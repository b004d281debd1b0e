"""Context parallelism: ring, bidirectional-ring and all-gather attention.

The counterpart of ``flashattention_tpu/parallel/ring.py``. q, k and v are
sharded on their sequence dim over a process group (the mesh's
``context`` axis); rank r holds rows [r * n, (r + 1) * n). The
online-softmax merge of normalised partials is associative, so partials
against K/V shards merge exactly like K/V tiles inside one kernel.

Each ring is two parts:

- a schedule (:func:`ring_forward`, :func:`ring_backward`,
  :func:`bidir_forward`, :func:`bidir_backward`): one rank's partials and
  merge over the shards it receives, in the order the ring delivers them.
  The schedules take any iterable of shards, so :func:`local_shards` can
  feed every rank's shards on one device (``chip_smoke.py`` and the card
  tests run all ranks of a ring on one card this way);
- a wrapper (:func:`ring_attention`, :func:`ring_attention_bidir`) that
  moves the shards between ranks with ``dist.batch_isend_irecv``, the next
  shard requested before the current partial runs.

Every partial is the flash kernel pair (``ops/flash_attn.py``, B1-B3) with
a ``q_offset`` known on the host, since the rank is: a past shard attends
fully (offset +n, or +n/2 for the bidirectional halves), the diagonal shard
causally (offset 0, or minus the half's start, which leaves the first rows
of the second half with no visible key: the kernel gives them the finite
mask-value LSE, which the merge weighs to 0), and a future shard is
skipped on the host without a launch. The JAX package launches future
shards with offset -n only to keep one traced call differentiable.

Backward: autograd does not cross ``send``/``recv``, so the rings are
``torch.autograd.Function``s whose backward is the ring backward.
di = rowsum(o * do) - dlse is taken once from the merged output, and every
partial's backward (B2/B3) runs with the merged (global) LSE and that di,
which gives the gradient of the whole attention. dQ accumulates on its rank;
dK and dV accumulate in fp32 buffers that travel with their shard and are
back with their owner after world-size steps. The JAX package instead
differentiates through the merge.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from flashattention_tpu_torch.ops import flash_attn as fa


def merge_partials(m, l, acc, o_p, lse_p):
    """Merge a normalised partial (o_p, lse_p) into the running (m, l, acc):
    m the running max (B, H, N), l the sum of weights, acc the unnormalised
    output; o = acc / l and lse = m + log l at the end."""
    m_new = torch.maximum(m, lse_p)
    alpha = torch.exp(m - m_new)
    w = torch.exp(lse_p - m_new)
    return (m_new, l * alpha + w,
            acc * alpha[..., None] + o_p.float() * w[..., None])


def _start(q):
    b, h, n, d = q.shape
    m = torch.full((b, h, n), float("-inf"), device=q.device)
    return m, torch.zeros_like(m), torch.zeros((b, h, n, d), device=q.device)


def _finish(m, l, acc, dtype):
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l_safe[..., None]).to(dtype), m + torch.log(l_safe)


def _offset(src: int, rank: int, full: int, diagonal: int):
    """q_offset of a partial against the shard of rank ``src``; None for a
    future shard, which is skipped."""
    if src < rank:
        return full
    return diagonal if src == rank else None


def _opts(q, k, causal, scale, offset, q_ids, kv_ids):
    return fa.make_opts(
        q, k, causal=causal, softmax_scale=scale, q_offset=offset,
        segment_ids=None if q_ids is None else (q_ids, kv_ids))


def _partials(q, shards, rank, world, causal, scale, q_ids, bidir):
    """Yields (opts, shard) of every partial this rank launches."""
    n = q.shape[2]
    for step, pair in enumerate(shards):
        halves = pair if bidir else (pair,)
        for i, shard in enumerate(halves):
            src = (rank - step if i == 0 else rank + step) % world
            if not causal:
                offset = None
            elif bidir:
                offset = _offset(src, rank, n // 2, -i * (n // 2))
            else:
                offset = _offset(src, rank, n, 0)
            if causal and offset is None:
                continue
            yield _opts(q, shard[0], causal, scale, offset, q_ids,
                        shard[2]), shard


def ring_forward(q, shards, rank: int, world: int, *, causal: bool = False,
                 softmax_scale=None, q_ids=None):
    """One rank's ring forward: ``shards`` yields (k, v, kv_ids) for steps
    0..world-1, step s holding the shard of rank (rank - s) % world
    (kv_ids None without segment ids). Returns (o, lse) of the local q."""
    return _forward(q, shards, rank, world, causal, softmax_scale, q_ids,
                    bidir=False)


def bidir_forward(q, shards, rank: int, world: int, *, causal: bool = False,
                  softmax_scale=None, q_ids=None):
    """One rank's bidirectional ring forward: ``shards`` yields pairs
    ((k1, v1, ids1), (k2, v2, ids2)), at step s the first half of rank
    (rank - s)'s shard and the second half of rank (rank + s)'s."""
    return _forward(q, shards, rank, world, causal, softmax_scale, q_ids,
                    bidir=True)


def _forward(q, shards, rank, world, causal, scale, q_ids, bidir):
    m, l, acc = _start(q)
    for opts, (k, v, _) in _partials(q, shards, rank, world, causal, scale,
                                     q_ids, bidir):
        o_p, lse_p = fa.flash_fwd(q, k, v, opts)
        m, l, acc = merge_partials(m, l, acc, o_p, lse_p)
    return _finish(m, l, acc, q.dtype)


def ring_backward(q, shards, o, lse, do, dlse, rank: int, world: int, *,
                  causal: bool = False, softmax_scale=None, q_ids=None):
    """One rank's ring backward: ``shards`` yields (k, v, kv_ids, dk, dv) in
    the forward's order, dk and dv fp32 buffers of that shard's gradient,
    into which this rank's share is added in place. ``o`` and ``lse`` are
    the merged forward's. Returns dq."""
    return _backward(q, shards, o, lse, do, dlse, rank, world, causal,
                     softmax_scale, q_ids, bidir=False)


def bidir_backward(q, shards, o, lse, do, dlse, rank: int, world: int, *,
                   causal: bool = False, softmax_scale=None, q_ids=None):
    """:func:`ring_backward` over the pairs of :func:`bidir_forward`, each
    half with its own dk, dv buffers."""
    return _backward(q, shards, o, lse, do, dlse, rank, world, causal,
                     softmax_scale, q_ids, bidir=True)


def _backward(q, shards, o, lse, do, dlse, rank, world, causal, scale, q_ids,
              bidir):
    do = do.to(q.dtype)
    di = (o.float() * do.float()).sum(dim=-1)
    if dlse is not None:
        di = di - dlse.float()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for opts, (k, v, _, dk, dv) in _partials(q, shards, rank, world, causal,
                                             scale, q_ids, bidir):
        dq_p, dk_p, dv_p = fa.flash_bwd_di(q, k, v, do, lse, di, opts)
        dq += dq_p
        dk += dk_p
        dv += dv_p
    return dq.to(q.dtype)


# ---------------------------------------------------------------------------
# Moving shards
# ---------------------------------------------------------------------------


def _seq_dim(t):
    return 2 if t.dim() == 4 else 1  # (B, H, N, D) or ids (B, N)


def local_shards(full, rank: int, world: int, *, bidir: bool = False):
    """The shards rank ``rank`` of a ring of ``world`` receives, in order,
    cut from whole-sequence tensors on one device: ``full`` is a tuple such
    as (k, v, ids[, dk, dv]) (ids may be None; (B, N) ids and (B, H, N, D)
    tensors are cut on their sequence dim). Slices are views, so fp32
    gradient buffers in ``full`` collect what the backward adds."""
    def cut(src, part, parts):
        return tuple(None if t is None else t.chunk(world * parts, _seq_dim(t))
                     [src * parts + part] for t in full)

    if not bidir:
        return [cut((rank - s) % world, 0, 1) for s in range(world)]
    return [(cut((rank - s) % world, 0, 2), cut((rank + s) % world, 1, 2))
            for s in range(world)]


class _Rotation:
    """Iterates over ring steps, moving tuples of tensors one rank along the
    group (``direction`` +1 or -1) between steps; the next tuple is
    requested before the current one is handed out. ``carry`` tensors
    (gradient buffers) move after the step's compute, one more time at the
    end, so that they come home: :attr:`carry` then holds the own shard's."""

    def __init__(self, tensors, carry, group, direction, tag):
        self.tensors = tuple(tensors)
        self.carry = tuple(carry)
        self.group, self.tag = group, tag
        self.world = dist.get_world_size(group)
        rank = dist.get_rank(group)
        self.dst = dist.get_global_rank(group, (rank + direction) % self.world)
        self.src = dist.get_global_rank(group, (rank - direction) % self.world)

    def _send(self, tensors):
        """Start sending ``tensors`` on and receiving their successors."""
        live = [t for t in tensors if t is not None]
        got = [torch.empty_like(t) for t in live]
        ops = ([dist.P2POp(dist.isend, t, self.dst, self.group, self.tag)
                for t in live]
               + [dist.P2POp(dist.irecv, t, self.src, self.group, self.tag)
                  for t in got])
        reqs = dist.batch_isend_irecv(ops) if ops else []
        it = iter(got)
        return reqs, tuple(None if t is None else next(it) for t in tensors)

    def __iter__(self):
        for step in range(self.world):
            reqs, nxt = [], None
            if self.world > 1 and step < self.world - 1:
                reqs, nxt = self._send(self.tensors)
            yield self.tensors + self.carry
            if self.world > 1 and self.carry:
                creqs, self.carry = self._send(self.carry)
                reqs = reqs + creqs
            for r in reqs:
                r.wait()
            if nxt is not None:
                self.tensors = nxt


def _ids(ids, q):
    return None if ids is None else ids.to(device=q.device,
                                           dtype=torch.int32).contiguous()


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ids, group, causal, scale, bidir):
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        kw = dict(causal=causal, softmax_scale=scale, q_ids=ids)
        if bidir:
            o, lse = bidir_forward(q, _pairs(_bidir_rotations(k, v, ids, group)),
                                   rank, world, **kw)
        else:
            o, lse = ring_forward(q, _Rotation((k, v, ids), (), group, 1, 0),
                                  rank, world, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (ids, group, kw, bidir, rank, world)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        ids, group, kw, bidir, rank, world = ctx.args
        if do is None:
            do = torch.zeros_like(o)
        if bidir:
            rots = _bidir_rotations(k, v, ids, group, grads=True)
            dq = bidir_backward(q, _pairs(rots), o, lse, do, dlse, rank, world,
                                **kw)
            dk = torch.cat([r.carry[0] for r in rots], dim=2)
            dv = torch.cat([r.carry[1] for r in rots], dim=2)
        else:
            rot = _Rotation((k, v, ids), _zero_grads(k, v), group, 1, 0)
            dq = ring_backward(q, rot, o, lse, do, dlse, rank, world, **kw)
            dk, dv = rot.carry
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None, None, None


def _zero_grads(k, v):
    return (torch.zeros(k.shape, dtype=torch.float32, device=k.device),
            torch.zeros(v.shape, dtype=torch.float32, device=v.device))


def _pairs(rots):
    """The two rotations step by step, each run to its end (where the
    gradient buffers travel home), which ``zip`` alone would not do for
    the second."""
    its = [iter(r) for r in rots]
    yield from zip(*its)
    for it in its:
        next(it, None)


def _bidir_rotations(k, v, ids, group, grads=False):
    """The two halves' rotations: the first half clockwise, the second
    counter-clockwise (own tags, so a ring of two keeps them apart)."""
    n = k.shape[2]
    if n % 2:
        raise ValueError(f"local KV length {n} must be even")
    half = n // 2
    rots = []
    for i, direction in ((0, 1), (1, -1)):
        part = slice(i * half, (i + 1) * half)
        kh, vh = k[:, :, part].contiguous(), v[:, :, part].contiguous()
        ih = None if ids is None else ids[:, part].contiguous()
        carry = _zero_grads(kh, vh) if grads else ()
        rots.append(_Rotation((kh, vh, ih), carry, group, direction, 1 + i))
    return rots


def ring_attention(q, k, v, *, group=None, causal: bool = False,
                   softmax_scale=None, segment_ids=None):
    """Ring attention over the ranks of ``group`` (None: the default
    group). q, k, v are this rank's (B, H, n, D) shards of the sequence;
    ``segment_ids`` this rank's (B, n) slice of the packed-varlen ids,
    which rotate with their K/V. Returns this rank's (o, lse),
    differentiable in q, k and v."""
    return _RingAttention.apply(q, k, v, _ids(segment_ids, q),
                                _group(group), causal, softmax_scale, False)


def ring_attention_bidir(q, k, v, *, group=None, causal: bool = False,
                         softmax_scale=None, segment_ids=None):
    """Bidirectional ring attention: each rank's K/V shard splits in two
    halves that rotate in opposite directions, half the bytes a step on
    each link direction; the same step count and result as
    :func:`ring_attention`. The local length must be even."""
    return _RingAttention.apply(q, k, v, _ids(segment_ids, q),
                                _group(group), causal, softmax_scale, True)


def _group(group):
    return group if group is not None else dist.group.WORLD


class _GatherSeq(torch.autograd.Function):
    """All-gather on a tensor's sequence dim; the backward sums the ranks'
    gradients and keeps this rank's slice (an all-reduce, which every
    backend has)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group, ctx.dim = group, _seq_dim(t)
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim=ctx.dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        world, rank = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(world, ctx.dim)[rank], None


def gathered_attention(q, k_full, v_full, rank: int, *, causal: bool = False,
                       softmax_scale=None, q_ids=None, kv_ids=None):
    """The all-gather schedule of one rank: its q shard against the whole
    K/V, causal along its true diagonal (q_offset = rank * n). One flash
    call, differentiable."""
    n = q.shape[2]
    return fa.kernel_attention(
        q, k_full, v_full, causal=causal, softmax_scale=softmax_scale,
        q_offset=rank * n if causal else None,
        segment_ids=None if q_ids is None else (q_ids, kv_ids))


def all_gather_attention(q, k, v, *, group=None, causal: bool = False,
                         softmax_scale=None, segment_ids=None):
    """Context parallelism by all-gather: every rank gathers the whole K/V
    (and ids) and attends its q shard with one flash call. Simpler than the
    ring and best when the sequence's K/V fit on every device."""
    group = _group(group)
    k_full, v_full = _GatherSeq.apply(k, group), _GatherSeq.apply(v, group)
    ids = _ids(segment_ids, q)
    ids_full = None
    if ids is not None:
        parts = [torch.empty_like(ids) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, ids, group=group)
        ids_full = torch.cat(parts, dim=1)
    return gathered_attention(q, k_full, v_full, dist.get_rank(group),
                              causal=causal, softmax_scale=softmax_scale,
                              q_ids=ids, kv_ids=ids_full)


def make_ring_attention(mesh, *, causal: bool = False, softmax_scale=None):
    """Ring attention over ``mesh``'s ``context`` axis: fn(q, k, v) on this
    rank's (B / data, H, N / context, D) shards -> (o, lse)."""
    group = mesh.get_group("context")

    def ring(q, k, v, segment_ids=None):
        return ring_attention(q, k, v, group=group, causal=causal,
                              softmax_scale=softmax_scale,
                              segment_ids=segment_ids)

    return ring


KINDS = ("ring", "bidir", "all_gather")


def _check_kind(kind):
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")


def rank_forward(kind: str, q, k, v, rank: int, world: int, *,
                 causal: bool = False, softmax_scale=None, q_ids=None,
                 kv_ids=None):
    """Rank ``rank``'s forward of a ``world``-rank ring (``kind`` in
    :data:`KINDS`) on one device: its q shard (B, H, n, D) and q ids
    (B, n), and the whole sequence's k, v (B, H, N, D) and ids (B, N), cut
    into the shards the rank would receive. Returns its (o, lse)."""
    _check_kind(kind)
    kw = dict(causal=causal, softmax_scale=softmax_scale, q_ids=q_ids)
    if kind == "all_gather":
        opts = _opts(q, k, causal, softmax_scale,
                     rank * q.shape[2] if causal else None, q_ids, kv_ids)
        return fa.flash_fwd(q, k, v, opts)
    fwd = bidir_forward if kind == "bidir" else ring_forward
    return fwd(q, local_shards((k, v, kv_ids), rank, world,
                               bidir=kind == "bidir"), rank, world, **kw)


def rank_backward(kind: str, q, k, v, o, lse, do, dlse, dk, dv, rank: int,
                  world: int, *, causal: bool = False, softmax_scale=None,
                  q_ids=None, kv_ids=None):
    """Rank ``rank``'s backward on one device (arguments as
    :func:`rank_forward`, with its merged o, lse and their cotangents): adds
    its share of the whole sequence's gradient into the fp32 buffers dk, dv
    (B, H, N, D) and returns its dq."""
    _check_kind(kind)
    if kind == "all_gather":
        opts = _opts(q, k, causal, softmax_scale,
                     rank * q.shape[2] if causal else None, q_ids, kv_ids)
        dq, dk_r, dv_r = fa.flash_bwd(q, k, v, o, lse, do.to(q.dtype), dlse,
                                      opts)
        dk += dk_r
        dv += dv_r
        return dq
    bwd = bidir_backward if kind == "bidir" else ring_backward
    shards = local_shards((k, v, kv_ids, dk, dv), rank, world,
                          bidir=kind == "bidir")
    return bwd(q, shards, o, lse, do, dlse, rank, world, causal=causal,
               softmax_scale=softmax_scale, q_ids=q_ids)


def schedules_on_one_device(kind: str, q, k, v, world: int, *,
                            causal: bool = False, softmax_scale=None,
                            segment_ids=None, do=None, dlse=None):
    """Every rank's schedule of a ``world``-rank ring, run in turn on one
    device over whole-sequence q, k, v (B, H, N, D) and ids (B, N): the
    check that needs no second device. Returns (o, lse) of the whole
    sequence, rank shards concatenated, and with ``do`` (and optional
    ``dlse``) also (dq, dk, dv)."""
    ids = _ids(segment_ids, q)
    qs = q.chunk(world, 2)
    q_ids = [None] * world if ids is None else ids.chunk(world, 1)
    kw = dict(causal=causal, softmax_scale=softmax_scale, kv_ids=ids)
    outs = [rank_forward(kind, qs[r], k, v, r, world, q_ids=q_ids[r], **kw)
            for r in range(world)]
    o = torch.cat([x[0] for x in outs], dim=2)
    lse = torch.cat([x[1] for x in outs], dim=2)
    if do is None:
        return o, lse
    dk, dv = _zero_grads(k, v)
    dos = do.chunk(world, 2)
    dlses = [None] * world if dlse is None else dlse.chunk(world, 2)
    dq = [rank_backward(kind, qs[r], k, v, outs[r][0], outs[r][1], dos[r],
                        dlses[r], dk, dv, r, world, q_ids=q_ids[r], **kw)
          for r in range(world)]
    return o, lse, torch.cat(dq, dim=2), dk.to(k.dtype), dv.to(v.dtype)
