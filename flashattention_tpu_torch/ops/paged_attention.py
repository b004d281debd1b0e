"""Paged attention: decode and chunked prefill against the paged KV cache.

The counterpart of ``flashattention_tpu/ops/pallas_paged.py``
(``pallas_paged_attention``). On a CUDA tensor :func:`paged_attention`
launches a hand-written kernel of ``csrc/paged_attention.cu``; on a CPU
tensor it runs :func:`paged_attention_plain`, the same function written in
plain PyTorch. Nothing falls back: a CUDA input the kernel does not take
raises, and a launch that fails raises.

Two routes, chosen by :func:`split_route` from the inputs alone: the split
page walk (``fat_paged_attention_split``: the walk cut across CTAs, pages
brought in by 1-D bulk copies, a second kernel merging the splits) for
bf16 q over bf16 or 1-byte pages in every schedule, and the first kernel
(``fat_paged_attention``, ``fat_paged_attention_quant``) for fp32 pages
or q and shapes the bulk copies cannot take. Both take any head dim; the
split route needs D % 8 == 0 and a ring that fits, and
above D = 128 the first kernel cuts its walk into splits too
(:func:`first_plan`), merged by the split route's merge kernel. Above D =
256 both kernels cut each output row into chunks of 256 columns, one CTA a
chunk, each computing the scores over all of D, and above
:data:`PASS_HEAD_DIM` (1024) they sum each tile's scores over passes of
1024 columns. The split
kernel walks a page on the tensor cores above D = 128, wherever a KV head
has 3 query rows or more and in the "full" schedule, else in lane groups
on the CUDA cores (:func:`split_walk`).
``paged_attention.launches`` counts every call,
``paged_attention.split_launches`` the split route's,
``paged_attention.tc_launches`` those of the split route on the tensor
cores and ``paged_attention.chunk_launches`` those with more than one
query a sequence (T > 1).

Layout (as in the JAX package):

    q             (B, H, D) decode, or (B, H, T, D) chunk
    k/v_pages     (H_kv, P, page, D) bf16/fp32, or int8/e4m3/e5m2 payloads
    k/v_scales    (H_kv, P, page, 1) fp32 per-slot scales of a quantized cache
    page_indices  (B, pages_per_seq) int32, logical -> physical page
    lengths       (B,) int32, slots written per sequence, the chunk included

Row t of a chunk sits at position ``lengths - T + t`` and attends to slots
``<= position``; with ``window`` W only to slots ``> position - W``, plus
the first ``sinks`` slots. A row that sees no slot returns zeros.

Rounding points follow the TPU kernel. The compute type is the pages' dtype
for bf16/fp32 pages and q's dtype for quantized pages (bf16 on the card
engine, fp32 in the CPU tests): q is scaled in it before QK, scores
accumulate in float32, and p is rounded to it before PV. Quantized payloads
convert to the compute type exactly; the fp32 scores are multiplied by
``k_scale[slot]`` after QK (before soft-cap and mask), ``l`` sums the
unscaled p, and ``p * v_scale[slot]`` is rounded to the compute type before
PV.

int8 pages have two more schedules (``int8_qk``), as the JAX kernel's
``FAT_PAGED_INT8_MXU`` knob:

- ``"qk"``: q is quantized per row, ``qs = max(max|q_row|, 1e-9) * (1/127)``,
  ``q8 = round(q / qs)``; scores are ``float(q8 . k8) * (qs * scale) *
  k_scale``; V converts as above.
- ``"full"``: as ``"qk"``, and ``pv = p * v_scale`` is re-quantized per row
  over each step of the page walk (the JAX merged kernel's steps of
  max(1, min(512 // page, pages_per_seq)) pages):
  ``ps = max(max pv, 1e-30) * (1/127)``, contribution ``round(pv / ps) * ps
  . v8``.

``int8_qk=None`` is the JAX default: ``"qk"`` for int8 pages, bf16 compute,
q_len 1 and page % 16 == 0, else the convert path. ``True`` means
``"qk"``, ``False`` the convert path. Either int8 schedule needs
page % 16 == 0 (the TPU merged schedule); other page sizes convert.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from flashattention_tpu_torch import _build
from flashattention_tpu_torch.ops.quant import inv_qmax
from flashattention_tpu_torch.ops.reference import score_pipeline

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
# payload format codes of the kernel: 0 = the compute type itself
_FMT_CODE = {torch.int8: 1, torch.float8_e4m3fn: 2, torch.float8_e5m2: 3}
_MODE_CODE = {"convert": 0, "qk": 1, "full": 2}
# Above 256 the kernels cut the output into chunks of CHUNK_HEAD_DIM
# columns; above PASS_HEAD_DIM (kPassD in csrc/paged_attention.cu) they sum
# the scores over passes of that many columns.
PASS_HEAD_DIM = 1024
CHUNK_HEAD_DIM = 256


def row_positions(lengths, q_len, rows_per_head):
    """(B, R) absolute position of each query row; row r is chunk token
    r % q_len of group member r // q_len."""
    t = torch.arange(rows_per_head, device=lengths.device) % q_len
    return lengths.to(torch.int64)[:, None] - q_len + t[None, :]


def int8_mode(k_pages, q_dtype, q_len, int8_qk) -> str:
    """The schedule of a call: "convert", "qk" or "full" (module
    docstring)."""
    if k_pages.dtype != torch.int8 or k_pages.shape[2] % 16:
        return "convert"
    if int8_qk is None:
        return "qk" if (q_dtype == torch.bfloat16 and q_len == 1) else "convert"
    if int8_qk is False:
        return "convert"
    if int8_qk is True or int8_qk == "qk":
        return "qk"
    if int8_qk == "full":
        return "full"
    raise ValueError(f"int8_qk must be None, a bool, 'qk' or 'full', got "
                     f"{int8_qk!r}")


# The split route's bulk copies: a stage of the ring holds one page's K and
# V slabs (and scale planes); at least 3 stages must fit this many bytes.
SPLIT_RING_BYTES = 192 * 1024
# A ring of 4 stages where it stays within this many bytes (several CTAs an
# SM hide the walk's latency), else 3.
SPLIT_RING_TARGET = 64 * 1024
# Slots a split walks at least (and 4 pages or more) up to D = 128: 128
# where a CTA holds one row set or tile (decode, the verify chunk), else 64
# (a T = 64 chunk, whose CTAs do more work a page). 8-page splits were the
# fastest at the engine's decode shape and 4-page ones at its T = 64 chunk
# (PERF.md, the paged rows).
SPLIT_SLOTS = {True: 128, False: 64}
SPLIT_MAX_PAGES = 64    # pages a split may walk (the kernel's list)
SPLIT_THREADS = 128
# The tensor-core walk: rows of a row tile (the N of mma.sync m16n8k16);
# the CTAs of 1, 2 and 4 row tiles its registers let an SM hold (4, 3, 2),
# whose share of the H100's 227 KB of shared memory (less the kernel's
# static arrays) bounds the ring; the shared memory one CTA may take.
TC_ROWS = 8
TC_CTAS_PER_SM = {1: 4, 2: 3, 4: 2}
# Above D = 256 a CTA holds 1 or 2 row tiles (its q fragments cover up to
# 16 k-steps a warp) and asks for 2 CTAs an SM.
TC_CTAS_PER_SM_CHUNKED = {1: 2, 2: 2}
TC_SMEM_BYTES = 227 * 1024 - 1024
# Slots a tensor-core split walks above D = 128: 256 for bf16 pages at one
# row tile (decode), else 128. 1-byte pages decode each tile to bf16 in
# shared memory and want twice the CTAs; the chunk's 16 row groups already
# give 256 CTAs (PERF.md, row 7w). Up to D = 128, SPLIT_SLOTS.
TC_WIDE_SLOTS = {True: 256, False: 128}
# CTAs the first kernel's splits aim at above D = 128: two on each of the
# H100's 132 SMs.
FIRST_TARGET_CTAS = 264
_WALK_CODE = {"lanes": 0, "tc": 1}


def split_route(q_dtype, page_dtype, mode, page_size, d, aligned=True):
    """True where the split kernel takes the call: bf16 q over bf16 pages,
    or over 1-byte pages in any schedule ("full" on the tensor-core walk,
    a split one walk step); D % 8 == 0; a page's K (or V) slab of one KV
    head, ``page * D * elt`` bytes, and for 1-byte pages its scale plane,
    ``page * 4`` bytes, multiples of 16; three stages of the ring within
    :data:`SPLIT_RING_BYTES`; above D = 128 a tensor-core CTA of two stages,
    its decoded tiles and score buffers within :data:`TC_SMEM_BYTES`
    (:func:`tc_min_smem`: 1-byte pages decode two 16-slot tiles of D
    columns, 263 KB at D = 2048); every tensor the copies read 16-byte
    aligned (``aligned``). Everything else takes the first kernel."""
    if q_dtype != torch.bfloat16:
        return False
    quant = page_dtype in _FMT_CODE
    if not quant and page_dtype != torch.bfloat16:
        return False
    if d % 8:
        return False
    slab = page_size * d * (1 if quant else 2)
    if slab % 16 or (quant and page_size % 4):
        return False
    if d > 128 and tc_min_smem(d, page_size, quant, mode) > TC_SMEM_BYTES:
        return False
    return aligned and 3 * (2 * slab + (8 * page_size if quant else 0)) \
        <= SPLIT_RING_BYTES


def tc_min_smem(d, page_size, quantized, mode="convert"):
    """Shared bytes of a tensor-core CTA of two stages and two row tiles
    (a "full" step of :func:`full_step_pages` at most), the most
    :func:`split_plan` asks for at its fewest stages: its ring, its decoded
    tiles and score buffers."""
    nrs = 2
    full = mode == "full"
    stage = (page_size * d + 8 * page_size if full
             else 2 * page_size * d + 8 * page_size if quantized
             else 2 * page_size * tc_row_bytes(d))
    step = max(1, 512 // page_size) if full else 0
    extra = ((2 * (32 * tc_row_bytes(d) + 128) if quantized else 0)
             + 2 * 4 * nrs * 32 * 16
             + step * page_size // 16 * nrs * 32 * 16)
    return 2 * stage + extra


def tc_row_bytes(d):
    """Bytes between two slot rows of the tensor-core walk's bf16 tiles:
    D * 2 rounded up to an odd count of 16-byte units (``tc_row_bytes`` in
    the kernel), so ldmatrix reads them without bank conflicts."""
    return ((d // 8) | 1) * 16


def split_walk(d, rows, mode="convert"):
    """The split kernel's walk for head dim ``d``, ``rows`` = G * T query
    rows a KV head and the schedule ``mode``: "tc" (mma.sync products over
    each page, the head dim cut over the CTA's 4 warps) above D = 128,
    wherever a KV head has 3 rows or more and for "full" (whose p8 are the
    integer operand of that product; no lane-group "full" exists), "lanes"
    (lane groups of D / 8 lanes a slot on the CUDA cores) for 1 or 2 rows
    up to D = 128. At GPT-3 Small's widths (D = 64) the tensor cores are
    faster from 3 rows on and slower at 1: PERF.md, row 7
    (scripts/paged_ab.py, scripts/paged_tc_variants.py)."""
    return "tc" if mode == "full" or d > 128 or rows >= 3 else "lanes"


@functools.lru_cache(maxsize=256)
def split_plan(h, h_kv, q_len, d, page_size, pps, quantized, mode="convert"):
    """The split kernel's launch plan, from shapes only (lengths live on
    the device): ``split_pages`` pages per split (at least 4 and
    :data:`SPLIT_SLOTS` slots; "full": one walk step,
    :func:`full_step_pages`, also ``step_pages``), ``n_splits`` to cover
    ``pps`` pages; ``walk`` (:func:`split_walk`); ``row_groups`` CTAs per
    KV head; ``stages`` of the ring.

    On the tensor-core walk a CTA holds ``nrs`` row tiles of ``rps`` =
    :data:`TC_ROWS` rows (1, 2 or 4 tiles: 8, 16 or more rows a KV head;
    above D = 256 at most 2, :data:`TC_CTAS_PER_SM_CHUNKED`, above
    :data:`PASS_HEAD_DIM` 1),
    its splits take :data:`TC_WIDE_SLOTS` slots above D = 128, and
    ``stages`` (2-4) are as many as fit, beside its decoded tiles and score
    buffers, in its share of an SM's shared memory (:data:`TC_CTAS_PER_SM`):
    resident CTAs, not a deeper ring, set the 1-byte pages' time (PERF.md,
    row 7w). "full" brings a step's K pages, then its V pages, one slab and
    both scale planes a stage, and keeps the step's scores (a float a row
    and slot) beside them. On the lane-group walk a CTA holds the ``rps`` =
    1 or 2 rows (``nrs`` = 1), and ``lg`` = D / 8 lanes (4, 8 or 16) hold 8
    columns each of a slot."""
    rows = (h // h_kv) * q_len
    walk = split_walk(d, rows, mode)
    full = mode == "full"
    step = full_step_pages(page_size, pps) if full else 0
    if walk == "tc":
        lg, rps = 0, TC_ROWS
        chunked = d > CHUNK_HEAD_DIM
        nrs = 1 if rows <= TC_ROWS or d > PASS_HEAD_DIM else (
            2 if rows <= 2 * TC_ROWS or chunked else 4)
        stage = (page_size * d + 8 * page_size if full
                 else 2 * page_size * d + 8 * page_size if quantized
                 else 2 * page_size * tc_row_bytes(d))
        extra = ((2 * (32 * tc_row_bytes(d) + 128) if quantized else 0)
                 + 2 * 4 * nrs * 32 * 16
                 + (step * page_size // 16 * nrs * 32 * 16 if full else 0))
        share = TC_SMEM_BYTES // (TC_CTAS_PER_SM_CHUNKED if chunked
                                  else TC_CTAS_PER_SM)[nrs]
        stages = max(2, min(4, (share - extra) // stage))
        slots = (TC_WIDE_SLOTS[nrs == 1 and not quantized] if d > 128
                 else SPLIT_SLOTS[nrs == 1])
    else:  # 1 or 2 rows, all in the one CTA
        lg = 4 if d <= 32 else (8 if d <= 64 else 16)
        rps, nrs = rows, 1
        stage = 2 * page_size * d * (1 if quantized else 2) + (
            8 * page_size if quantized else 0)
        stages = max(3, min(4, SPLIT_RING_TARGET // stage))
        slots = SPLIT_SLOTS[True]
    split_pages = (step if full
                   else min(SPLIT_MAX_PAGES, max(4, slots // page_size)))
    return dict(
        split_pages=split_pages, n_splits=-(-pps // split_pages), walk=walk,
        lg=lg, rps=rps, nrs=nrs, row_groups=-(-rows // (rps * nrs)),
        stages=stages, step_pages=step)


@functools.lru_cache(maxsize=256)
def first_plan(b, h, h_kv, q_len, d, pps, unit_pages):
    """``(split_units, n_splits)`` of the first kernel. Up to D = 128 it
    walks each sequence whole, ``(1, 1)``. Above, its walk is cut into
    ``n_splits`` splits of ``split_units`` units of ``unit_pages`` pages
    (the "full" schedule's walk step, so a step stays in one split; else
    1), at least 4 pages a split and enough splits that its blocks, (B,
    H_kv, row groups of 4, 8 or 16 rows) times the splits, reach
    :data:`FIRST_TARGET_CTAS`."""
    if d <= 128:
        return 1, 1
    rows = (h // h_kv) * q_len
    rpw = 1 if rows <= 4 else (2 if rows <= 64 else 4)
    blocks = b * h_kv * -(-rows // (4 * rpw))
    units = -(-pps // unit_pages)
    want = -(-FIRST_TARGET_CTAS // blocks)
    split_units = max(-(-4 // unit_pages), -(-units // want))
    return split_units, -(-units // split_units)


def full_step_pages(page_size: int, pps: int) -> int:
    """Pages per step of the "full" schedule's p re-quantization."""
    return max(1, min(max(1, 512 // page_size), pps))


def _walk_steps(lengths, q_len, page, pps, window, sinks, n_slots):
    """(B, L) step of the page walk holding each slot (module docstring,
    "full"): the walk visits the sink pages, then the band from the first
    page of the sequence's oldest in-band slot."""
    lp = torch.arange(n_slots, device=lengths.device) // page
    lp = lp[None, :].expand(lengths.shape[0], -1)
    if window is not None:
        first = torch.clamp(
            torch.div(lengths.long() - q_len - window + 1, page,
                      rounding_mode="floor"), min=0)[:, None]
        sink_pages = -(-sinks // page) if sinks else 0
        base = torch.clamp(first, min=sink_pages) if sink_pages else first
        lp = torch.where(lp < sink_pages, lp, lp - base + sink_pages)
    return torch.clamp(lp, min=0) // full_step_pages(page, pps)


def paged_attention_plain(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_indices: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
    softmax_scale: float | None = None,
    window: int | None = None,
    softcap: float | None = None,
    sinks: int = 0,
    int8_qk: bool | str | None = None,
) -> torch.Tensor:
    """Plain PyTorch paged attention: gather every page of the table, mask,
    softmax once. Same contract and rounding points as the kernel."""
    decode = q.dim() == 3
    if decode:
        q = q[:, :, None, :]
    b, h, t, d = q.shape
    h_kv, _, page, _ = k_pages.shape
    g = h // h_kv
    quantized = k_scales is not None
    cdt = q.dtype if quantized else k_pages.dtype
    mode = int8_mode(k_pages, q.dtype, t, int8_qk) if quantized else "convert"
    if softmax_scale is None:
        softmax_scale = d ** -0.5
    pi = page_indices.long()

    def gather(pages):  # (H_kv, B, pps, page, X) -> (B, H_kv, L, X)
        x = pages[:, pi].permute(1, 0, 2, 3, 4)
        return x.reshape(b, h_kv, -1, x.shape[-1]).float()

    k, v = gather(k_pages), gather(v_pages)
    if mode == "convert":
        scale = torch.tensor(softmax_scale, dtype=cdt, device=q.device)
        qc = (q.to(cdt) * scale).float().reshape(b, h_kv, g * t, d)
        s = torch.einsum("bhrd,bhld->bhrl", qc, k)
    else:
        qf = q.float().reshape(b, h_kv, g * t, d)
        qs = torch.clamp(qf.abs().amax(dim=-1, keepdim=True), min=1e-9)
        qs = qs * inv_qmax("int8")
        q8 = torch.round(qf / qs)
        s = torch.einsum("bhrd,bhld->bhrl", q8, k) * (qs * softmax_scale)
    if quantized:
        ks, vs = gather(k_scales)[..., 0], gather(v_scales)[..., 0]
        s = s * ks[:, :, None, :]
    pos = row_positions(lengths, t, g * t)[:, None, :, None]  # (B, 1, R, 1)
    slots = torch.arange(k.shape[2], device=q.device)[None, None, None, :]
    in_range = slots <= pos
    if window is not None:
        band = slots > pos - window
        if sinks:
            band = band | (slots < sinks)
        in_range = in_range & band
    s, _ = score_pipeline(s, softcap=softcap, visible=in_range)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(in_range, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    if not quantized:
        pv = p.to(cdt).float()
    elif mode != "full":
        pv = (p * vs[:, :, None, :]).to(cdt).float()
    else:
        pv = p * vs[:, :, None, :]
        step = _walk_steps(lengths, t, page, page_indices.shape[1], window,
                           sinks, k.shape[2])
        idx = step[:, None, None, :].expand_as(pv)
        pmax = torch.zeros(pv.shape[:-1] + (int(step.max()) + 1,),
                           device=q.device).scatter_reduce(
            -1, idx, pv, "amax", include_self=True)
        ps = torch.clamp(pmax, min=1e-30) * inv_qmax("int8")
        ps = ps.gather(-1, idx)
        pv = torch.round(pv / ps) * ps
    o = torch.einsum("bhrl,bhld->bhrd", pv, v)
    o = o / torch.where(l == 0, torch.ones_like(l), l)
    o = o.reshape(b, h, t, d).to(q.dtype)
    return o[:, :, 0] if decode else o


def _check_cuda_args(q, k_pages, v_pages, page_indices, lengths, k_scales,
                     v_scales):
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"paged_attention kernel takes bf16/fp32 q, got {q.dtype}")
    if k_pages.dtype != v_pages.dtype:
        raise TypeError(f"k_pages ({k_pages.dtype}) and v_pages "
                        f"({v_pages.dtype}) must share a dtype")
    if k_scales is None and k_pages.dtype != q.dtype:
        raise TypeError(
            f"q ({q.dtype}) and pages ({k_pages.dtype}, {v_pages.dtype}) "
            "must share a dtype"
        )
    if k_scales is not None and k_pages.dtype not in _FMT_CODE:
        raise TypeError(f"quantized pages must be int8/e4m3/e5m2, got "
                        f"{k_pages.dtype}")
    scale_shape = tuple(k_pages.shape[:3]) + (1,)
    for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != scale_shape):
            raise ValueError(f"{name} must be float32 {scale_shape}, is "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_indices", page_indices), ("lengths", lengths),
                    ("k_scales", k_scales), ("v_scales", v_scales)):
        if t is None:
            continue
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if page_indices.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_indices and lengths must be int32")
    if k_pages.shape != v_pages.shape:
        raise ValueError("k_pages and v_pages shapes differ")


def paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_indices: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
    softmax_scale: float | None = None,
    window: int | None = None,
    softcap: float | None = None,
    sinks: int = 0,
    int8_qk: bool | str | None = None,
) -> torch.Tensor:
    """Paged attention (module docstring). Returns o in q's shape and dtype.

    Launches a CUDA kernel for CUDA tensors, the one :func:`split_route`
    picks (counted in ``paged_attention.launches``; the split route also
    in ``split_launches``, and on the tensor cores in ``tc_launches``), and
    runs the plain version for CPU tensors.
    Quantized pages pass both ``k_scales`` and ``v_scales``."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales, or neither")
    decode = q.dim() == 3
    qq = q[:, :, None, :] if decode else q
    b, h, t, d = qq.shape
    h_kv, num_pages, page_size, d_k = k_pages.shape
    if d != d_k:
        raise ValueError(f"head_dim mismatch: q has {d}, cache has {d_k}")
    if h % h_kv != 0:
        raise ValueError(f"H={h} must be a multiple of H_kv={h_kv}")
    if page_indices.shape[0] != b or lengths.shape != (b,):
        raise ValueError("page_indices / lengths do not match the batch")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softmax_scale is None:
        softmax_scale = d ** -0.5
    quantized = k_scales is not None
    mode = int8_mode(k_pages, q.dtype, t, int8_qk) if quantized else "convert"
    if not q.is_cuda:
        return paged_attention_plain(
            q, k_pages, v_pages, page_indices, lengths, k_scales=k_scales,
            v_scales=v_scales, softmax_scale=softmax_scale, window=window,
            softcap=softcap, sinks=sinks, int8_qk=int8_qk,
        )
    _check_cuda_args(qq, k_pages, v_pages, page_indices, lengths, k_scales,
                     v_scales)
    qq = qq.contiguous()
    out = torch.empty_like(qq)
    if b == 0:
        return out[:, :, 0] if decode else out
    pps = page_indices.shape[1]
    lib = _build.load_kernel("paged_attention", _declare)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    aligned = all(x.data_ptr() % 16 == 0 for x in
                  (qq, k_pages, v_pages, k_scales, v_scales) if x is not None)
    if split_route(q.dtype, k_pages.dtype, mode, page_size, d, aligned):
        plan = split_plan(h, h_kv, t, d, page_size, pps, quantized, mode)
        part = torch.empty(plan["n_splits"] * b * h * t * (d + 2),
                           dtype=torch.float32, device=q.device)
        err = lib.fat_paged_attention_split(
            qq.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr() if quantized else None,
            v_scales.data_ptr() if quantized else None,
            page_indices.data_ptr(), lengths.data_ptr(), part.data_ptr(),
            out.data_ptr(), b, h, h_kv, t, d, num_pages, page_size, pps,
            float(softmax_scale), int(window) if window is not None else 0,
            int(sinks), float(softcap) if softcap is not None else 0.0,
            _FMT_CODE.get(k_pages.dtype, 0), _MODE_CODE[mode],
            plan["split_pages"], plan["n_splits"], _WALK_CODE[plan["walk"]],
            plan["lg"], plan["rps"], plan["nrs"], plan["stages"],
            plan["step_pages"], stream,
        )
        _build.check(err, "paged_attention split launch")
        paged_attention.launches += 1
        paged_attention.split_launches += 1
        paged_attention.tc_launches += plan["walk"] == "tc"
        paged_attention.chunk_launches += t > 1
        return out[:, :, 0] if decode else out
    step = full_step_pages(page_size, pps)
    units, n_splits = first_plan(b, h, h_kv, t, d, pps,
                                 step if mode == "full" else 1)
    part = (torch.empty(n_splits * b * h * t * (d + 2), dtype=torch.float32,
                        device=q.device) if d > 128 else None)
    part_ptr = part.data_ptr() if part is not None else None
    err = lib.fat_paged_attention(
        qq.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_indices.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, h, h_kv, t, d, num_pages, page_size, pps,
        float(softmax_scale), int(window) if window is not None else 0,
        int(sinks), float(softcap) if softcap is not None else 0.0,
        _DTYPE_CODE[q.dtype], part_ptr, n_splits, units, stream,
    ) if not quantized else lib.fat_paged_attention_quant(
        qq.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr(), v_scales.data_ptr(),
        page_indices.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, h, h_kv, t, d, num_pages, page_size, pps,
        float(softmax_scale), int(window) if window is not None else 0,
        int(sinks), float(softcap) if softcap is not None else 0.0,
        _DTYPE_CODE[q.dtype], _FMT_CODE[k_pages.dtype], _MODE_CODE[mode],
        step, part_ptr, n_splits, units, stream,
    )
    _build.check(err, "paged_attention launch")
    paged_attention.launches += 1
    paged_attention.chunk_launches += t > 1
    return out[:, :, 0] if decode else out


paged_attention.launches = 0
paged_attention.split_launches = 0
paged_attention.tc_launches = 0
paged_attention.chunk_launches = 0


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fat_paged_attention.restype = ctypes.c_int
    lib.fat_paged_attention.argtypes = [
        p, p, p, p, p, p, i, i, i, i, i, i, i, i, f, i, i, f, i, p, i, i, p,
    ]
    lib.fat_paged_attention_quant.restype = ctypes.c_int
    lib.fat_paged_attention_quant.argtypes = [
        p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, f, i, i, f, i, i, i,
        i, p, i, i, p,
    ]
    lib.fat_paged_attention_split.restype = ctypes.c_int
    lib.fat_paged_attention_split.argtypes = [
        p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, f, i, i, f, i, i,
        i, i, i, i, i, i, i, i, p,
    ]
