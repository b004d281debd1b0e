"""Block-sparse flash attention: kernels B8 (forward) and B9/B10 (backward).

The counterpart of ``flashattention_tpu/ops/pallas_sparse.py``
(``pallas_sparse_attention`` and its custom VJP). A bool tile pattern
(ceil(N_q / block_q), ceil(N_k / block_k)) says which (q block, KV block)
pairs attend; with ``causal`` it is ANDed with tile-granular causal
reachability (:func:`tile_pattern`). Each q block's active KV blocks, and
each KV block's active q blocks, are compacted into int32 lists with
counts (:func:`compact_rows`), built with tensor ops on the inputs' device
without a host sync; a kernel reads its loop bound from the count.

On CUDA tensors :func:`sparse_attention` launches ``csrc/sparse_fwd.cu``
(counted in ``sparse_attention.fwd_launches``) and, in the backward,
``csrc/sparse_bwd.cu`` (a dK/dV kernel over the transposed lists, then a
dQ kernel; ``sparse_attention.bwd_launches``). Each source has two routes
for each dtype, chosen by :func:`_route` and named by :func:`_entry`: with
both blocks multiples of 64, bf16 goes to the bf16 tensor-core kernels
(wgmma fed by TMA; ``fat_sparse_fwd_sm90`` / ``fat_sparse_bwd_sm90``) and
fp32 to the fp32 ones (3xTF32 wgmma fed by TMA; ``fat_sparse_fwd_sm90_f32``
/ ``fat_sparse_bwd_sm90_f32``; above D = 128 the wide kernels, whose
backward takes a scratch the wrapper allocates, ``flash_attn._wide_scratch``),
both up to D = 256 and both also counted in
``sparse_attention.fwd_tc_launches`` / ``bwd_tc_launches``; other blocks
go to the mma kernels (``mma.sync`` on 16-row slices anchored at each
block's start, any block size, D <= 256): bf16 on m16n8k16
(``fat_sparse_fwd_mma`` / ``fat_sparse_bwd_mma``) and fp32 in 3xTF32 on
m16n8k8 (``fat_sparse_fwd_mma_f32`` / ``fat_sparse_bwd_mma_f32``), both
also counted in ``sparse_attention.fwd_mma_launches`` /
``bwd_mma_launches``. Above D = 256 (:data:`SM90_MAX_HEAD_DIM`) every
call, any blocks, bf16 or fp32, goes to the wide kernels of
``csrc/sparse_wide.cu`` (``fat_sparse_fwd_wide`` / ``fat_sparse_bwd_wide``:
the mma route's walks and chunks with the head dim cut as
``csrc/flash_wide.cu`` cuts it), also counted in
``sparse_attention.fwd_wide_launches`` / ``bwd_wide_launches``; they take
any head dim. The first kernels, fp32 FMAs on the CUDA cores
(``fat_sparse_fwd`` / ``fat_sparse_bwd``), lie on no route: they are only
the comparison ``chip_smoke.py`` times beside the others.
On CPU tensors it runs the plain versions :func:`sparse_fwd_plain` and
:func:`sparse_bwd_plain`. Nothing falls back: a CUDA input the kernels do
not take (fp16, tensors on different devices; a head dim that is not a
multiple of 8 is padded, as in the flash wrapper) raises, and so does a
failed build or launch of any route.

The function. Query row r sits at key position r + (N_k - N_q). Inside an
active block pair an element is kept iff col < N_k and, when causal,
col <= r + N_k - N_q. ``s = (q·k in fp32) * scale`` in the forward and the
backward alike (the dense backward instead rounds q * scale to the input
type); a masked score takes ``DEFAULT_MASK_VALUE`` and its p is zeroed; p
is rounded to v's type before P·V and to do's before Pᵀ·dO; dK sums
``round(ds)ᵀ·q`` and dQ ``round(ds)·k`` unscaled, times the scale at the
end. Rows of a q block with no active KV block give o = 0 and
lse = -inf; a row of a visited block that sees no key gives o = 0 and
lse = ``DEFAULT_MASK_VALUE``. The plain versions are dense functions over
the expanded element mask with these rounding points, so kernel and plain
agree to about one bf16 ulp.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from flashattention_tpu_torch import _build
from flashattention_tpu_torch.ops.flash_attn import (
    _DTYPE_CODE,
    _aligned16,
    _expand_kv,
    _group_sum,
    _ptr,
    _wide_scratch,
)
from flashattention_tpu_torch.ops.reference import DEFAULT_MASK_VALUE

# The largest head dim of the tensor-core and mma kernels; above it the
# wide kernels (csrc/sparse_wide.cu) take every call, at any head dim.
SM90_MAX_HEAD_DIM = 256


@dataclasses.dataclass(frozen=True)
class SparseSpec:
    """Everything but q, k, v and the pattern that fixes the function."""

    causal: bool
    scale: float
    block_q: int
    block_k: int


# ---------------------------------------------------------------------------
# Block lists
# ---------------------------------------------------------------------------


def tile_pattern(pattern: torch.Tensor | None, n_q_tiles: int, n_k_tiles: int,
                 block_q: int, block_k: int, causal: bool, offset: int,
                 device=None) -> torch.Tensor:
    """The user pattern (all ones when None, on ``device``) ANDed, when
    ``causal``, with tile-granular causal reachability at ``offset``
    (``pallas_sparse._tile_pattern``): (n_q_tiles, n_k_tiles) bool."""
    if pattern is None:
        active = torch.ones((n_q_tiles, n_k_tiles), dtype=torch.bool,
                            device=device)
    else:
        if tuple(pattern.shape) != (n_q_tiles, n_k_tiles):
            raise ValueError(
                f"pattern must be (n_q_tiles, n_k_tiles)=({n_q_tiles}, "
                f"{n_k_tiles}), got {tuple(pattern.shape)}")
        active = pattern.bool()
    if causal:
        iq = torch.arange(n_q_tiles, device=active.device)[:, None]
        ik = torch.arange(n_k_tiles, device=active.device)[None, :]
        active = active & ((iq * block_q + block_q - 1 + offset) >= ik * block_k)
    return active


def compact_rows(active: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(R, C) bool -> (order (R, C) int32: each row's active column indices
    first, ascending, padded with its last active one (0 for an empty row);
    counts (R,) int32), as ``pallas_sparse._compact_rows``."""
    c = active.shape[1]
    counts = active.sum(dim=1, dtype=torch.int32)
    order = torch.argsort((~active).to(torch.int8), dim=1, stable=True)
    last = order.gather(1, (counts.long() - 1).clamp(min=0)[:, None])
    pos = torch.arange(c, device=active.device)[None, :]
    order = torch.where(pos < counts[:, None], order, last)
    return order.to(torch.int32).contiguous(), counts


def _active(pattern, q, k, spec: SparseSpec) -> torch.Tensor:
    n_q, n_k = q.shape[2], k.shape[2]
    return tile_pattern(pattern, -(-n_q // spec.block_q),
                        -(-n_k // spec.block_k), spec.block_q, spec.block_k,
                        spec.causal, n_k - n_q, device=q.device)


def element_mask(active: torch.Tensor, n_q: int, n_k: int,
                 spec: SparseSpec) -> torch.Tensor:
    """(N_q, N_k) bool: the tile map expanded to elements, ANDed with the
    causal edge when ``spec.causal``."""
    vis = active.repeat_interleave(spec.block_q, 0).repeat_interleave(
        spec.block_k, 1)[:n_q, :n_k]
    if spec.causal:
        rows = torch.arange(n_q, device=active.device)[:, None] + (n_k - n_q)
        vis = vis & (torch.arange(n_k, device=active.device)[None, :] <= rows)
    return vis


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def sparse_fwd_plain(q, k, v, active, spec: SparseSpec):
    """The forward kernel's function in plain PyTorch, dense over the
    expanded element mask: (o, lse)."""
    h, n_q = q.shape[1], q.shape[2]
    n_k = k.shape[2]
    vis = element_mask(active.to(q.device), n_q, n_k, spec)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     _expand_kv(k, h).float()) * spec.scale
    s = torch.where(vis, s, torch.full_like(s, DEFAULT_MASK_VALUE))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vis, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                     _expand_kv(v, h).float())
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    lse = (m + torch.log(l_safe))[..., 0]
    # rows of a q block with no active KV block were never visited
    row_on = active.to(q.device).any(dim=1).repeat_interleave(
        spec.block_q)[:n_q]
    lse = torch.where(row_on, lse, torch.full_like(lse, float("-inf")))
    return (o / l_safe).to(q.dtype), lse


def sparse_bwd_plain(q, k, v, do, lse, di, active, spec: SparseSpec):
    """The backward kernels' function in plain PyTorch, dense over the
    expanded element mask: dq, dk, dv from the saved LSE and
    ``di = rowsum(o·do) - dlse``."""
    h, n_q = q.shape[1], q.shape[2]
    h_kv, n_k = k.shape[1], k.shape[2]
    vis = element_mask(active.to(q.device), n_q, n_k, spec)
    qf, kf, dof = q.float(), _expand_kv(k, h).float(), do.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * spec.scale
    p = torch.where(vis, torch.exp(s - lse.float()[..., None]),
                    torch.zeros_like(s))
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, _expand_kv(v, h).float())
    ds = p * (dp - di.float()[..., None])
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(), qf)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(), kf)
    return ((dq * spec.scale).to(q.dtype),
            (_group_sum(dk, h_kv) * spec.scale).to(k.dtype),
            _group_sum(dv, h_kv).to(v.dtype))


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def _check_cuda(q, k, v, active, spec: SparseSpec, do=None, lse=None):
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"sparse attention kernels take bf16/fp32, got {q.dtype}")
    for name, t in (("k", k), ("v", v), ("do", do)):
        if t is not None and t.dtype != q.dtype:
            raise TypeError(f"{name} ({t.dtype}) must have q's dtype ({q.dtype})")
    b, h, n_q, d = q.shape
    if d % 8:
        raise ValueError(f"head_dim must be a multiple of 8 (the sparse "
                         f"kernels' rows), got {d}")
    n_k = k.shape[2]
    want = {"k": tuple(v.shape), "pattern": (-(-n_q // spec.block_q),
                                             -(-n_k // spec.block_k)),
            "do": tuple(q.shape), "lse": (b, h, n_q)}
    for name, t in (("k", k), ("pattern", active), ("do", do), ("lse", lse)):
        if t is not None and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, is "
                             f"{tuple(t.shape)}")
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"fit together")
    for name, t in (("q", q), ("k", k), ("v", v), ("pattern", active),
                    ("do", do), ("lse", lse)):
        if t is not None and (not t.is_cuda or t.device != q.device):
            raise ValueError(f"{name} must be on {q.device}, is on {t.device}")


def _shape_args(q, k, spec: SparseSpec):
    b, h, n_q, d = q.shape
    return [b, h, k.shape[1], n_q, k.shape[2], d, float(spec.scale),
            int(spec.causal), int(spec.block_q), int(spec.block_k)]


def _tensor_core_route(dtype, d: int, spec: SparseSpec) -> bool:
    """True where the tensor-core kernels take the call: ``block_q`` and
    ``block_k`` multiples of 64 (the TMA box and a consumer warpgroup's
    rows), bf16 or fp32 up to D = 256 (above D = 128 the bf16 dK/dV kernel
    splits the head dim between its two consumers; fp32 runs 3xTF32, each
    operand split into two TF32 parts, which keeps the fp32 1e-4 limit, and
    above D = 128 its wide kernels split the operands they keep as landed
    in registers). Other blocks take the mma kernels."""
    return (dtype in _DTYPE_CODE and d <= SM90_MAX_HEAD_DIM
            and spec.block_q % 64 == 0 and spec.block_k % 64 == 0)


def _route(dtype, d: int, spec: SparseSpec) -> str:
    """The route a call takes: above D = 256 "wide", else "tc" (wgmma)
    where both blocks are multiples of 64, else "mma". ``mma.sync`` gives a
    warp 16 rows, so the mma kernels cut each block into 16-row (and 16- or
    32-key) slices anchored at its start: a 64-row wgmma tile kept inside a
    block of 16 or 32 would be mostly masked rows. bf16 runs m16n8k16, fp32
    m16n8k8 in 3xTF32 (each operand split into two TF32 parts in
    registers), on one walk and one chunk rule. The wide kernels run that
    walk and chunk rule (any blocks) with every output cut into column
    chunks and every product over D taken in 64-column segments, so their
    registers and shared memory do not grow with D. A call none takes
    (fp16) is refused before it gets here (``_check_cuda``)."""
    if d > SM90_MAX_HEAD_DIM:
        return "wide"
    return "tc" if _tensor_core_route(dtype, d, spec) else "mma"


def _entry(part: str, dtype, route: str) -> str:
    """The C entry point of ``part`` ("fwd" or "bwd") on a route
    (:func:`_route`, or "fma": the FMA kernels, which no call takes and
    chip_smoke.py times beside the others) for ``dtype``: the tensor-core
    kernels' ``fat_sparse_{part}_sm90[_f32]``, the mma kernels'
    ``fat_sparse_{part}_mma[_f32]``, the wide kernels'
    ``fat_sparse_{part}_wide`` (both dtypes)."""
    if route == "fma":
        return f"fat_sparse_{part}"
    if route == "wide":
        return f"fat_sparse_{part}_wide"
    f32 = "_f32" if dtype == torch.float32 else ""
    if route == "mma":
        return f"fat_sparse_{part}_mma{f32}"
    return f"fat_sparse_{part}_sm90{f32}"


def kernel_fn(part: str, dtype, route: str):
    """The loaded C entry point :func:`_entry` names: the wide route's in
    the ``sparse_wide`` library, the others in ``sparse_{part}``."""
    if route == "wide":
        lib = _build.load_kernel("sparse_wide", _declare_wide)
    elif part == "fwd":
        lib = _build.load_kernel("sparse_fwd", _declare_fwd)
    else:
        lib = _build.load_kernel("sparse_bwd", _declare_bwd)
    return getattr(lib, _entry(part, dtype, route))


def route_kernels(dtype, d: int, spec: SparseSpec,
                  kv_splits: int = 1) -> frozenset[str]:
    """The ``__global__`` kernels a forward and a backward call launch (their
    names in a profiler trace). fp32 above D = 128 adds the split of the
    backward's B operands (``tf32_split_kernel``) and, where ``kv_splits``
    (``flash_attn._wide_scratch``) spreads a KV head's query heads over
    dK/dV CTAs, the sum of their partials (``kv_sum_kernel``); the mma
    route (bf16 or fp32), where ``kv_splits`` (the chunks of
    :func:`_mma_chunks`) cuts a KV block's walk over dK/dV CTAs, the sum of
    theirs (``sparse_bwd_sum_mma_kernel``), and so does the wide route
    (above D = 256, one name for both dtypes)."""
    tag = {"tc": "_sm90", "mma": "_mma", "wide": "_wide"}[
        _route(dtype, d, spec)]
    if dtype == torch.float32 and tag != "_wide":
        tag = {"_mma": "_f32_mma",
               "_sm90": "_f32_wide_sm90" if d > 128 else "_f32_sm90"}[tag]
    names = {f"sparse_{k}{tag}_kernel" for k in ("fwd", "bwd_dkv", "bwd_dq")}
    if tag == "_f32_wide_sm90":
        names.add("tf32_split_kernel")
        if kv_splits > 1:
            names.add("kv_sum_kernel")
    if tag in ("_mma", "_f32_mma", "_wide") and kv_splits > 1:
        names.add("sparse_bwd_sum_mma_kernel")
    return frozenset(names)


# 16-row steps of the mma dK/dV kernel a CTA walks at most for one KV block,
# and the most bytes its chunks' fp32 partials may take
MMA_CHUNK_STEPS = 32
MMA_SCRATCH_BYTES = 512 * 2 ** 20


def _mma_chunks(h: int, h_kv: int, n_q: int, block_q: int,
                k_numel: int) -> tuple[int, int]:
    """(chunk_len, chunks) of the mma route's dK/dV kernel: a KV block's
    walk, (h / h_kv) * its count of (query head, q block) entries, is cut
    into chunks of ``chunk_len`` entries (``MMA_CHUNK_STEPS`` 16-row steps),
    one CTA each, so that a block that many q blocks visit (a global
    column; under GQA/MQA every head of the group) is not walked by one
    CTA. ``chunks`` covers the longest walk the pattern allows, and no more
    than the partials of ``MMA_SCRATCH_BYTES`` (2 chunks |k| fp32 values),
    past which the chunks grow longer. The grid is never sized from the
    counts: a chunk past its block's walk exits."""
    longest = (h // h_kv) * -(-n_q // block_q)
    chunks = -(-longest // max(1, MMA_CHUNK_STEPS // -(-block_q // 16)))
    chunks = max(1, min(chunks, MMA_SCRATCH_BYTES // (8 * k_numel)))
    return -(-longest // chunks), chunks


def _mma_scratch(q, k, spec: SparseSpec) -> tuple[torch.Tensor | None, list]:
    """(scratch, [its pointer, chunk_len, chunks]) of a backward call on the
    mma or the wide route, bf16 or fp32 (:func:`_mma_chunks`): the fp32 dK/dV partials
    of the blocks whose walk takes more than one chunk, 2 * chunks * |k|
    values (None where one chunk covers every walk)."""
    chunk_len, chunks = _mma_chunks(q.shape[1], k.shape[1], q.shape[2],
                                    spec.block_q, k.numel())
    scratch = None
    if chunks > 1:
        scratch = torch.empty(2 * chunks * k.numel(), dtype=torch.float32,
                              device=q.device)
    return scratch, [_ptr(scratch), chunk_len, chunks]


def _bwd_scratch(route: str, q, k,
                 spec: SparseSpec) -> tuple[torch.Tensor | None, list]:
    """(scratch, the arguments a route's backward entry takes after the
    stream): the fp32 tensor-core route's scratch and query-head splits
    (``flash_attn._wide_scratch``), the mma and wide routes' scratch and
    chunks (:func:`_mma_scratch`). The caller holds the scratch until its
    launches are issued."""
    if route in ("mma", "wide"):
        return _mma_scratch(q, k, spec)
    if route == "tc" and q.dtype == torch.float32:
        scratch, splits = _wide_scratch(q, k)
        return scratch, [_ptr(scratch), splits]
    return None, []


def _fwd_cuda(q, k, v, active, spec: SparseSpec):
    _check_cuda(q, k, v, active, spec)
    q, k, v = (_aligned16(t.contiguous()) for t in (q, k, v))
    b, h, n_q, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, n_q), dtype=torch.float32, device=q.device)
    if o.numel() == 0 or k.shape[2] == 0:
        return o.zero_(), lse.fill_(float("-inf"))
    kv_list, kv_count = compact_rows(active)
    route = _route(q.dtype, d, spec)
    err = kernel_fn("fwd", q.dtype, route)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        kv_list.data_ptr(), kv_count.data_ptr(), *_shape_args(q, k, spec),
        kv_list.shape[1], _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "sparse_fwd launch")
    sparse_attention.fwd_launches += 1
    sparse_attention.fwd_tc_launches += route == "tc"
    sparse_attention.fwd_mma_launches += route == "mma"
    sparse_attention.fwd_wide_launches += route == "wide"
    return o, lse


def _bwd_cuda(q, k, v, do, lse, di, active, spec: SparseSpec):
    _check_cuda(q, k, v, active, spec, do, lse)
    q, k, v, do = (_aligned16(t.contiguous()) for t in (q, k, v, do))
    lse, di = lse.float().contiguous(), di.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.shape[2] == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    kv_list, kv_count = compact_rows(active)
    q_list, q_count = compact_rows(active.t())
    route = _route(q.dtype, q.shape[3], spec)
    scratch, more = _bwd_scratch(route, q, k, spec)
    err = kernel_fn("bwd", q.dtype, route)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), kv_list.data_ptr(), kv_count.data_ptr(),
        q_list.data_ptr(), q_count.data_ptr(), *_shape_args(q, k, spec),
        kv_list.shape[1], q_list.shape[1], _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream, *more)
    _build.check(err, "sparse_bwd launch")
    sparse_attention.bwd_launches += 1
    sparse_attention.bwd_tc_launches += route == "tc"
    sparse_attention.bwd_mma_launches += route == "mma"
    sparse_attention.bwd_wide_launches += route == "wide"
    return dq, dk, dv


_SHAPE_ARGTYPES = [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 3


def _declare_fwd(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.fat_sparse_fwd, lib.fat_sparse_fwd_mma,
               lib.fat_sparse_fwd_mma_f32, lib.fat_sparse_fwd_sm90,
               lib.fat_sparse_fwd_sm90_f32):
        fn.restype = ctypes.c_int
        fn.argtypes = [p] * 7 + _SHAPE_ARGTYPES + [i, i, p]


def _declare_bwd(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.fat_sparse_bwd, lib.fat_sparse_bwd_mma,
               lib.fat_sparse_bwd_mma_f32, lib.fat_sparse_bwd_sm90,
               lib.fat_sparse_bwd_sm90_f32):
        fn.restype = ctypes.c_int
        fn.argtypes = [p] * 13 + _SHAPE_ARGTYPES + [i, i, i, p]
    # the fp32 route takes its scratch and query-head splits (used above
    # D = 128) last, the mma routes their scratch and their dK/dV chunks
    lib.fat_sparse_bwd_sm90_f32.argtypes = ([p] * 13 + _SHAPE_ARGTYPES
                                            + [i, i, i, p, p, i])
    for fn in (lib.fat_sparse_bwd_mma, lib.fat_sparse_bwd_mma_f32):
        fn.argtypes = [p] * 13 + _SHAPE_ARGTYPES + [i, i, i, p, p, i, i]


def _declare_wide(lib: ctypes.CDLL) -> None:
    """The wide kernels' entry points: the mma route's arguments."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fat_sparse_fwd_wide.restype = ctypes.c_int
    lib.fat_sparse_fwd_wide.argtypes = [p] * 7 + _SHAPE_ARGTYPES + [i, i, p]
    lib.fat_sparse_bwd_wide.restype = ctypes.c_int
    lib.fat_sparse_bwd_wide.argtypes = ([p] * 13 + _SHAPE_ARGTYPES
                                        + [i, i, i, p, p, i, i])


# ---------------------------------------------------------------------------
# Dispatch and autograd
# ---------------------------------------------------------------------------


def sparse_fwd(q, k, v, active, spec: SparseSpec):
    """(o, lse) for the tile map ``active`` (after :func:`tile_pattern`):
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.is_cuda:
        return _fwd_cuda(q, k, v, active, spec)
    return sparse_fwd_plain(q, k, v, active, spec)


def sparse_bwd(q, k, v, o, lse, do, dlse, active, spec: SparseSpec):
    """(dq, dk, dv) from the forward's o and LSE and the cotangents of both
    (``dlse`` may be None). ``di = rowsum(o·do) - dlse`` is a PyTorch op
    outside the kernels, as in ``ops/flash_attn.flash_bwd``."""
    di = (o.float() * do.float()).sum(dim=-1)
    if dlse is not None:
        di = di - dlse.float()
    if q.is_cuda:
        return _bwd_cuda(q, k, v, do, lse, di, active, spec)
    return sparse_bwd_plain(q, k, v, do, lse, di, active, spec)


class _SparseAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, pattern, spec):
        o, lse = sparse_fwd(q, k, v, _active(pattern, q, k, spec), spec)
        ctx.save_for_backward(q, k, v, pattern, o, lse)
        ctx.spec = spec
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, pattern, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        # the lists are rebuilt from the saved pattern, as the JAX VJP does
        active = _active(pattern, q, k, ctx.spec)
        dq, dk, dv = sparse_bwd(q, k, v, o, lse, do.to(o.dtype), dlse, active,
                                ctx.spec)
        return dq, dk, dv, None, None


def sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pattern: torch.Tensor | None, *, causal: bool = False,
                     softmax_scale: float | None = None, block_q: int = 128,
                     block_k: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-sparse flash attention (module docstring): q (B, H, N_q, D),
    k/v (B, H_kv, N_k, D) with H % H_kv == 0, ``pattern`` a bool
    (ceil(N_q / block_q), ceil(N_k / block_k)) tile map, True = attend, or
    None for all tiles. Returns (o in q's shape and dtype, fp32 LSE
    (B, H, N_q)), differentiable in q, k and v through both. A head dim
    that is not a multiple of 8 is padded with zeros up to the next one
    (``flash_attn.kernel_attention`` does the same, at every D), the
    default scale taken from the unpadded D, and o and the gradients sliced
    back."""
    if q.dim() != 4:
        raise ValueError(f"expected (B, H, N, D), got {tuple(q.shape)}")
    if k.dim() != 4 or tuple(v.shape) != tuple(k.shape) or \
            k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] or \
            q.shape[1] % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit together")
    d = q.shape[-1]
    spec = SparseSpec(
        causal=bool(causal),
        scale=float(d ** -0.5 if softmax_scale is None else softmax_scale),
        block_q=int(block_q), block_k=int(block_k))
    if pattern is not None:
        pattern = torch.as_tensor(pattern)
    pad = -d % 8
    if pad:
        q, k, v = (torch.nn.functional.pad(x, (0, pad)) for x in (q, k, v))
    o, lse = _SparseAttention.apply(q, k, v, pattern, spec)
    return (o[..., :d], lse) if pad else (o, lse)


sparse_attention.fwd_launches = 0
sparse_attention.bwd_launches = 0
sparse_attention.fwd_tc_launches = 0
sparse_attention.bwd_tc_launches = 0
sparse_attention.fwd_mma_launches = 0
sparse_attention.bwd_mma_launches = 0
sparse_attention.fwd_wide_launches = 0
sparse_attention.bwd_wide_launches = 0
