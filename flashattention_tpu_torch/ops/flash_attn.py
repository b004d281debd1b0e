"""Flash attention forward and backward: the dense training kernels.

The counterpart of ``flashattention_tpu/ops/pallas_attn.py``
(``pallas_attention`` and its custom VJP). On CUDA tensors
:func:`kernel_attention` launches hand-written kernels from
``csrc/flash_fwd.cu`` (the forward) and ``csrc/flash_bwd.cu`` (the
backward, one call of two ``__global__`` kernels: dK/dV, then dQ); on CPU
tensors it runs their plain PyTorch versions, :func:`flash_fwd_plain` and
:func:`flash_bwd_plain`. Nothing falls back: a CUDA input the kernels do
not take raises, and so does a failed build or launch.

Every call runs on the tensor cores, by dtype and head dim (:func:`_entry`):
up to D = 256 bf16 runs ``fat_flash_fwd_sm90`` / ``fat_flash_bwd_sm90``
(wgmma, tiles by TMA; above D = 128 the dK/dV kernel splits the head dim
between its two consumer warpgroups) and fp32 ``fat_flash_fwd_sm90_f32`` /
``fat_flash_bwd_sm90_f32`` (the same on 3xTF32 wgmma: each fp32 operand
split into two TF32 parts, three products summed in fp32,
``csrc/tf32_sm90.cuh``; above D = 128 the operands too large to keep in two
parts are split in registers). Above D = 256 both dtypes run
``fat_flash_fwd_wide`` / ``fat_flash_bwd_wide`` (``csrc/flash_wide.cu``),
for any head dim: the forward on mma.sync, every output cut into column
chunks, one CTA a chunk, each recomputing the scores over all of D; the
backward on wgmma (fp32 on 3xTF32) in thread block clusters along D, whose
CTAs multiply their own columns and sum the partial scores through
distributed shared memory, so the scores are computed once per tile
(:func:`_wide_bwd_plan`; fp32 above 8 chunks of 256 columns takes chunked
mma.sync kernels). The
sources' third entry points, the first kernels (fp32 FMAs on the CUDA
cores), are no route of this module: they stay as the comparison
``chip_smoke.py`` times.
``kernel_attention.fwd_launches`` and ``bwd_launches`` count every call.

Contract (as in the JAX package): q (B, H, N_q, D), k/v (B, H_kv, N_k, D)
with H % H_kv == 0 and any D (:func:`kernel_attention` pads a D that is
not a multiple of 8); returns o in q's shape and dtype and an fp32 LSE
(B, H, N_q). Query row r sits at key position r + q_offset (default
N_k - N_q). Scores go through one pipeline, in this order:

1. ``q·k`` in fp32, times ``softmax_scale``;
2. plus ALiBi, ``-slope_h * |col - (r + q_offset)|``;
3. the soft-cap ``c * tanh(s / c)``;
4. the mask: causal (col <= r + q_offset), the window band
   (col > r + q_offset - window, plus the first ``sinks`` columns) and
   equal segment ids; a masked score takes the finite
   ``DEFAULT_MASK_VALUE`` and its p is zeroed.

The LSE is taken before dropout. Dropout keeps an element by a murmur3
hash of (seed, b·H + h, absolute row, absolute col) (:func:`keep_mask`),
so every version, and ``pallas_attention(dropout_seed=s)``, draws the same
mask, and the backward replays it. A row with no visible key gives o = 0,
zero gradients and an LSE <= -1e30.

Rounding points follow the TPU kernels: the forward scales inside the fp32
dot; the backward forms ``q * scale`` in the input dtype; p is rounded to
the V/dO dtype before P·V and Pᵀ·dO, ds to the q dtype before dK and dQ;
every sum is fp32. So kernel and plain agree to about one bf16 ulp.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from flashattention_tpu_torch import _build
from flashattention_tpu_torch.ops.reference import (
    alibi_bias,
    band_mask,
    score_pipeline,
)

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
# The largest head dim of the wgmma kernels (flash_fwd.cu, flash_bwd.cu);
# above it the chunked kernels of flash_wide.cu take the call.
SM90_MAX_HEAD_DIM = 256
_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True, eq=False)
class AttnOpts:
    """Everything but q, k and v that fixes the attention function."""

    causal: bool
    scale: float
    offset: int                      # key position of query row 0
    window: int | None = None
    sinks: int = 0
    softcap: float | None = None
    dropout_rate: float = 0.0
    seed: int = 0                    # uint32
    q_ids: torch.Tensor | None = None   # (B, N_q) int32
    kv_ids: torch.Tensor | None = None  # (B, N_k) int32
    slopes: torch.Tensor | None = None  # (H,) float32


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def dropout_threshold(rate: float) -> int:
    """uint32 threshold: an element is kept iff its hash >= this."""
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & _M32) << 16
    return (lo + hi) & _M32


def keep_mask(seed: int, b: int, h: int, rows: torch.Tensor,
              cols: torch.Tensor, rate: float) -> torch.Tensor:
    """Dropout keep mask (B, H, len(rows), len(cols)) at absolute ``rows``
    and ``cols``: the murmur3 finalizer of
    ``row·0x9E3779B1 + col·0x85EBCA77 + seed + (b·H + h)·2654435761``
    in wrapping uint32 arithmetic, kept iff >= ``rate · 2**32``
    (``pallas_attn.py:357-383``)."""
    dev = rows.device
    bh = torch.arange(b * h, device=dev, dtype=torch.int64).reshape(b, h, 1, 1)
    x = (_mul32(rows.to(torch.int64)[:, None], 0x9E3779B1)
         + _mul32(cols.to(torch.int64)[None, :], 0x85EBCA77)
         + (int(seed) & _M32)
         + _mul32(bh, 2654435761)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x >= dropout_threshold(rate)


def visible_mask(opts: AttnOpts, n_q: int, n_k: int, device):
    """(B|1, 1, N_q, N_k) bool, True where a score is kept; None when
    nothing is masked."""
    vis = None
    if opts.causal:
        vis = band_mask(n_q, n_k, opts.offset, window=opts.window,
                        sinks=opts.sinks, device=device)[None, None]
    if opts.q_ids is not None:
        seg = (opts.q_ids[:, None, :, None] == opts.kv_ids[:, None, None, :])
        vis = seg if vis is None else (vis & seg)
    return vis


def _score_pipeline(s: torch.Tensor, opts: AttnOpts):
    """Steps 2-4 of the pipeline on scaled fp32 scores (B, H, N_q, N_k).
    Returns (s, visible or None, d(capped)/d(raw) or None)."""
    n_q, n_k = s.shape[-2:]
    dev = s.device
    bias = None
    if opts.slopes is not None:
        bias = alibi_bias(opts.slopes, torch.arange(n_q, device=dev)
                          + opts.offset, torch.arange(n_k, device=dev))
    vis = visible_mask(opts, n_q, n_k, dev)
    s, dcap = score_pipeline(s, bias=bias, softcap=opts.softcap, visible=vis)
    return s, vis, dcap


def _expand_kv(t: torch.Tensor, h: int) -> torch.Tensor:
    return t.repeat_interleave(h // t.shape[1], dim=1)


def _group_sum(t: torch.Tensor, h_kv: int) -> torch.Tensor:
    b, h, n, d = t.shape
    return t.reshape(b, h_kv, h // h_kv, n, d).sum(dim=2)


def _dropout_keep(opts: AttnOpts, b, h, n_q, n_k, device):
    return keep_mask(opts.seed, b, h, torch.arange(n_q, device=device),
                     torch.arange(n_k, device=device), opts.dropout_rate)


def flash_fwd_plain(q, k, v, opts: AttnOpts):
    """The forward kernel's function in plain PyTorch, dense: (o, lse)."""
    b, h, n_q, _ = q.shape
    n_k = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     _expand_kv(k, h).float()) * opts.scale
    s, vis, _ = _score_pipeline(s, opts)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if vis is not None:
        p = torch.where(vis, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    if opts.dropout_rate > 0.0:
        keep = _dropout_keep(opts, b, h, n_q, n_k, q.device)
        p = torch.where(keep, p * (1.0 / (1.0 - opts.dropout_rate)),
                        torch.zeros_like(p))
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                     _expand_kv(v, h).float())
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / l_safe).to(q.dtype), (m + torch.log(l_safe))[..., 0]


def flash_bwd_plain(q, k, v, do, lse, di, opts: AttnOpts):
    """The backward kernels' function in plain PyTorch, dense: dq, dk, dv
    from the saved LSE and ``di = rowsum(o·do) - dlse``."""
    b, h, n_q, _ = q.shape
    h_kv, n_k = k.shape[1], k.shape[2]
    qs = (q * torch.tensor(opts.scale, dtype=q.dtype, device=q.device)).float()
    kf = _expand_kv(k, h).float()
    dof = do.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qs, kf)
    s, vis, dcap = _score_pipeline(s, opts)
    p = torch.exp(s - lse.float()[..., None])
    if vis is not None:
        p = torch.where(vis, p, torch.zeros_like(p))
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, _expand_kv(v, h).float())
    p_v = p
    if opts.dropout_rate > 0.0:
        keep = _dropout_keep(opts, b, h, n_q, n_k, q.device)
        inv = 1.0 / (1.0 - opts.dropout_rate)
        p_v = torch.where(keep, p * inv, torch.zeros_like(p))
        dp = torch.where(keep, dp * inv, torch.zeros_like(dp))
    dv = torch.einsum("bhqk,bhqd->bhkd", p_v.to(do.dtype).float(), dof)
    ds = p * (dp - di.float()[..., None])
    if dcap is not None:
        ds = ds * dcap
    ds = ds.to(q.dtype).float()
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qs)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * opts.scale
    return (dq.to(q.dtype), _group_sum(dk, h_kv).to(k.dtype),
            _group_sum(dv, h_kv).to(v.dtype))


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def _ptr(t):
    return None if t is None else t.data_ptr()


def _entry_name(prefix: str, dtype, d: int) -> tuple[str, str]:
    """(kernel library, entry point) of ``prefix`` ("fat_flash_fwd" or
    "fat_flash_bwd") for ``dtype`` and head dim ``d``, all on the tensor
    cores. Up to :data:`SM90_MAX_HEAD_DIM` (256): bf16 wgmma, or fp32 on
    3xTF32, which keeps the fp32 1e-4 limit where one TF32 product would
    not (above D = 128 its kernels split the operands they keep as landed in
    registers, ``csrc/tf32_sm90.cuh``). Above: the chunked mma.sync kernels
    of ``csrc/flash_wide.cu``, both dtypes in one entry point."""
    if d > SM90_MAX_HEAD_DIM:
        return "flash_wide", prefix + "_wide"
    lib = "flash_fwd" if prefix == "fat_flash_fwd" else "flash_bwd"
    return lib, prefix + ("_sm90_f32" if dtype == torch.float32 else "_sm90")


def _entry(prefix: str, dtype, d: int):
    """The loaded entry point :func:`_entry_name` names."""
    lib, name = _entry_name(prefix, dtype, d)
    return getattr(_build.load_kernel(lib, _DECLARE[lib]), name)


def route_kernels(dtype, d: int, kv_splits: int = 1) -> frozenset[str]:
    """The ``__global__`` kernels a forward and a backward call launch for
    ``dtype`` and head dim ``d`` (their names in a profiler trace). fp32
    at 128 < D <= 256 adds the split of the backward's B operands, and under
    GQA/MQA may add ``kv_sum_kernel`` (:func:`_kv_splits`). Above D = 256
    the forward is flash_wide.cu's chunked kernel and the backward its
    cluster kernels (fp32 with the split of its B operands), with
    ``kv_sum_kernel`` where ``kv_splits`` > 1 (:func:`_wide_bwd_plan`);
    fp32 above 8 chunks of 256 columns takes its chunked mma.sync kernels
    (:func:`_wide_cluster`)."""
    if d > SM90_MAX_HEAD_DIM:
        if not _wide_cluster(dtype, d):
            return frozenset({"flash_fwd_wide_kernel",
                              "flash_bwd_dkv_wide_kernel",
                              "flash_bwd_dq_wide_kernel"})
        tag = "wide_sm90" if dtype == torch.bfloat16 else "wide_f32_sm90"
        names = {"flash_fwd_wide_kernel", f"flash_bwd_dkv_{tag}_kernel",
                 f"flash_bwd_dq_{tag}_kernel"}
        if dtype == torch.float32:
            names.add("tf32_split_kernel")
        if kv_splits > 1:
            names.add("kv_sum_kernel")
        return frozenset(names)
    if dtype == torch.bfloat16:
        tag = "sm90"
    else:
        tag = "f32_wide_sm90" if d > 128 else "f32_sm90"
    names = {f"flash_fwd_{tag}_kernel", f"flash_bwd_dkv_{tag}_kernel",
             f"flash_bwd_dq_{tag}_kernel"}
    if tag == "f32_wide_sm90":
        names.add("tf32_split_kernel")
    return frozenset(names)


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if its data starts on a 16-byte boundary (as TMA needs),
    else a contiguous copy; never refused."""
    return t if t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format)


def _check_cuda(q, k, v, opts: AttnOpts, *others):
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash attention kernels take bf16/fp32, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q ({q.dtype}), k ({k.dtype}) and v ({v.dtype}) "
                        "must share a dtype")
    b, h, n_q, d = q.shape
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != d or \
            h % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit together")
    want = {"do": q.shape, "lse": (b, h, n_q)}
    for name, t in others:
        if tuple(t.shape) != tuple(want[name]):
            raise ValueError(f"{name} must be {tuple(want[name])}, is "
                             f"{tuple(t.shape)}")
    extra = [("q_ids", opts.q_ids), ("kv_ids", opts.kv_ids),
             ("alibi_slopes", opts.slopes)]
    for name, t in [("q", q), ("k", k), ("v", v), *others, *extra]:
        if t is None:
            continue
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, is on {t.device}")


def _scalars(q, k, opts: AttnOpts):
    b, h, n_q, d = q.shape
    h_kv, n_k = k.shape[1], k.shape[2]
    cap = opts.softcap
    rate = opts.dropout_rate
    return [
        b, h, h_kv, n_q, n_k, d, float(opts.scale), int(opts.causal),
        int(opts.offset), int(opts.window or 0), int(opts.sinks),
        float(cap or 0.0), float(1.0 / cap) if cap else 0.0,
        int(rate > 0.0), dropout_threshold(rate) if rate > 0.0 else 0,
        int(opts.seed) & _M32, float(1.0 / (1.0 - rate)) if rate > 0.0 else 1.0,
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    ]


def _fwd_cuda(q, k, v, opts: AttnOpts):
    _check_cuda(q, k, v, opts)
    q, k, v = (_aligned16(t.contiguous()) for t in (q, k, v))
    b, h, n_q, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, n_q), dtype=torch.float32, device=q.device)
    if o.numel() == 0 or k.shape[2] == 0:
        return o.zero_(), lse.fill_(float("-inf"))
    fn = _entry("fat_flash_fwd", q.dtype, q.shape[3])
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        _ptr(opts.q_ids), _ptr(opts.kv_ids), _ptr(opts.slopes),
        *_scalars(q, k, opts),
    )
    _build.check(err, "flash_fwd launch")
    kernel_attention.fwd_launches += 1
    return o, lse


def _bwd_cuda(q, k, v, do, lse, di, opts: AttnOpts):
    _check_cuda(q, k, v, opts, ("do", do), ("lse", lse))
    q, k, v, do = (_aligned16(t.contiguous()) for t in (q, k, v, do))
    lse, di = lse.contiguous(), di.contiguous()
    if do.dtype != q.dtype:
        raise TypeError(f"do ({do.dtype}) must have q's dtype ({q.dtype})")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.shape[2] == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    fn = _entry("fat_flash_bwd", q.dtype, q.shape[3])
    more = []
    if q.shape[3] > SM90_MAX_HEAD_DIM:
        scratch, plan = _wide_bwd_scratch(q, k)
        more = [_ptr(scratch), plan["cluster"], plan["groups"],
                plan["kv_splits"]]
    elif q.dtype == torch.float32:
        scratch, splits = _wide_scratch(q, k)
        more = [_ptr(scratch), splits]
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), _ptr(opts.q_ids), _ptr(opts.kv_ids), _ptr(opts.slopes),
        *_scalars(q, k, opts), *more,
    )
    _build.check(err, "flash_bwd launch")
    kernel_attention.bwd_launches += 1
    return dq, dk, dv


def _kv_splits(kv_heads: int, n_k: int, group: int, sms: int) -> int:
    """How many CTAs of the fp32 dK/dV kernel above D = 128 share one KV
    head's group of query heads (``kv_heads`` = B * H_kv, 64 keys a CTA):
    doubled, while it divides the group, until the kernel has two CTAs for
    each of the card's ``sms``. A GQA or MQA call with few KV heads
    otherwise leaves SMs idle while each CTA walks every query head of its
    group."""
    ctas = kv_heads * -(-n_k // 64)
    splits = 1
    while group % (2 * splits) == 0 and ctas * splits < 2 * sms:
        splits *= 2
    return splits


# Above D = 256 the backward's CTAs each hold WIDE_BWD_COLS columns of D;
# the CTAs of one tile form a cluster of at most WIDE_MAX_CLUSTER (the
# portable cluster size), and above that many chunks bf16 clusters repeat
# along D (csrc/flash_wide.cu).
WIDE_BWD_COLS = 256
WIDE_MAX_CLUSTER = 8


def _wide_cluster(dtype, d: int) -> bool:
    """True where the backward above D = 256 runs the cluster kernels:
    bf16 at every head dim, fp32 up to WIDE_MAX_CLUSTER chunks (D <= 2048;
    above, the fp32 chunked mma.sync kernels, whose clusters cannot
    repeat)."""
    return dtype == torch.bfloat16 or \
        -(-d // WIDE_BWD_COLS) <= WIDE_MAX_CLUSTER


def _wide_bwd_plan(dtype, d: int, b: int, h: int, h_kv: int, n_k: int,
                   sms: int) -> dict:
    """The backward's launch plan above D = 256, from shapes only: D in
    ``chunks`` of ``cols`` (:data:`WIDE_BWD_COLS`) columns, one CTA a
    chunk; the chunks of one tile in ``groups`` thread block clusters of
    ``cluster`` CTAs (as few clusters as :data:`WIDE_MAX_CLUSTER` allows,
    then as few CTAs each: ``cluster * groups`` >= ``chunks``, every
    cluster computing the scores over all of D); the dK/dV kernel's
    query-head walk of a KV head cut over ``kv_splits`` clusters
    (:func:`_kv_splits` over its ``B * H_kv * cluster * groups`` CTAs of 64
    keys). Where :func:`_wide_cluster` says no: cluster 0 (the chunked
    kernels), no splits."""
    chunks = -(-d // WIDE_BWD_COLS)
    if not _wide_cluster(dtype, d):
        return dict(cols=WIDE_BWD_COLS, chunks=chunks, cluster=0, groups=0,
                    kv_splits=1)
    groups = -(-chunks // WIDE_MAX_CLUSTER)
    cluster = -(-chunks // groups)
    splits = _kv_splits(b * h_kv * cluster * groups, n_k, h // h_kv, sms)
    return dict(cols=WIDE_BWD_COLS, chunks=chunks, cluster=cluster,
                groups=groups, kv_splits=splits)


def _wide_bwd_scratch(q, k) -> tuple[torch.Tensor | None, dict]:
    """(scratch, plan) of a backward call above D = 256: the plan
    (:func:`_wide_bwd_plan`) and fp32 scratch: in fp32 the two TF32 parts
    of q times the scale, do, k and v (4 (|q| + |k|) floats), made once by
    the call (``csrc/tf32_wide_bwd.cuh``); then, where the plan splits the
    dK/dV walk, the splits' partial dK and dV (2 kv_splits |k| floats)."""
    plan = _wide_bwd_plan(
        q.dtype, q.shape[3], q.shape[0], q.shape[1], k.shape[1], k.shape[2],
        torch.cuda.get_device_properties(q.device).multi_processor_count)
    n = 0
    if q.dtype == torch.float32 and plan["cluster"]:
        n = 4 * (q.numel() + k.numel())
    if plan["kv_splits"] > 1:
        n += 2 * plan["kv_splits"] * k.numel()
    scratch = (torch.empty(n, dtype=torch.float32, device=q.device)
               if n else None)
    return scratch, plan


def _wide_scratch(q, k) -> tuple[torch.Tensor | None, int]:
    """(scratch, kv_splits) of a backward call on an fp32 tensor-core route
    (this module's and ``sparse_attn``'s): above D = 128 the two TF32 parts
    of q, do, k and v, made once by the call (``csrc/tf32_wide_bwd.cuh``),
    then the dK/dV partial sums of a query-head group spread over
    ``kv_splits`` CTAs (:func:`_kv_splits`); (None, 1) at D <= 128."""
    if q.shape[3] <= 128:
        return None, 1
    splits = _kv_splits(
        k.shape[0] * k.shape[1], k.shape[2], q.shape[1] // k.shape[1],
        torch.cuda.get_device_properties(q.device).multi_processor_count)
    scratch = torch.empty(
        4 * (q.numel() + k.numel())
        + (2 * splits * k.numel() if splits > 1 else 0),
        dtype=torch.float32, device=q.device)
    return scratch, splits


def _scalar_argtypes():
    i, f, u, p = ctypes.c_int, ctypes.c_float, ctypes.c_uint32, ctypes.c_void_p
    return [i, i, i, i, i, i, f, i, i, i, i, f, f, i, u, u, f, i, p]


def _declare_fwd(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    for fn in (lib.fat_flash_fwd, lib.fat_flash_fwd_sm90,
               lib.fat_flash_fwd_sm90_f32):
        fn.restype = ctypes.c_int
        fn.argtypes = [p] * 8 + _scalar_argtypes()


def _declare_bwd(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    for fn in (lib.fat_flash_bwd, lib.fat_flash_bwd_sm90,
               lib.fat_flash_bwd_sm90_f32):
        fn.restype = ctypes.c_int
        fn.argtypes = [p] * 12 + _scalar_argtypes()
    # the fp32 route takes its scratch and query-head splits (used above
    # D = 128) last
    lib.fat_flash_bwd_sm90_f32.argtypes = ([p] * 12 + _scalar_argtypes()
                                           + [p, ctypes.c_int])


def _declare_wide(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn, n in ((lib.fat_flash_fwd_wide, 8), (lib.fat_flash_bwd_wide, 12)):
        fn.restype = ctypes.c_int
        fn.argtypes = [p] * n + _scalar_argtypes()
    # the backward's plan last: scratch, cluster, groups, kv_splits
    lib.fat_flash_bwd_wide.argtypes += [p, i, i, i]


# kernel library -> the function that declares its entry points
_DECLARE = {"flash_fwd": _declare_fwd, "flash_bwd": _declare_bwd,
            "flash_wide": _declare_wide}


# ---------------------------------------------------------------------------
# Dispatch and autograd
# ---------------------------------------------------------------------------


def flash_fwd(q, k, v, opts: AttnOpts):
    """(o, lse): the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if q.is_cuda:
        return _fwd_cuda(q, k, v, opts)
    return flash_fwd_plain(q, k, v, opts)


def flash_bwd(q, k, v, o, lse, do, dlse, opts: AttnOpts):
    """(dq, dk, dv) from the forward's o and LSE and the cotangents of both
    (``dlse`` may be None). ``di = rowsum(o·do) - dlse`` is a PyTorch op,
    as it is XLA outside the kernels in the JAX package."""
    di = (o.float() * do.float()).sum(dim=-1)
    if dlse is not None:
        di = di - dlse.float()
    return flash_bwd_di(q, k, v, do, lse, di, opts)


def flash_bwd_di(q, k, v, do, lse, di, opts: AttnOpts):
    """(dq, dk, dv) from a given LSE and ``di``: the backward kernels (CUDA
    tensors) or their plain version (CPU tensors). Ring attention passes
    the merged output's LSE and di to every partial."""
    if q.is_cuda:
        return _bwd_cuda(q, k, v, do, lse, di, opts)
    return flash_bwd_plain(q, k, v, do, lse, di, opts)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, opts):
        o, lse = flash_fwd(q, k, v, opts)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = opts
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.to(o.dtype), dlse, ctx.opts)
        return dq, dk, dv, None


def make_opts(q, k, *, causal=False, softmax_scale=None, dropout_rate=0.0,
              dropout_seed=None, q_offset=None, window=None, segment_ids=None,
              softcap=None, alibi_slopes=None, sinks=0) -> AttnOpts:
    """Check the arguments as ``pallas_attention`` does and fold them into
    :class:`AttnOpts`."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"expected (B, H, N, D), got {tuple(q.shape)}")
    b, h, n_q, d = q.shape
    if h % k.shape[1] != 0:
        raise ValueError(f"H={h} must be a multiple of H_kv={k.shape[1]}")
    if d < 1 or d % 8:
        raise ValueError(f"head_dim must be a multiple of 8, got {d}")
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if sinks:
        if window is None:
            raise ValueError("sinks require window= (StreamingLLM band)")
        if sinks < 0:
            raise ValueError(f"sinks must be >= 0, got {sinks}")
    n_k = k.shape[2]
    q_ids = kv_ids = None
    if segment_ids is not None:
        if isinstance(segment_ids, (tuple, list)):
            if len(segment_ids) != 2:
                raise ValueError("segment_ids pair must be (q_ids, kv_ids), "
                                 f"got {len(segment_ids)} elements")
            q_ids, kv_ids = segment_ids
        else:
            if n_q != n_k:
                raise ValueError(
                    f"one segment_ids array requires q_len == k_len ({n_q} != "
                    f"{n_k}); pass a (q_ids, kv_ids) pair")
            q_ids = kv_ids = segment_ids
        q_ids = torch.as_tensor(q_ids).to(device=q.device,
                                          dtype=torch.int32).contiguous()
        kv_ids = torch.as_tensor(kv_ids).to(device=q.device,
                                            dtype=torch.int32).contiguous()
        if tuple(q_ids.shape) != (b, n_q):
            raise ValueError(f"q segment_ids must be (B, N_q)={(b, n_q)}, got "
                             f"{tuple(q_ids.shape)}")
        if tuple(kv_ids.shape) != (b, n_k):
            raise ValueError(f"kv segment_ids must be (B, N_k)={(b, n_k)}, got "
                             f"{tuple(kv_ids.shape)}")
    slopes = None
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes).to(
            device=q.device, dtype=torch.float32).reshape(-1).contiguous()
        if tuple(slopes.shape) != (h,):
            raise ValueError(f"alibi_slopes must be (H,)=({h},), got "
                             f"{tuple(slopes.shape)}")
    return AttnOpts(
        causal=bool(causal),
        scale=float(d ** -0.5 if softmax_scale is None else softmax_scale),
        offset=int(n_k - n_q if q_offset is None else q_offset),
        window=None if window is None else int(window), sinks=int(sinks),
        softcap=None if softcap is None else float(softcap),
        dropout_rate=float(dropout_rate),
        seed=int(dropout_seed or 0) & _M32,
        q_ids=q_ids, kv_ids=kv_ids, slopes=slopes,
    )


def kernel_attention(q, k, v, *, causal=False, softmax_scale=None,
                     dropout_rate=0.0, dropout_seed=None, q_offset=None,
                     window=None, segment_ids=None, softcap=None,
                     alibi_slopes=None, sinks=0):
    """Flash attention (module docstring): (o, lse), differentiable in q,
    k and v through both outputs.

    Launches ``csrc/flash_fwd.cu`` for CUDA tensors (counted in
    ``kernel_attention.fwd_launches``) and, in the backward,
    ``csrc/flash_bwd.cu`` (``kernel_attention.bwd_launches``). CPU tensors
    run the plain versions.
    ``dropout_seed`` is an int (taken mod 2**32). A head dim that is not a
    multiple of 8 is padded with zeros up to the next one, as
    ``pallas_attention`` pads its head dim: zero columns change no score,
    the default scale is the unpadded D's, and o and the gradients are
    sliced back to D."""
    d = q.shape[-1]
    pad = -d % 8
    if pad:
        if softmax_scale is None:
            softmax_scale = d ** -0.5
        q, k, v = (torch.nn.functional.pad(x, (0, pad)) for x in (q, k, v))
    opts = make_opts(q, k, causal=causal, softmax_scale=softmax_scale,
                     dropout_rate=dropout_rate, dropout_seed=dropout_seed,
                     q_offset=q_offset, window=window, segment_ids=segment_ids,
                     softcap=softcap, alibi_slopes=alibi_slopes, sinks=sinks)
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"v {tuple(v.shape)} must match k {tuple(k.shape)}")
    o, lse = _FlashAttention.apply(q, k, v, opts)
    return (o[..., :d], lse) if pad else (o, lse)


kernel_attention.fwd_launches = 0
kernel_attention.bwd_launches = 0


def kernel_attention_plain(q, k, v, **kwargs):
    """The forward's plain version with :func:`kernel_attention`'s
    arguments: (o, lse), on any device, never a kernel."""
    return flash_fwd_plain(q, k, v, make_opts(q, k, **kwargs))
