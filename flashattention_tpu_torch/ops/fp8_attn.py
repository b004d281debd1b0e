"""FA3 8-bit attention: e4m3, e5m2 or int8 payloads with per-block scales.

The counterpart of ``flashattention_tpu/ops/pallas_fp8.py``
(``pallas_fp8_attention``). q, k and v are quantized per (batch, head,
sequence block) with fp32 scales (``ops/quant.py``; blocks as in
``ops/specs.fp8_kernel_blocks``). Two execution modes compute the same
quantized function:

- ``"fused"``: the 1-byte payloads go to the hand-written kernel
  ``csrc/flash_fwd_fp8.cu`` (on CUDA tensors; counted in
  ``fp8_attention.launches``), or to its plain version
  :func:`fp8_fwd_plain` on CPU tensors. ``"fused_cached"`` runs the same
  kernel: decoding each tile once was a TPU VMEM schedule, not another
  function. Every call with key blocks a multiple of 128 and D <= 256
  takes the tensor-core route (:func:`_tensor_core_route`): Q·Kᵀ on 8-bit
  wgmma and P·V on bf16 wgmma (``fat_flash_fwd_fp8_sm90``, counted also in
  ``fp8_attention.tc_launches``), in both ``int8_pv`` settings (s8's p8
  are integers, exact in bf16). Every call above D = 256 takes the wide
  route (:func:`_wide_route`, any head dim): ``csrc/fp8_wide.cu``'s
  ``fat_flash_fwd_fp8_wide`` on mma.sync, O cut into column chunks and
  Q·Kᵀ over all of D in every chunk's CTA (counted also in
  ``fp8_attention.wide_launches``). On both, a head dim that is not a
  multiple of 16 is padded with zero bytes first (:func:`kernel_head_dim`).
  The fp32 FMA kernel (``fat_flash_fwd_fp8``, D <= 256) takes only key
  blocks that are not whole 128s, which :func:`fp8_attention` never
  quantizes in (its blocks come from ``specs.fp8_kernel_blocks``;
  :func:`fp8_attention_prequant` can be handed such scales); chip_smoke
  times it beside the tensor-core route.
- ``"predecode"``: the payloads are dequantized to bf16 in PyTorch ops and
  the flash forward (``ops/flash_attn.flash_fwd``, kernel B1) runs on them.

``"auto"`` is the JAX rule: fused for int8 payloads or a single q block
(n_q <= block_q), predecode otherwise.

The fused function. Payloads are decoded exactly. Scores are the fp32 dot
of the decoded q and k (an exact integer dot for int8) times
``(sq[row block] * sk[col block]) * softmax_scale``, then ALiBi, the
soft-cap and the mask, as in ``ops/flash_attn``. The LSE is taken from
these quantized scores, before dropout. p is rounded to bf16 before P.V
and the contribution of each key is multiplied by ``sv[col block]``. With
int8 payloads and ``int8_pv="s8"`` p is instead re-quantized to int8 per
row and key block: ``ps = max(max p, 1e-30) * (1/127)``,
``p8 = round(p / ps)``, contribution ``(p8 . v8) * ps * sv``. The output
has q's dtype.

The backward is the straight-through estimator: the flash backward
(kernels B2/B3) on the dequantized bf16 inputs (``ste="dequant"``, the
default) or on the original inputs cast to bf16 (``ste="original"``), with
the LSE cotangent; dq comes back in q's dtype, dk/dv in k's and v's.

The JAX package reads the knobs ``FAT_INT8_PV`` and ``FAT_STE_GRADS`` from
the environment; here they are the arguments ``int8_pv`` and ``ste``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from flashattention_tpu_torch import _build
from flashattention_tpu_torch.ops import flash_attn as fa
from flashattention_tpu_torch.ops.quant import (
    FMT_OF_DTYPE,
    dequantize_bf16,
    inv_qmax,
    per_position,
    quantize_blocks,
)
from flashattention_tpu_torch.ops.specs import (
    FP8_KERNEL_BLOCK_K,
    FP8_KERNEL_BLOCK_Q,
    fp8_kernel_blocks,
)

MODES = ("auto", "fused", "fused_cached", "predecode")
_FMT_CODE = {"fp8": 0, "e5m2": 1, "int8": 2}
_OUT_CODE = {torch.bfloat16: 0, torch.float32: 1}


@dataclasses.dataclass(frozen=True)
class Fp8Config:
    """The non-tensor arguments that fix the quantized function."""

    block_q: int
    block_k: int
    mode: str
    fmt: str
    int8_pv: str
    ste: str


# ---------------------------------------------------------------------------
# Quantization of the inputs
# ---------------------------------------------------------------------------


def _pad_seq(x: torch.Tensor, block: int) -> torch.Tensor:
    pad = -x.shape[2] % block
    return F.pad(x, (0, 0, 0, pad)) if pad else x


def quantize_inputs(q, k, v, block_q, block_k, fmt):
    """(q8, k8, v8, sq, sk, sv, bq, bk): payloads of q, k, v's lengths and
    fp32 scales (B, H|H_kv, ceil(N / block)). A ragged last block is
    quantized as if padded with zeros (``pallas_fp8._prepare_fp8``), which
    leaves its absmax unchanged."""
    n_q, n_k = q.shape[2], k.shape[2]
    bq, bk = fp8_kernel_blocks(n_q, n_k, block_q, block_k)
    q8, sq = quantize_blocks(_pad_seq(q, bq), bq, fmt)
    k8, sk = quantize_blocks(_pad_seq(k, bk), bk, fmt)
    v8, sv = quantize_blocks(_pad_seq(v, bk), bk, fmt)
    return (q8[:, :, :n_q].contiguous(), k8[:, :, :n_k].contiguous(),
            v8[:, :, :n_k].contiguous(), sq.contiguous(), sk.contiguous(),
            sv.contiguous(), bq, bk)


# ---------------------------------------------------------------------------
# Plain version of the fused kernel
# ---------------------------------------------------------------------------


def fp8_fwd_plain(q8, k8, v8, sq, sk, sv, bq, bk, opts: fa.AttnOpts, *,
                  int8_pv="bf16", out_dtype=torch.bfloat16):
    """The fused kernel's function in plain PyTorch, dense: (o, lse)."""
    b, h, n_q, _ = q8.shape
    h_kv, n_k = k8.shape[1], k8.shape[2]
    g = h // h_kv
    sq_r = per_position(sq, bq, n_q)                                 # (B,H,Nq)
    sk_c = per_position(sk, bk, n_k).repeat_interleave(g, dim=1)    # (B,H,Nk)
    sv_c = per_position(sv, bk, n_k).repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q8.float(),
                     fa._expand_kv(k8.float(), h))
    s = s * ((sq_r[..., :, None] * sk_c[..., None, :]) * opts.scale)
    s, vis, _ = fa._score_pipeline(s, opts)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if vis is not None:
        p = torch.where(vis, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    if opts.dropout_rate > 0.0:
        keep = fa._dropout_keep(opts, b, h, n_q, n_k, q8.device)
        p = torch.where(keep, p * (1.0 / (1.0 - opts.dropout_rate)),
                        torch.zeros_like(p))
    vf = fa._expand_kv(v8.float(), h)
    if int8_pv == "s8":
        nb = -(-n_k // bk)
        pb = F.pad(p, (0, nb * bk - n_k)).reshape(b, h, n_q, nb, bk)
        ps = torch.clamp(pb.amax(dim=-1, keepdim=True), min=1e-30)
        ps = ps * inv_qmax("int8")
        p8 = torch.round(pb / ps)
        vb = F.pad(vf, (0, 0, 0, nb * bk - n_k)).reshape(b, h, nb, bk, -1)
        part = torch.einsum("bhqnk,bhnkd->bhqnd", p8, vb) * ps
        svb = sv.repeat_interleave(g, dim=1)[:, :, None, :, None]
        o = (part * svb).sum(dim=3)
    else:
        pc = p.to(torch.bfloat16).float() * sv_c[..., None, :]
        o = torch.einsum("bhqk,bhkd->bhqd", pc, vf)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / l_safe).to(out_dtype), (m + torch.log(l_safe))[..., 0]


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------


def _ptr(t):
    return None if t is None else t.data_ptr()


# The largest head dim of the wgmma and FMA kernels; above it the wide
# kernels (csrc/fp8_wide.cu) take every call, at any head dim.
SM90_MAX_HEAD_DIM = 256


def _tensor_core_route(d: int, bk: int) -> bool:
    """True where the tensor-core kernel takes the call, in either
    ``int8_pv`` setting: D <= 256 (128 < D <= 256 runs the D = 256
    kernels; a head dim below the kernel's reads zeros past D) and key
    blocks a multiple of 128, so that one key tile never spans two v
    scales."""
    return d <= SM90_MAX_HEAD_DIM and bk % 128 == 0


def _wide_route(d: int) -> bool:
    """True where the wide kernels take the call: every head dim above
    256, every format, both ``int8_pv`` settings and any key block (a
    32-key tile that spans two blocks runs its P.V once a block), but for
    ``int8_pv="s8"``, whose key blocks must be multiples of the 32-key
    tile (:func:`_fwd_cuda` raises)."""
    return d > SM90_MAX_HEAD_DIM


def kernel_head_dim(d: int) -> int:
    """The head dim the tensor-core kernel runs a call of head dim ``d``
    at: ``d`` rounded up to a multiple of 16, so that a payload row is a
    whole number of 16-byte units, as TMA's strides must be."""
    return -(-d // 16) * 16


def pad_head(x: torch.Tensor, width: int) -> torch.Tensor:
    """Payloads (..., D) padded with zero bytes to ``width`` columns. A
    zero byte decodes to 0 in int8, e4m3 and e5m2, and the scales were
    taken before the pad, so the attention of the padded payloads is the
    same function with zero columns of o past D."""
    d = x.shape[-1]
    if width == d:
        return x
    out = torch.zeros(x.shape[:-1] + (width,), dtype=x.dtype,
                      device=x.device)
    out[..., :d] = x
    return out


def _fwd_cuda(q8, k8, v8, sq, sk, sv, bq, bk, opts, int8_pv, out_dtype):
    fmt = FMT_OF_DTYPE.get(q8.dtype)
    if fmt is None or k8.dtype != q8.dtype or v8.dtype != q8.dtype:
        raise TypeError(f"payloads must share an 8-bit dtype, got {q8.dtype}, "
                        f"{k8.dtype}, {v8.dtype}")
    if out_dtype not in _OUT_CODE:
        raise TypeError(f"the fp8 kernel writes bf16/fp32, not {out_dtype}")
    b, h, n_q, d = q8.shape
    wide = _wide_route(d)
    if wide and int8_pv == "s8" and bk % 32:
        raise ValueError(f"key blocks of {bk}: above head dim "
                         f"{SM90_MAX_HEAD_DIM} int8_pv='s8' takes key blocks "
                         f"that are multiples of 32")
    h_kv, n_k = k8.shape[1], k8.shape[2]
    want = {"sq": (b, h, -(-n_q // bq)), "sk": (b, h_kv, -(-n_k // bk)),
            "sv": (b, h_kv, -(-n_k // bk))}
    for name, t in (("q8", q8), ("k8", k8), ("v8", v8), ("sq", sq),
                    ("sk", sk), ("sv", sv), ("q_ids", opts.q_ids),
                    ("kv_ids", opts.kv_ids), ("alibi_slopes", opts.slopes)):
        if t is None:
            continue
        if not t.is_cuda or t.device != q8.device:
            raise ValueError(f"{name} must be on {q8.device}, is on {t.device}")
        if name in want:
            if t.dtype != torch.float32 or tuple(t.shape) != want[name]:
                raise ValueError(f"{name} must be float32 {want[name]}, is "
                                 f"{t.dtype} {tuple(t.shape)}")
    tc = _tensor_core_route(d, bk)
    s8 = int8_pv == "s8"
    dk = kernel_head_dim(d) if tc or wide else d
    q8, k8, v8 = (fa._aligned16(pad_head(x.contiguous(), dk))
                  for x in (q8, k8, v8))
    sq, sk, sv = sq.contiguous(), sk.contiguous(), sv.contiguous()
    o = torch.empty((b, h, n_q, dk), dtype=out_dtype, device=q8.device)
    lse = torch.empty((b, h, n_q), dtype=torch.float32, device=q8.device)
    if o.numel() == 0 or n_k == 0:
        return o.zero_()[..., :d].contiguous(), lse.fill_(float("-inf"))
    # s8: each row's largest kept score in each key block, written by the
    # kernel's first pass and read by its second; on the wide route one
    # slot for each O chunk of 128 columns, whose CTAs write their own
    slots = -(-dk // 128) if wide else 1
    bmax = (torch.empty(slots * b * h * n_q * -(-n_k // bk),
                        dtype=torch.float32, device=q8.device)
            if (tc or wide) and s8 else None)
    cap, rate = opts.softcap, opts.dropout_rate
    lib = _build.load_kernel("fp8_wide" if wide else "flash_fwd_fp8",
                             _declare_wide if wide else _declare)
    args = (
        q8.data_ptr(), k8.data_ptr(), v8.data_ptr(), sq.data_ptr(),
        sk.data_ptr(), sv.data_ptr(), o.data_ptr(), lse.data_ptr(),
        _ptr(opts.q_ids), _ptr(opts.kv_ids), _ptr(opts.slopes),
        b, h, h_kv, n_q, n_k, dk, float(opts.scale), int(opts.causal),
        int(opts.offset), int(opts.window or 0), int(opts.sinks),
        float(cap or 0.0), float(1.0 / cap) if cap else 0.0,
        int(rate > 0.0), fa.dropout_threshold(rate) if rate > 0.0 else 0,
        int(opts.seed) & 0xFFFFFFFF,
        float(1.0 / (1.0 - rate)) if rate > 0.0 else 1.0,
        int(bq), int(bk), _FMT_CODE[fmt], int(s8), _OUT_CODE[out_dtype])
    stream = torch.cuda.current_stream(q8.device).cuda_stream
    if wide:
        err = lib.fat_flash_fwd_fp8_wide(*args, _ptr(bmax), stream)
    elif tc:
        err = lib.fat_flash_fwd_fp8_sm90(*args, _ptr(bmax), stream)
    else:
        err = lib.fat_flash_fwd_fp8(*args, stream)
    _build.check(err, "flash_fwd_fp8 launch")
    fp8_attention.launches += 1
    fp8_attention.tc_launches += tc
    fp8_attention.wide_launches += wide
    return (o if dk == d else o[..., :d].contiguous()), lse


def _declare(lib: ctypes.CDLL) -> None:
    p, common = ctypes.c_void_p, _common_argtypes()
    lib.fat_flash_fwd_fp8.restype = ctypes.c_int
    lib.fat_flash_fwd_fp8.argtypes = common + [p]
    lib.fat_flash_fwd_fp8_sm90.restype = ctypes.c_int
    lib.fat_flash_fwd_fp8_sm90.argtypes = common + [p, p]


def _common_argtypes() -> list:
    p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
    return ([p] * 11 + [i, i, i, i, i, i, f, i, i, i, i, f, f, i, u, u, f]
            + [i, i, i, i, i])


def _declare_wide(lib: ctypes.CDLL) -> None:
    """The wide kernels' entry point: the tensor-core route's arguments."""
    lib.fat_flash_fwd_fp8_wide.restype = ctypes.c_int
    lib.fat_flash_fwd_fp8_wide.argtypes = _common_argtypes() + [
        ctypes.c_void_p, ctypes.c_void_p]


def fp8_fwd(q8, k8, v8, sq, sk, sv, bq, bk, opts, *, int8_pv="bf16",
            out_dtype=torch.bfloat16):
    """The fused forward: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Returns (o in ``out_dtype``, fp32 LSE)."""
    if q8.is_cuda:
        return _fwd_cuda(q8, k8, v8, sq, sk, sv, bq, bk, opts, int8_pv,
                         out_dtype)
    return fp8_fwd_plain(q8, k8, v8, sq, sk, sv, bq, bk, opts,
                         int8_pv=int8_pv, out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------


class _Fp8Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, opts, cfg: Fp8Config):
        q8, k8, v8, sq, sk, sv, bq, bk = quantize_inputs(
            q, k, v, cfg.block_q, cfg.block_k, cfg.fmt)
        if cfg.mode == "predecode":
            o, lse = fa.flash_fwd(dequantize_bf16(q8, sq, bq),
                                  dequantize_bf16(k8, sk, bk),
                                  dequantize_bf16(v8, sv, bk), opts)
            o = o.to(q.dtype)
        else:
            o, lse = fp8_fwd(q8, k8, v8, sq, sk, sv, bq, bk, opts,
                             int8_pv=cfg.int8_pv, out_dtype=q.dtype)
        if cfg.ste == "original":
            ctx.save_for_backward(q, k, v, o, lse)
        else:
            ctx.save_for_backward(q8, k8, v8, sq, sk, sv, o, lse)
        ctx.blocks = (bq, bk)
        ctx.dtypes = (q.dtype, k.dtype, v.dtype)
        ctx.opts, ctx.cfg = opts, cfg
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        bf = torch.bfloat16
        if ctx.cfg.ste == "original":
            q, k, v, o, lse = ctx.saved_tensors
            qd, kd, vd = q.to(bf), k.to(bf), v.to(bf)
        else:
            q8, k8, v8, sq, sk, sv, o, lse = ctx.saved_tensors
            bq, bk = ctx.blocks
            qd, kd, vd = (dequantize_bf16(q8, sq, bq), dequantize_bf16(k8, sk, bk),
                          dequantize_bf16(v8, sv, bk))
        if do is None:
            do = torch.zeros_like(o)
        dq, dk, dv = fa.flash_bwd(qd, kd, vd, o.to(bf), lse, do.to(bf), dlse,
                                  ctx.opts)
        tq, tk, tv = ctx.dtypes
        return dq.to(tq), dk.to(tk), dv.to(tv), None, None


def resolve_mode(mode: str, fmt: str, n_q: int, block_q: int) -> str:
    """The JAX ``mode="auto"`` rule; ``"fused_cached"`` runs the fused
    kernel."""
    if mode not in MODES:
        raise ValueError(f"mode must be auto|fused|fused_cached|predecode, "
                         f"got {mode!r}")
    if mode == "auto":
        return "fused" if (fmt == "int8" or n_q <= block_q) else "predecode"
    return "fused" if mode == "fused_cached" else mode


def fp8_attention(q, k, v, *, causal=False, softmax_scale=None,
                  block_q=FP8_KERNEL_BLOCK_Q, block_k=FP8_KERNEL_BLOCK_K,
                  dropout_rate=0.0, dropout_seed=None, mode="auto",
                  softcap=None, segment_ids=None, alibi_slopes=None,
                  window=None, sinks=0, fmt="fp8", int8_pv="bf16",
                  ste="dequant"):
    """FA3 8-bit attention (module docstring): q (B, H, N_q, D), k/v
    (B, H_kv, N_k, D) -> (o in q's dtype, fp32 LSE (B, H, N_q)),
    differentiable in q, k and v through both outputs (STE)."""
    if q.dim() != 4:
        raise ValueError(f"expected (B, H, N, D), got {tuple(q.shape)}")
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError(f"H={q.shape[1]} must be a multiple of "
                         f"H_kv={k.shape[1]}")
    if fmt not in _FMT_CODE:
        raise ValueError(f"fmt must be fp8|int8|e5m2, got {fmt!r}")
    if int8_pv not in ("bf16", "s8"):
        raise ValueError(f"int8_pv must be bf16|s8, got {int8_pv!r}")
    if ste not in ("dequant", "original"):
        raise ValueError(f"ste must be dequant|original, got {ste!r}")
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"v {tuple(v.shape)} must match k {tuple(k.shape)}")
    mode = resolve_mode(mode, fmt, q.shape[2], block_q)
    opts = fa.make_opts(q, k, causal=causal, softmax_scale=softmax_scale,
                        dropout_rate=dropout_rate, dropout_seed=dropout_seed,
                        window=window, segment_ids=segment_ids,
                        softcap=softcap, alibi_slopes=alibi_slopes,
                        sinks=sinks)
    cfg = Fp8Config(int(block_q), int(block_k), mode, fmt,
                    int8_pv if fmt == "int8" else "bf16", ste)
    return _Fp8Attention.apply(q, k, v, opts, cfg)


fp8_attention.launches = 0
fp8_attention.tc_launches = 0
fp8_attention.wide_launches = 0


def fp8_attention_prequant(q8, k8, v8, sq, sk, sv, *, causal=False,
                           softmax_scale=None, out_dtype=torch.bfloat16):
    """The fused forward on payloads quantized beforehand (the serving
    path): blocks follow from the scale shapes, block_q = N_q /
    sq.shape[-1] and block_k = N_k / sk.shape[-1]. Returns (o, lse)."""
    n_q, n_k = q8.shape[2], k8.shape[2]
    opts = fa.make_opts(q8, k8, causal=causal, softmax_scale=softmax_scale)
    return fp8_fwd(q8, k8, v8, sq, sk, sv, n_q // sq.shape[-1],
                   n_k // sk.shape[-1], opts, out_dtype=out_dtype)
