"""Public attention API and backend routing.

The counterpart of ``flashattention_tpu/ops/api.py``: ``flash_attention``
and the FA1/FA2/FA3 entry points return ``(o, lse)`` for q, k, v
(B, H, N, D). Backends:

- ``"kernel"``    the flash kernels (``ops/flash_attn.kernel_attention``):
                  CUDA kernels on CUDA tensors, their plain versions on CPU
                  tensors (the JAX package's ``"pallas"``);
- ``"tiled"``     the tiled executor (``ops/tiled.py``; the JAX ``"xla"``);
- ``"reference"`` the dense fp32 oracle;
- ``"auto"``      ``"kernel"``.

The routing rules are the JAX package's: a dense ``mask`` goes to the tiled
executor (with a warning if the caller asked for the kernel); so does
dropout on a backend other than the kernel; GQA heads are expanded on the
dense routes; a window folds into the mask there. Failures are never
swallowed. The JAX ``dropout_key`` becomes ``dropout_seed``: an int, or
one uint32 drawn from ``generator`` (a ``torch.Generator``).
"""

from __future__ import annotations

import math
import warnings

import torch

from flashattention_tpu_torch.ops import quant
from flashattention_tpu_torch.ops.flash_attn import kernel_attention
from flashattention_tpu_torch.ops.fp8_attn import fp8_attention
from flashattention_tpu_torch.ops.reference import band_mask, reference_attention
from flashattention_tpu_torch.ops.specs import (
    FA3_BLOCK_K,
    FP8_KERNEL_BLOCK_Q,
    TILED_BLOCK_K,
    fa3_block_q,
    fp8_block,
)
from flashattention_tpu_torch.ops.tiled import tiled_attention

BACKENDS = ("auto", "kernel", "tiled", "reference")


def _resolve_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    return "kernel" if backend == "auto" else backend


def _seed(dropout_rate, dropout_seed, generator):
    if dropout_rate <= 0.0:
        return None
    if dropout_seed is not None:
        return int(dropout_seed)
    if generator is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed or generator")
    return int(torch.randint(0, 2 ** 32, (1,), generator=generator,
                             dtype=torch.int64, device=generator.device))


def _repeat_kv(k, v, h_q):
    h_kv = k.shape[1]
    if h_kv == h_q:
        return k, v
    if h_q % h_kv != 0:
        raise ValueError(f"H={h_q} must be a multiple of H_kv={h_kv}")
    return (k.repeat_interleave(h_q // h_kv, dim=1),
            v.repeat_interleave(h_q // h_kv, dim=1))


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    softmax_scale: float | None = None,
    backend: str = "auto",
    block_k: int = TILED_BLOCK_K,
    mask: torch.Tensor | None = None,
    dropout_rate: float = 0.0,
    dropout_seed: int | None = None,
    generator: torch.Generator | None = None,
    q_offset: int | None = None,
    window: int | None = None,
    segment_ids=None,
    softcap: float | None = None,
    alibi_slopes: torch.Tensor | None = None,
    sinks: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Generic flash attention entry point: q, k, v (B, H, N, D) ->
    (o, lse). The arguments mean what they mean in
    ``ops/flash_attn.kernel_attention``; ``mask`` is a bool (N_q, N_k) or
    (B|1, H|1, N_q, N_k) attend-mask. ``block_k`` sizes the tiled
    executor's key tiles; the CUDA kernels choose their own."""
    backend = _resolve_backend(backend)
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    if sinks and window is None:
        raise ValueError("sinks require window= (StreamingLLM band)")
    n_q, n_k = q.shape[-2], k.shape[-2]
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes).to(
            device=q.device, dtype=torch.float32).reshape(-1)
        if backend == "kernel" and mask is None and dropout_rate == 0.0:
            pass  # in-kernel positional bias
        elif backend == "tiled":
            if window is not None or segment_ids is not None:
                raise ValueError("alibi with window/segment_ids is only "
                                 "supported on the kernel backend")
        elif backend == "reference" and dropout_rate == 0.0:
            if window is not None or segment_ids is not None:
                raise ValueError("alibi with window/segment_ids is only "
                                 "supported on the kernel backend")
            off = (n_k - n_q) if q_offset is None else q_offset
            rows = torch.arange(n_q, device=q.device)[:, None] + off
            cols = torch.arange(n_k, device=q.device)[None, :]
            bias = -slopes[:, None, None] * (cols - rows).abs().float()
            kk, vv = _repeat_kv(k, v, q.shape[1])
            return reference_attention(
                q, kk, vv, causal=causal, softmax_scale=softmax_scale,
                q_offset=q_offset, mask=mask, bias=bias, softcap=softcap)
        else:
            raise ValueError(
                "alibi_slopes requires the kernel backend (in-kernel bias), "
                "the tiled backend (per-tile bias), or the reference "
                "dense-bias route without mask/dropout")
    if segment_ids is not None and (backend != "kernel" or mask is not None):
        # Routes other than the kernel take segments as a dense mask.
        if isinstance(segment_ids, (tuple, list)):
            q_ids, kv_ids = segment_ids
        else:
            q_ids = kv_ids = segment_ids
        q_ids = torch.as_tensor(q_ids).to(q.device)
        kv_ids = torch.as_tensor(kv_ids).to(q.device)
        seg = q_ids[:, None, :, None] == kv_ids[:, None, None, :]
        mask = seg if mask is None else (mask & seg)
        segment_ids = None
    will_tile = (backend == "tiled" or mask is not None
                 or (dropout_rate > 0.0 and backend != "kernel"))
    if window is not None and will_tile:
        # The band's low edge becomes a mask; the causal edge stays on the
        # executor's q_offset path.
        offset = (n_k - n_q) if q_offset is None else q_offset
        low = ~band_mask(n_q, n_k, offset - window, device=q.device)
        if sinks:
            low = low | (torch.arange(n_k, device=q.device) < sinks)[None, :]
        mask = low if mask is None else (mask & low)
    routes_tiled = mask is not None or (dropout_rate > 0.0
                                        and backend != "kernel")
    if q.shape[1] != k.shape[1] and (backend != "kernel" or routes_tiled):
        k, v = _repeat_kv(k, v, q.shape[1])
    seed = _seed(dropout_rate, dropout_seed, generator)
    if routes_tiled:
        if backend == "reference":
            if dropout_rate > 0.0:
                raise ValueError("reference backend has no dropout path")
            return reference_attention(
                q, k, v, causal=causal, softmax_scale=softmax_scale,
                q_offset=q_offset, mask=mask, softcap=softcap)
        if backend == "kernel" and mask is not None:
            warnings.warn(
                "flash_attention(backend='kernel', mask=...) runs the tiled "
                "executor: an arbitrary dense mask defeats kernel tile "
                "skipping. Use causal=/q_offset= to stay on the kernel path.",
                stacklevel=2)
        return tiled_attention(
            q, k, v, causal=causal, softmax_scale=softmax_scale,
            block_k=min(block_k, 128) if n_k < block_k else block_k,
            mask=mask, dropout_rate=dropout_rate, dropout_seed=seed,
            q_offset=q_offset, softcap=softcap,
            alibi_slopes=alibi_slopes if backend == "tiled" else None)
    if backend == "kernel":
        return kernel_attention(
            q, k, v, causal=causal, softmax_scale=softmax_scale,
            dropout_rate=dropout_rate, dropout_seed=seed, q_offset=q_offset,
            window=window, segment_ids=segment_ids, softcap=softcap,
            alibi_slopes=alibi_slopes, sinks=sinks)
    if backend == "tiled":
        return tiled_attention(
            q, k, v, causal=causal, softmax_scale=softmax_scale,
            block_k=min(block_k, 512), q_offset=q_offset, softcap=softcap,
            alibi_slopes=alibi_slopes)
    return reference_attention(
        q, k, v, causal=causal, softmax_scale=softmax_scale,
        q_offset=q_offset, window=window, softcap=softcap, sinks=sinks)


def fa1_attention(q, k, v, causal: bool = False, softmax_scale=None,
                  backend: str = "auto"):
    """FA1 generation: the same kernels as every generation here."""
    return flash_attention(q, k, v, causal=causal, softmax_scale=softmax_scale,
                           backend=backend)


def fa2_attention(q, k, v, causal: bool = False, softmax_scale=None,
                  backend: str = "auto"):
    """FA2 generation (deferred normalisation, as every route here)."""
    return flash_attention(q, k, v, causal=causal, softmax_scale=softmax_scale,
                           backend=backend)


def fa3_attention(q, k, v, causal: bool = False, softmax_scale=None,
                  backend: str = "auto", fp8: bool = False, fp8_seed: int = 0,
                  dropout_rate: float = 0.0, dropout_seed: int | None = None,
                  generator: torch.Generator | None = None,
                  fp8_fmt: str = "fp8", fp8_sign: torch.Tensor | None = None,
                  int8_pv: str = "bf16"):
    """FA3 generation; ``fp8=True`` runs the 8-bit path.

    q and k first go through the randomized-Hadamard rotation
    (``quant.incoherent_process``) with the signs ``fp8_sign``, by default
    drawn from a ``torch.Generator`` seeded with ``fp8_seed`` (JAX draws
    them with ``jax.random``; pass its vector to match). The kernel backend
    then runs ``fp8_attention`` (payloads of ``fp8_fmt``, q blocks of 512,
    k/v blocks of 1024, clamped to the sequence; with int8 payloads
    ``int8_pv="s8"`` re-quantizes p per key block, JAX's ``FAT_INT8_PV``);
    the tiled and reference backends run on e4m3 fake-quantized inputs
    (blocks: the largest divisors of N up to ``specs.fa3_block_q`` and
    ``specs.FA3_BLOCK_K``), whatever ``fp8_fmt`` and ``int8_pv`` say, as
    in the JAX package."""
    if not fp8:
        return flash_attention(q, k, v, causal=causal,
                               softmax_scale=softmax_scale, backend=backend,
                               dropout_rate=dropout_rate,
                               dropout_seed=dropout_seed, generator=generator)
    backend = _resolve_backend(backend)
    seed = _seed(dropout_rate, dropout_seed, generator)
    qr, kr = quant.incoherent_process(q, k, seed=fp8_seed, sign=fp8_sign)
    if backend == "kernel":
        return fp8_attention(
            qr, kr, v, causal=causal, softmax_scale=softmax_scale,
            block_q=min(fa3_block_q(q.shape[-1]), FP8_KERNEL_BLOCK_Q),
            block_k=FA3_BLOCK_K, dropout_rate=dropout_rate,
            dropout_seed=seed, fmt=fp8_fmt, int8_pv=int8_pv)
    blk_q = fp8_block(q.shape[-2], fa3_block_q(q.shape[-1]))
    blk_k = fp8_block(k.shape[-2], FA3_BLOCK_K)
    return flash_attention(
        quant.fake_quant_fp8(qr, blk_q), quant.fake_quant_fp8(kr, blk_k),
        quant.fake_quant_fp8(v, blk_k), causal=causal,
        softmax_scale=softmax_scale, backend=backend,
        dropout_rate=dropout_rate, dropout_seed=seed)


def alibi_slopes(n_heads: int) -> torch.Tensor:
    """The ALiBi paper's geometric head slopes: for H a power of two,
    slope_i = 2^(-8(i+1)/H); otherwise the paper's interpolation."""

    def _pow2(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start ** (i + 1) for i in range(n)]

    if math.log2(n_heads).is_integer():
        sl = _pow2(n_heads)
    else:
        base = 2 ** math.floor(math.log2(n_heads))
        sl = _pow2(base) + _pow2(2 * base)[0::2][: n_heads - base]
    return torch.tensor(sl, dtype=torch.float32)


def flash_attention_qkvpacked(qkv: torch.Tensor, **kwargs):
    """qkv (B, N, 3, H, D), unpacked to (B, H, N, D) q, k, v."""
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"expected (B, N, 3, H, D), got {tuple(qkv.shape)}")
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    return flash_attention(q, k, v, **kwargs)


def flash_attention_kvpacked(q: torch.Tensor, kv: torch.Tensor, **kwargs):
    """q (B, N, H, D) and kv (B, N, 2, H_kv, D) (GQA/MQA allowed)."""
    if kv.dim() != 5 or kv.shape[2] != 2:
        raise ValueError(f"expected kv (B, N, 2, H_kv, D), got {tuple(kv.shape)}")
    if q.dim() != 4:
        raise ValueError(f"expected q (B, N, H, D), got {tuple(q.shape)}")
    k, v = (kv[:, :, i].transpose(1, 2) for i in range(2))
    return flash_attention(q.transpose(1, 2), k, v, **kwargs)
