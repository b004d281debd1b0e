"""Block quantization and incoherent processing for the 8-bit (FA3) path.

The counterpart of ``flashattention_tpu/ops/quant.py`` plus the
dequantizers of ``flashattention_tpu/ops/pallas_fp8.py`` and the per-token
quantizer of ``flashattention_tpu/serving/paged_kv.py``. Payloads are real
``float8_e4m3fn``, ``float8_e5m2`` or ``int8`` tensors with fp32 scales:
per (batch, head, sequence block) for attention, per (head, page, slot) for
the paged cache. PyTorch's own fp8 casts replace the JAX package's bit
surgery; both round to nearest even and decode every finite code exactly,
so payload bytes and scales are bit-equal to the JAX package's.

One deliberate difference: ``incoherent_process`` takes the rotation's
random signs as an argument. JAX draws them with
``jax.random.rademacher(key(seed))``, which PyTorch cannot replay; the
default here draws them from a ``torch.Generator`` seeded with ``seed``.
"""

from __future__ import annotations

import functools

import torch

FP8_MAX = 448.0       # float8_e4m3fn max normal
E5M2_MAX = 57344.0    # float8_e5m2 max normal
INT8_MAX = 127.0
SCALE_EPS = 1e-6      # the smallest scale (the reference's clamp_min eps)

PAYLOAD_DTYPE = {"fp8": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2,
                 "int8": torch.int8}
QMAX = {"fp8": FP8_MAX, "e5m2": E5M2_MAX, "int8": INT8_MAX}
FMT_OF_DTYPE = {v: k for k, v in PAYLOAD_DTYPE.items()}


def _device_scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-dim float32 tensor on ``like``'s device. Dividing
    by it is an IEEE division on every device: PyTorch's CUDA kernels turn a
    division by a Python or CPU scalar into a multiply by its reciprocal,
    which would give other scales on the card than on the CPU. Filled on
    the device: no host-to-device copy, so no wait for the card."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _check_fmt(fmt: str) -> None:
    if fmt not in PAYLOAD_DTYPE:
        raise ValueError(f"fmt must be fp8|int8|e5m2, got {fmt!r}")


def hadamard_transform(x: torch.Tensor, *, normalize: bool = True):
    """Fast Walsh-Hadamard transform along the last axis (a power of two),
    in float32 with the JAX package's butterfly order, so the results are
    bit-equal; orthonormal (divided by sqrt(d)) with ``normalize``."""
    d = x.shape[-1]
    if d & (d - 1):
        raise ValueError(f"Hadamard requires power-of-2 dim, got {d}")
    shape = x.shape
    xf = x.float().reshape(-1, d)
    h = 1
    while h < d:
        xf = xf.reshape(-1, d // (2 * h), 2, h)
        a, c = xf[:, :, 0, :], xf[:, :, 1, :]
        xf = torch.stack([a + c, a - c], dim=2)
        h *= 2
    xf = xf.reshape(shape)
    if normalize:
        xf = xf / torch.sqrt(_device_scalar(float(d), xf))
    return xf.to(x.dtype)


def rademacher_signs(d: int, seed: int = 0) -> torch.Tensor:
    """(d,) float32 random signs +-1 from a ``torch.Generator`` seeded with
    ``seed`` (not JAX's draw: pass JAX's vector as ``sign=`` to match)."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randint(0, 2, (d,), generator=gen).float() * 2.0 - 1.0


@functools.lru_cache(maxsize=None)
def _signs_on(device: torch.device, d: int, seed: int) -> torch.Tensor:
    """:func:`rademacher_signs` copied to ``device`` once: a copy from host
    memory on every call would make the host wait for the card."""
    return rademacher_signs(d, seed).to(device)


def incoherent_process(q: torch.Tensor, k: torch.Tensor, *, seed: int = 0,
                       sign: torch.Tensor | None = None):
    """Randomized-Hadamard rotation of q and k: x' = (x * sign) H / sqrt(d)
    with one +-1 vector ``sign`` for both, so q'k'^T == qk^T while outliers
    spread out before 8-bit quantization. No-op when head_dim is not a power
    of two. ``sign`` defaults to :func:`rademacher_signs` of ``seed``."""
    d = q.shape[-1]
    if d & (d - 1):
        return q, k
    if sign is None:
        sign = _signs_on(q.device, d, int(seed))
    else:
        sign = torch.as_tensor(sign, dtype=torch.float32).to(q.device)
    sign = sign.reshape(d)
    qr = hadamard_transform(q.float() * sign, normalize=True)
    kr = hadamard_transform(k.float() * sign, normalize=True)
    return qr.to(q.dtype), kr.to(k.dtype)


def _blocks(x: torch.Tensor, block: int):
    *lead, n, d = x.shape
    if n % block:
        raise ValueError(f"sequence {n} is not a multiple of block {block}")
    return x.float().reshape(*lead, n // block, block, d)


def block_absmax_scale(x: torch.Tensor, block: int, *, amax: float = FP8_MAX):
    """Per-(..., seq-block) fp32 scales of x (..., N, D), N % block == 0:
    max(absmax / amax, SCALE_EPS), shape (..., N // block)."""
    absmax = _blocks(x, block).abs().amax(dim=(-2, -1))
    return torch.maximum(absmax / _device_scalar(amax, absmax),
                         _device_scalar(SCALE_EPS, absmax))


def quantize_blocks(x: torch.Tensor, block: int, fmt: str = "fp8"):
    """(..., N, D) -> (payload of ``fmt``, fp32 scales (..., N // block)):
    ``quantize_{fp8,e5m2,int8}_blocks`` of the JAX package. fp8 formats clip
    to their max normal; int8 rounds half to even and clips to +-127."""
    _check_fmt(fmt)
    *lead, n, d = x.shape
    scales = block_absmax_scale(x, block, amax=QMAX[fmt])
    y = _blocks(x, block) / scales[..., None, None]
    if fmt == "int8":
        y = torch.round(y).clamp(-INT8_MAX, INT8_MAX)
    else:
        y = y.clamp(-QMAX[fmt], QMAX[fmt])
    return y.to(PAYLOAD_DTYPE[fmt]).reshape(*lead, n, d), scales


def per_position(scales: torch.Tensor, block: int, n: int) -> torch.Tensor:
    """(..., n) scale of each of n sequence positions from per-block
    scales (..., ceil(n / block))."""
    return scales[..., torch.arange(n, device=scales.device) // block]


def dequantize_blocks(payload: torch.Tensor, scales: torch.Tensor, block: int):
    """payload * its block's scale, float32, for a payload (..., N, D) of any
    length N (``dequantize_fp8_blocks`` and ``pallas_fp8._dequant``)."""
    s = per_position(scales, block, payload.shape[-2])
    return payload.float() * s[..., None]


def dequantize_bf16(payload: torch.Tensor, scales: torch.Tensor, block: int):
    """``pallas_fp8._dequant_bf16``: decode * scale in fp32, then bf16."""
    return dequantize_blocks(payload, scales, block).to(torch.bfloat16)


def fake_quant_fp8(x: torch.Tensor, block: int) -> torch.Tensor:
    """e4m3 quantize -> dequantize round trip, in x's dtype."""
    payload, scales = quantize_blocks(x, block, "fp8")
    return dequantize_blocks(payload, scales, block).to(x.dtype)


def inv_qmax(quant: str) -> float:
    """fp32 1 / qmax of a payload format, as a Python float."""
    return float(torch.tensor(1.0 / QMAX[quant], dtype=torch.float32))


def quantize_tokens(x: torch.Tensor, quant: str):
    """Per-token quantization of the paged cache (``paged_kv._quantize_tokens``
    as the JAX package runs it, inside the jitted ``append_to_pages``):
    x (..., D) -> (payload (..., D), fp32 scale (...,)) with scale =
    max(absmax * fp32(1 / qmax), 1e-6) and payload = x / scale (an IEEE
    division), rounded half to even for int8 and cast (round to nearest
    even, no clamp) for fp8. XLA turns the source's ``absmax / qmax`` by a
    constant into that multiply, so this is what gives JAX's bytes."""
    _check_fmt(quant)
    x = x.float()
    absmax = x.abs().amax(dim=-1)
    scale = torch.maximum(absmax * inv_qmax(quant),
                          _device_scalar(SCALE_EPS, absmax))
    y = x / scale[..., None]
    if quant == "int8":
        y = torch.round(y)
    return y.to(PAYLOAD_DTYPE[quant]), scale
