"""Append of new K/V tokens into the paged cache, in place: a decode step
(T = 1) or a prefill chunk (T > 1), payloads and scales, in one launch.

The counterpart of ``flashattention_tpu/ops/pallas_append.py``
(``pallas_append_decode``) together with the index arithmetic, the token
quantization and the prefill scatter around it in
``flashattention_tpu/serving/paged_kv.py`` (``append_to_pages``), which the
JAX package jits into one program. On CUDA tensors :func:`paged_append`
launches the hand-written kernel ``csrc/paged_append.cu``
(``fat_paged_append_tokens``), which computes every target from the page
table and the lengths itself; on CPU tensors it runs
:func:`paged_append_plain`. Both update the pages in place and return them.

Token (b, t) of ``k_new``/``v_new`` (B, H_kv, T, D) lands at position
``lengths[b] + t``: physical page ``page_indices[b, pos // page]``, slot
``pos % page``, for every KV head. It writes nothing, payload or scale,
where ``pos < 0``, where ``pos >= pps * page``, where ``t >= valid_len[b]``
or where the physical page is outside ``[0, P)``. When several tokens name
the same (page, slot), as idle decode slots all name slot 0 of the engine's
dump page, which one lands is unspecified.

Pages hold bf16 or fp32 values (tokens converted as ``.to()`` does) or
int8/e4m3/e5m2 payloads with (H_kv, P, page, 1) fp32
``k_scales``/``v_scales``: each token row is quantized over D on the way
in (``ops/quant.quantize_tokens``), ``scale = max(absmax * fp32(1 / qmax),
1e-6)``, payload ``x / scale`` rounded half to even (int8) or cast to
nearest even (fp8). The kernel's bytes equal the plain version's. Both
take any head dim D.

The one-token-per-row form of the JAX package's ``pallas_append_decode``
(physical page, slot and keep flag per row) is this call with
``page_indices = phys[:, None]``, ``lengths = slot``, ``valid_len = ok``
and T = 1.
"""

from __future__ import annotations

import ctypes

import torch

from flashattention_tpu_torch import _build
from flashattention_tpu_torch.ops.quant import (
    FMT_OF_DTYPE,
    inv_qmax,
    quantize_tokens,
)

# page_fmt and src_dtype codes of fat_paged_append_tokens
_PAGE_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2,
              torch.float8_e4m3fn: 3, torch.float8_e5m2: 4}
_SRC_CODE = {torch.bfloat16: 0, torch.float32: 1}
_INV_QMAX = {dt: inv_qmax(fmt) for dt, fmt in FMT_OF_DTYPE.items()}


def paged_append_plain(k_pages, v_pages, k_new, v_new, page_indices, lengths,
                       valid_len=None, k_scales=None, v_scales=None):
    """Plain PyTorch append: one index_put_ of the kept (b, t) tokens."""
    b, _, t, _ = k_new.shape
    num_pages, page = k_pages.shape[1], k_pages.shape[2]
    pps = page_indices.shape[1]
    steps = torch.arange(t, device=lengths.device)
    pos = lengths.long()[:, None] + steps[None, :]             # (B, T)
    ok = (pos >= 0) & (pos < pps * page)
    if valid_len is not None:
        ok &= steps[None, :] < valid_len.long()[:, None]
    logical = torch.clamp(pos.div(page, rounding_mode="floor"), 0, pps - 1)
    phys = page_indices.long().gather(1, logical)
    ok &= (phys >= 0) & (phys < num_pages)
    phys, slot = phys[ok], (pos % page)[ok]
    for pages, scales, new in ((k_pages, k_scales, k_new),
                               (v_pages, v_scales, v_new)):
        tok = new.transpose(1, 2)[ok]                          # (N, H, D)
        if scales is not None:
            tok, sc = quantize_tokens(tok, FMT_OF_DTYPE[pages.dtype])
            scales[:, phys, slot, 0] = sc.transpose(0, 1)
        pages[:, phys, slot] = tok.to(pages.dtype).transpose(0, 1)
    return k_pages, v_pages


def _check_args(k_pages, v_pages, k_new, v_new, page_indices, lengths,
                valid_len, k_scales, v_scales):
    """Shapes and the scale planes' presence, on every device."""
    if k_pages.dim() != 4 or k_new.dim() != 4:
        raise ValueError("pages must be (H_kv, P, page, D) and new tokens "
                         "(B, H_kv, T, D)")
    h, num_pages, page, d = k_pages.shape
    b, _, t, _ = k_new.shape
    if v_pages.shape != k_pages.shape or v_pages.dtype != k_pages.dtype:
        raise ValueError("k_pages and v_pages differ in shape or dtype")
    if k_new.shape != (b, h, t, d) or v_new.shape != (b, h, t, d):
        raise ValueError(
            f"new tokens must be (B, {h}, T, {d}), got {tuple(k_new.shape)}, "
            f"{tuple(v_new.shape)}")
    if page_indices.dim() != 2 or page_indices.shape[0] != b:
        raise ValueError(f"page_indices must be ({b}, pages_per_seq)")
    for name, x in (("lengths", lengths), ("valid_len", valid_len)):
        if x is not None and tuple(x.shape) != (b,):
            raise ValueError(f"{name} must be ({b},), is {tuple(x.shape)}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales, or neither")
    if (k_scales is not None) != (k_pages.dtype in FMT_OF_DTYPE):
        raise ValueError("1-byte pages take k_scales and v_scales; bf16 and "
                         "fp32 pages take none")


def _check_cuda_args(k_pages, v_pages, k_new, v_new, page_indices, lengths,
                     valid_len, k_scales, v_scales):
    """What the kernel takes; raises on anything else."""
    dev = k_pages.device
    for name, x in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("k_new", k_new), ("v_new", v_new),
                    ("page_indices", page_indices), ("lengths", lengths),
                    ("valid_len", valid_len), ("k_scales", k_scales),
                    ("v_scales", v_scales)):
        if x is not None and x.device != dev:
            raise ValueError(f"{name} must be on {dev}, is on {x.device}")
    if k_pages.dtype not in _PAGE_CODE:
        raise TypeError(f"pages must be bf16/fp32/int8/e4m3/e5m2, got "
                        f"{k_pages.dtype}")
    if k_new.dtype not in _SRC_CODE or v_new.dtype != k_new.dtype:
        raise TypeError(f"new tokens must be bf16 or fp32 and share a dtype, "
                        f"got {k_new.dtype}, {v_new.dtype}")
    if k_new.stride(3) != 1 or v_new.stride(3) != 1:
        raise ValueError("new tokens must have a D stride of 1")
    for name, x in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("k_scales", k_scales), ("v_scales", v_scales),
                    ("lengths", lengths), ("valid_len", valid_len)):
        if x is not None and not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if page_indices.stride(1) != 1:
        raise ValueError("page_indices must have a column stride of 1")
    for name, x in (("page_indices", page_indices), ("lengths", lengths),
                    ("valid_len", valid_len)):
        if x is not None and x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, is {x.dtype}")
    if k_scales is not None:
        want = tuple(k_pages.shape[:3]) + (1,)
        for name, x in (("k_scales", k_scales), ("v_scales", v_scales)):
            if x.dtype != torch.float32 or tuple(x.shape) != want:
                raise ValueError(f"{name} must be float32 {want}")


def paged_append(
    k_pages: torch.Tensor,       # (H_kv, P, page, D)
    v_pages: torch.Tensor,
    k_new: torch.Tensor,         # (B, H_kv, T, D), D stride 1
    v_new: torch.Tensor,
    page_indices: torch.Tensor,  # (B, pages_per_seq) int32
    lengths: torch.Tensor,       # (B,) int32, lengths before the append
    valid_len: torch.Tensor | None = None,  # (B,) int32: real tokens of T
    k_scales: torch.Tensor | None = None,   # (H_kv, P, page, 1) fp32
    v_scales: torch.Tensor | None = None,
):
    """Write new K/V tokens into their pages, in place (module docstring).
    On the card: one kernel launch and no host sync, counted in
    ``paged_append.launches``, and also in ``paged_append.chunk_launches``
    where T > 1."""
    _check_args(k_pages, v_pages, k_new, v_new, page_indices, lengths,
                valid_len, k_scales, v_scales)
    if not k_pages.is_cuda:
        return paged_append_plain(k_pages, v_pages, k_new, v_new,
                                  page_indices, lengths, valid_len, k_scales,
                                  v_scales)
    _check_cuda_args(k_pages, v_pages, k_new, v_new, page_indices, lengths,
                     valid_len, k_scales, v_scales)
    h, num_pages, page, d = k_pages.shape
    b, _, t, _ = k_new.shape
    if b == 0 or t == 0 or h == 0:
        return k_pages, v_pages
    quant = k_scales is not None
    lib = _build.load_kernel("paged_append", _declare)
    stream = torch.cuda.current_stream(k_pages.device).cuda_stream
    err = lib.fat_paged_append_tokens(
        k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if quant else None,
        v_scales.data_ptr() if quant else None,
        k_new.data_ptr(), v_new.data_ptr(), *k_new.stride()[:3],
        *v_new.stride()[:3], page_indices.data_ptr(), page_indices.stride(0),
        lengths.data_ptr(),
        valid_len.data_ptr() if valid_len is not None else None,
        b, t, h, num_pages, page, page_indices.shape[1], d,
        _PAGE_CODE[k_pages.dtype], _SRC_CODE[k_new.dtype],
        _INV_QMAX.get(k_pages.dtype, 0.0), stream,
    )
    _build.check(err, "paged_append launch")
    paged_append.launches += 1
    paged_append.chunk_launches += t > 1
    return k_pages, v_pages


paged_append.launches = 0
paged_append.chunk_launches = 0


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fat_paged_append_tokens.restype = ctypes.c_int
    lib.fat_paged_append_tokens.argtypes = (
        [p] * 6 + [ll] * 6 + [p, ll, p, p] + [i] * 9 + [ctypes.c_float, p])
