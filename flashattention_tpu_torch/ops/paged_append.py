"""In-place decode append: one new K/V token per sequence into its page.

The counterpart of ``flashattention_tpu/ops/pallas_append.py``
(``pallas_append_decode``) and, for quantized caches, of the token
quantization and scale scatter around it in
``flashattention_tpu/serving/paged_kv.py``. On CUDA tensors
:func:`paged_append` launches the hand-written kernel
``csrc/paged_append.cu``; on CPU tensors it runs
:func:`paged_append_plain`. Both update the pages in place and return them.

Row b of ``k_new``/``v_new`` (B, H_kv, D) lands at page ``phys[b]``, slot
``slot[b]`` of every KV head where ``ok[b]`` is true; other rows write
nothing, scales included. When several rows name the same (page, slot), as
idle decode slots all name slot 0 of the engine's dump page, which row
lands is unspecified.

Quantized caches (int8/e4m3/e5m2 pages with (H_kv, P, page, 1) fp32
``k_scales``/``v_scales``) take each token in bf16/fp32 and quantize it on
the way in, per (row, head) over D (``ops/quant.quantize_tokens``):
``scale = max(absmax * fp32(1 / qmax), 1e-6)``, payload ``x / scale``
rounded half to even (int8) or cast to nearest even (fp8). The kernel does
this in the same launch, and its bytes equal the plain version's.
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

_ELEM_BYTES = {torch.bfloat16: 2, torch.float32: 4}
_FMT_CODE = {"int8": 1, "fp8": 2, "e5m2": 3}
_SRC_CODE = {torch.bfloat16: 0, torch.float32: 1}


def paged_append_plain(k_pages, v_pages, k_new, v_new, phys, slot, ok,
                       k_scales=None, v_scales=None):
    """Plain PyTorch append: an index_put_ of the rows where ``ok``."""
    sel = ok.bool()
    p, s = phys[sel].long(), slot[sel].long()
    for pages, scales, new in ((k_pages, k_scales, k_new),
                               (v_pages, v_scales, v_new)):
        tok = new[sel]
        if scales is not None:
            tok, sc = quantize_tokens(tok, FMT_OF_DTYPE[pages.dtype])
            scales[:, p, s, 0] = sc.transpose(0, 1)
        pages[:, p, s] = tok.to(pages.dtype).transpose(0, 1)
    return k_pages, v_pages


def _check_cuda_args(k_pages, v_pages, k_new, v_new, phys, slot, ok,
                     k_scales, v_scales):
    dev = k_pages.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("k_new", k_new), ("v_new", v_new), ("phys", phys),
                    ("slot", slot), ("ok", ok), ("k_scales", k_scales),
                    ("v_scales", v_scales)):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} must be on {dev}, is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k_pages.shape != v_pages.shape or v_pages.dtype != k_pages.dtype:
        raise ValueError("k_pages and v_pages differ in shape or dtype")
    if k_scales is None:
        if k_pages.dtype not in _ELEM_BYTES:
            raise TypeError(f"paged_append kernel takes bf16/fp32, got "
                            f"{k_pages.dtype}")
        if not (k_new.dtype == v_new.dtype == k_pages.dtype):
            raise TypeError("pages and new tokens must share a dtype")
    else:
        if k_pages.dtype not in FMT_OF_DTYPE:
            raise TypeError(f"quantized pages must be int8/e4m3/e5m2, got "
                            f"{k_pages.dtype}")
        if k_new.dtype not in _SRC_CODE or v_new.dtype != k_new.dtype:
            raise TypeError("new tokens must be bf16/fp32 and share a dtype")
        want = tuple(k_pages.shape[:3]) + (1,)
        for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
            if t.dtype != torch.float32 or tuple(t.shape) != want:
                raise ValueError(f"{name} must be float32 {want}")
    for name, t in (("phys", phys), ("slot", slot), ("ok", ok)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, is {t.dtype}")


def paged_append(
    k_pages: torch.Tensor,   # (H_kv, P, page, D)
    v_pages: torch.Tensor,
    k_new: torch.Tensor,     # (B, H_kv, D)
    v_new: torch.Tensor,
    phys: torch.Tensor,      # (B,) int32 physical page of the write slot
    slot: torch.Tensor,      # (B,) int32 slot within that page
    ok: torch.Tensor,        # (B,) int32 / bool; 0 rows write nothing
    k_scales: torch.Tensor | None = None,  # (H_kv, P, page, 1) fp32
    v_scales: torch.Tensor | None = None,
):
    """Write one token per sequence into the pages, in place (module
    docstring). Kernel launches are counted in ``paged_append.launches``."""
    h, num_pages, page_size, d = k_pages.shape
    b = k_new.shape[0]
    if k_new.shape != (b, h, d) or v_new.shape != (b, h, d):
        raise ValueError(
            f"new tokens must be (B, {h}, {d}), got {tuple(k_new.shape)}, "
            f"{tuple(v_new.shape)}"
        )
    if phys.shape != (b,) or slot.shape != (b,) or ok.shape != (b,):
        raise ValueError("phys / slot / ok must be (B,)")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales, or neither")
    if not k_pages.is_cuda:
        return paged_append_plain(k_pages, v_pages, k_new, v_new, phys, slot,
                                  ok, k_scales, v_scales)
    _check_cuda_args(k_pages, v_pages, k_new, v_new, phys, slot, ok,
                     k_scales, v_scales)
    if b == 0:
        return k_pages, v_pages
    lib = _build.load_kernel("paged_append", _declare)
    stream = torch.cuda.current_stream(k_pages.device).cuda_stream
    if k_scales is None:
        err = lib.fat_paged_append(
            k_pages.data_ptr(), v_pages.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), phys.data_ptr(), slot.data_ptr(), ok.data_ptr(),
            b, h, num_pages, page_size, d, _ELEM_BYTES[k_pages.dtype], stream,
        )
    else:
        err = lib.fat_paged_append_quant(
            k_pages.data_ptr(), v_pages.data_ptr(), k_scales.data_ptr(),
            v_scales.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            phys.data_ptr(), slot.data_ptr(), ok.data_ptr(),
            b, h, num_pages, page_size, d,
            _FMT_CODE[FMT_OF_DTYPE[k_pages.dtype]], _SRC_CODE[k_new.dtype],
            inv_qmax(FMT_OF_DTYPE[k_pages.dtype]), stream,
        )
    _build.check(err, "paged_append launch")
    paged_append.launches += 1
    return k_pages, v_pages


paged_append.launches = 0


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fat_paged_append.restype = ctypes.c_int
    lib.fat_paged_append.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.fat_paged_append_quant.restype = ctypes.c_int
    lib.fat_paged_append_quant.argtypes = [p] * 9 + [i] * 7 + [
        ctypes.c_float, p]
