"""Paged attention: decode and chunked prefill against the paged KV cache.

The counterpart of ``flashattention_tpu/ops/pallas_paged.py``
(``pallas_paged_attention``). On a CUDA tensor :func:`paged_attention`
launches the hand-written kernel ``csrc/paged_attention.cu``; on a CPU
tensor it runs :func:`paged_attention_plain`, the same function written in
plain PyTorch. Nothing falls back: a CUDA input the kernel does not take
raises.

Layout (as in the JAX package):

    q             (B, H, D) decode, or (B, H, T, D) chunk
    k/v_pages     (H_kv, P, page, D)
    page_indices  (B, pages_per_seq) int32, logical -> physical page
    lengths       (B,) int32, slots written per sequence, the chunk included

Row t of a chunk sits at position ``lengths - T + t`` and attends to slots
``<= position``; with ``window`` W only to slots ``> position - W``, plus
the first ``sinks`` slots. A row that sees no slot returns zeros.

The compute type is the pages' dtype: q is scaled in it before QK, scores
accumulate in float32, and p is rounded to it before PV (the TPU kernel's
rounding points). float32 pages give the exact float32 computation.
"""

from __future__ import annotations

import ctypes

import torch

from flashattention_tpu_torch import _build
from flashattention_tpu_torch.ops.reference import score_pipeline

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
MAX_HEAD_DIM = 128


def row_positions(lengths, q_len, rows_per_head):
    """(B, R) absolute position of each query row; row r is chunk token
    r % q_len of group member r // q_len."""
    t = torch.arange(rows_per_head, device=lengths.device) % q_len
    return lengths.to(torch.int64)[:, None] - q_len + t[None, :]


def paged_attention_plain(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_indices: torch.Tensor,
    lengths: torch.Tensor,
    *,
    softmax_scale: float | None = None,
    window: int | None = None,
    softcap: float | None = None,
    sinks: int = 0,
) -> torch.Tensor:
    """Plain PyTorch paged attention: gather every page of the table, mask,
    softmax once. Same contract and rounding points as the kernel."""
    decode = q.dim() == 3
    if decode:
        q = q[:, :, None, :]
    b, h, t, d = q.shape
    h_kv, _, page, _ = k_pages.shape
    g = h // h_kv
    cdt = k_pages.dtype
    if softmax_scale is None:
        softmax_scale = d ** -0.5
    pi = page_indices.long()
    # (H_kv, B, pps, page, D) -> (B, H_kv, L, D)
    k = k_pages[:, pi].permute(1, 0, 2, 3, 4).reshape(b, h_kv, -1, d).float()
    v = v_pages[:, pi].permute(1, 0, 2, 3, 4).reshape(b, h_kv, -1, d).float()
    scale = torch.tensor(softmax_scale, dtype=cdt, device=q.device)
    qc = (q.to(cdt) * scale).float().reshape(b, h_kv, g * t, d)
    s = torch.einsum("bhrd,bhld->bhrl", qc, k)
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
    o = torch.einsum("bhrl,bhld->bhrd", p.to(cdt).float(), v)
    o = o / torch.where(l == 0, torch.ones_like(l), l)
    o = o.reshape(b, h, t, d).to(q.dtype)
    return o[:, :, 0] if decode else o


def _check_cuda_args(q, k_pages, v_pages, page_indices, lengths):
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"paged_attention kernel takes bf16/fp32, got {q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(
            f"q ({q.dtype}) and pages ({k_pages.dtype}, {v_pages.dtype}) "
            "must share a dtype"
        )
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_indices", page_indices), ("lengths", lengths)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if page_indices.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_indices and lengths must be int32")
    if k_pages.shape != v_pages.shape:
        raise ValueError("k_pages and v_pages shapes differ")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {q.shape[-1]} > {MAX_HEAD_DIM}")


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
) -> torch.Tensor:
    """Paged attention (module docstring). Returns o in q's shape and dtype.

    Launches the CUDA kernel for CUDA tensors (counted in
    ``paged_attention.launches``) and runs the plain version for CPU
    tensors. Quantized pages (``k_scales``/``v_scales``) are not supported
    yet and raise."""
    if k_scales is not None or v_scales is not None:
        raise NotImplementedError("quantized page payloads are not ported yet")
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
    if not q.is_cuda:
        return paged_attention_plain(
            q, k_pages, v_pages, page_indices, lengths,
            softmax_scale=softmax_scale, window=window, softcap=softcap,
            sinks=sinks,
        )
    _check_cuda_args(qq, k_pages, v_pages, page_indices, lengths)
    qq = qq.contiguous()
    out = torch.empty_like(qq)
    if b == 0:
        return out[:, :, 0] if decode else out
    lib = _build.load_kernel("paged_attention", _declare)
    err = lib.fat_paged_attention(
        qq.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_indices.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, h, h_kv, t, d, num_pages, page_size, page_indices.shape[1],
        float(softmax_scale), int(window) if window is not None else 0,
        int(sinks), float(softcap) if softcap is not None else 0.0,
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "paged_attention launch")
    paged_attention.launches += 1
    return out[:, :, 0] if decode else out


paged_attention.launches = 0


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fat_paged_attention.restype = ctypes.c_int
    lib.fat_paged_attention.argtypes = [
        p, p, p, p, p, p, i, i, i, i, i, i, i, i, f, i, i, f, i, p,
    ]

