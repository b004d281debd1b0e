"""Paged KV cache.

The counterpart of ``flashattention_tpu/serving/paged_kv.py``. Layout:

    k_pages, v_pages: (num_kv_heads, num_pages, page_size, head_dim)
    page_indices:     (batch, pages_per_seq) int32, logical -> physical
    lengths:          (batch,) int32, tokens written per sequence

Pages hold bf16 or fp32 values, or int8 / float8_e4m3fn / float8_e5m2
payloads (``quant="int8"|"fp8"|"e5m2"``) with per (head, page, slot) fp32
scales of shape (H_kv, P, page, 1): per-token scales stay right under
incremental appends. Tokens are quantized as they are written
(``ops/quant.quantize_tokens``), bit for bit as the JAX package does.
Unlike the JAX package, whose arrays are immutable, appends here update
the cache's tensors in place (no copy of the pool per step).
"""

from __future__ import annotations

import dataclasses

import torch

from flashattention_tpu_torch.ops.paged_append import paged_append
from flashattention_tpu_torch.ops.paged_attention import paged_attention_plain
from flashattention_tpu_torch.ops.quant import PAYLOAD_DTYPE
from flashattention_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class PagedKVCache:
    """One layer's paged cache. ``quant`` in {None, "int8", "fp8", "e5m2"}."""

    k_pages: torch.Tensor            # (H_kv, P, page, D) values or payload
    v_pages: torch.Tensor
    k_scales: torch.Tensor | None = None  # (H_kv, P, page, 1) fp32 or None
    v_scales: torch.Tensor | None = None
    quant: str | None = None
    # the int8 schedule paged attention reads these pages in
    # (ops/paged_attention's int8_qk; None: its default rule)
    int8_qk: bool | str | None = None

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]

    @property
    def num_pages(self) -> int:
        return self.k_pages.shape[1]


def init_paged_cache(
    num_kv_heads: int,
    num_pages: int,
    page_size: int,
    head_dim: int,
    *,
    quant: str | None = None,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device | None = None,
    int8_qk: bool | str | None = None,
) -> PagedKVCache:
    """Zeroed pages on ``device`` (None: the card): ``dtype`` values, or
    the payloads of ``quant`` with scale planes of ones."""
    if quant is not None and quant not in PAYLOAD_DTYPE:
        raise ValueError(
            f"quant must be None|'int8'|'fp8'|'e5m2', got {quant!r}")
    device = resolve_device(device)
    shape = (num_kv_heads, num_pages, page_size, head_dim)
    payload = PAYLOAD_DTYPE[quant] if quant else dtype
    cache = PagedKVCache(
        k_pages=torch.zeros(shape, dtype=payload, device=device),
        v_pages=torch.zeros(shape, dtype=payload, device=device),
        quant=quant,
        int8_qk=int8_qk,
    )
    if quant:
        cache.k_scales, cache.v_scales = (
            torch.ones(shape[:3] + (1,), dtype=torch.float32, device=device)
            for _ in range(2))
    return cache


def append_to_pages(
    cache: PagedKVCache,
    k_new: torch.Tensor,         # (B, H_kv, T, D) new tokens
    v_new: torch.Tensor,
    page_indices: torch.Tensor,  # (B, pages_per_seq)
    lengths: torch.Tensor,       # (B,) lengths BEFORE this append
    valid_len: torch.Tensor | None = None,  # (B,) real tokens of the T
) -> PagedKVCache:
    """Write new K/V tokens into their pages, in place; returns ``cache``.

    One call of :func:`paged_append` for any T, which validates the
    arguments; on the card it is one kernel launch and no host sync (the
    kernel reads the page table and the lengths itself, and quantizes the
    tokens of a quantized cache). Positions
    past the sequence's page capacity and padding past ``valid_len`` are
    dropped: they are never written, not even with their current value (a
    masked position may alias a live write at the same slot).
    """
    paged_append(cache.k_pages, cache.v_pages, k_new, v_new, page_indices,
                 lengths, valid_len, cache.k_scales, cache.v_scales)
    return cache


def gather_pages(cache: PagedKVCache, page_indices: torch.Tensor):
    """Per-sequence contiguous K/V: (B, H_kv, pages*page, D) float32,
    dequantized (payload times its slot's scale) for a quantized cache."""
    pi = page_indices.long()
    b = pi.shape[0]

    def gather(pages, scales):
        x = pages[:, pi].float()
        if scales is not None:
            x = x * scales[:, pi]
        return x.transpose(0, 1).reshape(b, x.shape[0], -1, x.shape[-1])

    return (gather(cache.k_pages, cache.k_scales),
            gather(cache.v_pages, cache.v_scales))


def paged_attention_decode(
    q: torch.Tensor,             # (B, H, D)
    cache: PagedKVCache,
    page_indices: torch.Tensor,
    lengths: torch.Tensor,
    *,
    softmax_scale: float | None = None,
    window: int | None = None,
    softcap: float | None = None,
    sinks: int = 0,
) -> torch.Tensor:
    """Decode attention over the gathered, dequantized pages in float32
    (the JAX package's gather executor): a CPU oracle, returned in q's
    dtype."""
    k, v = gather_pages(cache, page_indices)   # (B, H_kv, L, D)
    # one page per sequence holding its whole gathered row
    pi = torch.arange(k.shape[0], dtype=torch.int32, device=k.device)[:, None]
    o = paged_attention_plain(
        q.float(), k.transpose(0, 1).contiguous(),
        v.transpose(0, 1).contiguous(), pi, lengths,
        softmax_scale=softmax_scale, window=window, softcap=softcap,
        sinks=sinks,
    )
    return o.to(q.dtype)
