"""Tiled online-softmax attention in plain PyTorch.

The counterpart of ``flashattention_tpu/ops/tiled.py``: the executor that
takes what the kernels do not, an arbitrary dense ``mask`` (and, through
it, the KV-cache decode of ``models/transformer.py``). A Python loop over
key tiles of ``block_k`` runs the online softmax in fp32 and divides by l
once at the end; the backward recomputes P from the saved LSE tile by tile.

Dropout uses the kernels' murmur3 counter mask at absolute (row, col)
(``ops/flash_attn.keep_mask``), so this executor and the kernels draw the
same mask for one seed. The JAX executor draws its mask with
``jax.random`` instead, which PyTorch cannot replay: with dropout the two
packages' tiled outputs differ by design.
"""

from __future__ import annotations

import dataclasses

import torch

from flashattention_tpu_torch.ops.flash_attn import keep_mask
from flashattention_tpu_torch.ops.reference import alibi_bias, score_pipeline


@dataclasses.dataclass(frozen=True, eq=False)
class _TiledOpts:
    causal: bool
    scale: float
    block_k: int
    offset: int
    mask: torch.Tensor | None
    dropout_rate: float
    seed: int
    softcap: float | None
    slopes: torch.Tensor | None


def _tile_scores(q32, k_j, j0, opts: _TiledOpts):
    """Scaled, biased, capped and masked fp32 scores of the key tile that
    starts at column ``j0``; returns (s, mask or None, d(capped)/d(raw) or
    None)."""
    n_q, n_j = q32.shape[2], k_j.shape[2]
    dev = q32.device
    s = torch.einsum("bhqd,bhkd->bhqk", q32, k_j.float()) * opts.scale
    rows = torch.arange(n_q, device=dev) + opts.offset
    cols = torch.arange(j0, j0 + n_j, device=dev)
    bias = None if opts.slopes is None else alibi_bias(opts.slopes, rows, cols)
    m = None
    if opts.causal:
        m = (cols[None, :] <= rows[:, None])[None, None]
    if opts.mask is not None:
        mt = opts.mask[..., j0:j0 + n_j]
        m = mt if m is None else (m & mt)
    s, dcap = score_pipeline(s, bias=bias, softcap=opts.softcap, visible=m)
    return s, m, dcap


def _tile_keep(opts: _TiledOpts, b, h, n_q, j0, n_j, device):
    return keep_mask(opts.seed, b, h, torch.arange(n_q, device=device),
                     torch.arange(j0, j0 + n_j, device=device),
                     opts.dropout_rate)


def _tiled_fwd(q, k, v, opts: _TiledOpts):
    b, h, n_q, d = q.shape
    n_k = k.shape[2]
    q32 = q.float()
    m_i = torch.full((b, h, n_q), float("-inf"), device=q.device)
    l_i = torch.zeros((b, h, n_q), device=q.device)
    acc = torch.zeros((b, h, n_q, d), device=q.device)
    for j0 in range(0, n_k, opts.block_k):
        k_j, v_j = k[:, :, j0:j0 + opts.block_k], v[:, :, j0:j0 + opts.block_k]
        s, tm, _ = _tile_scores(q32, k_j, j0, opts)
        m_new = torch.maximum(m_i, s.amax(dim=-1))
        alpha = torch.exp(m_i - m_new)
        p = torch.exp(s - m_new[..., None])
        if tm is not None:
            p = torch.where(tm, p, torch.zeros_like(p))
        l_i = alpha * l_i + p.sum(dim=-1)
        if opts.dropout_rate > 0.0:
            keep = _tile_keep(opts, b, h, n_q, j0, k_j.shape[2], q.device)
            p = torch.where(keep, p / (1.0 - opts.dropout_rate),
                            torch.zeros_like(p))
        acc = alpha[..., None] * acc + torch.einsum(
            "bhqk,bhkd->bhqd", p, v_j.float())
        m_i = m_new
    l_safe = torch.where(l_i == 0.0, torch.ones_like(l_i), l_i)
    return (acc / l_safe[..., None]).to(q.dtype), m_i + torch.log(l_safe)


def _tiled_bwd(q, k, v, o, lse, do, dlse, opts: _TiledOpts):
    b, h, n_q, _ = q.shape
    n_k = k.shape[2]
    q32, do32 = q.float(), do.float()
    di = (o.float() * do32).sum(dim=-1)
    if dlse is not None:
        di = di - dlse.float()
    dq = torch.zeros_like(q32)
    dk_tiles, dv_tiles = [], []
    for j0 in range(0, n_k, opts.block_k):
        k_j, v_j = k[:, :, j0:j0 + opts.block_k], v[:, :, j0:j0 + opts.block_k]
        s, tm, dcap = _tile_scores(q32, k_j, j0, opts)
        p = torch.exp(s - lse[..., None])
        if tm is not None:
            p = torch.where(tm, p, torch.zeros_like(p))
        dp = torch.einsum("bhqd,bhkd->bhqk", do32, v_j.float())
        p_v = p
        if opts.dropout_rate > 0.0:
            keep = _tile_keep(opts, b, h, n_q, j0, k_j.shape[2], q.device)
            p_v = torch.where(keep, p / (1.0 - opts.dropout_rate),
                              torch.zeros_like(p))
            dp = torch.where(keep, dp / (1.0 - opts.dropout_rate),
                             torch.zeros_like(dp))
        dv_tiles.append(torch.einsum("bhqk,bhqd->bhkd", p_v, do32))
        ds = p * (dp - di[..., None])
        if dcap is not None:
            ds = ds * dcap
        ds = ds * opts.scale
        dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, k_j.float())
        dk_tiles.append(torch.einsum("bhqk,bhqd->bhkd", ds, q32))
    return (dq.to(q.dtype), torch.cat(dk_tiles, dim=2).to(k.dtype),
            torch.cat(dv_tiles, dim=2).to(v.dtype))


class _Tiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, opts):
        o, lse = _tiled_fwd(q, k, v, opts)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = opts
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        return (*_tiled_bwd(q, k, v, o, lse, do, dlse, ctx.opts), None)


def tiled_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    softmax_scale: float | None = None,
    block_k: int = 128,
    mask: torch.Tensor | None = None,
    dropout_rate: float = 0.0,
    dropout_seed: int | None = None,
    q_offset: int | None = None,
    softcap: float | None = None,
    alibi_slopes: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Tiled online-softmax attention: q, k, v (B, H, N, D) with equal head
    counts (q may have another N than k/v) -> (o in q's dtype, fp32 lse).

    ``mask``: bool (N_q, N_k) or (B|1, H|1, N_q, N_k), True = attend.
    ``q_offset``: key position of query row 0 under ``causal`` (default
    N_k - N_q). ``softcap`` caps the scaled scores before the mask;
    ``alibi_slopes`` (H,) adds -slope_h * |col - (row + q_offset)|.
    ``dropout_seed`` (int) seeds the counter-based dropout mask."""
    d = q.shape[-1]
    if softmax_scale is None:
        softmax_scale = d ** -0.5
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if mask is not None:
        if mask.shape[-1] != k.shape[-2] or mask.shape[-2] != q.shape[-2]:
            raise ValueError(
                f"mask must end in (N_q, N_k)=({q.shape[-2]}, {k.shape[-2]}), "
                f"got {tuple(mask.shape)}")
        if mask.dim() not in (2, 4):
            raise ValueError(f"mask must be 2-D or 4-D, got {tuple(mask.shape)}")
        mask = mask.to(device=q.device, dtype=torch.bool)
    if q_offset is None:
        q_offset = k.shape[-2] - q.shape[-2]
    slopes = None
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes).to(
            device=q.device, dtype=torch.float32).reshape(-1)
        if tuple(slopes.shape) != (q.shape[1],):
            raise ValueError(f"alibi_slopes must be (H,)=({q.shape[1]},), got "
                             f"{tuple(slopes.shape)}")
    opts = _TiledOpts(
        causal=bool(causal), scale=float(softmax_scale), block_k=int(block_k),
        offset=int(q_offset), mask=mask, dropout_rate=float(dropout_rate),
        seed=int(dropout_seed or 0) & 0xFFFFFFFF,
        softcap=None if softcap is None else float(softcap), slopes=slopes,
    )
    return _Tiled.apply(q, k, v, opts)
