"""Decoder-only transformer: configuration, parameters, the training
forward and KV-cache decode.

The counterpart of ``flashattention_tpu/models/transformer.py``. Parameters
keep the JAX package's names and layout (weights are ``(in, out)`` and apply
as ``x @ w``), so a JAX parameter tree loads by name through
:func:`params_from_jax`:

    tok_emb, pos_emb, lm_head.{w,b}, final_ln.{g,b},
    blocks.{i}.attn.{w_qkv,b_qkv,w_o,b_o}   (or w_q,b_q,w_k,b_k,w_v,b_v),
    blocks.{i}.ln1.{g,b}, blocks.{i}.mlp.{w_in,b_in,w_out,b_out},
    blocks.{i}.ln2.{g,b}

and, with ``moe_experts > 0``, blocks.{i}.mlp.{router, w_in, b_in, w_out,
b_out} with a leading expert dim (``models/moe.py``).

Post-LN blocks (attention -> residual -> LN -> MLP -> residual -> LN), as
in the JAX package. Attention goes through ``ops.api.flash_attention``: the
CUDA flash kernels on the card; with a block-sparse pattern, through
``ops.sparse_attn.sparse_attention`` (kernels B8-B10) when there is no
attention dropout and no soft-cap, else through the tiled executor with the
pattern expanded to an element mask.

Tensor parallelism: the forward takes an optional ``shard`` (a
``parallel.sharded.ShardContext``). With it, the parameters are this model
rank's shards: attention runs the rank's heads, the MLP its columns of
``w_in`` (or its experts), and ``shard.enter`` / ``shard.exit`` put the
Megatron collectives around the column- and row-parallel products; the LM
head's vocab shards are gathered. Without it nothing changes.

Dropout under recomputation: with ``remat`` every block runs its forward
twice, and ``torch.utils.checkpoint`` restores only the global generators.
So each dropout site takes one integer seed, drawn per step before the
forward (:func:`dropout_site_seeds`, the counterpart of
``jax.random.split(dropout_key, 3 * n_layers)``), and builds its mask from
that seed inside the block; the recompute draws the same mask.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from flashattention_tpu_torch.models.moe import moe_mlp
from flashattention_tpu_torch.ops.api import flash_attention
from flashattention_tpu_torch.ops.sparse_attn import sparse_attention
from flashattention_tpu_torch.ops.tiled import tiled_attention
from flashattention_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Same fields and defaults as the JAX package's ``TransformerConfig``
    (GPT-3 Small widths), with torch dtypes."""

    vocab_size: int = 50257
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    n_kv_heads: int | None = None  # GQA/MQA; None -> MHA (= n_heads)
    fused_qkv: bool = True
    d_ff: int = 3072
    max_seq_len: int = 512
    dropout_rate: float = 0.1
    block_size: int = 128
    tau: float | None = None       # softmax temperature; default sqrt(d_head)
    pos_encoding: str = "learned"  # "learned" | "rope" | "none"
    rope_theta: float = 10000.0
    attention_window: int | None = None
    attn_softcap: float | None = None
    attention_sinks: int = 0
    loss_chunk: int | None = None
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 512
    moe_aux_coef: float = 0.01
    dtype: Any = torch.bfloat16    # activation/compute dtype
    param_dtype: Any = torch.float32
    attention_backend: str = "auto"
    remat: bool = True
    remat_policy: str = "full"     # "full" | "dots"

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def qkv_dim(self) -> int:
        """Fused QKV projection width: H·dh + 2·H_kv·dh."""
        return (self.n_heads + 2 * self.kv_heads) * self.d_head

    @property
    def softmax_scale(self) -> float:
        return 1.0 / self.tau if self.tau else self.d_head ** -0.5


def _check_supported(cfg: TransformerConfig) -> None:
    if cfg.pos_encoding not in ("learned", "rope", "none"):
        raise ValueError(f"unknown pos_encoding {cfg.pos_encoding!r}")
    if cfg.pos_encoding == "rope" and cfg.d_head % 2:
        raise ValueError("rope needs an even d_head")
    if cfg.attention_window is not None and cfg.attention_window < 1:
        raise ValueError("attention_window must be >= 1")
    if cfg.attention_sinks and cfg.attention_window is None:
        raise ValueError("attention_sinks require attention_window")
    if cfg.moe_experts and not 1 <= cfg.moe_top_k <= cfg.moe_experts:
        raise ValueError(f"moe_top_k must be in [1, {cfg.moe_experts}], got "
                         f"{cfg.moe_top_k}")


class _Params(nn.Module):
    """A module that only holds named, trainable parameters."""

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t))


def _ln(d, dtype, device):
    return _Params(g=torch.ones(d, dtype=dtype, device=device),
                   b=torch.zeros(d, dtype=dtype, device=device))


class Block(nn.Module):
    def __init__(self, attn: _Params, ln1: _Params, mlp: _Params, ln2: _Params):
        super().__init__()
        self.attn, self.ln1, self.mlp, self.ln2 = attn, ln1, mlp, ln2


class Transformer(nn.Module):
    """The model's parameters, named as in the JAX package."""

    def __init__(self, cfg: TransformerConfig, tok_emb, pos_emb, blocks,
                 final_ln, lm_head):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.tok_emb = nn.Parameter(tok_emb)
        self.pos_emb = nn.Parameter(pos_emb) if pos_emb is not None else None
        self.blocks = nn.ModuleList(blocks)
        self.final_ln = final_ln
        self.lm_head = lm_head


_QKV_NAMES = {True: ("w_qkv", "b_qkv", "w_o", "b_o"),
              False: ("w_q", "b_q", "w_k", "b_k", "w_v", "b_v", "w_o", "b_o")}
_MLP_NAMES = {False: ("w_in", "b_in", "w_out", "b_out"),
              True: ("router", "w_in", "b_in", "w_out", "b_out")}


def init_params(cfg: TransformerConfig, seed: int = 0,
                device: str | torch.device | None = None) -> Transformer:
    """Random parameters with the JAX package's init distribution (normal,
    std 0.02; residual-branch outputs 0.02 / sqrt(2 · n_layers); zero
    biases, unit LN gains; MoE blocks as ``init_moe_mlp``), drawn from a
    ``torch.Generator`` seeded with ``seed`` (not the JAX package's
    numbers), on ``device`` (None: the card)."""
    _check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    pd = cfg.param_dtype
    d, dff = cfg.d_model, cfg.d_ff
    qd, kvd = cfg.n_heads * cfg.d_head, cfg.kv_heads * cfg.d_head

    def normal(shape, std=0.02):
        return (torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * std).to(pd)

    def zeros(n):
        return torch.zeros(n, dtype=pd, device=device)

    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    tok_emb = normal((cfg.vocab_size, d))
    pos_emb = normal((cfg.max_seq_len, d)) if cfg.pos_encoding == "learned" else None
    lm_head = _Params(w=normal((d, cfg.vocab_size)), b=zeros(cfg.vocab_size))
    blocks = []
    for _ in range(cfg.n_layers):
        if cfg.fused_qkv:
            attn = _Params(w_qkv=normal((d, cfg.qkv_dim)), b_qkv=zeros(cfg.qkv_dim),
                           w_o=normal((d, d), out_scale), b_o=zeros(d))
        else:
            attn = _Params(w_q=normal((d, qd)), b_q=zeros(qd),
                           w_k=normal((d, kvd)), b_k=zeros(kvd),
                           w_v=normal((d, kvd)), b_v=zeros(kvd),
                           w_o=normal((d, d), out_scale), b_o=zeros(d))
        if cfg.moe_experts:
            e = cfg.moe_experts
            mlp = _Params(router=normal((d, e)), w_in=normal((e, d, dff)),
                          b_in=zeros((e, dff)),
                          w_out=normal((e, dff, d), out_scale),
                          b_out=zeros((e, d)))
        else:
            mlp = _Params(w_in=normal((d, dff)), b_in=zeros(dff),
                          w_out=normal((dff, d), out_scale), b_out=zeros(d))
        blocks.append(Block(attn, _ln(d, pd, device), mlp, _ln(d, pd, device)))
    return Transformer(cfg, tok_emb, pos_emb, blocks, _ln(d, pd, device), lm_head)


def params_from_jax(tree, cfg: TransformerConfig,
                    device: str | torch.device | None = None) -> Transformer:
    """Load a JAX parameter tree (nested dicts/lists of arrays, e.g. after
    ``jax.tree.map(np.asarray, params)``) into a :class:`Transformer` on
    ``device`` (None: the card), keeping names and the ``(in, out)`` weight
    layout."""
    device = resolve_device(device)

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32, copy=True)).to(
            device=device, dtype=cfg.param_dtype
        )

    def group(p, names):
        return _Params(**{n: t(p[n]) for n in names})

    blocks = [
        Block(
            group(bp["attn"], _QKV_NAMES["w_qkv" in bp["attn"]]),
            group(bp["ln1"], ("g", "b")),
            group(bp["mlp"], _MLP_NAMES["router" in bp["mlp"]]),
            group(bp["ln2"], ("g", "b")),
        )
        for bp in tree["blocks"]
    ]
    if len(blocks) != cfg.n_layers:
        raise ValueError(f"tree has {len(blocks)} blocks, cfg {cfg.n_layers}")
    pos_emb = t(tree["pos_emb"]) if "pos_emb" in tree else None
    return Transformer(
        cfg, t(tree["tok_emb"]), pos_emb, blocks,
        group(tree["final_ln"], ("g", "b")), group(tree["lm_head"], ("w", "b")),
    )


# ---------------------------------------------------------------------------
# Pieces shared by training, decode and the serving engine
# ---------------------------------------------------------------------------


def lm_head_logits(lm, x: torch.Tensor) -> torch.Tensor:
    """float32 LM-head projection."""
    return x.float() @ lm.w.float() + lm.b.float()


def head_logits(lm, x: torch.Tensor, shard=None) -> torch.Tensor:
    """:func:`lm_head_logits`; under ``shard`` the vocab shards of every
    model rank, gathered."""
    if shard is None:
        return lm_head_logits(lm, x)
    return shard.gather_vocab(lm_head_logits(lm, shard.enter(x)))


def layer_norm(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32 with population variance, cast back to x's
    dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), p.g.float(), p.b.float(), eps)
    return y.to(x.dtype)


def rope(t: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary position embedding (split-half / NeoX layout) on (B, H, N, dh).

    ``pos``: (N,) positions shared by the batch, or (B, N) per-row
    positions. float32 rotation, cast back."""
    half = t.shape[-1] // 2
    inv = theta ** (
        -torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    freqs = pos.to(torch.float32)[..., :, None] * inv
    if freqs.dim() == 3:
        freqs = freqs[:, None]  # broadcast over heads
    cos, sin = torch.cos(freqs), torch.sin(freqs)
    t1 = t[..., :half].float()
    t2 = t[..., half:].float()
    return torch.cat([t1 * cos - t2 * sin, t2 * cos + t1 * sin], dim=-1).to(t.dtype)


def block_sparse_mask(n_q: int, n_k: int, block: int,
                      pattern: torch.Tensor) -> torch.Tensor:
    """Expand an (n_q_blocks, n_k_blocks) tile pattern to an elementwise
    (n_q, n_k) bool mask; each tile entry covers ``block`` rows and cols."""
    if pattern.shape[0] * block < n_q or pattern.shape[1] * block < n_k:
        raise ValueError(f"pattern {tuple(pattern.shape)} x block {block} "
                         f"cannot cover ({n_q}, {n_k})")
    m = pattern.bool().repeat_interleave(block, 0).repeat_interleave(block, 1)
    return m[:n_q, :n_k]


def segment_positions(segment_ids: torch.Tensor) -> torch.Tensor:
    """Position of each token inside its segment: (B, N) ids of contiguous
    runs -> (B, N) int64, restarting at 0 on every id change."""
    b, n = segment_ids.shape
    ar = torch.arange(n, device=segment_ids.device)
    changed = torch.cat([
        torch.ones((b, 1), dtype=torch.bool, device=segment_ids.device),
        segment_ids[:, 1:] != segment_ids[:, :-1]], dim=1)
    start = torch.cummax(torch.where(changed, ar[None, :], 0), dim=1).values
    return ar[None, :] - start


def dropout_site_seeds(dropout_seed: int, n_layers: int) -> list[int]:
    """1 + 3·n_layers seeds: the embedding dropout, then per block the
    attention kernel's, the attention output's and the MLP output's."""
    rng = np.random.default_rng(int(dropout_seed))
    return [int(s) for s in rng.integers(0, 2 ** 31, size=1 + 3 * n_layers)]


def _dropout(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """Inverted dropout whose mask depends only on ``seed`` (and the
    device: CPU and CUDA generators draw different streams), so a
    recomputed forward replays it."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    u = torch.rand(x.shape, generator=gen, device=x.device, dtype=torch.float32)
    return torch.where(u < 1.0 - rate, x / (1.0 - rate), torch.zeros_like(x))


def _embed(params: Transformer, tokens, cfg, positions=None, start: int = 0):
    x = params.tok_emb[tokens].to(cfg.dtype) * torch.tensor(
        math.sqrt(cfg.d_model), dtype=cfg.dtype, device=tokens.device)
    if cfg.pos_encoding == "learned":
        if positions is not None:
            x = x + params.pos_emb[positions].to(cfg.dtype)
        else:
            x = x + params.pos_emb[start:start + tokens.shape[1]].to(cfg.dtype)
    return x


def _project_qkv(x, p, cfg, n_model: int = 1):
    """q, k, v (B, heads, N, dh) of this model rank's heads."""
    dt = x.dtype
    h, h_kv, dh = cfg.n_heads // n_model, cfg.kv_heads // n_model, cfg.d_head
    if hasattr(p, "w_qkv"):
        qkv = x @ p.w_qkv.to(dt) + p.b_qkv.to(dt)
        q, k, v = torch.split(qkv, [h * dh, h_kv * dh, h_kv * dh], dim=-1)
    else:
        q = x @ p.w_q.to(dt) + p.b_q.to(dt)
        k = x @ p.w_k.to(dt) + p.b_k.to(dt)
        v = x @ p.w_v.to(dt) + p.b_v.to(dt)
    b, n, _ = x.shape

    def heads(t, nh):  # (B, N, nh*dh) -> (B, nh, N, dh)
        return t.reshape(b, n, nh, dh).transpose(1, 2)

    return heads(q, h), heads(k, h_kv), heads(v, h_kv)


def _attention(x, p, cfg: TransformerConfig, *, dropout_seed, train,
               kv_cache=None, cache_index: int = 0, sparse_mask=None,
               segment_ids=None, positions=None, shard=None):
    b, n, d = x.shape
    n_model = 1
    if shard is not None:
        x, n_model = shard.enter(x), shard.n_model
        if dropout_seed is not None and n_model > 1:
            # other heads on every rank: other masks
            dropout_seed = (dropout_seed + shard.model_rank * 0x9E3779B1) \
                & 0xFFFFFFFF
    q, k, v = _project_qkv(x, p, cfg, n_model)
    if cfg.pos_encoding == "rope":
        if positions is not None:
            pos = positions
        else:
            start = cache_index if kv_cache is not None else 0
            pos = start + torch.arange(n, device=x.device)
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)  # rotated before caching

    if kv_cache is not None:
        # Decode: write this chunk's K/V at cache_index (in place), attend
        # to the written prefix through the tiled executor and a mask.
        kc, vc = kv_cache["k"], kv_cache["v"]
        kc[:, :, cache_index:cache_index + n] = k.to(kc.dtype)
        vc[:, :, cache_index:cache_index + n] = v.to(vc.dtype)
        n_cache = kc.shape[2]
        rows = torch.arange(n, device=x.device)[:, None] + cache_index
        cols = torch.arange(n_cache, device=x.device)[None, :]
        mask = cols <= rows
        if cfg.attention_window is not None:
            band = cols > rows - cfg.attention_window
            if cfg.attention_sinks:
                band = band | (cols < cfg.attention_sinks)
            mask = mask & band
        kk, vv = kc.to(q.dtype), vc.to(q.dtype)
        if cfg.kv_heads != cfg.n_heads:
            g = cfg.n_heads // cfg.kv_heads
            kk = kk.repeat_interleave(g, dim=1)
            vv = vv.repeat_interleave(g, dim=1)
        o, _ = tiled_attention(q, kk, vv, softmax_scale=cfg.softmax_scale,
                               block_k=min(cfg.block_size, n_cache), mask=mask,
                               softcap=cfg.attn_softcap)
    else:
        rate = cfg.dropout_rate if train else 0.0
        if sparse_mask is not None and cfg.attention_window is not None:
            raise ValueError(
                "attention_window and a block-sparse pattern cannot combine")
        if sparse_mask is not None and segment_ids is not None:
            raise ValueError("segment_ids (packed varlen) and a block-sparse "
                             "pattern cannot combine")
        if sparse_mask is not None and rate == 0.0 and cfg.attn_softcap is None:
            # the sparse kernels take GQA natively: K/V are not repeated
            o, _ = sparse_attention(
                q.contiguous(), k.contiguous(), v.contiguous(), sparse_mask,
                causal=True, softmax_scale=cfg.softmax_scale,
                block_q=cfg.block_size, block_k=cfg.block_size)
        else:
            o, _ = flash_attention(
                q.contiguous(), k.contiguous(), v.contiguous(),
                causal=True, softmax_scale=cfg.softmax_scale,
                backend=cfg.attention_backend, block_k=cfg.block_size,
                mask=(block_sparse_mask(n, n, cfg.block_size, sparse_mask)
                      if sparse_mask is not None else None),
                dropout_rate=rate,
                dropout_seed=dropout_seed if rate > 0 else None,
                window=cfg.attention_window, segment_ids=segment_ids,
                softcap=cfg.attn_softcap, sinks=cfg.attention_sinks,
            )
    o = o.transpose(1, 2).reshape(b, n, -1) @ p.w_o.to(o.dtype)
    if shard is not None:
        o = shard.exit(o)
    return o + p.b_o.to(o.dtype)


def _dense_mlp(x, p, shard=None):
    dt = x.dtype
    if shard is not None:
        x = shard.enter(x)
    hidden = F.gelu(x @ p.w_in.to(dt) + p.b_in.to(dt), approximate="tanh")
    y = hidden @ p.w_out.to(dt)
    if shard is not None:
        y = shard.exit(y)
    return y + p.b_out.to(dt)


def _mlp(x, p, cfg):
    """The MLP of the inference paths (KV-cache decode): dense, or the
    mixture routed dropless (exact, causal, the same for a whole sequence
    and one token)."""
    if hasattr(p, "router"):
        return moe_mlp(x, p, cfg, dropless=True)[0]
    return _dense_mlp(x, p)


def _mlp_aux(x, p, cfg, *, train, shard=None):
    """(y, fp32 load-balance aux): MoE blocks route with capacity drops
    in training and dropless otherwise; dense blocks give aux None."""
    if hasattr(p, "router"):
        return moe_mlp(x, p, cfg, dropless=not train, shard=shard)
    return _dense_mlp(x, p, shard), None


def _block(x, bp, cfg, *, seeds, train, sparse_mask=None, segment_ids=None,
           positions=None, shard=None):
    """One post-LN block; ``seeds`` are its three dropout-site seeds.
    Returns (x, the block's MoE aux loss, None for a dense block)."""
    drop = train and cfg.dropout_rate > 0
    attn_out = _attention(x, bp.attn, cfg, dropout_seed=seeds[0], train=train,
                          sparse_mask=sparse_mask, segment_ids=segment_ids,
                          positions=positions, shard=shard)
    if drop:
        attn_out = _dropout(attn_out, seeds[1], cfg.dropout_rate)
    x = layer_norm(x + attn_out, bp.ln1)
    mlp_out, aux = _mlp_aux(x, bp.mlp, cfg, train=train, shard=shard)
    if drop:
        mlp_out = _dropout(mlp_out, seeds[2], cfg.dropout_rate)
    return layer_norm(x + mlp_out, bp.ln2), aux


_SAVED_BY_DOTS = frozenset({torch.ops.aten.mm.default,
                            torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    """Remat "dots": keep the outputs of unbatched matrix products (the
    projections and the MLP), recompute the rest (the JAX package's
    ``dots_with_no_batch_dims_saveable``)."""
    if op in _SAVED_BY_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: TransformerConfig):
    if cfg.remat_policy not in ("full", "dots"):
        raise ValueError(f"remat_policy must be 'full' or 'dots', got "
                         f"{cfg.remat_policy!r}")
    if not cfg.remat or not torch.is_grad_enabled():
        return fn
    if cfg.remat_policy == "full":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    ctx_fn = functools.partial(create_selective_checkpoint_contexts,
                               _dots_policy)
    return lambda *a: checkpoint(fn, *a, use_reentrant=False, context_fn=ctx_fn)


def apply_transformer(
    params: Transformer,
    tokens: torch.Tensor,
    cfg: TransformerConfig,
    *,
    train: bool = False,
    dropout_seed: int | None = None,
    sparse_pattern: torch.Tensor | None = None,
    segment_ids: torch.Tensor | None = None,
    return_hidden: bool = False,
    return_aux: bool = False,
    shard=None,
):
    """tokens (B, N) -> float32 logits (B, N, vocab), or the final-LN hidden
    states with ``return_hidden``; with ``return_aux`` also the summed MoE
    load-balance loss of the blocks (fp32, 0 for a dense model). MoE blocks
    keep capacity drops under ``train`` and route dropless otherwise.
    ``shard``: tensor parallelism (module docstring).

    ``train`` turns dropout on; it then needs ``dropout_seed`` (an int),
    from which every site's seed is drawn. ``segment_ids`` (B, N): packed
    rows, attention within each segment and positions restarting per
    segment. ``sparse_pattern``: a bool block pattern, True = attend,
    normalized as the JAX package does to the ceil(N / block_size) square
    of tiles (each entry repeated ceil(n_tiles / its side) times, then
    sliced); causal attention then runs only the active tiles. It cannot
    combine with a window or ``segment_ids``."""
    _check_supported(cfg)
    drop = train and cfg.dropout_rate > 0
    if drop and dropout_seed is None:
        raise ValueError("train with dropout_rate > 0 requires dropout_seed")
    positions = None
    if segment_ids is not None:
        segment_ids = segment_ids.to(tokens.device)
        positions = segment_positions(segment_ids)
    x = _embed(params, tokens, cfg, positions)
    seeds = (dropout_site_seeds(dropout_seed, cfg.n_layers) if drop
             else [None] * (1 + 3 * cfg.n_layers))
    if drop:
        x = _dropout(x, seeds[0], cfg.dropout_rate)

    sparse_mask = None
    if sparse_pattern is not None:
        n = tokens.shape[1]
        n_tiles = -(-n // cfg.block_size)
        pat = torch.as_tensor(sparse_pattern, device=tokens.device).bool()
        sparse_mask = pat.repeat_interleave(
            -(-n_tiles // pat.shape[0]), 0).repeat_interleave(
            -(-n_tiles // pat.shape[1]), 1)[:n_tiles, :n_tiles]

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, bp in enumerate(params.blocks):
        one_block = functools.partial(
            _block, bp=bp, cfg=cfg, seeds=seeds[1 + 3 * i: 4 + 3 * i],
            train=train, sparse_mask=sparse_mask, segment_ids=segment_ids,
            positions=positions, shard=shard)
        x, aux = _remat(one_block, cfg)(x)
        if aux is not None:
            aux_total = aux_total + aux
    x = layer_norm(x, params.final_ln)
    out = x if return_hidden else head_logits(params.lm_head, x, shard)
    return (out, aux_total) if return_aux else out


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int | None = None,
                  dtype=None, device=None) -> list[dict[str, torch.Tensor]]:
    """Per layer {"k", "v"} of (B, H_kv, max_len, dh) zeros on ``device``
    (None: the card)."""
    device = resolve_device(device)
    shape = (batch, cfg.kv_heads, max_len or cfg.max_seq_len, cfg.d_head)
    dtype = dtype or cfg.dtype
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.n_layers)]


@torch.no_grad()
def _decode_chunk_impl(params, caches, tokens, cache_index: int, cfg):
    n = tokens.shape[1]
    # the learned table is sliced as lax.dynamic_slice does: clamped in range
    start = min(max(int(cache_index), 0), cfg.max_seq_len - n)
    x = _embed(params, tokens, cfg, start=start)
    for bp, cache in zip(params.blocks, caches):
        attn_out = _attention(x, bp.attn, cfg, dropout_seed=None, train=False,
                              kv_cache=cache, cache_index=int(cache_index))
        x = layer_norm(x + attn_out, bp.ln1)
        x = layer_norm(x + _mlp(x, bp.mlp, cfg), bp.ln2)
    x = layer_norm(x, params.final_ln)
    return lm_head_logits(params.lm_head, x), caches


def decode_step(params, caches, tokens, cache_index: int, cfg):
    """One decode step for tokens (B, 1) at ``cache_index``: returns
    (logits (B, vocab), caches). The caches are updated in place (the JAX
    version returns new arrays)."""
    logits, caches = _decode_chunk_impl(params, caches, tokens, cache_index, cfg)
    return logits[:, -1], caches


def decode_chunk(params, caches, tokens, cache_index: int, cfg):
    """Append the chunk tokens (B, n) at ``cache_index`` and attend causally
    to the cache prefix and the chunk: (logits (B, n, vocab), caches); row j
    predicts position cache_index + j + 1. Caches update in place."""
    return _decode_chunk_impl(params, caches, tokens, cache_index, cfg)
