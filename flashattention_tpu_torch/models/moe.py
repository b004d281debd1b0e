"""Mixture-of-experts MLP: top-k routing with capacity, GShard/Switch style.

The counterpart of ``flashattention_tpu/models/moe.py``. Per MoE layer the
parameters are ``router`` (D, E), ``w_in`` (E, D, F), ``b_in`` (E, F),
``w_out`` (E, F, D) and ``b_out`` (E, D), named as in the JAX package.

Routing, as the JAX package computes it:

- tokens are routed per group of consecutive tokens, the largest divisor of
  N that fits ``cfg.moe_group_size`` (never one whole-N group);
- fp32 router logits, softmax, the top-k experts of each token, their gates
  renormalised to sum to 1;
- each expert takes at most C = ceil(g * k * cf / E) assignments per group,
  filled choice-major (all first choices before any second choice);
  an assignment past C is dropped. ``dropless=True`` (every inference
  path) sets C = g, so nothing is dropped;
- dispatch and combine are one-hot einsums (plain ``torch.einsum``: the JAX
  package computes them outside any Pallas kernel), the experts' MLP uses
  tanh GELU;
- the Switch load-balance loss ``E * sum_e f_e * P_e`` over first choices.

Ties: ``jax.lax.top_k`` puts the lower expert index first where two
probabilities are equal (a zero router ties every expert); ``torch.topk``
promises no order there. :func:`top_k` takes a stable descending sort
instead, which keeps the lower index first.

Expert parallelism (``shard``, a ``parallel.sharded.ShardContext``): the
expert leaves hold this model rank's E / n_model experts, the router is
replicated and every rank routes the whole token set. The combine is linear
in the experts, so each rank mixes its own experts' outputs and one
all-reduce over ``model`` sums them, as after the row-parallel MLP; the
load-balance statistics are averaged over ``data`` so that the loss is the
one of the whole batch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def group_size(n: int, cfg) -> int:
    """Tokens per routing group: the largest divisor of ``n`` that fits
    ``cfg.moe_group_size``."""
    gs = min(cfg.moe_group_size, n)
    return next(g for g in range(gs, 0, -1) if n % g == 0)


def capacity(g: int, cfg, dropless: bool) -> int:
    """Slots per (group, expert)."""
    if dropless:
        return g
    return max(1, math.ceil(g * cfg.moe_top_k * cfg.moe_capacity_factor
                            / cfg.moe_experts))


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the last dim, ties to
    the lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(xg: torch.Tensor, router: torch.Tensor, cfg, cap: int):
    """Routing of grouped tokens xg (BG, G, D): (dispatch (BG, G, E, C),
    combine (BG, G, E, C), probs (BG, G, E), first-choice one-hot (BG, G, E),
    expert indices (BG, G, k)); all fp32 but the indices."""
    bg, g, _ = xg.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    probs = torch.softmax(xg.float() @ router.float(), dim=-1)
    gate_vals, gate_idx = top_k(probs, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    oh = F.one_hot(gate_idx, e).float()                      # (BG, G, k, E)
    # choice-major fill order: flatten (k, G) with k outermost
    flat = oh.transpose(1, 2).reshape(bg, k * g, e)
    pos = torch.cumsum(flat, dim=1) - flat                   # slots taken
    kept = flat * (pos < cap)
    # a dropped assignment (pos >= cap) has kept = 0, so clamping its slot
    # index changes nothing
    slot = F.one_hot(pos.long().clamp(max=cap - 1), cap).float() * kept[..., None]
    slot = slot.reshape(bg, k, g, e, cap).transpose(1, 2)    # (BG, G, k, E, C)
    dispatch = slot.sum(dim=2)
    combine = (gate_vals[..., None, None] * slot).sum(dim=2)
    return dispatch, combine, probs, oh[:, :, 0], gate_idx


def moe_mlp(x: torch.Tensor, p, cfg, *, dropless: bool = False, shard=None):
    """(B, N, D) -> ((B, N, D), fp32 aux loss), the JAX ``moe_mlp``.

    ``dropless=True`` for inference (eval forward, KV-cache decode, the
    serving engine): capacity g, nothing dropped, so the output does not
    depend on the group or on other tokens. Training keeps the capacity
    drops. ``p`` has the attributes ``router``, ``w_in``, ``b_in``,
    ``w_out``, ``b_out``; ``shard`` (optional) runs this rank's experts
    (module docstring)."""
    b, n, d = x.shape
    g = group_size(n, cfg)
    cap = capacity(g, cfg, dropless)
    xg = x.reshape(b * n // g, g, d)
    dispatch, combine, probs, first, _ = route(xg, p.router, cfg, cap)

    cdt = x.dtype
    if shard is not None and shard.n_model > 1:
        lo, hi = shard.model_range(cfg.moe_experts)
        dispatch = dispatch[:, :, lo:hi]
        combine = shard.enter(combine)[:, :, lo:hi]
        xg = shard.enter(xg)
    xin = torch.einsum("bnec,bnd->ebcd", dispatch.to(cdt), xg)
    h = F.gelu(torch.einsum("ebcd,edf->ebcf", xin, p.w_in.to(cdt))
               + p.b_in.to(cdt)[:, None, None, :], approximate="tanh")
    yexp = (torch.einsum("ebcf,efd->ebcd", h, p.w_out.to(cdt))
            + p.b_out.to(cdt)[:, None, None, :])
    y = torch.einsum("bnec,ebcd->bnd", combine.to(cdt), yexp)
    if shard is not None:
        y = shard.exit(y)

    # Switch load-balance loss over first choices, means over all tokens
    f = first.mean(dim=(0, 1))
    pm = probs.mean(dim=(0, 1))
    if shard is not None:
        f, pm = shard.data_mean(f), shard.data_mean(pm)
    aux = cfg.moe_experts * (f * pm).sum()
    return y.reshape(b, n, d), aux
