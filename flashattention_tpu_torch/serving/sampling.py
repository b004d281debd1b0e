"""Token sampling for the serving engine: temperature / top-k / top-p.

The counterpart of ``flashattention_tpu/serving/sampling.py``. Greedy
argmax is the default. Stochastic draws come from an explicit
``torch.Generator``; they cannot reproduce the JAX package's PRNG stream,
so the two agree in distribution, not draw by draw. The same holds for
:func:`spec_accept_emit`, the speculative engine's acceptance test.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["SamplingConfig", "filter_logits", "sample_logits",
           "spec_accept_emit"]


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """temperature: 0.0 = greedy argmax (top_k/top_p ignored).
    top_k: keep the k highest-probability tokens (0 = no top-k filter).
    top_p: keep the smallest prefix of descending-probability tokens whose
        cumulative mass reaches top_p (1.0 = no nucleus filter).
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


_NEG = -1e30  # filtered-out logit (finite)


def filter_logits(logits: torch.Tensor, cfg: SamplingConfig) -> torch.Tensor:
    """Temperature, then top-k, then top-p on (..., V) logits; filtered-out
    entries go to a large negative. Needs temperature > 0."""
    if cfg.greedy:
        raise ValueError("filter_logits needs temperature > 0")
    x = logits.float() / cfg.temperature
    v = x.shape[-1]
    neg = torch.full_like(x, _NEG)
    if 0 < cfg.top_k < v:
        kth = torch.topk(x, cfg.top_k, dim=-1).values[..., -1:]
        x = torch.where(x < kth, neg, x)
    if cfg.top_p < 1.0:
        sorted_x = torch.sort(x, dim=-1, descending=True).values
        probs = torch.softmax(sorted_x, dim=-1)
        cum = torch.cumsum(probs, dim=-1) - probs  # exclusive prefix mass
        in_nucleus = cum < cfg.top_p               # position 0 always kept
        cutoff = torch.where(
            in_nucleus, sorted_x, torch.full_like(sorted_x, float("inf"))
        ).amin(dim=-1, keepdim=True)
        x = torch.where(x < cutoff, neg, x)
    return x


def sample_logits(
    logits: torch.Tensor,
    generator: torch.Generator | None,
    cfg: SamplingConfig,
) -> torch.Tensor:
    """(B, V) logits -> (B,) int64 tokens. ``generator`` may be None when
    greedy."""
    if cfg.greedy:
        return torch.argmax(logits, dim=-1)
    if generator is None:
        raise ValueError("stochastic sampling needs a torch.Generator")
    probs = torch.softmax(filter_logits(logits, cfg), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def spec_accept_emit(
    p_dist: torch.Tensor,   # (B, g+1, V) target filtered probs per chunk row
    q_dist: torch.Tensor,   # (B, g, V)   draft filtered probs per proposal
    draft: torch.Tensor,    # (B, g)      proposed tokens
    generator: torch.Generator,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched distribution-preserving speculative acceptance (Leviathan
    et al. 2023), on the tensors' device with no host read.

    Per slot: accept draft token j while u_j * q(d_j) < p(d_j); at the
    first rejection draw the correction from the normalized residual
    max(p - q, 0) (p itself where the residual has no mass); when all g
    are accepted draw the bonus from the target's row g. Every emitted
    token is marginally distributed as the target's filtered distribution.

    Returns (a (B,) int32 accepted counts, emit (B, g+1) in ``draft``'s
    dtype): emit[b, :a[b]] are the accepted draft tokens and emit[b, a[b]]
    the correction or bonus; the engine emits emit[b, :a[b]+1]."""
    b, g = draft.shape
    idx = draft.long()[..., None]
    p_tok = p_dist[:, :g].gather(-1, idx)[..., 0]
    q_tok = q_dist.gather(-1, idx)[..., 0]
    u = torch.rand((b, g), generator=generator, device=p_dist.device)
    accept = u * torch.clamp(q_tok, min=1e-30) < p_tok
    a = torch.cumprod(accept.long(), dim=1).sum(dim=1)
    rows = torch.arange(b, device=p_dist.device)
    pa = p_dist[rows, a]
    qa = q_dist[rows, torch.clamp(a, max=g - 1)]
    res = torch.clamp(pa - qa, min=0.0)
    s = res.sum(dim=-1, keepdim=True)
    res = torch.where(s > 0, res / torch.clamp(s, min=1e-30), pa)
    dist = torch.where((a == g)[:, None], pa, res)  # a == g: the bonus row
    corr = torch.multinomial(dist, 1, generator=generator)[:, 0]
    emit = torch.cat([draft, torch.zeros_like(draft[:, :1])], dim=1)
    emit[rows, a] = corr.to(draft.dtype)
    return a.to(torch.int32), emit
