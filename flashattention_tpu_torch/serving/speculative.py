"""Draft-model speculative decoding on the dense KV-cache decode path.

The counterpart of ``flashattention_tpu/serving/speculative.py``: a small
draft model proposes ``gamma`` tokens autoregressively; the target model
scores all of them in one chunked forward
(``models.transformer.decode_chunk``); accepted prefixes advance several
tokens per target pass. Single sequence by design: speculative decoding
here targets latency, the continuous-batching engine (``serving/engine.py``,
whose speculative tick runs over the paged cache) throughput.

Guarantees:

- Greedy mode emits exactly the target model's greedy continuation.
- Stochastic mode accepts d_j with probability min(1, p_t(d_j)/p_d(d_j))
  over the temperature/top-k/top-p-filtered distributions and on rejection
  samples the normalized residual max(p_t - p_d, 0): the emitted tokens are
  distributed as the target's sampling. Draws come from a
  ``torch.Generator`` in place of the JAX package's PRNG key, so the two
  agree in distribution, not draw by draw.

Cache rollback is free: both caches mask attention at
``cols <= rows + cache_index``, so entries past the accepted prefix are
invisible and overwritten by the next chunk. The draft runs gamma + 1 steps
(the last feeds d_gamma, its sample discarded) so its cache covers the
longest prefix the target can accept.
"""

from __future__ import annotations

import dataclasses

import torch

from flashattention_tpu_torch.models.transformer import (
    TransformerConfig,
    decode_chunk,
    init_kv_cache,
)
from flashattention_tpu_torch.serving.sampling import (
    SamplingConfig,
    filter_logits,
)

__all__ = ["SpecStats", "speculative_generate", "generate"]


@dataclasses.dataclass
class SpecStats:
    rounds: int = 0
    proposed: int = 0
    accepted: int = 0
    emitted: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(self.proposed, 1)

    @property
    def tokens_per_target_pass(self) -> float:
        return self.emitted / max(self.rounds, 1)


def _feed(tokens, device) -> torch.Tensor:
    return torch.tensor([list(tokens)], dtype=torch.int64, device=device)


def _sample(row, sampling, generator) -> int:
    """One token from a (V,) logits row: argmax, or a draw from its filtered
    distribution."""
    if sampling is None or sampling.greedy:
        return int(torch.argmax(row))
    probs = torch.softmax(filter_logits(row, sampling), dim=-1)
    return int(torch.multinomial(probs, 1, generator=generator))


def _propose(params, caches, t0: int, pos0: int, generator, *, g: int,
             cfg: TransformerConfig, sampling):
    """Draft g tokens from position pos0 (t0 = the last accepted token, fed
    at pos0), each feeding the next on the device. Runs g + 1 steps so d_g's
    K/V land in the cache too. Returns (tokens (g,), probabilities (g,) of
    the drawn tokens under the filtered draft distribution, ones when
    greedy)."""
    greedy = sampling is None or sampling.greedy
    tok = _feed([t0], params.tok_emb.device)
    toks, probs = [], []
    for i in range(g + 1):
        logits, _ = decode_chunk(params, caches, tok, pos0 + i, cfg)
        if i == g:
            break  # this step only writes d_g's K/V
        row = logits[0, -1]
        if greedy:
            nxt = torch.argmax(row)
            prob = torch.ones((), device=row.device)
        else:
            dist = torch.softmax(filter_logits(row, sampling), dim=-1)
            nxt = torch.multinomial(dist, 1, generator=generator)[0]
            prob = dist[nxt]
        toks.append(nxt)
        probs.append(prob)
        tok = nxt.reshape(1, 1)
    return torch.stack(toks), torch.stack(probs)


def _peek_chunk(params, caches, tokens, cache_index: int, cfg):
    """``decode_chunk`` that leaves the caches as they were: a read-only
    logits probe (the positions it writes are saved and restored)."""
    n = tokens.shape[1]
    saved = [(c["k"][:, :, cache_index:cache_index + n].clone(),
              c["v"][:, :, cache_index:cache_index + n].clone())
             for c in caches]
    try:
        logits, _ = decode_chunk(params, caches, tokens, cache_index, cfg)
    finally:
        for c, (k, v) in zip(caches, saved):
            c["k"][:, :, cache_index:cache_index + n] = k
            c["v"][:, :, cache_index:cache_index + n] = v
    return logits


def _sync_draft(draft_params, caches_d, token: int, pos: int, cfg_d):
    """Append one token to the draft cache without sampling (the path taken
    when there is no room to speculate)."""
    decode_chunk(draft_params, caches_d,
                 _feed([token], draft_params.tok_emb.device), pos, cfg_d)


def speculative_generate(
    target_params,
    draft_params,
    target_cfg: TransformerConfig,
    draft_cfg: TransformerConfig,
    prompt,
    *,
    max_new_tokens: int,
    gamma: int = 4,
    sampling: SamplingConfig | None = None,
    generator: torch.Generator | None = None,
) -> tuple[list[int], SpecStats]:
    """Generate ``max_new_tokens`` continuations of ``prompt`` (list[int])
    on the device of the target's parameters.

    Greedy (sampling None / temperature 0) reproduces the target model's
    greedy continuation exactly; stochastic preserves the target's filtered
    sampling distribution by rejection sampling, drawing from
    ``generator`` (on the parameters' device).
    """
    if target_cfg.vocab_size != draft_cfg.vocab_size:
        raise ValueError("target and draft must share a vocabulary")
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    stochastic = sampling is not None and not sampling.greedy
    if stochastic and generator is None:
        raise ValueError("stochastic speculative decoding needs a "
                         "torch.Generator")

    seq = [int(t) for t in prompt]
    if not seq:
        raise ValueError("prompt must be non-empty")
    max_len = min(target_cfg.max_seq_len, draft_cfg.max_seq_len)
    if len(seq) > max_len:
        raise ValueError(f"prompt length {len(seq)} exceeds max_len {max_len}")
    dev_t, dev_d = target_params.tok_emb.device, draft_params.tok_emb.device
    caches_t = init_kv_cache(target_cfg, 1, max_len, device=dev_t)
    caches_d = init_kv_cache(draft_cfg, 1, max_len, device=dev_d)

    # Prefill both caches with seq[:-1]; each round feeds seq[-1] again as
    # the first chunk row, whose logits verify the first draft token.
    if len(seq) > 1:
        decode_chunk(target_params, caches_t, _feed(seq[:-1], dev_t), 0,
                     target_cfg)
        decode_chunk(draft_params, caches_d, _feed(seq[:-1], dev_d), 0,
                     draft_cfg)

    out: list[int] = []
    stats = SpecStats()

    while len(out) < max_new_tokens:
        m = len(seq)
        # The chunk needs rows m-1 .. m+g-1; the draft writes one further.
        g = min(gamma, max_new_tokens - len(out), max_len - m - 1)
        if g < 1:
            # No head-room to speculate (near max_len, or one token left):
            # plain target decode for the remainder.
            logits, _ = decode_chunk(target_params, caches_t,
                                     _feed([seq[-1]], dev_t), m - 1,
                                     target_cfg)
            tok = _sample(logits[0, -1], sampling, generator)
            _sync_draft(draft_params, caches_d, seq[-1], m - 1, draft_cfg)
            out.append(tok)
            seq.append(tok)
            stats.rounds += 1
            stats.emitted += 1
            if len(seq) > max_len:  # the next feed position would be max_len
                break
            continue

        d_toks, d_probs = _propose(draft_params, caches_d, seq[-1], m - 1,
                                   generator, g=g, cfg=draft_cfg,
                                   sampling=sampling)
        drafts = [int(t) for t in d_toks.cpu()]
        logits, _ = decode_chunk(target_params, caches_t,
                                 _feed([seq[-1], *drafts], dev_t), m - 1,
                                 target_cfg)  # (1, g+1, V); row j: m + j

        if not stochastic:
            t_hat = torch.argmax(logits[0], dim=-1).tolist()  # (g+1,)
            a = 0
            while a < g and t_hat[a] == drafts[a]:
                a += 1
            emitted = drafts[:a] + [t_hat[a]]  # correction (a < g) or bonus
        else:
            p_t = torch.softmax(filter_logits(logits[0], sampling), dim=-1)
            p_d = d_probs.tolist()
            us = torch.rand((g,), generator=generator,
                            device=generator.device).tolist()
            p_tok = p_t[torch.arange(g, device=p_t.device),
                        torch.tensor(drafts, device=p_t.device)].tolist()
            a = 0
            while a < g and us[a] < min(1.0, p_tok[a] / max(p_d[a], 1e-30)):
                a += 1
            emitted = drafts[:a]
            if a == g:  # all accepted: the bonus from the target's last row
                dist = p_t[g]
            else:
                dist = _residual(draft_params, caches_d, seq, emitted, a,
                                 p_t[a], draft_cfg, sampling)
            emitted.append(int(torch.multinomial(dist, 1,
                                                 generator=generator)))

        out.extend(emitted)
        seq.extend(emitted)
        stats.rounds += 1
        stats.proposed += g
        stats.accepted += a
        stats.emitted += len(emitted)

    return out[:max_new_tokens], stats


def _residual(draft_params, caches_d, seq, emitted, a, p_t_row, cfg_d,
              sampling):
    """max(p_t - p_d, 0) normalized at the first rejected position.

    The draft's filtered distribution there is recomputed by a read-only
    one-token forward: the draft cache already holds every token before it
    (the proposal wrote through the whole chunk). p_t itself where the
    residual has no mass (draft row equal to the target row)."""
    pos = len(seq) - 1 + a  # absolute position of the rejected token
    prev = ([seq[-1], *emitted])[a]  # chunk row a's input
    logits = _peek_chunk(draft_params, caches_d,
                         _feed([prev], draft_params.tok_emb.device), pos,
                         cfg_d)
    p_d_row = torch.softmax(filter_logits(logits[0, -1], sampling), dim=-1)
    res = torch.clamp(p_t_row - p_d_row.to(p_t_row.device), min=0.0)
    s = res.sum()
    if s <= 0:
        return p_t_row
    return res / s


def generate(
    params,
    cfg: TransformerConfig,
    prompt,
    *,
    max_new_tokens: int,
    sampling: SamplingConfig | None = None,
    generator: torch.Generator | None = None,
) -> list[int]:
    """Plain autoregressive decode on the same path (one target pass per
    token), on the parameters' device: the reference output of the
    speculative tests and a convenience API."""
    stochastic = sampling is not None and not sampling.greedy
    if stochastic and generator is None:
        raise ValueError("stochastic generation needs a torch.Generator")
    seq = [int(t) for t in prompt]
    dev = params.tok_emb.device
    caches = init_kv_cache(cfg, 1, cfg.max_seq_len, device=dev)
    if len(seq) > 1:
        decode_chunk(params, caches, _feed(seq[:-1], dev), 0, cfg)
    out: list[int] = []
    # len(seq) == max_seq_len still decodes: feeding seq[-1] writes the last
    # cache slot and gives the distribution of position max_seq_len (that
    # token cannot be fed back), as speculative_generate's fallback does.
    while len(out) < max_new_tokens and len(seq) <= cfg.max_seq_len:
        logits, _ = decode_chunk(params, caches, _feed([seq[-1]], dev),
                                 len(seq) - 1, cfg)
        tok = _sample(logits[0, -1], sampling, generator)
        out.append(tok)
        seq.append(tok)
    return out
