"""The port's dense speculative generation against the JAX package's.

``speculative_generate`` and ``generate`` run on the port's
``init_kv_cache`` / ``decode_chunk`` (float32, CPU) with the JAX parameter
trees loaded by ``params_from_jax``; greedy tokens must equal the JAX
functions' (``tests/test_speculative.py`` sets the configurations).
Stochastic draws come from a ``torch.Generator``: they are checked for the
acceptance identity, validity and seeding, not draw by draw.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
)
from flashattention_tpu.models.transformer import init_transformer
from flashattention_tpu.serving import speculative as jax_spec
from flashattention_tpu_torch.models.transformer import (
    TransformerConfig,
    decode_chunk,
    init_kv_cache,
    params_from_jax,
)
from flashattention_tpu_torch.serving import (
    SamplingConfig,
    SpecStats,
    generate,
    speculative_generate,
)
from flashattention_tpu_torch.serving import speculative as port_spec

TARGET = JaxConfig(
    vocab_size=61, d_model=64, n_layers=2, n_heads=4, d_ff=128,
    max_seq_len=64, block_size=32, dropout_rate=0.0, dtype=jnp.float32,
    attention_backend="xla",
)
DRAFT = dataclasses.replace(TARGET, d_model=32, n_layers=1, n_heads=2,
                            d_ff=64)


def port_config(cfg):
    kw = {f.name: getattr(cfg, f.name)
          for f in dataclasses.fields(TransformerConfig)}
    return TransformerConfig(**dict(kw, dtype=torch.float32,
                                    param_dtype=torch.float32))


@pytest.fixture(scope="module")
def models():
    """(JAX target, JAX draft, port target, port draft) parameters."""
    jt = init_transformer(jax.random.key(0), TARGET)
    jd = init_transformer(jax.random.key(7), DRAFT)
    pt, pd = (params_from_jax(jax.tree.map(np.asarray, p), port_config(c),
                              device="cpu")
              for p, c in ((jt, TARGET), (jd, DRAFT)))
    return jt, jd, pt, pd


PT, PD = port_config(TARGET), port_config(DRAFT)


@pytest.mark.parametrize("gamma", [1, 3, 5])
def test_greedy_matches_jax(models, gamma):
    """Greedy speculative tokens equal JAX's speculative and plain
    generation, for a draft that often disagrees."""
    jt, jd, pt, pd = models
    prompt = [3, 17, 42, 9]
    want = jax_spec.generate(jt, TARGET, prompt, max_new_tokens=20)
    want_spec, jstats = jax_spec.speculative_generate(
        jt, jd, TARGET, DRAFT, prompt, max_new_tokens=20, gamma=gamma)
    got, stats = speculative_generate(pt, pd, PT, PD, prompt,
                                      max_new_tokens=20, gamma=gamma)
    assert got == want == want_spec
    assert isinstance(stats, SpecStats)
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    assert generate(pt, PT, prompt, max_new_tokens=20) == want


def test_draft_equals_target_accepts_everything_greedy(models):
    _, _, pt, _ = models
    got, stats = speculative_generate(pt, pt, PT, PT, [5, 11],
                                      max_new_tokens=16, gamma=4)
    assert stats.accepted == stats.proposed > 0
    assert got == generate(pt, PT, [5, 11], max_new_tokens=16)
    assert stats.tokens_per_target_pass > 4.0


def test_draft_equals_target_accepts_everything_stochastic(models):
    """p_t / p_d == 1 at every proposal of a self-draft: the acceptance test
    takes every one (the filtered distributions, not raw logits)."""
    _, _, pt, _ = models
    cfg = SamplingConfig(temperature=0.9, top_k=20, top_p=0.95)
    out, stats = speculative_generate(
        pt, pt, PT, PT, [5, 11], max_new_tokens=16, gamma=4, sampling=cfg,
        generator=torch.Generator().manual_seed(3))
    assert len(out) == 16
    assert stats.proposed > 0 and stats.accepted == stats.proposed


def test_stochastic_is_valid_and_seeded(models):
    _, _, pt, pd = models
    cfg = SamplingConfig(temperature=1.0)

    def run(seed):
        return speculative_generate(
            pt, pd, PT, PD, [2, 4, 8], max_new_tokens=12, gamma=3,
            sampling=cfg, generator=torch.Generator().manual_seed(seed))

    (out, stats), (again, _), (other, _) = run(5), run(5), run(6)
    assert len(out) == 12 and all(0 <= t < TARGET.vocab_size for t in out)
    assert 0 <= stats.accepted <= stats.proposed
    assert stats.emitted >= len(out)
    assert out == again and out != other
    plain = generate(pt, PT, [2, 4, 8], max_new_tokens=12, sampling=cfg,
                     generator=torch.Generator().manual_seed(5))
    assert len(plain) == 12


def test_max_len_edge_matches_jax(models):
    """Generation ends cleanly at the cache limit: the no-headroom path
    advances token by token, as JAX's does."""
    jt, jd, pt, pd = models
    prompt = list(range(1, TARGET.max_seq_len - 4))
    got, stats = speculative_generate(pt, pd, PT, PD, prompt,
                                      max_new_tokens=32, gamma=4)
    want, jstats = jax_spec.speculative_generate(
        jt, jd, TARGET, DRAFT, prompt, max_new_tokens=32, gamma=4)
    assert got == want
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    assert len(prompt) + len(got) <= TARGET.max_seq_len + 1
    full = generate(pt, PT, prompt, max_new_tokens=32)
    assert got == full[: len(got)]
    assert full == jax_spec.generate(jt, TARGET, prompt, max_new_tokens=32)


def test_peek_chunk_leaves_the_cache(models):
    """The residual's read-only probe restores what it wrote."""
    _, _, _, pd = models
    caches = init_kv_cache(PD, 1, 16, device="cpu")
    decode_chunk(pd, caches, torch.tensor([[1, 2, 3, 4]]), 0, PD)
    before = [(c["k"].clone(), c["v"].clone()) for c in caches]
    logits = port_spec._peek_chunk(pd, caches, torch.tensor([[9]]), 4, PD)
    assert logits.shape == (1, 1, DRAFT.vocab_size)
    for c, (k, v) in zip(caches, before):
        assert torch.equal(c["k"], k) and torch.equal(c["v"], v)


@pytest.mark.parametrize("case", ["gamma", "generator", "empty", "vocab"])
def test_validation_errors(models, case):
    _, _, pt, pd = models
    kw, match = {
        "gamma": (dict(gamma=0), "gamma"),
        "generator": (dict(sampling=SamplingConfig(temperature=1.0)),
                      "Generator"),
        "empty": (dict(prompt=[]), "non-empty"),
        "vocab": (dict(draft_cfg=dataclasses.replace(PD, vocab_size=62)),
                  "vocabulary"),
    }[case]
    args = dict(target_params=pt, draft_params=pd, target_cfg=PT,
                draft_cfg=PD, prompt=[1], max_new_tokens=4)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        speculative_generate(**args)
    if case == "generator":
        with pytest.raises(ValueError, match="Generator"):
            generate(pt, PT, [1], max_new_tokens=2,
                     sampling=SamplingConfig(temperature=1.0))
