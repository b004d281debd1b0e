"""The PyTorch port's sampling filters against the JAX package's.

``filter_logits`` is deterministic, so the same numpy logits must give the
same filtered logits (float32). Draws use a ``torch.Generator`` and cannot
reproduce JAX's PRNG: they are checked for determinism under a seed and for
never leaving the filtered support. The speculative acceptance test
``spec_accept_emit`` is held, as ``tests/test_sampling.py`` holds JAX's, to
the target's distribution."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_tpu.serving.sampling import SamplingConfig as JaxSampling
from flashattention_tpu.serving.sampling import filter_logits as jax_filter
from flashattention_tpu_torch.serving.sampling import (
    SamplingConfig,
    filter_logits,
    sample_logits,
    spec_accept_emit,
)

SETTINGS = [(0.7, 0, 1.0), (1.0, 5, 1.0), (1.3, 0, 0.8), (0.9, 7, 0.6)]


@pytest.mark.parametrize("temperature,top_k,top_p", SETTINGS)
def test_filter_logits_matches_jax(temperature, top_k, top_p):
    logits = np.random.default_rng(0).standard_normal((3, 41)).astype(np.float32)
    ref = jax_filter(jnp.asarray(logits),
                     JaxSampling(temperature, top_k, top_p))
    out = filter_logits(torch.from_numpy(logits),
                        SamplingConfig(temperature, top_k, top_p))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_sample_logits_stays_in_support_and_is_seeded():
    logits = torch.from_numpy(
        np.random.default_rng(1).standard_normal((64, 50)).astype(np.float32))
    cfg = SamplingConfig(temperature=1.0, top_k=4)
    a = sample_logits(logits, torch.Generator().manual_seed(3), cfg)
    b = sample_logits(logits, torch.Generator().manual_seed(3), cfg)
    assert torch.equal(a, b)
    top4 = torch.topk(logits, 4, dim=-1).indices
    assert (top4 == a[:, None]).any(dim=-1).all()
    greedy = sample_logits(logits, None, SamplingConfig())
    assert torch.equal(greedy, logits.argmax(-1))
    with pytest.raises(ValueError):
        sample_logits(logits, None, cfg)


def test_spec_accept_emit_preserves_target():
    """The first emitted token of a round is marginally the target's
    distribution whatever the draft: draft ~ q, accept with p/q, else the
    normalized residual. n = 40 000 rounds at V = 8 in one batch; binomial
    sigma <= 0.5/sqrt(n) ~ 0.0025, gated at 5 sigma."""
    v, g, n = 8, 2, 40_000
    rng = np.random.default_rng(0)
    p = torch.from_numpy(rng.dirichlet(np.ones(v), size=g + 1).astype(np.float32))
    q = torch.from_numpy(rng.dirichlet(np.ones(v), size=g).astype(np.float32))
    gen = torch.Generator().manual_seed(1)
    draft = torch.multinomial(q, n, replacement=True, generator=gen).T  # (n, g)
    _, emit = spec_accept_emit(p.expand(n, -1, -1), q.expand(n, -1, -1),
                               draft, gen)
    emp = np.bincount(emit[:, 0].numpy(), minlength=v) / n
    np.testing.assert_allclose(emp, p[0].numpy(), atol=0.0125)


def test_spec_accept_emit_self_draft_accepts_all():
    """q == p rows: every proposal is accepted, the draft passes through and
    the bonus comes from the target's last row."""
    v, g, b = 8, 3, 4
    rng = np.random.default_rng(2)
    p = torch.from_numpy(rng.dirichlet(np.ones(v), size=(b, g + 1))
                         .astype(np.float32))
    draft = torch.from_numpy(rng.integers(0, v, size=(b, g)))
    a, emit = spec_accept_emit(p, p[:, :g], draft,
                               torch.Generator().manual_seed(3))
    assert torch.equal(a, torch.full((b,), g, dtype=torch.int32))
    assert torch.equal(emit[:, :g], draft)
    assert ((emit[:, g] >= 0) & (emit[:, g] < v)).all()


def test_spec_accept_emit_shapes_and_dtypes():
    """(a (B,) int32, emit (B, g+1) in the draft's dtype); a disjoint draft
    (q puts all mass where p has none) is rejected at once and corrected
    from p's support."""
    b, g, v = 5, 3, 6
    p = torch.zeros(b, g + 1, v)
    p[..., :3] = 1 / 3
    q = torch.zeros(b, g, v)
    q[..., 3:] = 1 / 3
    draft = torch.full((b, g), 4, dtype=torch.int64)
    a, emit = spec_accept_emit(p, q, draft, torch.Generator().manual_seed(0))
    assert a.shape == (b,) and a.dtype == torch.int32
    assert emit.shape == (b, g + 1) and emit.dtype == draft.dtype
    assert not a.any() and (emit[:, 0] < 3).all()
    assert torch.equal(emit[:, 1:g], draft[:, 1:])
