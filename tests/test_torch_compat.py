"""The port's reference-checkpoint migration (``flashattention_tpu_torch/
models/compat.py``) against the JAX package's, on the CPU in float32.

Seeded state dicts in the reference ``Transformer``'s layout (fused and
separate QKV, with and without biases, spare projections present) go
through both converters; logits and ``reference_lm_loss`` agree at 1e-4
(the JAX ladder) at tau 1.0 and 0.8. The JAX side runs jitted: its Pallas
flash kernel in interpret mode (as its own tests run it on the CPU) for
the reference's default layout, its tiled executor for the others.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_tpu.models import compat as jcompat
from flashattention_tpu_torch.models import compat
from flashattention_tpu_torch.ops import flash_attn as fa
from flashattention_tpu_torch.utils.testing import (
    assert_allclose,
    reference_state_dict,
)

TOL = 1e-4
SIZE = dict(vocab=97, d_model=32, n_layers=2, max_len=64)
HEADS = 4


def _ids(seed, b=2, n=24, vocab=97):
    return np.random.default_rng(seed).integers(0, vocab, (b, n))


def _jax_logits_and_loss(jparams, ids, targets, tau, backend):
    """JAX's apply_reference_transformer and reference_lm_loss, jitted
    together."""
    def both(p, i, t):
        return (jcompat.apply_reference_transformer(p, i, tau=tau,
                                                    backend=backend),
                jcompat.reference_lm_loss(p, i, t, tau=tau, backend=backend))

    logits, loss = jax.jit(both)(jparams, jnp.asarray(ids, jnp.int32),
                                 jnp.asarray(targets, jnp.int32))
    return np.asarray(logits), float(loss)


# (fused, bias, spare, JAX backend): the Pallas kernel in interpret mode for
# the reference's default layout, JAX's tiled executor for the others
CASES = [(True, True, True, "pallas"), (True, False, True, "xla"),
         (False, True, False, "xla"), (False, False, False, "xla"),
         (True, True, False, "xla")]


@pytest.mark.parametrize("tau", [1.0, 0.8])
@pytest.mark.parametrize("fused,bias,spare,backend", CASES)
def test_logits_and_loss_match_jax(fused, bias, spare, backend, tau):
    sd = reference_state_dict(**SIZE, fused=fused, bias=bias, spare=spare,
                              seed=7)
    ids, targets = _ids(3), _ids(5)
    params = compat.convert_reference_state_dict(sd, HEADS, device="cpu")
    jparams = jcompat.convert_reference_state_dict(sd, HEADS)
    want, jloss = _jax_logits_and_loss(jparams, ids, targets, tau, backend)
    logits = compat.apply_reference_transformer(
        params, torch.from_numpy(ids), tau=tau)
    assert logits.shape == (2, 24, SIZE["vocab"])
    assert_allclose(logits, want, rtol=TOL, atol=TOL)
    loss = compat.reference_lm_loss(params, torch.from_numpy(ids),
                                    torch.from_numpy(targets), tau=tau)
    assert math.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), jloss, rtol=TOL, atol=TOL)


def test_ffn_block_is_non_causal_and_ignores_tau():
    """Two flash calls a layer: causal at tau / sqrt(dh), then the "ffn"
    block non-causal at 1 / sqrt(dh)."""
    sd = reference_state_dict(**SIZE, seed=1)
    params = compat.convert_reference_state_dict(sd, HEADS, device="cpu")
    seen = []
    real = fa.kernel_attention

    def spy(q, k, v, **kw):
        seen.append((kw["causal"], kw["softmax_scale"]))
        return real(q, k, v, **kw)

    import flashattention_tpu_torch.ops.api as api
    orig = api.kernel_attention
    api.kernel_attention = spy
    try:
        compat.apply_reference_transformer(params, torch.from_numpy(_ids(2)),
                                           tau=0.5)
    finally:
        api.kernel_attention = orig
    dh = SIZE["d_model"] // HEADS
    assert seen == [(True, 0.5 / math.sqrt(dh)),
                    (False, 1.0 / math.sqrt(dh))] * SIZE["n_layers"]


def test_spare_projections_are_ignored():
    sd = reference_state_dict(**SIZE, fused=True, spare=True, seed=4)
    bare = {k: v for k, v in sd.items()
            if not any(f"attn.w_{n}." in k for n in "qkv")}
    ids = torch.from_numpy(_ids(6))
    a, b = (compat.apply_reference_transformer(
        compat.convert_reference_state_dict(s, HEADS, device="cpu"), ids)
        for s in (sd, bare))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_convert_validates_and_infers():
    sd = reference_state_dict(**SIZE, seed=0)
    with pytest.raises(ValueError, match="divisible"):
        compat.convert_reference_state_dict(sd, num_heads=5, device="cpu")
    params = compat.convert_reference_state_dict(sd, HEADS, device="cpu")
    cfg = params["config"]
    assert cfg == compat.RefConfig(num_heads=HEADS, d_model=32, vocab_size=97,
                                   max_len=64, n_layers=2)
    assert all(t.dtype == torch.float32 for t in (params["tok_emb"],
                                                  params["lm_head"]))
    too_long = torch.zeros((1, cfg.max_len + 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="max_len"):
        compat.apply_reference_transformer(params, too_long)
    # n == max_len is the longest input
    out = compat.apply_reference_transformer(params, too_long[:, :-1])
    assert out.shape == (1, cfg.max_len, cfg.vocab_size)


def test_bias_free_equals_zero_bias():
    """A bias-free checkpoint converts without "b" and runs like one whose
    biases are zero."""
    free = reference_state_dict(**SIZE, bias=False, seed=2)
    zero = dict(free)
    for k in list(free):
        if k.endswith(".weight") and (".attn." in k or ".ffn." in k):
            zero[k[:-len("weight")] + "bias"] = torch.zeros(free[k].shape[0])
    pf = compat.convert_reference_state_dict(free, HEADS, device="cpu")
    assert "b" not in pf["layers"][0]["attn"]["qkv"]
    ids = torch.from_numpy(_ids(8))
    a = compat.apply_reference_transformer(pf, ids)
    b = compat.apply_reference_transformer(
        compat.convert_reference_state_dict(zero, HEADS, device="cpu"), ids)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_converter_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compat.convert_reference_state_dict(
            reference_state_dict(**SIZE, seed=0), HEADS)
