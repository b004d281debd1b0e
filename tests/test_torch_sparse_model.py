"""The port's model with a block-sparse pattern against the JAX package's,
on the CPU in float32 at a tiny width (head dims 16, 256 and 512;
block_size 16, N = 64: 4 x 4 tiles;
block_size 32: 2 x 2, and 20 x 20 at N = 640 with a width-16 pattern),
weights carried across by ``params_from_jax``: logits, loss and gradients,
the soft-capped dense-mask fallback, dropout with a pattern, both remat
policies, and the errors of a pattern with a window or segment ids.

Tolerance: fp32 1e-4 (the JAX ladder). The JAX side reaches
``pallas_sparse_attention`` in interpret mode, as its own tests run it.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_tpu.models.transformer import TransformerConfig as JaxConfig
from flashattention_tpu.models.transformer import (
    apply_transformer as jax_apply,
)
from flashattention_tpu.models.transformer import init_transformer
from flashattention_tpu_torch.models import transformer as tt
from flashattention_tpu_torch.models.train import token_nll
from flashattention_tpu_torch.models.transformer import (
    TransformerConfig,
    apply_transformer,
    block_sparse_mask,
    init_params,
    params_from_jax,
)
from flashattention_tpu_torch.ops import sparse_attention
from flashattention_tpu_torch.ops.tiled import tiled_attention
from flashattention_tpu_torch.utils.testing import assert_allclose

TOL = 1e-4
N = 64
BASE = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, d_ff=128,
            max_seq_len=64, block_size=16, dropout_rate=0.0)
D256 = dict(d_model=512, n_heads=2, n_kv_heads=1, pos_encoding="rope")
D512 = dict(d_model=1024, n_heads=2, n_kv_heads=1, pos_encoding="rope")
# name: (config overrides, pattern); patterns are normalized onto 4 x 4 tiles
CASES = {
    "learned": ({}, [[1, 0], [0, 1]]),
    "rope_3x3": (dict(pos_encoding="rope"), [[1, 0, 0], [1, 1, 0], [0, 1, 1]]),
    "gqa_empty_rows": (dict(n_kv_heads=2), [[0, 0], [1, 1]]),
    "softcap_fallback": (dict(attn_softcap=3.0), [[1, 0], [1, 1]]),
    # head dim 256 (the D-split sparse kernels on the card), one KV head
    "d256_mqa_rope": (dict(D256), [[1, 0], [1, 1]]),
    # blocks of 32 (the mma kernels on the card, bf16 and fp32): 2 x 2 tiles
    "block32": (dict(block_size=32), [[1, 0], [1, 1]]),
    # head dim 512 (the wide sparse kernels on the card), one KV head
    "d512_mqa_rope": (dict(D512), [[1, 0], [1, 1]]),
}


def jax_config(**kw) -> JaxConfig:
    return JaxConfig(**{**BASE, **kw}, dtype=jnp.float32)


def port_config(cfg: JaxConfig, **kw) -> TransformerConfig:
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(TransformerConfig)}
    fields.update(dtype=torch.float32, param_dtype=torch.float32, **kw)
    return TransformerConfig(**fields)


def port_params(jparams, pcfg):
    return params_from_jax(jax.tree.map(np.asarray, jparams), pcfg,
                           device="cpu")


def tokens(b, n, vocab, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, n))


def flat_named(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat_named(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flat_named(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = np.asarray(tree, np.float32)
    return out


def _pattern(p):
    return np.asarray(p, bool)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sparse_logits_match_jax(case):
    over, pattern = CASES[case]
    jcfg = jax_config(**over)
    jp = init_transformer(jax.random.key(0), jcfg)
    pcfg = port_config(jcfg)
    toks = tokens(2, N, jcfg.vocab_size)
    ref = jax_apply(jp, jnp.asarray(toks, jnp.int32), jcfg,
                    sparse_pattern=jnp.asarray(_pattern(pattern)))
    launched = []
    with mock.patch.object(tt, "sparse_attention",
                           lambda *a, **k: launched.append(1)
                           or sparse_attention(*a, **k)):
        out = apply_transformer(port_params(jp, pcfg), torch.from_numpy(toks),
                                pcfg, sparse_pattern=torch.from_numpy(
                                    _pattern(pattern)))
    # the soft-capped config takes the dense-mask fallback, the others the
    # sparse route once per layer
    assert len(launched) == (0 if "softcap" in case else jcfg.n_layers)
    assert out.shape == (2, N, jcfg.vocab_size)
    assert_allclose(out, np.asarray(ref), rtol=TOL, atol=TOL, err_msg=case)


def _jax_loss(jcfg, toks, pattern):
    def loss(p):
        logits = jax_apply(p, jnp.asarray(toks[:, :-1], jnp.int32), jcfg,
                           sparse_pattern=jnp.asarray(pattern))
        logp = jax.nn.log_softmax(logits, axis=-1)
        tgt = jnp.asarray(toks[:, 1:], jnp.int32)[..., None]
        return -jnp.take_along_axis(logp, tgt, axis=-1).mean()
    return loss


def _port_loss(params, cfg, toks, pattern, **kw):
    t = torch.from_numpy(toks)
    logits = apply_transformer(params, t[:, :-1], cfg,
                               sparse_pattern=torch.from_numpy(pattern), **kw)
    return token_nll(logits, t[:, 1:]).mean()


# chip_smoke.py phase 7g's pattern (the fp32 mma kernels on the card) at a
# tiny width: local + global at width 16 on 20 x 20 tiles of 32 (N = 640),
# so the last q tiles skip some of the tiles between tile 0 and their window
LG20 = [[int(0 <= i - j < 16 or j == 0) for j in range(20)] for i in range(20)]


@pytest.mark.parametrize("case", ["learned", "gqa_rope", "d256_mqa_rope",
                                  "d512_mqa_rope", "block32_gqa",
                                  "block32_width16"])
def test_sparse_loss_and_grads_match_jax(case):
    over = {"learned": {}, "gqa_rope": dict(n_kv_heads=2, pos_encoding="rope"),
            "d256_mqa_rope": D256, "d512_mqa_rope": D512,
            "block32_gqa": dict(n_kv_heads=2, block_size=32),
            "block32_width16": dict(block_size=32, max_seq_len=640)}[case]
    n = 640 if case == "block32_width16" else N
    pattern = _pattern(LG20 if case == "block32_width16" else
                       [[1, 0, 0, 0], [1, 1, 0, 0], [0, 1, 1, 0], [1, 0, 1, 1]])
    jcfg = jax_config(**over)
    jp = init_transformer(jax.random.key(1), jcfg)
    toks = tokens(2, n + 1, jcfg.vocab_size)
    loss, grads = jax.value_and_grad(_jax_loss(jcfg, toks, pattern))(jp)
    params = port_params(jp, port_config(jcfg))
    tloss = _port_loss(params, port_config(jcfg), toks, pattern)
    tloss.backward()
    assert_allclose(tloss, np.asarray(loss), rtol=TOL, atol=TOL)
    ref = flat_named(grads)
    got = {n: p.grad for n, p in params.named_parameters()}
    assert set(got) == set(ref)
    for name, g in got.items():
        assert_allclose(g, ref[name], rtol=TOL, atol=TOL, err_msg=name)


def test_softcap_all_ones_pattern_equals_capped_dense():
    """JAX's test_sparse_pattern_with_softcap_matches_dense: a capped config
    routes a pattern to the dense-mask fallback, so an all-ones pattern
    gives the capped dense forward."""
    cfg = port_config(jax_config(attn_softcap=10.0))
    params = init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(tokens(1, N, cfg.vocab_size, seed=1))
    sparse = apply_transformer(params, toks, cfg,
                               sparse_pattern=torch.ones(4, 4, dtype=torch.bool))
    dense = apply_transformer(params, toks, cfg)
    assert_allclose(sparse, dense, rtol=2e-4, atol=2e-4)


def test_dropout_with_pattern_is_the_tiled_executor_with_the_mask():
    """Train with attention dropout and a pattern: the model calls the
    tiled executor with the pattern expanded to elements and the site's
    seed, never the sparse kernels (jax.random dropout cannot be replayed,
    so the reference is the port's own executor)."""
    cfg = port_config(jax_config(dropout_rate=0.1), remat=False)
    params = init_params(cfg, seed=2, device="cpu")
    toks = torch.from_numpy(tokens(2, N, cfg.vocab_size, seed=4))
    pattern = torch.tensor([[1, 0], [1, 1]], dtype=torch.bool)
    tile4 = pattern.repeat_interleave(2, 0).repeat_interleave(2, 1)
    want_mask = block_sparse_mask(N, N, cfg.block_size, tile4)

    def direct(q, k, v, *, mask, dropout_rate, dropout_seed, **_):
        assert torch.equal(mask, want_mask) and dropout_rate == 0.1
        return tiled_attention(q, k, v, causal=True,
                               softmax_scale=cfg.softmax_scale,
                               block_k=cfg.block_size, mask=mask,
                               dropout_rate=dropout_rate,
                               dropout_seed=dropout_seed)

    def no_sparse(*a, **k):
        raise AssertionError("dropout must not take the sparse kernels")

    with mock.patch.object(tt, "sparse_attention", no_sparse):
        got = apply_transformer(params, toks, cfg, train=True,
                                dropout_seed=7, sparse_pattern=pattern)
        with mock.patch.object(tt, "flash_attention", direct):
            want = apply_transformer(params, toks, cfg, train=True,
                                     dropout_seed=7, sparse_pattern=pattern)
    assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    other = apply_transformer(params, toks, cfg, train=True, dropout_seed=8,
                              sparse_pattern=pattern)
    assert not torch.allclose(other, got)  # another seed, other masks


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_remat_policies_agree_with_pattern(rate):
    """Loss and gradients with a pattern are the same without remat and
    under remat "full" and "dots", on the sparse route (rate 0) and the
    dropout fallback (rate 0.1)."""
    cfg = port_config(jax_config(dropout_rate=rate), remat=False)
    params = init_params(cfg, seed=5, device="cpu")
    toks = tokens(2, N + 1, cfg.vocab_size, seed=6)
    pattern = _pattern([[1, 0], [1, 1]])

    def grads(c):
        params.zero_grad(set_to_none=True)
        loss = _port_loss(params, c, toks, pattern, train=True,
                          dropout_seed=3 if rate else None)
        loss.backward()
        return loss.item(), {n: p.grad.clone()
                             for n, p in params.named_parameters()}

    l0, g0 = grads(cfg)
    for policy in ("full", "dots"):
        l1, g1 = grads(dataclasses.replace(cfg, remat=True,
                                           remat_policy=policy))
        assert l1 == l0, policy
        for name in g0:
            assert_allclose(g1[name], g0[name], rtol=1e-6, atol=1e-7,
                            err_msg=f"{policy} {name}")


@pytest.mark.parametrize("over, kw, match", [
    (dict(attention_window=8), {}, "attention_window"),
    ({}, dict(segment_ids=np.zeros((1, N), np.int32)), "segment_ids"),
])
def test_pattern_with_window_or_segments_raises_like_jax(over, kw, match):
    jcfg = jax_config(**over)
    jp = init_transformer(jax.random.key(0), jcfg)
    toks = tokens(1, N, jcfg.vocab_size)
    pattern = _pattern([[1, 0], [1, 1]])
    with pytest.raises(ValueError, match=match):
        jax_apply(jp, jnp.asarray(toks, jnp.int32), jcfg,
                  sparse_pattern=jnp.asarray(pattern),
                  **{k: jnp.asarray(v) for k, v in kw.items()})
    with pytest.raises(ValueError, match=match):
        apply_transformer(port_params(jp, port_config(jcfg)),
                          torch.from_numpy(toks), port_config(jcfg),
                          sparse_pattern=torch.from_numpy(pattern),
                          **{k: torch.from_numpy(v) for k, v in kw.items()})
