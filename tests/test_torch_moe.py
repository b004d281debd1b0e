"""The port's mixture-of-experts blocks against the JAX package's, on the CPU
in float32 at a tiny width (2 layers, d_model 64, 4 heads, 4 experts, top 2).

``moe_mlp`` in capacity mode (with drops) and dropless, the tie order under
a zero router, the load-balance loss at uniform routing, the equal-experts
oracle, the model's logits, loss and gradients, KV-cache decode and the
serving engine's greedy tokens. Tolerance: fp32 1e-4 (the JAX ladder);
greedy tokens exact.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_tpu.models import train as jtrain
from flashattention_tpu.models.moe import moe_mlp as jax_moe_mlp
from flashattention_tpu.models.transformer import TransformerConfig as JaxConfig
from flashattention_tpu.models.transformer import apply_transformer as jax_apply
from flashattention_tpu.models.transformer import init_transformer
from flashattention_tpu.serving import EngineConfig as JaxEngineConfig
from flashattention_tpu.serving import GenerationRequest as JaxRequest
from flashattention_tpu.serving import ServingEngine as JaxEngine
from flashattention_tpu_torch.models import moe
from flashattention_tpu_torch.models import train as ttrain
from flashattention_tpu_torch.models.transformer import (
    TransformerConfig,
    _dense_mlp,
    apply_transformer,
    decode_step,
    init_kv_cache,
    params_from_jax,
)
from flashattention_tpu_torch.serving import (
    EngineConfig,
    GenerationRequest,
    ServingEngine,
)
from flashattention_tpu_torch.utils.testing import assert_allclose

TOL = 1e-4

JCFG = JaxConfig(
    vocab_size=97, d_model=64, n_layers=2, n_heads=4, d_ff=96, max_seq_len=64,
    block_size=16, dropout_rate=0.0, dtype=jnp.float32, moe_experts=4,
    moe_top_k=2, moe_group_size=8,
)


def port_config(cfg: JaxConfig, **kw) -> TransformerConfig:
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(TransformerConfig)}
    fields.update(dtype=torch.float32, param_dtype=torch.float32,
                  attention_backend="auto", **kw)
    return TransformerConfig(**fields)


PCFG = port_config(JCFG)


@pytest.fixture(scope="module")
def jparams():
    return init_transformer(jax.random.key(0), JCFG)


@pytest.fixture(scope="module")
def pparams(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), PCFG,
                           device="cpu")


def layer(seed, d=64, e=4, f=96, router_scale=1.0):
    rng = np.random.default_rng(seed)
    return {
        "router": rng.standard_normal((d, e)).astype(np.float32) * router_scale,
        "w_in": rng.standard_normal((e, d, f)).astype(np.float32) * 0.1,
        "b_in": rng.standard_normal((e, f)).astype(np.float32) * 0.1,
        "w_out": rng.standard_normal((e, f, d)).astype(np.float32) * 0.1,
        "b_out": rng.standard_normal((e, d)).astype(np.float32) * 0.1,
    }


def as_port(p):
    return SimpleNamespace(**{k: torch.from_numpy(v) for k, v in p.items()})


def as_jax(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def both(x, p, cfg_kw=None, **kw):
    """(port (y, aux), JAX (y, aux)) of one MoE layer on x (numpy)."""
    jcfg = dataclasses.replace(JCFG, **(cfg_kw or {}))
    y, aux = moe.moe_mlp(torch.from_numpy(x), as_port(p), port_config(jcfg),
                         **kw)
    jy, jaux = jax_moe_mlp(jnp.asarray(x), as_jax(p), jcfg, **kw)
    return (y, aux), (np.asarray(jy), float(jaux))


@pytest.mark.parametrize("mode", ["capacity", "dropless", "group_4",
                                  "ragged_group"])
def test_moe_mlp_matches_jax(mode):
    cfg_kw = {"group_4": dict(moe_group_size=4),
              "ragged_group": dict(moe_group_size=5)}.get(mode)
    n = 15 if mode == "ragged_group" else 16  # ragged: groups of 5 of 15
    x = np.random.default_rng(1).standard_normal((2, n, 64)).astype(np.float32)
    (y, aux), (jy, jaux) = both(x, layer(2), cfg_kw,
                                dropless=mode == "dropless")
    assert_allclose(y, jy, rtol=TOL, atol=TOL, err_msg=mode)
    assert abs(float(aux) - jaux) <= TOL * (1 + abs(jaux))


def test_capacity_overflow_drops_like_jax():
    """A capacity near zero keeps one assignment per expert and group; the
    drop pattern is JAX's, and dropless keeps every assignment."""
    x = np.random.default_rng(3).standard_normal((2, 16, 64)).astype(np.float32)
    p = layer(4, router_scale=3.0)
    cfg_kw = dict(moe_capacity_factor=1e-9)
    (y, _), (jy, _) = both(x, p, cfg_kw)
    assert_allclose(y, jy, rtol=TOL, atol=TOL)
    rows = (np.abs(y.numpy()) > 1e-9).any(-1).sum()
    assert rows < 2 * 16  # some tokens lost every assignment
    (yd, _), (jyd, _) = both(x, p, cfg_kw, dropless=True)
    assert_allclose(yd, jyd, rtol=TOL, atol=TOL)
    assert np.abs(yd.numpy() - y.numpy()).max() > 1e-3


def test_zero_router_ties_pick_jax_experts():
    """A zero router ties every expert: both packages take experts 0 and 1,
    expert 0 first (so the one-token capacity goes to it)."""
    probs = torch.full((3, 5, 4), 0.25)
    vals, idx = moe.top_k(probs, 2)
    jvals, jidx = jax.lax.top_k(jnp.full((3, 5, 4), 0.25), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    p = layer(5)
    p["router"] = np.zeros_like(p["router"])
    x = np.ones((1, 8, 64), np.float32)
    for cfg_kw in (None, dict(moe_top_k=1, moe_capacity_factor=1e-9)):
        (y, _), (jy, _) = both(x, p, cfg_kw)
        assert_allclose(y, jy, rtol=TOL, atol=TOL)
    nonzero = (np.abs(y.numpy()[0]) > 1e-9).any(-1).sum()
    assert nonzero == 1  # only the first token kept its slot at expert 0


def test_aux_is_one_at_uniform_routing():
    p = layer(6)
    p["router"] = np.zeros_like(p["router"])
    x = np.random.default_rng(7).standard_normal((2, 16, 64)).astype(np.float32)
    (_, aux), (_, jaux) = both(x, p)
    assert abs(float(aux) - 1.0) <= 1e-5 and abs(jaux - 1.0) <= 1e-5


def test_equal_experts_equal_the_dense_mlp():
    """Identical experts and ample capacity: the gated mixture is the dense
    MLP."""
    rng = np.random.default_rng(8)
    dense = {"w_in": rng.standard_normal((64, 96)) * 0.1,
             "b_in": rng.standard_normal(96) * 0.1,
             "w_out": rng.standard_normal((96, 64)) * 0.1,
             "b_out": rng.standard_normal(64) * 0.1}
    dense = {k: v.astype(np.float32) for k, v in dense.items()}
    p = {"router": rng.standard_normal((64, 4)).astype(np.float32)}
    p.update({k: np.broadcast_to(v, (4,) + v.shape).copy()
              for k, v in dense.items()})
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    (y, aux), _ = both(x, p, dict(moe_capacity_factor=2.0))
    want = _dense_mlp(torch.from_numpy(x), as_port(dense))
    assert_allclose(y, want, rtol=1e-5, atol=1e-5)
    assert np.isfinite(float(aux))


@pytest.mark.parametrize("train", [False, True])
def test_apply_transformer_moe_matches_jax(jparams, pparams, train):
    """Logits and the summed aux: dropless in eval, capacity in training."""
    toks = np.random.default_rng(9).integers(0, 97, size=(2, 24))
    jl, jaux = jax_apply(jparams, jnp.asarray(toks, jnp.int32), JCFG,
                         train=train, dropout_key=jax.random.key(0),
                         return_aux=True)
    pl, paux = apply_transformer(pparams, torch.from_numpy(toks), PCFG,
                                 train=train, dropout_seed=0, return_aux=True)
    assert_allclose(pl, np.asarray(jl), rtol=TOL, atol=TOL)
    assert abs(paux.item() - float(jaux)) <= TOL
    assert paux.item() > 0.0


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


@pytest.mark.parametrize("loss_chunk", [None, 8])
def test_moe_loss_and_grads_match_jax(jparams, loss_chunk):
    """loss = CE + moe_aux_coef * aux, on the full and the chunked path;
    the router gets a gradient."""
    jcfg = dataclasses.replace(JCFG, loss_chunk=loss_chunk)
    pcfg = port_config(jcfg)
    toks = np.random.default_rng(10).integers(0, 97, size=(2, 25))
    jloss, jgrads = jax.value_and_grad(jtrain.loss_fn)(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32)}, jcfg,
        jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), pcfg,
                             device="cpu")
    loss = ttrain.loss_fn(params, {"tokens": torch.from_numpy(toks)}, pcfg, 0)
    loss.backward()
    assert abs(float(loss) - float(jloss)) <= TOL
    want = flat_named(jgrads)
    for name, p in params.named_parameters():
        assert_allclose(p.grad, want[name], rtol=TOL, atol=TOL, err_msg=name)
    assert float(params.blocks[0].mlp.router.grad.abs().max()) > 0.0


def test_moe_decode_matches_teacher_forced(pparams):
    """Decode routes one token at a time, dropless: the same logits as the
    whole-sequence eval forward."""
    n = 12
    toks = torch.from_numpy(np.random.default_rng(11).integers(0, 97, (2, n)))
    full = apply_transformer(pparams, toks, PCFG)
    caches = init_kv_cache(PCFG, batch=2, max_len=n, dtype=torch.float32,
                           device="cpu")
    steps = []
    for i in range(n):
        logits, caches = decode_step(pparams, caches, toks[:, i:i + 1], i, PCFG)
        steps.append(logits)
    assert_allclose(torch.stack(steps, dim=1), full, rtol=TOL, atol=TOL)


def test_moe_engine_tokens_match_jax_engine(jparams):
    """The port's engine routes dropless in prefill chunks and decode: its
    greedy tokens equal the JAX engine's on the same requests."""
    ecfg = dict(max_batch_size=2, page_size=8, num_pages=64, max_seq_len=64,
                prefill_pad=16)
    rng = np.random.default_rng(12)
    reqs = [(i, [int(t) for t in rng.integers(0, 97, size=n)], 6)
            for i, n in enumerate((5, 9, 21))]
    jeng = JaxEngine(jparams, JCFG, JaxEngineConfig(**ecfg))
    for rid, prompt, n in reqs:
        jeng.submit(JaxRequest(request_id=rid, prompt=prompt, max_new_tokens=n))
    want = jeng.run()
    params = params_from_jax(jax.tree.map(np.asarray, jparams), PCFG,
                             device="cpu")
    eng = ServingEngine(params, PCFG, EngineConfig(**ecfg), device="cpu")
    for rid, prompt, n in reqs:
        eng.submit(GenerationRequest(request_id=rid, prompt=prompt,
                                     max_new_tokens=n))
    got = eng.run()
    assert got == want
    assert all(len(got[rid]) == n for rid, _, n in reqs)


def test_moe_speculative_engine_matches_plain(jparams):
    """The speculative tick's draft steps and (B, gamma + 1) verify route
    dropless too: a self-drafting MoE engine gives the plain engine's
    greedy tokens and accepts every proposal."""
    ecfg = dict(max_batch_size=2, page_size=8, num_pages=64, max_seq_len=64,
                prefill_pad=16)
    rng = np.random.default_rng(13)
    prompts = [[int(t) for t in rng.integers(0, 97, size=n)] for n in (7, 12)]
    out = []
    for spec in (0, 3):
        params = params_from_jax(jax.tree.map(np.asarray, jparams), PCFG,
                                 device="cpu")
        kw = dict(draft_params=params, draft_cfg=PCFG) if spec else {}
        eng = ServingEngine(params, PCFG, EngineConfig(**ecfg, spec_gamma=spec),
                            device="cpu", **kw)
        for i, p in enumerate(prompts):
            eng.submit(GenerationRequest(request_id=i, prompt=p,
                                         max_new_tokens=8))
        out.append(eng.run())
        if spec:
            assert eng.spec_accepted == eng.spec_proposed > 0
    assert out[0] == out[1]
