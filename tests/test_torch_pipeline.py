"""The port's GPipe pipeline against the JAX package, on a gloo world of four
CPU processes (``tests/torch_dist_jobs.py``, no JAX in the workers).

- ``stack_pipeline_params`` equals the JAX package's and
  ``unstack_pipeline_params`` inverts it; a layer count the stages do not
  divide raises, and so does a batch that the microbatches do not divide;
- the forward equals the JAX dense ``apply_transformer`` at (pipe, n_micro)
  = (2, 2), (2, 4) (both with 2 data ranks) and (1, 2) (4 data ranks);
- one micro-step's gradients (hand-written backward schedule) equal the
  dense model's, on every rank;
- three train steps (data 2 x pipe 2) give the JAX one-device run's losses
  and keep the embedding and head equal on every rank;
- the MoE model's pipelined loss equals the JAX pipelined step's (the
  per-microbatch load-balance estimator).

The model is the JAX package's pipeline test model (4 layers, d_model 64,
GQA 4/2), fp32, dropout 0 (the pipeline draws other dropout seeds than
the dense forward, in both packages). Tolerance fp32 1e-4.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_dist_jobs
from flashattention_tpu.models import train as jtrain
from flashattention_tpu.models.transformer import TransformerConfig as JaxConfig
from flashattention_tpu.models.transformer import apply_transformer as jax_apply
from flashattention_tpu.models.transformer import init_transformer
from flashattention_tpu.parallel import make_mesh as jax_mesh
from flashattention_tpu.parallel import (
    make_pipelined_train_state as jax_pipe_state,
)
from flashattention_tpu.parallel import make_pipelined_train_step as jax_pipe_step
from flashattention_tpu.parallel import stack_pipeline_params as jax_stack
from flashattention_tpu_torch.models.transformer import (
    TransformerConfig,
    params_from_jax,
)
from flashattention_tpu_torch.parallel import (
    stack_pipeline_params,
    unstack_pipeline_params,
)

TOL = 1e-4
WORLD = 4
JCFG = JaxConfig(
    vocab_size=128, d_model=64, n_layers=4, n_heads=4, n_kv_heads=2, d_ff=128,
    max_seq_len=32, block_size=16, dropout_rate=0.0, dtype=jnp.float32,
)
MOE = dataclasses.replace(JCFG, moe_experts=4, moe_capacity_factor=2.0)
DROPOUT = dataclasses.replace(JCFG, dropout_rate=0.1)
FORWARD_CASES = [(2, 2, 2), (2, 2, 4), (4, 1, 2)]  # (data, pipe, n_micro)
TC = dict(grad_accum=1, warmup_steps=1, total_steps=4, learning_rate=1e-3)


def port_kw(jcfg):
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(TransformerConfig)}
    kw.update(dtype=torch.float32, param_dtype=torch.float32,
              attention_backend="auto")
    return kw


@functools.lru_cache(maxsize=None)
def jparams(moe=False):
    return init_transformer(jax.random.key(0), MOE if moe else JCFG)


def tree(moe=False):
    return jax.tree.map(np.asarray, jparams(moe))


def port_params(moe=False):
    return params_from_jax(tree(moe), TransformerConfig(
        **port_kw(MOE if moe else JCFG)), device="cpu")


def tokens(seed, b, n):
    return np.random.default_rng(seed).integers(0, 128, size=(b, n))


def fwd_name(data, pipe, n_micro):
    return f"fwd_d{data}_p{pipe}_m{n_micro}"


@pytest.fixture(scope="module")
def world():
    jobs = [(fwd_name(*c), "pipe_forward_job",
             dict(tree=tree(), cfg_kw=port_kw(JCFG), tokens=tokens(1, 8, 16),
                  data=c[0], pipe=c[1], n_micro=c[2]))
            for c in FORWARD_CASES]
    jobs.append(("grads", "pipe_train_job",
                 dict(tree=tree(), cfg_kw=port_kw(JCFG),
                      tc_kw={**TC, "grad_accum": 2},
                      batches=[tokens(2, 8, 17)], data=2, pipe=2, n_micro=2)))
    jobs.append(("train", "pipe_train_job",
                 dict(tree=tree(), cfg_kw=port_kw(JCFG), tc_kw=TC,
                      batches=[tokens(3 + i, 8, 17) for i in range(3)],
                      data=2, pipe=2, n_micro=2)))
    jobs.append(("moe", "pipe_train_job",
                 dict(tree=tree(True), cfg_kw=port_kw(MOE), tc_kw=TC,
                      batches=[tokens(6, 4, 17)], data=2, pipe=2, n_micro=2)))
    jobs.append(("dropout", "pipe_dropout_job",
                 dict(tree=tree(), cfg_kw=port_kw(DROPOUT),
                      tokens=tokens(7, 8, 16), data=2, pipe=2, n_micro=2)))
    return torch_dist_jobs.run_world(WORLD, jobs)


def test_workers_import_no_jax(world):
    for rank, out in enumerate(world):
        assert out["_jax_modules"] == [], (rank, out["_jax_modules"][:5])


def test_stack_matches_jax_and_round_trips():
    pp = stack_pipeline_params(port_params(), 2)
    want = jax_stack(jparams(), 2)
    for part in ("embed", "stages", "head"):
        got = jax.tree.map(np.asarray, pp[part],
                           is_leaf=lambda x: isinstance(x, torch.Tensor))
        jax.tree.map(np.testing.assert_array_equal, got,
                     jax.tree.map(np.asarray, want[part]))
    back = unstack_pipeline_params(pp, TransformerConfig(**port_kw(JCFG)))
    for (n, a), (_, b) in zip(port_params().named_parameters(),
                              back.named_parameters()):
        assert torch.equal(a, b), n


def test_stack_divisibility():
    with pytest.raises(ValueError, match="not divisible"):
        stack_pipeline_params(port_params(), 3)


def test_forward_batch_divisibility(world):
    assert "n_micro 3" in world[0][fwd_name(*FORWARD_CASES[0])]["error"]


@pytest.mark.parametrize("data,pipe,n_micro", FORWARD_CASES,
                         ids=[fwd_name(*c) for c in FORWARD_CASES])
def test_forward_matches_dense(world, data, pipe, n_micro):
    toks = tokens(1, 8, 16)
    want = np.asarray(jax_apply(jparams(), jnp.asarray(toks, jnp.int32), JCFG))
    for rank, out in enumerate(world):
        r = out[fwd_name(data, pipe, n_micro)]
        np.testing.assert_allclose(r["logits"], want[r["rows"]], rtol=TOL,
                                   atol=TOL, err_msg=f"rank {rank}")


def flat_named(t, prefix=""):
    out = {}
    if isinstance(t, dict):
        for k, v in t.items():
            out.update(flat_named(v, f"{prefix}{k}."))
    elif isinstance(t, (list, tuple)):
        for i, v in enumerate(t):
            out.update(flat_named(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = np.asarray(t, np.float32)
    return out


def test_grads_match_dense(world):
    """Every rank's stage gradients (and the replicated embedding and head)
    after one micro-step equal the dense model's."""
    toks = jnp.asarray(tokens(2, 8, 17), jnp.int32)
    grads = jax.jit(jax.grad(jtrain.loss_fn), static_argnums=2)(
        jparams(), {"tokens": toks}, JCFG, jax.random.key(0))
    want = flat_named(grads)
    seen = set()
    for rank, out in enumerate(world):
        for name, g in out["grads"]["grads"].items():
            np.testing.assert_allclose(g, want[name], rtol=TOL, atol=TOL,
                                       err_msg=f"rank {rank} {name}")
            seen.add(name)
    assert seen == set(want)


def test_train_steps_match_one_device(world):
    """Three steps' losses equal the JAX one-device run's; afterwards the
    embedding and head are equal on every rank."""
    params, jcfg = jparams(), JCFG
    tx = jtrain.make_optimizer(jtrain.TrainConfig(**TC))
    state = tx.init(params)
    grad_fn = jax.jit(jax.value_and_grad(jtrain.loss_fn), static_argnums=2)
    losses = []
    for i in range(3):
        batch = {"tokens": jnp.asarray(tokens(3 + i, 8, 17), jnp.int32)}
        loss, g = grad_fn(params, batch, jcfg, jax.random.key(0))
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    for out in world:
        np.testing.assert_allclose(out["train"]["losses"], losses, rtol=TOL,
                                   atol=TOL)
    shared0 = world[0]["train"]["shared"]
    for out in world[1:]:
        for name, p in out["train"]["shared"].items():
            np.testing.assert_array_equal(p, shared0[name], err_msg=name)


def test_pipelined_moe_loss_matches_jax(world):
    toks = jnp.asarray(tokens(6, 4, 17), jnp.int32)
    tx = jtrain.make_optimizer(jtrain.TrainConfig(**TC))
    mesh = jax_mesh(data=2, pipe=2)
    with mesh:
        st, opt, _ = jax_pipe_state(mesh, jparams(True), tx)
        step = jax_pipe_step(mesh, MOE, tx, n_micro=2)
        _, _, loss = step(st, opt, {"tokens": toks}, jax.random.key(0))
    for out in world:
        np.testing.assert_allclose(out["moe"]["losses"][0], float(loss),
                                   rtol=TOL, atol=TOL)


def test_pipeline_dropout_draws_its_own_seeds(world):
    """Train-mode dropout in the pipeline draws per-(microbatch, layer)
    seeds from the step's seed: replayable, seed-dependent, and another
    stream than the dense forward's (as the JAX pipeline's fold_in keys
    differ from its dense split), so dense parity holds at dropout 0."""
    for out in world:
        same, again, other = out["dropout"]["runs"]
        np.testing.assert_array_equal(same, again)
        assert np.abs(same - other).max() > 1e-3
        assert np.abs(same - out["dropout"]["dense"]).max() > 1e-3
