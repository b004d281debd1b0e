"""The port's parallel layer against the JAX package's, on gloo worlds of
four CPU processes.

The workers (``tests/torch_dist_jobs.py``) import no JAX; one world runs
every job of this module once, and each test compares one job's results
with the JAX package's in the pytest process (8 virtual CPU devices, the
tiled executor in the JAX rings, as the JAX package's own tests run them):

- ring, bidirectional-ring and all-gather attention over 4 context ranks,
  causal and not, with and without segment ids: o, LSE and dq, dk, dv
  (LSE and dLSE both carry a cotangent);
- the same schedules run rank by rank on one device
  (``schedules_on_one_device``, what the card checks);
- head-sharded attention on a 2 x 2 (data, model) mesh;
- the dp x tp train step (2 x 2 and 4 x 1, with ZeRO-1, a packed-varlen
  batch, GQA, and an MoE model with its experts over ``model``) against
  the JAX package's one-device step: two steps' losses and the parameters
  after them.

Tolerances: fp32 1e-4, LSE 5e-3 (the JAX ladder).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dist_jobs
from flashattention_tpu.models import train as jtrain
from flashattention_tpu.models.transformer import TransformerConfig as JaxConfig
from flashattention_tpu.models.transformer import init_transformer
from flashattention_tpu.ops.api import flash_attention as jax_flash
from flashattention_tpu.parallel import make_mesh as jax_mesh
from flashattention_tpu.parallel import param_partition_specs as jax_specs
from flashattention_tpu.parallel.ring import (
    all_gather_attention as jax_all_gather,
)
from flashattention_tpu.parallel.ring import ring_attention as jax_ring
from flashattention_tpu.parallel.ring import ring_attention_bidir as jax_bidir
from flashattention_tpu.parallel.sharded import _zero1_spec
from flashattention_tpu_torch.models.transformer import (
    TransformerConfig,
    params_from_jax,
)
from flashattention_tpu_torch.parallel import param_partition_specs
from flashattention_tpu_torch.parallel.ring import schedules_on_one_device

TOL, LSE_TOL = 1e-4, 5e-3
WORLD = 4
KINDS = ("ring", "bidir", "all_gather")
CP_CASES = [(kind, causal, seg) for kind in KINDS for causal in (False, True)
            for seg in (False, True)]


def cp_inputs(seg: bool):
    """q, k, v, do (2, 2, 128, 32), dlse (2, 2, 128) and packed ids (2, 128)
    whose documents cross the shard boundaries."""
    rng = np.random.default_rng(0)
    q, k, v, do = (rng.standard_normal((2, 2, 128, 32)).astype(np.float32)
                   for _ in range(4))
    dlse = rng.standard_normal((2, 2, 128)).astype(np.float32)
    ids = None
    if seg:
        ids = np.zeros((2, 128), np.int32)
        ids[0, 70:] = 1
        ids[1, 40:] = 1
        ids[1, 100:] = 2
    return q, k, v, do, dlse, ids


def cp_name(kind, causal, seg):
    return f"{kind}-{'causal' if causal else 'full'}{'-seg' if seg else ''}"


# ---------------------------------------------------------------------------
# Training configurations
# ---------------------------------------------------------------------------

BASE = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, d_ff=128,
            max_seq_len=32, block_size=16, dropout_rate=0.0)
TRAIN_CASES = {
    # name: (config, (data, model), zero1, packed)
    "dp2_tp2": (dict(), (2, 2), False, False),
    "dp2_tp2_zero1_packed_gqa": (dict(n_kv_heads=2), (2, 2), True, True),
    "dp4_zero1": (dict(), (4, 1), True, False),
    "ep_moe_dp2_tp2": (dict(moe_experts=4, moe_group_size=8, d_ff=96),
                       (2, 2), False, False),
}
TC = dict(grad_accum=1, warmup_steps=1, total_steps=4, learning_rate=1e-3)


def jax_config(**kw):
    return JaxConfig(**{**BASE, **kw}, dtype=jnp.float32)


def port_kw(jcfg):
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(TransformerConfig)}
    kw.update(dtype=torch.float32, param_dtype=torch.float32,
              attention_backend="auto")
    return kw


def train_batches(packed: bool):
    rng = np.random.default_rng(1)
    out = []
    for _ in range(2):
        b = {"tokens": rng.integers(0, 97, size=(4, 17)).astype(np.int64)}
        if packed:
            ids = np.zeros((4, 17), np.int32)
            ids[:, 6:] = 1
            ids[1:, 11:] = 2
            ids[3, 15:] = -1  # padding
            b["segment_ids"] = ids
        out.append(b)
    return out


def jax_params(case):
    return init_transformer(jax.random.key(3), jax_config(**TRAIN_CASES[case][0]))


# ---------------------------------------------------------------------------
# The world
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world():
    """Every rank's results of every job of this module, one spawn."""
    jobs = []
    for kind, causal, seg in CP_CASES:
        q, k, v, do, dlse, ids = cp_inputs(seg)
        jobs.append((cp_name(kind, causal, seg), "cp_job",
                     dict(kind=kind, q=q, k=k, v=v, do=do, dlse=dlse, ids=ids,
                          causal=causal)))
    q, k, v, _, _, _ = cp_inputs(False)
    q8 = np.concatenate([q, q[:, :, ::-1]], axis=1).copy()  # 4 heads
    jobs.append(("head_sharded", "head_sharded_job",
                 dict(q=q8, k=q8[..., ::-1, :].copy(), v=q8 * 0.5, data=2,
                      model=2)))
    for case, (cfg_kw, (data, model), zero1, packed) in TRAIN_CASES.items():
        tree = jax.tree.map(np.asarray, jax_params(case))
        jobs.append((case, "train_job",
                     dict(tree=tree, cfg_kw=port_kw(jax_config(**cfg_kw)),
                          tc_kw=TC, batches=train_batches(packed), data=data,
                          model=model, zero1=zero1)))
    return torch_dist_jobs.run_world(WORLD, jobs)


def test_workers_import_no_jax(world):
    for rank, out in enumerate(world):
        assert out["_jax_modules"] == [], (rank, out["_jax_modules"][:5])


# ---------------------------------------------------------------------------
# Context parallelism
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jax_cp(kind, causal, seg):
    """JAX's context-parallel (o, lse, dq, dk, dv) of cp_inputs(seg) on 4
    context devices, gradients through the merge."""
    q, k, v, do, dlse, ids = cp_inputs(seg)
    fn = {"ring": jax_ring, "bidir": jax_bidir, "all_gather": jax_all_gather}[kind]
    mesh = jax_mesh(context=WORLD)
    spec, ispec = P(None, None, "context", None), P(None, "context")
    ids_in = jnp.asarray(ids if seg else np.zeros((2, 128), np.int32))

    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(spec, spec, spec, ispec),
                       out_specs=(spec, P(None, None, "context")),
                       check_vma=False)
    def run(q_, k_, v_, ids_):
        return fn(q_, k_, v_, axis_name="context", causal=causal,
                  backend="xla", segment_ids=ids_ if seg else None)

    def loss(q_, k_, v_):
        o, lse = run(q_, k_, v_, ids_in)
        return jnp.sum(o * do) + jnp.sum(lse * dlse), (o, lse)

    grads, (o, lse) = jax.jit(jax.grad(loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return tuple(np.asarray(x) for x in (o, lse, *grads))


def _check(got, want, name):
    for part, g, w in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        tol = LSE_TOL if part == "lse" else TOL
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                   err_msg=f"{name} {part}")


@pytest.mark.parametrize("kind,causal,seg", CP_CASES,
                         ids=[cp_name(*c) for c in CP_CASES])
def test_context_parallel_matches_jax(world, kind, causal, seg):
    name = cp_name(kind, causal, seg)
    got = [np.concatenate([out[name][part] for out in world], axis=2)
           for part in ("o", "lse", "dq", "dk", "dv")]
    _check(got, jax_cp(kind, causal, seg), name)


@pytest.mark.parametrize("kind,causal,seg", CP_CASES,
                         ids=[cp_name(*c) for c in CP_CASES])
def test_schedules_on_one_device_match_jax(kind, causal, seg):
    """The rank-by-rank schedules of one device, as the card runs them."""
    q, k, v, do, dlse, ids = (None if x is None else torch.from_numpy(x)
                              for x in cp_inputs(seg))
    got = schedules_on_one_device(kind, q, k, v, WORLD, causal=causal,
                                  segment_ids=ids, do=do, dlse=dlse)
    _check([x.numpy() for x in got], jax_cp(kind, causal, seg),
           cp_name(kind, causal, seg))


def test_head_sharded_attention_matches_jax(world):
    q, k, v, _, _, _ = cp_inputs(False)
    q8 = np.concatenate([q, q[:, :, ::-1]], axis=1).copy()
    k8, v8 = q8[..., ::-1, :].copy(), q8 * 0.5
    o_ref, lse_ref = jax_flash(jnp.asarray(q8), jnp.asarray(k8),
                               jnp.asarray(v8), causal=True, backend="xla")
    o = np.zeros_like(q8)
    lse = np.zeros(q8.shape[:3], np.float32)
    for out in world:
        r = out["head_sharded"]
        rows = slice(r["data"], r["data"] + 1)
        heads = slice(2 * r["model"], 2 * r["model"] + 2)
        o[rows, heads], lse[rows, heads] = r["o"], r["lse"]
    np.testing.assert_allclose(o, np.asarray(o_ref), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse, np.asarray(lse_ref), rtol=LSE_TOL,
                               atol=LSE_TOL)


# ---------------------------------------------------------------------------
# Sharded training
# ---------------------------------------------------------------------------


def test_partition_specs_follow_jax():
    """The dim split over 'model', leaf by leaf, is the JAX package's
    PartitionSpec's (dense and MoE)."""
    for kw in ({}, dict(moe_experts=4)):
        jcfg = jax_config(**kw)
        jp = init_transformer(jax.random.key(0), jcfg)
        params = params_from_jax(jax.tree.map(np.asarray, jp),
                                 TransformerConfig(**port_kw(jcfg)),
                                 device="cpu")
        want = {}
        flat, _ = jax.tree_util.tree_flatten_with_path(
            jax_specs(jp), is_leaf=lambda x: isinstance(x, P))
        for path, spec in flat:
            name = ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                            for p in path)
            dims = [i for i, ax in enumerate(spec) if ax == "model"]
            want[name] = dims[0] if dims else None
        assert param_partition_specs(params) == want


@functools.lru_cache(maxsize=None)
def jax_steps(case):
    """The JAX package's one-device run of train_batches: losses and the
    parameters after them."""
    cfg_kw, _, _, packed = TRAIN_CASES[case]
    jcfg = jax_config(**cfg_kw)
    params = jax_params(case)
    tx = jtrain.make_optimizer(jtrain.TrainConfig(**TC))
    state = tx.init(params)
    grad_fn = jax.jit(jax.value_and_grad(jtrain.loss_fn), static_argnums=2)
    losses = []
    for b in train_batches(packed):
        batch = {k: jnp.asarray(v) for k, v in b.items()}
        loss, grads = grad_fn(params, batch, jcfg, jax.random.key(0))
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return losses, params


def flat_named(tree, prefix="", leaf=lambda x: np.asarray(x, np.float32)):
    """{'blocks.0.attn.w_qkv': leaf, ...} of a nested JAX tree."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat_named(v, f"{prefix}{k}.", leaf))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        for i, v in enumerate(tree):
            out.update(flat_named(v, f"{prefix}{i}.", leaf))
    else:
        out[prefix[:-1]] = leaf(tree)
    return out


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_sharded_train_step_matches_jax(world, case):
    """Two steps of the sharded step equal the JAX one-device steps: the
    losses and every parameter after them, on every rank."""
    losses, params = jax_steps(case)
    want = flat_named(params)
    for rank, out in enumerate(world):
        r = out[case]
        np.testing.assert_allclose(r["losses"], losses, rtol=TOL, atol=TOL)
        for name, p in r["params"].items():
            np.testing.assert_allclose(p, want[name], rtol=TOL, atol=1e-5,
                                       err_msg=f"{case} rank {rank} {name}")


@pytest.mark.parametrize("case", ["dp2_tp2_zero1_packed_gqa", "dp4_zero1"])
def test_zero1_slices_the_moments(world, case):
    """Under ZeRO-1 each data rank keeps moments for 1 / n_data of exactly
    the parameters whose moments the JAX ``_zero1_spec`` puts on 'data'
    (the rest, such as b_qkv split over 'model', stay whole)."""
    n_data = TRAIN_CASES[case][1][0]
    jp = jax_params(case)
    specs = flat_named(jax_specs(jp), leaf=lambda x: x)
    want = {name: (1 / n_data if "data" in _zero1_spec(
                specs[name], leaf.shape, n_data) else 1.0)
            for name, leaf in flat_named(jp).items()}
    for out in world:
        assert out[case]["shares"] == pytest.approx(want)
    assert min(want.values()) == 1 / n_data


def test_tensor_parallel_shards_heads_and_experts(world):
    """Each model rank holds its half of the heads (q, k and v of them in
    w_qkv), of d_ff, of the vocab (97: 49 and 48) and of the experts."""
    dense = world[0]["dp2_tp2_zero1_packed_gqa"]["local_shapes"]
    assert dense["blocks.0.attn.w_qkv"] == (64, (4 + 2 * 2) * 16 // 2)
    assert dense["blocks.0.mlp.w_in"] == (64, 64)
    vocab = {world[r]["dp2_tp2"]["local_shapes"]["lm_head.w"][1]
             for r in range(WORLD)}
    assert vocab == {49, 48}
    moe = world[0]["ep_moe_dp2_tp2"]["local_shapes"]
    assert moe["blocks.0.mlp.w_in"] == (2, 64, 96)
    assert moe["blocks.0.mlp.router"] == (64, 4)


@pytest.mark.parametrize("kind", KINDS)
def test_future_shards_launch_nothing(kind, monkeypatch):
    """The causal schedules skip a future shard on the host: 4 ranks make
    10 ring partials (r + 1 on rank r), 20 bidirectional halves and 4
    all-gather calls each way; without causality every step launches. (The
    JAX rings launch a future shard with q_offset = -n, which computes
    nothing, to keep one traced call differentiable.)"""
    from flashattention_tpu_torch.ops import flash_attn as fa

    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fa.flash_fwd, fa.flash_bwd_di

    def count(part, fn):
        def counted(*args):
            calls[part] += 1
            return fn(*args)
        return counted

    monkeypatch.setattr(fa, "flash_fwd", count("fwd", fwd))
    monkeypatch.setattr(fa, "flash_bwd_di", count("bwd", bwd))
    q, k, v, do, dlse, _ = (None if x is None else torch.from_numpy(x)
                            for x in cp_inputs(False))
    for causal, want in ((True, {"ring": 10, "bidir": 20, "all_gather": 4}),
                         (False, {"ring": 16, "bidir": 32, "all_gather": 4})):
        calls.update(fwd=0, bwd=0)
        schedules_on_one_device(kind, q, k, v, WORLD, causal=causal, do=do,
                                dlse=dlse)
        assert calls == {"fwd": want[kind], "bwd": want[kind]}, causal
