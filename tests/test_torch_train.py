"""The port's model and trainer against the JAX package's, on the CPU in
float32 at a tiny width: logits, loss and gradients, the optimizer and its
schedule against optax, four optimizer updates of ``train``, KV-cache
decode, remat with dropout, and checkpoint resume.

Tolerance: fp32 1e-4 (the JAX ladder). Dropout is off wherever the two
packages are compared: the JAX package draws residual dropout with
``jax.random``, the port from per-site integer seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flashattention_tpu.models import train as jtrain
from flashattention_tpu.models.transformer import TransformerConfig as JaxConfig
from flashattention_tpu.models.transformer import (
    apply_transformer as jax_apply,
)
from flashattention_tpu.models.transformer import (
    decode_chunk as jax_decode_chunk,
)
from flashattention_tpu.models.transformer import (
    decode_step as jax_decode_step,
)
from flashattention_tpu.models.transformer import init_kv_cache as jax_init_cache
from flashattention_tpu.models.transformer import init_transformer
from flashattention_tpu_torch.models import train as ttrain
from flashattention_tpu_torch.models.transformer import (
    TransformerConfig,
    apply_transformer,
    decode_chunk,
    decode_step,
    init_kv_cache,
    init_params,
    params_from_jax,
)
from flashattention_tpu_torch.utils.testing import assert_allclose

TOL = 1e-4

BASE = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, d_ff=128,
            max_seq_len=64, block_size=32, dropout_rate=0.0)
CONFIGS = {
    "learned": {},
    "no_positions": dict(pos_encoding="none"),
    "rope": dict(pos_encoding="rope"),
    "gqa": dict(n_kv_heads=2),
    "separate_qkv": dict(fused_qkv=False, n_kv_heads=2),
    "window_softcap": dict(attention_window=9, attention_sinks=2,
                           attn_softcap=3.0, pos_encoding="rope"),
}


def jax_config(**kw) -> JaxConfig:
    return JaxConfig(**{**BASE, **kw}, dtype=jnp.float32)


def port_config(cfg: JaxConfig, **kw) -> TransformerConfig:
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(TransformerConfig)}
    fields.update(dtype=torch.float32, param_dtype=torch.float32,
                  attention_backend="auto", **kw)
    return TransformerConfig(**fields)


def jax_params(cfg, seed=0):
    return init_transformer(jax.random.key(seed), cfg)


def port_params(jparams, pcfg):
    return params_from_jax(jax.tree.map(np.asarray, jparams), pcfg,
                           device="cpu")


def tokens(b, n, vocab, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, n))


def packed_ids(b, n):
    """Three documents per row, contiguous runs."""
    ids = np.zeros((b, n), np.int32)
    ids[:, n // 3:] = 1
    ids[:, 2 * n // 3:] = 2
    return ids


def flat_named(tree, prefix=""):
    """{'blocks.0.attn.w_qkv': array, ...} from a nested JAX tree."""
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


@pytest.mark.parametrize("case", sorted(CONFIGS) + ["segments"])
def test_apply_transformer_logits_match_jax(case):
    jcfg = jax_config(**CONFIGS.get(case, {}))
    jp = jax_params(jcfg)
    pcfg = port_config(jcfg)
    toks = tokens(2, 40, jcfg.vocab_size)
    seg = packed_ids(2, 40) if case == "segments" else None
    ref = jax_apply(jp, jnp.asarray(toks, jnp.int32), jcfg,
                    segment_ids=None if seg is None else jnp.asarray(seg))
    out = apply_transformer(port_params(jp, pcfg), torch.from_numpy(toks), pcfg,
                            segment_ids=None if seg is None
                            else torch.from_numpy(seg))
    assert out.dtype == torch.float32 and out.shape == (2, 40, jcfg.vocab_size)
    assert_allclose(out, np.asarray(ref), rtol=TOL, atol=TOL, err_msg=case)


@pytest.mark.parametrize("case", ["plain", "chunked", "segments", "gqa_rope",
                                  "mqa_d512"])
def test_loss_and_grads_match_jax(case):
    # mqa_d512: head dim 512 over one KV head (the shape of chip_smoke
    # phase 5d at 2 query heads)
    kw = {"chunked": dict(loss_chunk=16), "gqa_rope": dict(
        n_kv_heads=2, pos_encoding="rope"), "mqa_d512": dict(
        d_model=1024, n_heads=2, n_kv_heads=1, pos_encoding="rope")}.get(
        case, {})
    jcfg = jax_config(**kw)
    jp = jax_params(jcfg)
    pcfg = port_config(jcfg)
    toks = tokens(2, 41, jcfg.vocab_size)
    jbatch = {"tokens": jnp.asarray(toks, jnp.int32)}
    tbatch = {"tokens": torch.from_numpy(toks)}
    if case == "segments":
        ids = packed_ids(2, 41)
        ids[1, -5:] = -1  # a padding segment leaves the mean
        jbatch["segment_ids"] = jnp.asarray(ids)
        tbatch["segment_ids"] = torch.from_numpy(ids)
    loss, grads = jax.value_and_grad(jtrain.loss_fn)(
        jp, jbatch, jcfg, jax.random.key(0))
    params = port_params(jp, pcfg)
    tloss = ttrain.loss_fn(params, tbatch, pcfg, None)
    tloss.backward()
    assert_allclose(tloss, np.asarray(loss), rtol=TOL, atol=TOL)
    ref = flat_named(grads)
    got = {n: p.grad for n, p in params.named_parameters()}
    assert set(got) == set(ref)
    for name, g in got.items():
        assert_allclose(g, ref[name], rtol=TOL, atol=TOL, err_msg=name)


def _constant_grad_deltas_jax(tc, n_micro):
    """Parameter moves of one scalar under the JAX optimizer with a
    constant unit gradient and no weight decay: -lr(update) each update."""
    tx = jtrain.make_optimizer(tc)
    p = {"w": jnp.zeros(())}
    state = tx.init(p)
    moves = []
    for _ in range(n_micro):
        upd, state = tx.update({"w": jnp.ones(())}, state, p)
        new = optax.apply_updates(p, upd)
        moves.append(float(new["w"] - p["w"]))
        p = new
    return moves


def _constant_grad_deltas_port(tc, n_micro):
    w = torch.nn.Parameter(torch.zeros(()))
    holder = torch.nn.Module()
    holder.w = w
    opt = ttrain.Optimizer(holder, tc)
    moves = []
    for _ in range(n_micro):
        before = float(w)
        w.grad = torch.ones(()) if w.grad is None else w.grad + 1.0
        opt.step()
        moves.append(float(w) - before)
    return moves


@pytest.mark.parametrize("warmup,total,accum", [
    (10, 40, 1), (8, 40, 2), (1, 12, 2), (3, 20, 4), (2, 16, 2), (0, 9, 3),
])
def test_lr_schedule_matches_optax(warmup, total, accum):
    """The whole schedule, read off the parameter moves, including
    warmup_steps < grad_accum (warmup collapses to one update)."""
    tc = jtrain.TrainConfig(learning_rate=1e-2, warmup_steps=warmup,
                            total_steps=total, grad_accum=accum,
                            weight_decay=0.0)
    ptc = ttrain.TrainConfig(**dataclasses.asdict(tc))
    ref = _constant_grad_deltas_jax(tc, total + 2 * accum)
    got = _constant_grad_deltas_port(ptc, total + 2 * accum)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-9)
    lr = ttrain.lr_schedule(ptc)
    upd = [m for i, m in enumerate(got) if (i + 1) % accum == 0]
    np.testing.assert_allclose([-lr(u) for u in range(len(upd))], upd,
                               rtol=1e-5, atol=1e-9)


def test_optimizer_matches_optax_with_clipping_and_decay():
    rng = np.random.default_rng(5)
    shapes = [(3, 4), (5,), ()]
    tc = jtrain.TrainConfig(learning_rate=3e-2, warmup_steps=2, total_steps=12,
                            grad_accum=2, grad_clip=0.5, weight_decay=0.1)
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(3 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
             for _ in range(10)]
    tx = jtrain.make_optimizer(tc)
    p = [jnp.asarray(x) for x in init]
    state = tx.init(p)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, p)
        p = optax.apply_updates(p, upd)
    holder = torch.nn.Module()
    for i, x in enumerate(init):
        holder.register_parameter(f"p{i}", torch.nn.Parameter(torch.tensor(x)))
    opt = ttrain.Optimizer(holder, ttrain.TrainConfig(**dataclasses.asdict(tc)))
    params = list(holder.parameters())
    for g in grads:
        for t, x in zip(params, g):
            gx = torch.tensor(x)
            t.grad = gx if t.grad is None else t.grad + gx
        opt.step()
    for t, r in zip(params, p):
        assert_allclose(t, np.asarray(r), rtol=1e-5, atol=1e-6)


def test_train_four_updates_match_jax():
    """8 micro-steps, grad_accum 2: four optimizer updates of the port's
    train against the JAX train from the same initial parameters and the
    same synthetic batches."""
    jcfg = jax_config()
    tc = jtrain.TrainConfig(batch_size=2, seq_len=16, total_steps=8,
                            grad_accum=2, warmup_steps=2, log_every=1,
                            learning_rate=1e-3)
    jp_final, _, jlosses = jtrain.train(jcfg, tc, verbose=False)
    pkey, _ = jax.random.split(jax.random.key(tc.seed))
    jp0 = init_transformer(pkey, jcfg)
    pcfg = port_config(jcfg)
    params, opt, losses = ttrain.train(
        pcfg, ttrain.TrainConfig(**dataclasses.asdict(tc)),
        params=port_params(jp0, pcfg), device="cpu", verbose=False)
    assert opt.updates == 4
    np.testing.assert_allclose(losses, jlosses, rtol=TOL, atol=TOL)
    ref = flat_named(jp_final)
    moved = 0.0
    for name, p in params.named_parameters():
        assert_allclose(p, ref[name], rtol=TOL, atol=TOL, err_msg=name)
        moved = max(moved, float((p.detach() - torch.from_numpy(
            flat_named(jp0)[name])).abs().max()))
    assert moved > 10 * TOL  # the updates did move the parameters


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_grads_equal_plain_grads_with_dropout(policy):
    cfg = port_config(jax_config(), dropout_rate=0.1, remat=False)
    params = init_params(cfg, seed=2, device="cpu")
    batch = {"tokens": torch.from_numpy(tokens(2, 33, cfg.vocab_size))}

    def grads(c):
        params.zero_grad(set_to_none=True)
        loss = ttrain.loss_fn(params, batch, c, 1234)
        loss.backward()
        return float(loss), {n: p.grad.clone()
                             for n, p in params.named_parameters()}

    l0, g0 = grads(cfg)
    l1, g1 = grads(dataclasses.replace(cfg, remat=True, remat_policy=policy))
    l2, _ = grads(dataclasses.replace(cfg, remat=False))
    assert l0 == l1 == l2
    for name in g0:
        assert_allclose(g1[name], g0[name], rtol=1e-6, atol=1e-7, err_msg=name)
    other = ttrain.loss_fn(params, batch, cfg, 4321)
    assert float(other) != l0  # another seed, other masks


@pytest.mark.parametrize("case", ["learned", "window_softcap", "gqa"])
def test_decode_matches_jax(case):
    jcfg = jax_config(**CONFIGS[case])
    jp = jax_params(jcfg)
    pcfg = port_config(jcfg)
    params = port_params(jp, pcfg)
    toks = tokens(2, 12, jcfg.vocab_size, seed=9)
    jc = jax_init_cache(jcfg, 2, 32)
    tcache = init_kv_cache(pcfg, 2, 32, device="cpu")
    jl, jc = jax_decode_chunk(jp, jc, jnp.asarray(toks[:, :7], jnp.int32),
                              jnp.asarray(0, jnp.int32), jcfg)
    tl, tcache = decode_chunk(params, tcache, torch.from_numpy(toks[:, :7]), 0,
                              pcfg)
    assert_allclose(tl, np.asarray(jl), rtol=TOL, atol=TOL, err_msg="chunk")
    for i in range(7, 12):
        jl, jc = jax_decode_step(jp, jc, jnp.asarray(toks[:, i:i + 1], jnp.int32),
                                 jnp.asarray(i, jnp.int32), jcfg)
        tl, tcache = decode_step(params, tcache,
                                 torch.from_numpy(toks[:, i:i + 1]), i, pcfg)
        assert_allclose(tl, np.asarray(jl), rtol=TOL, atol=TOL,
                        err_msg=f"step {i}")
    assert_allclose(tcache[0]["k"], np.asarray(jc[0]["k"]), rtol=TOL, atol=TOL)


def test_checkpoint_resume_continues_the_run(tmp_path):
    cfg = port_config(jax_config(), dropout_rate=0.1)
    tc = ttrain.TrainConfig(batch_size=2, seq_len=16, total_steps=6,
                            grad_accum=2, warmup_steps=2, log_every=1,
                            learning_rate=1e-3, checkpoint_every=2,
                            checkpoint_dir=str(tmp_path / "ck"))
    full, _, full_losses = ttrain.train(
        cfg, dataclasses.replace(tc, checkpoint_dir=None), device="cpu",
        verbose=False)
    stream = ttrain.synthetic_batches(tc, cfg.vocab_size, 4)
    ttrain.train(cfg, tc, batches=stream, device="cpu", verbose=False)
    resumed, opt, losses = ttrain.train(cfg, tc, device="cpu", verbose=False)
    assert losses == full_losses[3:]  # resumed after the step-2 checkpoint
    assert opt.updates == 3
    for (name, a), b in zip(full.named_parameters(), resumed.parameters()):
        assert_allclose(b, a, rtol=1e-6, atol=1e-7, err_msg=name)


def test_entry_points_default_to_the_card():
    cfg = port_config(jax_config())
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the defaults would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.train(cfg, ttrain.TrainConfig(total_steps=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_kv_cache(cfg, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(jax.tree.map(np.asarray, jax_params(jax_config())),
                        cfg)
    from flashattention_tpu_torch.serving.paged_kv import init_paged_cache

    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_paged_cache(2, 4, 8, 16)
    params = init_params(cfg, device="cpu")
    assert all(p.requires_grad for p in params.parameters())


def test_separate_qkv_serves_like_fused():
    """The serving engine fuses separate q/k/v projections once; greedy
    tokens equal those of the same weights given fused."""
    from flashattention_tpu_torch.serving import (
        EngineConfig,
        GenerationRequest,
        ServingEngine,
    )

    jcfg = jax_config(**CONFIGS["separate_qkv"])
    jp = jax_params(jcfg)
    sep = port_params(jp, port_config(jcfg))
    fused_tree = jax.tree.map(np.asarray, jp)
    for bp in fused_tree["blocks"]:
        a = bp["attn"]
        bp["attn"] = dict(
            w_qkv=np.concatenate([a["w_q"], a["w_k"], a["w_v"]], axis=1),
            b_qkv=np.concatenate([a["b_q"], a["b_k"], a["b_v"]]),
            w_o=a["w_o"], b_o=a["b_o"])
    fcfg = port_config(jcfg, fused_qkv=True)
    fused = params_from_jax(fused_tree, fcfg, device="cpu")
    ecfg = EngineConfig(max_batch_size=2, page_size=8, num_pages=20,
                        max_seq_len=64, prefill_pad=16)
    out = []
    for params, c in ((sep, port_config(jcfg)), (fused, fcfg)):
        eng = ServingEngine(params, c, ecfg, device="cpu")
        for i, n in enumerate((5, 19)):
            eng.submit(GenerationRequest(i, tokens(1, n, c.vocab_size,
                                                   seed=i)[0].tolist(), 6))
        out.append(eng.run())
    assert out[0] == out[1]


def test_sparse_pattern_and_moe_raise():
    """A block-sparse pattern runs (tests/test_torch_sparse_model.py) and
    raises only where the JAX model does, with a window; MoE blocks build
    (tests/test_torch_moe.py) and raise only on a top-k beyond the experts."""
    cfg = port_config(jax_config(attention_window=4))
    params = init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="attention_window"):
        apply_transformer(params, torch.zeros(1, 8, dtype=torch.long), cfg,
                          sparse_pattern=torch.ones(1, 1))
    moe = init_params(dataclasses.replace(cfg, moe_experts=4), device="cpu")
    assert moe.blocks[0].mlp.router.shape == (cfg.d_model, 4)
    with pytest.raises(ValueError, match="moe_top_k"):
        init_params(dataclasses.replace(cfg, moe_experts=4, moe_top_k=5),
                    device="cpu")
