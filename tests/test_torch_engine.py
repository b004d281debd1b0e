"""The PyTorch port's serving engine against the JAX package's engine.

The JAX parameter tree loads into the port with ``params_from_jax``; both
engines serve the same requests on the CPU in float32 (the JAX engine
through its gather executor, the port through its plain versions) and the
greedy tokens must be equal. Request sets follow ``tests/test_serving.py``.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
)
from flashattention_tpu.models.transformer import init_transformer
from flashattention_tpu.serving import EngineConfig as JaxEngineConfig
from flashattention_tpu.serving import GenerationRequest as JaxRequest
from flashattention_tpu.serving import ServingEngine as JaxEngine
from flashattention_tpu_torch.models.transformer import (
    TransformerConfig,
    params_from_jax,
)
from flashattention_tpu_torch.serving import (
    EngineConfig,
    GenerationRequest,
    PageAllocator,
    SamplingConfig,
    ServingEngine,
)

CFG = JaxConfig(
    vocab_size=89, d_model=64, n_layers=2, n_heads=4, d_ff=128,
    max_seq_len=128, block_size=32, dropout_rate=0.0, dtype=jnp.float32,
    attention_backend="xla",
)


def port_config(cfg: JaxConfig) -> TransformerConfig:
    kw = {f.name: getattr(cfg, f.name)
          for f in dataclasses.fields(TransformerConfig)}
    kw.update(dtype=torch.float32, param_dtype=torch.float32)
    return TransformerConfig(**kw)


def port_engine(cfg, jparams, ecfg_kw, **port_kw):
    """The port's CPU engine over the JAX parameters ``jparams``."""
    pcfg = port_config(cfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), pcfg,
                             device="cpu")
    return ServingEngine(params, pcfg, EngineConfig(**ecfg_kw), device="cpu",
                         **port_kw)


def serve_both(cfg, key, ecfg_kw, requests, **port_kw):
    """Serve ``requests`` [(id, prompt, max_new)] on both engines; returns
    (jax results, port results, port engine)."""
    jparams = init_transformer(jax.random.key(key), cfg)
    jeng = JaxEngine(jparams, cfg, JaxEngineConfig(**ecfg_kw))
    for rid, prompt, n in requests:
        jeng.submit(JaxRequest(request_id=rid, prompt=prompt, max_new_tokens=n))
    res_jax = jeng.run()
    eng = port_engine(cfg, jparams, ecfg_kw, **port_kw)
    for rid, prompt, n in requests:
        eng.submit(GenerationRequest(request_id=rid, prompt=prompt,
                                     max_new_tokens=n))
    return res_jax, eng.run(), eng


def prompts(seed, sizes, vocab=CFG.vocab_size):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, size=n)] for n in sizes]


ECFG_SMALL = dict(max_batch_size=2, page_size=8, num_pages=32,
                  max_seq_len=64, prefill_pad=16)


def test_params_from_jax_keeps_names_and_values():
    jparams = init_transformer(jax.random.key(0), CFG)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), port_config(CFG),
                             device="cpu")
    names = dict(params.named_parameters())
    assert "blocks.1.attn.w_qkv" in names and "blocks.0.mlp.b_out" in names
    assert "blocks.0.ln1.g" in names and "lm_head.w" in names
    assert "pos_emb" in names and "final_ln.b" in names
    np.testing.assert_array_equal(
        names["blocks.1.attn.w_qkv"].detach().numpy(),
        np.asarray(jparams["blocks"][1]["attn"]["w_qkv"]),
    )
    assert names["blocks.1.attn.w_qkv"].shape == (CFG.d_model, CFG.qkv_dim)


@pytest.mark.parametrize("native", [False, None])
def test_plain_requests_match_jax(native):
    reqs = [(i, p, 6) for i, p in enumerate(prompts(0, (5, 11, 3)))]
    ecfg = dict(max_batch_size=4, page_size=8, num_pages=64, max_seq_len=128,
                prefill_pad=16)
    res_jax, res, eng = serve_both(CFG, 0, ecfg, reqs, native_allocator=native)
    assert res == res_jax
    assert eng.allocator.is_native == (native is None)


def test_continuous_admission_matches_jax():
    reqs = [(i, prompts(1, (4 + i,))[0], 4) for i in range(5)]
    res_jax, res, eng = serve_both(CFG, 0, ECFG_SMALL, reqs)
    assert res == res_jax and set(res) == set(range(5))
    assert eng.allocator.free_pages() == ECFG_SMALL["num_pages"] - 1
    # every decode step served at least one slot; all tokens accounted for
    assert eng.stats["decode_tokens"] + 5 == sum(len(v) for v in res.values())


def test_eviction_and_requeue_matches_jax():
    ecfg = dict(max_batch_size=2, page_size=8, num_pages=7, max_seq_len=32,
                prefill_pad=8)
    reqs = [(i, p, 20) for i, p in enumerate(prompts(17, (8, 8)))]
    evictions = []
    jparams = init_transformer(jax.random.key(0), CFG)
    eng = port_engine(CFG, jparams, ecfg)
    real_evict = eng._evict
    eng._evict = lambda slot: (evictions.append(slot.request.request_id),
                               real_evict(slot))[-1]
    for rid, p, n in reqs:
        eng.submit(GenerationRequest(rid, p, n))
    res = eng.run()
    jeng = JaxEngine(jparams, CFG, JaxEngineConfig(**ecfg))
    for rid, p, n in reqs:
        jeng.submit(JaxRequest(rid, p, n))
    assert evictions, "pool math should have forced an eviction"
    assert res == jeng.run()


def test_gqa_matches_jax():
    cfg = dataclasses.replace(CFG, n_kv_heads=2)
    reqs = [(0, prompts(4, (7,))[0], 5)]
    res_jax, res, _ = serve_both(cfg, 3, ECFG_SMALL, reqs)
    assert res == res_jax


def test_rope_matches_jax():
    cfg = dataclasses.replace(CFG, n_kv_heads=2, pos_encoding="rope")
    reqs = [(i, p, 5) for i, p in enumerate(prompts(6, (7, 4)))]
    res_jax, res, _ = serve_both(cfg, 5, ECFG_SMALL, reqs)
    assert res == res_jax


def test_d256_mqa_matches_jax():
    """Head dim 256 over one KV head (Gemma 2B's attention shape at 2
    query heads, rope), 2 layers: the engine's paged calls at D = 256."""
    cfg = dataclasses.replace(CFG, d_model=512, n_heads=2, n_kv_heads=1,
                              d_ff=512, pos_encoding="rope")
    reqs = [(i, p, 6) for i, p in enumerate(prompts(11, (13, 30, 5)))]
    ecfg = dict(max_batch_size=2, page_size=16, num_pages=24,
                max_seq_len=64, prefill_pad=16)
    res_jax, res, eng = serve_both(cfg, 7, ecfg, reqs)
    assert eng.caches[0].k_pages.shape[-1] == 256
    assert res == res_jax


def test_d512_mqa_matches_jax():
    """Head dim 512 over one KV head (2 query heads, rope), 2 layers: the
    engine's paged calls and appends above D = 256."""
    cfg = dataclasses.replace(CFG, d_model=1024, n_heads=2, n_kv_heads=1,
                              d_ff=512, pos_encoding="rope")
    reqs = [(i, p, 6) for i, p in enumerate(prompts(12, (13, 30, 5)))]
    ecfg = dict(max_batch_size=2, page_size=16, num_pages=24,
                max_seq_len=64, prefill_pad=16)
    res_jax, res, eng = serve_both(cfg, 8, ecfg, reqs)
    assert eng.caches[0].k_pages.shape[-1] == 512
    assert res == res_jax


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_prefix_cache_matches_jax(prefix_cache):
    rng = np.random.default_rng(3)
    common = [int(t) for t in rng.integers(0, CFG.vocab_size, size=24)]
    ps = [common + [int(t) for t in rng.integers(0, CFG.vocab_size, size=7)],
          common + [int(t) for t in rng.integers(0, CFG.vocab_size, size=3)],
          common[:10]]
    ecfg = dict(max_batch_size=4, page_size=8, num_pages=64, max_seq_len=128,
                prefill_pad=16, prefix_cache=prefix_cache)
    res_jax, res, eng = serve_both(CFG, 0, ecfg, [(i, p, 6) for i, p in
                                                   enumerate(ps)])
    assert res == res_jax
    held = len(eng._prefix_lru)
    assert (held >= 3) == prefix_cache
    assert eng.allocator.free_pages() == 64 - 1 - held  # dump page + pins
    # the shared prefix was not prefilled again
    full = sum(-(-len(p) // 16) for p in ps)
    assert (eng.stats["prefill_chunks"] < full) == prefix_cache


def test_rejects_request_larger_than_pool_like_jax():
    # need_total = 3 pages > num_pages = 2: rejected by both engines (the
    # port counts the dump page's hold, num_pages - 1 = 1; JAX the pool).
    reqs = [(0, prompts(2, (20,))[0], 2), (1, prompts(3, (5,))[0], 2)]
    ecfg = dict(max_batch_size=1, page_size=8, num_pages=2, max_seq_len=64,
                prefill_pad=8)
    res_jax, res, _ = serve_both(CFG, 0, ecfg, reqs)
    assert res == res_jax and res[0] == []


def test_rejects_request_needing_the_whole_pool():
    """A request needing exactly num_pages pages can never be granted (the
    dump page holds one for good): the port rejects it, and the request
    behind it is served with the JAX engine's tokens for that request
    alone (the JAX engine would wait on the first until max_steps)."""
    big, small = prompts(4, (20, 5))
    ecfg = dict(max_batch_size=1, page_size=8, num_pages=3, max_seq_len=64,
                prefill_pad=8)
    # 20 prompt tokens + 1 decode token: ceil(21 / 8) = 3 = num_pages
    res_jax, _, _ = serve_both(CFG, 0, ecfg, [(1, small, 2)])
    jparams = init_transformer(jax.random.key(0), CFG)
    eng = port_engine(CFG, jparams, ecfg)
    eng.submit(GenerationRequest(request_id=0, prompt=big, max_new_tokens=2))
    eng.submit(GenerationRequest(request_id=1, prompt=small, max_new_tokens=2))
    res = eng.run(max_steps=50)
    assert res[0] == []
    assert res[1] == res_jax[1] and len(res[1]) == 2


@pytest.mark.parametrize("native", [False, None])
def test_allocator_matches_python_reference(native):
    """Native and Python allocators give the same chains for one sequence of
    calls (grow, adopt, pin, release_range, release_prefix, unpin)."""
    a = PageAllocator(12, native=native)
    log = []
    assert a.grow(1, 4) and a.grow(2, 3) and not a.grow(3, 9)
    log.append((a.pages(1), a.pages(2), a.free_pages()))
    assert a.adopt(3, a.pages(1)[:2])
    assert a.pin(a.pages(1)[0]) == 3
    log.append((a.pages(3), a.refcount(a.pages(1)[0])))
    assert a.release_range(1, 1, 2) == 2
    assert a.release_prefix(2, 1) == 1
    log.append((a.pages(1), a.pages(2), a.free_pages()))
    a.release(1)
    a.release(3)
    assert a.unpin(0) == 0
    log.append((a.free_pages(), a.refcount(0)))
    ref = [([0, 1, 2, 3], [4, 5, 6], 5), ([0, 1], 3), ([0, 3], [5, 6], 7),
           (10, 0)]
    assert log == ref
    with pytest.raises(KeyError):
        a.pages(99)


def test_native_allocator_builds_here():
    """g++ is present on this machine, so the port builds its own allocator
    library (never the JAX package's)."""
    a = PageAllocator(4, native=True)
    assert a.is_native
    assert "flashattention_tpu_torch" in str(a._lib._name)


def test_stochastic_sampling_is_seeded():
    """temperature/top-k decode draws from the engine's torch.Generator: the
    same seed gives the same tokens, another seed other tokens (JAX's PRNG
    stream cannot be reproduced, so there is no token-level parity)."""
    jparams = init_transformer(jax.random.key(0), CFG)
    reqs = [(i, p, 8) for i, p in enumerate(prompts(12, (6, 9, 4)))]

    def run(seed):
        eng = port_engine(CFG, jparams, dict(
            ECFG_SMALL, seed=seed,
            sampling=SamplingConfig(temperature=1.0, top_k=20)))
        for rid, p, n in reqs:
            eng.submit(GenerationRequest(rid, p, n))
        return eng.run()

    a, b, c = run(0), run(0), run(1)
    assert a == b and a != c
    assert all(len(v) == 8 and all(0 <= t < CFG.vocab_size for t in v)
               for v in a.values())


def test_engine_without_device_needs_cuda():
    jparams = init_transformer(jax.random.key(0), CFG)
    pcfg = port_config(CFG)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), pcfg,
                             device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(params, pcfg, EngineConfig())


def test_unported_options_raise():
    jparams = init_transformer(jax.random.key(0), CFG)
    pcfg = port_config(CFG)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), pcfg,
                             device="cpu")
    # quantized pages (test_torch_paged_quant.py) and speculative decoding
    # (test_torch_spec_engine.py) are ported: half-given speculative
    # options raise the JAX engine's ValueErrors
    for ecfg, kw, match in ((EngineConfig(spec_gamma=2), {}, "draft_params"),
                            (EngineConfig(), {"draft_params": params},
                             "draft_cfg")):
        with pytest.raises(ValueError, match=match):
            ServingEngine(params, pcfg, ecfg, device="cpu", **kw)


def test_import_pulls_in_no_jax():
    code = (
        "import sys, flashattention_tpu_torch, "
        "flashattention_tpu_torch.serving.engine\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'flashattention_tpu' "
        "or m.startswith('flashattention_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
