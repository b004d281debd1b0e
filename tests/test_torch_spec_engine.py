"""The port's speculative engine against the JAX package's, on the CPU.

The JAX parameter trees load into the port with ``params_from_jax``; both
engines serve the same requests in float32 (the JAX engine through its
gather executor, the port through its plain versions). Greedy tokens must
equal the JAX spec engine's and the port's plain engine's. Request sets
follow ``tests/test_serving.py``. The programs of the speculative tick
(``spec_propose``, ``verify_logits``) and the whole-prompt ``prefill`` are
held against their JAX counterparts on one cache state.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_tpu.models.transformer import init_transformer
from flashattention_tpu.serving import EngineConfig as JaxEngineConfig
from flashattention_tpu.serving import GenerationRequest as JaxRequest
from flashattention_tpu.serving import ServingEngine as JaxEngine
from flashattention_tpu.serving import engine as jax_engine
from flashattention_tpu.serving import paged_kv as jax_kv
from flashattention_tpu_torch.models.transformer import params_from_jax
from flashattention_tpu_torch.serving import (
    EngineConfig,
    GenerationRequest,
    SamplingConfig,
    ServingEngine,
)
from flashattention_tpu_torch.serving import engine as port_engine_mod
from flashattention_tpu_torch.serving.paged_kv import (
    gather_pages,
    init_paged_cache,
)
from test_torch_engine import CFG, port_config, prompts

DRAFT_CFG = dataclasses.replace(CFG, n_layers=1, d_model=32, d_ff=64,
                                n_heads=2)


@pytest.fixture(scope="module")
def jparams():
    return init_transformer(jax.random.key(0), CFG)


@pytest.fixture(scope="module")
def jdraft():
    return init_transformer(jax.random.key(1), DRAFT_CFG)


def to_port(jp, cfg):
    return params_from_jax(jax.tree.map(np.asarray, jp), port_config(cfg),
                           device="cpu")


def run_jax(jp, cfg, ecfg_kw, reqs, draft=None):
    kw = {} if draft is None else dict(draft_params=draft[0],
                                       draft_cfg=draft[1])
    eng = JaxEngine(jp, cfg, JaxEngineConfig(**ecfg_kw), **kw)
    for rid, p, n in reqs:
        eng.submit(JaxRequest(request_id=rid, prompt=p, max_new_tokens=n))
    return eng.run(), eng


def run_port(jp, cfg, ecfg_kw, reqs, draft=None, engine_hook=None):
    kw = {} if draft is None else dict(draft_params=to_port(*draft),
                                       draft_cfg=port_config(draft[1]))
    eng = ServingEngine(to_port(jp, cfg), port_config(cfg),
                        EngineConfig(**ecfg_kw), device="cpu", **kw)
    if engine_hook is not None:
        engine_hook(eng)
    for rid, p, n in reqs:
        eng.submit(GenerationRequest(request_id=rid, prompt=p,
                                     max_new_tokens=n))
    return eng.run(), eng


ECFG = dict(max_batch_size=2, page_size=8, num_pages=64, max_seq_len=128,
            prefill_pad=16)


@pytest.mark.parametrize("draft", ["random", "self"])
def test_spec_engine_matches_jax_and_plain(jparams, jdraft, draft):
    """More requests than slots (continuous admission); a random 1-layer
    draft that often disagrees, and the target as its own draft."""
    dr = (jdraft, DRAFT_CFG) if draft == "random" else (jparams, CFG)
    reqs = [(i, p, 6) for i, p in enumerate(prompts(3, (5, 11, 3, 7)))]
    ecfg = dict(ECFG, spec_gamma=3)
    res_jax, _ = run_jax(jparams, CFG, ecfg, reqs, dr)
    res, eng = run_port(jparams, CFG, ecfg, reqs, dr)
    plain, _ = run_port(jparams, CFG, ECFG, reqs)
    assert res == res_jax == plain
    assert set(res) == set(range(4))
    assert eng.spec_rounds > 0 and eng.spec_proposed > 0
    assert eng.allocator.free_pages() == ECFG["num_pages"] - 1
    # every emitted token but the first of each request came from a tick
    assert eng.stats["decode_tokens"] + 4 == sum(map(len, res.values()))
    assert eng.stats["spec_ticks"] == eng.spec_rounds
    assert eng.stats["decode_steps"] == 0 and eng.stats["spec_s"] > 0


def test_spec_engine_self_draft_accepts_everything(jparams):
    """Self-draft: every greedy proposal is accepted, gamma + 1 tokens a
    round: 1 prefill token + ceil(8 / 4) = 2 rounds."""
    ecfg = dict(ECFG, max_batch_size=1, spec_gamma=3)
    reqs = [(0, prompts(4, (6,))[0], 9)]
    res, eng = run_port(jparams, CFG, ecfg, reqs, (jparams, CFG))
    res_jax, jeng = run_jax(jparams, CFG, ecfg, reqs, (jparams, CFG))
    assert res == res_jax
    assert eng.spec_accepted == eng.spec_proposed == jeng.spec_proposed
    assert eng.spec_rounds == 2 == jeng.spec_rounds


def test_spec_engine_int8_pages_matches_jax(jparams, jdraft):
    """int8 pages for both models with gamma = 2: the verify chunk runs the
    convert schedule, the draft's decode the int8 default."""
    ecfg = dict(ECFG, max_seq_len=64, quant="int8", spec_gamma=2)
    reqs = [(i, p, 5) for i, p in enumerate(prompts(5, (6, 13)))]
    res_jax, jeng = run_jax(jparams, CFG, ecfg, reqs, (jdraft, DRAFT_CFG))
    res, eng = run_port(jparams, CFG, ecfg, reqs, (jdraft, DRAFT_CFG))
    assert res == res_jax
    assert all(len(v) == 5 for v in res.values())
    assert (eng.spec_proposed, eng.spec_accepted) == (jeng.spec_proposed,
                                                      jeng.spec_accepted)
    assert eng.draft_caches[0].quant == "int8"


def test_spec_engine_eos_truncates(jparams):
    """An EOS inside the accepted run cuts emission where the plain engine
    stops, though the speculated chunk runs past it."""
    prompt = prompts(6, (5,))[0]
    base, _ = run_port(jparams, CFG, dict(ECFG, max_batch_size=1),
                       [(0, prompt, 8)])
    eos = base[0][3]
    ecfg = dict(ECFG, max_batch_size=1, eos_token=eos)
    want, _ = run_port(jparams, CFG, ecfg, [(0, prompt, 8)])
    assert want[0][-1] == eos and len(want[0]) < 8
    spec = dict(ecfg, spec_gamma=3)
    res, _ = run_port(jparams, CFG, spec, [(0, prompt, 8)], (jparams, CFG))
    res_jax, _ = run_jax(jparams, CFG, spec, [(0, prompt, 8)], (jparams, CFG))
    assert res == want == res_jax


def test_spec_engine_sliding_window_matches_plain():
    """The verify chunk's banded attention and the reclamation of pages
    below the band: the windowed plain engine's tokens, and JAX's."""
    cfg = dataclasses.replace(CFG, attention_window=5)
    jp = init_transformer(jax.random.key(8), cfg)
    ecfg = dict(max_batch_size=2, page_size=8, num_pages=32, max_seq_len=64,
                prefill_pad=16)
    reqs = [(i, p, 8) for i, p in enumerate(prompts(9, (9, 3)))]
    want, _ = run_port(jp, cfg, ecfg, reqs)
    spec = dict(ecfg, spec_gamma=3)
    res, eng = run_port(jp, cfg, spec, reqs, (jp, cfg))
    res_jax, _ = run_jax(jp, cfg, spec, reqs, (jp, cfg))
    assert res == want == res_jax
    assert eng.allocator.free_pages() == 31


def test_spec_engine_prefix_cache_matches_uncached(jparams, jdraft):
    """Adopted prefix pages carry the draft's K/V too: the cached spec
    engine equals the uncached one and the plain engine."""
    rng = np.random.default_rng(12)
    common = [int(t) for t in rng.integers(0, CFG.vocab_size, size=24)]
    reqs = [(0, common + [int(t) for t in rng.integers(0, 89, size=7)], 6),
            (1, common + [int(t) for t in rng.integers(0, 89, size=3)], 6)]
    dr = (jdraft, DRAFT_CFG)
    res_c, eng_c = run_port(jparams, CFG,
                            dict(ECFG, prefix_cache=True, spec_gamma=3),
                            reqs, dr)
    res_u, _ = run_port(jparams, CFG, dict(ECFG, spec_gamma=3), reqs, dr)
    plain, _ = run_port(jparams, CFG, ECFG, reqs)
    assert res_c == res_u == plain
    assert len(eng_c._prefix_lru) >= 3
    # the shared prefix was prefilled once
    assert eng_c.stats["prefill_chunks"] < 4


def test_spec_engine_evicts_and_requeues_under_pool_pressure(jparams):
    """A pool too small for both sequences forces evictions through the
    speculative tick; self-draft keeps the tokens exact."""
    ecfg = dict(max_batch_size=2, page_size=8, num_pages=7, max_seq_len=32,
                prefill_pad=8, spec_gamma=2)
    reqs = [(i, p, 20) for i, p in enumerate(prompts(18, (8, 8)))]
    evictions = []

    def hook(eng):
        real = eng._evict
        eng._evict = lambda slot: (evictions.append(slot.request.request_id),
                                   real(slot))[-1]

    res, _ = run_port(jparams, CFG, ecfg, reqs, (jparams, CFG), hook)
    res_jax, _ = run_jax(jparams, CFG, ecfg, reqs, (jparams, CFG))
    plain, _ = run_port(jparams, CFG, {k: v for k, v in ecfg.items()
                                       if k != "spec_gamma"}, reqs)
    assert evictions, "pool math should have forced an eviction"
    assert res == res_jax == plain


def test_spec_grow_sheds_the_page_deficit(jparams):
    """A speculative grow needing two more pages than are free sheds two
    prefix pins and keeps the sequence (shedding one, as a plain decode
    step does, would evict it)."""
    ecfg = dict(max_batch_size=1, page_size=4, num_pages=7, max_seq_len=32,
                prefill_pad=8, prefix_cache=True, spec_gamma=7)
    a, b = prompts(21, (12, 5))
    reqs = [(0, a, 1), (1, b, 12)]
    shed, evictions = [], []

    def hook(eng):
        real_shrink, real_evict = eng._shrink_prefix_cache, eng._evict
        eng._shrink_prefix_cache = lambda n: (shed.append(n),
                                              real_shrink(n))[-1]
        eng._evict = lambda slot: (evictions.append(slot.request.request_id),
                                   real_evict(slot))[-1]

    res, _ = run_port(jparams, CFG, ecfg, reqs, (jparams, CFG), hook)
    res_jax, _ = run_jax(jparams, CFG, ecfg, reqs, (jparams, CFG))
    plain, _ = run_port(jparams, CFG, dict(ecfg, prefix_cache=False,
                                           spec_gamma=0), reqs)
    assert max(shed) >= 2 and not evictions
    assert res == res_jax == plain and len(res[1]) == 12


def test_spec_engine_reaches_max_seq_len():
    """A slot driven to max_seq_len: its last ticks draft and verify rows
    past the position table (clamped, never accepted) and past the page
    capacity (dropped by the append)."""
    cfg = dataclasses.replace(CFG, max_seq_len=64)
    jp = init_transformer(jax.random.key(4), cfg)
    ecfg = dict(max_batch_size=2, page_size=8, num_pages=32, max_seq_len=64,
                prefill_pad=16, spec_gamma=4)
    reqs = [(0, prompts(22, (40,))[0], 24), (1, prompts(23, (9,))[0], 55)]
    res, eng = run_port(jp, cfg, ecfg, reqs, (jp, cfg))
    res_jax, _ = run_jax(jp, cfg, ecfg, reqs, (jp, cfg))
    plain, _ = run_port(jp, cfg, dict(ecfg, spec_gamma=0), reqs)
    assert res == res_jax == plain
    assert [len(res[0]), len(res[1])] == [24, 55]


def test_embed_clamps_positions_past_the_table(jparams):
    """Rows at or past max_seq_len read the table's last row, as JAX's
    gather clamps (PyTorch indexing would raise)."""
    w = port_engine_mod._serving_weights(to_port(jparams, CFG),
                                         port_config(CFG), "cpu")
    pcfg = port_config(CFG)
    tok = torch.tensor([[3, 4]])
    x = port_engine_mod._embed_positions(w, tok, pcfg,
                                         torch.tensor([[126, 200]]))
    y = port_engine_mod._embed_positions(w, tok, pcfg,
                                         torch.tensor([[126, 127]]))
    assert torch.equal(x, y)
    z = port_engine_mod._embed_decode(w, tok[:, :1], pcfg,
                                      torch.tensor([130], dtype=torch.int32))
    last = port_engine_mod._embed_positions(w, tok[:, :1], pcfg,
                                            torch.tensor([[127]]))
    assert torch.equal(z, last)


def test_spec_engine_stochastic_is_seeded_and_self_draft_accepts(jparams,
                                                                  jdraft):
    """Sampled speculation: exact token counts, the same tokens under one
    seed and other tokens under another, and a self-draft accepting nearly
    every proposal (q equals p up to rounding)."""
    ecfg = dict(ECFG, spec_gamma=3, seed=7,
                sampling=SamplingConfig(temperature=0.8, top_k=20))
    reqs = [(i, p, 7) for i, p in enumerate(prompts(11, (5, 9)))]
    res, eng = run_port(jparams, CFG, ecfg, reqs, (jdraft, DRAFT_CFG))
    again, _ = run_port(jparams, CFG, ecfg, reqs, (jdraft, DRAFT_CFG))
    other, _ = run_port(jparams, CFG, dict(ecfg, seed=8), reqs,
                        (jdraft, DRAFT_CFG))
    assert res == again and res != other
    assert all(len(v) == 7 and all(0 <= t < CFG.vocab_size for t in v)
               for v in res.values())
    assert eng.spec_rounds > 0 and eng.spec_proposed > 0
    selfd, eng3 = run_port(jparams, CFG, ecfg, reqs, (jparams, CFG))
    assert all(len(v) == 7 for v in selfd.values())
    assert eng3.spec_accepted / eng3.spec_proposed > 0.8


@pytest.mark.parametrize("case", ["gamma0", "no_draft_cfg", "vocab",
                                  "gamma_without_draft"])
def test_spec_engine_validation(jparams, jdraft, case):
    params, pcfg = to_port(jparams, CFG), port_config(CFG)
    draft, dcfg = to_port(jdraft, DRAFT_CFG), port_config(DRAFT_CFG)
    ecfg, kw, match = {
        "gamma0": (EngineConfig(spec_gamma=0),
                   dict(draft_params=draft, draft_cfg=dcfg), "spec_gamma"),
        "no_draft_cfg": (EngineConfig(spec_gamma=2),
                         dict(draft_params=draft), "draft_cfg"),
        "vocab": (EngineConfig(spec_gamma=2),
                  dict(draft_params=draft,
                       draft_cfg=dataclasses.replace(dcfg, vocab_size=90)),
                  "vocabulary"),
        "gamma_without_draft": (EngineConfig(spec_gamma=2), {},
                                "requires draft_params"),
    }[case]
    with pytest.raises(ValueError, match=match):
        ServingEngine(params, pcfg, ecfg, device="cpu", **kw)


# -- the programs of one tick, against JAX's on one cache state ------------


def _slots_state(jp, cfg, sizes, seed, pps=8, page=8):
    """Prompts of ``sizes`` prefilled into paged caches by JAX's
    whole-prompt prefill and the port's, each slot on its own pages.
    Returns (jax caches, port caches, port weights, page table (B, pps),
    lengths (B,), the two prefills' next tokens)."""
    pcfg, w = port_config(cfg), None
    w = port_engine_mod._serving_weights(to_port(jp, cfg), pcfg, "cpu")
    n_pages = len(sizes) * pps + 1
    jc = [jax_kv.init_paged_cache(cfg.kv_heads, n_pages, page, cfg.d_head,
                                  dtype=jnp.float32)
          for _ in range(cfg.n_layers)]
    pc = [init_paged_cache(cfg.kv_heads, n_pages, page, cfg.d_head,
                           dtype=torch.float32, device="cpu")
          for _ in range(cfg.n_layers)]
    jprefill = jax_engine.make_prefill_fn(cfg)
    pi = (np.random.default_rng(seed).permutation(n_pages - 1)[
        : len(sizes) * pps] + 1).reshape(len(sizes), pps).astype(np.int32)
    firsts = []
    for b, p in enumerate(prompts(seed, sizes, cfg.vocab_size)):
        toks = np.zeros((1, 32), np.int32)
        toks[0, :len(p)] = p
        jt, jc = jprefill(jp, jc, jnp.asarray(toks), jnp.asarray(pi[b:b + 1]),
                          jnp.int32(len(p)))
        pt = port_engine_mod.prefill(w, pcfg, pc,
                                     torch.from_numpy(toks).long(),
                                     torch.from_numpy(pi[b:b + 1]), len(p))
        firsts.append((int(jt[0]), int(pt[0])))
    lengths = np.asarray(sizes, np.int32)
    return jc, pc, w, pi, lengths, firsts


def _pages_close(jc, pc, pi):
    for a, b in zip(jc, pc):
        ja = [np.asarray(x) for x in jax_kv.gather_pages(a, jnp.asarray(pi))]
        pb = [x.numpy() for x in gather_pages(b, torch.from_numpy(pi))]
        for x, y in zip(ja, pb):
            np.testing.assert_allclose(y, x, rtol=1e-4, atol=1e-4)


def test_prefill_matches_jax(jparams):
    """``prefill`` (the tiled executor over the whole prompt) gives JAX's
    next token and its cache, for GQA too."""
    cfg = dataclasses.replace(CFG, n_kv_heads=2)
    jp = init_transformer(jax.random.key(2), cfg)
    jc, pc, _, pi, _, firsts = _slots_state(jp, cfg, (13, 5, 20), seed=30)
    assert all(a == b for a, b in firsts)
    _pages_close(jc, pc, pi)


def test_verify_and_propose_match_jax(jparams):
    """One tick's programs on one cache state: ``spec_propose`` gives JAX's
    greedy proposals, ``verify_logits`` JAX's verify tokens, both caches
    stay equal, and the verify rows equal the port's one-token decode
    steps (the chunk property the tick relies on)."""
    g = 3
    jc, pc, w, pi, lengths, firsts = _slots_state(jparams, CFG, (13, 5, 30),
                                                  seed=31)
    pcfg = port_config(CFG)
    last = np.asarray([[f[0]] for f in firsts], np.int32)
    jd, jdc = jax_engine.make_spec_propose_fn(CFG, g)(
        jparams, jax.tree.map(jnp.copy, jc), jnp.asarray(last),
        jnp.asarray(pi),
        jnp.asarray(lengths))
    # the draft is the target itself here: propose into a copy of the cache
    pd = [dataclasses.replace(c, k_pages=c.k_pages.clone(),
                              v_pages=c.v_pages.clone()) for c in pc]
    tok = torch.from_numpy(last).long()
    pit, lnt = torch.from_numpy(pi), torch.from_numpy(lengths)
    drafts, q_dist = port_engine_mod.spec_propose(w, pcfg, pd, tok, pit, lnt,
                                                  g)
    assert drafts.shape == (3, g) and q_dist is None
    np.testing.assert_array_equal(drafts.numpy(), np.asarray(jd))
    _pages_close(jdc, pd, pi)

    chunk = np.concatenate([last, np.asarray(jd)], axis=1)
    jt, jc2 = jax_engine.make_spec_verify_fn(CFG)(
        jparams, jc, jnp.asarray(chunk), jnp.asarray(pi), jnp.asarray(lengths))
    steps = [dataclasses.replace(c, k_pages=c.k_pages.clone(),
                                 v_pages=c.v_pages.clone()) for c in pc]
    logits = port_engine_mod.verify_logits(
        w, pcfg, pc, torch.from_numpy(chunk).long(), pit, lnt)
    assert logits.shape == (3, g + 1, CFG.vocab_size)
    assert logits.dtype == torch.float32
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), np.asarray(jt))
    _pages_close(jc2, pc, pi)
    rows = [port_engine_mod.decode_logits(
        w, pcfg, steps, torch.from_numpy(chunk[:, t:t + 1]).long(), pit,
        lnt + t) for t in range(g + 1)]
    np.testing.assert_allclose(logits.numpy(), torch.stack(rows, 1).numpy(),
                               rtol=1e-4, atol=1e-4)
