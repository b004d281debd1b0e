"""The port's quantized paged cache against the JAX package: int8, e4m3 and
e5m2 payloads with per-slot fp32 scales.

- ``init_paged_cache(quant=...)`` and ``append_to_pages`` (the append
  kernel's plain version, T = 1 and T > 1, tokens also as strided views of
  a fused projection in bf16 and fp32): payload bytes and scales bit-equal
  to JAX's;
- the plain quantized paged attention against ``pallas_paged_attention``
  (interpret mode) with float32 compute at the fp32 rung (1e-4), and with
  bf16 compute at the bf16 rung (5e-2; JAX's e4m3 decode there flushes
  denormal payloads to zero, the port's is exact);
- the int8 schedules "qk" and "full" (JAX's ``FAT_PAGED_INT8_MXU``);
- the port's CPU float32 engine with ``quant`` against the JAX CPU engine:
  equal greedy tokens, first-token logits at 1e-4; with
  ``EngineConfig(int8_qk=...)`` against the JAX engine on its Pallas paged
  kernel (interpret mode) under the matching ``FAT_PAGED_INT8_MXU``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_tpu.models.transformer import _layer_norm
from flashattention_tpu.models.transformer import init_transformer
from flashattention_tpu.ops.pallas_paged import pallas_paged_attention
from flashattention_tpu.serving import EngineConfig as JaxEngineConfig
from flashattention_tpu.serving import GenerationRequest as JaxRequest
from flashattention_tpu.serving import ServingEngine as JaxEngine
from flashattention_tpu.serving.engine import (
    _lm_logits,
    make_chunk_prefill_fn,
    make_decode_fn,
)
from flashattention_tpu.serving.paged_kv import (
    append_to_pages as jax_append_to_pages,
)
from flashattention_tpu.serving.paged_kv import init_paged_cache as jax_init
from flashattention_tpu_torch.ops import paged_append as pap
from flashattention_tpu_torch.ops import paged_attention as pa
from flashattention_tpu_torch.ops.quant import PAYLOAD_DTYPE, quantize_tokens
from flashattention_tpu_torch.serving import GenerationRequest, paged_kv
from flashattention_tpu_torch.serving import engine as engine_mod
from flashattention_tpu_torch.utils.testing import assert_allclose
from test_torch_cuda import CASES, fused_tokens, paged_inputs
from test_torch_engine import CFG, port_engine, prompts

QUANTS = ["int8", "fp8", "e5m2"]
JAX_DTYPE = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn,
             "e5m2": jnp.float8_e5m2}


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _assert_cache_equal(tc, jc, err=""):
    for name in ("k_pages", "v_pages"):
        np.testing.assert_array_equal(_bytes(getattr(tc, name)),
                                      _bytes(getattr(jc, name)), err_msg=err)
    for name in ("k_scales", "v_scales"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)),
                                      err_msg=err)


@pytest.mark.parametrize("quant", QUANTS)
def test_init_paged_cache(quant):
    tc = paged_kv.init_paged_cache(2, 5, 8, 16, quant=quant, device="cpu")
    jc = jax_init(2, 5, 8, 16, quant=quant)
    assert tc.k_pages.dtype == PAYLOAD_DTYPE[quant] and tc.quant == quant
    assert tc.k_scales.shape == (2, 5, 8, 1)
    assert tc.k_scales.dtype == torch.float32
    _assert_cache_equal(tc, jc)
    with pytest.raises(ValueError, match="quant"):
        paged_kv.init_paged_cache(2, 5, 8, 16, quant="int4", device="cpu")


@pytest.mark.parametrize("quant", QUANTS)
# JAX: scatter (16, 264), Pallas (128, 384, 512)
@pytest.mark.parametrize("d", [16, 128, 264, 384, 512])
def test_decode_append_bit_equal(quant, d):
    b, h, page, pps = 5, 2, 8, 3
    num_pages = b * pps + 1
    rng = np.random.default_rng(0)
    pi = rng.permutation(num_pages)[: b * pps].reshape(b, pps).astype(np.int32)
    lengths = np.array([0, 7, 23, 24, 11], np.int32)  # row 3 is full: drops
    valid = np.array([1, 1, 1, 1, 0], np.int32)       # row 4 writes nothing
    kn = rng.standard_normal((b, h, 1, d)).astype(np.float32) * 3
    vn = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    jc = jax_init(h, num_pages, page, d, quant=quant)
    jc = jax_append_to_pages(jc, jnp.asarray(kn), jnp.asarray(vn),
                             jnp.asarray(pi), jnp.asarray(lengths),
                             jnp.asarray(valid))
    tc = paged_kv.init_paged_cache(h, num_pages, page, d, quant=quant,
                                   device="cpu")
    before = pap.paged_append.launches
    paged_kv.append_to_pages(tc, *(torch.from_numpy(x) for x in
                                   (kn, vn, pi, lengths, valid)))
    assert pap.paged_append.launches == before  # CPU: the plain version
    _assert_cache_equal(tc, jc, quant)


@pytest.mark.parametrize("quant", QUANTS)
def test_prefill_append_bit_equal(quant):
    b, h, t, d, page, pps = 3, 2, 12, 16, 4, 3
    rng = np.random.default_rng(1)
    num_pages = b * pps + 2
    pi = rng.permutation(num_pages)[: b * pps].reshape(b, pps).astype(np.int32)
    lengths = np.array([0, 7, 2], np.int32)   # row 1 overruns: writes drop
    valid = np.array([12, 12, 5], np.int32)   # row 2: padding drops
    kn = rng.standard_normal((b, h, t, d)).astype(np.float32)
    vn = rng.standard_normal((b, h, t, d)).astype(np.float32) * 1e-3
    jc = jax_append_to_pages(jax_init(h, num_pages, page, d, quant=quant),
                             *(jnp.asarray(x) for x in
                               (kn, vn, pi, lengths, valid)))
    tc = paged_kv.init_paged_cache(h, num_pages, page, d, quant=quant,
                                   device="cpu")
    paged_kv.append_to_pages(tc, *(torch.from_numpy(x) for x in
                                   (kn, vn, pi, lengths, valid)))
    _assert_cache_equal(tc, jc, quant)


@pytest.mark.parametrize("t", [1, 6])
@pytest.mark.parametrize("src", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("quant", QUANTS)
def test_fused_projection_append_bit_equal(quant, src, t):
    """Tokens as the head views of a fused QKV projection, bf16 or fp32,
    into 1-byte pages: payloads and scales bit-equal to JAX's jitted
    ``append_to_pages`` (D = 128: T = 1 runs its Pallas append in interpret
    mode), padding and over-capacity positions dropped, scales included."""
    b, h, d, page, pps = 4, 2, 128, 4, 3
    num_pages = b * pps + 1
    rng = np.random.default_rng(20 + t)
    k, v = fused_tokens(rng, b, h, t, d, src)
    pi = rng.permutation(num_pages)[: b * pps].reshape(b, pps).astype(np.int32)
    lengths = np.array([0, 5, 12, 9], np.int32)   # row 2 full; row 3 overruns
    valid = np.array([t, t, t, 0 if t == 1 else 4], np.int32)
    jdt = jnp.bfloat16 if src == torch.bfloat16 else jnp.float32
    jc = jax_append_to_pages(
        jax_init(h, num_pages, page, d, quant=quant),
        *(jnp.asarray(x.float().numpy()).astype(jdt) for x in (k, v)),
        jnp.asarray(pi), jnp.asarray(lengths), jnp.asarray(valid))
    tc = paged_kv.init_paged_cache(h, num_pages, page, d, quant=quant,
                                   device="cpu")
    paged_kv.append_to_pages(tc, k, v, torch.from_numpy(pi),
                             torch.from_numpy(lengths),
                             torch.from_numpy(valid))
    _assert_cache_equal(tc, jc, quant)
    kept = sum(max(0, min(int(n), pps * page - int(ln)))
               for ln, n in zip(lengths, valid))
    assert int((tc.k_scales != 1).sum()) == kept * h


def _quantized(kp, vp, quant):
    """Pages of noise as (payload, scales) pairs, numpy and torch alike."""
    out = []
    for x in (kp, vp):
        p, s = quantize_tokens(torch.from_numpy(x), quant)
        out.append((p, s[..., None].contiguous()))
    return out


def _run_both(case, quant, q_dtype, jax_kw=None, port_kw=None):
    shape, kw = CASES[case]
    q, kp, vp, pi, ln = paged_inputs(**shape)
    (k8, ks), (v8, vs) = _quantized(kp, vp, quant)
    jq = jnp.asarray(q).astype(q_dtype)
    o_jax = pallas_paged_attention(
        jq, jnp.asarray(_bytes(k8)).view(JAX_DTYPE[quant]),
        jnp.asarray(_bytes(v8)).view(JAX_DTYPE[quant]), jnp.asarray(pi),
        jnp.asarray(ln), k_scales=jnp.asarray(ks.numpy()),
        v_scales=jnp.asarray(vs.numpy()), interpret=True,
        compute_dtype=q_dtype, **kw, **(jax_kw or {}))
    tq = torch.from_numpy(q).to(
        torch.bfloat16 if q_dtype == jnp.bfloat16 else torch.float32)
    o = pa.paged_attention(tq, k8, v8, torch.from_numpy(pi),
                           torch.from_numpy(ln), k_scales=ks, v_scales=vs,
                           **kw, **(port_kw or {}))
    assert o.dtype == tq.dtype and o.shape == tq.shape
    return o, np.asarray(o_jax.astype(jnp.float32))


QCASES = ["decode_p16", "decode_p8", "chunk_p16", "gqa_decode",
          "window_sinks_decode", "window_sinks_chunk", "softcap",
          "empty_decode"]


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("case", QCASES)
def test_quantized_plain_matches_pallas_fp32(case, quant):
    o, o_jax = _run_both(case, quant, jnp.float32)
    assert_allclose(o, o_jax, rtol=1e-4, atol=1e-4, err_msg=f"{case} {quant}")


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("case", ["decode_p16", "chunk_p16"])
def test_quantized_plain_matches_pallas_bf16(case, quant):
    """bf16 compute: JAX's default; int8 decode takes the int8-qk schedule
    on both sides (q_len 1, page 16)."""
    o, o_jax = _run_both(case, quant, jnp.bfloat16)
    assert_allclose(o, o_jax, rtol=5e-2, atol=5e-2, err_msg=f"{case} {quant}")


@pytest.mark.parametrize("quant, case", [
    ("int8", "mqa_d256_decode"), ("fp8", "mqa_d256_decode"),
    ("fp8", "mqa_d256_chunk_window_sinks_softcap"),
    ("e5m2", "mqa_d256_chunk_window_sinks_softcap"),
    ("int8", "gqa_d192_decode"), ("int8", "mqa_d512_decode"),
    ("fp8", "mqa_d512_decode"), ("fp8", "mqa_d512_chunk"),
    ("int8", "gqa_d264_chunk_window_sinks_softcap"),
    ("fp8", "gqa_d264_chunk_window_sinks_softcap")])
def test_d256_quantized_plain_matches_pallas_fp32(case, quant):
    """Head dims above 128 over 1-byte pages (Gemma 2B's MQA at D = 256,
    GQA at D = 192): the convert path at the fp32 rung."""
    o, o_jax = _run_both(case, quant, jnp.float32)
    assert_allclose(o, o_jax, rtol=1e-4, atol=1e-4, err_msg=f"{case} {quant}")


@pytest.mark.parametrize("mode, env", [("qk", "qk"), ("full", "full"),
                                       (False, "0")])
@pytest.mark.parametrize("case", ["decode_p16", "chunk_p16", "gqa_decode",
                                  "window_sinks_chunk", "mqa_d256_decode",
                                  "mqa_d512_decode", "mqa_d512_chunk"])
def test_int8_schedules_match_pallas(monkeypatch, case, mode, env):
    monkeypatch.setenv("FAT_PAGED_INT8_MXU", env)
    o, o_jax = _run_both(case, "int8", jnp.float32,
                         port_kw=dict(int8_qk=mode))
    assert_allclose(o, o_jax, rtol=1e-4, atol=1e-4, err_msg=f"{case} {mode}")


def test_int8_default_rule():
    kp = torch.zeros(1, 2, 16, 8, dtype=torch.int8)
    assert pa.int8_mode(kp, torch.bfloat16, 1, None) == "qk"
    assert pa.int8_mode(kp, torch.float32, 1, None) == "convert"
    assert pa.int8_mode(kp, torch.bfloat16, 4, None) == "convert"
    assert pa.int8_mode(kp[:, :, :8], torch.bfloat16, 1, None) == "convert"
    assert pa.int8_mode(kp[:, :, :8], torch.float32, 1, "full") == "convert"
    assert pa.int8_mode(kp, torch.float32, 4, "full") == "full"
    assert pa.int8_mode(kp.view(torch.float8_e4m3fn), torch.bfloat16, 1,
                        True) == "convert"
    with pytest.raises(ValueError, match="int8_qk"):
        pa.int8_mode(kp, torch.float32, 1, "turbo")


@pytest.mark.parametrize("quant", QUANTS)
def test_gather_executor_dequantizes(quant):
    """paged_attention_decode (the fp32 gather oracle) on a quantized
    cache equals the plain kernel version with fp32 compute."""
    shape, kw = CASES["gqa_decode"]
    q, kp, vp, pi, ln = paged_inputs(**shape)
    (k8, ks), (v8, vs) = _quantized(kp, vp, quant)
    cache = paged_kv.PagedKVCache(k8, v8, ks, vs, quant)
    o = paged_kv.paged_attention_decode(torch.from_numpy(q), cache,
                                        torch.from_numpy(pi),
                                        torch.from_numpy(ln), **kw)
    ref = pa.paged_attention(torch.from_numpy(q), k8, v8, torch.from_numpy(pi),
                             torch.from_numpy(ln), k_scales=ks, v_scales=vs,
                             **kw)
    assert_allclose(o, ref, rtol=1e-5, atol=1e-5)


def _jax_engine_with_logits(jparams, ecfg_kw, reqs):
    """The JAX CPU engine; records each admission's first-token logits."""
    jeng = JaxEngine(jparams, CFG, JaxEngineConfig(**ecfg_kw))
    logits = []

    def sample_last(params, x, idx):
        xl = _layer_norm(x, params["final_ln"])[:, idx: idx + 1]
        lg = _lm_logits(params, xl)[:, 0]
        logits.append(np.asarray(lg))
        return jnp.argmax(lg, axis=-1)

    jeng._sample_last = sample_last
    for rid, prompt, n in reqs:
        jeng.submit(JaxRequest(request_id=rid, prompt=prompt,
                               max_new_tokens=n))
    return jeng.run(), logits


@pytest.mark.parametrize("quant", QUANTS)
def test_engine_quantized_matches_jax(quant):
    """The port's CPU fp32 engine with quantized pages, continuous batching
    and chunked prefill, against the JAX CPU engine."""
    reqs = [(i, p, 6) for i, p in enumerate(prompts(3, (5, 21, 40)))]
    ecfg = dict(max_batch_size=2, page_size=8, num_pages=48, max_seq_len=64,
                prefill_pad=16, quant=quant)
    jparams = init_transformer(jax.random.key(0), CFG)
    res_jax, logits_jax = _jax_engine_with_logits(jparams, ecfg, reqs)
    eng = port_engine(CFG, jparams, ecfg)
    assert eng.caches[0].k_pages.dtype == PAYLOAD_DTYPE[quant]
    logits = []
    select = eng._select

    def record(lg):  # admissions select from (1, V), decode from (2, V)
        if lg.shape[0] == 1:
            logits.append(lg)
        return select(lg)

    eng._select = record
    for rid, prompt, n in reqs:
        eng.submit(GenerationRequest(rid, prompt, n))
    assert eng.run() == res_jax
    assert len(logits) == len(logits_jax) == len(reqs)
    for got, want in zip(logits, logits_jax):
        assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("int8_qk, env", [("full", "full"), ("qk", "qk"),
                                          (False, "0")])
def test_engine_int8_schedule_matches_jax(monkeypatch, int8_qk, env):
    """EngineConfig(int8_qk=...) reaches every paged call of the port's
    engine, prefill chunks included, as FAT_PAGED_INT8_MXU reaches every
    call of the JAX engine's Pallas paged kernel (its CPU engine gathers
    pages instead, which ignores the knob, so its programs are rebuilt on
    the kernel, run in interpret mode). Page 16: either int8 schedule
    needs page % 16 == 0. Greedy tokens equal; every paged call of the
    port's engine takes the requested schedule."""
    monkeypatch.setenv("FAT_PAGED_INT8_MXU", env)
    reqs = [(i, p, 5) for i, p in enumerate(prompts(11, (7, 19)))]
    ecfg = dict(max_batch_size=2, page_size=16, num_pages=16, max_seq_len=64,
                prefill_pad=16, quant="int8")
    jparams = init_transformer(jax.random.key(3), CFG)
    jeng = JaxEngine(jparams, CFG, JaxEngineConfig(**ecfg))
    jeng._chunk_prefill = make_chunk_prefill_fn(CFG, ecfg["prefill_pad"],
                                                use_pallas=True)
    jeng._decode = make_decode_fn(CFG, use_pallas=True)
    for rid, prompt, n in reqs:
        jeng.submit(JaxRequest(request_id=rid, prompt=prompt,
                               max_new_tokens=n))
    res_jax = jeng.run()
    eng = port_engine(CFG, jparams, dict(ecfg, int8_qk=int8_qk))
    modes = []
    real = pa.paged_attention

    def record(q, k_pages, *args, **kw):
        t = 1 if q.dim() == 3 else q.shape[2]
        modes.append(pa.int8_mode(k_pages, q.dtype, t, kw["int8_qk"]))
        return real(q, k_pages, *args, **kw)

    monkeypatch.setattr(engine_mod, "paged_attention", record)
    for rid, prompt, n in reqs:
        eng.submit(GenerationRequest(rid, prompt, n))
    assert eng.run() == res_jax
    want = {"full": "full", "qk": "qk", False: "convert"}[int8_qk]
    assert modes and set(modes) == {want}


def test_engine_int8_qk_is_checked():
    jparams = init_transformer(jax.random.key(3), CFG)
    with pytest.raises(ValueError, match="int8_qk"):
        port_engine(CFG, jparams, dict(quant="int8", int8_qk="turbo"))


@pytest.mark.parametrize("quant", ["fp8"])
def test_engine_quantized_d256_mqa_matches_jax(quant):
    """Head dim 256 with one KV head (Gemma 2B's attention shape at 2
    query heads) over e4m3 pages: the port's CPU fp32 engine against the
    JAX CPU engine, greedy tokens and first-token logits."""
    import dataclasses

    cfg = dataclasses.replace(CFG, d_model=512, n_heads=2, n_kv_heads=1,
                              d_ff=512, pos_encoding="rope")
    reqs = [(i, p, 5) for i, p in enumerate(prompts(10, (9, 26)))]
    ecfg = dict(max_batch_size=2, page_size=16, num_pages=16, max_seq_len=64,
                prefill_pad=16, quant=quant)
    jparams = init_transformer(jax.random.key(2), cfg)
    jeng = JaxEngine(jparams, cfg, JaxEngineConfig(**ecfg))
    for rid, prompt, n in reqs:
        jeng.submit(JaxRequest(request_id=rid, prompt=prompt,
                               max_new_tokens=n))
    res_jax = jeng.run()
    eng = port_engine(cfg, jparams, ecfg)
    assert eng.caches[0].k_pages.shape[-1] == 256
    for rid, prompt, n in reqs:
        eng.submit(GenerationRequest(rid, prompt, n))
    assert eng.run() == res_jax


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_quantized_window_sinks_and_prefix_cache_match_jax(quant):
    """quant composes with the sliding window + sinks (mid-chain page
    reclamation) and with the prefix cache, as in the JAX engine."""
    import dataclasses

    from test_torch_engine import serve_both

    cfg = dataclasses.replace(CFG, attention_window=24, attention_sinks=8,
                              n_kv_heads=2)
    prompt = prompts(7, (20,))[0]
    ecfg = dict(max_batch_size=1, page_size=8, num_pages=8, max_seq_len=128,
                prefill_pad=16, quant=quant)
    res_jax, res, eng = serve_both(cfg, 0, ecfg, [(0, prompt, 30)])
    assert res == res_jax and len(res[0]) == 30
    assert eng._evicted_prefix == {}
    shared = prompts(8, (24,))[0]
    reqs = [(i, shared + p, 4) for i, p in enumerate(prompts(9, (3, 5, 2)))]
    ecfg = dict(max_batch_size=1, page_size=8, num_pages=32, max_seq_len=64,
                prefill_pad=16, prefix_cache=True, quant=quant)
    res_jax, res, eng = serve_both(CFG, 0, ecfg, reqs)
    assert res == res_jax
    assert eng.stats["prefill_chunks"] < 2 * len(reqs)  # prefixes reused
