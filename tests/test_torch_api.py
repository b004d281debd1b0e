"""The port's attention API against the JAX package's: the routing rules of
``ops/api.py`` (backend names mapped: kernel <-> pallas in interpret mode,
tiled <-> xla, reference <-> reference), errors, the generation entry
points, ALiBi slopes and the packed wrappers. CPU, float32, tolerance 1e-4.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_tpu.ops import api as japi
from flashattention_tpu_torch.ops import api
from flashattention_tpu_torch.ops import flash_attn as fa
from flashattention_tpu_torch.utils.testing import assert_allclose

TOL = 1e-4
JAX_BACKEND = {"kernel": "pallas", "tiled": "xla", "reference": "reference"}


def _qkv(b=2, h=4, h_kv=4, n=48, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((b, h, n, d), (b, h_kv, n, d), (b, h_kv, n, d))]


ROUTES = {
    # name: (kwargs, backends, shape overrides)
    "causal": (dict(causal=True), ("kernel", "tiled", "reference"), {}),
    "gqa": (dict(causal=True), ("kernel", "tiled", "reference"),
            dict(h_kv=2)),
    "window_sinks": (dict(causal=True, window=11, sinks=2),
                     ("kernel", "tiled", "reference"), dict(h_kv=2)),
    "segments": (dict(causal=True, segments=True),
                 ("kernel", "tiled", "reference"), {}),
    "mask": (dict(causal=True, mask=True), ("kernel", "tiled", "reference"),
             dict(h_kv=2)),
    "softcap": (dict(causal=True, softcap=3.0), ("kernel", "tiled",
                                                 "reference"), {}),
    "alibi": (dict(causal=True, alibi=True), ("kernel", "tiled", "reference"),
              {}),
    "q_offset": (dict(causal=True, q_offset=-3), ("kernel", "tiled",
                                                  "reference"), {}),
}


def _route_kwargs(kw, b, h, n):
    kw = dict(kw)
    jkw, tkw = dict(kw), dict(kw)
    if kw.pop("segments", False):
        ids = np.repeat(np.arange(3), -(-n // 3))[None, :n].repeat(b, 0)
        ids = ids.astype(np.int32)
        for d in (jkw, tkw):
            d.pop("segments")
        jkw["segment_ids"], tkw["segment_ids"] = jnp.asarray(ids), torch.from_numpy(ids)
    if kw.pop("mask", False):
        m = np.random.default_rng(7).random((n, n)) < 0.8
        m[:, 0] = True
        jkw["mask"], tkw["mask"] = jnp.asarray(m), torch.from_numpy(m)
    if kw.pop("alibi", False):
        for d in (jkw, tkw):
            d.pop("alibi")
        jkw["alibi_slopes"] = japi.alibi_slopes(h)
        tkw["alibi_slopes"] = api.alibi_slopes(h)
    return jkw, tkw


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_flash_attention_routes_match_jax(route):
    kw, backends, shape = ROUTES[route]
    q, k, v = _qkv(**shape)
    b, h, n = q.shape[0], q.shape[1], q.shape[2]
    jkw, tkw = _route_kwargs(kw, b, h, n)
    for backend in backends:
        o, lse = japi.flash_attention(
            *[jnp.asarray(x) for x in (q, k, v)], backend=JAX_BACKEND[backend],
            interpret=True, block_q=32, block_k=32, **jkw)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            to, tl = api.flash_attention(
                *[torch.from_numpy(x) for x in (q, k, v)], backend=backend,
                block_k=32, **tkw)
        assert_allclose(to, np.asarray(o), rtol=TOL, atol=TOL,
                        err_msg=f"{route} {backend} o")
        seen = np.asarray(lse) > -1e30
        assert_allclose(tl.numpy()[seen], np.asarray(lse)[seen], rtol=TOL,
                        atol=TOL, err_msg=f"{route} {backend} lse")


def test_auto_is_the_kernel_path_and_mask_warns():
    q, k, v = [torch.from_numpy(x) for x in _qkv()]
    o_auto, _ = api.flash_attention(q, k, v, causal=True)
    o_kernel, _ = fa.kernel_attention(q, k, v, causal=True)
    assert torch.equal(o_auto, o_kernel)
    with pytest.warns(UserWarning, match="tiled executor"):
        api.flash_attention(q, k, v, backend="kernel",
                            mask=torch.ones(48, 48, dtype=torch.bool))


@pytest.mark.parametrize("bad", ["backend", "window", "sinks", "ref_dropout",
                                 "alibi_window", "no_seed"])
def test_routing_errors(bad):
    q, k, v = [torch.from_numpy(x) for x in _qkv()]
    kw = {"backend": dict(backend="xla"),
          "window": dict(window=4),
          "sinks": dict(causal=True, sinks=2),
          "ref_dropout": dict(backend="reference", dropout_rate=0.1,
                              dropout_seed=1),
          "alibi_window": dict(backend="tiled", causal=True, window=4,
                               alibi_slopes=api.alibi_slopes(4)),
          "no_seed": dict(dropout_rate=0.1)}[bad]
    with pytest.raises(ValueError) as err:
        api.flash_attention(q, k, v, **kw)
    if bad == "backend":
        for name in api.BACKENDS:
            assert name in str(err.value)


def test_dropout_seed_from_a_generator():
    q, k, v = [torch.from_numpy(x) for x in _qkv()]
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    o1, _ = api.flash_attention(q, k, v, causal=True, dropout_rate=0.2,
                                generator=g1)
    o2, _ = api.flash_attention(q, k, v, causal=True, dropout_rate=0.2,
                                generator=g2)
    o3, _ = api.flash_attention(q, k, v, causal=True, dropout_rate=0.2,
                                generator=g1)
    assert torch.equal(o1, o2)
    assert not torch.equal(o1, o3)
    seed = int(torch.randint(0, 2 ** 32, (1,), dtype=torch.int64,
                             generator=torch.Generator().manual_seed(5)))
    o4, _ = api.flash_attention(q, k, v, causal=True, dropout_rate=0.2,
                                dropout_seed=seed)
    assert torch.equal(o1, o4)


@pytest.mark.parametrize("gen", ["fa1", "fa2", "fa3"])
def test_generation_entry_points(gen):
    q, k, v = _qkv()
    fn, jfn = getattr(api, f"{gen}_attention"), getattr(japi, f"{gen}_attention")
    o, lse = fn(*[torch.from_numpy(x) for x in (q, k, v)], causal=True)
    jo, jl = jfn(*[jnp.asarray(x) for x in (q, k, v)], causal=True,
                 backend="xla")
    assert_allclose(o, np.asarray(jo), rtol=TOL, atol=TOL)
    assert_allclose(lse, np.asarray(jl), rtol=TOL, atol=TOL)
    if gen == "fa3":  # the 8-bit path (parity: test_torch_fp8_attn.py)
        o8, _ = fn(*[torch.from_numpy(x) for x in (q, k, v)], causal=True,
                   fp8=True)
        assert o8.shape == o.shape and torch.isfinite(o8).all()
        assert_allclose(o8, o, rtol=1e-1, atol=1e-1)  # the FP8 rung


@pytest.mark.parametrize("n_heads", [1, 4, 8, 12, 20])
def test_alibi_slopes_match_jax(n_heads):
    assert_allclose(api.alibi_slopes(n_heads),
                    np.asarray(japi.alibi_slopes(n_heads)), rtol=1e-6,
                    atol=0)


def test_packed_wrappers():
    q, k, v = [torch.from_numpy(x) for x in _qkv(h_kv=2)]
    ref, _ = api.flash_attention(q, k, v, causal=True)
    kvp = torch.stack([k.transpose(1, 2), v.transpose(1, 2)], dim=2)
    o, _ = api.flash_attention_kvpacked(q.transpose(1, 2), kvp, causal=True)
    assert_allclose(o, ref, rtol=1e-6, atol=1e-6)
    q2, k2, v2 = [torch.from_numpy(x) for x in _qkv()]
    ref2, _ = api.flash_attention(q2, k2, v2, causal=True)
    qkv = torch.stack([t.transpose(1, 2) for t in (q2, k2, v2)], dim=2)
    o2, _ = api.flash_attention_qkvpacked(qkv, causal=True)
    assert_allclose(o2, ref2, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        api.flash_attention_qkvpacked(qkv[:, :, :2])
