"""The port's FA3 8-bit attention (plain versions, CPU) against the JAX
package's ``pallas_fp8_attention`` in Pallas interpret mode, from the same
numpy inputs: fused and predecode, e4m3/e5m2/int8 payloads, head dims up to
512, GQA, window + sinks, soft-cap + segments + ALiBi, dropout with the same
seed, int8 PV in s8, and the straight-through backward in both flavours.

Limits: o and LSE at 5e-3 abs+rel, the JAX package's own fused-vs-oracle
limit (``tests/test_fp8.py``); STE gradients at 5e-3 abs+rel. The e4m3
decode of the JAX fused kernel flushes denormal payloads to zero; the
port decodes them exactly (an error below absmax/28672 of a block).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_tpu import fa3_attention as jax_fa3
from flashattention_tpu.ops.pallas_fp8 import pallas_fp8_attention
from flashattention_tpu_torch.ops import api, fp8_attn
from flashattention_tpu_torch.utils.testing import assert_allclose

BQ = BK = 128
TOL = 5e-3


def _inputs(b, h, h_kv, n, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, n, d)).astype(np.float32)
    k = rng.standard_normal((b, h_kv, n, d)).astype(np.float32)
    v = rng.standard_normal((b, h_kv, n, d)).astype(np.float32)
    do = 0.1 * rng.standard_normal((b, h, n, d)).astype(np.float32)
    dlse = 0.1 * rng.standard_normal((b, h, n)).astype(np.float32)
    return q, k, v, do, dlse


def _both(q, k, v, kw, jkw=None):
    """(o, lse) of the JAX kernel (interpret) and of the port."""
    jkw = dict(kw if jkw is None else jkw)
    jo, jl = pallas_fp8_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=BQ,
        block_k=BK, interpret=True, **jkw)
    to, tl = fp8_attn.fp8_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        block_q=BQ, block_k=BK, **kw)
    return (np.asarray(jo), np.asarray(jl)), (to, tl)


def _check(j, t, name):
    (jo, jl), (to, tl) = j, t
    assert to.dtype == torch.float32 and tuple(to.shape) == jo.shape
    assert_allclose(to, jo, rtol=TOL, atol=TOL, err_msg=f"{name} o")
    assert_allclose(tl, jl, rtol=TOL, atol=TOL, err_msg=f"{name} lse")


@pytest.mark.parametrize("shape", [(1, 2, 256, 64), (2, 1, 384, 128)])
@pytest.mark.parametrize("mode", ["fused", "predecode"])
@pytest.mark.parametrize("fmt", ["fp8", "e5m2", "int8"])
def test_fp8_forward_matches_pallas(shape, mode, fmt):
    b, h, n, d = shape
    q, k, v, _, _ = _inputs(b, h, h, n, d)
    kw = dict(causal=True, mode=mode, fmt=fmt)
    _check(*_both(q, k, v, kw), f"{shape} {mode} {fmt}")


@pytest.mark.parametrize("shape", [(1, 2, 2, 256, 256), (1, 4, 1, 384, 160)])
@pytest.mark.parametrize("fmt", ["fp8", "int8", "e5m2"])
def test_fp8_forward_matches_pallas_wide_head(shape, fmt):
    """Head dims above 128, which the card runs on the D = 256 kernels of
    the tensor-core route (160 reads zeros past D there)."""
    b, h, h_kv, n, d = shape
    q, k, v, _, _ = _inputs(b, h, h_kv, n, d, seed=9)
    kw = dict(causal=True, mode="fused", fmt=fmt)
    _check(*_both(q, k, v, kw), f"{shape} {fmt}")


def test_fp8_wide_head_mqa_window_sinks_softcap():
    q, k, v, _, _ = _inputs(1, 4, 1, 384, 256, seed=10)
    kw = dict(causal=True, mode="fused", fmt="int8", window=96, sinks=4,
              softcap=30.0)
    _check(*_both(q, k, v, kw), "d256 mqa window sinks softcap")


@pytest.mark.parametrize("mode", ["fused", "predecode"])
def test_fp8_gqa_noncausal(mode):
    q, k, v, _, _ = _inputs(2, 8, 2, 256, 64, seed=1)
    _check(*_both(q, k, v, dict(causal=False, mode=mode)), f"gqa {mode}")


@pytest.mark.parametrize("mode", ["fused", "predecode"])
@pytest.mark.parametrize("sinks", [0, 48])
def test_fp8_window_sinks(mode, sinks):
    q, k, v, _, _ = _inputs(1, 2, 2, 384, 64, seed=2)
    kw = dict(causal=True, mode=mode, window=128, sinks=sinks)
    _check(*_both(q, k, v, kw), f"window {mode} {sinks}")


@pytest.mark.parametrize("fmt", ["fp8", "int8"])
@pytest.mark.parametrize("mode", ["fused", "predecode"])
def test_fp8_softcap_segments_alibi(fmt, mode):
    q, k, v, _, _ = _inputs(1, 2, 2, 256, 64, seed=3)
    ids = np.zeros((1, 256), np.int32)
    ids[0, 100:] = 1
    slopes = np.asarray([0.5, 0.25], np.float32)
    kw = dict(causal=True, mode=mode, fmt=fmt, softcap=8.0)
    j = pallas_fp8_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=BQ,
        block_k=BK, interpret=True, segment_ids=jnp.asarray(ids),
        alibi_slopes=jnp.asarray(slopes), **kw)
    t = fp8_attn.fp8_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        block_q=BQ, block_k=BK, segment_ids=torch.from_numpy(ids),
        alibi_slopes=torch.from_numpy(slopes), **kw)
    _check((np.asarray(j[0]), np.asarray(j[1])), t, f"features {fmt} {mode}")


@pytest.mark.parametrize("fmt", ["fp8", "int8"])
def test_fp8_dropout_same_seed(fmt):
    q, k, v, _, _ = _inputs(1, 2, 2, 256, 64, seed=4)
    kw = dict(causal=True, mode="fused", fmt=fmt, dropout_rate=0.3,
              dropout_seed=7)
    _check(*_both(q, k, v, kw), f"dropout {fmt}")


def test_int8_pv_s8(monkeypatch):
    q, k, v, _, _ = _inputs(1, 2, 2, 384, 64, seed=5)
    monkeypatch.setenv("FAT_INT8_PV", "s8")
    kw = dict(causal=True, mode="fused", fmt="int8")
    j, t = _both(q, k, v, dict(kw, int8_pv="s8"), kw)
    _check(j, t, "s8")
    # s8 really re-quantizes p: it differs from the bf16 PV
    o_bf16, _ = fp8_attn.fp8_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), block_q=BQ, block_k=BK,
        **kw)
    assert float((o_bf16 - t[0]).abs().max()) > 0


def test_auto_mode_rule():
    rm = fp8_attn.resolve_mode
    assert rm("auto", "fp8", 128, 128) == "fused"
    assert rm("auto", "fp8", 129, 128) == "predecode"
    assert rm("auto", "int8", 4096, 128) == "fused"
    assert rm("fused_cached", "e5m2", 4096, 128) == "fused"
    with pytest.raises(ValueError, match="mode"):
        rm("turbo", "fp8", 1, 1)
    x = torch.zeros(1, 1, 128, 64)
    with pytest.raises(ValueError, match="fmt"):
        fp8_attn.fp8_attention(x, x, x, fmt="int4")
    with pytest.raises(ValueError, match="sinks require"):
        fp8_attn.fp8_attention(x, x, x, causal=True, sinks=16)


@pytest.mark.parametrize("ste", ["dequant", "original"])
@pytest.mark.parametrize("fmt", ["fp8", "int8"])
def test_ste_backward_matches_pallas(monkeypatch, ste, fmt):
    """dq, dk, dv of sum(o * do) + sum(lse * dlse), GQA with dropout."""
    q, k, v, do, dlse = _inputs(1, 4, 2, 256, 64, seed=6)
    kw = dict(causal=True, dropout_rate=0.1, dropout_seed=3, fmt=fmt)
    if ste == "original":
        monkeypatch.setenv("FAT_STE_GRADS", "original")

    def jloss(t):
        o, lse = pallas_fp8_attention(*t, block_q=BQ, block_k=BK,
                                      interpret=True, **kw)
        return jnp.sum(o * do) + jnp.sum(lse * dlse)

    jg = jax.grad(jloss)(tuple(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o, lse = fp8_attn.fp8_attention(*leaves, block_q=BQ, block_k=BK,
                                    ste=ste, **kw)
    ((o * torch.from_numpy(do)).sum()
     + (lse * torch.from_numpy(dlse)).sum()).backward()
    for name, t, j in zip(("dq", "dk", "dv"), leaves, jg):
        assert t.grad.dtype == torch.float32
        assert_allclose(t.grad, np.asarray(j), rtol=TOL, atol=TOL,
                        err_msg=f"{ste} {fmt} {name}")


@pytest.mark.parametrize("backend, jax_backend", [("kernel", "pallas"),
                                                  ("tiled", "xla")])
def test_fa3_fp8_end_to_end(backend, jax_backend):
    """fa3_attention(fp8=True): the rotation with JAX's signs, then the
    kernel path (fused, q blocks of 512 clamped to N) or the fake-quant
    path."""
    q, k, v, _, _ = _inputs(1, 2, 2, 200, 64, seed=7)
    jo, jl = jax_fa3(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, fp8=True, fp8_seed=5, backend=jax_backend)
    sign = np.array(jax.random.rademacher(jax.random.key(5), (64,),
                                          dtype=jnp.float32))
    to, tl = api.fa3_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=True, fp8=True,
        backend=backend, fp8_sign=torch.from_numpy(sign))
    _check((np.asarray(jo), np.asarray(jl)), (to, tl), f"fa3 {backend}")


def test_fa3_int8_pv_s8_end_to_end(monkeypatch):
    """fa3_attention(fp8=True, fp8_fmt="int8", int8_pv="s8") on the kernel
    backend against JAX's fa3_attention under FAT_INT8_PV=s8, with JAX's
    rotation signs; s8 is another function than the bf16 P·V."""
    q, k, v, _, _ = _inputs(1, 2, 2, 256, 64, seed=8)
    monkeypatch.setenv("FAT_INT8_PV", "s8")
    jo, jl = jax_fa3(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, fp8=True, fp8_seed=6, backend="pallas",
                     fp8_fmt="int8")
    sign = torch.from_numpy(np.array(jax.random.rademacher(
        jax.random.key(6), (64,), dtype=jnp.float32)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    kw = dict(causal=True, fp8=True, backend="kernel", fp8_sign=sign,
              fp8_fmt="int8")
    to, tl = api.fa3_attention(tq, tk, tv, int8_pv="s8", **kw)
    _check((np.asarray(jo), np.asarray(jl)), (to, tl), "fa3 int8 s8")
    o_bf16, _ = api.fa3_attention(tq, tk, tv, **kw)
    assert float((o_bf16 - to).abs().max()) > 0


def test_prequant_matches_pallas():
    """fp8_attention_prequant: blocks follow from the scale shapes. Above
    D = 256 (the wide kernels' route) key blocks of 48, which a 32-key tile
    spans two of, at a small size."""
    from flashattention_tpu.ops.pallas_fp8 import (
        pallas_fp8_attention_prequant,
        quantize_tiles,
    )
    from flashattention_tpu_torch.ops.quant import quantize_blocks

    for n, d, bq, bk in ((256, 64, 64, 128), (96, 512, 48, 48)):
        q, k, v, _, _ = _inputs(1, 2, 2, n, d, seed=8)
        blocks = ((q, bq), (k, bk), (v, bk))
        jq = [quantize_tiles(jnp.asarray(x), b) for x, b in blocks]
        tq = [quantize_blocks(torch.from_numpy(x), b) for x, b in blocks]
        jo, jl = pallas_fp8_attention_prequant(
            *(p for p, _ in jq), *(s for _, s in jq), causal=True,
            out_dtype=jnp.float32, interpret=True)
        to, tl = fp8_attn.fp8_attention_prequant(
            *(p for p, _ in tq), *(s for _, s in tq), causal=True,
            out_dtype=torch.float32)
        assert fp8_attn._wide_route(d) == (d > 256)
        _check((np.asarray(jo), np.asarray(jl)), (to, tl), f"prequant {d}")


@pytest.mark.parametrize("int8_pv, d, bk, want", [
    ("bf16", 64, 1024, True),     # the training/BASELINE head dims
    ("bf16", 128, 1024, True),
    ("bf16", 32, 128, True),      # one k32 step
    ("bf16", 96, 256, True),
    ("s8", 128, 1024, True),      # p8 integers on the same bf16 P·V
    ("bf16", 48, 1024, True),     # zeros past D from TMA
    ("bf16", 256, 1024, True),    # the D = 256 kernels: P·V in n128 halves
    ("bf16", 160, 1024, True),    # the D = 256 kernels, zeros past D
    ("bf16", 136, 1024, True),    # padded to 144 with zero bytes
    ("s8", 256, 1024, True),
    ("bf16", 256, 64, False),
    ("bf16", 64, 64, False),      # a key tile would span two v scales
    ("bf16", 264, 1024, False),   # above 256: the wide kernels
    ("s8", 512, 1024, False),
])
def test_tensor_core_route_rule(int8_pv, d, bk, want):
    """The 8-bit forward's route, from the inputs alone: wgmma with D <=
    256 and key blocks of whole 128s, in either ``int8_pv`` setting (the
    case's int8_pv says which setting the row stands for); the FMA kernel
    no call takes."""
    del int8_pv  # both settings take the same route
    assert fp8_attn._tensor_core_route(d, bk) is want


@pytest.mark.parametrize("d, width", [(80, 80), (48, 48), (136, 144),
                                      (8, 16), (256, 256)])
def test_kernel_head_dim(d, width):
    """The tensor-core kernel's head dim: D rounded up to whole 16 bytes
    of a payload row (TMA's strides); the kernel reads zeros past it."""
    assert fp8_attn.kernel_head_dim(d) == width


@pytest.mark.parametrize("fmt, int8_pv", [("int8", "bf16"), ("int8", "s8"),
                                          ("fp8", "bf16")])
@pytest.mark.parametrize("d", [80, 48, 136])
def test_padded_head_is_the_same_function(d, fmt, int8_pv):
    """Payloads padded with zero bytes (pad_head, as the card's wrapper
    pads to kernel_head_dim; here also to the next multiple of 32) give
    the unpadded call's o and LSE exactly, and zeros past D."""
    q, k, v, _, _ = _inputs(1, 2, 2, 256, d, seed=12)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    args = fp8_attn.quantize_inputs(q, k, v, BQ, BK, fmt)
    opts = fp8_attn.fa.make_opts(q, k, causal=True)
    o, lse = fp8_attn.fp8_fwd_plain(*args, opts, int8_pv=int8_pv,
                                    out_dtype=torch.float32)
    for width in {fp8_attn.kernel_head_dim(d), -(-d // 32) * 32}:
        padded = [fp8_attn.pad_head(x, width) for x in args[:3]]
        assert padded[0].shape[-1] == width
        op, lp = fp8_attn.fp8_fwd_plain(*padded, *args[3:], opts,
                                        int8_pv=int8_pv,
                                        out_dtype=torch.float32)
        assert torch.equal(op[..., :d], o), f"{d} -> {width} o"
        assert torch.equal(lp, lse), f"{d} -> {width} lse"
        assert not op[..., d:].any()


@pytest.mark.parametrize("fmt, int8_pv", [("fp8", "bf16"), ("int8", "bf16"),
                                          ("int8", "s8")])
def test_fp8_forward_matches_pallas_head_dim_80(monkeypatch, fmt, int8_pv):
    """Phi-2's head dim (80, not a multiple of 32: JAX pads it to 128
    lanes, the card's wrapper to whole 16 bytes) against the JAX kernel."""
    q, k, v, _, _ = _inputs(1, 4, 2, 256, 80, seed=11)
    monkeypatch.setenv("FAT_INT8_PV", int8_pv)
    kw = dict(causal=True, mode="fused", fmt=fmt)
    _check(*_both(q, k, v, dict(kw, int8_pv=int8_pv), kw),
           f"d80 {fmt} {int8_pv}")


def test_kernel_path_blocks_take_the_tensor_core_route():
    """The blocks fp8_attention quantizes in (ops/specs.fp8_kernel_blocks)
    are whole 128s of keys for every length, so int8_pv="bf16" at D = 64,
    128 or 256 always takes the tensor cores."""
    from flashattention_tpu_torch.ops.specs import fp8_kernel_blocks
    for n in (1, 100, 200, 1000, 4096, 8192):
        _, bk = fp8_kernel_blocks(n, n)
        assert fp8_attn._tensor_core_route(128, bk)
        assert fp8_attn._tensor_core_route(256, bk)


@pytest.mark.parametrize("fmt, int8_pv", [("fp8", "bf16"), ("e5m2", "bf16"),
                                          ("int8", "bf16"), ("int8", "s8")])
@pytest.mark.parametrize("shape", [(1, 4, 2, 256, 264), (1, 2, 1, 256, 512)])
def test_fp8_forward_matches_pallas_above_256(monkeypatch, shape, fmt,
                                              int8_pv):
    """Head dims above 256 (the wide kernels on the card; 264 is padded to
    272 there), GQA and MQA, every format and int8 with p in s8, against
    the JAX kernel."""
    q, k, v, _, _ = _inputs(*shape, seed=13)
    monkeypatch.setenv("FAT_INT8_PV", int8_pv)
    kw = dict(causal=True, mode="fused", fmt=fmt)
    _check(*_both(q, k, v, dict(kw, int8_pv=int8_pv), kw),
           f"{shape} {fmt} {int8_pv}")


@pytest.mark.parametrize("fmt", ["fp8", "int8"])
def test_ste_backward_above_256_matches_pallas(fmt):
    """dq, dk, dv of sum(o * do) + sum(lse * dlse) at D = 512, MQA: the
    straight-through backward on the flash kernels above 256."""
    q, k, v, do, dlse = _inputs(1, 2, 1, 256, 512, seed=14)
    kw = dict(causal=True, fmt=fmt)

    def jloss(t):
        o, lse = pallas_fp8_attention(*t, block_q=BQ, block_k=BK,
                                      interpret=True, **kw)
        return jnp.sum(o * do) + jnp.sum(lse * dlse)

    jg = jax.grad(jloss)(tuple(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o, lse = fp8_attn.fp8_attention(*leaves, block_q=BQ, block_k=BK, **kw)
    ((o * torch.from_numpy(do)).sum()
     + (lse * torch.from_numpy(dlse)).sum()).backward()
    for name, t, j in zip(("dq", "dk", "dv"), leaves, jg):
        assert_allclose(t.grad, np.asarray(j), rtol=TOL, atol=TOL,
                        err_msg=f"d512 {fmt} {name}")


@pytest.mark.parametrize("d, width", [(264, 272), (260, 272), (384, 384),
                                      (512, 512), (1024, 1024)])
def test_wide_route_rule(d, width):
    """Above D = 256 every call takes the wide kernels (any head dim; the
    wrapper pads D to whole 16 bytes, kernel_head_dim); up to 256 none
    does. fp8_attention's key blocks (multiples of 128) are multiples of
    the wide kernels' 32-key tile."""
    from flashattention_tpu_torch.ops.specs import fp8_kernel_blocks
    assert fp8_attn._wide_route(d)
    assert not fp8_attn._wide_route(fp8_attn.SM90_MAX_HEAD_DIM)
    assert fp8_attn.kernel_head_dim(d) == width
    for n in (1, 200, 4096):
        _, bk = fp8_kernel_blocks(n, n)
        assert not fp8_attn._tensor_core_route(d, bk)
        assert bk % 32 == 0
