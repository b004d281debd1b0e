"""The port's flash attention (plain versions, CPU) against the JAX package's
Pallas kernels in interpret mode: o, lse, dq, dk and dv for every feature of
the forward kernel, from the same numpy inputs and the same dropout seed.

Tolerances: the JAX ladder, fp32 1e-4 and bf16 5e-2. The bf16 forward of
the JAX package rounds q * scale to bf16 before the dot, the port's scales
the fp32 dot; both are inside the bf16 rung.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_tpu.ops.pallas_attn import _keep_mask, pallas_attention
from flashattention_tpu_torch.ops import flash_attn as fa
from flashattention_tpu_torch.utils.testing import assert_allclose

TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _inputs(b, h, h_kv, n_q, n_k, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, n_q, d)).astype(np.float32)
    k = rng.standard_normal((b, h_kv, n_k, d)).astype(np.float32)
    v = rng.standard_normal((b, h_kv, n_k, d)).astype(np.float32)
    do = rng.standard_normal((b, h, n_q, d)).astype(np.float32)
    dlse = rng.standard_normal((b, h, n_q)).astype(np.float32)
    return q, k, v, do, dlse


def _segments(b, n, seed=1):
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, 4, size=(b, n)), axis=1)
    return ids.astype(np.int32)


# name: (shape (b, h, h_kv, n_q, n_k, d), kwargs, use dlse)
CASES = {
    "causal": ((2, 4, 4, 200, 200, 64), dict(causal=True), False),
    "full": ((2, 2, 2, 64, 200, 32), dict(causal=False), False),
    "gqa": ((1, 4, 2, 200, 200, 32), dict(causal=True), False),
    "window_sinks": ((1, 2, 1, 200, 200, 32),
                     dict(causal=True, window=37, sinks=5), False),
    "segments": ((2, 2, 2, 200, 200, 32), dict(causal=True, segments=True),
                 False),
    "softcap": ((1, 2, 2, 64, 64, 64),
                dict(causal=True, softcap=2.0, softmax_scale=0.9), False),
    "alibi": ((1, 4, 4, 200, 200, 32), dict(causal=True, alibi=True), False),
    "dropout": ((2, 2, 1, 200, 200, 32),
                dict(causal=True, dropout_rate=0.2, dropout_seed=1234), False),
    "dropout_full": ((1, 2, 2, 64, 200, 64),
                     dict(causal=False, dropout_rate=0.3, dropout_seed=99),
                     False),
    "q_offset": ((1, 2, 2, 64, 200, 32), dict(causal=True, q_offset=100),
                 False),
    "dlse": ((1, 2, 2, 64, 64, 32), dict(causal=True), True),
    "all": ((2, 4, 2, 200, 200, 32),
            dict(causal=True, window=64, sinks=3, softcap=5.0, alibi=True,
                 segments=True, dropout_rate=0.1, dropout_seed=5), True),
    # head dims above 128 (bf16 on the card: the D = 256 tensor-core kernels)
    "d256_window_dropout": ((1, 4, 2, 96, 130, 256),
                            dict(causal=True, window=40, sinks=3,
                                 softcap=20.0, dropout_rate=0.2,
                                 dropout_seed=31), True),
    "d192_segments_alibi": ((2, 2, 2, 64, 100, 192),
                            dict(causal=False, segments=True, alibi=True),
                            False),
    # above D = 256 (on the card: the chunked kernels of flash_wide.cu; 264
    # and 384 end in a part-filled chunk, 512 fills two)
    "d264_causal_dlse": ((1, 2, 2, 64, 96, 264), dict(causal=True), True),
    "d384_full_mqa": ((1, 2, 1, 48, 80, 384), dict(causal=False), False),
    "d512_gqa_window_softcap": ((1, 4, 2, 64, 64, 512),
                                dict(causal=True, window=24, sinks=2,
                                     softcap=10.0, dropout_rate=0.1,
                                     dropout_seed=9), True),
}


def _run_jax(q, k, v, do, dlse, kw, dtype):
    jdt = jnp.dtype(dtype)
    args = [jnp.asarray(x, jdt) for x in (q, k, v)]

    def f(q_, k_, v_):
        return pallas_attention(q_, k_, v_, interpret=True, **kw)

    (o, lse), vjp = jax.vjp(f, *args)
    dq, dk, dv = vjp((jnp.asarray(do, jdt), jnp.asarray(dlse)))
    return [np.asarray(x, np.float32) for x in (o, lse, dq, dk, dv)]


def _run_port(q, k, v, do, dlse, kw, dtype):
    tdt = getattr(torch, dtype)
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_(True)
              for x in (q, k, v)]
    o, lse = fa.kernel_attention(*leaves, **kw)
    torch.autograd.backward([o, lse], [torch.from_numpy(do).to(tdt),
                                       torch.from_numpy(dlse)])
    return [o, lse] + [t.grad for t in leaves]


def _kwargs(case, shape):
    b, h, _, n_q, n_k, _ = shape
    kw = dict(CASES[case][1])
    jkw, tkw = dict(kw), dict(kw)
    if kw.pop("segments", False):
        for d in (jkw, tkw):
            d.pop("segments")
        if n_q == n_k:
            ids = _segments(b, n_q)
            jkw["segment_ids"] = jnp.asarray(ids)
            tkw["segment_ids"] = torch.from_numpy(ids)
        else:  # a (q_ids, kv_ids) pair
            ids = (_segments(b, n_q), _segments(b, n_k, seed=2))
            jkw["segment_ids"] = tuple(jnp.asarray(x) for x in ids)
            tkw["segment_ids"] = tuple(torch.from_numpy(x) for x in ids)
    if kw.pop("alibi", False):
        slopes = (0.5 ** np.arange(1, h + 1)).astype(np.float32)
        for d in (jkw, tkw):
            d.pop("alibi")
        jkw["alibi_slopes"] = jnp.asarray(slopes)
        tkw["alibi_slopes"] = torch.from_numpy(slopes)
    return jkw, tkw


# every feature in fp32; a subset in bf16
PARAMS = ([(c, "float32") for c in sorted(CASES)]
          + [(c, "bfloat16") for c in ("causal", "gqa", "dropout", "all",
                                        "d256_window_dropout",
                                        "d192_segments_alibi")])


@pytest.mark.parametrize("case,dtype", PARAMS)
def test_plain_flash_matches_pallas_interpret(case, dtype):
    shape, _, use_dlse = CASES[case]
    b, h, h_kv, n_q, n_k, d = shape
    q, k, v, do, dlse = _inputs(b, h, h_kv, n_q, n_k, d)
    if not use_dlse:
        dlse = np.zeros_like(dlse)
    jkw, tkw = _kwargs(case, shape)
    ref = _run_jax(q, k, v, do, dlse, jkw, dtype)
    out = _run_port(q, k, v, do, dlse, tkw, dtype)
    tol = TOL[dtype]
    for name, a, r in zip(("o", "lse", "dq", "dk", "dv"), out, ref):
        assert_allclose(a, r, rtol=tol, atol=tol, err_msg=f"{case} {name}")


def test_keep_mask_is_bit_exact_with_pallas():
    n_q, n_k, b, h = 96, 160, 2, 3
    for seed, rate in ((0, 0.1), (123456789, 0.5), (-5, 0.9)):
        ours = fa.keep_mask(seed, b, h, torch.arange(n_q), torch.arange(n_k),
                            rate).numpy()
        for bh in range(b * h):
            theirs = np.asarray(_keep_mask(
                jnp.asarray(seed, jnp.int32), jnp.asarray(bh, jnp.int32), 0, 0,
                n_q, n_k, rate))
            np.testing.assert_array_equal(ours[bh // h, bh % h], theirs)
        kept = ours.mean()
        assert abs(kept - (1 - rate)) < 0.02


def test_row_without_keys_gives_zeros():
    """q_offset < 0: the first rows see no key. o and every gradient are 0
    there (the LSE is <= -1e30, not compared), as in the Pallas kernel."""
    q, k, v, do, dlse = _inputs(1, 2, 2, 64, 64, 32)
    kw = dict(causal=True, q_offset=-10)
    ref = _run_jax(q, k, v, do, np.zeros_like(dlse), kw, "float32")
    out = _run_port(q, k, v, do, np.zeros_like(dlse), kw, "float32")
    assert float(out[0][:, :, :10].abs().max()) == 0.0
    assert float(out[1][:, :, :10].max()) <= -1e30
    assert float(out[2][:, :, :10].abs().max()) == 0.0
    for name, i in (("o", 0), ("dq", 2), ("dk", 3), ("dv", 4)):
        assert_allclose(out[i], ref[i], rtol=1e-4, atol=1e-4, err_msg=name)


def test_same_seed_same_output_and_lse_ignores_dropout():
    q, k, v, _, _ = _inputs(1, 2, 2, 64, 64, 32)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    o1, l1 = fa.kernel_attention(*t, causal=True, dropout_rate=0.3,
                                 dropout_seed=7)
    o2, _ = fa.kernel_attention(*t, causal=True, dropout_rate=0.3,
                                dropout_seed=7)
    o3, _ = fa.kernel_attention(*t, causal=True, dropout_rate=0.3,
                                dropout_seed=8)
    _, l0 = fa.kernel_attention(*t, causal=True)
    assert torch.equal(o1, o2)
    assert not torch.equal(o1, o3)
    assert torch.equal(l1, l0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_dim_not_a_multiple_of_8_is_padded(dtype):
    """D = 36: padded with zeros to 40 as ``pallas_attention`` pads its
    head dim, the default scale of D = 36; o, LSE and every gradient
    against Pallas interpret, in D = 36."""
    q, k, v, do, dlse = _inputs(1, 4, 2, 80, 80, 36)
    kw = dict(causal=True, window=50, sinks=2, dropout_rate=0.1,
              dropout_seed=3)
    ref = _run_jax(q, k, v, do, dlse, kw, dtype)
    out = _run_port(q, k, v, do, dlse, kw, dtype)
    tol = TOL[dtype]
    for name, a, r in zip(("o", "lse", "dq", "dk", "dv"), out, ref):
        assert tuple(a.shape) == r.shape, name
        assert_allclose(a, r, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("bad", ["d264", "heads", "window", "sinks",
                                 "seed", "segments", "slopes"])
def test_contract_errors(bad):
    q = torch.zeros(1, 4, 16, 32)
    k = torch.zeros(1, 2, 16, 32)
    kw = dict(causal=True)
    if bad == "d264":
        # a head dim above 256 is no error: it computes, in bf16 as in fp32,
        # and a D that is not a multiple of 8 above it is padded
        for dt, d in ((torch.bfloat16, 264), (torch.float32, 264),
                      (torch.float32, 300)):
            q, k, v, _, _ = (torch.from_numpy(x).to(dt)
                             for x in _inputs(1, 4, 2, 16, 16, d))
            o, lse = fa.kernel_attention(q, k, v, **kw)
            o_ref, lse_ref = fa.flash_fwd_plain(
                q, k, v, fa.make_opts(q, k, **kw)) if d % 8 == 0 else (
                o, lse)
            assert o.shape == q.shape and o.dtype == dt
            assert bool(torch.isfinite(o.float()).all())
            assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
        return
    elif bad == "heads":
        k = torch.zeros(1, 3, 16, 32)
    elif bad == "window":
        kw = dict(causal=False, window=4)
    elif bad == "sinks":
        kw["sinks"] = 2
    elif bad == "seed":
        kw["dropout_rate"] = 0.1
    elif bad == "segments":
        kw["segment_ids"] = torch.zeros(1, 15, dtype=torch.int32)
    elif bad == "slopes":
        kw["alibi_slopes"] = torch.ones(3)
    with pytest.raises(ValueError):
        fa.kernel_attention(q, k, k, **kw)


def test_cpu_path_launches_no_kernel():
    q, k, v, _, _ = _inputs(1, 2, 2, 32, 32, 32)
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    before = (fa.kernel_attention.fwd_launches, fa.kernel_attention.bwd_launches)
    o, _ = fa.kernel_attention(*t, causal=True)
    o.sum().backward()
    assert (fa.kernel_attention.fwd_launches,
            fa.kernel_attention.bwd_launches) == before
    o_plain, _ = fa.kernel_attention_plain(*[x.detach() for x in t], causal=True)
    assert torch.equal(o.detach(), o_plain)


# (dtype, head dim, wgmma route?): bf16 and fp32 up to D = 256 go to the
# wgmma kernels (fp32 on 3xTF32), above to the chunked mma.sync kernels of
# flash_wide.cu (both dtypes); every head dim goes to the tensor cores.
ROUTES = ([("bfloat16", d, True) for d in (40, 64, 128, 136, 192, 256)]
          + [("float32", d, True) for d in (40, 64, 128)]
          + [("float32", d, True) for d in (136, 256)]
          + [("bfloat16", 264, False), ("float32", 264, False)])


@pytest.mark.parametrize("dtype,d,want", ROUTES)
def test_tensor_core_route(dtype, d, want):
    """Every head dim goes to a tensor-core entry point: up to D = 256 its
    dtype's wgmma one (fp32 to the 3xTF32 ones), above the chunked one,
    whose kernels route_kernels names."""
    dt = getattr(torch, dtype)
    q = torch.zeros(1, 2, 4, d, dtype=dt)
    fa.make_opts(q, q)
    suffix = "_sm90_f32" if dt == torch.float32 else "_sm90"
    for prefix in ("fat_flash_fwd", "fat_flash_bwd"):
        lib, name = fa._entry_name(prefix, dt, d)
        if want:
            assert name == prefix + suffix
            assert lib == ("flash_fwd" if "fwd" in prefix else "flash_bwd")
        else:
            assert (lib, name) == ("flash_wide", prefix + "_wide")
    # the cluster backward on wgmma (fp32 with the split of its operands)
    wide = ({"flash_fwd_wide_kernel", "flash_bwd_dkv_wide_sm90_kernel",
             "flash_bwd_dq_wide_sm90_kernel"} if dt == torch.bfloat16 else
            {"flash_fwd_wide_kernel", "flash_bwd_dkv_wide_f32_sm90_kernel",
             "flash_bwd_dq_wide_f32_sm90_kernel", "tf32_split_kernel"})
    assert (fa.route_kernels(dt, d) == wide) == (not want)
    if not want:  # the sum of split partials
        assert fa.route_kernels(dt, d, kv_splits=4) == wide | {"kv_sum_kernel"}
        # fp32 above 8 chunks: the chunked mma.sync kernels
        chunked = {"flash_fwd_wide_kernel", "flash_bwd_dkv_wide_kernel",
                   "flash_bwd_dq_wide_kernel"}
        assert (fa.route_kernels(dt, 2056) == chunked) == (dt == torch.float32)


# (B * H_kv, N_k, group, SMs, splits): the fp32 dK/dV kernel above D = 128
# splits a query-head group until it has two CTAs an SM, by halving steps
# that divide the group; MHA (group 1) and a full grid never split.
KV_SPLITS = [(8, 8192, 1, 132, 1), (2, 300, 4, 132, 4), (1, 4096, 8, 132, 8),
             (1, 8192, 8, 132, 4), (4, 4096, 6, 132, 2), (16, 8192, 8, 132, 1)]


@pytest.mark.parametrize("kv_heads,n_k,group,sms,want", KV_SPLITS)
def test_kv_splits_fill_the_card(kv_heads, n_k, group, sms, want):
    assert fa._kv_splits(kv_heads, n_k, group, sms) == want


# (D, B, H, H_kv, N_k): (chunks, cluster, groups, kv_splits) of the bf16
# backward above D = 256 on 132 SMs: one cluster of ceil(D / 256) CTAs up to
# 8 chunks, then the fewest clusters of the fewest CTAs along D; phase 5d's
# MQA call splits its 4 query heads over 4 clusters (256 dK/dV CTAs).
WIDE_PLANS = [
    (264, 2, 4, 4, 300, (2, 2, 1, 1)),       # a last chunk of 8 columns
    (512, 1, 4, 1, 2048, (2, 2, 1, 4)),      # phase 5d's call
    (640, 1, 8, 8, 1024, (3, 3, 1, 1)),      # a cluster of 3
    (1024, 1, 4, 2, 1024, (4, 4, 1, 2)),      # GQA 4/2: split in two
    (2048, 1, 2, 1, 512, (8, 8, 1, 2)),      # the largest single cluster
    (2056, 1, 2, 2, 512, (9, 5, 2, 1)),      # clusters repeat along D
    (1024, 1, 8, 1, 512, (4, 4, 1, 8)),      # MQA: the walk split 8 ways
    (4096, 1, 4, 4, 256, (16, 8, 2, 1)),
]


@pytest.mark.parametrize("d,b,h,h_kv,n_k,want", WIDE_PLANS)
def test_wide_bwd_plan(d, b, h, h_kv, n_k, want):
    plan = fa._wide_bwd_plan(torch.bfloat16, d, b, h, h_kv, n_k, 132)
    got = (plan["chunks"], plan["cluster"], plan["groups"], plan["kv_splits"])
    assert got == want
    assert plan["cols"] == fa.WIDE_BWD_COLS
    assert plan["cluster"] <= fa.WIDE_MAX_CLUSTER
    assert plan["cluster"] * plan["groups"] >= plan["chunks"]
    assert (plan["cluster"] - 1) * plan["groups"] < plan["chunks"]
    assert (h // h_kv) % plan["kv_splits"] == 0
    # fp32: the same plan up to 8 chunks; above, the chunked kernels
    f32 = fa._wide_bwd_plan(torch.float32, d, b, h, h_kv, n_k, 132)
    if want[2] == 1:
        assert f32 == plan
    else:
        assert (f32["cluster"], f32["groups"], f32["kv_splits"]) == (0, 0, 1)


def test_aligned16_copies_an_unaligned_view_only():
    buf = torch.arange(1 + 4 * 8 * 40, dtype=torch.bfloat16)
    aligned = buf[: 4 * 8 * 40].view(4, 8, 40)
    assert aligned.data_ptr() % 16 == 0
    assert fa._aligned16(aligned) is aligned
    view = buf[1:].view(4, 8, 40)  # 2 bytes past the boundary
    assert view.data_ptr() % 16 != 0
    got = fa._aligned16(view)
    assert got.data_ptr() % 16 == 0 and got.is_contiguous()
    assert torch.equal(got, view)


# ---------------------------------------------------------------------------
# The fp32 tensor-core route's arithmetic (csrc/tf32_sm90.cuh), emulated
# ---------------------------------------------------------------------------


def _tf32(x):
    """x rounded to the nearest TF32 value, ties away from zero, as the
    kernels' tf32_round: 0x1000 added to the bits, the low 13 cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _products_3xtf32(einsum):
    """einsum with each operand split into big = tf32(x) and small =
    tf32(x - big), summed as the kernels' wgmmas sum them: the two small
    terms, then big·big, in fp32."""
    def product(spec, a, b):
        ab, bb = _tf32(a), _tf32(b)
        as_, bs = _tf32(a - ab), _tf32(b - bb)
        return (einsum(spec, as_, bb) + einsum(spec, ab, bs)) + einsum(
            spec, ab, bb)
    return product


def _products_1xtf32(einsum):
    """einsum on one TF32 product: both operands rounded to TF32."""
    return lambda spec, a, b: einsum(spec, _tf32(a), _tf32(b))


def _plain_with_products(split, causal, rate, shape=(2, 12, 512, 64)):
    """(o, lse, dq, dk, dv) of flash_fwd_plain / flash_bwd_plain with every
    product (Q·Kᵀ and P·V; S, dP, dV, dK and dQ) taken through ``split``,
    and the same of the plain versions as they are, from one numpy input
    at ``shape`` (B, H, N, D)."""
    b, h, n, d = shape
    q, k, v, do, _ = _inputs(b, h, h, n, n, d, seed=3)
    q, k, v, do = (torch.from_numpy(x) for x in (q, k, v, do))
    opts = fa.make_opts(q, k, causal=causal, dropout_rate=rate,
                        dropout_seed=11 if rate else None)

    def run():
        o, lse = fa.flash_fwd_plain(q, k, v, opts)
        di = (o * do).sum(-1)
        return [o, lse, *fa.flash_bwd_plain(q, k, v, do, lse, di, opts)]

    ref = run()
    with mock.patch.object(torch, "einsum", split(torch.einsum)):
        got = run()
    return got, ref


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_3xtf32_products_keep_the_fp32_limit(causal, rate):
    """The split the fp32 kernels run every product in holds o, LSE, dQ, dK
    and dV within fp32's 1e-4 of the plain versions."""
    got, ref = _plain_with_products(_products_3xtf32, causal, rate)
    for name, a, r in zip(("o", "lse", "dq", "dk", "dv"), got, ref):
        assert_allclose(a, r, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_products_keep_the_fp32_limit_at_d256(causal):
    """The same at head dim 256, the wide kernels' (S and dP sum 256 terms),
    with dropout: o, LSE, dQ, dK and dV within fp32's 1e-4."""
    got, ref = _plain_with_products(_products_3xtf32, causal, 0.1,
                                    shape=(1, 4, 512, 256))
    for name, a, r in zip(("o", "lse", "dq", "dk", "dv"), got, ref):
        assert_allclose(a, r, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_one_tf32_product_misses_the_fp32_limit(causal):
    """Why the split: with one TF32 product per fp32 product, some output
    leaves the 1e-4 rung."""
    got, ref = _plain_with_products(_products_1xtf32, causal, 0.0)
    excess = max(float(((a - r).abs() - 1e-4 - 1e-4 * r.abs()).max())
                 for a, r in zip(got, ref))
    assert excess > 0
