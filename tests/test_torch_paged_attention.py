"""The PyTorch port's paged attention against the JAX package.

Same numpy inputs through ``pallas_paged_attention`` (Pallas interpret mode,
float32 compute), the JAX gather executor ``paged_attention_decode`` and the
port's plain version, at the float32 tolerance of the ladder (1e-4). Page 16
takes the TPU's merged schedule, page 8 its flat one; the port has one
kernel for both. ``test_torch_cuda.py`` holds the CUDA kernel against the
plain version on the same cases.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_tpu.ops.pallas_paged import pallas_paged_attention
from flashattention_tpu.serving.paged_kv import PagedKVCache as JaxCache
from flashattention_tpu.serving.paged_kv import (
    paged_attention_decode as jax_paged_attention_decode,
)
from flashattention_tpu_torch.ops import paged_attention as pa
from flashattention_tpu_torch.serving import paged_kv
from flashattention_tpu_torch.utils.testing import assert_allclose
from test_torch_cuda import CASES, paged_inputs as _inputs

TOL = 1e-4  # float32 rung of the ladder


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_interpret(case):
    shape, kw = CASES[case]
    q, kp, vp, pi, ln = _inputs(**shape)
    o_jax = pallas_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pi),
        jnp.asarray(ln), interpret=True, compute_dtype=jnp.float32, **kw,
    )
    o = pa.paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(pi), torch.from_numpy(ln), **kw,
    )
    assert o.shape == q.shape and o.dtype == torch.float32
    assert torch.isfinite(o).all()
    assert_allclose(o, np.asarray(o_jax), rtol=TOL, atol=TOL, err_msg=case)
    for i, n in enumerate(ln):
        if n == 0 and q.ndim == 3:
            assert float(o[i].abs().max()) == 0.0  # empty sequence -> zeros


@pytest.mark.parametrize(
    "case", [c for c in sorted(CASES) if CASES[c][0]["q_len"] == 0]
)
def test_decode_oracle_matches_jax_gather_executor(case):
    shape, kw = CASES[case]
    q, kp, vp, pi, ln = _inputs(**shape)
    ln_jax = np.maximum(ln, 1)  # the gather executor has no empty rows
    cache = JaxCache(jnp.asarray(kp), jnp.asarray(vp), None, None)
    o_jax = jax_paged_attention_decode(
        jnp.asarray(q), cache, jnp.asarray(pi), jnp.asarray(ln_jax), **kw
    )
    tcache = paged_kv.PagedKVCache(torch.from_numpy(kp), torch.from_numpy(vp))
    o = paged_kv.paged_attention_decode(
        torch.from_numpy(q), tcache, torch.from_numpy(pi),
        torch.from_numpy(ln_jax), **kw,
    )
    assert_allclose(o, np.asarray(o_jax), rtol=TOL, atol=TOL, err_msg=case)


def test_bf16_pages_follow_the_tpu_rounding_points():
    """bf16 pages: the plain version rounds where the Pallas kernel does
    (q*scale and p in bf16, fp32 accumulation) - held at the bf16 rung."""
    q, kp, vp, pi, ln = _inputs(**CASES["chunk_p16"][0])
    bf = lambda x: jnp.asarray(x).astype(jnp.bfloat16)
    o_jax = pallas_paged_attention(
        bf(q), bf(kp), bf(vp), jnp.asarray(pi), jnp.asarray(ln),
        interpret=True, compute_dtype=jnp.bfloat16,
    )
    tb = lambda x: torch.from_numpy(x).to(torch.bfloat16)
    o = pa.paged_attention(tb(q), tb(kp), tb(vp), torch.from_numpy(pi),
                           torch.from_numpy(ln))
    assert o.dtype == torch.bfloat16
    assert_allclose(o, np.asarray(o_jax.astype(jnp.float32)),
                    rtol=5e-2, atol=5e-2)


def test_cpu_call_never_counts_a_launch():
    q, kp, vp, pi, ln = _inputs(**CASES["decode_p8"][0])
    before = pa.paged_attention.launches
    pa.paged_attention(*(torch.from_numpy(x) for x in (q, kp, vp, pi, ln)))
    assert pa.paged_attention.launches == before


def test_rejects_quantized_pages_and_bad_window():
    q, kp, vp, pi, ln = (torch.from_numpy(x) for x in
                         _inputs(**CASES["decode_p8"][0]))
    # quantized pages are ported (test_torch_paged_quant.py); a cache
    # with only one of its two scale planes is rejected
    with pytest.raises(ValueError, match="both"):
        pa.paged_attention(q, kp, vp, pi, ln, k_scales=kp[..., :1])
    with pytest.raises(ValueError):
        pa.paged_attention(q, kp, vp, pi, ln, window=0)


# name: (q dtype, page dtype, schedule, page, D, aligned, split route?)
SPLIT_ROUTE = {
    "bf16_decode": (torch.bfloat16, torch.bfloat16, "convert", 16, 64, True,
                    True),
    "bf16_page24_d128": (torch.bfloat16, torch.bfloat16, "convert", 24, 128,
                         True, True),
    "int8_qk": (torch.bfloat16, torch.int8, "qk", 16, 64, True, True),
    "int8_convert": (torch.bfloat16, torch.int8, "convert", 16, 64, True,
                     True),
    "e4m3_page24": (torch.bfloat16, torch.float8_e4m3fn, "convert", 24, 64,
                    True, True),
    "e5m2": (torch.bfloat16, torch.float8_e5m2, "convert", 16, 64, True,
             True),
    "fp32": (torch.float32, torch.float32, "convert", 16, 64, True, False),
    "fp32_q_int8": (torch.float32, torch.int8, "convert", 16, 64, True,
                    False),
    "int8_full": (torch.bfloat16, torch.int8, "full", 16, 64, True, False),
    "d_not_8": (torch.bfloat16, torch.bfloat16, "convert", 16, 36, True,
                False),
    "d_above_128": (torch.bfloat16, torch.bfloat16, "convert", 16, 256, True,
                    True),
    "d_above_256": (torch.bfloat16, torch.bfloat16, "convert", 16, 264, True,
                    False),
    "int8_qk_d256": (torch.bfloat16, torch.int8, "qk", 16, 256, True, True),
    # page 6 x D 8 x 1 byte = 48 bytes: 16-byte multiple, but a scale plane
    # of 24 bytes is not
    "e4m3_page6": (torch.bfloat16, torch.float8_e4m3fn, "convert", 6, 8,
                   True, False),
    # 2 x 8 bytes of a 1-byte slab: not a 16-byte multiple
    "e4m3_slab_8": (torch.bfloat16, torch.float8_e4m3fn, "convert", 1, 8,
                    True, False),
    "bf16_page2_d8": (torch.bfloat16, torch.bfloat16, "convert", 2, 8, True,
                      True),
    "unaligned": (torch.bfloat16, torch.bfloat16, "convert", 16, 64, False,
                  False),
    # three stages of 2 x 512 x 128 x 2 bytes exceed the ring's budget
    "ring_too_big": (torch.bfloat16, torch.bfloat16, "convert", 512, 128,
                     True, False),
}


@pytest.mark.parametrize("case", sorted(SPLIT_ROUTE))
def test_split_route_rule(case):
    """Which kernel a CUDA call takes, from its inputs alone."""
    *args, want = SPLIT_ROUTE[case]
    assert pa.split_route(*args) is want


@pytest.mark.parametrize("page, q_len, pages", [(16, 1, 8), (8, 1, 16),
                                                 (24, 1, 5), (64, 1, 4),
                                                 (16, 64, 4), (8, 64, 8)])
def test_split_plan_pages_per_split(page, q_len, pages):
    """Splits of at least 4 pages: 128 slots at decode, 64 for chunks,
    enough splits to cover every page of the table."""
    plan = pa.split_plan(12, 12, q_len, 64, page, 40, False)
    assert plan["split_pages"] == pages
    assert plan["n_splits"] * pages >= 40
    assert (plan["n_splits"] - 1) * pages < 40


def test_split_plan_fills_the_card_at_the_engine_decode_shape():
    """The serving engine's decode step (B = 32, GPT-3 Small's 12 heads,
    D = 64, page 16, 512 slots a sequence) gives at least two CTAs per SM
    of the H100's 132, where the first kernel had 384 CTAs of which one
    warp in four computed."""
    def ctas(b, plan):  # grid (B * H_kv, splits, row groups)
        return b * 12 * plan["n_splits"] * plan["row_groups"]

    plan = pa.split_plan(12, 12, 1, 64, 16, 32, False)
    assert (plan["rps"], plan["nrs"], plan["lg"]) == (1, 1, 8)
    assert ctas(32, plan) >= 2 * 132
    chunk = pa.split_plan(12, 12, 64, 64, 16, 32, False)
    assert ctas(1, chunk) >= 2 * 132  # the first kernel: 48


@pytest.mark.parametrize("h, h_kv, q_len, rps, nrs, groups", [
    (12, 12, 1, 1, 1, 1), (12, 6, 1, 2, 1, 1), (12, 4, 1, 4, 1, 1),
    (12, 1, 1, 4, 4, 1), (12, 12, 64, 4, 4, 4), (12, 4, 64, 4, 4, 12),
    (4, 4, 5, 4, 2, 1)])
def test_split_plan_rows(h, h_kv, q_len, rps, nrs, groups):
    """Rows of a KV head (GQA group x chunk) into row sets of rps rows,
    nrs sets a CTA (at most 16 rows), row_groups CTAs."""
    plan = pa.split_plan(h, h_kv, q_len, 64, 16, 32, False)
    assert (plan["rps"], plan["nrs"], plan["row_groups"]) == (rps, nrs,
                                                              groups)
    assert plan["rps"] * plan["nrs"] * plan["row_groups"] >= (h // h_kv) * q_len


def test_split_plan_at_head_dim_256():
    """Gemma 2B's MQA decode step on the engine's shape (B = 32, 8 query
    heads over 1 KV head, D = 256, page 16, 4096 slots a sequence): 8 rows
    a KV head in 2 row sets of 4, lane groups of 16 lanes at 16 columns
    covering the head dim, 8-page splits over 256 pages, a ring of 4
    stages (bf16: 16 KB each; 1-byte pages: 8 KB and the scales); above
    D = 256 no route takes the call."""
    plan = pa.split_plan(8, 1, 1, 256, 16, 256, False)
    assert (plan["lg"], plan["epl"]) == (16, 16)
    assert plan["lg"] * plan["epl"] >= 256
    assert (plan["rps"], plan["nrs"], plan["row_groups"]) == (4, 2, 1)
    assert (plan["split_pages"], plan["n_splits"], plan["stages"]) == (8, 32,
                                                                       4)
    assert pa.split_plan(8, 1, 1, 256, 16, 256, True)["stages"] == 4
    below = pa.split_plan(8, 1, 1, 128, 16, 256, False)
    assert (below["lg"], below["epl"]) == (16, 8)
    with pytest.raises(ValueError, match="head_dim 264"):
        pa._check_cuda_args(*(torch.zeros(1, 1, 264),) * 3, None, None, None,
                            None)


@pytest.mark.parametrize("b, h, h_kv, q_len, d, pps, unit, want", [
    (8, 8, 1, 1, 256, 256, 1, (8, 32)),     # fp32 decode: 8 blocks -> 256
    (32, 8, 1, 1, 256, 256, 32, (1, 8)),    # "full": whole 32-page steps
    (1, 8, 1, 64, 256, 128, 1, (15, 9)),    # a chunk: 32 row groups
    (2, 8, 1, 1, 256, 3, 1, (4, 1)),        # fewer pages than a split
    (8, 8, 1, 1, 128, 256, 1, (1, 1)),      # D <= 128 walks whole
])
def test_first_plan_splits_above_head_dim_128(b, h, h_kv, q_len, d, pps,
                                              unit, want):
    """The first kernel's splits above D = 128: at least 4 pages a split,
    enough splits for its blocks to reach FIRST_TARGET_CTAS where the
    pages allow, and splits covering every unit of the table."""
    units, n_splits = pa.first_plan(b, h, h_kv, q_len, d, pps, unit)
    assert (units, n_splits) == want
    if d > 128:
        assert n_splits * units * unit >= pps
        assert units * unit >= 4
