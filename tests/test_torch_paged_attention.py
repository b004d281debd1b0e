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


@pytest.mark.parametrize("case", ["mqa_d512_decode",
                                  "gqa_d264_chunk_window_sinks_softcap"])
def test_bf16_pages_above_256_follow_the_tpu_rounding_points(case):
    """bf16 pages above D = 256, decode and chunk, against the Pallas
    kernel in bf16 at the bf16 rung, as at D <= 256."""
    shape, kw = CASES[case]
    q, kp, vp, pi, ln = _inputs(**shape)
    bf = lambda x: jnp.asarray(x).astype(jnp.bfloat16)
    o_jax = pallas_paged_attention(
        bf(q), bf(kp), bf(vp), jnp.asarray(pi), jnp.asarray(ln),
        interpret=True, compute_dtype=jnp.bfloat16, **kw)
    tb = lambda x: torch.from_numpy(x).to(torch.bfloat16)
    o = pa.paged_attention(tb(q), tb(kp), tb(vp), torch.from_numpy(pi),
                           torch.from_numpy(ln), **kw)
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    assert_allclose(o, np.asarray(o_jax.astype(jnp.float32)),
                    rtol=5e-2, atol=5e-2, err_msg=case)


@pytest.mark.parametrize("h, h_kv, q_len, d, quantized, nrs, groups, chunks", [
    (4, 1, 1, 512, False, 1, 1, 2),    # chip_smoke phase 3d: decode
    (4, 1, 64, 512, True, 2, 16, 2),   # its T = 64 chunk: 2 row tiles
    (4, 1, 5, 512, False, 2, 2, 2),    # its verify chunk, 20 rows
    (2, 1, 1, 1024, True, 1, 1, 4),    # D = 1024: 4 chunks
    (4, 2, 3, 264, False, 1, 1, 2)])   # D = 264: a chunk of 8 columns
def test_split_plan_above_head_dim_256(h, h_kv, q_len, d, quantized, nrs,
                                       groups, chunks):
    """Above D = 256 the tensor-core walk holds 1 or 2 row tiles a CTA
    (each CTA's q fragments cover up to 16 k-steps a warp) in a ring of
    2-4 stages that fits the H100's shared memory with the decoded tiles
    and score buffers; the kernel cuts O into ceil(D / 256) chunks."""
    plan = pa.split_plan(h, h_kv, q_len, d, 16, 32, quantized)
    assert plan["walk"] == "tc"
    assert (plan["nrs"], plan["row_groups"]) == (nrs, groups)
    assert -(-d // pa.CHUNK_HEAD_DIM) == chunks
    rs = pa.tc_row_bytes(d)
    stage = 2 * 16 * d + 8 * 16 if quantized else 2 * 16 * rs
    smem = (plan["stages"] * stage
            + (2 * (32 * rs + 128) if quantized else 0)
            + 2 * 4 * plan["nrs"] * 32 * 16)
    assert 2 <= plan["stages"] <= 4
    assert smem <= pa.TC_SMEM_BYTES


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
    # "full": the split route's tensor-core walk for bf16 q; fp32 q stays
    # on the first kernel
    "int8_full": (torch.bfloat16, torch.int8, "full", 16, 64, True, True),
    "fp32_q_int8_full": (torch.float32, torch.int8, "full", 16, 64, True,
                         False),
    "d_not_8": (torch.bfloat16, torch.bfloat16, "convert", 16, 36, True,
                False),
    "d_above_128": (torch.bfloat16, torch.bfloat16, "convert", 16, 256, True,
                    True),
    "d_above_256": (torch.bfloat16, torch.bfloat16, "convert", 16, 264, True,
                    True),
    "int8_full_d512": (torch.bfloat16, torch.int8, "full", 16, 512, True,
                       True),
    "d_1024": (torch.bfloat16, torch.bfloat16, "convert", 16, 1024, True,
               True),
    # above 1024 the tensor-core walk sums the scores over passes of 1024
    # columns; at page 16 the ring of D = 1032 exceeds its budget
    "d_above_1024": (torch.bfloat16, torch.bfloat16, "convert", 8, 1032,
                     True, True),
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


@pytest.mark.parametrize("h, h_kv, q_len, d, page, pps, nrs, step", [
    (12, 12, 1, 64, 16, 32, 1, 32), (12, 12, 64, 64, 16, 32, 4, 32),
    (8, 1, 1, 256, 16, 256, 1, 32), (12, 4, 5, 64, 32, 20, 2, 16),
    (4, 4, 1, 32, 16, 3, 1, 3)])
def test_split_plan_full(h, h_kv, q_len, d, page, pps, nrs, step):
    """The int8 "full" schedule: the tensor-core walk at every row count
    (one row included), a split one walk step of full_step_pages pages,
    and a ring of 2-4 stages of one slab and two scale planes beside the
    step's scores."""
    plan = pa.split_plan(h, h_kv, q_len, d, page, pps, True, "full")
    assert (plan["walk"], plan["nrs"]) == ("tc", nrs)
    assert plan["split_pages"] == plan["step_pages"] == step \
        == pa.full_step_pages(page, pps)
    assert plan["n_splits"] * step >= pps
    assert 2 <= plan["stages"] <= 4
    assert pa.split_walk(d, 1, "full") == "tc"
    assert pa.split_walk(64, 1, "qk") == "lanes"


def test_split_plan_fills_the_card_at_the_engine_decode_shape():
    """The serving engine's decode step (B = 32, GPT-3 Small's 12 heads,
    D = 64, page 16, 512 slots a sequence) gives at least two CTAs per SM
    of the H100's 132, where the first kernel had 384 CTAs of which one
    warp in four computed; its T = 64 prefill chunk, on the tensor cores
    in 2 row groups of 32 rows, at least one CTA per SM (the first kernel:
    48)."""
    def ctas(b, plan):  # (B * H_kv * row groups, splits)
        return b * 12 * plan["n_splits"] * plan["row_groups"]

    plan = pa.split_plan(12, 12, 1, 64, 16, 32, False)
    assert (plan["walk"], plan["rps"], plan["nrs"], plan["lg"]) == (
        "lanes", 1, 1, 8)
    assert ctas(32, plan) >= 2 * 132
    chunk = pa.split_plan(12, 12, 64, 64, 16, 32, False)
    assert (chunk["walk"], chunk["nrs"], chunk["row_groups"]) == ("tc", 4, 2)
    assert ctas(1, chunk) >= 132


@pytest.mark.parametrize("h, h_kv, q_len, rps, nrs, groups", [
    (12, 12, 1, 1, 1, 1), (12, 6, 1, 2, 1, 1), (12, 4, 1, 8, 1, 1),
    (12, 1, 1, 8, 2, 1), (12, 12, 64, 8, 4, 2), (12, 4, 64, 8, 4, 6),
    (4, 4, 5, 8, 1, 1)])
def test_split_plan_rows(h, h_kv, q_len, rps, nrs, groups):
    """Rows of a KV head (GQA group x chunk): 1 or 2 in one CTA on the
    lane-group walk; 3 or more in row tiles of rps = 8 rows on the tensor
    cores, nrs tiles a CTA (at most 32 rows), row_groups CTAs."""
    plan = pa.split_plan(h, h_kv, q_len, 64, 16, 32, False)
    assert (plan["rps"], plan["nrs"], plan["row_groups"]) == (rps, nrs,
                                                              groups)
    assert plan["rps"] * plan["nrs"] * plan["row_groups"] >= (h // h_kv) * q_len


def test_split_plan_at_head_dim_256():
    """Gemma 2B's MQA decode step on the engine's shape (B = 32, 8 query
    heads over 1 KV head, D = 256, page 16, 4096 slots a sequence): the
    tensor-core walk with its 8 rows in one row tile and one CTA a split;
    bf16 pages in 16-page splits over 256 pages with a ring of 3 stages
    (16.5 KB each, the rows padded to 528 bytes), 1-byte pages in 8-page
    splits with 2 stages (8 KB and the scales, beside two decoded bf16
    tiles), so 4 CTAs fit an SM; at D = 128 the same 8 rows also take the
    tensor cores; above D = 256 the call passes the head-dim check (it
    fails here only for lying on the CPU), above 1024 it does not."""
    plan = pa.split_plan(8, 1, 1, 256, 16, 256, False)
    assert plan["walk"] == "tc"
    assert (plan["rps"], plan["nrs"], plan["row_groups"]) == (8, 1, 1)
    assert (plan["split_pages"], plan["n_splits"], plan["stages"]) == (16, 16,
                                                                       3)
    assert pa.tc_row_bytes(256) == 528
    quant = pa.split_plan(8, 1, 1, 256, 16, 256, True)
    assert (quant["split_pages"], quant["n_splits"], quant["stages"]) == (
        8, 32, 2)
    below = pa.split_plan(8, 1, 1, 128, 16, 256, False)
    assert (below["walk"], below["split_pages"]) == ("tc", 8)
    with pytest.raises(ValueError, match="must be on"):
        pa._check_cuda_args(*(torch.zeros(1, 1, 264),) * 3, None, None, None,
                            None)
    # no head dim is refused: D = 1032 fails only on the device check
    with pytest.raises(ValueError, match="must be on"):
        pa._check_cuda_args(*(torch.zeros(1, 1, 1032),) * 3, None, None,
                            None, None)


@pytest.mark.parametrize("h, h_kv, q_len, d, walk, nrs, groups", [
    (8, 1, 1, 256, "tc", 1, 1),      # Gemma 2B: decode
    (8, 1, 64, 256, "tc", 4, 16),    # a T = 64 prefill chunk, 512 rows
    (8, 1, 5, 256, "tc", 4, 2),      # the verify chunk, 40 rows
    (4, 2, 1, 192, "tc", 1, 1),      # GQA at D = 192, 2 rows
    (16, 1, 1, 136, "tc", 2, 1),     # 16 rows at D = 136
    (12, 12, 1, 64, "lanes", 1, 1),  # GPT-3 Small: decode
    (12, 12, 64, 64, "tc", 4, 2),    # its T = 64 chunk
    (12, 12, 5, 64, "tc", 1, 1),     # its verify chunk
    (12, 4, 1, 64, "tc", 1, 1),      # GQA 12/4: 3 rows
    (12, 6, 1, 64, "lanes", 1, 1),   # GQA 12/6: 2 rows
])
def test_split_plan_walk(h, h_kv, q_len, d, walk, nrs, groups):
    """The walk split_plan picks: the tensor cores above D = 128 and
    wherever a KV head has 3 rows or more, in row tiles of 8 rows (1, 2 or
    4 a CTA); lane groups for 1 or 2 rows up to D = 128."""
    plan = pa.split_plan(h, h_kv, q_len, d, 16, 32, False)
    rows = (h // h_kv) * q_len
    assert plan["walk"] == pa.split_walk(d, rows) == walk
    assert (plan["nrs"], plan["row_groups"]) == (nrs, groups)
    assert plan["rps"] * plan["nrs"] * groups >= (h // h_kv) * q_len
    if walk == "tc":
        assert plan["rps"] == pa.TC_ROWS and plan["lg"] == 0


@pytest.mark.parametrize("page, d, quantized", [
    (16, 256, False), (16, 256, True), (64, 256, False), (120, 256, True),
    (112, 144, False)])
def test_split_plan_tc_ring_fits(page, d, quantized):
    """On the tensor-core walk the ring, the decoded tiles (1-byte pages)
    and the score buffers fit the H100's shared memory with at least 2
    stages, for the largest pages split_route lets through."""
    dtype = torch.int8 if quantized else torch.bfloat16
    assert pa.split_route(torch.bfloat16, dtype, "convert", page, d)
    plan = pa.split_plan(8, 1, 64, d, page, 8, quantized)
    rs = pa.tc_row_bytes(d)
    stage = 2 * page * d + 8 * page if quantized else 2 * page * rs
    smem = (plan["stages"] * stage
            + (2 * (32 * rs + 128) if quantized else 0)
            + 2 * 4 * plan["nrs"] * 32 * 16)
    assert 2 <= plan["stages"] <= 4
    assert smem <= pa.TC_SMEM_BYTES


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
