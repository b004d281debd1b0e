"""The port's block-sparse attention (plain versions, CPU) against the JAX
package's ``pallas_sparse_attention`` in interpret mode: the tile map and
the compacted lists exactly, then o, lse, dq, dk and dv through autograd
and ``jax.vjp`` from the same numpy inputs.

Tolerances: the JAX ladder, fp32 1e-4 for o and the gradients and 5e-3
for the LSE. Empty rows are compared exactly: o = 0 with lse = -inf where
a q block has no active KV block, lse = the mask value where a visited
block's row sees no key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_tpu.ops.pallas_sparse import (
    _compact_rows,
    _tile_pattern,
    pallas_sparse_attention,
)
from flashattention_tpu_torch.ops import sparse_attention
from flashattention_tpu_torch.ops import sparse_attn as sa
from flashattention_tpu_torch.ops.reference import DEFAULT_MASK_VALUE
from flashattention_tpu_torch.utils.testing import assert_allclose

TOL = 1e-4
LSE_TOL = 5e-3

P4 = [[1, 0, 0, 0], [1, 1, 0, 0], [0, 1, 1, 0], [1, 0, 1, 1]]
# Longformer/BigBird local + global on 8 x 8 tiles: q tile i sees tiles
# i - 3 .. i and tile 0; on 4 x 4 tiles with a window of 2 (q tile 3 skips
# tile 1)
LG8 = [[int(0 <= i - j < 4 or j == 0) for j in range(8)] for i in range(8)]
LG4 = [[int(0 <= i - j < 2 or j == 0) for j in range(4)] for i in range(4)]
LG16W16 = [[int(0 <= i - j < 16 or j == 0) for j in range(16)]
           for i in range(16)]
# name: ((b, h, h_kv, n_q, n_k, d), pattern or None, kwargs, use dlse)
CASES = {
    "causal_4x4": ((1, 2, 2, 512, 512, 64), P4, dict(causal=True), False),
    "full_4x4": ((1, 2, 2, 512, 512, 64), P4, dict(causal=False), False),
    "pattern_none": ((1, 2, 2, 384, 384, 64), None, dict(causal=True), False),
    "empty_q_block": ((1, 1, 1, 256, 256, 64), [[1, 1], [0, 0]],
                      dict(causal=False), False),
    "unaligned_200": ((1, 1, 1, 200, 200, 64), [[1, 1], [1, 1]],
                      dict(causal=True), False),
    "gqa_4_2": ((1, 4, 2, 256, 256, 64), [[1, 0], [1, 1]], dict(causal=True),
                False),
    "block_q_ne_block_k": ((1, 2, 2, 256, 256, 64),
                           [[1, 0], [0, 1], [1, 1], [1, 0]],
                           dict(causal=True, block_q=64, block_k=128), False),
    "nq_ne_nk": ((2, 2, 1, 128, 256, 64), [[1, 0, 1, 1], [0, 1, 0, 1]],
                 dict(causal=True, block_q=64, block_k=64), False),
    "dlse": ((1, 2, 2, 256, 256, 64), [[1, 0], [1, 1]], dict(causal=True),
             True),
    # rows 0-63 of q block 0 see no key of KV block 1 (cols 64-127)
    "masked_rows": ((1, 2, 2, 256, 256, 64), [[0, 1, 0, 0], [1, 0, 1, 1]],
                    dict(causal=True, block_q=128, block_k=64), True),
    # head dim 256 (the D-split kernels on the card): MQA over 4 heads, and
    # D = 136 with rows that see no key
    "d256_gqa": ((1, 4, 1, 256, 256, 256), None, dict(causal=True), True),
    "d136_masked_rows": ((1, 2, 2, 256, 256, 136),
                         [[0, 1, 0, 0], [1, 0, 1, 1]],
                         dict(causal=True, block_q=128, block_k=64), False),
    # a head dim that is not a multiple of 8: the wrapper pads it to 40
    "d36": ((1, 2, 1, 256, 256, 36), [[1, 0], [1, 1]], dict(causal=True),
            True),
    # the fp32 tensor-core route's card cases at reduced sizes: the model
    # call's local + global pattern on tiles of 128 (i), and D = 128 with
    # GQA, N_q != N_k, blocks 64 x 128, an emptied q-block row and an LSE
    # cotangent (j)
    "i_model_fp32": ((1, 2, 2, 1024, 1024, 64), LG8, dict(causal=True),
                     False),
    "j_d128_gqa_ragged": ((1, 4, 2, 192, 256, 128), [[1, 0], [0, 0], [1, 1]],
                          dict(causal=True, block_q=64, block_k=128), True),
    # the fp32 wide route's main path at a reduced size: phase 7e's MQA call
    # (D = 256, one KV head) on tiles of 128, with an LSE cotangent
    "l_d256_fp32_mqa": ((1, 4, 1, 512, 512, 256), LG4, dict(causal=True),
                        True),
    # blocks that are not multiples of 64 (the mma kernels in bf16 on the
    # card): 16 x 16; 32 x 32 with GQA, N_q != N_k and an LSE cotangent;
    # 24 x 40 at D = 136 with an emptied q-block row (slices past a block's
    # end, partial key sub-tiles); 32 x 32 at D = 256 with one KV head
    "b16_local_global": ((1, 2, 2, 128, 128, 64), LG8, dict(
        causal=True, block_q=16, block_k=16), False),
    "b32_gqa_nq_ne_nk": ((2, 4, 2, 96, 160, 64), [[1, 0, 1, 0, 0],
                                                  [0, 1, 1, 1, 0],
                                                  [1, 0, 0, 1, 1]],
                         dict(causal=True, block_q=32, block_k=32), True),
    "b24x40_d136_empty_row": ((1, 4, 2, 120, 160, 136),
                              [[1, 0, 0, 1], [0, 0, 0, 0], [1, 1, 0, 0],
                               [0, 1, 1, 0], [1, 0, 1, 1]],
                              dict(causal=True, block_q=24, block_k=40),
                              False),
    "b32_d256_mqa": ((1, 4, 1, 128, 128, 256), LG4, dict(
        causal=True, block_q=32, block_k=32), True),
    # chip_smoke.py phase 7g's pattern (the fp32 mma kernels on the card) at
    # a reduced size: local + global at width 16 on blocks of 32, N = 512,
    # with an LSE cotangent
    "b32_w16_fp32_dlse": ((1, 2, 2, 512, 512, 64), LG16W16, dict(
        causal=True, block_q=32, block_k=32), True),
}


def _inputs(b, h, h_kv, n_q, n_k, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, n_q, d)).astype(np.float32)
    k = rng.standard_normal((b, h_kv, n_k, d)).astype(np.float32)
    v = rng.standard_normal((b, h_kv, n_k, d)).astype(np.float32)
    do = rng.standard_normal((b, h, n_q, d)).astype(np.float32)
    dlse = rng.standard_normal((b, h, n_q)).astype(np.float32)
    return q, k, v, do, dlse


def _run_jax(q, k, v, do, dlse, pattern, kw):
    pat = None if pattern is None else jnp.asarray(pattern, bool)

    def f(q_, k_, v_):
        return pallas_sparse_attention(q_, k_, v_, pat, interpret=True, **kw)

    (o, lse), vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    grads = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    return [np.asarray(x, np.float32) for x in (o, lse, *grads)]


def _run_port(q, k, v, do, dlse, pattern, kw):
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    pat = None if pattern is None else torch.tensor(pattern, dtype=torch.bool)
    o, lse = sparse_attention(*leaves, pat, **kw)
    torch.autograd.backward([o, lse], [torch.from_numpy(do),
                                       torch.from_numpy(dlse)])
    return [o, lse] + [t.grad for t in leaves]


@pytest.mark.parametrize("case", sorted(CASES))
def test_sparse_attention_matches_jax(case):
    shape, pattern, kw, use_dlse = CASES[case]
    q, k, v, do, dlse = _inputs(*shape)
    if not use_dlse:
        dlse = np.zeros_like(dlse)
    ref = _run_jax(q, k, v, do, dlse, pattern, kw)
    got = _run_port(q, k, v, do, dlse, pattern, kw)
    for name, g, r in zip(("o", "lse", "dq", "dk", "dv"), got, ref):
        assert tuple(g.shape) == r.shape, name
        tol = LSE_TOL if name == "lse" else TOL
        assert_allclose(g, r, rtol=tol, atol=tol, err_msg=f"{case} {name}")


def _port_case(case):
    shape, pattern, kw, _ = CASES[case]
    q, k, v, do, _ = _inputs(*shape)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o, lse = sparse_attention(*leaves, torch.tensor(pattern, dtype=torch.bool),
                              **kw)
    (o * torch.from_numpy(do)).sum().backward()
    return o.detach(), lse.detach(), leaves[0].grad


def test_empty_rows_are_exact():
    """o = 0 and lse = -inf on a q block with no active KV block (and no
    gradient reaches it); o = 0 and lse = the mask value on a visited
    block's rows that see no key."""
    o, lse, dq = _port_case("empty_q_block")
    assert torch.equal(o[:, :, 128:], torch.zeros_like(o[:, :, 128:]))
    assert bool(torch.isneginf(lse[:, :, 128:]).all())
    assert bool((lse[:, :, :128] > -1e30).all())
    assert torch.equal(dq[:, :, 128:], torch.zeros_like(dq[:, :, 128:]))
    o, lse, dq = _port_case("masked_rows")
    assert torch.equal(o[:, :, :64], torch.zeros_like(o[:, :, :64]))
    assert bool((lse[:, :, :64] == DEFAULT_MASK_VALUE).all())
    assert bool((lse[:, :, 64:] > -1e30).all())
    assert torch.equal(dq[:, :, :64], torch.zeros_like(dq[:, :, :64]))


@pytest.mark.parametrize("n_q,n_k,bq,bk,causal", [
    (512, 512, 128, 128, True), (512, 512, 128, 128, False),
    (384, 1024, 64, 128, True), (1000, 600, 128, 64, True),
])
def test_tile_lists_equal_jax(n_q, n_k, bq, bk, causal):
    rng = np.random.default_rng(n_q + n_k)
    nqt, nkt = -(-n_q // bq), -(-n_k // bk)
    pattern = rng.random((nqt, nkt)) < 0.4
    pattern[1] = False  # an empty row
    off = n_k - n_q
    ja = _tile_pattern(jnp.asarray(pattern), nqt, nkt, bq, bk, causal, off)
    ta = sa.tile_pattern(torch.from_numpy(pattern), nqt, nkt, bq, bk, causal,
                         off)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    for jt, tt in ((ja, ta), (ja.T, ta.t())):
        jl, jc = _compact_rows(jt)
        tl, tc = sa.compact_rows(tt)
        assert tl.dtype == tc.dtype == torch.int32
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_rejects_like_jax():
    q = torch.zeros(1, 2, 256, 64)
    with pytest.raises(ValueError, match=r"pattern must be \(n_q_tiles"):
        sparse_attention(q, q, q, torch.ones(3, 2, dtype=torch.bool))
    with pytest.raises(ValueError, match=r"pattern must be \(n_q_tiles"):
        pallas_sparse_attention(*(jnp.zeros((1, 2, 256, 64)),) * 3,
                                jnp.ones((3, 2), bool), interpret=True)
    with pytest.raises(ValueError, match="expected"):
        sparse_attention(q[0], q[0], q[0], None)


# (dtype, head dim, (block_q, block_k)) -> does the tensor-core route take it?
# The shapes of the card cases in tests/test_torch_cuda.py.
ROUTES = [
    (torch.bfloat16, 64, (128, 128), True),    # a_model
    (torch.bfloat16, 128, (128, 128), True),   # b_d128
    (torch.float32, 64, (64, 64), True),       # c_gqa_ragged: 3xTF32
    (torch.bfloat16, 64, (64, 128), True),     # d_nq_ne_nk: one consumer
    (torch.float32, 40, (48, 80), False),      # e_edges_d40
    (torch.float32, 256, (128, 64), True),     # f_d256_masked_rows: wide
    (torch.bfloat16, 64, (64, 64), True),      # g_bf16_gqa_ragged
    (torch.bfloat16, 128, (128, 64), True),    # h_bf16_d128_masked_rows
    (torch.bfloat16, 40, (48, 80), False),     # i_bf16_blocks_48_80
    (torch.bfloat16, 256, (128, 128), True),   # D = 256: the D split
    (torch.bfloat16, 64, (192, 128), True),    # multiples of 64, not of 128
    (torch.bfloat16, 64, (128, 32), False),    # block_k below the TMA box
    (torch.bfloat16, 136, (64, 128), True),    # k_bf16_d136_gqa_ragged
    (torch.bfloat16, 256, (128, 32), False),   # D = 256, block_k below 64
    (torch.bfloat16, 256, (128, 64), True),    # j_bf16_d256_masked_rows
    (torch.float32, 128, (128, 128), True),    # fp32 at D = 128
    (torch.float32, 128, (64, 128), True),     # m_fp32_d128_gqa_ragged
    (torch.float32, 136, (64, 128), True),     # fp32 above D = 128: wide
    (torch.float32, 256, (128, 128), True),    # fp32 at D = 256: wide
    (torch.float32, 64, (128, 32), False),     # fp32, block_k below 64
    (torch.float32, 256, (128, 32), False),    # fp32 at D = 256, block_k 32
    (torch.float32, 64, (32, 32), False),      # u_fp32_model_b32: phase 7g
    (torch.float32, 256, (32, 32), False),     # v_fp32_b32_d256_mqa
    (torch.float32, 136, (24, 40), False),     # w_fp32_b24x40_d136
    (torch.float32, 128, (16, 16), False),     # x_fp32_b16_d128_gqa
    (torch.float32, 256, (96, 80), False),     # chip_smoke.py's case (n)
]


@pytest.mark.parametrize("dtype,d,blocks,tc", ROUTES)
def test_mma_route(dtype, d, blocks, tc):
    """bf16 and fp32 up to D = 256 with blocks that are not both multiples
    of 64 take the mma kernels (fp32 in 3xTF32); no call takes the FMA
    kernels, and none takes two routes."""
    spec = sa.SparseSpec(causal=True, scale=0.125, block_q=blocks[0],
                         block_k=blocks[1])
    assert sa._route(dtype, d, spec) == ("tc" if tc else "mma")


@pytest.mark.parametrize("dtype,d,blocks,tc", ROUTES)
def test_tensor_core_route(dtype, d, blocks, tc):
    """With both blocks multiples of 64, bf16 and fp32 (3xTF32; above D =
    128 the wide kernels) up to D = 256 take the tensor-core kernels; other
    blocks the mma kernels."""
    spec = sa.SparseSpec(causal=True, scale=0.125, block_q=blocks[0],
                         block_k=blocks[1])
    assert sa._tensor_core_route(dtype, d, spec) is tc


# (dtype, head dim, blocks, kv_splits) -> the kernels a forward and a
# backward call launch, as the profiler names them
ROUTE_KERNELS = [
    (torch.float32, 256, (128, 128), 8, {
        "sparse_fwd_f32_wide_sm90_kernel", "sparse_bwd_dkv_f32_wide_sm90_kernel",
        "sparse_bwd_dq_f32_wide_sm90_kernel", "tf32_split_kernel",
        "kv_sum_kernel"}),
    (torch.float32, 136, (64, 128), 1, {
        "sparse_fwd_f32_wide_sm90_kernel", "sparse_bwd_dkv_f32_wide_sm90_kernel",
        "sparse_bwd_dq_f32_wide_sm90_kernel", "tf32_split_kernel"}),
    (torch.float32, 128, (128, 128), 1, {
        "sparse_fwd_f32_sm90_kernel", "sparse_bwd_dkv_f32_sm90_kernel",
        "sparse_bwd_dq_f32_sm90_kernel"}),
    (torch.bfloat16, 256, (128, 128), 1, {
        "sparse_fwd_sm90_kernel", "sparse_bwd_dkv_sm90_kernel",
        "sparse_bwd_dq_sm90_kernel"}),
    # fp32 with blocks that are not both multiples of 64: the fp32 mma
    # kernels (3xTF32), with the sum of the chunks' partials where a walk
    # takes more than one: chip_smoke.py's case (n), phase 7g's call (8
    # chunks) and case (t) (MQA at D = 256, 64 chunks)
    (torch.float32, 256, (96, 80), 1, {
        "sparse_fwd_f32_mma_kernel", "sparse_bwd_dkv_f32_mma_kernel",
        "sparse_bwd_dq_f32_mma_kernel"}),
    (torch.float32, 64, (32, 32), 8, {
        "sparse_fwd_f32_mma_kernel", "sparse_bwd_dkv_f32_mma_kernel",
        "sparse_bwd_dq_f32_mma_kernel", "sparse_bwd_sum_mma_kernel"}),
    (torch.float32, 256, (32, 32), 64, {
        "sparse_fwd_f32_mma_kernel", "sparse_bwd_dkv_f32_mma_kernel",
        "sparse_bwd_dq_f32_mma_kernel", "sparse_bwd_sum_mma_kernel"}),
    # bf16 with blocks that are not both multiples of 64: the mma kernels,
    # with the sum of the dK/dV partials where a KV block's walk is cut
    # into chunks
    (torch.bfloat16, 64, (32, 32), 1, {
        "sparse_fwd_mma_kernel", "sparse_bwd_dkv_mma_kernel",
        "sparse_bwd_dq_mma_kernel"}),
    (torch.bfloat16, 256, (128, 32), 8, {
        "sparse_fwd_mma_kernel", "sparse_bwd_dkv_mma_kernel",
        "sparse_bwd_dq_mma_kernel", "sparse_bwd_sum_mma_kernel"}),
    (torch.bfloat16, 136, (24, 40), 1, {
        "sparse_fwd_mma_kernel", "sparse_bwd_dkv_mma_kernel",
        "sparse_bwd_dq_mma_kernel"}),
]


@pytest.mark.parametrize("dtype,d,blocks,splits,want", ROUTE_KERNELS)
def test_route_kernels(dtype, d, blocks, splits, want):
    """fp32 above D = 128 names the wide kernels and the split of the
    backward's B operands and the sum of the dK/dV partials where a KV
    head's query heads are split over CTAs, the mma route the sum of its
    partials where a KV block's walk is cut into chunks; the other routes
    their three kernels."""
    spec = sa.SparseSpec(causal=True, scale=0.0625, block_q=blocks[0],
                         block_k=blocks[1])
    assert sa.route_kernels(dtype, d, spec, kv_splits=splits) == want


# (B, H, H_kv, N, D, block_q) -> (chunk_len, chunks)
@pytest.mark.parametrize("b,h,h_kv,n,d,block_q,want", [
    (2, 12, 12, 4096, 64, 32, (16, 8)),   # phase 7f: the global column in 8
    (1, 8, 1, 4096, 256, 32, (16, 64)),   # chip_smoke.py's case (q): MQA
    (1, 8, 2, 2048, 128, 16, (32, 16)),   # case (p): blocks of 16, GQA 8/2
    (2, 8, 2, 384, 136, 24, (16, 4)),     # case (r): 2 steps an entry
    (1, 4, 2, 200, 64, 32, (14, 1)),      # every walk in one chunk
    (2, 12, 12, 16384, 64, 32, (256, 2)),  # the partials' budget: longer
])
def test_mma_dkv_chunks(b, h, h_kv, n, d, block_q, want):
    """The mma dK/dV kernel cuts a KV block's walk of (query head, q block)
    entries into chunks of 32 16-row steps, enough chunks for the longest
    walk the pattern allows (every q block, every head of the group), and
    no more than the fp32 partials of ``MMA_SCRATCH_BYTES`` allow."""
    k_numel = b * h_kv * n * d
    chunk_len, chunks = sa._mma_chunks(h, h_kv, n, block_q, k_numel)
    assert (chunk_len, chunks) == want
    assert chunk_len * chunks >= h // h_kv * -(-n // block_q)
    assert chunks == 1 or 8 * chunks * k_numel <= sa.MMA_SCRATCH_BYTES


# (B, H, H_kv, N, D, block) -> (chunk_len, chunks) of an fp32 backward
@pytest.mark.parametrize("b,h,h_kv,n,d,block,want", [
    (2, 12, 12, 4096, 64, 32, (16, 8)),   # phase 7g: phase 7f in fp32
    (1, 8, 1, 4096, 256, 32, (16, 64)),   # chip_smoke.py's case (t): MQA
    (1, 8, 2, 1000, 256, 96, (5, 9)),     # case (n): 6 steps an entry
])
def test_fp32_mma_backward_scratch(b, h, h_kv, n, d, block, want):
    """The fp32 mma backward takes the bf16 route's chunks and scratch: one
    chunk rule for both dtypes, partials in fp32 either way (2 chunks |k|
    values, allocated only where a walk takes more than one chunk)."""
    q = torch.empty(b, h, n, d, device="meta")
    k = torch.empty(b, h_kv, n, d, device="meta")
    spec = sa.SparseSpec(causal=True, scale=d ** -0.5, block_q=block,
                         block_k=block)
    assert sa._route(torch.float32, d, spec) == "mma"
    assert sa._mma_chunks(h, h_kv, n, block, k.numel()) == want
    scratch, more = sa._bwd_scratch("mma", q, k, spec)
    assert more[1:] == list(want)
    assert scratch.dtype == torch.float32
    assert scratch.numel() == 2 * want[1] * k.numel()


@pytest.mark.parametrize("kv_heads,n_k,group,want", [
    (1, 4096, 8, 8),   # phase 7e's call: Gemma 2B's MQA, 8 query heads
    (2, 1024, 4, 4),   # chip_smoke.py's case (k): GQA 8/2
    (4, 512, 4, 4),    # case (m): B = 2, GQA 8/2, N_k 512
    (8, 8192, 4, 1),   # enough CTAs without a split
])
def test_sparse_wide_backward_splits_the_group(kv_heads, n_k, group, want):
    """The sparse wide backward spreads a KV head's query heads over dK/dV
    CTAs by the flash backward's rule: one scratch function, one split rule
    (on 132 SMs)."""
    from flashattention_tpu_torch.ops import flash_attn as fa

    assert sa._wide_scratch is fa._wide_scratch
    assert fa._kv_splits(kv_heads, n_k, group, 132) == want


# Head dims above 256 (the wide kernels on the card, bf16 and fp32), each
# with an LSE cotangent: GQA at D = 264 on blocks of 128; MQA at D = 512
# with q-block row 0 emptied; D = 264 on blocks of 32 with GQA and q-block
# row 1 emptied; MQA at D = 512 on blocks of 32; D = 260, which the wrapper
# pads to 264.
WIDE_CASES = {
    "d264_gqa_b128": ((1, 4, 2, 256, 256, 264), [[1, 0], [1, 1]], {}),
    "d512_mqa_b128_empty_row": ((1, 2, 1, 256, 256, 512), [[0, 0], [1, 1]],
                                {}),
    "d264_gqa_b32_empty_row": ((1, 4, 2, 128, 128, 264),
                               [[1, 0, 0, 0], [0, 0, 0, 0], [0, 1, 1, 0],
                                [1, 0, 1, 1]], dict(block_q=32, block_k=32)),
    "d512_mqa_b32": ((1, 2, 1, 128, 128, 512), LG4,
                     dict(block_q=32, block_k=32)),
    "d260_padded": ((1, 2, 1, 128, 128, 260), [[1, 0], [1, 1]],
                    dict(block_q=64, block_k=64)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(WIDE_CASES))
def test_sparse_attention_above_256_matches_jax(case, dtype):
    """o, lse and the gradients under a nonzero LSE cotangent against the
    JAX kernel in interpret mode, from the same inputs rounded to the same
    dtype, at the JAX ladder's rung (fp32 1e-4, bf16 5e-2; LSE 5e-3); rows
    of an emptied q block keep lse = -inf exactly in both."""
    shape, pattern, kw = WIDE_CASES[case]
    q, k, v, do, dlse = _inputs(*shape, seed=21)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    pat = np.asarray(pattern, bool)

    def f(q_, k_, v_):
        return pallas_sparse_attention(q_, k_, v_, jnp.asarray(pat),
                                       causal=True, interpret=True, **kw)

    (jo, jl), vjp = jax.vjp(f, *(jnp.asarray(x, jdt) for x in (q, k, v)))
    jgrads = vjp((jnp.asarray(do, jdt), jnp.asarray(dlse)))
    ref = [np.asarray(x, np.float32) for x in (jo, jl, *jgrads)]
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_(True)
              for x in (q, k, v)]
    o, lse = sparse_attention(*leaves, torch.from_numpy(pat), causal=True,
                              **kw)
    torch.autograd.backward([o, lse], [torch.from_numpy(do).to(tdt),
                                       torch.from_numpy(dlse)])
    got = [o, lse] + [t.grad for t in leaves]
    tol = TOL if dtype == "float32" else 5e-2
    for name, g, r in zip(("o", "lse", "dq", "dk", "dv"), got, ref):
        assert tuple(g.shape) == r.shape, name
        assert g.dtype == (torch.float32 if name == "lse" else tdt), name
        if name == "lse":
            empty = np.isneginf(r)
            np.testing.assert_array_equal(torch.isneginf(g).numpy(), empty)
            assert_allclose(g[torch.from_numpy(~empty)], r[~empty],
                            rtol=LSE_TOL, atol=LSE_TOL,
                            err_msg=f"{case} {dtype} lse")
            continue
        assert_allclose(g.float(), r, rtol=tol, atol=tol,
                        err_msg=f"{case} {dtype} {name}")


# head dims above 256 take the wide route, any dtype and blocks
WIDE_ROUTES = [
    (torch.bfloat16, 264, (96, 80)), (torch.bfloat16, 512, (128, 128)),
    (torch.float32, 512, (32, 32)), (torch.float32, 1024, (128, 128)),
    (torch.bfloat16, 384, (16, 16)),
]


@pytest.mark.parametrize("dtype,d,blocks", WIDE_ROUTES)
def test_wide_route_above_256(dtype, d, blocks):
    """Above D = 256 every call takes the wide kernels, which name three
    kernels of one name for both dtypes and the sum of the dK/dV chunks'
    partials where a walk takes more than one chunk; the tensor-core
    route stops at 256."""
    spec = sa.SparseSpec(causal=True, scale=d ** -0.5, block_q=blocks[0],
                         block_k=blocks[1])
    assert sa._route(dtype, d, spec) == "wide"
    assert not sa._tensor_core_route(dtype, d, spec)
    assert sa._entry("fwd", dtype, "wide") == "fat_sparse_fwd_wide"
    assert sa._entry("bwd", dtype, "wide") == "fat_sparse_bwd_wide"
    names = {"sparse_fwd_wide_kernel", "sparse_bwd_dkv_wide_kernel",
             "sparse_bwd_dq_wide_kernel"}
    assert sa.route_kernels(dtype, d, spec, kv_splits=1) == names
    assert sa.route_kernels(dtype, d, spec, kv_splits=4) == names | {
        "sparse_bwd_sum_mma_kernel"}
    # the limit the D <= 256 kernels keep
    assert sa._route(dtype, sa.SM90_MAX_HEAD_DIM, spec) in ("tc", "mma")


# (B, H, H_kv, N, D, block_q) -> (chunk_len, chunks) above D = 256
@pytest.mark.parametrize("b,h,h_kv,n,d,block_q,want", [
    (1, 4, 1, 4096, 512, 128, (4, 32)),    # phase 7x's call: 32 chunks
    (1, 2, 1, 1024, 1024, 128, (4, 4)),    # chip_smoke.py's case (y)
    (1, 4, 1, 2048, 512, 32, (16, 16)),    # case (x): MQA at blocks of 32
    (1, 4, 1, 16384, 1024, 128, (128, 4)),  # the partials' budget: longer
])
def test_wide_dkv_chunks(b, h, h_kv, n, d, block_q, want):
    """The wide dK/dV kernel takes the mma route's chunk rule; at wide head
    dims the partials' budget (2 chunks |k| fp32 values within
    MMA_SCRATCH_BYTES) bites sooner, and the chunks grow longer rather
    than pass it."""
    k_numel = b * h_kv * n * d
    chunk_len, chunks = sa._mma_chunks(h, h_kv, n, block_q, k_numel)
    assert (chunk_len, chunks) == want
    assert chunk_len * chunks >= h // h_kv * -(-n // block_q)
    assert chunks == 1 or 8 * chunks * k_numel <= sa.MMA_SCRATCH_BYTES
    q = torch.empty(b, h, n, d, device="meta")
    k = torch.empty(b, h_kv, n, d, device="meta")
    spec = sa.SparseSpec(causal=True, scale=d ** -0.5, block_q=block_q,
                         block_k=block_q)
    scratch, more = sa._bwd_scratch("wide", q, k, spec)
    assert more[1:] == list(want)
    assert (scratch is None) == (chunks == 1)
