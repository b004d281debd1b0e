"""The port's quantization helpers (``flashattention_tpu_torch/ops/quant.py``
and ``ops/specs.py``) against the JAX package's: the same numpy inputs give
bit-equal Hadamard rotations, payload bytes, scales and dequantized values,
and the same quantization blocks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_tpu.ops import quant as jquant
from flashattention_tpu.ops.api import _fp8_block
from flashattention_tpu.ops.pallas_fp8 import (
    _dequant_bf16,
    _fp8_blocks,
    _fp8_to_f32_xla,
    quantize_tiles,
)
from flashattention_tpu.ops.specs import pick_fa3_spec
from flashattention_tpu.serving.paged_kv import _quantize_tokens
from flashattention_tpu_torch.ops import fp8_attn, quant, specs

JAX_DTYPE = {"fp8": jnp.float8_e4m3fn, "e5m2": jnp.float8_e5m2,
             "int8": jnp.int8}


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _x(shape, seed=0, spread=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if spread:  # magnitudes from 1e-4 to 1e2: denormal codes appear
        x *= 10.0 ** rng.uniform(-4, 2, size=shape[:-1] + (1,))
    return x


@pytest.mark.parametrize("d", [16, 64, 128])
def test_hadamard_bit_equal(d):
    x = _x((3, 5, d))
    want = np.asarray(jquant.hadamard_transform(jnp.asarray(x)))
    got = quant.hadamard_transform(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 7])
def test_incoherent_process_with_jax_signs_bit_equal(seed):
    q, k = _x((2, 3, 40, 64), 1), _x((2, 3, 40, 64), 2)
    jq, jk = jquant.incoherent_process(jnp.asarray(q), jnp.asarray(k),
                                       seed=seed)
    sign = np.array(jax.random.rademacher(jax.random.key(seed), (64,),
                                            dtype=jnp.float32))
    tq, tk = quant.incoherent_process(torch.from_numpy(q), torch.from_numpy(k),
                                      sign=torch.from_numpy(sign))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    # the default draws +-1 signs from a seeded torch.Generator
    s = quant.rademacher_signs(64, seed)
    assert set(s.tolist()) <= {-1.0, 1.0}
    assert torch.equal(s, quant.rademacher_signs(64, seed))
    # a head dim that is not a power of two is left as it is
    q6 = torch.randn(1, 1, 4, 48)
    assert quant.incoherent_process(q6, q6)[0] is q6


@pytest.mark.parametrize("fmt", ["fp8", "e5m2", "int8"])
@pytest.mark.parametrize("block", [32, 128])
def test_block_quantizers_bit_equal(fmt, block):
    x = _x((2, 3, 256, 64), 3)
    j8, js = quantize_tiles(jnp.asarray(x), block, fmt)
    t8, ts = quant.quantize_blocks(torch.from_numpy(x), block, fmt)
    assert t8.dtype == quant.PAYLOAD_DTYPE[fmt]
    np.testing.assert_array_equal(_bytes(t8), _bytes(j8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # the plain dequantizers agree bit for bit as well
    np.testing.assert_array_equal(
        quant.dequantize_blocks(t8, ts, block).numpy(),
        np.asarray(jquant.dequantize_fp8_blocks(j8, js, block)))
    jd = np.asarray(_dequant_bf16(j8, js, block).astype(jnp.float32))
    np.testing.assert_array_equal(
        quant.dequantize_bf16(t8, ts, block).float().numpy(), jd)


def test_fake_quant_matches():
    """Bit-equal to the eager JAX round trip; the jitted ``fake_quant_fp8``
    is one fp32 ulp off in places (XLA rewrites the division)."""
    x = _x((1, 2, 192, 32), 4)
    got = quant.fake_quant_fp8(torch.from_numpy(x), 64).numpy()
    j8, js = jquant.quantize_fp8_blocks(jnp.asarray(x), 64)
    np.testing.assert_array_equal(
        got, np.asarray(jquant.dequantize_fp8_blocks(j8, js, 64)))
    want = np.asarray(jquant.fake_quant_fp8(jnp.asarray(x), 64))
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=0)


@pytest.mark.parametrize("fmt", ["fp8", "e5m2"])
def test_fp8_decode_of_every_code(fmt):
    """PyTorch's fp8 -> float32 cast equals the JAX package's bit-surgery
    decode on every finite code (NaN/inf codes never occur in payloads)."""
    codes = np.arange(256, dtype=np.uint8)
    jp = jax.lax.bitcast_convert_type(jnp.asarray(codes), JAX_DTYPE[fmt])
    want = np.asarray(_fp8_to_f32_xla(jp))
    got = torch.from_numpy(codes).view(quant.PAYLOAD_DTYPE[fmt]).float().numpy()
    finite = np.isfinite(got)
    assert finite.sum() >= 240
    np.testing.assert_array_equal(got[finite], want[finite])


def test_ragged_inputs_quantize_as_padded():
    """A ragged last block quantizes as JAX's zero-padded one does."""
    x = _x((1, 2, 200, 64), 5)
    bq, _ = specs.fp8_kernel_blocks(200, 200)
    xp = np.pad(x, ((0, 0), (0, 0), (0, bq - 200), (0, 0)))
    j8, js = quantize_tiles(jnp.asarray(xp), bq, "fp8")
    t8, _, _, ts, _, _, bq2, _ = fp8_attn.quantize_inputs(
        *(torch.from_numpy(x),) * 3, specs.FP8_KERNEL_BLOCK_Q,
        specs.FP8_KERNEL_BLOCK_K, "fp8")
    assert bq2 == bq == 224 and t8.shape[2] == 200
    np.testing.assert_array_equal(_bytes(t8), _bytes(j8)[:, :, :200])
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("quant_fmt", ["int8", "fp8", "e5m2"])
def test_token_quantizer_bit_equal(quant_fmt):
    x = _x((5, 3, 64), 6)
    x[0, 0] = 0.0  # an all-zero token takes the 1e-6 floor
    # as the JAX engine runs it: inside the jitted append
    jp, js = jax.jit(_quantize_tokens, static_argnums=(1, 2))(
        jnp.asarray(x), quant_fmt, JAX_DTYPE[quant_fmt])
    tp, ts = quant.quantize_tokens(torch.from_numpy(x), quant_fmt)
    np.testing.assert_array_equal(_bytes(tp), _bytes(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("n_q, n_k", [(1, 1), (100, 37), (200, 200),
                                      (512, 1024), (513, 1025), (4096, 8192),
                                      (8192, 8192)])
def test_kernel_block_rule(n_q, n_k):
    assert specs.fp8_kernel_blocks(n_q, n_k) == _fp8_blocks(n_q, n_k, 512,
                                                            1024)
    assert specs.fp8_kernel_blocks(n_q, n_k, 128, 128) == _fp8_blocks(
        n_q, n_k, 128, 128)


@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("n", [100, 512, 2048, 8192, 20000])
def test_fa3_block_rules(d, n):
    spec = pick_fa3_spec(d, n)
    assert specs.fa3_block_q(d) == spec.block_q
    assert specs.FA3_BLOCK_K == spec.block_k
    assert min(specs.fa3_block_q(d), 512) == specs.FP8_KERNEL_BLOCK_Q
    for pref in (spec.block_q, spec.block_k):
        assert specs.fp8_block(n, pref) == _fp8_block(n, pref)
