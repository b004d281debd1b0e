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
