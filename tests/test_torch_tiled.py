"""The port's tiled executor and dense oracle against the JAX package's, on
the CPU in float32 (tolerance 1e-4): o, lse and, for the executor, the
gradients of q, k and v through both outputs.

With dropout the two tiled executors draw different masks by design (the
JAX one from ``jax.random``); there the port's executor is held against the
port's flash path, which draws the same murmur3 mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_tpu.ops.reference import causal_mask as jax_causal_mask
from flashattention_tpu.ops.reference import reference_attention as jax_ref
from flashattention_tpu.ops.reference import (
    reference_attention_grads as jax_ref_grads,
)
from flashattention_tpu.ops.tiled import tiled_attention as jax_tiled
from flashattention_tpu_torch.ops import flash_attn as fa
from flashattention_tpu_torch.ops.reference import (
    causal_mask,
    reference_attention,
    reference_attention_grads,
)
from flashattention_tpu_torch.ops.tiled import tiled_attention
from flashattention_tpu_torch.utils.testing import assert_allclose

TOL = 1e-4


def _qkv(b, h, n_q, n_k, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((b, h, n_q, d), (b, h, n_k, d), (b, h, n_k, d), (b, h, n_q, d),
             (b, h, n_q))]


def _mask(shape, seed=2):
    m = np.random.default_rng(seed).random(shape) < 0.7
    m[..., 0] = True  # every row keeps a key
    return m


TILED_CASES = {
    # name: (b, h, n_q, n_k, d, block_k, kwargs)
    "causal": (2, 2, 70, 70, 32, 32, dict(causal=True)),
    "full_ragged": (1, 2, 50, 90, 32, 32, dict(causal=False)),
    "q_offset": (1, 2, 16, 90, 32, 32, dict(causal=True, q_offset=40)),
    "mask2d": (1, 2, 40, 70, 32, 32, dict(causal=False, mask="2d")),
    "mask4d_causal": (2, 2, 40, 40, 16, 16, dict(causal=True, mask="4d")),
    "softcap": (1, 2, 40, 40, 32, 16, dict(causal=True, softcap=2.0)),
    "alibi": (1, 4, 48, 48, 32, 16, dict(causal=True, alibi=True)),
}


def _tiled_kwargs(kw, b, h, n_q, n_k):
    kw = dict(kw)
    jkw, tkw = dict(kw), dict(kw)
    m = kw.pop("mask", None)
    if m is not None:
        arr = _mask((n_q, n_k) if m == "2d" else (b, 1, n_q, n_k))
        jkw["mask"], tkw["mask"] = jnp.asarray(arr), torch.from_numpy(arr)
    if kw.pop("alibi", False):
        sl = (0.5 ** np.arange(1, h + 1)).astype(np.float32)
        for d in (jkw, tkw):
            d.pop("alibi")
        jkw["alibi_slopes"], tkw["alibi_slopes"] = jnp.asarray(sl), torch.from_numpy(sl)
    return jkw, tkw


@pytest.mark.parametrize("case", sorted(TILED_CASES))
def test_tiled_matches_jax_tiled(case):
    b, h, n_q, n_k, d, bk, kw = TILED_CASES[case]
    q, k, v, do, dlse = _qkv(b, h, n_q, n_k, d)
    jkw, tkw = _tiled_kwargs(kw, b, h, n_q, n_k)

    def f(q_, k_, v_):
        return jax_tiled(q_, k_, v_, block_k=bk, **jkw)

    (o, lse), vjp = jax.vjp(f, *[jnp.asarray(x) for x in (q, k, v)])
    ref = [o, lse, *vjp((jnp.asarray(do), jnp.asarray(dlse)))]
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    to, tl = tiled_attention(*leaves, block_k=bk, **tkw)
    torch.autograd.backward([to, tl], [torch.from_numpy(do),
                                       torch.from_numpy(dlse)])
    out = [to, tl] + [t.grad for t in leaves]
    for name, a, r in zip(("o", "lse", "dq", "dk", "dv"), out, ref):
        assert_allclose(a, np.asarray(r), rtol=TOL, atol=TOL,
                        err_msg=f"{case} {name}")


def test_tiled_dropout_draws_the_kernels_mask():
    q, k, v, do, _ = _qkv(2, 2, 64, 64, 32)
    kw = dict(causal=True, dropout_rate=0.25, dropout_seed=321)
    outs = []
    for fn in (lambda *t: tiled_attention(*t, block_k=16, **kw),
               lambda *t: fa.kernel_attention(*t, **kw)):
        leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        o, lse = fn(*leaves)
        (o * torch.from_numpy(do)).sum().backward()
        outs.append([o, lse] + [t.grad for t in leaves])
    for name, a, r in zip(("o", "lse", "dq", "dk", "dv"), *outs):
        assert_allclose(a, r, rtol=TOL, atol=TOL, err_msg=name)


REF_CASES = {
    # name: (n_q, n_k, kwargs)
    "plain": (40, 40, dict()),
    "causal": (40, 40, dict(causal=True)),
    "decode_shape": (8, 40, dict(causal=True)),
    "q_offset": (8, 40, dict(causal=True, q_offset=5)),
    "window_sinks": (40, 40, dict(causal=True, window=7, sinks=3)),
    "softcap_scale": (40, 40, dict(causal=True, softcap=1.5,
                                   softmax_scale=0.3)),
    "bias_mask": (24, 40, dict(bias=True, mask=True)),
    "empty_rows": (16, 16, dict(causal=True, q_offset=-4)),
}


@pytest.mark.parametrize("case", sorted(REF_CASES))
def test_reference_matches_jax_reference(case):
    n_q, n_k, kw = REF_CASES[case]
    q, k, v, _, _ = _qkv(2, 2, n_q, n_k, 16)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("bias"):
        bias = np.random.default_rng(4).standard_normal((2, 1, n_q, n_k))
        jkw["bias"], tkw["bias"] = jnp.asarray(bias), torch.from_numpy(bias)
    if kw.get("mask"):
        m = _mask((n_q, n_k))
        jkw["mask"], tkw["mask"] = jnp.asarray(m), torch.from_numpy(m)
    o, lse = jax_ref(*[jnp.asarray(x) for x in (q, k, v)], **jkw)
    to, tl = reference_attention(*[torch.from_numpy(x) for x in (q, k, v)],
                                 **tkw)
    assert_allclose(to, np.asarray(o), rtol=TOL, atol=TOL, err_msg="o")
    assert_allclose(tl, np.asarray(lse), rtol=TOL, atol=TOL, err_msg="lse")


def test_reference_grads_and_causal_mask_match_jax():
    q, k, v, do, _ = _qkv(1, 2, 24, 24, 16)
    ref = jax_ref_grads(*[jnp.asarray(x) for x in (q, k, v, do)], causal=True,
                        window=6)
    got = reference_attention_grads(*[torch.from_numpy(x) for x in (q, k, v, do)],
                                    causal=True, window=6)
    for a, r in zip(got, ref):
        assert_allclose(a, np.asarray(r), rtol=TOL, atol=TOL)
    for n_q, n_k, off in ((5, 9, 0), (9, 9, 2), (4, 4, -1)):
        np.testing.assert_array_equal(
            causal_mask(n_q, n_k, q_offset=off).numpy(),
            np.asarray(jax_causal_mask(n_q, n_k, q_offset=off)))


def test_tiled_rejects_bad_arguments():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError):
        tiled_attention(q, q, q, mask=torch.ones(8, 9, dtype=torch.bool))
    with pytest.raises(ValueError):
        tiled_attention(q, q, q, dropout_rate=0.1)
    with pytest.raises(ValueError):
        tiled_attention(q, q, q, alibi_slopes=torch.ones(3))
