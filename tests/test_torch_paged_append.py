"""The PyTorch port's paged-cache appends against the JAX package.

T = 1 (decode): the port's plain append vs ``pallas_append_decode`` in
interpret mode, bit-exact, with ``ok = 0`` rows that must write nothing.
T > 1 (prefill): the port's scatter vs ``append_to_pages``, bit-exact, with
``valid_len`` padding and positions past a sequence's page capacity
dropped. ``test_torch_cuda.py`` holds the CUDA kernel against the plain
version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_tpu.ops.pallas_append import pallas_append_decode
from flashattention_tpu.serving.paged_kv import (
    append_to_pages as jax_append_to_pages,
)
from flashattention_tpu.serving.paged_kv import gather_pages as jax_gather
from flashattention_tpu.serving.paged_kv import init_paged_cache as jax_init
from flashattention_tpu_torch.ops import paged_append as pap
from flashattention_tpu_torch.serving import paged_kv
from test_torch_cuda import decode_rows as _decode_rows


@pytest.mark.parametrize("page", [8, 16])
def test_decode_append_matches_pallas_interpret_bit_exact(page):
    kp, vp, kn, vn, phys, slot, ok = _decode_rows(page=page)
    kj, vj = pallas_append_decode(
        *(jnp.asarray(x) for x in (kp, vp, kn, vn, phys, slot)),
        jnp.asarray(ok).astype(bool), interpret=True,
    )
    kt, vt = (torch.from_numpy(x.copy()) for x in (kp, vp))
    out = pap.paged_append(kt, vt, *(torch.from_numpy(x) for x in
                                     (kn, vn, phys, slot, ok)))
    assert out[0] is kt and out[1] is vt  # in place
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    # ok == 0 rows left their page untouched
    for b in np.flatnonzero(ok == 0):
        np.testing.assert_array_equal(kt[:, phys[b]].numpy(), kp[:, phys[b]])


def _prefill(b=3, h=2, t=12, d=8, page=4, pps=3, seed=1):
    rng = np.random.default_rng(seed)
    kn = rng.standard_normal((b, h, t, d)).astype(np.float32)
    vn = rng.standard_normal((b, h, t, d)).astype(np.float32)
    pi = rng.permutation(b * pps + 2)[: b * pps].reshape(b, pps).astype(np.int32)
    # row 1 runs past its 12-slot capacity (starts at 7): writes >= 12 drop
    lengths = np.array([0, 7, 2], np.int32)
    valid = np.array([12, 12, 5], np.int32)  # row 2: 7 padding rows drop
    return kn, vn, pi, lengths, valid, b * pps + 2, page


@pytest.mark.parametrize("with_valid", [True, False])
def test_prefill_scatter_matches_jax_bit_exact(with_valid):
    kn, vn, pi, lengths, valid, num_pages, page = _prefill()
    h, d = kn.shape[1], kn.shape[3]
    jc = jax_init(h, num_pages, page, d, dtype=jnp.float32)
    jc = jax_append_to_pages(
        jc, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pi),
        jnp.asarray(lengths),
        valid_len=jnp.asarray(valid) if with_valid else None,
    )
    tc = paged_kv.init_paged_cache(h, num_pages, page, d, dtype=torch.float32,
                                  device="cpu")
    paged_kv.append_to_pages(
        tc, torch.from_numpy(kn), torch.from_numpy(vn), torch.from_numpy(pi),
        torch.from_numpy(lengths),
        valid_len=torch.from_numpy(valid) if with_valid else None,
    )
    np.testing.assert_array_equal(tc.k_pages.numpy(), np.asarray(jc.k_pages))
    np.testing.assert_array_equal(tc.v_pages.numpy(), np.asarray(jc.v_pages))
    # the over-capacity tail of row 1 did not wrap onto its last page
    last = pi[1, -1]
    np.testing.assert_array_equal(tc.k_pages[:, last, 3].numpy(),
                                  kn[1, :, 11 - 7])


def test_decode_append_through_cache_matches_jax():
    """T = 1 through append_to_pages: lengths past capacity and
    valid_len == 0 rows write nothing."""
    rng = np.random.default_rng(3)
    b, h, d, page, pps, num_pages = 4, 2, 8, 4, 3, 14
    kn = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    vn = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    pi = rng.permutation(num_pages)[: b * pps].reshape(b, pps).astype(np.int32)
    lengths = np.array([0, 5, 12, 11], np.int32)  # row 2 is full
    valid = np.array([1, 1, 1, 0], np.int32)      # row 3 is padding
    jc = jax_append_to_pages(
        jax_init(h, num_pages, page, d, dtype=jnp.float32),
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pi),
        jnp.asarray(lengths), valid_len=jnp.asarray(valid),
    )
    tc = paged_kv.init_paged_cache(h, num_pages, page, d, dtype=torch.float32,
                                  device="cpu")
    paged_kv.append_to_pages(
        tc, torch.from_numpy(kn), torch.from_numpy(vn), torch.from_numpy(pi),
        torch.from_numpy(lengths), valid_len=torch.from_numpy(valid),
    )
    np.testing.assert_array_equal(tc.k_pages.numpy(), np.asarray(jc.k_pages))
    np.testing.assert_array_equal(tc.v_pages.numpy(), np.asarray(jc.v_pages))
    assert int((tc.k_pages != 0).sum()) == 2 * h * d  # rows 0 and 1 only


def test_append_rejects_bad_shapes():
    kp, vp, kn, vn, phys, slot, ok = (torch.from_numpy(x) for x in
                                      _decode_rows())
    with pytest.raises(ValueError):
        pap.paged_append(kp, vp, kn[:, :2], vn, phys, slot, ok)
    with pytest.raises(ValueError):
        pap.paged_append(kp, vp, kn, vn, phys[:2], slot, ok)


def test_gather_pages_matches_jax():
    """After a prefill append, the gathered per-sequence K/V equal the JAX
    package's gather_pages (float32, bit-exact)."""
    kn, vn, pi, lengths, valid, num_pages, page = _prefill()
    h, d = kn.shape[1], kn.shape[3]
    jc = jax_append_to_pages(
        jax_init(h, num_pages, page, d, dtype=jnp.float32), jnp.asarray(kn),
        jnp.asarray(vn), jnp.asarray(pi), jnp.asarray(lengths),
        valid_len=jnp.asarray(valid),
    )
    tc = paged_kv.init_paged_cache(h, num_pages, page, d, dtype=torch.float32,
                                  device="cpu")
    paged_kv.append_to_pages(
        tc, torch.from_numpy(kn), torch.from_numpy(vn), torch.from_numpy(pi),
        torch.from_numpy(lengths), valid_len=torch.from_numpy(valid),
    )
    kj, vj = jax_gather(jc, jnp.asarray(pi))
    kt, vt = paged_kv.gather_pages(tc, torch.from_numpy(pi))
    assert kt.shape == (3, h, pi.shape[1] * page, d)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
