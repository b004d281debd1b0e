"""The PyTorch port's paged-cache appends against the JAX package.

One entry, ``paged_append`` (behind ``append_to_pages``), serves a decode
step (T = 1) and a prefill chunk (T > 1); its plain version runs here.
Every comparison is bit-exact, with inputs made from a seed with numpy:

- T = 1 against JAX's ``append_to_pages``, which runs
  ``pallas_append_decode`` in interpret mode at D % 128 == 0 and its scatter
  otherwise; T > 1 against its scatter. ``valid_len`` padding and positions
  past a sequence's page capacity are dropped.
- Tokens given as the strided head views of a fused (B, T, 3·H·D) QKV
  projection, as the serving engine passes them, in bf16 and fp32, into
  bf16 and fp32 pages.
- ``pallas_append_decode``'s one-token-per-row form (``append_rows`` of
  ``test_torch_cuda.py``: ``paged_append`` with ``page_indices = phys[:,
  None]``, ``lengths = slot``, ``valid_len = ok``) with ``ok = 0`` rows and
  rows whose page or slot is out of range, which write nothing.

``test_torch_cuda.py`` holds the CUDA kernel against the plain version on
the card.
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
from test_torch_cuda import append_rows
from test_torch_cuda import decode_rows as _decode_rows
from test_torch_cuda import fused_tokens

JAX_OF = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


def _bits(x):
    """Raw bytes of a torch tensor or a JAX array, for bit equality."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


@pytest.mark.parametrize("page", [8, 16])
def test_decode_append_matches_pallas_interpret_bit_exact(page):
    kp, vp, kn, vn, phys, slot, ok = _decode_rows(page=page)
    kj, vj = pallas_append_decode(
        *(jnp.asarray(x) for x in (kp, vp, kn, vn, phys, slot)),
        jnp.asarray(ok).astype(bool), interpret=True,
    )
    kt, vt = (torch.from_numpy(x.copy()) for x in (kp, vp))
    out = append_rows(kt, vt, *(torch.from_numpy(x) for x in
                                (kn, vn, phys, slot, ok)))
    assert out[0] is kt and out[1] is vt  # in place
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    # ok == 0 rows left their page untouched
    for b in np.flatnonzero(ok == 0):
        np.testing.assert_array_equal(kt[:, phys[b]].numpy(), kp[:, phys[b]])


def test_rows_out_of_range_write_nothing():
    """Rows whose page is outside [0, P) or whose slot is outside
    [0, page) drop like ``ok = 0`` rows: the port equals
    ``pallas_append_decode`` with those rows' ``ok`` cleared."""
    kp, vp, kn, vn, phys, slot, ok = _decode_rows(b=6, page=8)
    num_pages, page = kp.shape[1], kp.shape[2]
    phys_t, slot_t = phys.copy(), slot.copy()
    phys_t[0], slot_t[2], phys_t[3], slot_t[5] = -1, page, num_pages, -1
    ok_t = np.ones_like(ok)  # only the range drops the four rows
    ok_t[1] = 0
    keep = np.array([0, 0, 0, 0, 1, 0], bool)
    kj, vj = pallas_append_decode(
        *(jnp.asarray(x) for x in (kp, vp, kn, vn, phys, slot)),
        jnp.asarray(keep), interpret=True,
    )
    kt, vt = (torch.from_numpy(x.copy()) for x in (kp, vp))
    append_rows(kt, vt, *(torch.from_numpy(x) for x in
                          (kn, vn, phys_t, slot_t, ok_t)))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert int((kt != torch.from_numpy(kp)).any(-1).sum()) == kp.shape[0]


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


@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("src", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dst", [torch.bfloat16, torch.float32])
def test_fused_projection_append_matches_jax(dst, src, t):
    """Tokens as the head views of a fused QKV projection, in either type,
    into bf16 or fp32 pages: equal to JAX's ``append_to_pages`` on the same
    values (D = 128, so T = 1 runs ``pallas_append_decode`` in interpret
    mode there), with padding and over-capacity positions dropped."""
    b, h, d, page, pps = 4, 2, 128, 4, 3
    num_pages = b * pps + 1
    rng = np.random.default_rng(10 + t)
    k, v = fused_tokens(rng, b, h, t, d, src)
    assert k.stride(3) == 1 and not k.is_contiguous()
    pi = rng.permutation(num_pages)[: b * pps].reshape(b, pps).astype(np.int32)
    lengths = np.array([0, 5, 12, 10], np.int32)  # row 2 full; row 3 overruns
    valid = np.array([t, t, t, 0 if t == 1 else 2], np.int32)
    jc = jax_append_to_pages(
        jax_init(h, num_pages, page, d, dtype=JAX_OF[dst]),
        *(jnp.asarray(x.float().numpy()).astype(JAX_OF[src]) for x in (k, v)),
        jnp.asarray(pi), jnp.asarray(lengths), valid_len=jnp.asarray(valid))
    tc = paged_kv.init_paged_cache(h, num_pages, page, d, dtype=dst,
                                   device="cpu")
    paged_kv.append_to_pages(tc, k, v, torch.from_numpy(pi),
                             torch.from_numpy(lengths),
                             valid_len=torch.from_numpy(valid))
    np.testing.assert_array_equal(_bits(tc.k_pages), _bits(jc.k_pages))
    np.testing.assert_array_equal(_bits(tc.v_pages), _bits(jc.v_pages))
    kept = sum(max(0, min(int(n), pps * page - int(ln)))
               for ln, n in zip(lengths, valid))
    assert int((tc.k_pages != 0).any(-1).sum()) == kept * h


def test_append_rejects_bad_shapes():
    kp, vp, kn, vn, phys, slot, ok = (torch.from_numpy(x) for x in
                                      _decode_rows())
    with pytest.raises(ValueError):  # 2 of the cache's 3 heads
        append_rows(kp, vp, kn[:, :2], vn, phys, slot, ok)
    with pytest.raises(ValueError):  # a page table of 2 rows for 6
        append_rows(kp, vp, kn, vn, phys[:2], slot, ok)
    k4, v4 = kn[:, :, None], vn[:, :, None]
    lengths = slot.clone()
    with pytest.raises(ValueError):  # (B, H, D) where (B, H, T, D) belongs
        pap.paged_append(kp, vp, kn, vn, phys[:, None], lengths)
    with pytest.raises(ValueError):
        pap.paged_append(kp, vp, k4, v4, phys[:, None], lengths[:2])
    with pytest.raises(ValueError):
        pap.paged_append(kp, vp, k4, v4, phys[:2, None], lengths)
    with pytest.raises(ValueError):  # bf16/fp32 pages take no scales
        pap.paged_append(kp, vp, k4, v4, phys[:, None], lengths,
                         k_scales=kp[..., :1], v_scales=vp[..., :1])


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
