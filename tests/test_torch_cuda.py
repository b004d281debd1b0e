"""The PyTorch port's CUDA kernels on the card.

Every test here is marked ``cuda`` and skips where there is no GPU; the
file imports neither JAX nor the JAX package, so it also runs on a machine
that has only the port:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

It also holds the paged-attention cases and append rows that the CPU parity
tests (``test_torch_paged_attention.py``, ``test_torch_paged_append.py``)
feed to the JAX package.
"""

import copy
import dataclasses
import re
import time

import numpy as np
import pytest
import torch

from flashattention_tpu_torch.models import train as ttrain
from flashattention_tpu_torch.models.transformer import TransformerConfig, init_params
from flashattention_tpu_torch.ops import flash_attn as fa
from flashattention_tpu_torch.ops import fp8_attn
from flashattention_tpu_torch.ops import paged_append as pap
from flashattention_tpu_torch.ops import paged_attention as pa
from flashattention_tpu_torch.ops.quant import quantize_tokens
from flashattention_tpu_torch.serving import (
    EngineConfig,
    GenerationRequest,
    ServingEngine,
)
from flashattention_tpu_torch.utils.testing import assert_allclose


def paged_inputs(*, b, h, h_kv, d, page, pps, q_len, lengths, seed=0):
    """Pages of noise, a shuffled page table, q of (B, H[, T], D), as numpy."""
    rng = np.random.default_rng(seed)
    num_pages = b * pps + 3
    kp = rng.standard_normal((h_kv, num_pages, page, d)).astype(np.float32)
    vp = rng.standard_normal((h_kv, num_pages, page, d)).astype(np.float32)
    pi = rng.permutation(num_pages)[: b * pps].reshape(b, pps).astype(np.int32)
    shape = (b, h, d) if q_len == 0 else (b, h, q_len, d)
    q = rng.standard_normal(shape).astype(np.float32)
    return q, kp, vp, pi, np.asarray(lengths, np.int32)


CASES = {
    # name: (shape kwargs, attention kwargs); q_len 0 means decode (B, H, D)
    "decode_p16": (dict(b=3, h=4, h_kv=4, d=32, page=16, pps=4, q_len=0,
                        lengths=[37, 5, 64]), {}),
    "decode_p8": (dict(b=3, h=4, h_kv=4, d=32, page=8, pps=6, q_len=0,
                       lengths=[37, 5, 48]), {}),
    "chunk_p16": (dict(b=2, h=4, h_kv=4, d=32, page=16, pps=4, q_len=8,
                       lengths=[40, 8]), {}),
    "chunk_p8": (dict(b=2, h=4, h_kv=4, d=32, page=8, pps=6, q_len=8,
                      lengths=[41, 12]), {}),
    "gqa_decode": (dict(b=2, h=8, h_kv=2, d=16, page=16, pps=3, q_len=0,
                        lengths=[33, 17]), {}),
    "gqa_chunk": (dict(b=2, h=8, h_kv=2, d=16, page=8, pps=5, q_len=4,
                       lengths=[30, 6]), {}),
    "window_sinks_decode": (dict(b=2, h=4, h_kv=2, d=32, page=8, pps=6,
                                 q_len=0, lengths=[45, 9]),
                            dict(window=10, sinks=3)),
    "window_sinks_chunk": (dict(b=1, h=4, h_kv=2, d=32, page=16, pps=4,
                                q_len=16, lengths=[60]),
                           dict(window=9, sinks=4)),
    "window_chunk": (dict(b=1, h=2, h_kv=2, d=32, page=8, pps=4, q_len=8,
                          lengths=[24]), dict(window=9)),
    "softcap": (dict(b=2, h=4, h_kv=4, d=32, page=16, pps=3, q_len=0,
                     lengths=[40, 3]), dict(softcap=0.5, softmax_scale=0.7)),
    "empty_decode": (dict(b=2, h=8, h_kv=2, d=32, page=8, pps=2, q_len=0,
                          lengths=[11, 0]), {}),
    "empty_chunk": (dict(b=2, h=4, h_kv=4, d=32, page=8, pps=3, q_len=4,
                         lengths=[0, 9]), {}),
    "wide_rows_d128": (dict(b=1, h=16, h_kv=2, d=128, page=24, pps=4, q_len=12,
                            lengths=[90]), {}),
    # The split page walk (decode splits of 128 slots, chunk splits of 64):
    # one slot, exactly one split, one slot past its boundary, and empty.
    "split_lengths": (dict(b=4, h=4, h_kv=4, d=32, page=16, pps=20, q_len=0,
                           lengths=[1, 128, 129, 0]), {}),
    # sinks, then a band of 26 pages across two 16-page splits
    "split_window_sinks": (dict(b=2, h=8, h_kv=2, d=32, page=8, pps=40,
                                q_len=0, lengths=[300, 150]),
                           dict(window=200, sinks=20)),
    "split_gqa_chunk64": (dict(b=1, h=12, h_kv=4, d=32, page=16, pps=8,
                               q_len=64, lengths=[100]), {}),
    "split_page24": (dict(b=3, h=4, h_kv=4, d=32, page=24, pps=8, q_len=0,
                          lengths=[170, 24, 25]), {}),
}
# bf16 cases the split route must take (the counter checks it); fp32 takes
# the first kernel.
PAGED_SPLIT = {"decode_p16", "decode_p8", "chunk_p16", "chunk_p8",
               "gqa_decode", "gqa_chunk", "window_sinks_decode",
               "window_sinks_chunk", "window_chunk", "softcap",
               "empty_decode", "empty_chunk", "wide_rows_d128",
               "split_lengths", "split_window_sinks", "split_gqa_chunk64",
               "split_page24"}


def decode_rows(b=6, h=3, d=16, num_pages=10, page=8, seed=0):
    """One token per row for the decode append, distinct pages, two
    ``ok = 0`` rows; numpy."""
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((h, num_pages, page, d)).astype(np.float32)
    vp = rng.standard_normal((h, num_pages, page, d)).astype(np.float32)
    kn = rng.standard_normal((b, h, d)).astype(np.float32)
    vn = rng.standard_normal((b, h, d)).astype(np.float32)
    phys = rng.permutation(num_pages)[:b].astype(np.int32)
    slot = rng.integers(0, page, size=b).astype(np.int32)
    ok = np.array([1, 0, 1, 1, 0, 1][:b], np.int32)
    return kp, vp, kn, vn, phys, slot, ok


def append_rows(k_pages, v_pages, kn, vn, phys, slot, ok):
    """``pallas_append_decode``'s one-token-per-row form (row b of
    ``kn``/``vn`` (B, H_kv, D) to page ``phys[b]``, slot ``slot[b]`` where
    ``ok[b]``) through ``paged_append``: ``page_indices = phys[:, None]``,
    ``lengths = slot``, ``valid_len = ok``, so a page outside [0, P) or a
    slot outside [0, page) drops the row too."""
    return pap.paged_append(k_pages, v_pages, kn[:, :, None], vn[:, :, None],
                            phys[:, None], slot, ok.to(torch.int32))


def fused_tokens(rng, b, h, t, d, dtype, device="cpu", offset=0):
    """K and V (B, H, T, D) as the serving engine's ``_qkv`` makes them: head
    views of one fused (B, T, 3·H·D) projection (D stride 1, not
    contiguous). ``offset`` elements ahead of Q in each projection row move
    every view off its alignment."""
    qkv = torch.from_numpy(
        rng.standard_normal((b, t, offset + 3 * h * d)).astype(np.float32))
    _, k, v = torch.split(qkv.to(device, dtype)[..., offset:], h * d, dim=-1)
    return tuple(x.reshape(b, t, h, d).transpose(1, 2) for x in (k, v))


PAGE_FORMATS = ["bf16", "fp32", "int8", "fp8", "e5m2"]
PAGE_DTYPE = {"bf16": torch.bfloat16, "fp32": torch.float32}


def append_inputs(kind, fmt, src, device, seed=0, d=64, offset=0):
    """The engine's append shapes (H_kv = 12, D = 64, page 16, 512 slots a
    sequence) on ``device``: pages of noise in ``fmt`` ((payload, scales)
    or (values, None) for K and V), K/V views of a fused projection in
    ``src`` (``offset`` elements off its start, as ``fused_tokens``), page
    table, lengths, valid_len and the dump page.

    decode: B = 32, T = 1; every fourth slot idle on the dump page (length
    0, a row of dump pages, as the engine routes it), one sequence full
    (length 512: dropped), one with valid_len 0 (dropped), one token below
    the 1e-6 scale floor. chunk: B = 1, T = 64 from position 480 with
    valid_len 50: tokens 32-49 pass the capacity and drop, 50-63 are
    padding. verify (the speculative engine's chunk): B = 32, T = 5 at
    ``verify_lengths``, every fourth slot idle; slot 0's rows past
    position 511 drop."""
    rng = np.random.default_rng(seed)
    h, page, pps = 12, 16, 32
    b, t = {"decode": (32, 1), "chunk": (1, 64), "verify": (32, 5)}[kind]
    num_pages, dump = b * pps + 1, 0
    kp, vp = (rng.standard_normal((h, num_pages, page, d)).astype(np.float32)
              for _ in range(2))
    if fmt in PAGE_DTYPE:
        pages = [torch.from_numpy(x).to(device, PAGE_DTYPE[fmt])
                 for x in (kp, vp)]
        pages = [pages[0], None, pages[1], None]
    else:
        pages = quantized_pages(kp, vp, fmt, device)
    k, v = fused_tokens(rng, b, h, t, d, src, device, offset)
    pi = (rng.permutation(num_pages - 1)[: b * pps] + 1).reshape(b, pps)
    if kind == "decode":
        lengths = rng.integers(0, pps * page, size=b)
        idle = np.arange(b) % 4 == 3
        pi[idle], lengths[idle] = dump, 0
        lengths[0] = pps * page
        valid = np.ones(b, np.int64)
        valid[5] = 0
        k[2] *= 1e-8
    elif kind == "verify":
        lengths = verify_lengths(rng)
        idle = np.arange(b) % 4 == 3
        pi[idle], lengths[idle] = dump, 0
        valid = np.full(b, t)
    else:
        lengths, valid = np.array([480]), np.array([50])
    pi, lengths, valid = (torch.from_numpy(x.astype(np.int32)).to(device)
                          for x in (pi, lengths, valid))
    return pages, k, v, pi, lengths, valid, dump


def verify_lengths(rng, b=32, t=5, capacity=512):
    """Slot lengths before a speculative verify chunk of ``t`` rows (the
    engine's B = 32, gamma = 4): drawn from [33, 505], slot 0 at
    ``capacity - t + 1`` (its last row passes the page capacity), slot 1
    at 46 (its chunk crosses a page boundary), slots 2 and 3 at 33 and
    505."""
    lengths = rng.integers(33, 506, size=b)
    lengths[:4] = [capacity - t + 1, 46, 33, 505]
    return lengths


def append_bytes_equal(got, want, dump):
    """Payloads and scales equal bit for bit outside the dump page."""
    keep = [p for p in range(got[0].shape[1]) if p != dump]
    return all(torch.equal(g[:, keep].view(torch.uint8),
                           w[:, keep].view(torch.uint8))
               for g, w in zip(got, want) if g is not None)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


# bf16: the paged kernel rounds p at each tile's running max, the plain
# version at the row's final max; one bf16 ulp of an output near 2 is 1.6e-2.
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_matches_plain(cuda_device, case, dtype):
    shape, kw = CASES[case]
    args = [torch.from_numpy(x).to(cuda_device) for x in paged_inputs(**shape)]
    for i in range(3):
        args[i] = args[i].to(dtype)
    before = pa.paged_attention.launches, pa.paged_attention.split_launches
    o = pa.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    split = int(dtype == torch.bfloat16 and case in PAGED_SPLIT)
    assert (pa.paged_attention.launches - before[0],
            pa.paged_attention.split_launches - before[1]) == (1, split)
    assert o.dtype == dtype and o.shape == args[0].shape
    ref = pa.paged_attention_plain(*args, **kw)
    tol = KERNEL_TOL[dtype]
    assert_allclose(o, ref, rtol=tol, atol=tol, err_msg=case)
    # rows of empty sequences are exactly zero
    for i, n in enumerate(shape["lengths"]):
        if n == 0:
            assert not o[i].any()


@pytest.mark.cuda
def test_paged_attention_kernel_rejects_what_it_does_not_take(cuda_device):
    shape, _ = CASES["decode_p8"]
    q, kp, vp, pi, ln = (torch.from_numpy(x).to(cuda_device)
                         for x in paged_inputs(**shape))
    with pytest.raises(TypeError):
        pa.paged_attention(q.half(), kp.half(), vp.half(), pi, ln)
    with pytest.raises(TypeError):
        pa.paged_attention(q, kp, vp, pi.long(), ln)
    with pytest.raises(ValueError):
        pa.paged_attention(q, kp, vp, pi.cpu(), ln)


def device_kernels_of(fn, tries=3):
    """Names of the device events that ``fn()`` runs, under torch.profiler,
    in launch order, between two marker fills of one element. CUPTI now and
    then records nothing of so short a window; the window is then profiled
    again (``fn`` must be idempotent), at most ``tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    marker = torch.empty(1, device="cuda")
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            marker.fill_(1.0)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            marker.fill_(2.0)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        fills = [i for i, e in enumerate(events) if "FillFunctor" in e.name]
        if len(fills) == 2:
            return [e.name for e in events[fills[0] + 1: fills[1]]]
    pytest.fail(f"the profiler recorded no marker pair in {tries} windows")


def _append_both(pages, k, v, pi, lengths, valid):
    """The kernel and the plain version on copies of ``pages``."""
    got = [x if x is None else x.clone() for x in pages]
    want = [x if x is None else x.clone() for x in pages]
    before = pap.paged_append.launches
    pap.paged_append(got[0], got[2], k, v, pi, lengths, valid, got[1], got[3])
    torch.cuda.synchronize()
    assert pap.paged_append.launches == before + 1
    pap.paged_append_plain(want[0], want[2], k, v, pi, lengths, valid,
                           want[1], want[3])
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["decode", "chunk"])
@pytest.mark.parametrize("src", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fmt", ["bf16", "fp32"])
def test_paged_append_kernel_matches_plain(cuda_device, fmt, src, kind):
    """bf16 and fp32 pages: the kernel equals its plain version bit for bit
    outside the dump page (which idle row lands there is unspecified), for
    tokens of either type given as strided views, with the idle rows,
    over-capacity and valid_len drops of ``append_inputs``."""
    pages, k, v, pi, lengths, valid, dump = append_inputs(
        kind, fmt, src, cuda_device)
    got, want = _append_both(pages, k, v, pi, lengths, valid)
    assert append_bytes_equal(got, want, dump)
    assert not append_bytes_equal(got, pages, dump)  # it did write


# Inputs the 16-byte route cannot take: D = 100 is no multiple of 8
# (decode), and views one element off the projection's start leave every
# token unaligned (chunk).
SCALAR_ROUTE = {"d100": dict(kind="decode", d=100),
                "unaligned": dict(kind="chunk", offset=1)}


@pytest.mark.cuda
@pytest.mark.parametrize("why", sorted(SCALAR_ROUTE))
@pytest.mark.parametrize("src", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fmt", PAGE_FORMATS)
def test_paged_append_scalar_route_matches_plain(cuda_device, fmt, src, why):
    """Where D is not a multiple of 8 or a token is not 16-byte aligned the
    kernel holds one element a lane (W = 1, up to eight chunks a lane, the
    absmax shuffled over all 32 lanes); that instantiation ran (its name
    in torch.profiler) and equals the plain version bit for bit outside the
    dump page, payloads and scales, in every format."""
    kw = SCALAR_ROUTE[why]
    pages, k, v, pi, lengths, valid, dump = append_inputs(
        kw["kind"], fmt, src, cuda_device, d=kw.get("d", 64),
        offset=kw.get("offset", 0))
    if "offset" in kw:
        assert k.data_ptr() % 16 and v.data_ptr() % 16
    got, want = _append_both(pages, k, v, pi, lengths, valid)
    names = device_kernels_of(lambda: pap.paged_append(
        got[0], got[2], k, v, pi, lengths, valid, got[1], got[3]))
    # the last template argument is W: "<..., 1>" (or "Li1EE" mangled)
    assert len(names) == 1 and re.search(
        r"paged_append_tokens_kernel(<[^>]*\b1>|I.*Li1EE)", names[0]), names
    assert append_bytes_equal(got, want, dump)
    assert not append_bytes_equal(got, pages, dump)  # it did write


@pytest.mark.cuda
def test_paged_append_rows_kernel_matches_plain(cuda_device):
    """The phys/slot/ok form on the card: ok = 0 rows and rows with a page
    or slot out of range write nothing."""
    kp, vp, kn, vn, phys, slot, ok = decode_rows(b=6, page=16)
    phys[0], slot[2], phys[3] = -1, 16, kp.shape[1]
    cast = lambda x: torch.from_numpy(x).to(cuda_device, torch.bfloat16)
    idx = lambda x: torch.from_numpy(x).to(cuda_device)
    got, want = [cast(kp), cast(vp)], [cast(kp), cast(vp)]
    before = pap.paged_append.launches
    append_rows(*got, cast(kn), cast(vn), idx(phys), idx(slot), idx(ok))
    torch.cuda.synchronize()
    assert pap.paged_append.launches == before + 1
    pap.paged_append_plain(*want, cast(kn)[:, :, None], cast(vn)[:, :, None],
                           idx(phys)[:, None], idx(slot), idx(ok))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    # row 5 only (rows 0, 2 and 3 out of range, 1 and 4 ok = 0)
    assert int((got[0] != cast(kp)).any(-1).sum()) == kp.shape[0]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["decode", "chunk"])
@pytest.mark.parametrize("fmt", PAGE_FORMATS)
def test_append_to_pages_is_one_kernel_and_no_sync(cuda_device, fmt, kind):
    """One append_to_pages on a card cache runs exactly one device kernel
    (torch.profiler) and never waits for the card (sync debug mode
    "error"), at a decode step and at a prefill chunk, in every format."""
    from flashattention_tpu_torch.serving import paged_kv

    _, k, v, pi, lengths, valid, _ = append_inputs(
        kind, fmt, torch.bfloat16, cuda_device)
    cache = paged_kv.init_paged_cache(
        12, pi.numel() + 1, 16, 64, quant=None if fmt in PAGE_DTYPE else fmt,
        dtype=PAGE_DTYPE.get(fmt, torch.bfloat16), device=cuda_device)
    valid = valid if kind == "chunk" else None  # as the engine passes them
    paged_kv.append_to_pages(cache, k, v, pi, lengths, valid)  # build, warm
    torch.cuda.synchronize()

    def append_without_sync():
        torch.cuda.set_sync_debug_mode("error")
        try:
            paged_kv.append_to_pages(cache, k, v, pi, lengths, valid)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    names = device_kernels_of(append_without_sync)
    assert len(names) == 1 and "paged_append_tokens_kernel" in names[0], names


@pytest.mark.cuda
def test_paged_append_kernel_rejects_what_it_does_not_take(cuda_device):
    pages, k, v, pi, lengths, valid, _ = append_inputs(
        "decode", "bf16", torch.bfloat16, cuda_device)
    kp, vp = pages[0], pages[2]
    with pytest.raises(ValueError):  # D stride 2
        wide = torch.cat([k, k], dim=-1)[..., ::2]
        pap.paged_append(kp, vp, wide, wide, pi, lengths)
    with pytest.raises(TypeError):  # fp16 tokens
        pap.paged_append(kp, vp, k.half(), v.half(), pi, lengths)
    with pytest.raises(TypeError):  # fp16 pages
        pap.paged_append(kp.half(), vp.half(), k, v, pi, lengths)
    with pytest.raises(TypeError):  # int64 lengths
        pap.paged_append(kp, vp, k, v, pi, lengths.long())
    with pytest.raises(ValueError):  # lengths on another device
        pap.paged_append(kp, vp, k, v, pi, lengths.cpu())
    with pytest.raises(ValueError):  # 1-byte pages without their scales
        pap.paged_append(kp.to(torch.int8), vp.to(torch.int8), k, v, pi,
                         lengths)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(cuda_device):
    """A small float32 engine on the card gives the CPU engine's greedy
    tokens, and its decode runs through both kernels."""
    cfg = TransformerConfig(vocab_size=89, d_model=64, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=128, max_seq_len=128,
                            dropout_rate=0.0, dtype=torch.float32,
                            attention_window=20, attention_sinks=4)
    params = init_params(cfg, seed=1, device=cuda_device)
    ecfg = EngineConfig(max_batch_size=3, page_size=8, num_pages=40,
                        max_seq_len=128, prefill_pad=16)
    rng = np.random.default_rng(2)
    reqs = [GenerationRequest(i, [int(t) for t in rng.integers(0, 89, n)], 12)
            for i, n in enumerate((5, 30, 17, 9))]
    out = {}
    for dev in ("cpu", cuda_device):
        eng = ServingEngine(params, cfg, ecfg, device=dev)
        for r in reqs:
            eng.submit(r)
        pa.paged_attention.launches = pap.paged_append.launches = 0
        out[str(dev)] = eng.run()
        launches = (pa.paged_attention.launches, pap.paged_append.launches)
    assert out["cpu"] == out[str(cuda_device)]
    assert launches[0] > 0 and launches[1] > 0
    # one append launch a layer per decode step and per prefill chunk
    assert launches[1] == cfg.n_layers * (eng.stats["decode_steps"]
                                          + eng.stats["prefill_chunks"])


# ---------------------------------------------------------------------------
# The speculative engine's verify chunk (B = 32, T = gamma + 1 = 5)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["bf16", "fp8", "int8"])
def test_paged_attention_at_the_verify_shape(cuda_device, pages):
    """GPT-3 Small heads (12, D = 64), page 16, 512 slots a sequence, bf16
    q of T = 5 rows a slot at lengths spread over [33, 505] plus one slot
    whose rows pass the page capacity: the split route (int8 pages take the
    convert schedule at T > 1) within the paged limit of the plain
    version."""
    rng = np.random.default_rng(9)
    q, kp, vp, pi, ln = paged_inputs(
        b=32, h=12, h_kv=12, d=64, page=16, pps=32, q_len=5,
        lengths=verify_lengths(rng) + 5, seed=9)
    q = torch.from_numpy(q).to(cuda_device, torch.bfloat16)
    pi, ln = (torch.from_numpy(x).to(cuda_device) for x in (pi, ln))
    if pages == "bf16":
        kp, vp = (torch.from_numpy(x).to(cuda_device, torch.bfloat16)
                  for x in (kp, vp))
        kw = {}
    else:
        kp, ks, vp, vs = quantized_pages(kp, vp, pages, cuda_device)
        kw = dict(k_scales=ks, v_scales=vs)
        assert pa.int8_mode(kp, q.dtype, 5, None) == "convert"
    before = (pa.paged_attention.launches, pa.paged_attention.split_launches,
              pa.paged_attention.chunk_launches)
    o = pa.paged_attention(q, kp, vp, pi, ln, **kw)
    torch.cuda.synchronize()
    assert (pa.paged_attention.launches - before[0],
            pa.paged_attention.split_launches - before[1],
            pa.paged_attention.chunk_launches - before[2]) == (1, 1, 1)
    ref = pa.paged_attention_plain(q, kp, vp, pi, ln, **kw)
    tol = KERNEL_TOL[torch.bfloat16]
    assert torch.isfinite(o.float()).all()
    assert_allclose(o, ref, rtol=tol, atol=tol, err_msg=pages)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", PAGE_FORMATS)
def test_paged_append_at_the_verify_shape(cuda_device, fmt):
    """B = 32 slots of T = 5 tokens (bf16 views of a fused projection; fp32
    for fp32 pages): bit-exact against the plain version outside the dump
    page, and the rows past slot 0's capacity write nothing."""
    src = torch.float32 if fmt == "fp32" else torch.bfloat16
    pages, k, v, pi, lengths, valid, dump = append_inputs(
        "verify", fmt, src, cuda_device)
    chunks0 = pap.paged_append.chunk_launches
    got, want = _append_both(pages, k, v, pi, lengths, valid)
    assert pap.paged_append.chunk_launches == chunks0 + 1
    assert append_bytes_equal(got, want, dump)
    assert not append_bytes_equal(got, pages, dump)
    # slot 0 sits at 508: positions 508-511 land on its last page, 512 drops
    last = int(pi[0, -1])
    for g, p in zip(got, pages):
        if g is not None:
            assert torch.equal(g[:, last, :12].view(torch.uint8),
                               p[:, last, :12].view(torch.uint8))
            assert not torch.equal(g[:, last, 12:].view(torch.uint8),
                                   p[:, last, 12:].view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("draft_layers", [2, 1])
def test_spec_engine_on_card(cuda_device, draft_layers):
    """A tiny bf16 speculative engine on the card: the launch counts of the
    speculative tick (paged attention and append: L_t a verify, L_d x
    (gamma + 1) a tick, L_t + L_d a prefill chunk), every paged launch on
    the split route, and a self-draft (``draft_layers`` 2, the target
    itself) accepting at least 0.9 of its proposals."""
    cfg = TransformerConfig(vocab_size=89, d_model=64, n_layers=2, n_heads=4,
                            d_ff=128, max_seq_len=128, dropout_rate=0.0)
    params = init_params(cfg, seed=3, device=cuda_device)
    draft = (params, cfg)
    if draft_layers != cfg.n_layers:
        dcfg = dataclasses.replace(cfg, n_layers=draft_layers)
        draft = (init_params(dcfg, seed=4, device=cuda_device), dcfg)
    gamma = 4
    ecfg = EngineConfig(max_batch_size=4, page_size=16, num_pages=40,
                        max_seq_len=128, prefill_pad=16, spec_gamma=gamma)
    rng = np.random.default_rng(5)
    eng = ServingEngine(params, cfg, ecfg, device=cuda_device,
                        draft_params=draft[0], draft_cfg=draft[1])
    for i, n in enumerate((5, 30, 17, 9, 60, 3)):
        prompt = [int(t) for t in rng.integers(0, 89, n)]
        eng.submit(GenerationRequest(i, prompt, 20))
    pa.paged_attention.launches = pa.paged_attention.split_launches = 0
    pap.paged_append.launches = 0
    out = eng.run()
    assert sorted(out) == list(range(6)) and all(len(v) == 20
                                                 for v in out.values())
    lt, ld = cfg.n_layers, draft[1].n_layers
    ticks, chunks = eng.stats["spec_ticks"], eng.stats["prefill_chunks"]
    want = (lt + ld * (gamma + 1)) * ticks + (lt + ld) * chunks
    assert pa.paged_attention.launches == want
    assert pa.paged_attention.split_launches == want
    assert pap.paged_append.launches == want
    if draft_layers == cfg.n_layers:
        assert eng.spec_accepted / eng.spec_proposed >= 0.9


# ---------------------------------------------------------------------------
# Flash attention forward and backward kernels
# ---------------------------------------------------------------------------

# name: ((b, h, h_kv, n_q, n_k, d), dtype, kernel_attention kwargs, extras);
# one case per chip_smoke.py flash case (the bench shape cut to N = 2048),
# plus ragged and head-dim edges, in fp32 (the FMA route) and in bf16 (the
# tensor-core route wherever D <= 128).
FLASH_CASES = {
    "a_train": ((8, 12, 12, 512, 512, 64), torch.bfloat16,
                dict(causal=True, dropout_rate=0.1, dropout_seed=3), ()),
    "b_bench": ((1, 8, 8, 2048, 2048, 128), torch.bfloat16,
                dict(causal=True), ()),
    "c_gqa_window": ((2, 12, 4, 300, 300, 64), torch.bfloat16,
                     dict(causal=True, window=128, sinks=4, softcap=30.0), ()),
    "d_segments_alibi": ((2, 4, 4, 256, 256, 64), torch.bfloat16,
                         dict(causal=True), ("segments", "alibi")),
    "e_fp32": ((2, 4, 2, 200, 200, 64), torch.float32, dict(causal=True), ()),
    "f_dlse": ((2, 4, 4, 128, 128, 64), torch.bfloat16, dict(causal=True),
               ("dlse",)),
    "g_empty_rows": ((1, 4, 4, 64, 64, 64), torch.float32,
                     dict(causal=True, q_offset=-10), ()),
    "d256_full_ragged": ((1, 2, 2, 100, 77, 256), torch.float32,
                         dict(causal=False, dropout_rate=0.25,
                              dropout_seed=11), ()),
    "d40_offset": ((2, 2, 1, 77, 130, 40), torch.float32,
                   dict(causal=True, q_offset=20), ("dlse",)),
    "h_fp32_dropout": ((2, 12, 12, 512, 512, 64), torch.float32,
                       dict(causal=True, dropout_rate=0.1, dropout_seed=99),
                       ()),
    # bf16 edges of the tensor-core kernels: D zero-padded by TMA, ragged
    # N_q / N_k, a query offset, GQA, an LSE cotangent
    "bf16_d40_offset": ((2, 2, 1, 77, 130, 40), torch.bfloat16,
                        dict(causal=True, q_offset=20), ("dlse",)),
    "bf16_empty_rows": ((1, 4, 4, 64, 64, 64), torch.bfloat16,
                        dict(causal=True, q_offset=-10), ()),
    "bf16_d128_gqa_window_dropout": (
        (2, 8, 2, 300, 300, 128), torch.bfloat16,
        dict(causal=True, window=96, sinks=4, softcap=30.0, dropout_rate=0.1,
             dropout_seed=21), ()),
    "bf16_full_segments_alibi": ((2, 4, 4, 192, 320, 64), torch.bfloat16,
                                 dict(causal=False), ("segments", "alibi")),
    "bf16_d256_fma_route": ((1, 2, 2, 100, 77, 256), torch.bfloat16,
                            dict(causal=True), ()),
    "bf16_k_unaligned_view": ((2, 4, 2, 128, 128, 64), torch.bfloat16,
                              dict(causal=True), ("k_unaligned",)),
}


def flash_tol(dtype, ref):
    """(rtol, atol) of a flash kernel output against its plain version
    ``ref``: fp32 1e-4 each; bf16, where the two round at the same points
    and sum in another order, two ulps (rtol 1.6e-2) and atol
    1e-3 * max|ref| for elements that cancel to near zero."""
    if dtype == torch.bfloat16:
        return 1.6e-2, 1e-3 * float(ref.float().abs().max())
    return 1e-4, 1e-4


def flash_inputs(shape, dtype, extras, device, seed=0):
    b, h, h_kv, n_q, n_k, d = shape
    gen = torch.Generator().manual_seed(seed)

    def rand(*s):
        return torch.randn(s, generator=gen).to(device, dtype)

    q, k, v = rand(b, h, n_q, d), rand(b, h_kv, n_k, d), rand(b, h_kv, n_k, d)
    do = rand(b, h, n_q, d)
    dlse = (torch.randn((b, h, n_q), generator=gen).to(device)
            if "dlse" in extras else None)
    kw = {}
    if "segments" in extras:
        ids = [torch.sort(torch.randint(0, 4, (b, n), generator=gen))[0]
               .to(device, torch.int32)
               for n in ([n_q] if n_q == n_k else [n_q, n_k])]
        kw["segment_ids"] = ids[0] if n_q == n_k else (ids[0], ids[1])
    if "alibi" in extras:
        kw["alibi_slopes"] = (0.5 ** torch.arange(1, h + 1)).to(device)
    if "k_unaligned" in extras:  # a view 2 bytes past a 16-byte boundary
        buf = torch.empty(k.numel() + 1, dtype=dtype, device=device)
        k = buf[1:].view(k.shape).copy_(k)
        assert k.data_ptr() % 16 != 0
    return q, k, v, do, dlse, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernels_match_plain(cuda_device, case):
    shape, dtype, kw, extras = FLASH_CASES[case]
    q, k, v, do, dlse, more = flash_inputs(shape, dtype, extras, cuda_device)
    opts = fa.make_opts(q, k, **kw, **more)
    ka = fa.kernel_attention
    before = (ka.fwd_launches, ka.bwd_launches, ka.fwd_tc_launches,
              ka.bwd_tc_launches)
    o, lse = fa.flash_fwd(q, k, v, opts)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, opts)
    rtol, atol = flash_tol(dtype, o_ref)
    assert_allclose(o, o_ref, rtol=rtol, atol=atol, err_msg=f"{case} o")
    seen = lse_ref > -1e30  # rows without a key: LSE only <= -1e30
    assert bool((lse[~seen] <= -1e30).all())
    assert_allclose(lse[seen], lse_ref[seen], rtol=1e-4, atol=1e-4,
                    err_msg=f"{case} lse")
    grads = fa.flash_bwd(q, k, v, o_ref, lse_ref, do, dlse, opts)
    torch.cuda.synchronize()
    di = (o_ref.float() * do.float()).sum(-1)
    if dlse is not None:
        di = di - dlse
    refs = fa.flash_bwd_plain(q, k, v, do, lse_ref, di, opts)
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        assert g.dtype == r.dtype and g.shape == r.shape
        rtol, atol = flash_tol(dtype, r)
        assert_allclose(g, r, rtol=rtol, atol=atol, err_msg=f"{case} {name}")
    tc = int(dtype == torch.bfloat16 and shape[-1] <= 128)
    after = (ka.fwd_launches, ka.bwd_launches, ka.fwd_tc_launches,
             ka.bwd_tc_launches)
    assert tuple(x - y for x, y in zip(after, before)) == (1, 1, tc, tc)


@pytest.mark.cuda
def test_flash_bf16_backward_is_deterministic(cuda_device):
    """The tensor-core backward at the training shape with dropout, twice:
    bit-equal gradients (no atomics, so no dependence on block order)."""
    shape, dtype, kw, extras = FLASH_CASES["a_train"]
    q, k, v, do, _, _ = flash_inputs(shape, dtype, extras, cuda_device)
    opts = fa.make_opts(q, k, **kw)
    o, lse = fa.flash_fwd(q, k, v, opts)
    t0 = fa.kernel_attention.bwd_tc_launches
    first = fa.flash_bwd(q, k, v, o, lse, do, None, opts)
    second = fa.flash_bwd(q, k, v, o, lse, do, None, opts)
    torch.cuda.synchronize()
    assert fa.kernel_attention.bwd_tc_launches - t0 == 2
    for name, x, y in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(x, y), name


@pytest.mark.cuda
def test_flash_autograd_on_card_matches_cpu(cuda_device):
    """kernel_attention's autograd on the card against the same call on
    the CPU (plain versions), fp32, with dropout, GQA and a window."""
    gen = torch.Generator().manual_seed(4)
    base = [torch.randn(s, generator=gen) for s in
            ((2, 4, 96, 32), (2, 2, 96, 32), (2, 2, 96, 32))]
    kw = dict(causal=True, window=40, sinks=2, dropout_rate=0.2,
              dropout_seed=17)
    out = {}
    for dev in ("cpu", cuda_device):
        leaves = [t.detach().to(dev).requires_grad_(True) for t in base]
        o, lse = fa.kernel_attention(*leaves, **kw)
        (o.square().sum() + lse.sum()).backward()
        out[str(dev)] = [o, lse] + [t.grad for t in leaves]
    for name, a, r in zip(("o", "lse", "dq", "dk", "dv"), out[str(cuda_device)],
                          out["cpu"]):
        assert_allclose(a, r, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros(1, 2, 16, 32, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.kernel_attention(q, q, q)
    q32 = q.float()
    with pytest.raises(ValueError):
        fa.kernel_attention(q32, q32.cpu(), q32)


def _tiny_train_config(**kw):
    return TransformerConfig(vocab_size=97, d_model=64, n_layers=2, n_heads=4,
                             n_kv_heads=2, d_ff=128, max_seq_len=64,
                             block_size=32, **kw)


def _loss_and_grads(params, cfg, tokens, seed):
    params.zero_grad(set_to_none=True)
    loss = ttrain.loss_fn(params, {"tokens": tokens}, cfg, seed)
    loss.backward()
    return loss.item(), {n: p.grad.detach().float().cpu()
                         for n, p in params.named_parameters()}


@pytest.mark.cuda
def test_training_loss_on_card_matches_cpu(cuda_device):
    """A float32 training loss and its gradients (remat full, GQA) on the
    card against the CPU. Dropout is off: residual dropout draws from the
    device's generator, whose CUDA and CPU streams differ."""
    cfg = _tiny_train_config(dtype=torch.float32, dropout_rate=0.0)
    cpu_params = init_params(cfg, seed=3, device="cpu")
    card_params = copy.deepcopy(cpu_params).to(cuda_device)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 97, (2, 49)))
    f0, b0 = fa.kernel_attention.fwd_launches, fa.kernel_attention.bwd_launches
    l_card, g_card = _loss_and_grads(card_params, cfg, tokens.to(cuda_device),
                                     None)
    assert (fa.kernel_attention.fwd_launches - f0,
            fa.kernel_attention.bwd_launches - b0) == (2 * cfg.n_layers,
                                                       cfg.n_layers)
    l_cpu, g_cpu = _loss_and_grads(cpu_params, cfg, tokens, None)
    assert abs(l_card - l_cpu) <= 1e-4 * (1 + abs(l_cpu))
    for name in g_cpu:
        assert_allclose(g_card[name], g_cpu[name], rtol=1e-4, atol=1e-4,
                        err_msg=name)


@pytest.mark.cuda
def test_remat_policies_agree_on_card(cuda_device):
    """bf16 with dropout: remat "full", "dots" and none give the same loss
    and gradients on the card (the recompute replays every mask)."""
    cfg = _tiny_train_config(dropout_rate=0.1, remat=False)
    params = init_params(cfg, seed=4, device=cuda_device)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, 97, (2, 49))).to(cuda_device)
    ref = _loss_and_grads(params, cfg, tokens, 5)
    for policy in ("full", "dots"):
        got = _loss_and_grads(params, dataclasses.replace(
            cfg, remat=True, remat_policy=policy), tokens, 5)
        assert abs(got[0] - ref[0]) <= 1e-6 * abs(ref[0]), policy
        for name in ref[1]:
            assert_allclose(got[1][name], ref[1][name], rtol=1e-5, atol=1e-6,
                            err_msg=f"{policy} {name}")


# ---------------------------------------------------------------------------
# Quantized pages (int8, e4m3, e5m2) and the FA3 8-bit forward
# ---------------------------------------------------------------------------

QUANT_FORMATS = ["int8", "fp8", "e5m2"]


def quantized_pages(kp, vp, quant, device):
    """(payload, (..., 1) scales) of K and V pages, on ``device``."""
    out = []
    for x in (kp, vp):
        p, s = quantize_tokens(torch.from_numpy(x), quant)
        out += [p.to(device), s[..., None].contiguous().to(device)]
    return out


# name: (paged case, int8_qk)
QUANT_PAGED = {
    "decode": ("decode_p16", None), "decode_p8": ("decode_p8", None),
    "chunk": ("chunk_p16", None), "gqa": ("gqa_decode", None),
    "window_sinks": ("window_sinks_chunk", None), "softcap": ("softcap", None),
    "empty": ("empty_decode", None), "wide": ("wide_rows_d128", None),
    "qk_decode": ("decode_p16", "qk"), "qk_chunk": ("window_sinks_chunk", "qk"),
    "full_decode": ("gqa_decode", "full"),
    "full_window": ("window_sinks_chunk", "full"),
    "split_lengths": ("split_lengths", None),
    "split_lengths_convert": ("split_lengths", False),
    "split_window": ("split_window_sinks", None),
    "split_window_qk_chunk": ("window_sinks_chunk", "qk"),
    "split_gqa_chunk": ("split_gqa_chunk64", None),
    "split_page24": ("split_page24", None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name, quant", [
    (n, f) for n in sorted(QUANT_PAGED) for f in QUANT_FORMATS
    if QUANT_PAGED[n][1] is None or f == "int8"])  # int8 schedules: int8 only
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantized_paged_attention_kernel_matches_plain(cuda_device, name,
                                                        quant, dtype):
    case, int8_qk = QUANT_PAGED[name]
    shape, kw = CASES[case]
    q, kp, vp, pi, ln = paged_inputs(**shape)
    k8, ks, v8, vs = quantized_pages(kp, vp, quant, cuda_device)
    q = torch.from_numpy(q).to(cuda_device, dtype)
    pi, ln = (torch.from_numpy(x).to(cuda_device) for x in (pi, ln))
    kw = dict(kw, k_scales=ks, v_scales=vs, int8_qk=int8_qk)
    before = pa.paged_attention.launches, pa.paged_attention.split_launches
    o = pa.paged_attention(q, k8, v8, pi, ln, **kw)
    torch.cuda.synchronize()
    # bf16 q takes the split route in every schedule but "full"
    split = int(dtype == torch.bfloat16 and int8_qk != "full")
    assert (pa.paged_attention.launches - before[0],
            pa.paged_attention.split_launches - before[1]) == (1, split)
    assert o.dtype == dtype and o.shape == q.shape
    ref = pa.paged_attention_plain(q, k8, v8, pi, ln, **kw)
    tol = KERNEL_TOL[dtype]
    assert_allclose(o, ref, rtol=tol, atol=tol, err_msg=f"{name} {quant}")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["decode", "chunk"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", QUANT_FORMATS)
def test_quantized_paged_append_kernel_bit_exact(cuda_device, quant, dtype,
                                                 kind):
    """1-byte pages: payloads and scales equal the plain version's bit for
    bit outside the dump page, tokens of either type quantized in the
    launch; dropped tokens write neither payload nor scale."""
    pages, k, v, pi, lengths, valid, dump = append_inputs(
        kind, quant, dtype, cuda_device)
    got, want = _append_both(pages, k, v, pi, lengths, valid)
    assert append_bytes_equal(got, want, dump)
    assert not append_bytes_equal(got, pages, dump)


def _engine_decode_pages(quant, device, seed=0):
    """The engine's decode shape (B = 32, 12 heads, D = 64, page 16, 512
    slots a sequence): q, pages (quantized if ``quant``), table, lengths."""
    q, kp, vp, pi, ln = paged_inputs(
        b=32, h=12, h_kv=12, d=64, page=16, pps=32, q_len=0,
        lengths=np.random.default_rng(seed).integers(0, 513, size=32),
        seed=seed)
    q = torch.from_numpy(q).to(device, torch.bfloat16)
    pi, ln = (torch.from_numpy(x).to(device) for x in (pi, ln))
    if quant is None:
        return q, *(torch.from_numpy(x).to(device, torch.bfloat16)
                    for x in (kp, vp)), pi, ln, {}
    k8, ks, v8, vs = quantized_pages(kp, vp, quant, device)
    return q, k8, v8, pi, ln, dict(k_scales=ks, v_scales=vs)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [None] + QUANT_FORMATS)
def test_paged_split_is_deterministic(cuda_device, quant):
    """Two calls of the split route are bit-equal: splits merge in a fixed
    order, with no atomics."""
    q, kp, vp, pi, ln, kw = _engine_decode_pages(quant, cuda_device)
    s0 = pa.paged_attention.split_launches
    first = pa.paged_attention(q, kp, vp, pi, ln, **kw)
    second = pa.paged_attention(q, kp, vp, pi, ln, **kw)
    torch.cuda.synchronize()
    assert pa.paged_attention.split_launches - s0 == 2
    assert torch.equal(first, second)
    ref = pa.paged_attention_plain(q, kp, vp, pi, ln, **kw)
    tol = KERNEL_TOL[torch.bfloat16]
    assert_allclose(first, ref, rtol=tol, atol=tol, err_msg=str(quant))


@pytest.mark.cuda
def test_paged_first_kernel_on_split_inputs(cuda_device, monkeypatch):
    """The first kernel still takes inputs the split route takes (as
    chip_smoke.py times it beside the split route) and agrees with the
    plain version there."""
    q, kp, vp, pi, ln, _ = _engine_decode_pages(None, cuda_device)
    monkeypatch.setattr(pa, "split_route", lambda *a: False)
    s0 = pa.paged_attention.split_launches
    o = pa.paged_attention(q, kp, vp, pi, ln)
    torch.cuda.synchronize()
    assert pa.paged_attention.split_launches == s0
    ref = pa.paged_attention_plain(q, kp, vp, pi, ln)
    tol = KERNEL_TOL[torch.bfloat16]
    assert_allclose(o, ref, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_paged_split_failure_raises(cuda_device, monkeypatch):
    """A split launch that reports an error raises; nothing falls back to
    the first kernel or the plain version."""
    q, kp, vp, pi, ln, _ = _engine_decode_pages(None, cuda_device)
    calls = []

    class Lib:  # the split entry fails (cudaErrorInvalidValue)
        def __getattr__(self, name):
            if name.endswith("_split"):
                return lambda *args: 1
            return lambda *args: calls.append(name) or 0

    monkeypatch.setattr(pa._build, "load_kernel", lambda name, declare: Lib())
    with pytest.raises(RuntimeError, match="paged_attention split launch"):
        pa.paged_attention(q, kp, vp, pi, ln)
    assert calls == []


# name: ((b, h, h_kv, n[, n_k], d), dtype, fp8_attention kwargs, extras)
FP8_CASES = {
    "e4m3_causal": ((1, 4, 4, 1024, 128), torch.bfloat16,
                    dict(causal=True, mode="fused"), ()),
    "int8_causal": ((1, 4, 4, 1024, 128), torch.bfloat16,
                    dict(causal=True, fmt="int8"), ()),
    "e5m2_causal": ((1, 4, 4, 1024, 128), torch.bfloat16,
                    dict(causal=True, mode="fused", fmt="e5m2"), ()),
    "dropout_one_tile": ((2, 12, 12, 512, 64), torch.bfloat16,
                         dict(causal=True, dropout_rate=0.1,
                              dropout_seed=5), ()),
    "gqa_window_sinks_softcap": ((2, 12, 4, 512, 64), torch.bfloat16,
                                 dict(causal=True, mode="fused", window=128,
                                      sinks=4, softcap=30.0), ()),
    "segments_alibi": ((2, 12, 12, 512, 64), torch.bfloat16,
                       dict(causal=True, mode="fused"),
                       ("segments", "alibi")),
    "s8": ((1, 4, 4, 1024, 64), torch.bfloat16,
           dict(causal=True, fmt="int8", int8_pv="s8", block_k=256), ()),
    "s8_dropout_window": ((1, 4, 2, 700, 64), torch.float32,
                          dict(causal=True, fmt="int8", int8_pv="s8",
                               block_k=128, window=300, sinks=8,
                               dropout_rate=0.2, dropout_seed=9), ()),
    "fp32_ragged_full": ((2, 2, 1, 200, 64), torch.float32,
                         dict(causal=False, mode="fused", fmt="e5m2"), ()),
    "d256_int8": ((1, 2, 2, 300, 256), torch.float32,
                  dict(causal=True, fmt="int8"), ()),
    "int8_d64": ((2, 4, 4, 512, 64), torch.bfloat16,
                 dict(causal=True, fmt="int8"), ()),
    "e4m3_ragged_1000_d128": ((1, 4, 4, 1000, 128), torch.bfloat16,
                              dict(causal=True, mode="fused"), ()),
    "e4m3_nq_ne_nk_fp32": ((1, 4, 2, 600, 1000, 64), torch.float32,
                           dict(causal=True, mode="fused"), ()),
    "int8_nq_ne_nk_ragged": ((1, 4, 4, 384, 1000, 128), torch.bfloat16,
                             dict(causal=True, fmt="int8"), ()),
}
# The cases the tensor-core route takes (int8_pv "bf16", D <= 128 with
# D % 32 == 0); the s8 cases and D = 256 stay on the FMA kernel.
FP8_TENSOR_CORE = {"e4m3_causal", "int8_causal", "e5m2_causal",
                   "dropout_one_tile", "gqa_window_sinks_softcap",
                   "segments_alibi", "fp32_ragged_full", "int8_d64",
                   "e4m3_ragged_1000_d128", "e4m3_nq_ne_nk_fp32",
                   "int8_nq_ne_nk_ragged"}


def fp8_inputs(shape, dtype, extras, device, seed=0):
    b, h, h_kv, n, *n_k, d = shape
    q, k, v, do, _, kw = flash_inputs((b, h, h_kv, n, (n_k or [n])[0], d),
                                      dtype, extras, device, seed)
    return q, k, v, do, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FP8_CASES))
def test_fp8_kernel_matches_plain(cuda_device, case):
    shape, dtype, kw, extras = FP8_CASES[case]
    q, k, v, _, more = fp8_inputs(shape, dtype, extras, cuda_device)
    kw = dict(kw, **more)
    fmt = kw.pop("fmt", "fp8")
    int8_pv = kw.pop("int8_pv", "bf16")
    bk = kw.pop("block_k", 1024)
    mode = fp8_attn.resolve_mode(kw.pop("mode", "auto"), fmt, q.shape[2], 512)
    assert mode == "fused"
    opts = fa.make_opts(q, k, **kw)
    q8, k8, v8, sq, sk, sv, bq, bk = fp8_attn.quantize_inputs(
        q, k, v, 512, bk, fmt)
    before = fp8_attn.fp8_attention.launches, fp8_attn.fp8_attention.tc_launches
    o, lse = fp8_attn.fp8_fwd(q8, k8, v8, sq, sk, sv, bq, bk, opts,
                              int8_pv=int8_pv, out_dtype=dtype)
    torch.cuda.synchronize()
    tc = int(case in FP8_TENSOR_CORE)
    assert tc == fp8_attn._tensor_core_route(int8_pv, q.shape[3], bk)
    assert (fp8_attn.fp8_attention.launches - before[0],
            fp8_attn.fp8_attention.tc_launches - before[1]) == (1, tc)
    o_ref, lse_ref = fp8_attn.fp8_fwd_plain(q8, k8, v8, sq, sk, sv, bq, bk,
                                            opts, int8_pv=int8_pv,
                                            out_dtype=dtype)
    # p is rounded to bf16 before P.V whatever the output dtype, at the
    # kernel's running max and the plain version's final max: the bf16 limit
    rtol, atol = flash_tol(torch.bfloat16, o_ref)
    assert_allclose(o, o_ref, rtol=rtol, atol=atol, err_msg=f"{case} o")
    assert_allclose(lse, lse_ref, rtol=1e-4, atol=1e-4, err_msg=f"{case} lse")


@pytest.mark.cuda
@pytest.mark.parametrize("ste", ["dequant", "original"])
def test_fp8_attention_autograd_on_card_matches_cpu(cuda_device, ste):
    """fp8_attention's STE autograd on the card (kernel B4, then B2/B3)
    against the same call on the CPU (plain versions)."""
    gen = torch.Generator().manual_seed(6)
    base = [torch.randn(s, generator=gen) for s in
            ((2, 4, 256, 64), (2, 2, 256, 64), (2, 2, 256, 64))]
    do = torch.randn((2, 4, 256, 64), generator=gen)
    kw = dict(causal=True, window=100, sinks=2, dropout_rate=0.1,
              dropout_seed=4, mode="fused", ste=ste)
    out = {}
    for dev in ("cpu", cuda_device):
        leaves = [t.detach().to(dev).requires_grad_(True) for t in base]
        o, lse = fp8_attn.fp8_attention(*leaves, **kw)
        # fixed cotangents: card and CPU backwards see the same do
        ((o * do.to(dev)).sum() + lse.sum()).backward()
        out[str(dev)] = [o, lse] + [t.grad for t in leaves]
    for name, a, r in zip(("o", "lse", "dq", "dk", "dv"), out[str(cuda_device)],
                          out["cpu"]):
        # lse: fp32 scores; o: p in bf16 (see above); grads: bf16 backward
        rtol, atol = ((1e-4, 1e-4) if name == "lse"
                      else flash_tol(torch.bfloat16, r))
        assert_allclose(a, r, rtol=rtol, atol=atol, err_msg=f"{ste} {name}")


@pytest.mark.cuda
def test_fp8_tensor_core_failure_raises(cuda_device, monkeypatch):
    """A tensor-core launch of the 8-bit forward that reports an error
    raises; nothing falls back to the FMA kernel or the plain version."""
    q = torch.randn(1, 2, 256, 64, device=cuda_device)
    args = fp8_attn.quantize_inputs(q, q, q, 512, 1024, "fp8")
    opts = fa.make_opts(q, q, causal=True)
    calls = []

    class Lib:  # the tensor-core entry fails (cudaErrorInvalidValue)
        def __getattr__(self, name):
            if name.endswith("_sm90"):
                return lambda *a: 1
            return lambda *a: calls.append(name) or 0

    monkeypatch.setattr(fp8_attn._build, "load_kernel",
                        lambda name, declare: Lib())
    with pytest.raises(RuntimeError, match="flash_fwd_fp8 launch"):
        fp8_attn.fp8_fwd(*args, opts)
    assert calls == []


@pytest.mark.cuda
def test_fp8_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros(1, 2, 64, 32, device=cuda_device)
    q8, k8, v8, sq, sk, sv, bq, bk = fp8_attn.quantize_inputs(q, q, q, 512,
                                                             1024, "fp8")
    opts = fa.make_opts(q, q)
    with pytest.raises(TypeError):
        fp8_attn.fp8_fwd(q8, k8.view(torch.int8), v8, sq, sk, sv, bq, bk, opts)
    with pytest.raises(ValueError):
        fp8_attn.fp8_fwd(q8, k8, v8, sq.cpu(), sk, sv, bq, bk, opts)
    with pytest.raises(TypeError):
        fp8_attn.fp8_fwd(q8, k8, v8, sq, sk, sv, bq, bk, opts,
                         out_dtype=torch.float16)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", QUANT_FORMATS)
def test_quantized_engine_on_card_matches_cpu(cuda_device, quant):
    """A float32 engine with quantized pages: the card's greedy tokens equal
    the CPU's, and every decode step and prefill chunk launches both
    kernels per layer."""
    cfg = TransformerConfig(vocab_size=89, d_model=64, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=128, max_seq_len=128,
                            dropout_rate=0.0, dtype=torch.float32)
    params = init_params(cfg, seed=1, device=cuda_device)
    ecfg = EngineConfig(max_batch_size=3, page_size=16, num_pages=40,
                        max_seq_len=128, prefill_pad=16, quant=quant)
    rng = np.random.default_rng(3)
    reqs = [GenerationRequest(i, [int(t) for t in rng.integers(0, 89, n)], 10)
            for i, n in enumerate((5, 30, 17, 9))]
    out = {}
    for dev in ("cpu", cuda_device):
        eng = ServingEngine(params, cfg, ecfg, device=dev)
        for r in reqs:
            eng.submit(r)
        pa.paged_attention.launches = pap.paged_append.launches = 0
        out[str(dev)] = eng.run()
        launches = (pa.paged_attention.launches, pap.paged_append.launches)
    assert out["cpu"] == out[str(cuda_device)]
    runs = eng.stats["decode_steps"] + eng.stats["prefill_chunks"]
    assert launches == (cfg.n_layers * runs, cfg.n_layers * runs)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", QUANT_FORMATS)
def test_quantizers_on_card_match_cpu(cuda_device, fmt):
    """Block and token quantization, and the Hadamard rotation, give the
    same bytes on the card as on the CPU (PyTorch's CUDA division by a
    scalar is a reciprocal multiply; the port divides by device tensors)."""
    from flashattention_tpu_torch.ops import quant

    gen = torch.Generator().manual_seed(8)
    x = torch.randn((2, 3, 256, 128), generator=gen) * 3
    q, k = quant.incoherent_process(x, x.flip(2), seed=1)
    qc, kc = quant.incoherent_process(x.to(cuda_device),
                                      x.flip(2).to(cuda_device), seed=1)
    assert torch.equal(qc.cpu(), q) and torch.equal(kc.cpu(), k)
    for got, want in ((quant.quantize_blocks(q.to(cuda_device), 64, fmt),
                       quant.quantize_blocks(q, 64, fmt)),
                      (quant.quantize_tokens(q.to(cuda_device), fmt),
                       quant.quantize_tokens(q, fmt))):
        for g, w in zip(got, want):
            assert torch.equal(g.cpu().view(torch.uint8), w.view(torch.uint8))


# ---------------------------------------------------------------------------
# Block-sparse attention (kernels B8, B9 + B10)
# ---------------------------------------------------------------------------


def local_global(n_tiles, width=4):
    """Longformer/BigBird local + global layout: each q tile sees the
    ``width`` tiles ending at its own and the first tile."""
    i = torch.arange(n_tiles)[:, None]
    j = torch.arange(n_tiles)[None, :]
    return ((i - j >= 0) & (i - j < width)) | (j == 0)


def random_pattern(n_q_tiles, n_k_tiles, density, empty_row, seed=0):
    gen = torch.Generator().manual_seed(seed)
    p = torch.rand((n_q_tiles, n_k_tiles), generator=gen) < density
    p[empty_row] = False
    return p


# name: ((b, h, h_kv, n_q, n_k, d), dtype, causal, (block_q, block_k),
# pattern, use dlse); chip_smoke.py's sparse cases (a)-(d) at reduced sizes,
# plus ragged block and head-dim edges with masked rows, in fp32 (the FMA
# route) and in bf16 (the tensor-core route wherever D <= 128 and both
# blocks are multiples of 64).
SPARSE_CASES = {
    "a_model": ((2, 12, 12, 1024, 1024, 64), torch.bfloat16, True, (128, 128),
                local_global(8), False),
    "b_d128": ((1, 8, 8, 2048, 2048, 128), torch.bfloat16, True, (128, 128),
               local_global(16), False),
    "c_gqa_ragged": ((1, 12, 4, 1000, 1000, 64), torch.float32, False, (64, 64),
                     random_pattern(16, 16, 0.3, 5), False),
    "d_nq_ne_nk": ((2, 8, 8, 384, 512, 64), torch.bfloat16, True, (64, 128),
                   local_global(6)[:, :4], True),
    "e_edges_d40": ((1, 4, 2, 200, 328, 40), torch.float32, True, (48, 80),
                    random_pattern(5, 5, 0.5, 2, seed=1), True),
    "f_d256_masked_rows": ((1, 2, 1, 256, 256, 256), torch.float32, True,
                           (128, 64), torch.tensor([[0, 1, 0, 0], [1, 0, 1, 1]],
                                                   dtype=torch.bool), False),
    # bf16 edges of the tensor-core kernels: GQA at a ragged N with an empty
    # q-block row (one consumer per CTA, 64-key blocks); D = 128 with rows
    # that see no key of a visited block and a KV block no q block visits
    "g_bf16_gqa_ragged": ((1, 12, 4, 1000, 1000, 64), torch.bfloat16, False,
                          (64, 64), random_pattern(16, 16, 0.3, 5), True),
    "h_bf16_d128_masked_rows": ((1, 2, 1, 256, 256, 128), torch.bfloat16, True,
                                (128, 64),
                                torch.tensor([[0, 1, 0, 0], [1, 0, 1, 0]],
                                             dtype=torch.bool), False),
    # bf16 with blocks that are not multiples of 64: the FMA route
    "i_bf16_blocks_48_80": ((1, 4, 2, 200, 328, 40), torch.bfloat16, True,
                            (48, 80), random_pattern(5, 5, 0.5, 2, seed=1),
                            True),
}
# The cases the tensor-core route takes; the others stay on the FMA kernels.
SPARSE_TENSOR_CORE = {"a_model", "b_d128", "d_nq_ne_nk", "g_bf16_gqa_ragged",
                      "h_bf16_d128_masked_rows"}


def _sparse_case(name, device):
    from flashattention_tpu_torch.ops import sparse_attn as sa

    shape, dtype, causal, (bq, bk), pattern, use_dlse = SPARSE_CASES[name]
    q, k, v, do, dlse, _ = flash_inputs(shape, dtype,
                                        ("dlse",) if use_dlse else (), device)
    spec = sa.SparseSpec(causal=causal, scale=shape[-1] ** -0.5, block_q=bq,
                         block_k=bk)
    active = sa.tile_pattern(pattern.to(device), pattern.shape[0],
                             pattern.shape[1], bq, bk, causal,
                             shape[4] - shape[3])
    return sa, q, k, v, do, dlse, pattern, spec, active


def _sparse_counts(sa):
    c = sa.sparse_attention
    return (c.fwd_launches, c.bwd_launches, c.fwd_tc_launches,
            c.bwd_tc_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SPARSE_CASES))
def test_sparse_kernels_match_plain(cuda_device, case):
    sa, q, k, v, do, dlse, _, spec, active = _sparse_case(case, cuda_device)
    before = _sparse_counts(sa)
    o, lse = sa.sparse_fwd(q, k, v, active, spec)
    torch.cuda.synchronize()
    o_ref, lse_ref = sa.sparse_fwd_plain(q, k, v, active, spec)
    rtol, atol = flash_tol(q.dtype, o_ref)
    assert_allclose(o, o_ref, rtol=rtol, atol=atol, err_msg=f"{case} o")
    # rows of empty q blocks: -inf; rows that see no key: the mask value
    empty = torch.isneginf(lse_ref)
    masked = lse_ref <= -1e30
    assert torch.equal(torch.isneginf(lse), empty)
    assert torch.equal(lse[masked], lse_ref[masked])
    assert_allclose(lse[~masked], lse_ref[~masked], rtol=1e-4, atol=1e-4,
                    err_msg=f"{case} lse")
    grads = sa.sparse_bwd(q, k, v, o_ref, lse_ref, do, dlse, active, spec)
    torch.cuda.synchronize()
    di = (o_ref.float() * do.float()).sum(-1)
    if dlse is not None:
        di = di - dlse
    refs = sa.sparse_bwd_plain(q, k, v, do, lse_ref, di, active, spec)
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        assert g.dtype == r.dtype and g.shape == r.shape
        rtol, atol = flash_tol(q.dtype, r)
        assert_allclose(g, r, rtol=rtol, atol=atol, err_msg=f"{case} {name}")
    # keys of KV blocks no q block visits: dK = dV = 0 exactly
    unvisited = (~active.any(0)).repeat_interleave(spec.block_k)[:k.shape[2]]
    for g in grads[1:]:
        assert not g[:, :, unvisited].any()
    tc = int(case in SPARSE_TENSOR_CORE)
    assert tc == sa._tensor_core_route(q.dtype, q.shape[3], spec)
    after = _sparse_counts(sa)
    assert tuple(x - y for x, y in zip(after, before)) == (1, 1, tc, tc)


@pytest.mark.cuda
def test_sparse_bf16_backward_is_deterministic(cuda_device):
    """The tensor-core sparse backward at the model case, twice: bit-equal
    gradients (no atomics, so no dependence on block order)."""
    sa, q, k, v, do, dlse, _, spec, active = _sparse_case("a_model",
                                                          cuda_device)
    o, lse = sa.sparse_fwd(q, k, v, active, spec)
    t0 = sa.sparse_attention.bwd_tc_launches
    first = sa.sparse_bwd(q, k, v, o, lse, do, dlse, active, spec)
    second = sa.sparse_bwd(q, k, v, o, lse, do, dlse, active, spec)
    torch.cuda.synchronize()
    assert sa.sparse_attention.bwd_tc_launches - t0 == 2
    for name, x, y in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(x, y), name


@pytest.mark.cuda
@pytest.mark.parametrize("part", ["fwd", "bwd"])
def test_sparse_tensor_core_failure_raises(cuda_device, monkeypatch, part):
    """A tensor-core launch that reports an error raises; nothing falls
    back to the FMA kernels or the plain version."""
    sa, q, k, v, do, dlse, _, spec, active = _sparse_case("a_model",
                                                          cuda_device)
    calls = []

    class Lib:  # the tensor-core entry fails (cudaErrorInvalidValue)
        def __getattr__(self, name):
            if name.endswith("_sm90"):
                return lambda *args: 1
            return lambda *args: calls.append(name) or 0

    monkeypatch.setattr(sa._build, "load_kernel", lambda name, declare: Lib())
    with pytest.raises(RuntimeError, match=f"sparse_{part} launch"):
        if part == "fwd":
            sa.sparse_fwd(q, k, v, active, spec)
        else:
            sa.sparse_bwd(q, k, v, q, torch.zeros_like(q[..., 0]).float(), do,
                          dlse, active, spec)
    assert calls == []


@pytest.mark.cuda
def test_sparse_autograd_on_card_matches_cpu(cuda_device):
    """sparse_attention's autograd on the card against the same call on the
    CPU (plain versions), fp32, GQA, causal, ragged N, LSE cotangent."""
    from flashattention_tpu_torch.ops import sparse_attention

    gen = torch.Generator().manual_seed(6)
    base = [torch.randn(s, generator=gen) for s in
            ((2, 4, 150, 32), (2, 2, 150, 32), (2, 2, 150, 32))]
    pattern = torch.tensor([[1, 0, 0], [1, 1, 0], [0, 1, 1]], dtype=torch.bool)
    out = {}
    for dev in ("cpu", cuda_device):
        leaves = [t.detach().to(dev).requires_grad_(True) for t in base]
        o, lse = sparse_attention(*leaves, pattern.to(dev), causal=True,
                                  block_q=64, block_k=64)
        (o.square().sum() + lse.sum()).backward()
        out[str(dev)] = [o, lse] + [t.grad for t in leaves]
    for name, a, r in zip(("o", "lse", "dq", "dk", "dv"), out[str(cuda_device)],
                          out["cpu"]):
        assert_allclose(a, r, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.cuda
def test_sparse_kernel_rejects_what_it_does_not_take(cuda_device):
    from flashattention_tpu_torch.ops import sparse_attention

    pat = torch.ones(2, 2, dtype=torch.bool, device=cuda_device)
    q = torch.zeros(1, 2, 256, 32, device=cuda_device)
    with pytest.raises(TypeError):
        sparse_attention(q.half(), q.half(), q.half(), pat)
    for d in (36, 264):
        x = torch.zeros(1, 2, 256, d, device=cuda_device)
        with pytest.raises(ValueError, match="head_dim"):
            sparse_attention(x, x, x, pat)
    with pytest.raises(ValueError, match="pattern must be"):
        sparse_attention(q, q, q, pat[:1])
    with pytest.raises(ValueError, match="pattern must be on"):
        sparse_attention(q, q, q, pat.cpu())
    with pytest.raises(ValueError, match="k must be on"):
        sparse_attention(q, q.cpu(), q, pat)


@pytest.mark.cuda
def test_sparse_model_launch_counts(cuda_device):
    """A bf16 model with a pattern (remat "full"): one no-grad forward runs
    one sparse forward per layer; forward and backward run two (the remat
    recompute) and one sparse backward per layer; no flash kernel runs."""
    from flashattention_tpu_torch.models.train import token_nll
    from flashattention_tpu_torch.models.transformer import apply_transformer
    from flashattention_tpu_torch.ops import sparse_attn as sa

    cfg = dataclasses.replace(_tiny_train_config(dropout_rate=0.0),
                              block_size=16)
    params = init_params(cfg, seed=6, device=cuda_device)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, 97, (2, 65))).to(cuda_device)
    pattern = local_global(4, width=2).to(cuda_device)

    def counts():
        return (sa.sparse_attention.fwd_launches,
                sa.sparse_attention.bwd_launches,
                fa.kernel_attention.fwd_launches,
                fa.kernel_attention.bwd_launches)

    c0 = counts()
    with torch.no_grad():
        apply_transformer(params, toks[:, :-1], cfg, sparse_pattern=pattern)
    c1 = counts()
    logits = apply_transformer(params, toks[:, :-1], cfg, sparse_pattern=pattern)
    token_nll(logits, toks[:, 1:]).mean().backward()
    c2 = counts()
    n = cfg.n_layers
    assert tuple(b - a for a, b in zip(c0, c1)) == (n, 0, 0, 0)
    assert tuple(b - a for a, b in zip(c1, c2)) == (2 * n, n, 0, 0)
    assert all(torch.isfinite(p.grad).all() for p in params.parameters())


# ---------------------------------------------------------------------------
# Context parallelism (all ranks of a ring on one card) and MoE blocks
# ---------------------------------------------------------------------------

# kind: forward partials a causal ring of 4 ranks launches (rank r: r + 1
# for the ring, 2 (r + 1) halves for the bidirectional ring, one call each
# for all-gather); non-causal rings launch every step
CP_CAUSAL_LAUNCHES = {"ring": 10, "bidir": 20, "all_gather": 4}
CP_FULL_LAUNCHES = {"ring": 16, "bidir": 32, "all_gather": 4}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ring", "bidir", "all_gather"])
@pytest.mark.parametrize("causal,seg", [(True, False), (True, True),
                                        (False, True)])
def test_context_parallel_schedules_on_card(cuda_device, kind, causal, seg):
    """The schedules of 4 ranks run in turn on the card (bf16, the
    tensor-core kernels) against one flash call over the whole sequence:
    o, LSE and the three gradients, with an LSE cotangent; the exact
    partial launches, none for a future shard.

    Limit: the flash limit, plus, where the schedule merges or sums up to
    4 partials that the kernels return rounded to bf16, half an ulp of each
    (4 * 2**-9 * max|ref|). A non-causal row's output averages every key,
    so all outputs are small and the flash limit's atol (1e-3 * max|ref|)
    alone is below one rounding of a partial."""
    from flashattention_tpu_torch.parallel.ring import schedules_on_one_device

    b, h, n, d = 1, 4, 1024, 128
    gen = torch.Generator().manual_seed(5)
    q, k, v, do = (torch.randn((b, h, n, d), generator=gen).to(
        cuda_device, torch.bfloat16) for _ in range(4))
    dlse = torch.randn((b, h, n), generator=gen).to(cuda_device)
    ids = None
    if seg:
        ids = torch.zeros((b, n), dtype=torch.int32)
        ids[:, 300:] = 1
        ids[:, 700:] = 2
        ids = ids.to(cuda_device)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o_ref, lse_ref = fa.kernel_attention(*leaves, causal=causal,
                                         segment_ids=ids)
    torch.autograd.backward([o_ref, lse_ref], [do, dlse])
    f0, t0 = fa.kernel_attention.fwd_launches, fa.kernel_attention.fwd_tc_launches
    got = schedules_on_one_device(kind, q, k, v, 4, causal=causal,
                                  segment_ids=ids, do=do, dlse=dlse)
    torch.cuda.synchronize()
    want_launches = (CP_CAUSAL_LAUNCHES if causal else CP_FULL_LAUNCHES)[kind]
    assert fa.kernel_attention.fwd_launches - f0 == want_launches
    assert fa.kernel_attention.fwd_tc_launches - t0 == want_launches
    refs = [o_ref, lse_ref] + [t.grad for t in leaves]
    for name, a, r in zip(("o", "lse", "dq", "dk", "dv"), got, refs):
        assert torch.isfinite(a.float()).all(), name
        if name == "lse":
            assert_allclose(a, r, rtol=1e-4, atol=1e-4, err_msg=name)
        else:
            rtol, atol = flash_tol(torch.bfloat16, r)
            atol += 4 * 2 ** -9 * float(r.float().abs().max())
            assert_allclose(a, r, rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.cuda
def test_moe_block_on_card_matches_cpu(cuda_device):
    """One MoE layer forward and backward (capacity routing), bf16 on the
    card against fp32 on the CPU from the same bf16-representable inputs:
    output and gradients within 5e-2 relative L2, the same experts."""
    from types import SimpleNamespace

    from flashattention_tpu_torch.models import moe

    cfg = TransformerConfig(d_model=256, d_ff=512, moe_experts=8, moe_top_k=2,
                            moe_group_size=128)
    gen = torch.Generator().manual_seed(6)

    def rnd(*s, scale=1.0):
        return (torch.randn(s, generator=gen) * scale).bfloat16().float()

    base = dict(router=rnd(256, 8, scale=0.1), w_in=rnd(8, 256, 512, scale=0.05),
                b_in=rnd(8, 512, scale=0.05), w_out=rnd(8, 512, 256, scale=0.05),
                b_out=rnd(8, 256, scale=0.05))
    x0, dy = rnd(2, 256, 256), rnd(2, 256, 256)
    out = {}
    for dev, dt in (("cpu", torch.float32), (cuda_device, torch.bfloat16)):
        p = {n: t.to(dev).clone().requires_grad_(True)
             for n, t in base.items()}
        x = x0.to(dev, dt).clone().requires_grad_(True)
        y, aux = moe.moe_mlp(x, SimpleNamespace(**p), cfg)
        torch.autograd.backward([y, aux], [dy.to(dev, dt),
                                           torch.tensor(0.5, device=dev)])
        g = moe.group_size(256, cfg)
        _, _, _, _, idx = moe.route(x.detach().reshape(-1, g, 256), p["router"],
                                    cfg, moe.capacity(g, cfg, False))
        out[str(dev)] = dict(y=y, aux=aux, x=x.grad, idx=idx.cpu(),
                             **{n: t.grad for n, t in p.items()})
    card, cpu = out[str(cuda_device)], out["cpu"]
    assert torch.equal(card["idx"], cpu["idx"])
    assert abs(card["aux"].item() - cpu["aux"].item()) <= 5e-2
    for name in ("y", "x", "router", "w_in", "b_in", "w_out", "b_out"):
        a, r = card[name].float().cpu(), cpu[name].float()
        rel = float((a - r).norm() / r.norm())
        assert rel <= 5e-2, (name, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("fused,bias", [(True, True), (False, False)])
def test_compat_forward_on_card_matches_cpu(cuda_device, fused, bias):
    """A reference checkpoint (fp32) through compat: logits and loss on the
    card against the CPU at 1e-4 relative to the largest logit; two
    flash_fwd launches a layer, all on the FMA route."""
    from flashattention_tpu_torch.models import compat
    from flashattention_tpu_torch.utils.testing import reference_state_dict

    sd = reference_state_dict(vocab=211, d_model=128, n_layers=2, max_len=96,
                              fused=fused, bias=bias, seed=5)
    gen = torch.Generator().manual_seed(2)
    ids = torch.randint(0, 211, (3, 96), generator=gen)
    tgt = torch.randint(0, 211, (3, 96), generator=gen)
    out = {}
    for dev in ("cpu", cuda_device):
        params = compat.convert_reference_state_dict(sd, 2, device=dev)
        fa.kernel_attention.fwd_launches = 0
        fa.kernel_attention.fwd_tc_launches = 0
        with torch.no_grad():
            logits = compat.apply_reference_transformer(params, ids, tau=0.9)
            loss = compat.reference_lm_loss(params, ids, tgt, tau=0.9)
        out[str(dev)] = (logits.cpu(), float(loss),
                         fa.kernel_attention.fwd_launches,
                         fa.kernel_attention.fwd_tc_launches)
    (a, la, n, n_tc), (r, lr, _, _) = out[str(cuda_device)], out["cpu"]
    assert (n, n_tc) == (8, 0)  # two forwards, 2 x 2 layers each, FMA route
    scale = float(r.abs().max())
    assert float((a - r).abs().max()) <= 1e-4 * scale
    assert abs(la - lr) <= 1e-4 * abs(lr)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [("fa2", "forward", {}),
                                  ("fa2", "backward", {}),
                                  ("fa3", "forward",
                                   dict(fp8=True, fp8_fmt="int8"))])
def test_sweep_record_on_card(cuda_device, cell):
    """One sweep cell in-process: status ok, a roofline share of the card's
    peak in (0, 1.05], peak memory from the allocator."""
    from flashattention_tpu_torch.bench import sweep

    algo, direction, kw = cell
    rec = sweep.run_config(sweep.cell(algo, direction, 1024, 128, **kw))
    assert rec.status == "ok", rec.error
    assert rec.mean_ms > 0 and 0 < rec.roofline_frac <= 1.05
    assert rec.mem_source == "cuda_max_allocated" and rec.peak_mem_mb > 0
    assert rec.dtype == kw.get("fp8_fmt", "bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,n", [("int8", 1024), ("fp8", 512),
                                   ("fp8", 1024)])
def test_fa3_fp8_call_does_not_wait_for_the_card(cuda_device, fmt, n):
    """fa3_attention(fp8=True) issues its rotation, quantizers and kernel
    without the host waiting for the card (sync debug mode "error"): the
    fused 8-bit kernel (int8 at any length, e4m3 in one q block) and e4m3
    predecoded onto the flash forward."""
    from flashattention_tpu_torch.ops.api import fa3_attention

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((1, 2, n, 128), generator=gen, device=cuda_device,
                           dtype=torch.bfloat16) for _ in range(3))
    with torch.no_grad():
        ref, _ = fa3_attention(q, k, v, causal=True, fp8=True, fp8_fmt=fmt)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            o, _ = fa3_attention(q, k, v, causal=True, fp8=True, fp8_fmt=fmt)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(o, ref)


@pytest.mark.cuda
def test_benchmark_call_times_device_work_only(cuda_device):
    """benchmark_call refuses a call that makes the host wait for the card,
    and lengthens its stream hold until it covers a call that takes longer
    to issue than the hold: 3 ms of host time before a one-element add
    stays out of the events."""
    from flashattention_tpu_torch.bench.harness import benchmark_call

    x = torch.ones(4, device=cuda_device)
    with pytest.raises(RuntimeError):
        benchmark_call(lambda t: t.sum().item(), (x,), warmup=1, iters=2)
    assert torch.cuda.get_sync_debug_mode() == 0

    def slow_issue(t):
        time.sleep(0.003)
        return t + 1

    ms, _, _ = benchmark_call(slow_issue, (x,), warmup=1, iters=5)
    assert ms < 1.0
