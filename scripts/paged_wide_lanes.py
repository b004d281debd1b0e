"""The split paged-attention kernel above D = 128 at 64, 128 and 256 slots
a split (``ops/paged_attention.SPLIT_SLOTS`` takes 128), on one NVIDIA
GPU, in its lane layout (16 lanes a slot at 16 columns a lane; the C entry
is called directly with the plan's other fields, so no package setting
changes). Cases at Gemma 2B's attention widths (8 query heads over 1 KV
head, D = 256) on the serving engine's shapes: the decode step (B = 32,
page 16, lengths 256-4096) over bf16, int8 ("qk") and e4m3 pages, a T = 64
prefill chunk at length 2048 and the speculative verify chunk (B = 32,
T = 5). Each case is held against the plain version (2e-2) and timed (CUDA
events, median of 30, L2 flushed, the stream held while the host issues)
in the order 64, 128, 256, 256, 128, 64, and its two kernels (the split
walk, the merge) timed apart under torch.profiler. Prints the card's name
and power limit, each reading, and one JSON line; writes
``chiprun_out/paged_wide_lanes.json``. Exits nonzero without a card.

    python3 scripts/paged_wide_lanes.py
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from flashattention_tpu_torch import _build  # noqa: E402
from flashattention_tpu_torch.bench import harness  # noqa: E402
from flashattention_tpu_torch.ops import paged_attention as pa  # noqa: E402
from flashattention_tpu_torch.ops.quant import quantize_tokens  # noqa: E402

SLOTS = (64, 128, 256)
TOL = 2e-2


def kernel_split(fn, n=5):
    """Device ms of one call's split-walk and merge kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {"split": 0.0, "merge": 0.0}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        for k in out:
            if f"paged_{k}_kernel" in e.key:
                out[k] += us / n / 1e3
    return out


def inputs(gen, dev, *, b, q_len, lengths, quant, pps=256):
    """q (B, 8[, T], 256) bf16, pages of noise (quantized per slot for
    ``quant``), a shuffled table: Gemma 2B's MQA on 16-slot pages."""
    num_pages = b * pps + 1
    shape = (1, num_pages, 16, 256)
    kp = torch.randn(shape, generator=gen, device=dev)
    vp = torch.randn(shape, generator=gen, device=dev)
    kw = {}
    if quant:
        (kp, ks), (vp, vs) = (quantize_tokens(x, quant) for x in (kp, vp))
        kw = dict(k_scales=ks[..., None].contiguous(),
                  v_scales=vs[..., None].contiguous())
    else:
        kp, vp = kp.bfloat16(), vp.bfloat16()
    perm = torch.randperm(num_pages - 1, generator=gen, device=dev) + 1
    pi = perm[: b * pps].reshape(b, pps).to(torch.int32)
    qs = (b, 8, 256) if q_len == 1 else (b, 8, q_len, 256)
    q = torch.randn(qs, generator=gen, device=dev).bfloat16()
    ln = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    return (q, kp, vp, pi, ln), kw


def split_call(args, kw, slots):
    """The split route's two kernels on ``args`` with splits of ``slots``
    slots, the rest of the plan as ``split_plan`` gives it."""
    q, kp, vp, pi, ln = args
    qq = q[:, :, None] if q.dim() == 3 else q
    b, h, t, d = qq.shape
    h_kv, num_pages, page, _ = kp.shape
    pps = pi.shape[1]
    quant = "k_scales" in kw
    mode = pa.int8_mode(kp, q.dtype, t, None) if quant else "convert"
    plan = pa.split_plan(h, h_kv, t, d, page, pps, quant)
    split_pages = max(1, slots // page)
    n_splits = -(-pps // split_pages)
    lib = _build.load_kernel("paged_attention", pa._declare)
    part = torch.empty(n_splits * b * h * t * (d + 2), dtype=torch.float32,
                       device=q.device)
    out = torch.empty_like(qq)
    err = lib.fat_paged_attention_split(
        qq.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        kw["k_scales"].data_ptr() if quant else None,
        kw["v_scales"].data_ptr() if quant else None, pi.data_ptr(),
        ln.data_ptr(), part.data_ptr(), out.data_ptr(), b, h, h_kv, t, d,
        num_pages, page, pps, d ** -0.5, 0, 0, 0.0,
        pa._FMT_CODE.get(kp.dtype, 0), pa._MODE_CODE[mode], split_pages,
        n_splits, plan["lg"], plan["epl"], plan["rps"], plan["nrs"],
        plan["stages"], torch.cuda.current_stream().cuda_stream)
    _build.check(err, "paged_attention split launch")
    return out[:, :, 0] if q.dim() == 3 else out


def main() -> int:
    if not torch.cuda.is_available():
        print("paged_wide_lanes: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    hgen = torch.Generator().manual_seed(0)
    decode_len = torch.randint(256, 4097, (32,), generator=hgen).tolist()
    verify_len = torch.randint(256, 4097, (32,), generator=hgen).tolist()
    cases = {
        "decode_bf16": dict(b=32, q_len=1, lengths=decode_len, quant=None),
        "decode_int8_qk": dict(b=32, q_len=1, lengths=decode_len,
                               quant="int8"),
        "decode_e4m3": dict(b=32, q_len=1, lengths=decode_len, quant="fp8"),
        "chunk_t64_bf16": dict(b=1, q_len=64, lengths=[2048], quant=None),
        "verify_t5_bf16": dict(b=32, q_len=5, lengths=verify_len, quant=None),
    }
    flush = harness.l2_flush_buffer(dev)
    made = {name: inputs(gen, dev, **c) for name, c in cases.items()}
    keys = [f"s{n}" for n in SLOTS]
    out = {name: {k: dict(ms=[]) for k in keys} for name in cases}
    for slots in SLOTS + SLOTS[::-1]:
        key = f"s{slots}"
        for name, (args, kw) in made.items():
            rec = out[name][key]

            def call():
                return split_call(args, kw, slots)

            o = call()
            torch.cuda.synchronize()
            if "max_abs_err" not in rec:
                ref = pa.paged_attention_plain(*args, **kw)
                err = (o.float() - ref.float()).abs()
                if bool((err > TOL + TOL * ref.float().abs()).any()):
                    raise SystemExit(
                        f"{name} {key}: max |kernel - plain| "
                        f"{float(err.max()):.3e} over {TOL}")
                rec["max_abs_err"] = float(err.max())
                rec["kernels_ms"] = kernel_split(call)
            rec["ms"].append(statistics.median(harness.time_calls(
                call, flush, reps=30, warmup=3)[0]))
            print(f"{name} {key}: {rec['ms'][-1]:.4f} ms (split walk "
                  f"{rec['kernels_ms']['split']:.4f}, merge "
                  f"{rec['kernels_ms']['merge']:.4f}; max_abs_err "
                  f"{rec['max_abs_err']:.3e})", flush=True)
    rec = dict(card=card, cases=out)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "paged_wide_lanes.json").write_text(
        json.dumps(rec, indent=1))
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
