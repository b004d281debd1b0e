"""Device time of each flash kernel of the PyTorch port on one NVIDIA GPU:
the forward and the backward's two kernels (dK/dV, then dQ; above D = 128
in fp32 also the split of its B operands and, where a GQA/MQA group is
spread over dK/dV CTAs, the sum of their partials) of
``kernel_attention``'s routes at the training shape (8, 12, 512, D), bf16
and fp32 (3xTF32) at D = 64 and fp32 at D = 128, causal and not, from
``torch.profiler`` over 20 forward + backward calls. Prints the card's
name and power limit, then one JSON line; exits nonzero without a card.

    python3 scripts/flash_kernel_split.py
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from flashattention_tpu_torch.ops import flash_attn as fa  # noqa: E402

CALLS = 20
CONFIGS = ((torch.float32, 64), (torch.bfloat16, 64), (torch.float32, 128))


def kernel_ms(q, k, v, do, causal):
    """{kernel name: mean device ms a call} over CALLS forward + backward
    calls (after three of each to warm up)."""
    opts = fa.make_opts(q, k, causal=causal)
    o, lse = fa.flash_fwd(q, k, v, opts)
    for _ in range(3):
        fa.flash_fwd(q, k, v, opts)
        fa.flash_bwd(q, k, v, o, lse, do, None, opts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fa.flash_fwd(q, k, v, opts)
            fa.flash_bwd(q, k, v, o, lse, do, None, opts)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        name = re.search(
            r"flash_\w+_kernel(?:<[^>]*>)?|tf32_split_kernel|kv_sum_kernel",
            e.key)
        if name:
            total = (e.device_time_total if hasattr(e, "device_time_total")
                     else e.cuda_time_total)  # µs over the CALLS calls
            out[name.group(0)] = total / e.count / 1e3
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_kernel_split: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    gen = torch.Generator().manual_seed(1)
    out = []
    for dtype, d in CONFIGS:
        q, k, v, do = (torch.randn(8, 12, 512, d, generator=gen)
                       .to("cuda", dtype) for _ in range(4))
        for causal in (True, False):
            out.append(dict(dtype=str(dtype).replace("torch.", ""), d=d,
                            causal=causal, ms=kernel_ms(q, k, v, do, causal)))
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "shape": [8, 12, 512], "kernels": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
