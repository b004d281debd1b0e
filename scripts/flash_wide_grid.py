"""Device time of each kernel of the flash pair above head dim 256
(``csrc/flash_wide.cu``: forward, dK/dV, dQ) at chip_smoke phase 5d's call
(B = 1, 4 query heads, N = 2048, D = 512, causal) with the query heads
over 1, 2 and 4 KV heads, and at B = 4 over one KV head, in bf16 and fp32,
from ``torch.profiler`` (``scripts/flash_kernel_split.py``'s
``kernel_ms``). Every KV-head count does the same products (each query
head's S, dP, dK and dV over all keys); what changes is the number of
dK/dV CTAs (B * H_kv * ceil(N / 64) * D / 128: 128 at phase 5d's MQA
call, 512 with 4 KV heads) and how many query heads each one walks. B = 4
gives 4x the work and 4x the CTAs. Prints the card's name and power limit,
then one JSON line; exits nonzero without a card.

    python3 scripts/flash_wide_grid.py
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
# (B, H, H_kv, N, D)
SHAPES = ((1, 4, 1, 2048, 512), (1, 4, 2, 2048, 512), (1, 4, 4, 2048, 512),
          (4, 4, 1, 2048, 512))


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_wide_grid: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    spec = importlib.util.spec_from_file_location(
        "flash_kernel_split", ROOT / "scripts" / "flash_kernel_split.py")
    split = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(split)
    gen = torch.Generator().manual_seed(1)
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        for b, h, h_kv, n, d in SHAPES:
            q, do = (torch.randn(b, h, n, d, generator=gen).to("cuda", dtype)
                     for _ in range(2))
            k, v = (torch.randn(b, h_kv, n, d, generator=gen)
                    .to("cuda", dtype) for _ in range(2))
            out.append(dict(dtype=str(dtype).replace("torch.", ""),
                            shape=[b, h, h_kv, n, d],
                            ms=split.kernel_ms(q, k, v, do, True)))
            del q, k, v, do
            torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "causal": True, "kernels": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
