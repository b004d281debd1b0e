"""One-time timing of the PyTorch port's routes that still run the first
CUDA-core FMA kernels at head dim 256, on one NVIDIA GPU:

- the dense flash forward and backward in fp32 at (1, 8, 8192, 256) causal
  (``fat_flash_fwd`` / ``fat_flash_bwd``), beside fp32 SDPA;
- the 8-bit forward (B4) in int8 at (1, 8, 8192, 256) causal on its FMA
  kernel, with its bound and bf16 SDPA on the dequantized inputs as a
  yardstick.

Each is launched once on the FMA route (checked by the route counters),
held against its plain version and timed by ``chip_smoke.py``'s own case
functions. The sparse fp32 route is ``chip_smoke.py``'s sparse case (c).
Prints the card's name and power limit, then one JSON line; exits nonzero
without a card.

    python3 scripts/fma_routes.py
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

FLASH = ("fp32 B=1 H=8 N=8192 D=256 causal: the FMA kernels",
         (1, 8, 8, 8192, 8192, 256), torch.float32, dict(causal=True), ())
FP8 = ("(1, 8, 8192, 256) int8 causal, auto (fused): the FMA kernel",
       (1, 8, 8, 8192, 256), dict(causal=True, fmt="int8"), ())


def main() -> int:
    if not torch.cuda.is_available():
        print("fma_routes: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(cs.SEED)
    timer = cs.Timer(dev)
    cs.FLASH_CASES["fp32_d256"] = FLASH
    cs.FP8_CASES["int8_d256"] = FP8
    out = {"flash_fp32_d256": cs.flash_case(timer, gen, dev, "fp32_d256")}
    torch.cuda.empty_cache()
    out["fp8_int8_d256"] = cs.fp8_case(timer, gen, dev, "int8_d256")
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
