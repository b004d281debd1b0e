"""One-time timing of the PyTorch port's route that still runs a first
CUDA-core FMA kernel at head dim 256, on one NVIDIA GPU: the 8-bit forward
(B4) in int8 at (1, 8, 8192, 256) causal on its FMA kernel, with its bound
and bf16 SDPA on the dequantized inputs as a yardstick.

It is launched once on the FMA route (checked by the route counter), held
against its plain version and timed by ``chip_smoke.py``'s own case
function. The dense fp32 flash pair at that shape runs on the tensor cores
and is ``chip_smoke.py``'s flash case (m), which times the FMA kernels
beside it; the sparse fp32 route is its sparse case (c). Prints the card's
name and power limit, then one JSON line; exits nonzero without a card.

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
    cs.FP8_CASES["int8_d256"] = FP8
    out = {"fp8_int8_d256": cs.fp8_case(timer, gen, dev, "int8_d256")}
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
