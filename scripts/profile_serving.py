"""Where a prefill chunk's and a decode step's time goes in the PyTorch
port's serving engine on one NVIDIA GPU: the serving profile of
``chip_smoke.py`` (phases 3 and 3b: GPT-3 Small widths, bf16, batch 32;
32 admissions of 200-token prompts, then 20 decode steps) with bf16 and
fp8 pages, alone, printed as one JSON line.

    python3 scripts/profile_serving.py              # this checkout
    python3 scripts/profile_serving.py --tree DIR   # another checkout

With ``--tree`` this checkout's profile code measures the
``flashattention_tpu_torch`` package of DIR (a checkout of another commit
of the repository), so two versions can be compared on one card, in
turns A, B, B, A. The profile times admission apart from decoding through
the engine's ``_admit`` and checks the batch through ``_num_active``, so
DIR's ``ServingEngine`` must have both. Exits nonzero without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="checkout whose package is measured")
    args = ap.parse_args()
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    # this checkout's chip_smoke.py, which imports DIR's package
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import flashattention_tpu_torch

    if Path(flashattention_tpu_torch.__file__).resolve().parents[1] != tree:
        print(f"profile_serving: the package was not imported from {tree}",
              file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device; nothing was measured",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    smoke.log(f"[card] {card}; package of {tree}")
    cfg, ecfg = smoke.serving_config()
    params = smoke.init_params(cfg, seed=smoke.SEED, device="cpu")
    dev = torch.device("cuda")
    prof = {q or "bf16": smoke.phase_profile(
        cfg, params, dataclasses.replace(ecfg, quant=q), dev)
        for q in (None, "fp8")}
    print(json.dumps({"card": card, "tree": str(tree), "profile": prof}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
