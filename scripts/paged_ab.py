"""Phase 2's paged-attention cases at D <= 128 (``chip_smoke.paged_cases``,
PERF.md rows 7-8) and at head dim 256 (``chip_smoke.paged_d256_table``,
rows 7w-8w) for the package of one checkout, on one NVIDIA GPU, printed as
one JSON line of kernel ms (split route and its walk, and the first
kernel) per case, after the ptxas spill report of the paged library, built
anew.

    python3 scripts/paged_ab.py              # this checkout
    python3 scripts/paged_ab.py --tree DIR   # another checkout

With ``--tree`` this checkout's ``chip_smoke.py`` times the
``flashattention_tpu_torch`` package of DIR, so two versions compare on
one card in turns A, B, B, A (the inputs come from one seed, so both see
the same). Exits nonzero without a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
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
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    if not torch.cuda.is_available():
        print("paged_ab: no CUDA device", file=sys.stderr)
        return 1
    from flashattention_tpu_torch import _build
    from flashattention_tpu_torch.ops import paged_attention as pa

    _build.kernel_path("paged_attention").unlink(missing_ok=True)
    _build.load_kernel("paged_attention", pa._declare)
    spills = {name: spill for name, (_, spill) in cs.ptxas_entries(
        _build.BUILD_LOG["paged_attention"]).items() if spill}
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(cs.SEED)
    timer = cs.Timer(dev)
    cases = {**cs.paged_cases(gen), **cs.paged_d256_table(gen)}
    out = {}
    for key, (name, dtype, kw) in cases.items():
        r = cs.attention_case(timer, gen, dev, name, dtype, **kw)
        out[key] = dict(ms=r["ms"], first_ms=r.get("first_ms"),
                        route=r["route"], walk=r["walk"])
        torch.cuda.empty_cache()
    print(json.dumps(dict(tree=str(tree), spills=spills, cases=out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
