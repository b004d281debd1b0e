"""The append's kernel times (``chip_smoke.append_case``: B7 at the
engine's decode step, B = 32, and at a T = 64 prefill chunk) in every page
format at head dims 64 (12 KV heads, phase 2's cases), 128 (12 KV heads),
256 and 512 (one KV head, phases 2 and 3c-3d) for the package of one
checkout, on one NVIDIA GPU, printed as one JSON line of kernel ms per case
after the ptxas register and spill report of the append library, built
anew.

    python3 scripts/append_ab.py              # this checkout
    python3 scripts/append_ab.py --tree DIR   # another checkout

With ``--tree`` this checkout's ``chip_smoke.py`` times the
``flashattention_tpu_torch`` package of DIR, so two versions compare on
one card in turns A, B, B, A (the inputs come from one seed, so both see
the same). Each case is checked bit-exact against the plain version.
Exits nonzero without a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (head dim, KV heads, max_len) of the cases
SHAPES = ((64, 12, 512), (128, 12, 512), (256, 1, 4096), (512, 1, 4096))


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
        print("append_ab: no CUDA device", file=sys.stderr)
        return 1
    from flashattention_tpu_torch import _build
    from flashattention_tpu_torch.ops import paged_append as pap

    _build.kernel_path("paged_append").unlink(missing_ok=True)
    _build.load_kernel("paged_append", pap._declare)
    regs = sorted({r for r, _ in cs.ptxas_entries(
        _build.BUILD_LOG["paged_append"]).values()})
    spills = {name: spill for name, (_, spill) in cs.ptxas_entries(
        _build.BUILD_LOG["paged_append"]).items() if spill}
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(cs.SEED)
    timer = cs.Timer(dev)
    out = {}
    for d, h, max_len in SHAPES:
        for fmt in cs.APPEND_FORMATS:
            for kind in ("decode", "chunk"):
                r = cs.append_case(timer, gen, dev, fmt, kind, h=h, d=d,
                                   max_len=max_len)
                out[f"{fmt}_{kind}_d{d}"] = dict(ms=r["ms"],
                                                 floor_ms=r["floor_ms"])
        torch.cuda.empty_cache()
    print(json.dumps(dict(tree=str(tree), registers=regs, spills=spills,
                          cases=out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
