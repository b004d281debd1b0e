"""Runs one card test of ``tests/test_torch_cuda.py`` many times in one
process and keeps every failure's message: the way to tell a fault that
shows once in many runs (a race) from a check of the profiler's records.

    python3 scripts/repeat_card_test.py \\
        "tests/test_torch_cuda.py::test_flash_kernels_match_plain[bf16_d192_gqa_window_dropout]" \\
        --count 100

The kernels are built once (the first run); each run is one
``pytest.main`` on the node, its output dropped. Prints the card's name and
power limit, then one JSON line: runs, passes, and each failure's run
number, check (the failing assertion's message line) and the end of its
report; writes ``chiprun_out/repeat_card_test.json``. Exits nonzero
without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


class Failures:
    """pytest plugin: the reports of this run's failed phases."""

    def __init__(self):
        self.reports = []

    def pytest_runtest_logreport(self, report):
        if report.failed:
            self.reports.append(report.longreprtext)


def check_line(text: str) -> str:
    """The assertion's message: the first line that starts with "E"."""
    for line in text.splitlines():
        if line.startswith("E "):
            return line[1:].strip()
    return text.strip().splitlines()[-1] if text.strip() else ""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("node", help="pytest node id of a card test")
    ap.add_argument("--count", type=int, default=100)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("repeat_card_test: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    sys.path.insert(0, str(ROOT))
    fails, passes = [], 0
    for i in range(args.count):
        plugin = Failures()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = pytest.main([args.node, "--noconftest", "-p",
                              "no:cacheprovider", "-q"], plugins=[plugin])
        if rc == 0:
            passes += 1
        else:
            text = "\n".join(plugin.reports) or f"pytest exit code {rc}"
            fails.append(dict(run=i, check=check_line(text),
                              report=text[-4000:]))
            print(f"run {i}: {fails[-1]['check']}", flush=True)
    out = dict(node=args.node, runs=args.count, passed=passes, failures=fails)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "repeat_card_test.json").write_text(
        json.dumps(out))
    print(json.dumps(dict(out, failures=[
        {k: f[k] for k in ("run", "check")} for f in fails])))
    return 0 if not fails else 2


if __name__ == "__main__":
    sys.exit(main())
