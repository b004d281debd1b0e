"""The port's profiling helpers (``flashattention_tpu_torch/utils/
profiling.py``) on the CPU: a trace is written, and ``timed`` chains its
calls."""

import json

import torch

from flashattention_tpu_torch.ops.api import flash_attention
from flashattention_tpu_torch.utils import profiling


def test_trace_writes_a_chrome_trace(tmp_path):
    q = torch.randn(1, 2, 64, 16)
    with profiling.trace(tmp_path / "tr") as prof:
        flash_attention(q, q, q, causal=True)
    path = prof.trace_path
    assert path.parent == tmp_path / "tr" and path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_timed_chains_the_first_output():
    calls = []

    def fn(x, y):
        calls.append(x.clone())
        return x + y, "ignored"

    a = torch.zeros(3)
    sec = profiling.timed(fn, a, torch.ones(3), iters=4, trials=2)
    assert sec > 0
    # warm-up loop and two trials, each chained from args[0]
    assert len(calls) == 12
    assert [float(c[0]) for c in calls[:4]] == [0.0, 1.0, 2.0, 3.0]
