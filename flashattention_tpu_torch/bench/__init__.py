"""Benchmark harness: per-config timing on the card, TFLOP/s and roofline
accounting, JSON/CSV records, figures.

The counterpart of ``flashattention_tpu/bench``: the same record schema,
FLOP model (4·B·H·N²·d forward, 2x backward) and sweep grid; the roofline
is the card's (``harness.peak_tflops``). Run the sweep with
``python -m flashattention_tpu_torch.bench.sweep --quick``.
"""

from flashattention_tpu_torch.bench.harness import (
    BenchRecord,
    attention_flops,
    benchmark_call,
    peak_tflops,
    write_results,
)

__all__ = [
    "BenchRecord",
    "attention_flops",
    "benchmark_call",
    "peak_tflops",
    "write_results",
]
