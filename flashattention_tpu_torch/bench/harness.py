"""Timing and records for the benchmark suite.

The counterpart of ``flashattention_tpu/bench/harness.py``. A record holds
algo / backend / direction / shape / causal / dtype, the time, TFLOP/s and
the share of the card's peak (``roofline_frac``), peak memory, and
``status`` ("ok" / "oom" / "failed"). The fields are the JAX package's, so
records of the two packages load side by side.

Timing (``time_calls``, also ``chip_smoke.py``'s timer): CUDA events
around each call, the L2 flushed before it and the stream held by a sleep
kernel while the host issues the call, so the events bracket device work
only; the median of the samples. ``benchmark_call`` refuses a call that
makes the host wait for the card, and lengthens the hold until it covers
the host's issue of every timed call.
"""

from __future__ import annotations

import csv
import dataclasses
import functools
import json
import statistics
import time
from pathlib import Path
from typing import Any, Callable

import torch

# Dense peaks of the cards the port is measured on, TFLOP/s (TOPS for
# int8), by device name (``torch.cuda.get_device_name``).
CARD_PEAKS = {
    # H100 SXM: 989 bf16 tensor, 1979 fp8/int8 tensor; fp32 165, the
    # fp32-exact tensor-core rate the flash kernels run fp32 at (3xTF32:
    # three TF32 products at 495 a product), above the CUDA cores' 67, so
    # no fp32 cell can read a roofline share above 1
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989.0, "fp8": 1979.0,
                              "int8": 1979.0, "float32": 165.0},
}
# the record's dtype names -> the peak they run at
_PEAK_OF = {"bf16": "bfloat16", "bfloat16": "bfloat16", "fp32": "float32",
            "float32": "float32", "fp8": "fp8", "e5m2": "fp8", "int8": "int8"}


def peak_tflops(dtype: str, device_kind: str | None = None) -> float:
    """The card's dense peak for ``dtype`` ("bf16", "fp32", "fp8", "e5m2",
    "int8"); ``device_kind`` defaults to the card's name. A card without a
    known peak raises: no roofline share is made up."""
    if device_kind is None:
        device_kind = torch.cuda.get_device_name(0)
    peaks = CARD_PEAKS.get(device_kind)
    if peaks is None:
        raise ValueError(f"no peak rates known for {device_kind!r}; add them "
                         "to bench.harness.CARD_PEAKS")
    if dtype not in _PEAK_OF:
        raise ValueError(f"no peak rate for dtype {dtype!r}")
    return peaks[_PEAK_OF[dtype]]


def attention_flops(
    b: int, h: int, n: int, d: int, *, direction: str = "forward",
    causal: bool = False,
) -> float:
    """The reference's FLOP model: forward 4·B·H·N²·d, backward 2x the
    forward, both 3x; causal halves the work."""
    f = 4.0 * b * h * n * n * d
    if direction == "backward":
        f *= 2.0
    elif direction == "both":
        f *= 3.0
    if causal:
        f /= 2.0
    return f


@dataclasses.dataclass
class BenchRecord:
    algo: str
    backend: str
    direction: str
    batch: int
    heads: int
    seqlen: int
    head_dim: int
    causal: bool
    dtype: str
    mean_ms: float = 0.0
    pstdev_ms: float = 0.0
    tflops: float = 0.0
    roofline_frac: float = 0.0
    peak_mem_mb: float = 0.0
    # where peak_mem_mb came from: "cuda_max_allocated"
    # (torch.cuda.max_memory_allocated over the timed calls)
    mem_source: str = ""
    status: str = "ok"
    error: str = ""

    def row(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def device_peak_memory_mb() -> float:
    """Peak memory allocated on the card by this process since the last
    ``torch.cuda.reset_peak_memory_stats``, in MB."""
    return torch.cuda.max_memory_allocated() / 1e6


# 128 MB of float32, written before each timed call: evicts the 50 MB L2
FLUSH_FLOATS = 32 * 1024 * 1024
# Cycles of the sleep kernel that holds the stream while the host issues a
# timed call: about 1 ms on an H100. ``benchmark_call`` quadruples it, up
# to ``MAX_HOLD_CYCLES``, for a call whose issue takes longer.
HOLD_CYCLES = 2_000_000
MAX_HOLD_CYCLES = 128_000_000


def l2_flush_buffer(device="cuda") -> torch.Tensor:
    return torch.empty(FLUSH_FLOATS, dtype=torch.float32, device=device)


def time_calls(fn: Callable, flush: torch.Tensor, *, reps: int,
               warmup: int = 0, hold_cycles: int | None = HOLD_CYCLES
               ) -> tuple[list[float], int]:
    """(ms of each of ``reps`` timed calls of ``fn()``, the number of them
    the hold did not cover), after ``warmup`` untimed calls. Before each
    timed call ``flush`` is zeroed. With ``hold_cycles`` a sleep kernel
    holds the stream while the host issues the start event, the call and
    the end event, so the events bracket device work only; a sample is not
    covered when the sleep had ended before the end event was issued (the
    card then waited for the host inside the events). With ``hold_cycles``
    None the card is idle when the host starts to issue the call, and the
    events take in the host's issue, as a caller meets it."""
    for _ in range(warmup):
        fn()
    samples, uncovered = [], 0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if hold_cycles:
            torch.cuda._sleep(hold_cycles)
        else:
            torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        uncovered += bool(hold_cycles) and start.query()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return samples, uncovered


def benchmark_call(fn: Callable, args: tuple, *, warmup: int = 3,
                   iters: int = 30) -> tuple[float, float, float]:
    """(median ms, pstdev ms of the samples, peak MB) of ``fn(*args)`` on
    the card: ``warmup`` untimed calls, one more in which any wait of the
    host for the card raises (its events would hold host time), then
    ``iters`` timed ones (:func:`time_calls`), again with a hold four times
    longer while the hold did not cover every call. Peak MB: the most this
    process had allocated during the timed calls (the inputs included),
    less the flush buffer."""
    if not torch.cuda.is_available():
        raise RuntimeError("benchmark_call times on the card; there is none")
    flush = l2_flush_buffer()
    call = functools.partial(fn, *args)
    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hold = HOLD_CYCLES
    while True:
        samples, uncovered = time_calls(call, flush, reps=iters,
                                        hold_cycles=hold)
        if not uncovered:
            break
        if hold >= MAX_HOLD_CYCLES:
            raise RuntimeError(f"a {hold}-cycle hold did not cover the "
                               f"host's issue of {uncovered} of {iters} calls")
        hold *= 4
    peak = device_peak_memory_mb() - flush.numel() * flush.element_size() / 1e6
    return statistics.median(samples), statistics.pstdev(samples), peak


def write_results(
    records: list[BenchRecord], out_dir: str | Path, tag: str
) -> tuple[Path, Path]:
    """Timestamped JSON + CSV."""
    if not records:
        raise ValueError("write_results needs at least one record")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    ts = time.strftime("%Y%m%d_%H%M%S")
    jpath = out_dir / f"{tag}_{ts}.json"
    cpath = out_dir / f"{tag}_{ts}.csv"
    rows = [r.row() for r in records]
    jpath.write_text(json.dumps(rows, indent=1))
    with open(cpath, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
    return jpath, cpath


def console_table(records: list[BenchRecord]) -> str:
    """Fixed-width table."""
    hdr = (f"{'algo':6} {'backend':8} {'dir':8} {'N':>6} {'d':>4} "
           f"{'causal':>6} {'dtype':9} {'ms':>9} {'TFLOP/s':>8} "
           f"{'%roof':>6} {'status':>7}")
    lines = [hdr, "-" * len(hdr)]
    for r in records:
        lines.append(
            f"{r.algo:6} {r.backend:8} {r.direction:8} {r.seqlen:>6} "
            f"{r.head_dim:>4} {str(r.causal):>6} {r.dtype:9} "
            f"{r.mean_ms:>9.3f} {r.tflops:>8.1f} "
            f"{100 * r.roofline_frac:>5.1f}% {r.status:>7}"
        )
    return "\n".join(lines)
