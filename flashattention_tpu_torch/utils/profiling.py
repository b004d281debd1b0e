"""Profiling and timing.

The counterpart of ``flashattention_tpu/utils/profiling.py``:

- ``trace(logdir)``: a ``torch.profiler`` run (CPU activity, and CUDA where
  there is a card) around a block, exported as a Chrome trace (view it in
  Perfetto or ``chrome://tracing``).
- ``timed(fn, *args)``: the best seconds per iteration of chained calls,
  timed with CUDA events on the card.

The JAX module's ``enable_compile_cache`` and ``compiled_cost`` have no
counterpart: the port compiles no XLA programs (its kernels are built once
by ``_build``), so there is no compile cache to point anywhere and no HLO
cost model to ask; and ``torch.utils.flop_counter`` does not see kernels
launched through ctypes. ``bench.harness.attention_flops`` gives the
attention FLOP model instead.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Callable

import torch


@contextlib.contextmanager
def trace(logdir: str | Path):
    """Profile a block: ``with trace("traces") as prof: f()``. Yields the
    ``torch.profiler.profile``; on exit the Chrome trace is written under
    ``logdir`` and its path set as ``prof.trace_path``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    d = Path(logdir)
    d.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = d / f"trace_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(str(path))
    prof.trace_path = path


def timed(fn: Callable, *args, iters: int = 20, trials: int = 3) -> float:
    """Best per-iteration seconds of ``iters`` chained calls over
    ``trials``: ``fn(*args)``'s first output, cast to ``args[0]``'s dtype
    and shape, is the next call's first argument. CUDA events on the card,
    the host clock on CPU tensors."""
    a0 = args[0]
    cuda = a0.is_cuda

    def loop():
        x = a0
        for _ in range(iters):
            out = fn(x, *args[1:])
            first = out[0] if isinstance(out, (tuple, list)) else out
            x = first.to(a0.dtype).reshape(a0.shape)
        return x

    loop()  # warm-up: builds and loads the kernels
    best = float("inf")
    for _ in range(trials):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            loop()
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            loop()
            dt = time.perf_counter() - t0
        best = min(best, dt / iters)
    return best
