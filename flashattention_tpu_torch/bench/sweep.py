"""Benchmark sweep CLI on the card.

The counterpart of ``flashattention_tpu/bench/sweep.py``: the same grid and
flags. Each config runs in a fresh subprocess, so a failed or out-of-memory
cell costs that cell, not the sweep.

    python -m flashattention_tpu_torch.bench.sweep --quick
    python -m flashattention_tpu_torch.bench.sweep \\
        --seqlens 512 1024 2048 4096 8192 16384 --dims 64 128 256 \\
        --algos fa2 fa3 --directions forward backward --plot

A backward cell times forward + backward and consumes all three gradients.
``--fp8`` runs fa3's 8-bit path with payloads of ``--fp8-fmt`` (e4m3 by
default, as the JAX package; int8 payloads take the fused 8-bit kernel at
any length, e4m3 and e5m2 only where one q block covers the sequence).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Callable

import torch

from flashattention_tpu_torch.bench.harness import (
    BenchRecord,
    attention_flops,
    benchmark_call,
    console_table,
    peak_tflops,
    write_results,
)


def cell(algo: str, direction: str, seqlen: int, dim: int, *,
         causal: bool = True, dtype: str = "bf16", backend: str = "kernel",
         batch: int = 1, heads: int = 4, fp8: bool = False,
         fp8_fmt: str = "fp8", dropout: float = 0.0,
         kv_heads: int | None = None) -> argparse.Namespace:
    """One config, as :func:`run_config` takes it."""
    return argparse.Namespace(
        algo=algo, direction=direction, seqlen=seqlen, dim=dim, causal=causal,
        dtype=dtype, backend=backend, batch=batch, heads=heads, fp8=fp8,
        fp8_fmt=fp8_fmt, dropout=dropout, kv_heads=kv_heads)


def cell_call(ns) -> tuple[Callable, tuple, str]:
    """(fn, args, record dtype) of one config: ``fn(*args)`` is the call
    :func:`run_config` times, on seeded inputs on the card."""
    from flashattention_tpu_torch.ops import api

    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[ns.dtype]
    kv_heads = ns.kv_heads or ns.heads
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(h):
        return torch.randn((ns.batch, h, ns.seqlen, ns.dim), generator=gen,
                           device="cuda", dtype=torch.float32).to(dtype)

    q, k, v = rand(ns.heads), rand(kv_heads), rand(kv_heads)
    kwargs = dict(causal=ns.causal, backend=ns.backend)
    rec_dtype = ns.dtype
    if ns.algo == "fa3":
        algo_fn = api.fa3_attention
        if ns.fp8:
            kwargs.update(fp8=True, fp8_fmt=ns.fp8_fmt)
            rec_dtype = ns.fp8_fmt
        if ns.dropout > 0.0:
            kwargs.update(dropout_rate=ns.dropout, dropout_seed=9)
    elif ns.dropout > 0.0:
        # fa1/fa2 keep the reference's signature (no dropout argument):
        # the generic entry point carries it
        algo_fn = api.flash_attention
        kwargs.update(dropout_rate=ns.dropout, dropout_seed=9)
    else:
        algo_fn = {"fa1": api.fa1_attention, "fa2": api.fa2_attention}[ns.algo]

    if ns.direction == "forward":
        def fn(q_, k_, v_):
            with torch.no_grad():
                return algo_fn(q_, k_, v_, **kwargs)[0]
    else:
        def fn(q_, k_, v_):
            leaves = [t.detach().requires_grad_(True) for t in (q_, k_, v_)]
            o, _ = algo_fn(*leaves, **kwargs)
            dq, dk, dv = torch.autograd.grad(o.float().square().sum(), leaves)
            # every gradient consumed; dk/dv may have fewer heads (GQA)
            return dq + (dk + dv).sum(1, keepdim=True).to(dq.dtype)
    return fn, (q, k, v), rec_dtype


def run_config(ns) -> BenchRecord:
    """Time one config on the card; failures land in the record."""
    rec = BenchRecord(
        algo=ns.algo, backend=ns.backend, direction=ns.direction,
        batch=ns.batch, heads=ns.heads, seqlen=ns.seqlen, head_dim=ns.dim,
        causal=ns.causal, dtype=ns.dtype,
    )
    try:
        fn, args, rec.dtype = cell_call(ns)
        rec.mean_ms, rec.pstdev_ms, rec.peak_mem_mb = benchmark_call(fn, args)
        rec.mem_source = "cuda_max_allocated"
        flops = attention_flops(
            ns.batch, ns.heads, ns.seqlen, ns.dim,
            direction="both" if ns.direction == "backward" else "forward",
            causal=ns.causal,
        )
        rec.tflops = flops / (rec.mean_ms / 1e3) / 1e12
        rec.roofline_frac = rec.tflops / peak_tflops(rec.dtype)
    except torch.cuda.OutOfMemoryError as e:
        rec.status = "oom"
        rec.error = f"{type(e).__name__}: {e}"[:200]
    except Exception as e:  # a failed cell is recorded, the sweep goes on
        rec.status = "failed"
        rec.error = f"{type(e).__name__}: {e}"[:200]
    return rec


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seqlens", type=int, nargs="+",
                    default=[512, 1024, 2048, 4096, 8192, 16384])
    ap.add_argument("--dims", type=int, nargs="+", default=[64, 128, 256])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--algos", nargs="+", default=["fa2"],
                    choices=["fa1", "fa2", "fa3"])
    ap.add_argument("--backends", nargs="+", default=["kernel"],
                    choices=["kernel", "tiled", "reference"])
    ap.add_argument("--directions", nargs="+", default=["forward"],
                    choices=["forward", "backward"])
    ap.add_argument("--dtypes", nargs="+", default=["bf16"],
                    choices=["bf16", "fp32"])
    ap.add_argument("--causal", choices=["true", "false", "both"],
                    default="both")
    ap.add_argument("--fp8", action="store_true",
                    help="fa3 runs its 8-bit path")
    ap.add_argument("--fp8-fmt", default="fp8", choices=["fp8", "e5m2", "int8"],
                    help="payload format of the 8-bit path (fp8 = e4m3)")
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="attention dropout rate")
    ap.add_argument("--kv-heads", type=int, default=None,
                    help="GQA: number of KV heads (< --heads)")
    ap.add_argument("--out", default="sweep_results")
    ap.add_argument("--tag", default="sweep")
    ap.add_argument("--cell-timeout", type=float, default=600.0,
                    help="per-config subprocess timeout (s)")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--plot", action="store_true")
    # internal: run one config in-process
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--algo", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--backend", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--direction", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dtype", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--seqlen", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dim", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--causal-one", action="store_true", help=argparse.SUPPRESS)
    return ap


def main(argv=None):
    ns = _parser().parse_args(argv)

    if ns.one:
        ns.causal = ns.causal_one
        rec = run_config(ns)
        print("RECORD " + json.dumps(rec.row()), flush=True)
        return

    if not torch.cuda.is_available():
        raise SystemExit("the sweep times on the card; there is none")
    if ns.quick:
        ns.seqlens = [1024, 4096]
        ns.dims = [128]

    causals = {"true": [True], "false": [False], "both": [False, True]}[ns.causal]
    records = []
    for algo in ns.algos:
        for backend in ns.backends:
            for direction in ns.directions:
                for dtype in ns.dtypes:
                    for n in ns.seqlens:
                        for d in ns.dims:
                            for causal in causals:
                                records.append(_subprocess_cell(
                                    ns, algo, backend, direction, dtype, n, d,
                                    causal))
                                print(console_table(records[-1:]).splitlines()[-1],
                                      flush=True)

    print()
    print(console_table(records))
    jpath, cpath = write_results(records, ns.out, ns.tag)
    print(f"\nwrote {jpath} and {cpath}")
    if ns.plot:
        from flashattention_tpu_torch.bench.plotting import (
            plot_mixed_figure,
            plot_sweep,
            render_ablation_table,
        )

        card = torch.cuda.get_device_name(0)
        print(f"wrote {plot_sweep(records, ns.out, ns.tag, card)}")
        print(f"wrote {plot_mixed_figure(records, ns.out, ns.tag, card)}")
        for ext, p in render_ablation_table(records, ns.out, ns.tag).items():
            print(f"wrote {p} ({ext})")


def _subprocess_cell(ns, algo, backend, direction, dtype, n, d, causal):
    """One config in a fresh ``python -m ...sweep --one`` process."""
    cmd = [
        sys.executable, "-m", "flashattention_tpu_torch.bench.sweep", "--one",
        "--algo", algo, "--backend", backend, "--direction", direction,
        "--dtype", dtype, "--seqlen", str(n), "--dim", str(d),
        "--batch", str(ns.batch), "--heads", str(ns.heads),
        "--fp8-fmt", ns.fp8_fmt,
    ]
    if causal:
        cmd.append("--causal-one")
    if ns.fp8:
        cmd.append("--fp8")
    if ns.dropout:
        cmd += ["--dropout", str(ns.dropout)]
    if ns.kv_heads:
        cmd += ["--kv-heads", str(ns.kv_heads)]
    failed = dict(algo=algo, backend=backend, direction=direction,
                  batch=ns.batch, heads=ns.heads, seqlen=n, head_dim=d,
                  causal=causal, dtype=dtype, status="failed")
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=ns.cell_timeout)
    except subprocess.TimeoutExpired:
        return BenchRecord(**failed, error="cell timeout")
    line = [l for l in r.stdout.splitlines() if l.startswith("RECORD ")]
    if line:
        return BenchRecord(**json.loads(line[0][7:]))
    err = (r.stderr.strip().splitlines() or ["?"])[-1]
    return BenchRecord(**failed, error=err[:200])


if __name__ == "__main__":
    main()
