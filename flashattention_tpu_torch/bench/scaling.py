"""Training tokens/s at data-parallel sizes 1..N, and the efficiency
against linear scaling.

The counterpart of ``flashattention_tpu/bench/scaling.py``: the sharded
training step (``parallel.make_sharded_train_step``) at a constant batch
per rank (weak scaling), one process per rank. On cards the ranks join an
NCCL group, one card each, and the record's ``efficiency_vs_linear`` is
tokens/s over (size x the first size's tokens/s). ``--gloo N`` runs N CPU
ranks over gloo instead: that checks the sharded program end to end, and
the ratio mostly reflects the host's cores, so it is named
``host_contention_ratio`` and the record's mode ``program-validation``.

    python -m flashattention_tpu_torch.bench.scaling               # cards
    python -m flashattention_tpu_torch.bench.scaling --gloo 4 --sizes 1 2 4
"""

from __future__ import annotations

import argparse
import json
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def bench_config(seq_len: int = 256, **kw):
    """The JAX harness's model: vocab 1024, d_model 256, 4 layers, 8 heads,
    d_ff 1024, dropout 0, bf16 (``kw`` overrides)."""
    from flashattention_tpu_torch.models.transformer import TransformerConfig

    fields = dict(vocab_size=1024, d_model=256, n_layers=4, n_heads=8,
                  d_ff=1024, max_seq_len=seq_len, block_size=128,
                  dropout_rate=0.0, dtype=torch.bfloat16)
    fields.update(kw)
    return TransformerConfig(**fields)


def measure_train_tokens_per_s(mesh, *, cfg=None, batch_per_device=4,
                               seq_len=256, steps=8, device=None) -> float:
    """Tokens/s of ``steps`` sharded micro-steps (after one untimed) over
    ``mesh``'s data axis, on this rank's ``device`` (None: the card). Every
    rank of the mesh calls this; each returns the same number."""
    from flashattention_tpu_torch.models.train import TrainConfig
    from flashattention_tpu_torch.models.transformer import init_params
    from flashattention_tpu_torch.parallel import (
        make_sharded_train_state,
        make_sharded_train_step,
    )
    from flashattention_tpu_torch.parallel.mesh import axis_size
    from flashattention_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    cfg = cfg or bench_config(seq_len)
    n_data = axis_size(mesh, "data")
    tc = TrainConfig(grad_accum=1, warmup_steps=2, total_steps=steps + 4,
                     batch_size=batch_per_device * n_data, seq_len=seq_len)
    params = init_params(cfg, seed=0, device=device)
    local, opt, _ = make_sharded_train_state(mesh, params, tc)
    del params
    step = make_sharded_train_step(mesh, cfg)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(tc.batch_size, seq_len + 1)))
    batch = {"tokens": tokens.to(device)}
    float(step(local, opt, batch))  # warm-up: builds the kernels
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step(local, opt, batch)
    lv = float(loss)  # reading the loss back waits for the card
    dist.barrier()
    dt = time.perf_counter() - t0
    if not np.isfinite(lv):
        raise RuntimeError(f"loss {lv} is not finite")
    return tc.batch_size * seq_len * steps / dt


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank, world, port, backend, kw, results):
    from flashattention_tpu_torch.parallel import make_mesh

    if backend == "nccl":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        device = torch.device("cpu")
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        tps = measure_train_tokens_per_s(make_mesh(data=world),
                                         device=device, **kw)
        results.put((rank, tps, None))
    except Exception:  # reported by the parent, which raises it
        results.put((rank, None, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def tokens_per_s_at(n: int, backend: str, timeout: float = 900.0,
                    **kw) -> float:
    """Rank 0's tokens/s of a world of ``n`` fresh processes over
    ``backend`` ("nccl": one card each; "gloo": CPU ranks)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, n, port, backend, kw, results))
             for r in range(n)]
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < n:
            rank, tps, err = results.get(timeout=timeout)
            if err is not None:
                raise RuntimeError(f"rank {rank}:\n{err}")
            got[rank] = tps
    finally:
        for p in procs:
            p.join(timeout=30 if len(got) == n else 1)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return got[0]


def scaling_records(sizes, backend: str, **kw) -> list[dict]:
    """One record per data-parallel size, efficiency against the first."""
    records, base = [], None
    for n in sizes:
        tps = tokens_per_s_at(n, backend, **kw)
        base = base or tps
        eff = tps / (base * n)
        rec = {"metric": "train_tokens_per_s_scaling", "devices": n,
               "value": tps, "unit": "tokens/s"}
        if backend == "gloo":
            rec["mode"] = "program-validation (gloo CPU ranks)"
            rec["host_contention_ratio"] = eff
        else:
            rec["mode"] = "hardware"
            rec["efficiency_vs_linear"] = eff
        records.append(rec)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gloo", type=int, default=0,
                    help="N CPU ranks over gloo (validation mode)")
    ap.add_argument("--sizes", type=int, nargs="+", default=None)
    ap.add_argument("--batch-per-device", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=256)
    ns = ap.parse_args(argv)

    if ns.gloo:
        backend, most = "gloo", ns.gloo
    else:
        backend, most = "nccl", torch.cuda.device_count()
        if most == 0:
            raise SystemExit("no CUDA device: pass --gloo N for CPU ranks")
    sizes = ns.sizes or sorted({1, 2, most} & {s for s in (1, 2, 4, 8, 16, 32)
                                                if s <= most})
    if max(sizes) > most:
        raise SystemExit(f"sizes {sizes} exceed the {most} ranks available")
    for rec in scaling_records(sizes, backend,
                               batch_per_device=ns.batch_per_device,
                               seq_len=ns.seq_len):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
