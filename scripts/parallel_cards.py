"""The parallel layer across the cards of one machine, over NCCL.

    python3 scripts/parallel_cards.py               # one process per card
    python3 scripts/parallel_cards.py --cpu 4       # gloo, 4 CPU processes

One process per card (``tcp://127.0.0.1``, NCCL; gloo with ``--cpu``),
each running every check, which rank 0 holds against one card's result:

1. ring, bidirectional-ring and all-gather attention over all ranks
   (``context`` = world) at (1, 8, 8192, 128) bf16 causal, forward and
   backward with an LSE cotangent; o, LSE and dq, dk, dv gathered to rank
   0 against one flash call over the whole sequence on rank 0's card: the
   flash limit (two bf16 ulps + 1e-3 x max) plus half an ulp of each of
   the up to ``world`` bf16 partials a rank merges or sums
   (``world * 2**-9 * max``); LSE 1e-4. Timed: the step (forward and
   backward, every rank synchronised) on the host clock, median of 10,
   beside the one call on one card.
2. The dp x tp step (``data`` = 2, ``model`` = world / 2, ZeRO-1) and the
   GPipe step (``data`` = 2, ``pipe`` = world / 2, 2 microbatches) at GPT-3
   Small widths in fp32 compute, dropout 0, batch 8 x 512, then the dp x
   tp x EP step of the MoE model (8 experts, top 2): the whole batch's
   loss and every gradient (gathered) against ``train_step`` on rank 0's
   card from the same parameters, 1e-4 relative L2 (fp32 sums in another
   order). Timed: one step a check, median of 3, beside ``train_step``.

Prints one JSON line with the card names and power limits, every error
and time; exits nonzero on a failed check or without enough cards.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import datetime
import json
import os
import socket
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from flashattention_tpu_torch import _build  # noqa: E402
from flashattention_tpu_torch.models import train as ttrain  # noqa: E402
from flashattention_tpu_torch.models.transformer import (  # noqa: E402
    TransformerConfig,
    init_params,
)
from flashattention_tpu_torch.ops import flash_attn as fa  # noqa: E402
from flashattention_tpu_torch.parallel import (  # noqa: E402
    all_gather_attention,
    make_mesh,
    make_pipelined_train_state,
    make_pipelined_train_step,
    make_sharded_train_state,
    make_sharded_train_step,
    ring_attention,
    ring_attention_bidir,
)
from flashattention_tpu_torch.parallel.sharded import (  # noqa: E402
    ShardContext,
    unshard_params,
)

STEP_TOL = 1e-4
KERNELS = ("flash_fwd", "flash_bwd")  # every kernel these checks launch


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, dev, reps):
    """Median host-clock seconds of ``fn`` on every rank, each rank
    synchronised and then all ranks joined by a barrier."""
    times = []
    for _ in range(reps):
        dist.barrier()
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        dist.barrier()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _gather_seq(t, dim):
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts, dim=dim)


def check_context_parallel(dev, shape, rank, world):
    b, h, n, d = shape
    gen = torch.Generator().manual_seed(11)
    q, k, v, do = (torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
                   for _ in range(4))
    dlse = torch.randn((b, h, n), generator=gen).to(dev)
    refs = None
    if rank == 0:
        def one_call():
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            o, lse = fa.kernel_attention(*leaves, causal=True)
            torch.autograd.backward([o, lse], [do, dlse])
            return [o.detach(), lse.detach()] + [t.grad for t in leaves]

        refs = one_call()
        one_ms = 1e3 * _timed_local(one_call, dev)
    mine = [t.chunk(world, 2)[rank].contiguous() for t in (q, k, v, do, dlse)]
    out = {}
    for name, fn in (("ring", ring_attention), ("bidir", ring_attention_bidir),
                     ("all_gather", all_gather_attention)):
        def step():
            leaves = [t.clone().requires_grad_(True) for t in mine[:3]]
            o, lse = fn(*leaves, causal=True)
            torch.autograd.backward([o, lse], [mine[3], mine[4]])
            return [o, lse] + [t.grad for t in leaves]

        got = [_gather_seq(t.detach(), 2) for t in step()]
        rec = {"step_ms": 1e3 * _timed(step, dev, 10)}
        if rank == 0:
            rec["one_card_ms"] = one_ms
            rec["max_abs_err"] = {}
            for part, a, r in zip(("o", "lse", "dq", "dk", "dv"), got, refs):
                r32 = r.float()
                if part == "lse":
                    rtol, atol = 1e-4, 1e-4
                else:
                    big = float(r32.abs().max())
                    rtol, atol = 1.6e-2, 1e-3 * big + world * 2 ** -9 * big
                err = (a.float() - r32).abs()
                rec["max_abs_err"][part] = float(err.max())
                if bool((err > atol + rtol * r32.abs()).any()):
                    rec["failed"] = f"{name} {part}: max |err| {err.max():.3e}"
        out[name] = rec
    return out


def _timed_local(fn, dev, reps=10):
    times = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _grads(module):
    return {n: p.grad.detach().float().clone()
            for n, p in module.named_parameters() if p.grad is not None}


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def check_steps(dev, cfg, tc, rank, world, name, mesh_kw, pipelined):
    """One micro-step (grad_accum 2: the gradients stay) of the sharded or
    pipelined step against ``train_step`` on rank 0; then the median of 3
    timed micro-steps."""
    params = init_params(cfg, seed=5, device=dev)
    batch = next(iter(ttrain.synthetic_batches(tc, cfg.vocab_size, 1,
                                               device=dev)))
    mesh = make_mesh(**mesh_kw)
    if pipelined:
        local, opt, _ = make_pipelined_train_state(mesh, params, tc)
        step = make_pipelined_train_step(mesh, cfg, n_micro=2)
    else:
        local, opt, specs = make_sharded_train_state(mesh, params, tc,
                                                     zero1=True)
        step = make_sharded_train_step(mesh, cfg)
    loss = float(step(local, opt, batch, None))
    if pipelined:  # the stage's blocks to rank 0, under their global names
        grads = _grads(local)
        pipe = mesh_kw["pipe"]
        first = mesh.get_local_rank("pipe") * (cfg.n_layers // pipe)
        named = {}
        for n, g in grads.items():
            if n.startswith("blocks."):
                i, rest = n.split(".", 2)[1:]
                n = f"blocks.{first + int(i)}.{rest}"
            named[n] = g.cpu()
        every = [None] * world
        dist.all_gather_object(every, named)
        grads = {}
        for part in every:
            grads.update(part)
    else:  # the gradients gathered as a parameter set
        shards = copy.deepcopy(local)
        for p, q in zip(shards.parameters(), local.parameters()):
            p.data = q.grad.detach().clone()
        grads = {n: p.detach().float().cpu() for n, p in unshard_params(
            shards, ShardContext(mesh), specs).named_parameters()}
        del shards
    rec = {"loss": loss}
    if rank == 0:
        ref = copy.deepcopy(params)
        ref_opt = ttrain.make_optimizer(ref, tc)
        want_loss = float(ttrain.train_step(ref, ref_opt, batch, None, cfg))
        want = {n: g.cpu() for n, g in _grads(ref).items()}
        rec["loss_ref"] = want_loss
        rec["loss_rel"] = abs(loss - want_loss) / abs(want_loss)
        rec["grad_max_rel_l2"] = max(_rel(grads[n], want[n]) for n in want)
        if rec["loss_rel"] > STEP_TOL or rec["grad_max_rel_l2"] > STEP_TOL:
            rec["failed"] = (f"{name}: loss rel {rec['loss_rel']:.2e}, worst "
                             f"gradient rel L2 {rec['grad_max_rel_l2']:.2e}")
        rec["one_card_ms"] = 1e3 * _timed_local(lambda: float(
            ttrain.train_step(ref, ref_opt, batch, None, cfg)), dev, 3)
        del ref, ref_opt
    for p in local.parameters():
        p.grad = None
    opt.micro = 0
    rec["step_ms"] = 1e3 * _timed(lambda: float(step(local, opt, batch, None)),
                                  dev, 3)
    return rec


def worker(rank, world, port, cpu, results):
    if cpu:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
        backend = "gloo"
    else:
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        backend = "nccl"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        out = {}
        shape = (1, 2, 256, 64) if cpu else (1, 8, 8192, 128)
        out["context_parallel"] = check_context_parallel(dev, shape, rank,
                                                         world)
        if cpu:
            cfg = TransformerConfig(vocab_size=97, d_model=64, n_layers=4,
                                    n_heads=4, d_ff=128, max_seq_len=64,
                                    dropout_rate=0.0, dtype=torch.float32)
            tc = ttrain.TrainConfig(batch_size=4, seq_len=32, grad_accum=2)
        else:
            cfg = TransformerConfig(dropout_rate=0.0, dtype=torch.float32)
            tc = ttrain.TrainConfig(batch_size=8, seq_len=512, grad_accum=2)
        half = world // 2
        for name, kw, pipelined, c in (
            ("dp_tp_zero1", dict(data=2, model=half), False, cfg),
            ("dp_pipe", dict(data=2, pipe=half), True, cfg),
            ("dp_tp_ep_moe", dict(data=2, model=half), False,
             dataclasses.replace(cfg, moe_experts=8)),
        ):
            out[name] = check_steps(dev, c, tc, rank, world, name, kw,
                                    pipelined)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        results.put((rank, out, None))
    except Exception:  # reported by the parent, which fails
        import traceback
        results.put((rank, None, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", type=int, default=0,
                    help="rehearse with this many gloo processes on the CPU")
    args = ap.parse_args()
    if args.cpu:
        world, cards = args.cpu, "cpu"
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
            print("parallel_cards: needs 2 or more CUDA devices",
                  file=sys.stderr)
            return 1
        world = torch.cuda.device_count()
        cards = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
        print(f"[cards] {cards}", flush=True)
        with ThreadPoolExecutor() as pool:  # once, before the ranks load them
            built = dict(zip(KERNELS, pool.map(_build.build_kernel, KERNELS)))
        print(f"[build] {built}", flush=True)
    if world % 2:
        print("parallel_cards: needs an even world", file=sys.stderr)
        return 1
    os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=worker, args=(r, world, port, args.cpu > 0,
                                              results))
             for r in range(world)]
    for p in procs:
        p.start()
    got, error = {}, None
    while len(got) < world and error is None:
        rank, out, err = results.get(timeout=1500)
        if err is not None:
            error = f"rank {rank}:\n{err}"
        got[rank] = out
    for p in procs:
        p.join(timeout=60 if error is None else 5)
        if p.is_alive():
            p.terminate()
    if error is not None:
        print(f"parallel_cards: FAILED: {error}", file=sys.stderr)
        return 1
    rec = dict(world=world, cards=cards, **got[0])
    checks = [*rec["context_parallel"].values(),
              *(rec[k] for k in ("dp_tp_zero1", "dp_pipe", "dp_tp_ep_moe"))]
    failed = [c["failed"] for c in checks if "failed" in c]
    print(json.dumps(rec), flush=True)
    if failed:
        print(f"parallel_cards: FAILED: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
