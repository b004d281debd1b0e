"""Jobs that the port's gloo tests run in worker processes.

``run_world(world, jobs)`` starts ``world`` processes (spawn), joins them in
one gloo process group over a localhost port, runs every job on every rank
and returns each rank's results. This module imports torch, numpy and the
port only, so the workers hold no JAX; each rank reports whether anything
of JAX or the JAX package was imported (``"_jax_modules"``). Inputs and
results are numpy arrays; the parity tests compute the JAX side in the
pytest process.
"""

from __future__ import annotations

import queue as queue_mod
import socket
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_modules() -> list[str]:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "flashattention_tpu"))


def _worker(rank, world, port, jobs, results):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        out = {}
        for name, fn, kwargs in jobs:
            out[name] = globals()[fn](rank=rank, world=world, **kwargs)
        out["_jax_modules"] = _jax_modules()
        results.put((rank, out, None))
    except Exception:  # reported to the test, which fails with it
        results.put((rank, None, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def run_world(world: int, jobs, timeout: float = 600.0) -> list[dict]:
    """Every rank's {job name: result} for ``jobs`` [(name, function name
    in this module, kwargs)]."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, world, port, jobs, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        while len(got) + len(errors) < world:
            rank, out, err = results.get(timeout=timeout)
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
                break  # the other ranks may wait in a collective forever
            got[rank] = out
    except queue_mod.Empty:
        errors.append(f"no result within {timeout} s")
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 1)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [got[r] for r in range(world)]


def _np(t):
    return t.detach().float().numpy()


def _port_cfg(cfg_kw):
    from flashattention_tpu_torch.models.transformer import TransformerConfig
    return TransformerConfig(**cfg_kw)


# ---------------------------------------------------------------------------
# Context parallelism
# ---------------------------------------------------------------------------


def cp_job(rank, world, kind, q, k, v, do, dlse, ids, causal):
    """One context-parallel attention over a mesh of ``world`` context ranks:
    this rank's o, lse, dq, dk, dv."""
    from flashattention_tpu_torch.parallel import (
        all_gather_attention,
        make_mesh,
        ring_attention,
        ring_attention_bidir,
    )

    mesh = make_mesh(context=world)
    r = mesh.get_local_rank("context")
    fn = {"ring": ring_attention, "bidir": ring_attention_bidir,
          "all_gather": all_gather_attention}[kind]
    part = lambda x, dim: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(np.split(x, world, axis=dim)[r]))
    qs, ks, vs = (part(x, 2).requires_grad_() for x in (q, k, v))
    o, lse = fn(qs, ks, vs, group=mesh.get_group("context"), causal=causal,
                segment_ids=None if ids is None else part(ids, 1))
    ((o * part(do, 2)).sum() + (lse * part(dlse, 2)).sum()).backward()
    return dict(o=_np(o), lse=_np(lse), dq=_np(qs.grad), dk=_np(ks.grad),
                dv=_np(vs.grad))


def head_sharded_job(rank, world, q, k, v, data, model):
    """Head-parallel attention on a (data, model) mesh: this rank's block of
    o and lse and where it sits."""
    from flashattention_tpu_torch.parallel import (
        head_sharded_attention,
        make_mesh,
    )

    mesh = make_mesh(data=data, model=model)
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    cut = lambda x: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
        np.split(np.split(x, data, 0)[d], model, 1)[m]))
    o, lse = head_sharded_attention(mesh, causal=True)(cut(q), cut(k), cut(v))
    return dict(o=_np(o), lse=_np(lse), data=d, model=m)


# ---------------------------------------------------------------------------
# Sharded training
# ---------------------------------------------------------------------------


def train_job(rank, world, tree, cfg_kw, tc_kw, batches, data, model, zero1):
    """``len(batches)`` dp x tp steps from the parameters ``tree``: losses,
    the whole parameters after them (gathered), and per AdamW tensor the
    share of its parameter it holds moments for."""
    from flashattention_tpu_torch.models.train import TrainConfig
    from flashattention_tpu_torch.models.transformer import params_from_jax
    from flashattention_tpu_torch.parallel import (
        make_mesh,
        make_sharded_train_state,
        make_sharded_train_step,
    )
    from flashattention_tpu_torch.parallel.sharded import (
        ShardContext,
        unshard_params,
    )

    cfg = _port_cfg(cfg_kw)
    mesh = make_mesh(data=data, model=model)
    params = params_from_jax(tree, cfg, device="cpu")
    local, opt, specs = make_sharded_train_state(
        mesh, params, TrainConfig(**tc_kw), zero1=zero1)
    step = make_sharded_train_step(mesh, cfg)
    losses = [float(step(local, opt, {k: torch.from_numpy(v)
                                      for k, v in b.items()}, None))
              for b in batches]
    full = unshard_params(local, ShardContext(mesh), specs)
    names = [n for n, _ in local.named_parameters()]
    shares = {n: a.numel() / p.numel() for n, (p, a, _) in
              zip(names, opt.slices)}
    return dict(losses=losses, shares=shares,
                params={n: _np(p) for n, p in full.named_parameters()},
                local_shapes={n: tuple(p.shape)
                              for n, p in local.named_parameters()})


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


def pipe_forward_job(rank, world, tree, cfg_kw, tokens, data, pipe, n_micro):
    """The GPipe forward's logits of this rank and the batch rows they
    hold; a batch that n_micro does not divide raises."""
    from flashattention_tpu_torch.models.transformer import params_from_jax
    from flashattention_tpu_torch.parallel import (
        make_mesh,
        make_pipeline_forward,
    )
    from flashattention_tpu_torch.parallel.pipeline import (
        pipeline_rows,
        pipeline_stage,
    )

    cfg = _port_cfg(cfg_kw)
    mesh = make_mesh(data=data, pipe=pipe)
    stage = pipeline_stage(mesh, params_from_jax(tree, cfg, device="cpu"))
    fwd = make_pipeline_forward(mesh, cfg, n_micro)
    logits = fwd(stage, torch.from_numpy(tokens))
    error = None
    try:
        make_pipeline_forward(mesh, cfg, 3)(stage, torch.from_numpy(tokens))
    except ValueError as e:
        error = str(e)
    return dict(logits=_np(logits), error=error,
                rows=pipeline_rows(tokens.shape[0], n_micro, data,
                                   mesh.get_local_rank("data")))


def pipe_train_job(rank, world, tree, cfg_kw, tc_kw, batches, data, pipe,
                   n_micro):
    """Pipelined micro-steps: the loss of each, this stage's gradients after
    the first (grad_accum 2 keeps them: no update yet) named by global
    layer, and the embedding and head after the last."""
    from flashattention_tpu_torch.models.train import TrainConfig
    from flashattention_tpu_torch.models.transformer import params_from_jax
    from flashattention_tpu_torch.parallel import (
        make_mesh,
        make_pipelined_train_state,
        make_pipelined_train_step,
    )

    cfg = _port_cfg(cfg_kw)
    mesh = make_mesh(data=data, pipe=pipe)
    stage, opt, _ = make_pipelined_train_state(
        mesh, params_from_jax(tree, cfg, device="cpu"), TrainConfig(**tc_kw))
    step = make_pipelined_train_step(mesh, cfg, n_micro)
    lps = cfg.n_layers // pipe
    first = mesh.get_local_rank("pipe") * lps
    losses, grads = [], None
    for b in batches:
        losses.append(float(step(stage, opt, {"tokens": torch.from_numpy(b)},
                                 None)))
        if grads is None:
            grads = {}
            for n, p in stage.named_parameters():
                if n.startswith("blocks."):
                    i, rest = n.split(".", 2)[1:]
                    n = f"blocks.{first + int(i)}.{rest}"
                grads[n] = None if p.grad is None else _np(p.grad)
    shared = {n: _np(p) for n, p in stage.named_parameters()
              if not n.startswith("blocks.")}
    return dict(losses=losses, grads=grads, shared=shared)


def pipe_dropout_job(rank, world, tree, cfg_kw, tokens, data, pipe, n_micro):
    """Train-mode pipeline forwards with dropout: twice from one seed, once
    from another; and the dense train-mode forward from the first seed."""
    from flashattention_tpu_torch.models.transformer import (
        apply_transformer,
        params_from_jax,
    )
    from flashattention_tpu_torch.parallel import (
        make_mesh,
        make_pipeline_forward,
    )
    from flashattention_tpu_torch.parallel.pipeline import (
        pipeline_rows,
        pipeline_stage,
    )

    cfg = _port_cfg(cfg_kw)
    mesh = make_mesh(data=data, pipe=pipe)
    params = params_from_jax(tree, cfg, device="cpu")
    stage = pipeline_stage(mesh, params)
    fwd = make_pipeline_forward(mesh, cfg, n_micro, train=True)
    toks = torch.from_numpy(tokens)
    runs = [_np(fwd(stage, toks, seed)) for seed in (7, 7, 8)]
    rows = pipeline_rows(tokens.shape[0], n_micro, data,
                         mesh.get_local_rank("data"))
    with torch.no_grad():
        dense = apply_transformer(params, toks, cfg, train=True,
                                  dropout_seed=7)
    return dict(runs=runs, dense=_np(dense)[rows])
