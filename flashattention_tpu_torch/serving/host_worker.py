"""Process-separated multi-host serving: one engine per OS process.

The counterpart of ``flashattention_tpu/serving/host_worker.py``.
``serving/multihost.py`` routes requests across engines; here each
``ProcessEngine`` spawns a process (``multiprocessing`` spawn context: a
fresh interpreter, no forked CUDA state) that builds its own weights and
``ServingEngine`` and serves a command loop over a pipe. The proxy offers
the surface the scheduler uses (``submit``, ``step``, ``finished``,
``waiting``, ``_num_active``), so ``MultiHostScheduler`` drives either kind
unchanged, plus ``run_async``/``wait_run`` to drain every host at once.

Weights are made in the worker from (config, seed) by ``init_params``, as
each host of a pod initializes or restores its own replica. The worker runs
on ``device``: None means the CUDA card, as every entry point of the port;
workers on one card share it. A worker that cannot build its engine (no
card, for one) answers every call with the error, which the proxy raises as
``RuntimeError("worker error: ...")``.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
from typing import Any


def _fields(cfg) -> dict:
    """A config dataclass as its fields (values kept, not recursed into)."""
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _build_engine(cfg_fields, ecfg_fields, param_seed, device,
                  draft_cfg_fields, draft_seed):
    from flashattention_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from flashattention_tpu_torch.serving.engine import (
        EngineConfig,
        ServingEngine,
    )
    from flashattention_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    cfg = TransformerConfig(**cfg_fields)
    spec_kw = {}
    if draft_cfg_fields is not None:
        # each worker makes its own draft weights (same seed, same draft)
        draft_cfg = TransformerConfig(**draft_cfg_fields)
        spec_kw = dict(draft_params=init_params(draft_cfg, draft_seed,
                                                device=device),
                       draft_cfg=draft_cfg)
    return ServingEngine(init_params(cfg, param_seed, device=device), cfg,
                         EngineConfig(**ecfg_fields), device=device, **spec_kw)


def _worker_main(conn, cfg_fields, ecfg_fields, param_seed, device,
                 draft_cfg_fields=None, draft_seed=1):
    """Engine host process: build the replica, serve pipe commands."""
    from flashattention_tpu_torch.serving.engine import GenerationRequest

    engine, init_error = None, None
    try:
        engine = _build_engine(cfg_fields, ecfg_fields, param_seed, device,
                               draft_cfg_fields, draft_seed)
    except Exception as e:  # reported on every call, raised by the proxy
        init_error = f"engine init failed: {type(e).__name__}: {e}"

    while True:
        try:
            op, payload = conn.recv()
        except EOFError:
            break
        if op == "shutdown":
            conn.send(("ok", None))
            break
        if init_error is not None:
            conn.send(("err", init_error))
            continue
        try:
            if op == "submit":
                rid, prompt, mnt = payload
                engine.submit(GenerationRequest(rid, list(prompt), mnt))
                conn.send(("ok", None))
            elif op == "step":
                engine.step()
                conn.send(("ok", None))
            elif op == "status":
                conn.send(("ok", (
                    len(engine.waiting),
                    engine._num_active(),
                    {k: list(v) for k, v in engine.finished.items()},
                )))
            elif op == "run":
                conn.send(("ok", engine.run(payload)))
            else:
                conn.send(("err", f"unknown op {op!r}"))
        except Exception as e:  # surface worker faults to the scheduler
            conn.send(("err", f"{type(e).__name__}: {e}"))
    conn.close()


class ProcessEngine:
    """Pipe-RPC proxy exposing the ServingEngine surface the scheduler uses.

    The worker owns the weights and the paged cache; this object owns only
    the pipe and the process. ``device``: None = the CUDA card (shared by
    the workers on one machine), ``"cpu"`` for the plain versions."""

    def __init__(self, cfg, ecfg, *, param_seed: int = 0, device=None,
                 draft_cfg=None, draft_seed: int = 1):
        ctx = mp.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(
            target=_worker_main,
            args=(child, _fields(cfg), _fields(ecfg), param_seed, device,
                  _fields(draft_cfg) if draft_cfg is not None else None,
                  draft_seed),
            daemon=True,
        )
        self._proc.start()
        child.close()
        self._pending = False

    # -- RPC plumbing -------------------------------------------------------

    def _recv(self):
        try:
            status, value = self._conn.recv()
        except EOFError:
            raise RuntimeError("worker error: the worker process exited "
                               f"(exit code {self._proc.exitcode})") from None
        if status != "ok":
            raise RuntimeError(f"worker error: {value}")
        return value

    def _call(self, op: str, payload: Any = None):
        if self._pending:
            raise RuntimeError("run_async in flight; call wait_run first")
        self._conn.send((op, payload))
        return self._recv()

    # -- ServingEngine surface (what MultiHostScheduler touches) ------------

    def submit(self, request) -> None:
        self._call(
            "submit",
            (request.request_id, list(request.prompt), request.max_new_tokens),
        )

    def step(self) -> None:
        self._call("step")

    @property
    def finished(self) -> dict[int, list[int]]:
        return self._call("status")[2]

    @property
    def waiting(self) -> list:
        return [None] * self._call("status")[0]

    def _num_active(self) -> int:
        return self._call("status")[1]

    def run(self, max_steps: int = 10_000) -> dict[int, list[int]]:
        return self._call("run", max_steps)

    # -- parallel drive across hosts ----------------------------------------

    def run_async(self, max_steps: int = 10_000) -> None:
        """Start a full drain in the worker without blocking; all hosts
        decode concurrently (one OS process each)."""
        if self._pending:
            raise RuntimeError("run_async in flight; call wait_run first")
        self._conn.send(("run", max_steps))
        self._pending = True

    def wait_run(self) -> dict[int, list[int]]:
        self._pending = False
        return self._recv()

    def close(self) -> None:
        try:
            if not self._pending:
                self._call("shutdown")
        except (BrokenPipeError, EOFError, OSError, RuntimeError):
            pass
        self._proc.join(timeout=30)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=10)
        self._conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
