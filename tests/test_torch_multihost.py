"""The port's multi-host routing and process workers, on the CPU.

``MultiHostScheduler`` must make the JAX scheduler's routing decisions on
the same request stream. ``ProcessEngine`` workers (one spawned process
each, ``device="cpu"``) driven by the scheduler must give the results of
in-process engines built from the same seeds, plain and speculative. Each
spawn imports torch, so the file starts three workers in all.
"""

import dataclasses

import pytest
import torch

from flashattention_tpu.serving.multihost import (
    MultiHostScheduler as JaxScheduler,
)
from flashattention_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
)
from flashattention_tpu_torch.serving import (
    EngineConfig,
    GenerationRequest,
    MultiHostScheduler,
    ProcessEngine,
    ServingEngine,
)

CFG = TransformerConfig(vocab_size=64, d_model=32, n_layers=1, n_heads=2,
                        d_ff=32, max_seq_len=64, dropout_rate=0.0,
                        block_size=16, dtype=torch.float32, remat=False)
DRAFT = dataclasses.replace(CFG, d_model=16, d_ff=16, n_heads=1)
ECFG = EngineConfig(max_batch_size=2, page_size=8, num_pages=64,
                    max_seq_len=64, prefill_pad=8)


def _requests(n=6):
    return [GenerationRequest(
        request_id=i, prompt=[(7 * i + j) % 64 for j in range(3 + i % 5)],
        max_new_tokens=4 + i % 3) for i in range(n)]


class _FakeEngine:
    """The surface the scheduler touches; ``finish(rid)`` completes one."""

    def __init__(self):
        self.waiting, self.finished, self.stepped = [], {}, 0

    def submit(self, request):
        self.waiting.append(request.request_id)

    def step(self):
        self.stepped += 1

    def _num_active(self):
        return 0

    def finish(self, rid):
        self.waiting.remove(rid)
        self.finished[rid] = [rid]


def test_scheduler_routes_as_jax():
    """Least-loaded routing with the round-robin tie-break, and the load
    released as requests finish between submits: the same engine index for
    every submit and the same loads after every operation."""
    sides = []
    for cls in (JaxScheduler, MultiHostScheduler):
        engines = [_FakeEngine() for _ in range(3)]
        sides.append((cls(engines), engines))
    lens = [5, 5, 5, 2, 9, 1, 1, 30, 4, 4, 4, 4, 7, 3]
    trace = [[], []]
    for i, n in enumerate(lens):
        for (sched, engines), log in zip(sides, trace):
            req = GenerationRequest(i, [1] * n, 3)
            log.append(("submit", sched.submit(req), tuple(sched.loads)))
            if i % 4 == 3:  # the oldest outstanding request finishes
                eng = next(e for e in engines if e.waiting)
                eng.finish(eng.waiting[0])
                sched.step()
                log.append(("step", tuple(sched.loads)))
    assert trace[0] == trace[1]
    assert {t[1] for t in trace[1] if t[0] == "submit"} == {0, 1, 2}
    with pytest.raises(ValueError):
        MultiHostScheduler([])


def _in_process(seeds, ecfg, draft_seeds=None):
    kw = lambda i: ({} if draft_seeds is None else dict(
        draft_params=init_params(DRAFT, draft_seeds[i], device="cpu"),
        draft_cfg=DRAFT))
    return [ServingEngine(init_params(CFG, s, device="cpu"), CFG, ecfg,
                          device="cpu", **kw(i))
            for i, s in enumerate(seeds)]


def test_process_engines_match_in_process():
    """Two workers under the scheduler, stepped in lockstep and then
    drained concurrently (run_async / wait_run), against two in-process
    engines from the same seeds under the same scheduler."""
    engines = _in_process((0, 1), ECFG)
    sched = MultiHostScheduler(engines)
    routes = [sched.submit(r) for r in _requests()]
    expected = sched.run()
    extra = _requests(10)[6:]
    for r in extra:
        engines[r.request_id % 2].submit(r)
    expected_extra = {}
    for e in engines:
        expected_extra.update({k: v for k, v in e.run().items()
                               if k >= 6})

    procs = [ProcessEngine(CFG, ECFG, param_seed=i, device="cpu")
             for i in range(2)]
    try:
        psched = MultiHostScheduler(procs)
        assert [psched.submit(r) for r in _requests()] == routes
        assert psched.run() == expected
        for r in extra:
            procs[r.request_id % 2].submit(r)
        for p in procs:
            p.run_async()
        with pytest.raises(RuntimeError, match="run_async"):
            procs[0].step()
        merged = {}
        for p in procs:
            merged.update({k: v for k, v in p.wait_run().items() if k >= 6})
    finally:
        for p in procs:
            p.close()
    assert merged == expected_extra
    assert set(expected) == set(range(6)) and set(merged) == set(range(6, 10))
    assert not any(p._proc.is_alive() for p in procs)


def test_process_spec_engines_match_in_process():
    """Speculative workers build their own drafts from ``draft_seed``; the
    scheduler's routing and greedy speculative decoding reproduce the
    in-process speculative engines."""
    ecfg = dataclasses.replace(ECFG, spec_gamma=2)
    sched = MultiHostScheduler(_in_process((0, 1), ecfg, (100, 101)))
    for r in _requests():
        sched.submit(r)
    expected = sched.run()
    procs = [ProcessEngine(CFG, ecfg, param_seed=i, device="cpu",
                           draft_cfg=DRAFT, draft_seed=100 + i)
             for i in range(2)]
    try:
        psched = MultiHostScheduler(procs)
        for r in _requests():
            psched.submit(r)
        got = psched.run()
    finally:
        for p in procs:
            p.close()
    assert got == expected


def test_worker_without_a_card_raises():
    """``device=None`` means the card: a worker that cannot build its
    engine answers with the error, raised as a worker error; no CPU
    fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with ProcessEngine(CFG, ECFG, param_seed=0) as p:
        with pytest.raises(RuntimeError, match="worker error: .*CUDA"):
            p.submit(_requests(1)[0])
        with pytest.raises(RuntimeError, match="worker error"):
            p.step()
    assert not p._proc.is_alive()
