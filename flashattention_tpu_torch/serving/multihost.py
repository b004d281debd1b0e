"""Multi-host continuous batching: requests routed across engine replicas.

The counterpart of ``flashattention_tpu/serving/multihost.py`` (plain
Python, copied rather than imported). Model replicas are data parallel:
each host (or card) runs its own ``ServingEngine`` over its own paged cache
and a host-side scheduler routes requests. Admission is the only cross-host
decision, O(requests), not O(tokens).

``MultiHostScheduler`` routes to the least-loaded engine by outstanding
work (prompt + max_new_tokens), falling back to round-robin on ties, which
keeps every engine's batched decode step equally full. Per-engine
backpressure (page-pool exhaustion defers admission, an out-of-pages
sequence is evicted and requeued) is the engines' own. The engines may be
in-process ``ServingEngine``s or ``host_worker.ProcessEngine`` proxies, one
OS process each.
"""

from __future__ import annotations

import dataclasses

from flashattention_tpu_torch.serving.engine import GenerationRequest


@dataclasses.dataclass
class _EngineState:
    engine: object  # ServingEngine or ProcessEngine
    outstanding: int = 0  # queued + in-flight token budget


class MultiHostScheduler:
    """Routes requests across N independent engines (one per host)."""

    def __init__(self, engines: list):
        if not engines:
            raise ValueError("need at least one engine")
        self._states = [_EngineState(e) for e in engines]
        self._rr = 0
        self._cost: dict[int, tuple[int, int]] = {}  # rid -> (engine, cost)

    def submit(self, request: GenerationRequest) -> int:
        """Routes to the least-loaded engine; returns its index."""
        cost = len(request.prompt) + request.max_new_tokens
        best = min(
            range(len(self._states)),
            key=lambda i: (
                self._states[i].outstanding,
                (i - self._rr) % len(self._states),
            ),
        )
        self._rr = (best + 1) % len(self._states)
        self._states[best].outstanding += cost
        self._cost[request.request_id] = (best, cost)
        self._states[best].engine.submit(request)
        return best

    def step(self) -> None:
        """One tick on every engine (engines share no state)."""
        for st in self._states:
            st.engine.step()
        self._settle()

    def _settle(self) -> None:
        """Release the load of finished requests, so routing sees current
        load (also when submit() and step() interleave)."""
        for rid, (idx, cost) in list(self._cost.items()):
            if rid in self._states[idx].engine.finished:
                self._states[idx].outstanding -= cost
                del self._cost[rid]

    def run(self, max_steps: int = 10_000) -> dict[int, list[int]]:
        """Drive all engines to completion; merged {request_id: tokens}."""
        def busy() -> bool:
            return any(
                st.engine.waiting or st.engine._num_active()
                for st in self._states
            )

        steps = 0
        while busy() and steps < max_steps:
            self.step()
            steps += 1
        self._settle()
        results: dict[int, list[int]] = {}
        for st in self._states:
            done = dict(st.engine.finished)
            overlap = set(results) & set(done)
            if overlap:
                raise RuntimeError(
                    f"duplicate request ids across hosts: {overlap}")
            results.update(done)
        return results

    @property
    def loads(self) -> list[int]:
        return [st.outstanding for st in self._states]
