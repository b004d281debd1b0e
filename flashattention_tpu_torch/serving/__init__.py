"""Paged serving: KV cache, allocator, sampling, the engine (plain and
speculative), dense speculative generation and multi-host routing."""

from flashattention_tpu_torch.serving.allocator import PageAllocator
from flashattention_tpu_torch.serving.engine import (
    EngineConfig,
    GenerationRequest,
    ServingEngine,
)
from flashattention_tpu_torch.serving.host_worker import ProcessEngine
from flashattention_tpu_torch.serving.multihost import MultiHostScheduler
from flashattention_tpu_torch.serving.sampling import (
    SamplingConfig,
    spec_accept_emit,
)
from flashattention_tpu_torch.serving.speculative import (
    SpecStats,
    generate,
    speculative_generate,
)

__all__ = [
    "EngineConfig",
    "GenerationRequest",
    "MultiHostScheduler",
    "PageAllocator",
    "ProcessEngine",
    "SamplingConfig",
    "ServingEngine",
    "SpecStats",
    "generate",
    "spec_accept_emit",
    "speculative_generate",
]
