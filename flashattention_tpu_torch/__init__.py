"""PyTorch + CUDA port of flashattention_tpu for NVIDIA Hopper (H100).

Beside the JAX package, which stays the reference. This package imports
torch, numpy and the standard library only. Its kernels are hand-written
CUDA C++ under ``csrc/``, built at first use by ``_build``; on CPU tensors
every kernel wrapper runs its plain PyTorch version. Entry points that make
tensors run on the card unless given ``device="cpu"``.

Ported so far:

- the paged serving engine (``serving``) with its two kernels, paged
  attention (``ops.paged_attention``) and the in-place append of decode
  tokens and prefill chunks (``ops.paged_append``);
- training (``models.train``): the dense decoder forward
  (``models.transformer.apply_transformer``) over the flash-attention
  forward and backward kernels (``ops.flash_attn``), the attention API
  (``ops.api``), the tiled executor and the dense oracle;
- the 8-bit path: FA3 8-bit attention (``ops.fp8_attn``, kernel
  ``csrc/flash_fwd_fp8.cu``) behind ``fa3_attention(fp8=True)``, and
  int8/e4m3/e5m2 paged caches (``init_paged_cache(quant=...)``,
  ``EngineConfig(quant=...)``) through the paged kernels;
- block-sparse attention (``ops.sparse_attn.sparse_attention``, kernels
  ``csrc/sparse_fwd.cu`` and ``csrc/sparse_bwd.cu``) and the model's
  ``apply_transformer(sparse_pattern=...)``;
- speculative decoding on the paged engine (``ServingEngine(draft_params=,
  draft_cfg=)`` with ``EngineConfig(spec_gamma=)``, through the paged
  kernels), dense speculative generation (``speculative_generate``,
  ``generate``) and multi-host routing (``MultiHostScheduler`` over
  in-process engines or ``ProcessEngine`` workers).
"""

from flashattention_tpu_torch.models.train import TrainConfig, train
from flashattention_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    apply_transformer,
    init_params,
    params_from_jax,
)
from flashattention_tpu_torch.ops.api import (
    alibi_slopes,
    fa1_attention,
    fa2_attention,
    fa3_attention,
    flash_attention,
)
from flashattention_tpu_torch.ops.flash_attn import kernel_attention
from flashattention_tpu_torch.ops.fp8_attn import fp8_attention
from flashattention_tpu_torch.ops.paged_append import paged_append
from flashattention_tpu_torch.ops.paged_attention import paged_attention
from flashattention_tpu_torch.ops.reference import reference_attention
from flashattention_tpu_torch.ops.sparse_attn import sparse_attention
from flashattention_tpu_torch.ops.tiled import tiled_attention
from flashattention_tpu_torch.serving import (
    EngineConfig,
    GenerationRequest,
    MultiHostScheduler,
    PageAllocator,
    ProcessEngine,
    SamplingConfig,
    ServingEngine,
    SpecStats,
    generate,
    spec_accept_emit,
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
    "TrainConfig",
    "Transformer",
    "TransformerConfig",
    "alibi_slopes",
    "apply_transformer",
    "fa1_attention",
    "fa2_attention",
    "fa3_attention",
    "flash_attention",
    "fp8_attention",
    "generate",
    "init_params",
    "kernel_attention",
    "paged_append",
    "paged_attention",
    "params_from_jax",
    "reference_attention",
    "sparse_attention",
    "spec_accept_emit",
    "speculative_generate",
    "tiled_attention",
    "train",
]
