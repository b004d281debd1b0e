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
  in-process engines or ``ProcessEngine`` workers);
- mixture-of-experts blocks (``models.moe``) in training, decode and the
  serving engine, and the parallel layer on ``torch.distributed``
  (``parallel``): the mesh, dp x tp and expert-parallel training with
  ZeRO-1, head-parallel attention, ring, bidirectional-ring and all-gather
  context parallelism over the flash kernels, and GPipe.
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
from flashattention_tpu_torch.parallel import (
    all_gather_attention,
    head_sharded_attention,
    make_mesh,
    make_pipeline_forward,
    make_pipelined_train_state,
    make_pipelined_train_step,
    make_ring_attention,
    make_sharded_train_state,
    make_sharded_train_step,
    param_partition_specs,
    ring_attention,
    ring_attention_bidir,
    stack_pipeline_params,
    unstack_pipeline_params,
)
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
    "all_gather_attention",
    "apply_transformer",
    "fa1_attention",
    "fa2_attention",
    "fa3_attention",
    "flash_attention",
    "fp8_attention",
    "generate",
    "head_sharded_attention",
    "init_params",
    "kernel_attention",
    "make_mesh",
    "make_pipeline_forward",
    "make_pipelined_train_state",
    "make_pipelined_train_step",
    "make_ring_attention",
    "make_sharded_train_state",
    "make_sharded_train_step",
    "paged_append",
    "paged_attention",
    "param_partition_specs",
    "params_from_jax",
    "reference_attention",
    "ring_attention",
    "ring_attention_bidir",
    "sparse_attention",
    "spec_accept_emit",
    "speculative_generate",
    "stack_pipeline_params",
    "tiled_attention",
    "train",
    "unstack_pipeline_params",
]
