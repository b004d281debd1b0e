"""Multi-device parallelism over ``torch.distributed``: the mesh, dp x tp
(and expert-parallel) training with ZeRO-1, head-parallel attention, ring,
bidirectional-ring and all-gather context parallelism, and GPipe.

The counterpart of ``flashattention_tpu/parallel``, with the same names.
The caller initialises the process group (NCCL on the cards, gloo on the
CPU) and every rank calls the same functions on its own shards.
"""

from flashattention_tpu_torch.parallel.mesh import make_mesh
from flashattention_tpu_torch.parallel.pipeline import (
    make_pipeline_forward,
    make_pipelined_train_state,
    make_pipelined_train_step,
    stack_pipeline_params,
    unstack_pipeline_params,
)
from flashattention_tpu_torch.parallel.ring import (
    all_gather_attention,
    make_ring_attention,
    ring_attention,
    ring_attention_bidir,
)
from flashattention_tpu_torch.parallel.sharded import (
    head_sharded_attention,
    make_sharded_train_state,
    make_sharded_train_step,
    param_partition_specs,
)

__all__ = [
    "make_mesh",
    "ring_attention",
    "ring_attention_bidir",
    "all_gather_attention",
    "make_ring_attention",
    "head_sharded_attention",
    "param_partition_specs",
    "make_sharded_train_state",
    "make_sharded_train_step",
    "stack_pipeline_params",
    "unstack_pipeline_params",
    "make_pipeline_forward",
    "make_pipelined_train_state",
    "make_pipelined_train_step",
]
