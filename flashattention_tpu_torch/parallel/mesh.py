"""Device-mesh construction over ``torch.distributed``.

The counterpart of ``flashattention_tpu/parallel/mesh.py``. The process
group is the caller's: ``torch.distributed.init_process_group`` with an
address, a world size and a rank (nothing on the machine announces a
cluster). Each rank drives one device: the CUDA card of its local rank
under NCCL, the CPU under gloo.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

MESH_DIMS = ("data", "pipe", "model", "context")


def make_mesh(data: int = 1, model: int = 1, context: int = 1,
              pipe: int = 1) -> DeviceMesh:
    """A (data, pipe, model, context) ``DeviceMesh`` over ranks 0..n-1 of
    the default process group, n = data * pipe * model * context.

    ``data``: batch / DP (outermost); ``pipe``: pipeline stages
    (point-to-point activations); ``model``: TP heads, MLP columns, vocab
    shards and experts; ``context``: the sequence, for ring attention. Axes
    of size 1 are kept. Ranks past n are not in the mesh. Every rank of the
    default group calls this (it builds one sub-group per axis slice)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised "
                           "(init_process_group)")
    n = data * model * context * pipe
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"need {n} devices for mesh ({data}, {pipe}, {model}, "
                         f"{context}), have {world}")
    kind = "cpu" if dist.get_backend() == "gloo" else "cuda"
    ranks = torch.arange(n).reshape(data, pipe, model, context)
    return DeviceMesh(kind, ranks, mesh_dim_names=MESH_DIMS)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The size of ``mesh``'s axis ``name``."""
    return mesh.shape[MESH_DIMS.index(name)]
