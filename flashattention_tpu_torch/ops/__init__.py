"""Attention kernels and their plain PyTorch versions."""

from flashattention_tpu_torch.ops.sparse_attn import sparse_attention

__all__ = ["sparse_attention"]
