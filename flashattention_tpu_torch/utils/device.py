"""Where the port's entry points put their tensors."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; a CUDA device without a card raises.

    Every entry point that makes tensors (``init_params``,
    ``params_from_jax``, ``init_paged_cache``, ``ServingEngine``, ``train``)
    runs on the card unless the caller passes ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless it is given "
            "device='cpu'"
        )
    return dev
