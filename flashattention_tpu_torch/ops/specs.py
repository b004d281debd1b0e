"""Tile choice of the three algorithm generations (FA1, FA2, FA3).

The counterpart of ``flashattention_tpu/ops/specs.py``. That module's
block table was measured on a TPU (v5e, Pallas block shapes) and chooses
no CUDA tile: the CUDA kernels pick their own (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``). The one value of it that reaches code here is the
tiled executor's key tile, which the TPU table sets to 1024 for every
sequence length and head dim. An H100 measurement would replace it.
"""

TILED_BLOCK_K = 1024
