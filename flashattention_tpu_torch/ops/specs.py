"""Block sizes that fix numerics: the tiled executor's key tile and the 8-bit
path's quantization blocks.

The counterpart of ``flashattention_tpu/ops/specs.py``. That module's
block table was measured on a TPU (v5e, Pallas block shapes) and chooses
no CUDA tile: the CUDA kernels pick their own (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``, ``csrc/flash_fwd_fp8.cu``). Three of its values
still reach code here because they set numerics, not speed:

- the tiled executor's key tile, 1024 for every sequence length and head
  dim;
- the FA3 8-bit path's quantization blocks. Scales are per sequence block,
  so the block decides every scale. The kernel path
  (``fa3_attention(fp8=True)`` on the kernel backend) quantizes q in blocks
  of min(fa3 forward block_q, 512) = 512 and k/v in blocks of 1024, clamped
  to the sequence by :func:`fp8_kernel_blocks`; the tiled and reference
  paths fake-quantize in the largest divisor of N up to the table's
  forward block_q (1024 for head_dim <= 64, else 512) and block_k (1024).
"""

TILED_BLOCK_K = 1024

FA3_BLOCK_K = 1024              # every row of the TPU table
FP8_KERNEL_BLOCK_Q = 512        # min(fa3 forward block_q, 512)
FP8_KERNEL_BLOCK_K = FA3_BLOCK_K


def fa3_block_q(head_dim: int) -> int:
    """The TPU table's FA3 forward block_q: 1024 for d <= 64, else 512."""
    return 1024 if head_dim <= 64 else 512


def fp8_kernel_blocks(n_q: int, n_k: int, block_q: int = FP8_KERNEL_BLOCK_Q,
                      block_k: int = FP8_KERNEL_BLOCK_K) -> tuple[int, int]:
    """Quantization blocks (bq, bk) of the 8-bit kernel path after clamping
    to the sequence (``pallas_fp8._fp8_blocks``): bq a multiple of 32,
    bk of 128; e.g. n_q = 200 gives bq = 224."""
    bq = min(block_q, max(128, ((n_q + 31) // 32) * 32))
    bk = min(block_k, max(128, ((n_k + 127) // 128) * 128))
    return max(32, (bq // 32) * 32), max(128, (bk // 128) * 128)


def fp8_block(n: int, preferred: int) -> int:
    """Largest block <= ``preferred`` that divides n (``api._fp8_block``):
    the fake-quant path's scales are per block of the unpadded sequence."""
    b = min(preferred, n)
    while n % b:
        b -= 1
    return max(b, 1)
