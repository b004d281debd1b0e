// Shared by flash_fwd.cu and flash_bwd.cu: the argument block, the score
// pipeline (ALiBi, soft-cap, mask), the dropout hash and the numeric helpers.
//
// Layout: q (B, H, Nq, D), k/v (B, H_kv, Nk, D), contiguous; query head h
// reads KV head h / (H / H_kv). Query row r sits at key position
// r + offset. Scores go through one pipeline, in this order (as in
// flashattention_tpu/ops/pallas_attn.py:483-501): the scaled fp32 dot; plus
// ALiBi -slope_h * |col - (r + offset)|; the soft-cap c * tanh(s / c); the
// mask (causal, window band + sinks, equal segment ids, col < Nk), where a
// masked score takes the finite mask value and its p is zeroed.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fat {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
// -0.7 * float32 max: the finite mask value of the JAX package.
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* q_ids;   // (B, Nq) or null
  const int32_t* kv_ids;  // (B, Nk) or null
  const float* slopes;    // (H,) or null
  int B, H, H_kv, Nq, Nk, D;
  float scale;
  int causal, offset, window, sinks;  // window <= 0: none
  float softcap, softcap_inv;         // softcap <= 0: none
  int dropout;
  uint32_t drop_threshold, seed;
  float drop_inv;
};

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16(x);
  }
};

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Does row `row` (< Nq) of batch b see column `col`?
__device__ __forceinline__ bool visible(const AttnArgs& a, int b, int row,
                                        int col) {
  if (col >= a.Nk) return false;
  if (a.causal) {
    const int pos = row + a.offset;
    if (col > pos) return false;
    if (a.window > 0 && col <= pos - a.window &&
        !(a.sinks > 0 && col < a.sinks)) {
      return false;
    }
  }
  if (a.q_ids != nullptr &&
      a.q_ids[(size_t)b * a.Nq + row] != a.kv_ids[(size_t)b * a.Nk + col]) {
    return false;
  }
  return true;
}

// Steps 2-3 of the pipeline on a scaled score; *dcap gets d(capped)/d(raw).
__device__ __forceinline__ float post_score(const AttnArgs& a, int h, int row,
                                            int col, float s, float* dcap) {
  if (a.slopes != nullptr) {
    const float dist = (float)abs(col - (row + a.offset));
    s += -a.slopes[h] * dist;
  }
  *dcap = 1.f;
  if (a.softcap > 0.f) {
    const float t = tanhf(s * a.softcap_inv);
    s = a.softcap * t;
    *dcap = 1.f - t * t;
  }
  return s;
}

// Dropout keep bit at absolute (row, col) of batch-head bh = b * H + h: the
// murmur3 finalizer over a counter (pallas_attn.py:357-383), so every tile
// size, the backward and the plain version draw the same mask.
__device__ __forceinline__ bool keep(const AttnArgs& a, uint32_t bh, int row,
                                     int col) {
  uint32_t x = (uint32_t)row * 0x9E3779B1u + (uint32_t)col * 0x85EBCA77u +
               a.seed + bh * 2654435761u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= a.drop_threshold;
}

// Key tiles of width `tile` that rows [r_lo, r_hi] can see, as a walk:
// first the sink tiles, then the band [band_begin, end). Tiles wholly above
// the causal diagonal or below the window band are never visited.
struct TileWalk {
  int n_sink, band_begin, n_walk;
  __device__ __forceinline__ int tile(int w) const {
    return w < n_sink ? w : band_begin + (w - n_sink);
  }
};

__device__ __forceinline__ TileWalk key_tiles(const AttnArgs& a, int r_lo,
                                              int r_hi, int tile) {
  const int n_tiles = (a.Nk + tile - 1) / tile;
  int end = n_tiles, begin = 0, n_sink = 0;
  if (a.causal) {
    const int last = r_hi + a.offset;
    end = last < 0 ? 0 : min(n_tiles, last / tile + 1);
    if (a.window > 0) {
      const int lo = r_lo + a.offset - a.window + 1;
      begin = lo > 0 ? lo / tile : 0;
      if (a.sinks > 0) n_sink = min((a.sinks + tile - 1) / tile, end);
    }
  }
  TileWalk w;
  w.n_sink = n_sink;
  w.band_begin = max(begin, n_sink);
  w.n_walk = n_sink + max(0, end - w.band_begin);
  return w;
}

// Opt a kernel into `bytes` of dynamic shared memory (above 48 KB needs it).
template <typename Kernel>
inline cudaError_t set_smem(Kernel* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace fat
