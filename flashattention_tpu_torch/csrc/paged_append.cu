// Append of new K/V tokens into the paged KV cache on Hopper (sm_90a), at a
// decode step (T = 1) and at a prefill chunk (T > 1), in one launch.
//
// Replaces: flashattention_tpu/ops/pallas_append.py, function _kernel
// (launched by pallas_append_decode), together with the index arithmetic
// and the prefill scatter around it in flashattention_tpu/serving/paged_kv.py
// (append_to_pages), which the JAX package jits into one program. The TPU
// kernel gets each sequence's physical page, slot and keep flag by scalar
// prefetch; this kernel computes them itself from the page table and the
// lengths.
//
// Contract (fat_paged_append_tokens). k_pages, v_pages (H_kv, P, page, D)
// hold bf16, fp32, int8, e4m3 or e5m2 values; 1-byte pages carry fp32
// scales k_scales, v_scales (H_kv, P, page) beside them. The new tokens
// k_new, v_new (B, H_kv, T, D) are bf16 or fp32, given as a pointer and
// element strides for B, H_kv and T (D has stride 1), so the head views of
// a fused QKV projection go in without a copy. page_indices (B, pps) int32
// with row stride pi_stride, lengths (B,) int32 (before the append) and
// valid_len (B,) int32 or null. Token (b, t) goes to position
// pos = lengths[b] + t: physical page page_indices[b, pos / page], slot
// pos % page. It writes nothing, payload or scale, where pos < 0, where
// pos >= pps * page, where t >= valid_len[b], or where the physical page is
// outside [0, P). The kernel never reads the cache. Several rows may name
// one (page, slot), as the serving engine's idle decode slots all name slot
// 0 of its dump page: which row lands there is unspecified.
//
// Conversions, with the bits of the PyTorch ops of the plain version: bf16
// into fp32 pages is exact, fp32 into bf16 pages rounds to nearest even
// (__float2bfloat16_rn, as .to() does), like types are copied as raw bits.
// 1-byte pages quantize each (b, t, K|V, head) row over D, as
// ops/quant.quantize_tokens does: scale = max(absmax * (1 / qmax), 1e-6)
// with the fp32 reciprocal passed in, payload = x / scale (an IEEE
// division), rounded half to even with __float2int_rn for int8 and
// converted round-to-nearest-even with __NV_SATFINITE for fp8, which gives
// the unclamped cast's bytes because |x / scale| rounds to at most qmax.
//
// What bounds it on this card: latency, not bytes. A decode step of the
// serving engine (B = 32, H_kv = 12, D = 64, bf16) moves about 100 KB, some
// 30 ns of HBM time, against a few microseconds for the launch and two
// dependent reads from device memory (lengths, then the page-table entry)
// before the first store.
//
// What the design does about it. One lane group per (b, t, K|V, head)
// row: G lanes (G = D / 8 rounded up to a power of two, at most 32) hold
// the row, 8 elements a lane, with 16-byte loads and stores, neighbouring
// lanes on neighbouring addresses; rows are ordered (b, t, K|V,
// head), so a block reads one contiguous run of a fused projection. The grid
// has one lane group per row (768 rows at the engine's decode step, 1536 at
// a 64-token chunk). Each lane issues its token load and the loads of
// lengths[b] and valid_len[b] before the page-table load that needs the
// length, so the store waits on two round trips to device memory, the
// second for one 4-byte entry. On an NVIDIA H100 (700 W) a call takes
// 1.3-1.4x the time of the card's smallest launch, a one-element zero_
// (PERF.md). For
// 1-byte pages the absmax is a shuffle inside the lane group and one lane
// writes the scale. Where D is not a multiple of 8, or a tensor or stride
// is not 16-byte aligned, the same kernel is instantiated with chunks of
// one element (W = 1); the host picks the instantiation. A row wider than 32
// chunks goes through its warp chunk by chunk (chunk c of the row at lane
// c % 32), so the kernel takes any D: each lane loads its first chunk
// before the lengths, as above, and any further chunk after the page-table
// entry; 1-byte pages take the row's absmax over every chunk first, then
// load each further chunk again (from L1) to quantize it, so the scale is
// the whole row's. Up to D = 256 at W = 8 a lane has one chunk, so the
// whole row is in flight before the lengths arrive.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kThreads = 128;

// Page formats (page_fmt) and token types (src_dtype) of the C interface.
enum PageFmt { kBf16 = 0, kF32 = 1, kInt8 = 2, kE4m3 = 3, kE5m2 = 4 };

template <int FMT>
struct PageType {
  using type = uint8_t;
};
template <>
struct PageType<kBf16> {
  using type = __nv_bfloat16;
};
template <>
struct PageType<kF32> {
  using type = float;
};

struct AppendArgs {
  void* k_pages;
  void* v_pages;
  float* k_scales;  // 1-byte pages, else null
  float* v_scales;
  const void* k_new;
  const void* v_new;
  long long k_sb, k_sh, k_st;  // element strides of B, H_kv, T
  long long v_sb, v_sh, v_st;
  const int32_t* page_indices;
  long long pi_stride;
  const int32_t* lengths;
  const int32_t* valid_len;  // null: every token of the T is valid
  int B, T, H, num_pages, page_size, pps, D;
  int lanes_log2;       // lanes a row, log2
  int chunks_per_lane;
  float inv_qmax;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename Dt, typename S>
__device__ __forceinline__ Dt convert(S x) {
  if constexpr (std::is_same_v<Dt, S>) {
    return x;
  } else if constexpr (std::is_same_v<Dt, float>) {
    return __bfloat162float(x);
  } else {
    return __float2bfloat16_rn(x);
  }
}

template <int FMT>
__device__ __forceinline__ uint8_t encode(float y) {
  if constexpr (FMT == kInt8) {
    return (uint8_t)(int8_t)__float2int_rn(y);
  } else {
    return (uint8_t)__nv_cvt_float_to_fp8(
        y, __NV_SATFINITE, FMT == kE4m3 ? __NV_E4M3 : __NV_E5M2);
  }
}

// W elements at p: 16-byte accesses where W elements fill whole 16 bytes
// (W = 8: bf16 and fp32 tokens, bf16 and fp32 pages), one 8-byte access for
// 8 one-byte payloads, element by element at W = 1.
template <typename T, int W>
__device__ __forceinline__ void load_chunk(const T* __restrict__ p,
                                           T (&x)[W]) {
  constexpr int kBytes = W * (int)sizeof(T);
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      reinterpret_cast<uint4*>(x)[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) x[i] = p[i];
  }
}

template <typename T, int W>
__device__ __forceinline__ void store_chunk(T* __restrict__ p,
                                            const T (&y)[W]) {
  constexpr int kBytes = W * (int)sizeof(T);
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      reinterpret_cast<uint4*>(p)[i] = reinterpret_cast<const uint4*>(y)[i];
    }
  } else if constexpr (kBytes == 8) {
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(y);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) p[i] = y[i];
  }
}

template <typename S, int W>
__device__ __forceinline__ float absmax(const S (&x)[W]) {
  float m = 0.f;
#pragma unroll
  for (int e = 0; e < W; ++e) m = fmaxf(m, fabsf(to_float(x[e])));
  return m;
}

// Chunk i of a lane is chunk lane + i * G of its row.
template <typename S, int FMT, int W>
__global__ void __launch_bounds__(kThreads)
paged_append_tokens_kernel(const AppendArgs a) {
  using Dt = typename PageType<FMT>::type;
  const int G = 1 << a.lanes_log2;
  const int lane = threadIdx.x & (G - 1);
  const int rows = a.B * a.T * 2 * a.H;
  const int row = blockIdx.x * (kThreads >> a.lanes_log2) +
                  (threadIdx.x >> a.lanes_log2);
  const bool live = row < rows;
  // row = ((b * T + t) * 2 + kv) * H + h
  int h = 0, kv = 0, t = 0, b = 0;
  if (live) {
    int r = row;
    h = r % a.H;
    r /= a.H;
    kv = r & 1;
    r >>= 1;
    t = r % a.T;
    b = r / a.T;
  }

  // Independent loads first: the lane's first chunk, lengths[b] and
  // valid_len[b].
  const S* src = static_cast<const S*>(kv ? a.v_new : a.k_new) +
                 b * (kv ? a.v_sb : a.k_sb) + h * (kv ? a.v_sh : a.k_sh) +
                 t * (kv ? a.v_st : a.k_st);
  const bool has0 = live && lane * W < a.D;
  alignas(16) S x[W];
  if (has0) load_chunk<S, W>(src + lane * W, x);
  const int len = live ? __ldg(a.lengths + b) : 0;
  const int vlen = (live && a.valid_len != nullptr) ? __ldg(a.valid_len + b)
                                                    : a.T;

  // Then the page-table entry, which needs the length.
  const long long pos = (long long)len + t;
  bool keep = live && t < vlen && pos >= 0 &&
              pos < (long long)a.pps * a.page_size;
  int p = -1;
  if (keep) {
    p = __ldg(a.page_indices + b * a.pi_stride + (int)(pos / a.page_size));
  }
  keep = keep && p >= 0 && p < a.num_pages;
  const int s = keep ? (int)(pos % a.page_size) : 0;
  const size_t at = ((size_t)h * a.num_pages + (keep ? p : 0)) * a.page_size + s;
  Dt* dst = static_cast<Dt*>(kv ? a.v_pages : a.k_pages) + at * a.D;

  if constexpr (FMT == kBf16 || FMT == kF32) {
    auto put = [&](const S (&y)[W], int c) {
      alignas(16) Dt z[W];
#pragma unroll
      for (int e = 0; e < W; ++e) z[e] = convert<Dt>(y[e]);
      store_chunk<Dt, W>(dst + c * W, z);
    };
    if (keep && has0) {
      put(x, lane);
      for (int i = 1; i < a.chunks_per_lane; ++i) {
        const int c = lane + i * G;
        if (c * W >= a.D) break;
        alignas(16) S y[W];
        load_chunk<S, W>(src + c * W, y);
        put(y, c);
      }
    }
  } else {
    // Every lane of the warp reaches the shuffles: rows past the end and
    // dropped rows take part with what they hold and store nothing.
    float amax = has0 ? absmax<S, W>(x) : 0.f;
    for (int i = 1; has0 && i < a.chunks_per_lane; ++i) {
      const int c = lane + i * G;
      if (c * W >= a.D) break;
      alignas(16) S y[W];
      load_chunk<S, W>(src + c * W, y);
      amax = fmaxf(amax, absmax<S, W>(y));
    }
    for (int o = G >> 1; o > 0; o >>= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    }
    const float scale = fmaxf(amax * a.inv_qmax, 1e-6f);
    auto put = [&](const S (&y)[W], int c) {
      alignas(16) uint8_t z[W];
#pragma unroll
      for (int e = 0; e < W; ++e) {
        z[e] = encode<FMT>(__fdiv_rn(to_float(y[e]), scale));
      }
      store_chunk<uint8_t, W>(dst + c * W, z);
    };
    if (keep) {
      if (has0) put(x, lane);
      for (int i = 1; has0 && i < a.chunks_per_lane; ++i) {
        const int c = lane + i * G;
        if (c * W >= a.D) break;
        alignas(16) S y[W];
        load_chunk<S, W>(src + c * W, y);
        put(y, c);
      }
      if (lane == 0) (kv ? a.v_scales : a.k_scales)[at] = scale;
    }
  }
}

template <typename S, int FMT>
void launch(const AppendArgs& a, bool vec, int rows, cudaStream_t st) {
  const int per_block = kThreads >> a.lanes_log2;
  const int grid = (rows + per_block - 1) / per_block;
  if (vec) {
    paged_append_tokens_kernel<S, FMT, 8><<<grid, kThreads, 0, st>>>(a);
  } else {
    paged_append_tokens_kernel<S, FMT, 1><<<grid, kThreads, 0, st>>>(a);
  }
}

template <typename S>
int launch_src(int page_fmt, const AppendArgs& a, bool vec, int rows,
               cudaStream_t st) {
  switch (page_fmt) {
    case kBf16: launch<S, kBf16>(a, vec, rows, st); break;
    case kF32: launch<S, kF32>(a, vec, rows, st); break;
    case kInt8: launch<S, kInt8>(a, vec, rows, st); break;
    case kE4m3: launch<S, kE4m3>(a, vec, rows, st); break;
    case kE5m2: launch<S, kE5m2>(a, vec, rows, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

// page_fmt: 0 = bfloat16, 1 = float32, 2 = int8, 3 = e4m3, 4 = e5m2 (k and
// v pages); src_dtype: 0 = bfloat16, 1 = float32 (k_new, v_new). Strides
// count elements (a dimension of size 1 may pass any). inv_qmax: fp32
// 1 / (127, 448 or 57344) for 1-byte pages, whose k_scales, v_scales are
// (H_kv, P, page) fp32; null for bf16 and fp32 pages. valid_len may be
// null. Returns cudaGetLastError().
int fat_paged_append_tokens(
    void* k_pages, void* v_pages, void* k_scales, void* v_scales,
    const void* k_new, const void* v_new, long long k_sb, long long k_sh,
    long long k_st, long long v_sb, long long v_sh, long long v_st,
    const void* page_indices, long long pi_stride, const void* lengths,
    const void* valid_len, int B, int T, int H, int num_pages, int page_size,
    int pps, int D, int page_fmt, int src_dtype, float inv_qmax,
    void* stream) {
  if (B < 1 || T < 1 || H < 1 || D < 1 || num_pages < 1 ||
      page_size < 1 || pps < 1 || page_fmt < kBf16 || page_fmt > kE5m2 ||
      (long long)B * T * 2 * H > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const bool quant = page_fmt >= kInt8;
  if (quant != (k_scales != nullptr && v_scales != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  // the stride of a dimension of size 1 is never used
  if (B == 1) k_sb = v_sb = 0;
  if (H == 1) k_sh = v_sh = 0;
  if (T == 1) k_st = v_st = 0;
  const int src_bytes = src_dtype == 0 ? 2 : 4;
  const long long strides[6] = {k_sb, k_sh, k_st, v_sb, v_sh, v_st};
  bool vec = D % 8 == 0 && aligned16(k_new) && aligned16(v_new) &&
             aligned16(k_pages) && aligned16(v_pages);
  for (long long s : strides) vec = vec && (s * src_bytes) % 16 == 0;
  const int W = vec ? 8 : 1;
  const int chunks = D / W;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < chunks && lanes_log2 < 5) ++lanes_log2;
  AppendArgs a;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.k_scales = static_cast<float*>(k_scales);
  a.v_scales = static_cast<float*>(v_scales);
  a.k_new = k_new;
  a.v_new = v_new;
  a.k_sb = k_sb;
  a.k_sh = k_sh;
  a.k_st = k_st;
  a.v_sb = v_sb;
  a.v_sh = v_sh;
  a.v_st = v_st;
  a.page_indices = static_cast<const int32_t*>(page_indices);
  a.pi_stride = pi_stride;
  a.lengths = static_cast<const int32_t*>(lengths);
  a.valid_len = static_cast<const int32_t*>(valid_len);
  a.B = B;
  a.T = T;
  a.H = H;
  a.num_pages = num_pages;
  a.page_size = page_size;
  a.pps = pps;
  a.D = D;
  a.lanes_log2 = lanes_log2;
  a.chunks_per_lane = (chunks + (1 << lanes_log2) - 1) >> lanes_log2;
  a.inv_qmax = inv_qmax;
  const int rows = B * T * 2 * H;
  auto st = static_cast<cudaStream_t>(stream);
  int err;
  if (src_dtype == 0) {
    err = launch_src<__nv_bfloat16>(page_fmt, a, vec, rows, st);
  } else if (src_dtype == 1) {
    err = launch_src<float>(page_fmt, a, vec, rows, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

}  // extern "C"
