// In-place decode append into the paged KV cache on Hopper (sm_90a).
//
// Replaces: flashattention_tpu/ops/pallas_append.py, function _kernel
// (launched by pallas_append_decode).
//
// Contract. k_new, v_new (B, H_kv, D) hold one token per sequence; row b is
// written into k_pages, v_pages (H_kv, P, page, D) at physical page phys[b],
// slot slot[b], for every KV head, where ok[b] is nonzero. Rows with ok[b]
// zero (or an index out of range) write nothing. The pages are updated in
// place.
//
// Unlike the TPU kernel, which runs its grid in order and rewrites a whole
// 16-slot sub-block (read-modify-write), blocks here run concurrently: the
// serving engine points every idle decode slot at slot 0 of one shared dump
// page, so several blocks may write that one row at once. Each block
// therefore writes only its own (H_kv, D) row, and never reads a byte of the
// cache back. Which idle row lands on the dump page is unspecified; nothing
// reads it.
//
// Quantized caches (fat_paged_append_quant): the pages hold int8, e4m3 or
// e5m2 payloads with per-slot fp32 scales k_scales, v_scales (H_kv, P, page).
// The kernel takes the tokens in bf16 or fp32 and quantizes each (row, head)
// over D in the same launch, as paged_kv._quantize_tokens does inside the
// JAX package's jitted append: scale = max(absmax * (1 / qmax), 1e-6) (the
// reciprocal passed in as fp32), payload = x / scale (an IEEE division; the
// build has no fast-math), rounded half to even with __float2int_rn for int8
// and converted round-to-nearest-even with __NV_SATFINITE for fp8, which
// gives the unclamped cast's bytes because |x / scale| rounds to at most
// qmax. One warp owns one head's row: the absmax is a warp reduction, lane 0
// writes the scale. Rows with ok[b] zero write neither payload nor scale.
//
// What bounds it on this card: launch latency. It moves 2 * B * H_kv * D
// elements read and written (about 100 KB at B = 32, H_kv = 12, D = 64 in
// bfloat16), some 60 ns of HBM time against a few microseconds of launch.
// The design keeps it to one launch for K and V together, one block per
// sequence, with elements copied as raw bits (2 or 4 bytes) and neighbouring
// threads on neighbouring addresses.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <typename E>
__global__ void __launch_bounds__(kThreads)
paged_append_kernel(E* __restrict__ k_pages, E* __restrict__ v_pages,
                    const E* __restrict__ k_new, const E* __restrict__ v_new,
                    const int32_t* __restrict__ phys,
                    const int32_t* __restrict__ slot,
                    const int32_t* __restrict__ ok, int H, int num_pages,
                    int page_size, int D) {
  const int b = blockIdx.x;
  if (!ok[b]) return;
  const int p = phys[b], s = slot[b];
  if (p < 0 || p >= num_pages || s < 0 || s >= page_size) return;
  const size_t src = (size_t)b * H * D;
  for (int i = threadIdx.x; i < H * D; i += kThreads) {
    const int h = i / D, d = i % D;
    const size_t dst = (((size_t)h * num_pages + p) * page_size + s) * D + d;
    k_pages[dst] = k_new[src + i];
    v_pages[dst] = v_new[src + i];
  }
}

template <typename S>
__device__ __forceinline__ float to_float(S x);

template <>
__device__ __forceinline__ float to_float<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// FMT: 1 = int8, 2 = e4m3, 3 = e5m2.
template <int FMT>
__device__ __forceinline__ uint8_t encode(float y) {
  if (FMT == 1) return (uint8_t)(int8_t)__float2int_rn(y);
  return (uint8_t)__nv_cvt_float_to_fp8(
      y, __NV_SATFINITE, FMT == 2 ? __NV_E4M3 : __NV_E5M2);
}

template <typename S, int FMT>
__global__ void __launch_bounds__(kThreads)
paged_append_quant_kernel(uint8_t* __restrict__ k_pages,
                          uint8_t* __restrict__ v_pages,
                          float* __restrict__ k_scales,
                          float* __restrict__ v_scales,
                          const S* __restrict__ k_new,
                          const S* __restrict__ v_new,
                          const int32_t* __restrict__ phys,
                          const int32_t* __restrict__ slot,
                          const int32_t* __restrict__ ok, int H,
                          int num_pages, int page_size, int D,
                          float inv_qmax) {
  const int b = blockIdx.x;
  if (!ok[b]) return;
  const int p = phys[b], s = slot[b];
  if (p < 0 || p >= num_pages || s < 0 || s >= page_size) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int row = warp; row < 2 * H; row += kThreads / 32) {
    const int h = row % H;
    const bool is_v = row >= H;
    const S* src = (is_v ? v_new : k_new) + ((size_t)b * H + h) * D;
    float amax = 0.f;
    for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(to_float(src[d])));
    for (int o = 16; o > 0; o >>= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    }
    const float scale = fmaxf(amax * inv_qmax, 1e-6f);
    const size_t at = ((size_t)h * num_pages + p) * page_size + s;
    uint8_t* dst = (is_v ? v_pages : k_pages) + at * D;
    for (int d = lane; d < D; d += 32) dst[d] = encode<FMT>(to_float(src[d]) / scale);
    if (lane == 0) (is_v ? v_scales : k_scales)[at] = scale;
  }
}

template <typename S>
int launch_quant(int fmt, void* k_pages, void* v_pages, void* k_scales,
                 void* v_scales, const void* k_new, const void* v_new,
                 const int32_t* ph, const int32_t* sl, const int32_t* okp,
                 int B, int H, int num_pages, int page_size, int D,
                 float inv_qmax, cudaStream_t st) {
#define FAT_Q(F_)                                                             \
  paged_append_quant_kernel<S, F_><<<B, kThreads, 0, st>>>(                    \
      static_cast<uint8_t*>(k_pages), static_cast<uint8_t*>(v_pages),          \
      static_cast<float*>(k_scales), static_cast<float*>(v_scales),            \
      static_cast<const S*>(k_new), static_cast<const S*>(v_new), ph, sl, okp, \
      H, num_pages, page_size, D, inv_qmax)
  if (fmt == 1) {
    FAT_Q(1);
  } else if (fmt == 2) {
    FAT_Q(2);
  } else if (fmt == 3) {
    FAT_Q(3);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef FAT_Q
  return 0;
}

}  // namespace

extern "C" {

// elem_bytes: 2 (bfloat16) or 4 (float32). Returns cudaGetLastError().
int fat_paged_append(void* k_pages, void* v_pages, const void* k_new,
                     const void* v_new, const void* phys, const void* slot,
                     const void* ok, int B, int H, int num_pages,
                     int page_size, int D, int elem_bytes, void* stream) {
  if (B < 1 || H < 1 || D < 1) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* ph = static_cast<const int32_t*>(phys);
  const auto* sl = static_cast<const int32_t*>(slot);
  const auto* okp = static_cast<const int32_t*>(ok);
  if (elem_bytes == 2) {
    paged_append_kernel<uint16_t><<<B, kThreads, 0, st>>>(
        static_cast<uint16_t*>(k_pages), static_cast<uint16_t*>(v_pages),
        static_cast<const uint16_t*>(k_new), static_cast<const uint16_t*>(v_new),
        ph, sl, okp, H, num_pages, page_size, D);
  } else if (elem_bytes == 4) {
    paged_append_kernel<uint32_t><<<B, kThreads, 0, st>>>(
        static_cast<uint32_t*>(k_pages), static_cast<uint32_t*>(v_pages),
        static_cast<const uint32_t*>(k_new), static_cast<const uint32_t*>(v_new),
        ph, sl, okp, H, num_pages, page_size, D);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Quantized pages. fmt: 1 = int8, 2 = e4m3, 3 = e5m2 (k and v pages);
// src_dtype: 0 = bfloat16, 1 = float32 (k_new, v_new); inv_qmax: fp32
// 1 / (127, 448 or 57344). k_scales, v_scales: (H_kv, P, page) fp32.
// Returns cudaGetLastError().
int fat_paged_append_quant(void* k_pages, void* v_pages, void* k_scales,
                           void* v_scales, const void* k_new,
                           const void* v_new, const void* phys,
                           const void* slot, const void* ok, int B, int H,
                           int num_pages, int page_size, int D, int fmt,
                           int src_dtype, float inv_qmax, void* stream) {
  if (B < 1 || H < 1 || D < 1) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* ph = static_cast<const int32_t*>(phys);
  const auto* sl = static_cast<const int32_t*>(slot);
  const auto* okp = static_cast<const int32_t*>(ok);
  int err;
  if (src_dtype == 0) {
    err = launch_quant<__nv_bfloat16>(fmt, k_pages, v_pages, k_scales,
                                      v_scales, k_new, v_new, ph, sl, okp, B,
                                      H, num_pages, page_size, D, inv_qmax,
                                      st);
  } else if (src_dtype == 1) {
    err = launch_quant<float>(fmt, k_pages, v_pages, k_scales, v_scales,
                              k_new, v_new, ph, sl, okp, B, H, num_pages,
                              page_size, D, inv_qmax, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

}  // extern "C"
