// FA3 8-bit attention forward on Hopper (sm_90a): o and the fp32 LSE from
// e4m3, e5m2 or int8 payloads with per-block fp32 scales.
//
// Replaces: flashattention_tpu/ops/pallas_fp8.py, _fp8_fwd_kernel (launched
// by _fp8_fwd). Same contract as flash_fwd.cu (causal with the offset
// Nk - Nq, window + sinks, GQA, segment ids, soft-cap, in-kernel ALiBi,
// murmur3 dropout after the LSE), on quantized inputs:
//
//   q8 (B, H, Nq, D), k8/v8 (B, H_kv, Nk, D) one-byte payloads;
//   sq (B, H, ceil(Nq / bq)), sk/sv (B, H_kv, ceil(Nk / bk)) fp32 scales,
//   one per sequence block of bq (q) or bk (k, v) positions.
//
// Scales are indexed by absolute row and column (row / bq, col / bk), so the
// kernel's own 32-key tiles are free of the quantization blocks, and ragged
// N is handled by bounds checks.
//
// Numerics, in the TPU kernel's order: payloads decode exactly (cuda_fp8.h
// conversions; int8 -> float). The score is the fp32 dot of the decoded q
// and k (for int8 an exact integer dot: |sum| <= 127^2 * 256 < 2^24), times
// (sq[row / bq] * sk[col / bk]) * scale, then ALiBi, the soft-cap and the
// mask. The online softmax keeps m and l in fp32; the LSE comes from these
// quantized scores. p (after dropout) is rounded to bf16 and each key's
// contribution to P.V is multiplied by sv[col / bk]. With pv_s8 (int8
// payloads, int8_pv="s8") p is re-quantized per row and key block instead:
// ps = max(max p, 1e-30) * (1/127), p8 = rint(p / ps), contribution
// p8 * ps * sv * v8. To know a block's max p before its first tile, a
// pre-pass over the block's tiles computes each row's largest visible score
// (which becomes the running max, so p stays in one frame for the whole
// block) and its largest kept score; this costs one more Q.K over the block.
//
// What bounds it on this card: the tensor-core rate. At the (1, 8, 8192, 128)
// causal shape the work is 4 * B * H * N^2 * D / 2 flops (about 0.137 TFLOP):
// Q.K, half of it, on 8-bit operands and P.V on bf16 p (both 8-bit with
// pv_s8), against 24 MB of payloads. This first version does not reach for
// that bound: it is flash_fwd.cu's kernel (flash_fwd.cuh), running fp32 FMAs
// on the CUDA cores on payloads decoded into fp32 shared-memory tiles. fp8
// wgmma with the scales folded into the epilogue is later work.

#include <cuda_fp8.h>

#include "flash_fwd.cuh"

namespace {

using namespace fat;

// One-byte payloads: 0 = e4m3, 1 = e5m2, 2 = int8; p is rounded to bf16.
template <int FMT>
struct QuantIn {
  using Elem = uint8_t;
  static constexpr bool kQuant = true;
  static __device__ __forceinline__ float load(uint8_t x) {
    if constexpr (FMT == 0) {
      __nv_fp8_e4m3 f;
      f.__x = x;
      return static_cast<float>(f);
    } else if constexpr (FMT == 1) {
      __nv_fp8_e5m2 f;
      f.__x = x;
      return static_cast<float>(f);
    } else {
      return (float)(int8_t)x;
    }
  }
  static __device__ __forceinline__ float round_p(float p) {
    return Num<__nv_bfloat16>::round(p);
  }
};

template <typename T>
cudaError_t by_fmt(int fmt, const AttnArgs& a, const Scales& f, void* o,
                   float* lse, cudaStream_t st) {
  if (fmt == 0) return fwd_by_dim<T, QuantIn<0>>(a, f, o, lse, st);
  if (fmt == 1) return fwd_by_dim<T, QuantIn<1>>(a, f, o, lse, st);
  if (fmt == 2) return fwd_by_dim<T, QuantIn<2>>(a, f, o, lse, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// fmt: 0 = e4m3, 1 = e5m2, 2 = int8 (q8, k8, v8 share it); pv_s8 only with
// int8. out_dtype: 0 = bfloat16, 1 = float32. Returns cudaGetLastError()
// after the launch.
int fat_flash_fwd_fp8(const void* q8, const void* k8, const void* v8,
                      const void* sq, const void* sk, const void* sv, void* o,
                      void* lse, const void* q_ids, const void* kv_ids,
                      const void* slopes, int B, int H, int H_kv, int Nq,
                      int Nk, int D, float scale, int causal, int offset,
                      int window, int sinks, float softcap, float softcap_inv,
                      int dropout, uint32_t drop_threshold, uint32_t seed,
                      float drop_inv, int bq, int bk, int fmt, int pv_s8,
                      int out_dtype, void* stream) {
  if (D < 8 || D > 256 || D % 8 != 0 || H_kv < 1 || H % H_kv != 0 || B < 1 ||
      Nq < 1 || Nk < 1 || H > 65535 || B > 65535 || bq < 1 || bk < 1 ||
      (pv_s8 && fmt != 2)) {
    return (int)cudaErrorInvalidValue;
  }
  AttnArgs a{q8, k8, v8, static_cast<const int32_t*>(q_ids),
             static_cast<const int32_t*>(kv_ids),
             static_cast<const float*>(slopes), B, H, H_kv, Nq, Nk, D, scale,
             causal, offset, window, sinks, softcap, softcap_inv, dropout,
             drop_threshold, seed, drop_inv};
  Scales f{static_cast<const float*>(sq), static_cast<const float*>(sk),
           static_cast<const float*>(sv), bq, bk, (Nq + bq - 1) / bq,
           (Nk + bk - 1) / bk, pv_s8};
  auto st = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  cudaError_t err;
  if (out_dtype == 0) {
    err = by_fmt<__nv_bfloat16>(fmt, a, f, o, l, st);
  } else if (out_dtype == 1) {
    err = by_fmt<float>(fmt, a, f, o, l, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"
