// Flash-attention forward on Hopper (sm_90a): o and the fp32 LSE.
//
// Replaces: flashattention_tpu/ops/pallas_attn.py, _fwd_kernel (launched by
// _flash_fwd). Same contract: causal with a query offset, window + sinks,
// GQA, segment ids, soft-cap, in-kernel ALiBi and murmur3 dropout applied
// after the LSE (the LSE and the normaliser l use the pre-dropout p). A row
// with no visible key writes o = 0; its LSE is the running max (-inf or the
// mask value) plus log 1.
//
// Numerics follow the TPU kernel's rounding points: the scores are the fp32
// dot of the input values times the scale; p (after dropout scaling) is
// rounded to the input type before P·V; m, l and the output accumulate in
// fp32; o is written in the input type.
//
// What bounds it on this card: at D = 64 a (query row, key) pair costs
// 4·D flops against a few bytes, so the tensor-core rate bounds it
// (4·B·H·Nq·Nk·D flops, half of that causal, over 989 TFLOP/s). This first
// version does not reach for that bound: it runs fp32 FMAs on the CUDA cores.
//
// The kernel body is flash_fwd.cuh's, instantiated for plain inputs.

#include "flash_fwd.cuh"

extern "C" {

// dtype: 0 = bfloat16, 1 = float32 (q, k, v and o share it). Returns
// cudaGetLastError() after the launch.
int fat_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, const void* q_ids, const void* kv_ids,
                  const void* slopes, int B, int H, int H_kv, int Nq, int Nk,
                  int D, float scale, int causal, int offset, int window,
                  int sinks, float softcap, float softcap_inv, int dropout,
                  uint32_t drop_threshold, uint32_t seed, float drop_inv,
                  int dtype, void* stream) {
  using namespace fat;
  if (D < 8 || D > 256 || D % 8 != 0 || H_kv < 1 || H % H_kv != 0 || B < 1 ||
      Nq < 1 || Nk < 1 || H > 65535 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  AttnArgs a{q, k, v, static_cast<const int32_t*>(q_ids),
             static_cast<const int32_t*>(kv_ids),
             static_cast<const float*>(slopes), B, H, H_kv, Nq, Nk, D, scale,
             causal, offset, window, sinks, softcap, softcap_inv, dropout,
             drop_threshold, seed, drop_inv};
  const Scales none{};
  auto st = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  cudaError_t err;
  if (dtype == 0) {
    err = fwd_by_dim<__nv_bfloat16, PlainIn<__nv_bfloat16>>(a, none, o, l, st);
  } else if (dtype == 1) {
    err = fwd_by_dim<float, PlainIn<float>>(a, none, o, l, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"
