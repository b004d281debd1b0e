// The call-level pieces of the fp32 wide backward (3xTF32, 128 < D <= 256),
// shared by flash_bwd.cu and sparse_bwd.cu, whose dK/dV and dQ kernels run
// on the same schedules (DkvWideCfg, DqWideCfg in tf32_sm90.cuh):
//
//   - the wrapper's scratch: the two TF32 parts of q (times q_scale), dO, K
//     and V, the B operands that TMA lands in both parts, made once a call
//     by tf32_split_kernel instead of once a tile in each CTA; then, where
//     a KV head's group of query heads is walked by `splits` dK/dV CTAs,
//     their partial sums;
//   - kv_sum_kernel, which sums those partials in split order, so that two
//     calls give equal bits whatever order the CTAs ran in;
//   - the tensor maps of the two kernels.
//
// Both kernels move bytes: each reads and writes its buffers once.
#pragma once

#include "tf32_sm90.cuh"

namespace fat {

// x times `scale` split into `big` and `small` (n4 float4s).
__global__ void tf32_split_kernel(const float4* __restrict__ x, float scale,
                                  float4* __restrict__ big,
                                  float4* __restrict__ small, size_t n4) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 b, s;
    sm90::split4(x[i], scale, b, s);
    big[i] = b;
    small[i] = s;
  }
}

// dk and dv as the sums, in split order, of `splits` pairs of partials
// (part: [splits][dk, dv][n4 float4s]).
__global__ void kv_sum_kernel(const float4* __restrict__ part, int splits,
                              float4* __restrict__ dk, float4* __restrict__ dv,
                              size_t n4) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 k = part[i], v = part[n4 + i];
    for (int s = 1; s < splits; ++s) {
      const float4 pk = part[2 * s * n4 + i], pv = part[(2 * s + 1) * n4 + i];
      k = make_float4(k.x + pk.x, k.y + pk.y, k.z + pk.z, k.w + pk.w);
      v = make_float4(v.x + pv.x, v.y + pv.y, v.z + pv.z, v.w + pv.w);
    }
    dk[i] = k;
    dv[i] = v;
  }
}

namespace sm90 {

// The layout of a call's scratch: 2 (|q| + |do| + |k| + |v|) floats (each
// operand's big part, then its small part), then 2 splits |k| for the
// dK/dV partials where splits > 1 (part is null otherwise).
struct WideScratch {
  size_t nq, nk;  // elements of q (and do), of k (and v)
  float *qb, *qs, *dob, *dos, *kb, *ks, *vb, *vs, *part;
};

inline WideScratch wide_scratch(const AttnArgs& a, float* scratch,
                                int splits) {
  WideScratch w;
  w.nq = (size_t)a.B * a.H * a.Nq * a.D;
  w.nk = (size_t)a.B * a.H_kv * a.Nk * a.D;
  w.qb = scratch;
  w.qs = w.qb + w.nq;
  w.dob = w.qs + w.nq;
  w.dos = w.dob + w.nq;
  w.kb = w.dos + w.nq;
  w.ks = w.kb + w.nk;
  w.vb = w.ks + w.nk;
  w.vs = w.vb + w.nk;
  w.part = splits > 1 ? w.vs + w.nk : nullptr;
  return w;
}

inline cudaError_t split_pair(const void* x, float scale, float* big,
                              float* small, size_t n, cudaStream_t st) {
  const size_t n4 = n / 4;
  tf32_split_kernel<<<stream_blocks(n4), 256, 0, st>>>(
      static_cast<const float4*>(x), scale, reinterpret_cast<float4*>(big),
      reinterpret_cast<float4*>(small), n4);
  return cudaGetLastError();
}

// q times q_scale, dO, K and V split into the scratch's parts: four
// launches of tf32_split_kernel.
inline cudaError_t split_operands(const AttnArgs& a, const void* dout,
                                  float q_scale, const WideScratch& w,
                                  cudaStream_t st) {
  cudaError_t err = split_pair(a.q, q_scale, w.qb, w.qs, w.nq, st);
  if (err == cudaSuccess) err = split_pair(dout, 1.f, w.dob, w.dos, w.nq, st);
  if (err == cudaSuccess) err = split_pair(a.k, 1.f, w.kb, w.ks, w.nk, st);
  if (err == cudaSuccess) err = split_pair(a.v, 1.f, w.vb, w.vs, w.nk, st);
  return err;
}

// dk and dv from the partials (one launch of kv_sum_kernel), where the
// dK/dV kernel wrote partials (w.part is not null).
inline cudaError_t sum_partials(const WideScratch& w, int splits, void* dk,
                                void* dv, cudaStream_t st) {
  if (w.part == nullptr) return cudaSuccess;
  const size_t n4 = w.nk / 4;
  kv_sum_kernel<<<stream_blocks(n4), 256, 0, st>>>(
      reinterpret_cast<const float4*>(w.part), splits,
      static_cast<float4*>(dk), static_cast<float4*>(dv), n4);
  return cudaGetLastError();
}

// The dK/dV kernel's maps, in its argument order: the parts of q and of dO
// in R-row boxes, K and V as landed in KEYS-row boxes.
template <int DP>
inline cudaError_t dkv_wide_maps(CUtensorMap (&m)[6], const AttnArgs& a,
                                 const WideScratch& w) {
  using Kv = DkvWideCfg<DP>;
  const int QH = a.B * a.H, KH = a.B * a.H_kv;
  constexpr int RB = box_rows<Kv::R>(), KB = box_rows<Kv::KEYS>();
  cudaError_t err = make_map32(&m[0], w.qb, QH, a.Nq, a.D, RB);
  if (err == cudaSuccess) err = make_map32(&m[1], w.qs, QH, a.Nq, a.D, RB);
  if (err == cudaSuccess) err = make_map32(&m[2], a.k, KH, a.Nk, a.D, KB);
  if (err == cudaSuccess) err = make_map32(&m[3], a.v, KH, a.Nk, a.D, KB);
  if (err == cudaSuccess) err = make_map32(&m[4], w.dob, QH, a.Nq, a.D, RB);
  if (err == cudaSuccess) err = make_map32(&m[5], w.dos, QH, a.Nq, a.D, RB);
  return err;
}

// The dQ kernel's maps, in its argument order: q as landed, the parts of K
// and of V in KEYS-row boxes, dO as landed (ROWS-row boxes).
template <int DP>
inline cudaError_t dq_wide_maps(CUtensorMap (&m)[6], const AttnArgs& a,
                                const void* dout, const WideScratch& w) {
  using Dq = DqWideCfg<DP>;
  const int QH = a.B * a.H, KH = a.B * a.H_kv;
  constexpr int QR = box_rows<Dq::ROWS>(), KR = box_rows<Dq::KEYS>();
  cudaError_t err = make_map32(&m[0], a.q, QH, a.Nq, a.D, QR);
  if (err == cudaSuccess) err = make_map32(&m[1], w.kb, KH, a.Nk, a.D, KR);
  if (err == cudaSuccess) err = make_map32(&m[2], w.ks, KH, a.Nk, a.D, KR);
  if (err == cudaSuccess) err = make_map32(&m[3], w.vb, KH, a.Nk, a.D, KR);
  if (err == cudaSuccess) err = make_map32(&m[4], w.vs, KH, a.Nk, a.D, KR);
  if (err == cudaSuccess) err = make_map32(&m[5], dout, QH, a.Nq, a.D, QR);
  return err;
}

}  // namespace sm90
}  // namespace fat
