// Shared by the chunked mma.sync kernels above head dim 256 (flash_wide.cu,
// sparse_wide.cu): the 64-column segment and output-chunk widths, the tile
// copies into shared memory, the segment products that reduce over the head
// dim (S, dP and their transposes) and the products into an output chunk
// (P.V, dS.K, P^T.dO, dS^T.q), in bf16 on m16n8k16 and in fp32 (3xTF32) on
// m16n8k8, and the cp.async ring of items. flash_wide.cu's header sets out
// the design they serve.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"
#include "sparse_mma.cuh"

namespace fat {
namespace wide {

using mma::a_col;
using mma::a_row;
using mma::acc_split;
using mma::b_col;
using mma::b_row;
using mma::f32_b;
using mma::f32_row_bytes;
using mma::mma3_1688;
using mma::split_frag;
using sm90::smem_u32;

constexpr int kThreadsW = 128;  // 4 warps
constexpr int kSeg = 64;        // head-dim columns of a segment item
constexpr int kStages = 3;
constexpr int kRowsF = 64;      // query rows of a forward or dQ CTA
constexpr int kKeysF = 32;      // keys of a forward or dQ step
constexpr int kKeysB = 64;      // keys of a dK/dV CTA
constexpr int kRowsB = 32;      // query rows of a dK/dV step
constexpr int kChunkO = 128;    // columns of an O chunk

template <typename T>
constexpr bool kBf16 = std::is_same_v<T, __nv_bfloat16>;

// Columns of a dQ chunk, and of a dK/dV chunk, whose CTA holds both: 64
// in fp32, where 128 spilled (the 3xTF32 split's temporaries and the
// fresh accumulators beside the running sums).
template <typename T>
constexpr int kChunkQ = kBf16<T> ? 128 : 64;
template <typename T>
constexpr int kChunkKV = kBf16<T> ? 128 : 64;

// Bytes between two rows of a shared tile of `cols` columns of T.
template <typename T>
__host__ __device__ constexpr int row_bytes(int cols) {
  return kBf16<T> ? tc_row_bytes(cols) : f32_row_bytes(cols);
}

__host__ __device__ constexpr int cmax(int x, int y) { return x > y ? x : y; }

// Rows [0, rows) of a tile of COLS columns: columns [d0, d0 + COLS) of the
// rows at src (row stride D elements), 16 bytes a copy; rows at or past
// n_ok and columns at or past D are zeros. D % 8 == 0, so a 16-byte unit is
// wholly inside D or wholly past it.
// Thread `tid` of `nthr` takes every nthr-th copy (load_tile: the CTA's
// 128 threads).
template <typename T, int COLS>
__device__ __forceinline__ void load_tile_n(char* dst, int rs, const T* src,
                                            int rows, int n_ok, int d0, int D,
                                            int tid, int nthr) {
  constexpr int E = 16 / sizeof(T), CPR = COLS / E;
  for (int i = tid; i < rows * CPR; i += nthr) {
    const int j = i / CPR, c = i % CPR, d = d0 + c * E;
    const bool ok = j < n_ok && d < D;
    cp_async16(smem_u32(dst + j * rs + c * 16),
               ok ? src + (size_t)j * D + d : src, ok);
  }
}

template <typename T, int COLS>
__device__ __forceinline__ void load_tile(char* dst, int rs, const T* src,
                                          int rows, int n_ok, int d0, int D) {
  load_tile_n<T, COLS>(dst, rs, src, rows, n_ok, d0, D, threadIdx.x,
                       kThreadsW);
}

// q_s = round(q * scale) in place over `rows` rows of a COLS-column tile.
template <typename T, int COLS>
__device__ __forceinline__ void scale_tile(char* t, int rs, int rows,
                                           float sc) {
  constexpr int CPR = COLS * (int)sizeof(T) / 16;
  for (int i = threadIdx.x; i < rows * CPR; i += kThreadsW) {
    uint4* p = reinterpret_cast<uint4*>(t + (i / CPR) * rs + (i % CPR) * 16);
    uint4 v = *p;
    if constexpr (kBf16<T>) {
      uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f =
            __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[j]));
        w[j] = pack_bf16(f.x * sc, f.y * sc);
      }
    } else {
      float* f = reinterpret_cast<float*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) f[j] *= sc;
    }
    *p = v;
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) x[i][c] = 0.f;
  }
}

// fp32: the tensor cores' own fp32 sums drift over a long chain of
// products into one accumulator (dV of an MQA call at N = 2048, 8192
// products an element, missed the 1e-4 limit by 6x), so the fp32 products
// sum each segment, or each group of kGroup output tiles of a step, in a
// fresh accumulator, which the CUDA cores add to the running sum (rounded
// to nearest).
constexpr int kGroup = 4;

template <int N>
__device__ __forceinline__ void add_to(float (&acc)[N][4],
                                       const float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] += x[i][c];
  }
}

// acc (16 rows x 8 NT columns) += A . B^T over one 64-column segment: A's
// 16 rows at ta, B's 8 NT rows at tb, both row-major at row stride rs. A
// k step is 32 bytes of a row (16 bf16, or 8 fp32 in TF32).
template <typename T, int NT>
__device__ __forceinline__ void seg_mma(float (&acc)[NT][4], const char* ta,
                                        const char* tb, int rs, int lane) {
  constexpr int KS = kSeg * (int)sizeof(T) / 32;
  const uint32_t pa = smem_u32(ta + a_row(lane) * rs + 2 * a_col(lane));
  const uint32_t pb = smem_u32(tb + b_row(lane) * rs + 2 * b_col(lane));
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if constexpr (kBf16<T>) {
      uint32_t af[4];
      ldsm_x4(af, pa + ks * 32);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, pb + np * 16 * rs + ks * 32);
        mma_16816(acc[2 * np], af, bf[0], bf[1]);
        mma_16816(acc[2 * np + 1], af, bf[2], bf[3]);
      }
    } else {
      uint32_t x[4], ab[4], as[4];
      ldsm_x4(x, pa + ks * 32);
      split_frag(x, ab, as);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bb[4], bs[4];
        ldsm_x4(x, pb + np * 16 * rs + ks * 32);
        split_frag(x, bb, bs);
        mma3_1688(acc[2 * np], ab, as, bb[0], bb[1], bs[0], bs[1]);
        mma3_1688(acc[2 * np + 1], ab, as, bb[2], bb[3], bs[2], bs[3]);
      }
    }
  }
}

template <typename T, int NT>
__device__ __forceinline__ void seg_product(float (&acc)[NT][4],
                                            const char* ta, const char* tb,
                                            int rs, int lane) {
  if constexpr (kBf16<T>) {
    seg_mma<T, NT>(acc, ta, tb, rs, lane);
  } else {
    float tmp[NT][4];
    zero(tmp);
    seg_mma<T, NT>(tmp, ta, tb, rs, lane);
    add_to(acc, tmp);
  }
}

// acc (16 x 8 NO) += P . B: P an accumulator of 16 x 8 NT (rounded to T as
// the A operand), B (8 NT rows of k, 8 NO columns) row-major at tb, row
// stride rs.
template <typename T, int NT, int NO>
__device__ __forceinline__ void rs_product(float (&acc)[NO][4],
                                           const float (&p)[NT][4],
                                           const char* tb, int rs, int lane) {
  if constexpr (kBf16<T>) {
    const int at = a_row(lane) * rs + 2 * a_col(lane);
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(p[2 * kk][0], p[2 * kk][1]),
          pack_bf16(p[2 * kk][2], p[2 * kk][3]),
          pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
          pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < NO / 2; ++dn) {
        uint32_t bf[4];
        ldsm_x4_t(bf, smem_u32(tb + kk * 16 * rs + at + dn * 32));
        mma_16816(acc[2 * dn], pa, bf[0], bf[1]);
        mma_16816(acc[2 * dn + 1], pa, bf[2], bf[3]);
      }
    }
  } else {  // kGroup output tiles at a time, each in a fresh accumulator
    static_assert(NO % kGroup == 0, "rs_product: NO % kGroup");
    const int ov = 2 * (lane & 3) * rs + 4 * (lane >> 2);
#pragma unroll
    for (int d0 = 0; d0 < NO; d0 += kGroup) {
      float tmp[kGroup][4];
      zero(tmp);
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        uint32_t pb[4], ps[4];
        acc_split(p[kk], pb, ps);
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          uint32_t vb[2], vs[2];
          f32_b(tb, kk * 8 * rs + ov + (d0 + j) * 32, rs, vb, vs);
          mma3_1688(tmp[j], pb, ps, vb[0], vb[1], vs[0], vs[1]);
        }
      }
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[d0 + j][c] += tmp[j][c];
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float x, float y) {
  if constexpr (kBf16<T>) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
}

// The ring: item i in stage i % kStages; every thread copies its share.
// Before item i's products: wait for it, and make sure every warp is past
// item i - 1 before its stage is refilled with item i + kStages - 1.
template <typename Issue>
__device__ __forceinline__ void ring_start(int n_items, Issue&& issue) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_items) issue(s);
    cp_async_commit();
  }
}

template <typename Issue>
__device__ __forceinline__ void ring_step(int i, int n_items, Issue&& issue) {
  cp_async_wait<kStages - 2>();
  __syncthreads();
  if (i + kStages - 1 < n_items) issue(i + kStages - 1);
  cp_async_commit();
}

}  // namespace wide
}  // namespace fat
