// Warp-level tensor-core products (mma.sync m16n8k16, bf16 in, and
// m16n8k8, tf32 in, both with fp32 accumulate) and what feeds them:
// ldmatrix in both forms, movmatrix, bf16
// packing, the padded row stride that keeps ldmatrix free of bank conflicts,
// and cp.async copies into shared memory. Shared by the split paged walk
// (paged_attention.cu) and the mma route of the block-sparse kernels
// (sparse_fwd.cu, sparse_bwd.cu, sparse_mma.cuh).
//
// Fragments of m16n8k16 (lane = 4 g + tq): A (16 x 16, row) holds rows g and
// g + 8 at columns 2tq, 2tq + 1 (a0 / a1) and 2tq + 8, 2tq + 9 (a2 / a3); B
// (16 x 8, col) holds column g at rows 2tq, 2tq + 1 (b0) and 2tq + 8,
// 2tq + 9 (b1); the accumulator holds row g (c0, c1) and row g + 8 (c2, c3)
// at columns 2tq, 2tq + 1. Fragments of m16n8k8 tf32: A (16 x 8) holds rows
// g and g + 8 at columns tq (a0 / a1) and tq + 4 (a2 / a3); B (8 x 8) holds
// column g at rows tq (b0) and tq + 4 (b1); the accumulator as m16n8k16's.
// An 8 x 8 b16 matrix of ldmatrix is 8 rows of 4 fp32, so the non-transposed
// ldmatrix hands each lane the fp32 at (row g, column tq): it loads tf32 A
// fragments, and B fragments of a tile stored N-major, as it loads bf16
// ones, a k8 step of fp32 being 32 bytes as a k16 step of bf16 is.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace fat {

// Bytes between two rows of a bf16 tile of D columns in shared memory: the
// row's D * 2 bytes rounded up to an odd count of 16-byte units, so the 8
// rows one ldmatrix reads fall in 8 different quads of banks.
__host__ __device__ constexpr int tc_row_bytes(int D) {
  return ((D / 8) | 1) * 16;
}

// d (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d (16 x 8, fp32) += a (16 x 8, tf32, row) * b (8 x 8, tf32, col)
__device__ __forceinline__ void mma_1688(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8. The .trans form hands each lane the transposed fragment.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// The transposed fragment of an 8 x 8 bf16 matrix held across the warp.
__device__ __forceinline__ uint32_t movm_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;"
               : "=r"(y)
               : "r"(x));
  return y;
}

// Two floats rounded to bf16, lo in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 bytes from global src to shared dst (both 16-byte aligned), or 16 zero
// bytes where !ok (src is then not read, but must be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile(
      "cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
      "r"(ok ? 16 : 0)
      : "memory");
}

// 4 bytes, or 4 zero bytes where !ok.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile(
      "cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
      "r"(ok ? 4 : 0)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace fat
