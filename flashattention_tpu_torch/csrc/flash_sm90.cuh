// Hopper (sm_90a) machinery of the tensor-core flash kernels (the bf16
// routes of flash_fwd.cu and flash_bwd.cu): tensor maps made on the
// host, TMA loads that complete on mbarriers, wgmma descriptors for
// 128-byte-swizzled bf16 tiles in K-major and MN-major form, the wgmma
// instructions the kernels issue, setmaxnreg, and the map from an element of
// an m64nN accumulator fragment to its (row, col).
//
// Tiles. Every tile in shared memory is a stack of "halves" of R rows x 64
// bf16 columns (128 bytes a row), one per 64 columns of the head dim, each
// written by TMA with the 128-byte swizzle (16-byte chunk c of row r lands
// at chunk c ^ (r % 8)) from boxes of 64 (or, for a 32-row tile, 32) rows x
// 64 columns. That is the
// layout wgmma reads with layout type SWIZZLE_128B: 8-row groups 1024 bytes
// apart. Tiles start 1024-byte aligned. TMA fills reads past the tensor's
// rows or columns with zeros (a box wholly past the head dim included), so
// a head dim below 64, 128 or 256 and a ragged row count need no code of
// their own.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: nothing links libcuda

#include <type_traits>

#include "flash_common.cuh"

namespace fat {
namespace sm90 {

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda; null if the driver does not offer it.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    return err == cudaSuccess && res == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

constexpr int kBox = 64;  // TMA box: 64 rows x 64 columns (8 KB)

// Map of a contiguous bf16 tensor (planes, rows, cols), 16-byte aligned, read
// in boxes of box_rows x kBox with the 128-byte swizzle. Returns a CUDA
// error code.
inline cudaError_t make_map(CUtensorMap* m, const void* base, int planes,
                            int rows, int cols, int box_rows = kBox) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || cols % 8 != 0) {
    return cudaErrorInvalidValue;
  }
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)cols * rows * 2};
  const cuuint32_t box[3] = {kBox, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = enc(
      m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Device: shared memory, mbarriers, TMA, barriers, registers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte-aligned address of dynamic shared memory (the kernels
// ask for 1024 bytes more than they use).
__device__ __forceinline__ char* align_1024(char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also expects `bytes` of TMA transactions this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A consumer's k-th
// use of a ring slot waits with parity k & 1; a producer's k-th refill of a
// slot waits on its "empty" barrier with (k & 1) ^ 1, which passes at once
// on the first round.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Box (col, row, plane) of a 3-D tensor map into shared memory at `dst`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"(plane)
      : "memory");
}

// Rows [row, row + R) of `plane`, all DP columns, into the tile at `dst`
// (DP / 64 halves of R x 64). R * DP * 2 bytes complete on `bar`. A tile of
// fewer than 64 rows needs a map of R-row boxes.
template <int R, int DP>
__device__ __forceinline__ void tma_tile(char* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int plane) {
  constexpr int BR = R < kBox ? R : kBox;  // rows per box
#pragma unroll
  for (int hf = 0; hf < DP / 64; ++hf) {
#pragma unroll
    for (int rb = 0; rb < R / BR; ++rb) {
      tma_load(dst + (hf * R + rb * BR) * 128, map, bar, hf * 64,
               row + rb * BR, plane);
    }
  }
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy (wgmma, TMA) accesses.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Named barrier `id` (1-15; 0 is __syncthreads) over `n` threads.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// Producer warpgroup and consumer warpgroups: 24 + 2 x 240 registers of a
// 384-thread block fit the SM's 64K.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kThreadsWS = 384;  // warpgroup 0 loads, 1-2 compute

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Matrix descriptor of a SWIZZLE_128B operand at `p` (1024-byte-aligned
// atoms): lbo and sbo in bytes.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major operand for k-step kk (16 columns) of rows [row, row + 64) of an
// R-row tile: the 16 columns lie in one 128-byte row of one half, 32 bytes
// per step; 8-row groups 1024 bytes apart (SBO); LBO is unused.
template <int R>
__device__ __forceinline__ uint64_t desc_k(const char* tile, int row, int kk) {
  return make_desc(tile + (kk / 4) * R * 128 + row * 128 + (kk % 4) * 32, 16,
                   1024);
}

// MN-major B operand (B[k][n] = tile[k][n], n contiguous) for k-step kk:
// rows 16kk..16kk+15 of an R-row tile, 2048 bytes per step; 8-row (k)
// groups 1024 bytes apart (SBO); the 64-column halves along n R * 128
// bytes apart (LBO).
template <int R>
__device__ __forceinline__ uint64_t desc_mn(const char* tile, int kk) {
  return make_desc(tile + kk * 16 * 128, R * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 32, fp32) {+}= A (64 x 16) * B (16 x 32); A and B K-major in shared
// memory (descriptors); D += only where scale_d != 0.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, fp32) {+}= A (64 x 16) * B (16 x 64); A and B K-major in shared
// memory (descriptors); D += only where scale_d != 0.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, fp32) {+}= A (64 x 16) * B (16 x 128); A and B K-major in shared
// memory (descriptors); D += only where scale_d != 0.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, fp32) += A (64 x 16) * B (16 x 128); A K-major and B
// MN-major (transpose bit set) in shared memory.
__device__ __forceinline__ void wgmma_ss_mn_n128(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(1));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 registers in the A layout) *
// B (16 x 64); B MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 registers in the A layout) *
// B (16 x 128); B MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// ---------------------------------------------------------------------------
// Accumulator fragments
// ---------------------------------------------------------------------------

// Element i of an m64nN fp32 accumulator fragment of thread t (0-127) of its
// warpgroup sits at row acc_row(t, i) (0-63) and column acc_col(t, i): warp
// t / 32 holds rows 16 (t / 32) + {0, 8} + (t % 32) / 4, and each thread
// column pairs 8 j + 2 (t % 4) + {0, 1}.
__device__ __forceinline__ int acc_row(int t, int i) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}

__device__ __forceinline__ int acc_col(int t, int i) {
  return 8 * (i >> 2) + 2 * (t & 3) + (i & 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The fragment rounded to bf16 as the register A operands of N / 16
// k-steps: columns 16 kk..16 kk + 15 of the accumulator are the A layout of
// step kk, so no shuffle is needed.
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&f)[N / 2],
                                         uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[kk][j] = pack_bf16(f[8 * kk + 2 * j], f[8 * kk + 2 * j + 1]);
    }
  }
}

// The instruction for an accumulator of N columns.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_ss: N is 32-128");
  if constexpr (N == 32) {
    wgmma_ss_n32(d, da, db, scale_d);
  } else if constexpr (N == 64) {
    wgmma_ss_n64(d, da, db, scale_d);
  } else {
    wgmma_ss_n128(d, da, db, scale_d);
  }
}

// N = 256 (the head dim 256 accumulators) is two n128 products over the
// fragment's halves (elements 0-63 hold columns 0-127): B's columns 128-255
// start two 64-column halves, 2 LBO, further on.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 64 || N == 128 || N == 256, "wgmma_rs: N is 64-256");
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, db);
  } else if constexpr (N == 128) {
    wgmma_rs_n128(d, a, db);
  } else {
    const uint64_t lbo16 = (db >> 16) & 0x3FFF;  // LBO in 16-byte units
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(d), a, db);
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(d + 64), a, db + 2 * lbo16);
  }
}

// Byte offset of bf16 element (r, c) in a tile of 128-byte rows (64
// columns) written as TMA's 128-byte swizzle lays it out, so that
// desc_k reads it as a K-major operand; the tile is 1024-byte aligned.
__device__ __forceinline__ int swizzle128(int r, int c) {
  return r * 128 + (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// The exchange of the dK/dV kernels' head-dim split (D = 256: two consumers
// share a 64-key tile, consumer cw holding columns 128 cw .. 128 cw + 127 of
// dK and dV). This consumer's round(p)ᵀ and round(ds)ᵀ (fragments of keys x
// QS query rows, from row q0 of the ROWS-row tile) go to pt_s and dst_s at
// (key, query row) in the 128-byte swizzle, where the other consumer's
// products read them; after named barrier 2 both issue dV[:, half] +=
// Pᵀ·dO[:, half] and dK[:, half] += dSᵀ·q[:, half] over all ROWS rows (A
// K-major; B MN-major from this consumer's two 64-column halves of the dO
// and q tiles). The caller commits and waits.
template <int KEYS, int ROWS, int QS>
__device__ __forceinline__ void dsplit_products(
    const float (&pt)[QS / 2], const float (&dst)[QS / 2], char* pt_s,
    char* dst_s, const char* dot, const char* qt, int q0, int cw, int t,
    float (&dv_acc)[64], float (&dk_acc)[64]) {
#pragma unroll
  for (int i = 0; i < QS / 2; i += 2) {
    const int at = swizzle128(acc_row(t, i), q0 + acc_col(t, i));
    *reinterpret_cast<uint32_t*>(pt_s + at) = pack_bf16(pt[i], pt[i + 1]);
    *reinterpret_cast<uint32_t*>(dst_s + at) = pack_bf16(dst[i], dst[i + 1]);
  }
  fence_proxy_async();
  named_sync(2, 256);

  const int hoff = 2 * cw * ROWS * 128;
  wgmma_fence();
  fence_regs(dv_acc);
  fence_regs(dk_acc);
#pragma unroll
  for (int kk = 0; kk < ROWS / 16; ++kk) {
    wgmma_ss_mn_n128(dv_acc, desc_k<KEYS>(pt_s, 0, kk),
                     desc_mn<ROWS>(dot + hoff, kk));
    wgmma_ss_mn_n128(dk_acc, desc_k<KEYS>(dst_s, 0, kk),
                     desc_mn<ROWS>(qt + hoff, kk));
  }
}

// Rounds `bytes` of bf16 at p (a multiple of 16) to bf16(x * scale) in
// place, thread `tid` of `n` taking every n-th 16 bytes: the backward's q_s.
__device__ __forceinline__ void scale_bf16(char* p, int bytes, float scale,
                                           int tid, int n) {
  for (int i = tid * 16; i < bytes; i += n * 16) {
    uint4 v = *reinterpret_cast<uint4*>(p + i);
    uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[j]));
      w[j] = pack_bf16(f.x * scale, f.y * scale);
    }
    *reinterpret_cast<uint4*>(p + i) = v;
  }
}

// ---------------------------------------------------------------------------
// The score pipeline over a fragment
// ---------------------------------------------------------------------------
//
// visible() and post_score() test each feature with a branch (and visible()
// loads segment ids under one), which on 32-64 elements a thread serialises
// the loop. So a warpgroup classifies its block of (rows, cols) once per
// tile and runs an element loop specialised for the class: no mask code
// where every pair is visible, visible() on arguments whose segment-id
// pointers are null (the compiler folds its tests to selects) elsewhere,
// with segment ids compared through bits read once per tile, and
// post_score() only where ALiBi or the soft-cap is on. The functions
// themselves are flash_common.cuh's, unchanged.

enum TileClass { kInterior = 0, kBand = 1, kSegments = 2 };

// Class of the block of rows [r_lo, r_hi] and columns [c_lo, c_hi].
__device__ __forceinline__ int tile_class(const AttnArgs& a, int r_lo, int r_hi,
                                          int c_lo, int c_hi) {
  if (a.q_ids != nullptr) return kSegments;
  if (r_hi >= a.Nq || c_hi >= a.Nk) return kBand;
  if (a.causal) {
    if (c_hi > r_lo + a.offset) return kBand;  // crosses the diagonal
    if (a.window > 0 && c_lo <= r_hi + a.offset - a.window &&
        !(a.sinks > 0 && c_hi < a.sinks)) {
      return kBand;  // crosses the window's lower edge
    }
  }
  return kInterior;
}

// Segment ids of a fragment, read once per tile: bit c of seg[r] is set
// where the id of this thread's accumulator row r (row_ids[row0 +
// acc_row(t, 2 r)]) equals that of its c-th column (col_ids[col0 +
// acc_col(t, i)], i = 4 (c / 2) + c % 2), both in range. For a fragment of
// N columns, N / 4 bits.
template <int N>
__device__ __forceinline__ void segment_bits(const int32_t* row_ids, int row0,
                                             int n_rows, const int32_t* col_ids,
                                             int col0, int n_cols, int t,
                                             uint32_t (&seg)[2]) {
  static_assert(N / 4 <= 32, "segment_bits: at most 32 columns a thread");
  int rid[2];
  bool rok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + acc_row(t, 2 * r);
    rok[r] = row < n_rows;
    rid[r] = rok[r] ? row_ids[row] : 0;
    seg[r] = 0u;
  }
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
    const int col = col0 + acc_col(t, 4 * (c / 2) + c % 2);
    if (col < n_cols) {
      const int id = col_ids[col];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rok[r] && id == rid[r]) seg[r] |= 1u << c;
      }
    }
  }
}

// Is element i of the fragment, at (row, col) of the attention matrix,
// visible? kBand and kSegments run visible() on the arguments without
// segment ids (its tests fold to selects); kSegments adds the ids' bit.
template <int CLS>
__device__ __forceinline__ bool tile_visible(const AttnArgs& a, int b,
                                             int row, int col,
                                             const uint32_t (&seg)[2], int i) {
  if constexpr (CLS == kInterior) {
    return true;
  } else {
    AttnArgs band = a;  // folded away: only the id pointers differ
    band.q_ids = nullptr;
    band.kv_ids = nullptr;
    const bool vis = row < a.Nq && visible(band, b, row, col);
    if constexpr (CLS == kBand) {
      return vis;
    } else {
      return vis && ((seg[(i >> 1) & 1] >> ((i >> 2) * 2 + (i & 1))) & 1u);
    }
  }
}

// Steps 2-3 of the pipeline where POST (ALiBi or soft-cap on), else s.
template <bool POST>
__device__ __forceinline__ float tile_score(const AttnArgs& a, int h, int row,
                                            int col, float s, float* dcap) {
  if constexpr (POST) {
    return post_score(a, h, row, col, s, dcap);
  } else {
    *dcap = 1.f;
    return s;
  }
}

template <int V>
using Int = std::integral_constant<int, V>;

// f(Int<class>, Int<post>) with both as compile-time constants.
template <typename F>
__device__ __forceinline__ void dispatch_tile(int cls, bool post, F&& f) {
  if (post) {
    if (cls == kInterior) f(Int<kInterior>{}, Int<1>{});
    else if (cls == kBand) f(Int<kBand>{}, Int<1>{});
    else f(Int<kSegments>{}, Int<1>{});
  } else {
    if (cls == kInterior) f(Int<kInterior>{}, Int<0>{});
    else if (cls == kBand) f(Int<kBand>{}, Int<0>{});
    else f(Int<kSegments>{}, Int<0>{});
  }
}

}  // namespace sm90
}  // namespace fat
