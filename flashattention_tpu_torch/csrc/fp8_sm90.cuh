// Hopper (sm_90a) machinery of the 8-bit forward's tensor-core route
// (fat_flash_fwd_fp8_sm90 in flash_fwd_fp8.cu), beside flash_sm90.cuh, which
// it reuses and leaves unchanged: tensor maps of 1-byte payloads, the
// m64nNk32 s8 wgmma (int8 Q·Kᵀ into s32), and the exact decode of a 1-byte
// tile into the bf16 layout flash_sm90.cuh's descriptors read.
//
// Tiles. A 1-byte tile is a stack of column halves of R rows x 128 bytes
// (128 payload columns each): one half up to a head dim of 128 (a head dim
// below 128 reads zeros from TMA), two at 128 < DP <= 256 (the second half
// holds columns 128-255, zeros past the head dim). TMA writes each half from
// boxes of 128 columns with the 128-byte swizzle: the layout
// flash_sm90.cuh's bf16 "halves" have, measured in bytes. A k32 step of an
// 8-bit operand is 32 bytes, as bf16's k16 step is, and four steps fill a
// half's row as four k16 steps fill a bf16 half's, so desc_k's K-major
// descriptor serves the s8 product at every head dim (q8 and k8 have D
// contiguous: both K-major, as 8-bit wgmma requires). A decoded tile is
// DP / 64 halves of R rows x 64 bf16 with the 128-byte swizzle, which desc_k
// reads K-major (Q, K) and desc_mn MN-major (V, for P·V).
#pragma once

#include <cuda_fp8.h>

#include "flash_sm90.cuh"

namespace fat {
namespace sm90 {

constexpr int kRow8 = 128;  // bytes (and 1-byte columns) of a half's row

// Column halves of a 1-byte tile at head dim DP.
template <int DP>
__host__ __device__ constexpr int halves8() {
  return DP > 128 ? DP / 128 : 1;
}

// Map of a contiguous 1-byte tensor (planes, rows, cols), 16-byte aligned,
// cols % 16 == 0, read in boxes of box_rows rows x 128 columns with the
// 128-byte swizzle. Returns a CUDA error code.
inline cudaError_t make_map8(CUtensorMap* m, const void* base, int planes,
                             int rows, int cols, int box_rows = kBox) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || cols % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)cols,
                                 (cuuint64_t)cols * rows};
  const cuuint32_t box[3] = {kRow8, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = enc(
      m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Rows [row, row + R) of `plane` into the tile at `dst` (halves8<DP>()
// halves of R x 128 bytes); R * 128 bytes a half complete on `bar`. A tile
// of fewer than 64 rows needs a map of R-row boxes.
template <int R, int DP>
__device__ __forceinline__ void tma_tile8(char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row, int plane) {
  constexpr int BR = R < kBox ? R : kBox;  // rows per box
#pragma unroll
  for (int hf = 0; hf < halves8<DP>(); ++hf) {
#pragma unroll
    for (int rb = 0; rb < R / BR; ++rb) {
      tma_load(dst + (hf * R + rb * BR) * kRow8, map, bar, hf * kRow8,
               row + rb * BR, plane);
    }
  }
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x N, s32) {+}= A (64 x 32) * B (32 x N), A and B int8 K-major in
// shared memory (descriptors); D += only where scale_d != 0.
__device__ __forceinline__ void wgmma_s8_n32(uint32_t (&d)[16], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n64(uint32_t (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n128(uint32_t (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x N, s32) {+}= A (64 x 32) * B (32 x N), int8, for N of 32-128.
template <int N>
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_s8: N is 32-128");
  if constexpr (N == 32) {
    wgmma_s8_n32(d, da, db, scale_d);
  } else if constexpr (N == 64) {
    wgmma_s8_n64(d, da, db, scale_d);
  } else {
    wgmma_s8_n128(d, da, db, scale_d);
  }
}

// Four payload bytes of format FMT as two packed bf16 pairs, exactly. int8
// goes through the float bits of 2^23 + (x + 128) less 2^23 + 128: a byte
// permute and an add instead of I2F, which an SM runs at 16 a clock
// against 128 fp32 adds (as paged_attention.cu's load8_exact).
template <int FMT>
__device__ __forceinline__ void bytes_to_bf16(uint32_t w, uint32_t* out) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const uint32_t pair = w >> (16 * j);
    float2 f;
    if constexpr (FMT == 2) {
      const uint32_t u = w ^ 0x80808080u;
      f = make_float2(
          __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | (2 * j))) -
              8388736.f,
          __uint_as_float(
              __byte_perm(u, 0x4B000000u, 0x7540u | (2 * j + 1))) -
              8388736.f);
    } else {
      const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
          (__nv_fp8x2_storage_t)(pair & 0xffffu),
          FMT == 0 ? __NV_E4M3 : __NV_E5M2);
      f = __half22float2(__half2(h));
    }
    out[j] = pack_bf16(f.x, f.y);
  }
}

// The 1-byte tile `raw` (halves8<DP>() halves of ROWS x 128 bytes,
// TMA-swizzled) decoded into the bf16 tile `dst` (DP / 64 halves of ROWS x
// 64, 128-byte swizzle), thread `tid` of `n`: each takes 16 source bytes (16
// columns of one row) at a time and writes two 16-byte chunks.
template <int FMT, int ROWS, int DP>
__device__ __forceinline__ void decode_tile(const char* raw, char* dst,
                                            int tid, int n) {
  constexpr int CH = DP / 16;  // source chunks a row
  for (int u = tid; u < ROWS * CH; u += n) {
    const int r = u / CH, cs = u % CH, sw = r & 7;
    const uint4 src = *reinterpret_cast<const uint4*>(
        raw + ((cs / 8) * ROWS + r) * kRow8 + (((cs % 8) ^ sw) << 4));
    uint32_t out[8];
    bytes_to_bf16<FMT>(src.x, out);
    bytes_to_bf16<FMT>(src.y, out + 2);
    bytes_to_bf16<FMT>(src.z, out + 4);
    bytes_to_bf16<FMT>(src.w, out + 6);
    char* row = dst + (cs / 4) * ROWS * 128 + r * 128;
    const int lc = 2 * (cs % 4);
    *reinterpret_cast<uint4*>(row + ((lc ^ sw) << 4)) =
        make_uint4(out[0], out[1], out[2], out[3]);
    *reinterpret_cast<uint4*>(row + (((lc + 1) ^ sw) << 4)) =
        make_uint4(out[4], out[5], out[6], out[7]);
  }
}

// a / b as IEEE division rounds it, from rb = 1 / b (correctly rounded):
// two corrections of a * rb by its exact FMA residual (Markstein), without
// div.rn.f32's range check and slow path each element. s8's quotients lie
// in [0, 127] with b >= 1e-30 / 127, far from overflow and underflow.
__device__ __forceinline__ float div_rn(float a, float b, float rb) {
  float q = a * rb;
  q = fmaf(fmaf(-b, q, a), rb, q);
  return fmaf(fmaf(-b, q, a), rb, q);
}

}  // namespace sm90
}  // namespace fat
