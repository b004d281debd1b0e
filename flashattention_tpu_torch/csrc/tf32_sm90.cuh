// Hopper (sm_90a) machinery of the fp32 tensor-core flash kernels (the fp32
// routes of flash_fwd.cu and flash_bwd.cu), beside flash_sm90.cuh, which it
// reuses and leaves unchanged: fp32 tensor maps, the 3xTF32 split, the
// transposing pass, A operands split in registers, and the m64nNk8
// .f32.tf32.tf32 wgmma.
//
// 3xTF32. A tensor core reads an fp32 operand as TF32 (10 mantissa bits), so
// one product is good to about 5e-4, beyond fp32's 1e-4 limit. Each operand x
// is split into big = tf32(x) and small = tf32(x - big), both rounded to
// nearest by tf32_round, so both are exact TF32 values (low 13 bits zero)
// and it does not matter which bits the tensor core reads. A product a·b is
// summed as a_s·b_b + a_b·b_s, then + a_b·b_b, in the fp32 accumulator: x -
// big - small is below 2^-23 |x| and the dropped a_s·b_s below 2^-22 |a| |b|.
// Three TF32 products at 495 TFLOP/s are ~165 TFLOP/s of fp32-exact work,
// against 67 on the CUDA cores.
//
// Tiles. An fp32 tile is a stack of "halves" of R rows x 32 fp32 (128 bytes
// a row), one per 32 columns, with the 128-byte swizzle (16-byte chunk c of
// row r at chunk c ^ (r % 8), sw_off): flash_sm90.cuh's bf16 halves measured
// in bytes. A tf32 k8 step is 32 bytes, as a bf16 k16 step is, so desc_k
// reads a K-major k8 step of an fp32 tile as it reads a bf16 k16 step (kk
// counts k8 steps here). TMA writes that layout from boxes of 32 columns.
//
// Operand layout. TF32 wgmma reads both shared-memory operands K-major only
// (there is no transpose bit), so a product whose B operand is stored
// MN-major (P·V, Pᵀ·dO, dSᵀ·q_s, dS·K) reads a transposed copy that the
// producer warpgroup writes (transpose_split): DP rows of the head dim, the
// source rows as columns (32 of them a half; fewer are used when a tile has
// fewer rows).
//
// A operands in registers. P, Pᵀ, dS and dSᵀ come out of a product as m64nN
// accumulator fragments: a thread holds columns 2 tq and 2 tq + 1 of each
// 8-column step (tq = lane % 4), where the TF32 A fragment holds columns tq
// and tq + 4. Instead of shuffling, the k index is permuted: register j of k
// step kk takes the accumulator element acc_to_tf32_a names, and the
// transposed B tile puts source row 8 g + p at column kcol(8 g + p) = 8 g +
// p / 2 + 4 (p % 2), so both sides agree on which k each term pairs.
//
// Head dims above 128 (the "wide" kernels). Two parts of every operand do
// not fit: at D = 256 a 64-row fp32 tile is 64 KB a part. So an operand
// used as A is kept once, as TMA landed it, and each thread loads its A
// fragment of a k8 step from the swizzled tile and splits it in registers
// (tile_a_split; with a transposing access, tile_at, where the product is
// computed transposed so that the transposed side is the A operand: dVᵀ +=
// dOᵀ·P instead of dV += Pᵀ·dO). Only B operands hold both parts in shared
// memory, and no transposed copy is made but the forward's Vᵀ.
#pragma once

#include "flash_sm90.cuh"

namespace fat {
namespace sm90 {

// ---------------------------------------------------------------------------
// Host: fp32 tensor maps
// ---------------------------------------------------------------------------

constexpr int kHalf32 = 32;  // fp32 columns of a 128-byte tile row

// Map of a contiguous fp32 tensor (planes, rows, cols), 16-byte aligned,
// cols % 4 == 0, read in boxes of `box_rows` rows x 32 columns with the
// 128-byte swizzle. Returns a CUDA error code.
inline cudaError_t make_map32(CUtensorMap* m, const void* base, int planes,
                              int rows, int cols, int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || cols % 4 != 0) {
    return cudaErrorInvalidValue;
  }
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 4,
                                 (cuuint64_t)cols * rows * 4};
  const cuuint32_t box[3] = {kHalf32, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = enc(
      m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Rows of a box for a tile of R rows: the map and the loads must agree.
template <int R>
__host__ __device__ constexpr int box_rows() {
  return R < 64 ? R : 64;
}

// ---------------------------------------------------------------------------
// Device: tiles
// ---------------------------------------------------------------------------

// Rows [row, row + R) of `plane`, all DP columns, into the fp32 tile at
// `dst` (DP / 32 halves of R x 32). R * DP * 4 bytes complete on `bar`.
template <int R, int DP>
__device__ __forceinline__ void tma_tile32(char* dst, const CUtensorMap* map,
                                           uint64_t* bar, int row,
                                           int plane) {
  constexpr int BOX = box_rows<R>();
#pragma unroll
  for (int hf = 0; hf < DP / kHalf32; ++hf) {
#pragma unroll
    for (int rb = 0; rb < R / BOX; ++rb) {
      tma_load(dst + (hf * R + rb * BOX) * 128, map, bar, hf * kHalf32,
               row + rb * BOX, plane);
    }
  }
}

// Rows [row, row + R) of `plane`, all DP columns, fetched into L2 (no
// shared memory, no barrier): the next step's tile while this one runs.
template <int R, int DP>
__device__ __forceinline__ void tma_prefetch32(const CUtensorMap* map, int row,
                                               int plane) {
  constexpr int BOX = box_rows<R>();
#pragma unroll
  for (int hf = 0; hf < DP / kHalf32; ++hf) {
#pragma unroll
    for (int rb = 0; rb < R / BOX; ++rb) {
      asm volatile(
          "cp.async.bulk.prefetch.tensor.3d.L2.global.tile [%0, {%1, %2, %3}];"
          ::"l"(reinterpret_cast<uint64_t>(map)), "r"(hf * kHalf32),
          "r"(row + rb * BOX), "r"(plane)
          : "memory");
    }
  }
}

// Byte offset of element (r, c) of an R-row fp32 tile, c a multiple of 4.
template <int R>
__device__ __forceinline__ int sw_off(int r, int c) {
  return (c >> 5) * R * 128 + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4);
}

// Column of source row k in a transposed tile (see the header comment).
__device__ __forceinline__ int kcol(int k) {
  return (k & ~7) + ((k & 7) >> 1) + 4 * (k & 1);
}

// x rounded to the nearest TF32 value, ties away from zero: the low 13 bits
// cleared after adding half of their range.
__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

__device__ __forceinline__ void split4(float4 x, float scale, float4& big,
                                       float4& small) {
  const float v[4] = {x.x * scale, x.y * scale, x.z * scale, x.w * scale};
  float b[4], s[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    b[j] = tf32_round(v[j]);
    s[j] = tf32_round(v[j] - b[j]);
  }
  big = make_float4(b[0], b[1], b[2], b[3]);
  small = make_float4(s[0], s[1], s[2], s[3]);
}

// Element j (a constant once unrolled) of a float4.
__device__ __forceinline__ float elem(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// The tile at `src` (`bytes`, a multiple of 16) times `scale`, split into
// `big` and `small` at the same offsets (big may be src: in place), thread
// tid of n.
__device__ __forceinline__ void split_tile(const char* src, char* big,
                                           char* small, int bytes, float scale,
                                           int tid, int n) {
  for (int i = tid * 16; i < bytes; i += n * 16) {
    float4 b, s;
    split4(*reinterpret_cast<const float4*>(src + i), scale, b, s);
    *reinterpret_cast<float4*>(big + i) = b;
    *reinterpret_cast<float4*>(small + i) = s;
  }
}

// The R-row x DP-column tile at `src` times `scale`, transposed and split
// into the DP-row tiles `big` and `small`: source row k goes to column
// kcol(k), so the source rows 8 g + p + 2 m (m = 0..3) of one parity p land
// in the four adjacent columns 8 g + 4 p + m. Thread tid of n takes such a
// 4-row unit at 4 columns (16 values) at a time.
template <int R, int DP>
__device__ __forceinline__ void transpose_split(const char* src, char* big,
                                                char* small, float scale,
                                                int tid, int n) {
  constexpr int UNITS = R / 4;  // (g, p) pairs
  for (int u = tid; u < UNITS * (DP / 4); u += n) {
    const int kq = u % UNITS, c = 4 * (u / UNITS);
    const int k0 = 8 * (kq >> 1) + (kq & 1);
    float4 x[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      x[m] = *reinterpret_cast<const float4*>(src +
                                              sw_off<R>(k0 + 2 * m, c));
    }
    const int col = 8 * (kq >> 1) + 4 * (kq & 1);
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      float4 b, s;
      split4(make_float4(elem(x[0], dd), elem(x[1], dd), elem(x[2], dd),
                         elem(x[3], dd)),
             scale, b, s);
      const int at = sw_off<DP>(c + dd, col);
      *reinterpret_cast<float4*>(big + at) = b;
      *reinterpret_cast<float4*>(small + at) = s;
    }
  }
}

// Shared-memory bytes of a transposed tile of R source rows: DP rows x 32
// columns a half, ceil(R / 32) halves.
template <int R, int DP>
__host__ __device__ constexpr int transposed_bytes() {
  return ((R + kHalf32 - 1) / kHalf32) * DP * 128;
}

// ---------------------------------------------------------------------------
// Register A operands
// ---------------------------------------------------------------------------

// An m64nN fp32 accumulator fragment as the split TF32 A operands of N / 8
// k steps. Step kk's registers hold (row g, k tq), (g + 8, tq), (g, tq + 4),
// (g + 8, tq + 4) of the A layout; they take the accumulator's columns 2 tq,
// 2 tq, 2 tq + 1, 2 tq + 1 of the step (elements 4 kk + 0, 2, 1, 3), the
// column order kcol gives the transposed B tiles.
template <int N>
__device__ __forceinline__ void acc_to_tf32_a(const float (&f)[N / 2],
                                              uint32_t (&big)[N / 8][4],
                                              uint32_t (&small)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    const float v[4] = {f[4 * kk], f[4 * kk + 2], f[4 * kk + 1],
                        f[4 * kk + 3]};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float b = tf32_round(v[j]);
      big[kk][j] = __float_as_uint(b);
      small[kk][j] = __float_as_uint(tf32_round(v[j] - b));
    }
  }
}

// Byte offset of element (r, c) of an R-row fp32 tile, any c.
template <int R>
__device__ __forceinline__ int sw_off1(int r, int c) {
  return sw_off<R>(r, c) + ((c & 3) << 2);
}

__device__ __forceinline__ void split1(float x, uint32_t& big,
                                       uint32_t& small) {
  const float b = tf32_round(x);
  big = __float_as_uint(b);
  small = __float_as_uint(tf32_round(x - b));
}

// The split TF32 A fragment of k8 step kk for rows [row0, row0 + 64) of the
// R-row fp32 tile `a` as TMA landed it (row-major, K-major as A), times
// `scale`: thread t holds (row g, k tq), (g + 8, tq), (g, tq + 4),
// (g + 8, tq + 4) of its warp's 16 rows (g = lane / 4, tq = lane % 4).
// The eight lanes of a row group read eight distinct 16-byte chunks, so
// the four loads are free of bank conflicts.
template <int R>
__device__ __forceinline__ void tile_a_split(const char* a, int row0, int kk,
                                             float scale, int t,
                                             uint32_t (&big)[4],
                                             uint32_t (&small)[4]) {
  const int r = row0 + 16 * (t >> 5) + ((t & 31) >> 2);
  const int c = 8 * kk + (t & 3);
  const int at[4] = {sw_off1<R>(r, c), sw_off1<R>(r + 8, c),
                     sw_off1<R>(r, c + 4), sw_off1<R>(r + 8, c + 4)};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    split1(*reinterpret_cast<const float*>(a + at[j]) * scale, big[j],
           small[j]);
  }
}

// The TF32 A fragment of k8 step kk of Xᵀ, rows [m0, m0 + 64): A[m][k] =
// X[k][m], X the R-row fp32 tile pair (xb, xs) already split (k runs over
// X's rows, m over its columns). Both parts are loaded as they are.
template <int R>
__device__ __forceinline__ void tile_at(const char* xb, const char* xs,
                                        int m0, int kk, int t,
                                        uint32_t (&big)[4],
                                        uint32_t (&small)[4]) {
  const int m = m0 + 16 * (t >> 5) + ((t & 31) >> 2);
  const int k = 8 * kk + (t & 3);
  const int at[4] = {sw_off1<R>(k, m), sw_off1<R>(k, m + 8),
                     sw_off1<R>(k + 4, m), sw_off1<R>(k + 4, m + 8)};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    big[j] = *reinterpret_cast<const uint32_t*>(xb + at[j]);
    small[j] = *reinterpret_cast<const uint32_t*>(xs + at[j]);
  }
}

// x0, x1 split into the two-part tile (big, small) at byte offset `at`
// (8-byte aligned: an even column).
__device__ __forceinline__ void store_split2(char* big, char* small, int at,
                                             float x0, float x1) {
  uint32_t b0, s0, b1, s1;
  split1(x0, b0, s0);
  split1(x1, b1, s1);
  *reinterpret_cast<uint2*>(big + at) = make_uint2(b0, b1);
  *reinterpret_cast<uint2*>(small + at) = make_uint2(s0, s1);
}

// Keeps A-operand registers alive (and unchanged) until the wgmma that
// reads them has been waited for.
template <int KS>
__device__ __forceinline__ void keep_regs(uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[kk][j])::"memory");
  }
}

// ---------------------------------------------------------------------------
// wgmma, tf32
// ---------------------------------------------------------------------------

// D (64 x 16, fp32) {+}= A (64 x 8) * B (8 x 16), tf32, A and B K-major in
// shared memory (descriptors); D += only where scale_d != 0.
__device__ __forceinline__ void wgmma_tf32_ss_n16(float (&d)[8], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 32, fp32) {+}= A (64 x 8) * B (8 x 32), tf32, A and B K-major in
// shared memory (descriptors); D += only where scale_d != 0.
__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[16], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, fp32) {+}= A (64 x 8) * B (8 x 64), tf32, A and B K-major in
// shared memory (descriptors); D += only where scale_d != 0.
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 16, fp32) += A (64 x 8, tf32 registers in the A layout) *
// B (8 x 16); B K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_rs_n16(float (&d)[8],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// D (64 x 32, fp32) += A (64 x 8, tf32 registers in the A layout) *
// B (8 x 32); B K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[16],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// D (64 x 64, fp32) += A (64 x 8, tf32 registers in the A layout) *
// B (8 x 64); B K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// D (64 x 128, fp32) += A (64 x 8, tf32 registers in the A layout) *
// B (8 x 128); B K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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

template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t da,
                                              uint64_t db, int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64, "wgmma_tf32_ss: N is 16-64");
  if constexpr (N == 16) {
    wgmma_tf32_ss_n16(d, da, db, scale_d);
  } else if constexpr (N == 32) {
    wgmma_tf32_ss_n32(d, da, db, scale_d);
  } else {
    wgmma_tf32_ss_n64(d, da, db, scale_d);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128,
                "wgmma_tf32_rs: N is 16-128");
  if constexpr (N == 16) {
    wgmma_tf32_rs_n16(d, a, db);
  } else if constexpr (N == 32) {
    wgmma_tf32_rs_n32(d, a, db);
  } else if constexpr (N == 64) {
    wgmma_tf32_rs_n64(d, a, db);
  } else {
    wgmma_tf32_rs_n128(d, a, db);
  }
}

// D += A·B over k8 step kk, A in registers, B k8 step kk of the N-row
// K-major tile `bt`. N = 256 (the head dim 256 accumulators) is two n128
// products over the fragment's halves (elements 0-63 hold columns 0-127)
// and the tile's rows 0-127 and 128-255.
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs_tile(float (&d)[N / 2],
                                                   const uint32_t (&a)[4],
                                                   const char* bt, int kk) {
  if constexpr (N == 256) {
    wgmma_tf32_rs_n128(*reinterpret_cast<float(*)[64]>(d), a,
                       desc_k<256>(bt, 0, kk));
    wgmma_tf32_rs_n128(*reinterpret_cast<float(*)[64]>(d + 64), a,
                       desc_k<256>(bt, 128, kk));
  } else {
    wgmma_tf32_rs<N>(d, a, desc_k<N>(bt, 0, kk));
  }
}

// D = A·Bᵀ in 3xTF32 over KS k8 steps: A is rows [row0, row0 + 64) of the
// RA-row tile pair (ab, as), B the RB-row tile pair (bb, bs), both K-major;
// N = RB. Issues the 3 KS wgmmas (small terms first); the caller fences,
// commits and waits.
template <int RA, int RB, int KS>
__device__ __forceinline__ void mma3_ss(float (&d)[RB / 2], const char* ab,
                                        const char* as, int row0,
                                        const char* bb, const char* bs) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    wgmma_tf32_ss<RB>(d, desc_k<RA>(as, row0, kk), desc_k<RB>(bb, 0, kk),
                      kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    wgmma_tf32_ss<RB>(d, desc_k<RA>(ab, row0, kk), desc_k<RB>(bs, 0, kk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    wgmma_tf32_ss<RB>(d, desc_k<RA>(ab, row0, kk), desc_k<RB>(bb, 0, kk), 1);
  }
}

// D += A·B in 3xTF32 over KS k8 steps: A the split register operands (ab,
// as), B the N-row transposed tile pair (bb, bs), K-major.
template <int N, int KS>
__device__ __forceinline__ void mma3_rs(float (&d)[N / 2],
                                        const uint32_t (&ab)[KS][4],
                                        const uint32_t (&as)[KS][4],
                                        const char* bb, const char* bs) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) wgmma_tf32_rs_tile<N>(d, as[kk], bb, kk);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) wgmma_tf32_rs_tile<N>(d, ab[kk], bs, kk);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) wgmma_tf32_rs_tile<N>(d, ab[kk], bb, kk);
}

// D_m += A_m·B in 3xTF32 for M accumulators that share the B tile pair
// (bb, bs) (N-row, K-major): A_m the split register operands of KS k8
// steps. The accumulators' wgmmas alternate, so M chains run at once. The
// caller fences, commits and waits.
template <int N, int KS, int M>
__device__ __forceinline__ void mma3_rs_m(float (&d)[M][N / 2],
                                          const uint32_t (&ab)[M][KS][4],
                                          const uint32_t (&as)[M][KS][4],
                                          const char* bb, const char* bs) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int m = 0; m < M; ++m) wgmma_tf32_rs_tile<N>(d[m], as[m][kk], bb, kk);
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int m = 0; m < M; ++m) wgmma_tf32_rs_tile<N>(d[m], ab[m][kk], bs, kk);
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int m = 0; m < M; ++m) wgmma_tf32_rs_tile<N>(d[m], ab[m][kk], bb, kk);
  }
}

// D += A·Bᵀ in 3xTF32 over KS k8 steps: A rows [0, 64) of the RA-row fp32
// tile `a` as TMA landed it, times `scale`, split in registers
// (tile_a_split); B the N-row tile pair (bb, bs), K-major. The steps go in
// groups of GS, one commit each, with the A registers of NB groups live
// (the oldest group is waited for before its registers are loaded again).
// Fences first; waits for every product before it returns.
template <int RA, int N, int KS, int GS, int NB>
__device__ __forceinline__ void mma3_ra(float (&d)[N / 2], const char* a,
                                        float scale, const char* bb,
                                        const char* bs, int t) {
  static_assert(KS % GS == 0, "mma3_ra: groups of GS k8 steps");
  static_assert(NB == 1 || NB == 2, "mma3_ra: one or two register sets");
  uint32_t ab[NB][GS][4], as[NB][GS][4];
#pragma unroll
  for (int g = 0; g < KS / GS; ++g) {
    const int sl = g % NB;
    if (g >= NB) {
      wgmma_wait<NB - 1>();
      keep_regs(ab[sl]);
      keep_regs(as[sl]);
    }
#pragma unroll
    for (int j = 0; j < GS; ++j) {
      tile_a_split<RA>(a, 0, g * GS + j, scale, t, ab[sl][j], as[sl][j]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < GS; ++j) {  // small terms first
      wgmma_tf32_rs_tile<N>(d, as[sl][j], bb, g * GS + j);
    }
#pragma unroll
    for (int j = 0; j < GS; ++j) {
      wgmma_tf32_rs_tile<N>(d, ab[sl][j], bs, g * GS + j);
    }
#pragma unroll
    for (int j = 0; j < GS; ++j) {
      wgmma_tf32_rs_tile<N>(d, ab[sl][j], bb, g * GS + j);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(d);
#pragma unroll
  for (int sl = 0; sl < NB; ++sl) {
    keep_regs(ab[sl]);
    keep_regs(as[sl]);
  }
}

// Byte offset of thread t's 16-byte hand-over slot in columns 16-23 of a
// 64-row fp32 tile of 32 columns whose products read columns 0-15 only.
__device__ __forceinline__ int xchg_off(int t) {
  return sw_off<64>(t >> 1, 16 + 4 * (t & 1));
}

// ---------------------------------------------------------------------------
// The wide kernels' shapes (128 < D <= 256), shared by the dense kernels
// (flash_fwd.cu, flash_bwd.cu) and the block-sparse ones (sparse_fwd.cu,
// sparse_bwd.cu), which walk lists on the same schedules
// ---------------------------------------------------------------------------

// Forward: one consumer warpgroup of 64 query rows; K/V tiles of 32 keys.
// Shared memory at 1 KB a fp32 row of 256: Q as landed (64 KB, the A
// operand of S = Q·Kᵀ, split in registers k8 step by k8 step), then one
// stage of K big (where TMA lands it, split in place) and small (64 KB), V
// as landed (32 KB) and Vᵀ big and small (64 KB), which P·V reads K-major:
// 224 KB. K and V have barriers of their own, so that K's next tile loads
// while P·V runs and V's while S runs.
template <int DP>
struct FwdWideCfg {
  static constexpr int ROWS = 64, KEYS = 32, THREADS = 256;
  // S: groups of 8 k8 steps, one register set (mma3_ra)
  static constexpr int GS = 8, NB = 1;
  static constexpr int Q_BYTES = ROWS * DP * 4;  // as landed
  static constexpr int T_BYTES = KEYS * DP * 4;  // K, V or Vᵀ, one part
  static_assert(transposed_bytes<KEYS, DP>() == T_BYTES, "Vᵀ tile size");
  static constexpr int BARS = 7;
  static constexpr size_t SMEM = 1024 + Q_BYTES + 5 * T_BYTES + 8 * BARS;
};

// Backward, dK/dV: 64 keys a CTA, K and V as landed (128 KB); per step of
// R = 16 query rows q and dO in two parts (64 KB), P_vᵀ and dSᵀ in two
// parts (32 KB): 224 KB (flash_bwd.cu's header of the wide pair).
template <int DP>
struct DkvWideCfg {
  static constexpr int KEYS = 64, R = 16, THREADS = 384;
  static constexpr int GS = 2, NB = 2;  // Sᵀ, dPᵀ k8 steps (mma3_ra)
  static constexpr int KV_BYTES = KEYS * DP * 4;  // K or V as landed
  static constexpr int T_BYTES = R * DP * 4;      // q_s or dO, one part
  static constexpr int X_BYTES = KEYS * kHalf32 * 4;  // P_vᵀ or dSᵀ, a part
  static constexpr int BARS = 4;
  static constexpr size_t SMEM = 1024 + 2 * KV_BYTES + 4 * T_BYTES +
                                 4 * X_BYTES + 2 * R * 4 + 8 * BARS;
};

// Backward, dQ: 64 query rows a CTA, q and dO as landed (128 KB); per step
// of 16 keys K and V in two parts (64 KB), dS in two parts (16 KB): 208 KB.
template <int DP>
struct DqWideCfg {
  static constexpr int ROWS = 64, KEYS = 16, THREADS = 384;
  static constexpr int GS = 8, NB = 1;  // S, dP k8 steps (mma3_ra)
  static constexpr int Q_BYTES = ROWS * DP * 4;  // q or dO as landed
  static constexpr int T_BYTES = KEYS * DP * 4;  // K or V, one part
  static constexpr int X_BYTES = ROWS * kHalf32 * 4;  // dS, one part
  static constexpr int BARS = 3;
  static constexpr size_t SMEM =
      1024 + 2 * Q_BYTES + 4 * T_BYTES + 2 * X_BYTES + 8 * BARS;
};

// The hand-over of the wide backward kernels' product split: consumer HF
// holds fragment `mine` (64 rows x 16 columns: Sᵀ or S on consumer 0, dPᵀ
// or dP on consumer 1) and takes its elements [4 HF, 4 HF + 4) (columns
// 8 HF .. 8 HF + 7). It writes the other consumer's four elements into its
// slot of its tile (xchg_off: consumer 0 writes into x0, consumer 1 into
// x1), and after named barrier 2 reads the other product's values at its
// own four elements into `theirs`. HF is a constant, so no register array
// is indexed at run time.
template <int HF>
__device__ __forceinline__ void hand_over(const float (&mine)[8],
                                          float (&theirs)[4], char* x0,
                                          char* x1, int t) {
  constexpr int GIVE = 4 * (1 - HF);
  const int at = xchg_off(t);
  *reinterpret_cast<float4*>((HF == 0 ? x0 : x1) + at) =
      make_float4(mine[GIVE], mine[GIVE + 1], mine[GIVE + 2],
                  mine[GIVE + 3]);
  named_sync(2, 256);
  const float4 v = *reinterpret_cast<const float4*>((HF == 0 ? x1 : x0) + at);
  theirs[0] = v.x;
  theirs[1] = v.y;
  theirs[2] = v.z;
  theirs[3] = v.w;
}

// Register split of the fp32 kernels' blocks of two consumer warpgroups:
// 72 + 2 x 216 registers of a 384-thread block fit the SM's 64K (the
// producer's splitting and transposing needs more than the bf16 kernels'
// 24, and spilled at 56 in the dK/dV kernel; the consumers' fragments need
// less than their 240).
constexpr int kProducerRegs32 = 72;
constexpr int kConsumerRegs32 = 216;
// The wide backward kernels' split: their producer only splits tiles in
// place (no transposing pass), and a dK/dV consumer holds 128 accumulator
// registers beside 64 of A fragments: 40 + 2 x 232. The three warpgroups
// together stay at 64,512 registers, as every split here does: at the
// SM's full 65,536 (32 + 2 x 240) setmaxnreg.inc never returned on the
// card and the kernel hung.
constexpr int kProducerRegsWide = 40;
constexpr int kConsumerRegsWide = 232;

// The producer warpgroup: thread 0 issues TMA; warps 1-3 split and
// transpose landed tiles.
constexpr int kPrepThreads = 96;

// Blocks of 256 threads for n4 float4s: one each, at most 16 a SM.
inline int stream_blocks(size_t n4) {
  const size_t want = (n4 + 255) / 256;
  return (int)(want < 132 * 16 ? want : 132 * 16);
}

}  // namespace sm90
}  // namespace fat
