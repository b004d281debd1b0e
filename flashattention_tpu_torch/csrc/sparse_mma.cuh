// Shared by the mma routes of sparse_fwd.cu and sparse_bwd.cu (blocks that
// are not both multiples of 64: bf16 on m16n8k16, fp32 in 3xTF32 on
// m16n8k8): the 16-row unit of work, the walks that anchor every tile at a
// block's start, the ldmatrix lane maps, the copies of row tiles into
// shared memory and the fp32 route's split products.
//
// The unit of work is a 16-row slice anchored at a block's start: q block
// iq's slice s holds rows iq * block_q + 16 s .. + 15 and never crosses
// into the next block, so it follows its own block's list; rows past the
// block's end (or past Nq) are zero, masked and never stored. Keys are
// walked the same way, in sub-tiles anchored at each active KV block's
// start; keys past the block's end (or Nk) are zero and masked. Any block
// size works; one that is a multiple of 16 wastes nothing. Tiles land by
// cp.async, 16 bytes a lane, at tc_row_bytes(D) a row for bf16
// (mma_sync.cuh) or f32_row_bytes(D) for fp32; in bf16 a 16-column block
// at or past D reads a zero row instead (D % 8 == 0, so an 8-column block
// is wholly inside or wholly past it), in fp32 a k8 step is 8 columns and
// the steps past D are skipped.
//
// fp32 (3xTF32, tf32_sm90.cuh): every operand is split in registers into
// big = tf32(x) and small = tf32(x - big) where a warp reads it, and each
// product is a_s.b_b + a_b.b_s, then + a_b.b_b, three m16n8k8 mma.sync.
// ldmatrix moves 16-bit elements, and its .trans form would cut an fp32
// apart, so the B operands stored MN-major (V in P.V, dO in P^T.dO, q in
// dS^T.q, K in dS.K) are read by 32-bit shared loads. The k index of those
// products is permuted as in tf32_sm90.cuh (kcol, acc_to_tf32_a): an
// accumulator fragment of P or dS becomes the A fragment {c0, c2, c1, c3}
// with no shuffle, its k = tq standing for column 2 tq and k = tq + 4 for
// 2 tq + 1, so the B fragment of k step j reads rows 8 j + 2 tq and
// 8 j + 2 tq + 1 at column g (f32_b).
#pragma once

#include "flash_common.cuh"
#include "mma_sync.cuh"
#include "sparse_sm90.cuh"
#include "tf32_sm90.cuh"

namespace fat {
namespace mma {

using sm90::kept;
using sm90::smem_u32;

constexpr int kSlice = 16;    // rows of a slice: M of m16n8k16
constexpr int kMaxWarps = 4;  // warps (slices) a CTA
// Stages of every mma kernel's ring: the shared memory of a third stage
// cost more resident CTAs than it hid (scripts/sparse_mma_variants.py).
constexpr int kStages = 2;

// The warps of a CTA for `units` units of one block: one a unit, up to 4.
__host__ __device__ constexpr int cta_warps(int units) {
  return units < kMaxWarps ? units : kMaxWarps;
}

// ldmatrix lane maps (mma_sync.cuh). A operand from a row-major tile
// (rows = M, columns = K), and the .trans B operand from a tile whose rows
// are K: the lane's row and column offsets inside the 16 x 16 block.
__device__ __forceinline__ int a_row(int lane) {
  return (lane & 7) + 8 * ((lane >> 3) & 1);
}
__device__ __forceinline__ int a_col(int lane) { return 8 * (lane >> 4); }
// The B operand from a tile whose rows are N (two n8 tiles of 16 rows).
__device__ __forceinline__ int b_row(int lane) {
  return (lane & 7) + 8 * (lane >> 4);
}
__device__ __forceinline__ int b_col(int lane) { return 8 * ((lane >> 3) & 1); }

// The walk of one q block's list (forward, dQ) in KEYS-key sub-tiles, each
// anchored at an active KV block's start, up to `stop` (the causal stop of
// the CTA's last row, else Nk), `passes` times over (the forward's max pass
// and its softmax pass). Every thread walks it alike, the loads a few steps
// ahead of the products.
struct KeyWalk {
  const int32_t* blocks;
  int n, block_k, Nk, stop, keys, passes;
  int w, c0, pass;  // the current sub-tile: list entry, first key, pass
  __device__ __forceinline__ int end() const {  // this KV block's keys end
    return min(blocks[w] * block_k + block_k, Nk);
  }
  __device__ __forceinline__ bool done() const { return pass >= passes; }
  // The first sub-tile of list entry w_ or a later one, in pass p or later.
  __device__ __forceinline__ void seek(int w_, int p) {
    for (; p < passes; ++p, w_ = 0) {
      for (; w_ < n; ++w_) {
        const int lo = blocks[w_] * block_k;
        if (lo < min(min(lo + block_k, Nk), stop)) {
          w = w_;
          c0 = lo;
          pass = p;
          return;
        }
      }
    }
    pass = passes;
  }
  __device__ __forceinline__ void next() {
    c0 += keys;
    if (c0 >= min(end(), stop)) seek(w + 1, pass);
  }
};

__device__ __forceinline__ KeyWalk key_walk(const AttnArgs& a,
                                            const int32_t* list, int n,
                                            int block_k, int r_last, int keys,
                                            int passes) {
  KeyWalk k{list, n, block_k, a.Nk,
            a.causal ? r_last + a.offset + 1 : a.Nk, keys, passes, 0, 0, 0};
  k.seek(0, 0);
  return k;
}

// The dK/dV walk of one KV block: its entries e = g * n + w (query head g of
// the GQA group, entry w of the transposed list of n q blocks) from e to
// e_end (a CTA's chunk of them), each q block in 16-row steps anchored at
// its start, from the first step that holds a row at or past r_min
// (causal: the first row that sees the CTA's first key).
struct RowWalk {
  const int32_t* blocks;
  int n, block_q, Nq, r_min, e_end;
  int e, r0;  // the current step: entry, first row
  __device__ __forceinline__ int g() const { return e / n; }
  __device__ __forceinline__ int r_hi() const {  // this q block's rows end
    return min(blocks[e % n] * block_q + block_q, Nq);
  }
  __device__ __forceinline__ bool done() const { return e >= e_end; }
  __device__ __forceinline__ void seek(int e_) {
    for (; e_ < e_end; ++e_) {
      const int lo = blocks[e_ % n] * block_q;
      const int start =
          r_min > lo ? lo + (r_min - lo) / kSlice * kSlice : lo;
      if (start < min(lo + block_q, Nq)) {
        e = e_;
        r0 = start;
        return;
      }
    }
    e = e_end;
  }
  __device__ __forceinline__ void next() {
    r0 += kSlice;
    if (r0 >= r_hi()) seek(e + 1);
  }
};

// A thread's share of copying row tiles of D columns by cp.async, 16 bytes
// at a time: chunk c of row j first, then `threads` chunks on. Made once a
// kernel, so a copy costs no integer division.
struct RowCopy {
  int cpr, j0, c0, dj, dc;  // chunks a row; first row, chunk; the step
};

// T is the tile's element type (bf16 or fp32), as load_rows takes it.
template <typename T>
__device__ __forceinline__ RowCopy row_copy(int D, int tid, int threads) {
  const int cpr = D * (int)sizeof(T) / 16;
  const int j0 = tid / cpr, dj = threads / cpr;
  return RowCopy{cpr, j0, tid - j0 * cpr, dj, threads - dj * cpr};
}

// `rows` rows from src (row stride D), rows >= n_ok zero-filled, into a tile
// at dst with row stride rs.
template <typename T>
__device__ __forceinline__ void load_rows(const RowCopy& rc, char* dst,
                                          const T* src, int rows, int n_ok,
                                          int rs) {
  constexpr int E = 16 / sizeof(T);  // elements a chunk
  for (int j = rc.j0, c = rc.c0; j < rows;) {
    const bool ok = j < n_ok;
    cp_async16(smem_u32(dst + j * rs + c * 16),
               src + (ok ? (size_t)j * rc.cpr * E + c * E : 0), ok);
    j += rc.dj;
    c += rc.dc;
    if (c >= rc.cpr) {
      c -= rc.cpr;
      ++j;
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 (3xTF32 on m16n8k8)
// ---------------------------------------------------------------------------

// Bytes between two rows of an fp32 tile of D columns (D % 8 == 0): D + 4
// floats, an odd count of 16-byte units, so the 8 rows one ldmatrix reads
// fall in 8 different quads of banks, and the 32-bit reads of f32_b, rows
// 2 tq and 2 tq + 1 at column g, fall in 32 different banks.
__host__ __device__ constexpr int f32_row_bytes(int D) {
  return ((D / 4) | 1) * 16;
}

// A fragment (ldmatrix's four registers, or four accumulator elements) split
// into its TF32 parts.
__device__ __forceinline__ void split_frag(const uint32_t (&x)[4],
                                           uint32_t (&big)[4],
                                           uint32_t (&small)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sm90::split1(__uint_as_float(x[j]), big[j], small[j]);
  }
}

// An m16n8 accumulator fragment (P or dS over 8 keys or rows) as the split
// A fragment of one k8 step: {c0, c2, c1, c3} (see the header comment).
__device__ __forceinline__ void acc_split(const float (&c)[4],
                                          uint32_t (&big)[4],
                                          uint32_t (&small)[4]) {
  const float v[4] = {c[0], c[2], c[1], c[3]};
#pragma unroll
  for (int j = 0; j < 4; ++j) sm90::split1(v[j], big[j], small[j]);
}

// The split B fragment of k step j of an MN-major fp32 tile for the
// permuted k: rows 8 j + 2 tq and 8 j + 2 tq + 1 at column n0 + g, `at`
// being the byte offset of row 8 j + 2 tq, column n0 + g.
__device__ __forceinline__ void f32_b(const char* tile, int at, int rs,
                                      uint32_t (&big)[2],
                                      uint32_t (&small)[2]) {
  sm90::split1(*reinterpret_cast<const float*>(tile + at), big[0], small[0]);
  sm90::split1(*reinterpret_cast<const float*>(tile + at + rs), big[1],
               small[1]);
}

// d += a.b in 3xTF32: a_s.b_b + a_b.b_s, then + a_b.b_b.
__device__ __forceinline__ void mma3_1688(float (&d)[4],
                                          const uint32_t (&ab)[4],
                                          const uint32_t (&as)[4],
                                          uint32_t bb0, uint32_t bb1,
                                          uint32_t bs0, uint32_t bs1) {
  mma_1688(d, as, bb0, bb1);
  mma_1688(d, ab, bs0, bs1);
  mma_1688(d, ab, bb0, bb1);
}

// ---------------------------------------------------------------------------
// The sum of the dK/dV chunks (sparse_bwd.cu, sparse_wide.cu)
// ---------------------------------------------------------------------------

// dK and dV of the KV blocks whose walk took more than one chunk: the sums
// of their chunks' fp32 partials in chunk order, stored as T (the others
// were stored by their one CTA).
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  auto* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[0] = __floats2bfloat162_rn(x.x, x.y);
  p2[1] = __floats2bfloat162_rn(x.z, x.w);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

template <typename T>
__global__ void sparse_bwd_sum_mma_kernel(AttnArgs a,
                                          const float4* __restrict__ part,
                                          const int32_t* __restrict__ q_count,
                                          int block_k, int chunk_len,
                                          T* __restrict__ dk,
                                          T* __restrict__ dv) {
  const size_t n4 = (size_t)a.B * a.H_kv * a.Nk * a.D / 4;
  const int G = a.H / a.H_kv, d4 = a.D / 4;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const int key = (int)(i / d4 % a.Nk);
    const int n_entries = G * q_count[key / block_k];
    if (n_entries <= chunk_len) continue;
    float4 k = part[i], v = part[n4 + i];
    for (int c = 1; c * chunk_len < n_entries; ++c) {
      const float4 pk = part[2 * c * n4 + i], pv = part[(2 * c + 1) * n4 + i];
      k = make_float4(k.x + pk.x, k.y + pk.y, k.z + pk.z, k.w + pk.w);
      v = make_float4(v.x + pv.x, v.y + pv.y, v.z + pv.z, v.w + pv.w);
    }
    store4(dk + 4 * i, k);
    store4(dv + 4 * i, v);
  }
}

}  // namespace mma
}  // namespace fat
