// Block-sparse flash attention above head dim 256 on Hopper (sm_90a): the
// forward (kernel B8) and the backward's dK/dV and dQ kernels (B9, B10) for
// any head dim, bf16 on mma.sync m16n8k16 and fp32 in 3xTF32 on mma.sync
// m16n8k8.
//
// Replaces: flashattention_tpu/ops/pallas_sparse.py, _sparse_fwd_kernel,
// _sparse_bwd_dkv_kernel and _sparse_bwd_dq_kernel, at the head dims above
// 256 that pallas_sparse_attention computes and that the kernels of
// sparse_fwd.cu and sparse_bwd.cu (D <= 256) do not take. Same function,
// lists and rounding points as those (sparse_fwd.cu's header): s = (q . k
// in fp32) * scale in the forward and the backward; in bf16 p rounded at
// each row's final max (two passes over the list), in fp32 one pass with an
// online softmax; dK and dQ unscaled until the store; o = 0 and lse = -inf
// on q blocks with no active KV block, the mask value on a visited block's
// rows that see no key, dK = dV = 0 exactly on KV blocks no q block visits.
//
// What bounds it on this card: the tensor-core rate, as the D <= 256
// kernels (4 D flops per kept (head, row, key) forward, 10 backward, over
// 989 TFLOP/s bf16 or 165 fp32 in 3xTF32).
//
// Design: the mma route's walks (sparse_mma.cuh) with flash_wide.cu's cut
// of the head dim (wide_mma.cuh). The unit of work is the mma route's: a
// 16-row slice anchored at its q block's start, up to 4 slices (of the
// query heads of one KV head) a CTA, all on one list, in the forward and
// dQ; 16 keys of one KV block a warp, up to 4 a CTA, in dK/dV, whose walk
// of (query head, q block) entries is cut into chunks of MMA_CHUNK_STEPS
// 16-row steps over CTAs (ops/sparse_attn._mma_chunks), their fp32
// partials summed in chunk order by sparse_bwd_sum_mma_kernel. Every output
// with D columns (O, dQ, dK, dV) is cut into chunks of DC columns, one CTA a
// chunk (grid y = KV head x [walk chunk x] column chunk): O 128, dQ and
// dK/dV 128 in bf16 and 64 in fp32 (flash_wide.cu's widths, which do not
// spill). Every product that reduces over D (S = Q.K^T, dP = dO.V^T and
// their transposes) runs over all of D in every column chunk's CTA, in
// 64-column segments taken in one order by the same instructions, so the
// CTAs of one slice compute the same scores bit for bit, the same row max
// and the same LSE, and their chunks of O share one normaliser. Tiles
// stream through a ring of wide::kStages stages by cp.async: for each key
// sub-tile (forward, dQ) or 16-row step (dK/dV) of the walk ceil(D / 64)
// segment items, each the 64-column slices of the operands of S (and dP),
// then one chunk item, the DC-column tile that the step's P.V, dS.K,
// P^T.dO or dS^T.q reads (the bf16 forward's first pass, which only takes
// the row max, has no chunk items). Shared memory is the same at every D.
// A warp past its block's end (or past Nq, or a key slice past Nk) still
// takes part in every barrier and ring step, loads nothing of its own and
// stores nothing.

#include <climits>

#include "sparse_mma.cuh"
#include "wide_mma.cuh"

namespace fat {
namespace swide {

using mma::KeyWalk;
using mma::RowWalk;
using mma::kMaxWarps;
using mma::kSlice;
using sm90::kept;
using wide::cmax;
using wide::kBf16;
using wide::kChunkKV;
using wide::kChunkO;
using wide::kChunkQ;
using wide::kSeg;
using wide::kStages;
using wide::kThreadsW;
using wide::load_tile_n;
using wide::row_bytes;
using wide::rs_product;
using wide::seg_product;
using wide::store2;
using wide::zero;

// The items of a list walk (forward, dQ): for each KEYS-key sub-tile of
// each pass, nseg segment items, then, in the last pass only, one chunk
// item.
struct KeyItems {
  KeyWalk w;
  int j, nseg;
  __device__ __forceinline__ bool done() const { return w.done(); }
  __device__ __forceinline__ bool chunk() const { return j == nseg; }
  __device__ __forceinline__ void next() {
    if (++j == nseg + (w.pass == w.passes - 1)) {
      j = 0;
      w.next();
    }
  }
};

// The items of a dK/dV walk: for each 16-row step, nseg segment items and
// one chunk item.
struct RowItems {
  RowWalk w;
  int j, nseg;
  __device__ __forceinline__ bool done() const { return w.done(); }
  __device__ __forceinline__ bool chunk() const { return j == nseg; }
  __device__ __forceinline__ void next() {
    if (++j == nseg + 1) {
      j = 0;
      w.next();
    }
  }
};

// The ring over a walk's items (KeyItems or RowItems), as the mma route
// runs it: `ld` issues kStages - 1 items ahead of the products' cursor;
// before item it's products, every thread waits for it and every warp is
// past item it - 1, whose stage the next issue refills. body(cursor, stage)
// runs each item.
template <typename Items, typename Issue, typename Body>
__device__ __forceinline__ void run_ring(Items ld, Issue&& issue,
                                         Body&& body) {
  Items cw = ld;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (!ld.done()) {
      issue(ld, s);
      ld.next();
    }
    cp_async_commit();
  }
  for (int it = 0; !cw.done(); ++it, cw.next()) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (!ld.done()) {
      issue(ld, (it + kStages - 1) % kStages);
      ld.next();
    }
    cp_async_commit();
    body(cw, it % kStages);
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <typename T, int KEYS>
struct FwdCfg {
  static constexpr int RS = row_bytes<T>(kSeg), RC = row_bytes<T>(kChunkO);
  // segment item: Q (4 slices of 16 rows) and K (KEYS keys), 64 columns;
  // chunk item: V's chunk
  static constexpr int STAGE =
      cmax((kMaxWarps * kSlice + KEYS) * RS, KEYS * RC);
  static constexpr size_t SMEM = (size_t)kStages * STAGE;
};

// One CTA takes W = blockDim.x / 32 units of one q block (unit u: slice
// u / G of query head hk * G + u % G, one warp a unit, as the mma route's
// forward) and O's columns [d_c, d_c + 128).
template <typename T, int KEYS>
__global__ void __launch_bounds__(kThreadsW, 1)
sparse_fwd_wide_kernel(AttnArgs a, const int32_t* __restrict__ kv_list,
                       const int32_t* __restrict__ kv_count, int stride,
                       int block_q, int block_k, T* __restrict__ o,
                       float* __restrict__ lse) {
  using Cfg = FwdCfg<T, KEYS>;
  constexpr bool BF = kBf16<T>;
  constexpr int NT = KEYS / 8, NO = kChunkO / 8;
  constexpr int RS = Cfg::RS, RC = Cfg::RC, STAGE = Cfg::STAGE;
  extern __shared__ __align__(128) char smem[];

  const int W = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int G = a.H / a.H_kv, D = a.D, nch = (D + kChunkO - 1) / kChunkO;
  const int units = (block_q + kSlice - 1) / kSlice * G;
  const int per = (units + W - 1) / W;
  const int n_q_blocks = (a.Nq + block_q - 1) / block_q;
  // heavy first: causal, a later q block sees more keys
  const int iq = n_q_blocks - 1 - blockIdx.x / per;
  const int u0 = blockIdx.x % per * W, u = u0 + warp;
  const int b = blockIdx.z, hk = blockIdx.y / nch;
  const int d_c = blockIdx.y % nch * kChunkO;
  const int r_end = min(iq * block_q + block_q, a.Nq);  // this q block's rows
  const int h = hk * G + u % G;
  const int r0 = iq * block_q + u / G * kSlice;
  const bool live = u < units && r0 < r_end;  // past Nq: nothing to store
  const int r_last = min(iq * block_q + (min(units, u0 + W) - 1) / G * kSlice +
                             kSlice - 1, r_end - 1);
  const int n_active = kv_count[iq];
  const KeyItems items{
      mma::key_walk(a, kv_list + (size_t)iq * stride, n_active, block_k,
                    r_last, KEYS, BF ? 2 : 1),
      0, (D + kSeg - 1) / kSeg};

  const size_t kv_off = ((size_t)b * a.H_kv + hk) * a.Nk * D;
  const T* kg = static_cast<const T*>(a.k) + kv_off;
  const T* vg = static_cast<const T*>(a.v) + kv_off;
  const T* qg = static_cast<const T*>(a.q) +
                (((size_t)b * a.H + h) * a.Nq + (live ? r0 : 0)) * D;

  // Segment item: this warp's 16 rows of Q (its lanes), the sub-tile's K
  // (every thread); chunk item: V's chunk.
  auto issue = [&](const KeyItems& ld, int st) {
    char* s = smem + st * STAGE;
    const int c0 = ld.w.c0, n_ok = ld.w.end() - c0;
    if (!ld.chunk()) {
      const int d0 = ld.j * kSeg;
      if (live) {
        load_tile_n<T, kSeg>(s + warp * kSlice * RS, RS, qg, kSlice,
                             r_end - r0, d0, D, lane, 32);
      }
      load_tile_n<T, kSeg>(s + kMaxWarps * kSlice * RS, RS,
                           kg + (size_t)c0 * D, KEYS, n_ok, d0, D,
                           threadIdx.x, blockDim.x);
    } else {
      load_tile_n<T, kChunkO>(s, RC, vg + (size_t)c0 * D, KEYS, n_ok, d_c,
                              D, threadIdx.x, blockDim.x);
    }
  };

  // bf16: a visited block's row that meets no key keeps the mask value as
  // its max (lse = the mask value); rows of a block with count 0 keep -inf.
  // fp32: masked scores count in the row max as the mask value and give p
  // = 0, so a row whose max is still the mask value when its first kept
  // key arrives drops them exactly (alpha = 0).
  float m[2], l[2] = {0.f, 0.f}, acc[NO][4], sc[NT][4];
  m[0] = m[1] = BF && n_active > 0 ? kMaskValue : -INFINITY;
  zero(acc);
  zero(sc);
  bool reduced = false;  // bf16: the rows' final max, reduced over a quad
  if (!items.done()) {
    run_ring(items, issue, [&](const KeyItems& cw, int st) {
      if (!live) return;
      const char* s = smem + st * STAGE;
      const int c0 = cw.w.c0, c_end = cw.w.end();
      if (!cw.chunk()) {  // S += Q[:, seg] . K[:, seg]^T
        if (cw.j == 0) zero(sc);
        seg_product<T, NT>(sc, s + warp * kSlice * RS,
                           s + kMaxWarps * kSlice * RS, RS, lane);
        if (BF && cw.w.pass == 0 && cw.j == cw.nseg - 1) {
#pragma unroll
          for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int row = r0 + g + 8 * (c >> 1);
              const int col = c0 + 8 * n + 2 * tq + (c & 1);
              if (kept(a, row, col, c_end)) {
                m[c >> 1] = fmaxf(m[c >> 1], sc[n][c] * a.scale);
              }
            }
          }
        }
        return;
      }
      if constexpr (BF) {  // p at the row's final max
        if (!reduced) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            m[r] = fmaxf(m[r], __shfl_xor_sync(kFull, m[r], 1));
            m[r] = fmaxf(m[r], __shfl_xor_sync(kFull, m[r], 2));
          }
          reduced = true;
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int row = r0 + g + 8 * (c >> 1);
            const int col = c0 + 8 * n + 2 * tq + (c & 1);
            const float p = kept(a, row, col, c_end)
                                ? expf(sc[n][c] * a.scale - m[c >> 1])
                                : 0.f;
            l[c >> 1] += p;
            sc[n][c] = p;
          }
        }
      } else {  // the online softmax over the 4 lanes of a row
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int row = r0 + g + 8 * (c >> 1);
            const int col = c0 + 8 * n + 2 * tq + (c & 1);
            const bool vis = kept(a, row, col, c_end);
            const float x = sc[n][c] * a.scale;
            mx[c >> 1] = fmaxf(mx[c >> 1], vis ? x : kMaskValue);
            sc[n][c] = vis ? x : -INFINITY;
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
          const float alpha = expf(m[r] - mx[r]);
          l[r] *= alpha;
          m[r] = mx[r];
#pragma unroll
          for (int dn = 0; dn < NO; ++dn) {
            acc[dn][2 * r] *= alpha;
            acc[dn][2 * r + 1] *= alpha;
          }
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            sc[n][c] = expf(sc[n][c] - m[c >> 1]);
            l[c >> 1] += sc[n][c];
          }
        }
      }
      rs_product<T, NT, NO>(acc, sc, s, RC, lane);  // O[:, chunk] += P . V
    });
  }
  if (!live) return;

  const size_t bh = (size_t)b * a.H + h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    if (!BF && n_active > 0) m[r] = fmaxf(m[r], kMaskValue);
    const int row = r0 + g + 8 * r;
    if (row >= r_end) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    const size_t base = bh * a.Nq + row;
#pragma unroll
    for (int dn = 0; dn < NO; ++dn) {
      const int col = d_c + 8 * dn + 2 * tq;
      if (col < D) {
        store2(o + base * D + col, acc[dn][2 * r] / l_safe,
               acc[dn][2 * r + 1] / l_safe);
      }
    }
    if (d_c == 0 && tq == 0) lse[base] = m[r] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

template <typename T, int KEYS>
struct DqCfg {
  static constexpr int RS = row_bytes<T>(kSeg), RC = row_bytes<T>(kChunkQ<T>);
  // segment item: q and dO (4 slices of 16 rows each), K and V (KEYS
  // keys), 64 columns; chunk item: K's chunk
  static constexpr int STAGE =
      cmax((2 * kMaxWarps * kSlice + 2 * KEYS) * RS, KEYS * RC);
  static constexpr size_t SMEM = (size_t)kStages * STAGE;
};

// The forward's layout over the q block's list: S = q.K^T and dP = dO.V^T
// over all of D, then dQ[:, chunk] += round(ds) . K[:, chunk].
template <typename T, int KEYS>
__global__ void __launch_bounds__(kThreadsW, 1)
sparse_bwd_dq_wide_kernel(AttnArgs a, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ di,
                          const int32_t* __restrict__ kv_list,
                          const int32_t* __restrict__ kv_count, int stride,
                          int block_q, int block_k, T* __restrict__ dq) {
  using Cfg = DqCfg<T, KEYS>;
  constexpr int DC = kChunkQ<T>, NT = KEYS / 8, NO = DC / 8;
  constexpr int RS = Cfg::RS, RC = Cfg::RC, STAGE = Cfg::STAGE;
  constexpr int SQ = kMaxWarps * kSlice;  // rows of the q (and dO) slices
  extern __shared__ __align__(128) char smem[];

  const int W = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int G = a.H / a.H_kv, D = a.D, nch = (D + DC - 1) / DC;
  const int units = (block_q + kSlice - 1) / kSlice * G;
  const int per = (units + W - 1) / W;
  const int n_q_blocks = (a.Nq + block_q - 1) / block_q;
  const int iq = n_q_blocks - 1 - blockIdx.x / per;  // heavy first
  const int u0 = blockIdx.x % per * W, u = u0 + warp;
  const int b = blockIdx.z, hk = blockIdx.y / nch;
  const int d_c = blockIdx.y % nch * DC;
  const int r_end = min(iq * block_q + block_q, a.Nq);
  const int h = hk * G + u % G;
  const int r0 = iq * block_q + u / G * kSlice;
  const bool live = u < units && r0 < r_end;
  const int r_last = min(iq * block_q + (min(units, u0 + W) - 1) / G * kSlice +
                             kSlice - 1, r_end - 1);
  const KeyItems items{
      mma::key_walk(a, kv_list + (size_t)iq * stride, kv_count[iq], block_k,
                    r_last, KEYS, 1),
      0, (D + kSeg - 1) / kSeg};

  const size_t kv_off = ((size_t)b * a.H_kv + hk) * a.Nk * D;
  const T* kg = static_cast<const T*>(a.k) + kv_off;
  const T* vg = static_cast<const T*>(a.v) + kv_off;
  const size_t bh = (size_t)b * a.H + h;
  const size_t q_off = (bh * a.Nq + (live ? r0 : 0)) * D;
  const T* qg = static_cast<const T*>(a.q) + q_off;
  const T* dog = dout + q_off;

  auto issue = [&](const KeyItems& ld, int st) {
    char* s = smem + st * STAGE;
    const int c0 = ld.w.c0, n_ok = ld.w.end() - c0;
    if (!ld.chunk()) {
      const int d0 = ld.j * kSeg;
      if (live) {
        load_tile_n<T, kSeg>(s + warp * kSlice * RS, RS, qg, kSlice,
                             r_end - r0, d0, D, lane, 32);
        load_tile_n<T, kSeg>(s + (SQ + warp * kSlice) * RS, RS, dog, kSlice,
                             r_end - r0, d0, D, lane, 32);
      }
      load_tile_n<T, kSeg>(s + 2 * SQ * RS, RS, kg + (size_t)c0 * D, KEYS,
                           n_ok, d0, D, threadIdx.x, blockDim.x);
      load_tile_n<T, kSeg>(s + (2 * SQ + KEYS) * RS, RS, vg + (size_t)c0 * D,
                           KEYS, n_ok, d0, D, threadIdx.x, blockDim.x);
    } else {
      load_tile_n<T, DC>(s, RC, kg + (size_t)c0 * D, KEYS, n_ok, d_c, D,
                         threadIdx.x, blockDim.x);
    }
  };

  float lse_r[2] = {0.f, 0.f}, di_r[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (live && row < r_end) {
      lse_r[r] = lse[bh * a.Nq + row];
      di_r[r] = di[bh * a.Nq + row];
    }
  }
  float acc[NO][4], sc[NT][4], dp[NT][4];
  zero(acc);
  zero(sc);
  zero(dp);
  if (!items.done()) {
    run_ring(items, issue, [&](const KeyItems& cw, int st) {
      if (!live) return;
      const char* s = smem + st * STAGE;
      if (!cw.chunk()) {  // S += q . K^T, dP += dO . V^T over the segment
        if (cw.j == 0) {
          zero(sc);
          zero(dp);
        }
        seg_product<T, NT>(sc, s + warp * kSlice * RS, s + 2 * SQ * RS, RS,
                           lane);
        seg_product<T, NT>(dp, s + (SQ + warp * kSlice) * RS,
                           s + (2 * SQ + KEYS) * RS, RS, lane);
        return;
      }
      const int c0 = cw.w.c0, c_end = cw.w.end();
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = r0 + g + 8 * (c >> 1);
          const int col = c0 + 8 * n + 2 * tq + (c & 1);
          const float p = row < r_end && kept(a, row, col, c_end)
                              ? expf(sc[n][c] * a.scale - lse_r[c >> 1])
                              : 0.f;
          sc[n][c] = p * (dp[n][c] - di_r[c >> 1]);  // ds
        }
      }
      rs_product<T, NT, NO>(acc, sc, s, RC, lane);  // dQ[:, chunk] += dS . K
    });
  }
  if (!live) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= r_end) continue;
    const size_t base = (bh * a.Nq + row) * D;
#pragma unroll
    for (int dn = 0; dn < NO; ++dn) {
      const int col = d_c + 8 * dn + 2 * tq;
      if (col < D) {
        store2(dq + base + col, acc[dn][2 * r] * a.scale,
               acc[dn][2 * r + 1] * a.scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dK, dV
// ---------------------------------------------------------------------------

template <typename T>
struct DkvCfg {
  static constexpr int RS = row_bytes<T>(kSeg), RC = row_bytes<T>(kChunkKV<T>);
  static constexpr int SK = kMaxWarps * kSlice;  // keys of K (and V)
  // segment item: K and V (4 slices of 16 keys), q and dO (16 rows), 64
  // columns; chunk item: q's and dO's chunks and the step's LSE and di
  static constexpr int STAGE =
      cmax((2 * SK + 2 * kSlice) * RS, 2 * kSlice * RC + 2 * kSlice * 4);
  static constexpr size_t SMEM = (size_t)kStages * STAGE;
};

// One CTA takes up to 4 slices of 16 keys of one KV block (one warp a
// slice), the columns [d_c, d_c + DC) of their dK and dV, and a chunk of
// chunk_len entries of the block's walk (blockIdx.y = (KV head * chunks +
// chunk) * column chunks + column chunk), in 16-row steps: S^T = K.q^T and
// dP^T = V.dO^T over all of D, then dV[:, chunk] += round(p)^T . dO[:,
// chunk] and dK[:, chunk] += round(ds)^T . q[:, chunk]. A walk of one
// chunk stores dK (scaled) and dV in T; else each chunk writes fp32
// partials into `part` ([chunk][dk, dv][B, H_kv, Nk, D]) for
// sparse_bwd_sum_mma_kernel.
template <typename T>
__global__ void __launch_bounds__(kThreadsW, 1)
sparse_bwd_dkv_wide_kernel(AttnArgs a, const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ di,
                           const int32_t* __restrict__ q_list,
                           const int32_t* __restrict__ q_count, int stride,
                           int block_q, int block_k, T* __restrict__ dk,
                           T* __restrict__ dv, float* __restrict__ part,
                           int chunk_len, int chunks) {
  using Cfg = DkvCfg<T>;
  constexpr int DC = kChunkKV<T>, NO = DC / 8;
  constexpr int RS = Cfg::RS, RC = Cfg::RC, STAGE = Cfg::STAGE, SK = Cfg::SK;
  extern __shared__ __align__(128) char smem[];

  const int W = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int G = a.H / a.H_kv, D = a.D, nch = (D + DC - 1) / DC;
  const int per = ((block_k + kSlice - 1) / kSlice + W - 1) / W;
  const int ik = blockIdx.x / per;
  const int c_first = ik * block_k + blockIdx.x % per * W * kSlice;
  const int c_end = min(ik * block_k + block_k, a.Nk);  // this KV block's keys
  if (c_first >= c_end) return;  // the whole CTA past Nk
  const int kb = c_first + warp * kSlice;  // this warp's first key
  const bool live = kb < c_end;
  const int b = blockIdx.z, d_c = blockIdx.y % nch * DC;
  const int hk = blockIdx.y / nch / chunks, chunk = blockIdx.y / nch % chunks;
  const int n = q_count[ik];
  const int e_lo = chunk * chunk_len, n_entries = G * n;
  if (chunk > 0 && e_lo >= n_entries) return;  // chunk 0 stores the zeros
  const bool direct = n_entries <= chunk_len;  // one CTA takes the block
  RowItems items{RowWalk{q_list + (size_t)ik * stride, n, block_q, a.Nq,
                         a.causal ? c_first - a.offset : INT_MIN,
                         min(n_entries, e_lo + chunk_len), 0, 0},
                 0, (D + kSeg - 1) / kSeg};
  items.w.seek(e_lo);

  const size_t kv_off = ((size_t)b * a.H_kv + hk) * a.Nk;
  const T* kg = static_cast<const T*>(a.k) + (kv_off + c_first) * D;
  const T* vg = static_cast<const T*>(a.v) + (kv_off + c_first) * D;

  auto issue = [&](const RowItems& ld, int st) {
    char* s = smem + st * STAGE;
    const size_t row0 =
        ((size_t)b * a.H + hk * G + ld.w.g()) * a.Nq + ld.w.r0;
    const int n_ok = ld.w.r_hi() - ld.w.r0;
    const T* qg = static_cast<const T*>(a.q) + row0 * D;
    const T* dog = dout + row0 * D;
    if (!ld.chunk()) {
      const int d0 = ld.j * kSeg;
      load_tile_n<T, kSeg>(s, RS, kg, W * kSlice, c_end - c_first, d0, D,
                           threadIdx.x, blockDim.x);
      load_tile_n<T, kSeg>(s + SK * RS, RS, vg, W * kSlice, c_end - c_first,
                           d0, D, threadIdx.x, blockDim.x);
      load_tile_n<T, kSeg>(s + 2 * SK * RS, RS, qg, kSlice, n_ok, d0, D,
                           threadIdx.x, blockDim.x);
      load_tile_n<T, kSeg>(s + (2 * SK + kSlice) * RS, RS, dog, kSlice, n_ok,
                           d0, D, threadIdx.x, blockDim.x);
    } else {
      load_tile_n<T, DC>(s, RC, qg, kSlice, n_ok, d_c, D, threadIdx.x,
                         blockDim.x);
      load_tile_n<T, DC>(s + kSlice * RC, RC, dog, kSlice, n_ok, d_c, D,
                         threadIdx.x, blockDim.x);
      if (threadIdx.x < 2 * kSlice) {  // the LSE, then di
        float* ls = reinterpret_cast<float*>(s + 2 * kSlice * RC);
        const int j = threadIdx.x % kSlice;
        const bool ok = j < n_ok;
        cp_async4(sm90::smem_u32(ls + threadIdx.x),
                  (threadIdx.x < kSlice ? lse : di) + row0 + (ok ? j : 0), ok);
      }
    }
  };

  float dka[NO][4], dva[NO][4], st_[2][4], dp[2][4];
  zero(dka);
  zero(dva);
  zero(st_);
  zero(dp);
  if (!items.done()) {
    run_ring(items, issue, [&](const RowItems& cw, int stage) {
      if (!live) return;
      const char* s = smem + stage * STAGE;
      if (!cw.chunk()) {  // S^T += K . q^T, dP^T += V . dO^T (segment)
        if (cw.j == 0) {
          zero(st_);
          zero(dp);
        }
        seg_product<T, 2>(st_, s + warp * kSlice * RS, s + 2 * SK * RS, RS,
                          lane);
        seg_product<T, 2>(dp, s + (SK + warp * kSlice) * RS,
                          s + (2 * SK + kSlice) * RS, RS, lane);
        return;
      }
      const float* ls = reinterpret_cast<const float*>(s + 2 * kSlice * RC);
      const float* dis = ls + kSlice;
      const int r0 = cw.w.r0, r_hi = cw.w.r_hi();
      float pt[2][4], dst[2][4];  // p^T and ds^T (keys x the step's rows)
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = kb + g + 8 * (c >> 1);
          const int rr = 8 * n2 + 2 * tq + (c & 1), row = r0 + rr;
          const float p = row < r_hi && kept(a, row, key, c_end)
                              ? expf(st_[n2][c] * a.scale - ls[rr])
                              : 0.f;
          pt[n2][c] = p;
          dst[n2][c] = p * (dp[n2][c] - dis[rr]);
        }
      }
      rs_product<T, 2, NO>(dva, pt, s + kSlice * RC, RC, lane);
      rs_product<T, 2, NO>(dka, dst, s, RC, lane);
    });
  }
  if (!live) return;

  // A KV block no q block visits stores exact zeros.
  const size_t nk = (size_t)a.B * a.H_kv * a.Nk * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kb + g + 8 * r;
    if (key >= c_end) continue;
    const size_t base = (kv_off + key) * D;
#pragma unroll
    for (int dn = 0; dn < NO; ++dn) {
      const int col = d_c + 8 * dn + 2 * tq;
      if (col >= D) continue;
      const float k0 = dka[dn][2 * r] * a.scale, k1 = dka[dn][2 * r + 1] * a.scale;
      const float v0 = dva[dn][2 * r], v1 = dva[dn][2 * r + 1];
      if (direct) {
        store2(dk + base + col, k0, k1);
        store2(dv + base + col, v0, v1);
      } else {
        float* pk = part + 2 * chunk * nk + base + col;
        *reinterpret_cast<float2*>(pk) = make_float2(k0, k1);
        *reinterpret_cast<float2*>(pk + nk) = make_float2(v0, v1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

// Units (slices of 16 rows of the query heads of one KV head) of a q block,
// and the CTAs of all q blocks, as the mma route's forward and dQ take them.
inline long long q_ctas(const AttnArgs& a, int block_q, int* warps) {
  const int units = (block_q + kSlice - 1) / kSlice * (a.H / a.H_kv);
  *warps = mma::cta_warps(units);
  return (long long)((a.Nq + block_q - 1) / block_q) *
         ((units + *warps - 1) / *warps);
}

template <typename T, int KEYS>
cudaError_t launch_fwd(const AttnArgs& a, const int32_t* list,
                       const int32_t* count, int stride, int block_q,
                       int block_k, void* o, float* lse, cudaStream_t st) {
  auto kernel = sparse_fwd_wide_kernel<T, KEYS>;
  cudaError_t err = set_smem(kernel, FwdCfg<T, KEYS>::SMEM);
  if (err != cudaSuccess) return err;
  int warps;
  const long long ctas = q_ctas(a, block_q, &warps);
  const int nch = (a.D + kChunkO - 1) / kChunkO;
  if (ctas > 0x7fffffff || (long long)a.H_kv * nch > 65535) {
    return cudaErrorInvalidValue;
  }
  kernel<<<dim3((unsigned)ctas, a.H_kv * nch, a.B), 32 * warps,
           FwdCfg<T, KEYS>::SMEM, st>>>(a, list, count, stride, block_q,
                                        block_k, static_cast<T*>(o), lse);
  return cudaGetLastError();
}

// Sub-tiles of 16 keys for blocks of 16 keys or fewer, else 32.
template <typename T>
cudaError_t sparse_fwd_wide(const AttnArgs& a, const int32_t* list,
                            const int32_t* count, int stride, int block_q,
                            int block_k, void* o, float* lse,
                            cudaStream_t st) {
  return block_k <= 16 ? launch_fwd<T, 16>(a, list, count, stride, block_q,
                                           block_k, o, lse, st)
                       : launch_fwd<T, 32>(a, list, count, stride, block_q,
                                           block_k, o, lse, st);
}

template <typename T, int KEYS>
cudaError_t launch_dq(const AttnArgs& a, const int32_t* list,
                      const int32_t* count, int stride, int block_q,
                      int block_k, const T* dout, const float* lse,
                      const float* di, void* dq, cudaStream_t st) {
  auto kernel = sparse_bwd_dq_wide_kernel<T, KEYS>;
  cudaError_t err = set_smem(kernel, DqCfg<T, KEYS>::SMEM);
  if (err != cudaSuccess) return err;
  int warps;
  const long long ctas = q_ctas(a, block_q, &warps);
  const int nch = (a.D + kChunkQ<T> - 1) / kChunkQ<T>;
  if (ctas > 0x7fffffff || (long long)a.H_kv * nch > 65535) {
    return cudaErrorInvalidValue;
  }
  kernel<<<dim3((unsigned)ctas, a.H_kv * nch, a.B), 32 * warps,
           DqCfg<T, KEYS>::SMEM, st>>>(a, dout, lse, di, list, count, stride,
                                       block_q, block_k, static_cast<T*>(dq));
  return cudaGetLastError();
}

// dK/dV (each KV block's walk in chunks of chunk_len entries over up to
// `chunks` CTAs a column chunk, then the sum of the partials where chunks >
// 1), then dQ (sub-tiles of 16 keys for blocks of 16 keys or fewer, else
// 32), on `st`.
template <typename T>
cudaError_t sparse_bwd_wide(const AttnArgs& a, const int32_t* kv_list,
                            const int32_t* kv_count, const int32_t* q_list,
                            const int32_t* q_count, int kv_stride,
                            int q_stride, int block_q, int block_k,
                            const void* dout, const float* lse,
                            const float* di, void* dq, void* dk, void* dv,
                            float* part, int chunk_len, int chunks,
                            cudaStream_t st) {
  auto kernel = sparse_bwd_dkv_wide_kernel<T>;
  cudaError_t err = set_smem(kernel, DkvCfg<T>::SMEM);
  if (err != cudaSuccess) return err;
  const int slices = (block_k + kSlice - 1) / kSlice;
  const int warps = mma::cta_warps(slices);
  const long long ctas = (long long)((a.Nk + block_k - 1) / block_k) *
                         ((slices + warps - 1) / warps);
  const int nch = (a.D + kChunkKV<T> - 1) / kChunkKV<T>;
  if (ctas > 0x7fffffff || (long long)a.H_kv * chunks * nch > 65535) {
    return cudaErrorInvalidValue;
  }
  const T* d_o = static_cast<const T*>(dout);
  kernel<<<dim3((unsigned)ctas, a.H_kv * chunks * nch, a.B), 32 * warps,
           DkvCfg<T>::SMEM, st>>>(a, d_o, lse, di, q_list, q_count, q_stride,
                                  block_q, block_k, static_cast<T*>(dk),
                                  static_cast<T*>(dv), part, chunk_len,
                                  chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (chunks > 1) {
    const size_t n4 = (size_t)a.B * a.H_kv * a.Nk * a.D / 4;
    mma::sparse_bwd_sum_mma_kernel<T><<<sm90::stream_blocks(n4), 256, 0, st>>>(
        a, reinterpret_cast<const float4*>(part), q_count, block_k, chunk_len,
        static_cast<T*>(dk), static_cast<T*>(dv));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return block_k <= 16
             ? launch_dq<T, 16>(a, kv_list, kv_count, kv_stride, block_q,
                                block_k, d_o, lse, di, dq, st)
             : launch_dq<T, 32>(a, kv_list, kv_count, kv_stride, block_q,
                                block_k, d_o, lse, di, dq, st);
}

inline bool bad_shape(int B, int H, int H_kv, int Nq, int Nk, int D,
                      int block_q, int block_k, int stride, int dtype,
                      const void* q, const void* k, const void* v) {
  return dtype < 0 || dtype > 1 || D <= 256 || D % 8 != 0 || H_kv < 1 ||
         H % H_kv != 0 || B < 1 || Nq < 1 || Nk < 1 || B > 65535 ||
         block_q < 1 || block_k < 1 ||
         stride < (Nk + block_k - 1) / block_k ||
         (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
          reinterpret_cast<uintptr_t>(v)) % 16 != 0;
}

}  // namespace swide
}  // namespace fat

extern "C" {

// The forward above D = 256, bf16 (dtype 0) or fp32 (dtype 1): any block_q
// and block_k; D % 8 == 0; q, k and v contiguous and 16-byte aligned
// (cp.async). Same arguments as fat_sparse_fwd in sparse_fwd.cu. Returns
// cudaGetLastError() after the launch.
int fat_sparse_fwd_wide(const void* q, const void* k, const void* v, void* o,
                        void* lse, const void* kv_list, const void* kv_count,
                        int B, int H, int H_kv, int Nq, int Nk, int D,
                        float scale, int causal, int block_q, int block_k,
                        int stride, int dtype, void* stream) {
  using namespace fat;
  if (swide::bad_shape(B, H, H_kv, Nq, Nk, D, block_q, block_k, stride, dtype,
                       q, k, v)) {
    return (int)cudaErrorInvalidValue;
  }
  AttnArgs a{q, k, v, nullptr, nullptr, nullptr, B, H, H_kv, Nq, Nk, D, scale,
             causal, Nk - Nq, 0, 0, 0.f, 0.f, 0, 0u, 0u, 1.f};
  auto st = static_cast<cudaStream_t>(stream);
  const auto* list = static_cast<const int32_t*>(kv_list);
  const auto* count = static_cast<const int32_t*>(kv_count);
  auto* l = static_cast<float*>(lse);
  return (int)(dtype == 0
                   ? swide::sparse_fwd_wide<__nv_bfloat16>(
                         a, list, count, stride, block_q, block_k, o, l, st)
                   : swide::sparse_fwd_wide<float>(a, list, count, stride,
                                                   block_q, block_k, o, l,
                                                   st));
}

// The backward above D = 256: the dK/dV kernel (and the sum of its
// chunks' partials where chunks > 1), then the dQ kernel. The arguments of
// fat_sparse_bwd_mma in sparse_bwd.cu: the last three are the fp32 scratch
// of 2 * chunks * |k| floats (null where chunks == 1), chunk_len and
// chunks from ops/sparse_attn._mma_chunks.
int fat_sparse_bwd_wide(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* di,
                        void* dq, void* dk, void* dv, const void* kv_list,
                        const void* kv_count, const void* q_list,
                        const void* q_count, int B, int H, int H_kv, int Nq,
                        int Nk, int D, float scale, int causal, int block_q,
                        int block_k, int kv_stride, int q_stride, int dtype,
                        void* stream, void* scratch, int chunk_len,
                        int chunks) {
  using namespace fat;
  if (swide::bad_shape(B, H, H_kv, Nq, Nk, D, block_q, block_k, kv_stride,
                       dtype, q, k, v) ||
      q_stride < (Nq + block_q - 1) / block_q || chunk_len < 1 ||
      chunks < 1 || (chunks > 1 && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  AttnArgs a{q, k, v, nullptr, nullptr, nullptr, B, H, H_kv, Nq, Nk, D, scale,
             causal, Nk - Nq, 0, 0, 0.f, 0.f, 0, 0u, 0u, 1.f};
  auto st = static_cast<cudaStream_t>(stream);
  const auto* kl = static_cast<const int32_t*>(kv_list);
  const auto* kc = static_cast<const int32_t*>(kv_count);
  const auto* ql = static_cast<const int32_t*>(q_list);
  const auto* qc = static_cast<const int32_t*>(q_count);
  const auto* l = static_cast<const float*>(lse);
  const auto* d = static_cast<const float*>(di);
  auto* part = static_cast<float*>(scratch);
  return (int)(dtype == 0
                   ? swide::sparse_bwd_wide<__nv_bfloat16>(
                         a, kl, kc, ql, qc, kv_stride, q_stride, block_q,
                         block_k, dout, l, d, dq, dk, dv, part, chunk_len,
                         chunks, st)
                   : swide::sparse_bwd_wide<float>(
                         a, kl, kc, ql, qc, kv_stride, q_stride, block_q,
                         block_k, dout, l, d, dq, dk, dv, part, chunk_len,
                         chunks, st));
}

}  // extern "C"
