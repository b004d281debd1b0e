// Flash attention above head dim 256 on Hopper (sm_90a), for any head dim:
// the forward (o and the fp32 LSE) on mma.sync, bf16 on m16n8k16 and fp32
// in 3xTF32 on m16n8k8; the backward's dK/dV and dQ kernels on wgmma (fp32
// in 3xTF32) in thread block clusters along the head dim.
//
// Replaces: flashattention_tpu/ops/pallas_attn.py, _fwd_kernel (launched by
// _flash_fwd) and the backward's _bwd_fused_kernel (both launches),
// _bwd_dkv_kernel and _bwd_dq_kernel, at the head dims above 256 that
// pallas_attention computes (it pads D to a lane multiple) and that the
// D <= 256 kernels of flash_fwd.cu and flash_bwd.cu do not take. Same
// contract and rounding points as those (flash_common.cuh): causal with a
// query offset, window + sinks, GQA, segment ids, soft-cap, ALiBi and murmur3
// dropout; the backward forms q_s = q * scale in the input type, rounds p_v
// and ds to it before their products, and scales dQ at the store.
//
// What bounds it on this card: the tensor-core rate, as the D <= 256
// kernels (4 B H Nq Nk D flops forward, 10 backward, half causal, over 989
// TFLOP/s bf16 or 165 fp32 in 3xTF32).
//
// The forward. O (D columns) is cut into chunks of 128 columns, one CTA a
// chunk (grid y = head x chunks). S = Q.K^T runs over all of D in every
// chunk's CTA, in 64-column segments taken in one order by the same
// instructions, so the CTAs of one (row tile, head) compute the same scores
// bit for bit, the same running max and the same dropout mask, and their
// chunks of O share one normaliser. Tiles stream through a ring of kStages
// stages by cp.async (wide_mma.cuh): for each key tile ceil(D / 64) segment
// items, then the chunk's V tile. 4 warps of 16 query rows, 64 rows a CTA,
// row tiles last to first; fragments as mma_sync.cuh and sparse_mma.cuh set
// out (A and N-major B by ldmatrix, MN-major bf16 B by ldmatrix.trans,
// MN-major fp32 B by 32-bit loads at the permuted k of sparse_mma.cuh).
//
// The backward (namespace wbwd). What held the earlier chunked backward
// back: every output chunk's CTA recomputed S and dP over all of D, so
// a score element cost 2 nch + 2 products in dK/dV and 2 nch + 1 in dQ
// against 7 for the pair (19 at D = 512 in bf16, 67 at D = 1024 in fp32),
// with each chunk's CTA reading all of q, dO, K and V again; 4 warps on
// mma.sync at one CTA an SM; and a dK/dV grid of one CTA a 64-key tile and
// chunk, which under MQA walked a whole query-head group alone. Here:
//   - a CTA holds kW = 256 columns of D (its chunk); the C = ceil(D / 256)
//     CTAs of one key tile (dK/dV) or row tile (dQ) form a cluster along D
//     (cluster rank = chunk). Each loads only its own columns by TMA and its
//     two consumer warpgroups compute the partial S (consumer 0) and dP
//     (consumer 1) over those columns with wgmma. The partials meet in
//     distributed shared memory (Exchange): every CTA writes its fragment
//     into its own buffer, and each consumer reads its half of the elements
//     from every CTA of the cluster in rank order and sums them, so every
//     CTA holds the same scores bit for bit, and so the same p, dropout mask
//     and ds; two buffers alternate, guarded by two mbarriers that each CTA
//     arrives on remotely (ready: partials written; freed: read), so a
//     step's writes wait only for the reads of two steps before. Then each
//     consumer takes half the score pipeline, writes round(p_v) and
//     round(ds) into shared memory, and both run the output products for
//     their 128 of the chunk's columns: dV += P_v^T.dO, dK += dS^T.q_s (bf16,
//     P_v^T and dS^T as register A operands of wgmma, dO and q_s MN-major),
//     or dV^T += dO^T.P_v, dK^T += q_s^T.dS (fp32: TF32 wgmma reads only
//     K-major operands). Products a score element: 7 in all, for D up to
//     8 x 256 (8 CTAs, the portable cluster size);
//   - above that (bf16), `groups` clusters of C CTAs repeat along D, and
//     every cluster computes the scores over all of D: CTA r's partial
//     runs over the chunks r, r + C, ... in 64-column segment items (the
//     same for every group), before the main item that holds its own
//     chunk's operands for the output products. That is the only
//     recomputation left. fp32 (whose shared memory holds no segment
//     items) takes the chunked kernels below above 8 chunks;
//   - one producer warp keeps TMA loads in flight into an mbarrier-guarded
//     ring (bf16: 3 stages; fp32: one, with the next tile fetched into L2),
//     beside two consumer warpgroups of 240 (bf16) or 232 (fp32) registers;
//   - under GQA/MQA the dK/dV kernel's walk of (query head, row tile)
//     steps of a KV head is cut over `splits` clusters, whole query heads
//     each (ops/flash_attn._wide_bwd_plan), each writing fp32 partials
//     that kv_sum_kernel adds in split order, in the output's dtype.
// No atomics; every sum has one order, so the result does not depend on
// block order.
//   bf16 dK/dV: 64 keys a CTA, K and V resident (64 KB); steps of 32 query
//     rows (q and dO, 32 KB a stage); partials 64 keys x 32 rows
//     (m64n32); round(p_v)^T and round(ds)^T 10 KB: 204 KB.
//   bf16 dQ: 64 query rows a CTA, q_s and dO resident (64 KB); steps of 32
//     keys (K and V, 32 KB a stage): 198 KB.
//   fp32: flash_bwd.cu's pair at D = 256 (DkvWideCfg, DqWideCfg: 16-row and
//     16-key steps, operands split once a call into the wrapper's scratch),
//     the hand-over between its consumers replaced by the exchange, which
//     uses the 16 columns of the round(p_v)^T / round(ds)^T tiles that no
//     product reads (dQ: two more tiles, 225 KB).

#include "tf32_wide_bwd.cuh"
#include "wide_mma.cuh"

namespace fat {
namespace wide {

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <typename T>
struct FwdWide {
  static constexpr int RS = row_bytes<T>(kSeg), RC = row_bytes<T>(kChunkO);
  static constexpr int STAGE = cmax((kRowsF + kKeysF) * RS, kKeysF * RC);
  static constexpr size_t SMEM = (size_t)kStages * STAGE;
};

template <typename T>
__global__ void __launch_bounds__(kThreadsW, 1)
flash_fwd_wide_kernel(const AttnArgs a, T* __restrict__ o,
                      float* __restrict__ lse) {
  using Cfg = FwdWide<T>;
  constexpr int NT = kKeysF / 8, NO = kChunkO / 8;
  constexpr int RS = Cfg::RS, RC = Cfg::RC, STAGE = Cfg::STAGE;
  extern __shared__ __align__(128) char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int D = a.D, nch = (D + kChunkO - 1) / kChunkO;
  const int chunk = blockIdx.y % nch, h = blockIdx.y / nch, b = blockIdx.z;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRowsF;  // heavy first
  const int hk = h / (a.H / a.H_kv), d_c = chunk * kChunkO;
  const TileWalk walk =
      key_tiles(a, r0, min(r0 + kRowsF, a.Nq) - 1, kKeysF);
  const int nseg = (D + kSeg - 1) / kSeg, per = nseg + 1;
  const int n_items = walk.n_walk * per;
  const uint32_t bh = (uint32_t)(b * a.H + h);
  const T* qg = static_cast<const T*>(a.q) + ((size_t)bh * a.Nq + r0) * D;
  const size_t kv_off = ((size_t)b * a.H_kv + hk) * a.Nk * D;
  const T* kg = static_cast<const T*>(a.k) + kv_off;
  const T* vg = static_cast<const T*>(a.v) + kv_off;

  auto issue = [&](int i) {
    char* st = smem + (i % kStages) * STAGE;
    const int j = i % per, c0 = walk.tile(i / per) * kKeysF;
    if (j < nseg) {
      load_tile<T, kSeg>(st, RS, qg, kRowsF, a.Nq - r0, j * kSeg, D);
      load_tile<T, kSeg>(st + kRowsF * RS, RS, kg + (size_t)c0 * D, kKeysF,
                         a.Nk - c0, j * kSeg, D);
    } else {
      load_tile<T, kChunkO>(st, RC, vg + (size_t)c0 * D, kKeysF, a.Nk - c0,
                            d_c, D);
    }
  };

  const int row0 = r0 + 16 * warp;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NO][4], sc[NT][4];
  zero(acc);
  zero(sc);
  ring_start(n_items, issue);
  for (int i = 0; i < n_items; ++i) {
    ring_step(i, n_items, issue);
    const char* st = smem + (i % kStages) * STAGE;
    const int j = i % per, c0 = walk.tile(i / per) * kKeysF;
    if (j < nseg) {  // S += Q[:, seg] . K[:, seg]^T
      if (j == 0) zero(sc);
      seg_product<T, NT>(sc, st + 16 * warp * RS, st + kRowsF * RS, RS, lane);
      continue;
    }
    // The score pipeline at absolute (row, col); a masked score counts in
    // the row max as the mask value and gives p = 0 (held as -inf).
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = row0 + g + 8 * (c >> 1);
        const int col = c0 + 8 * n + 2 * tq + (c & 1);
        const bool vis = row < a.Nq && visible(a, b, row, col);
        float dcap;
        const float x = post_score(a, h, row, col, sc[n][c] * a.scale, &dcap);
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
        float p = expf(sc[n][c] - m[c >> 1]);
        l[c >> 1] += p;
        if (a.dropout) {
          const int row = row0 + g + 8 * (c >> 1);
          const int col = c0 + 8 * n + 2 * tq + (c & 1);
          p = keep(a, bh, row, col) ? p * a.drop_inv : 0.f;
        }
        sc[n][c] = p;
      }
    }
    rs_product<T, NT, NO>(acc, sc, st, RC, lane);  // O[:, chunk] += P . V
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    const int row = row0 + g + 8 * r;
    if (row >= a.Nq) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    const size_t base = (size_t)bh * a.Nq + row;
#pragma unroll
    for (int dn = 0; dn < NO; ++dn) {
      const int col = d_c + 8 * dn + 2 * tq;
      if (col < D) {
        store2(o + base * D + col, acc[dn][2 * r] / l_safe,
               acc[dn][2 * r + 1] / l_safe);
      }
    }
    if (chunk == 0 && tq == 0) lse[base] = m[r] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

template <typename T>
struct DqWide {
  static constexpr int RS = row_bytes<T>(kSeg), RC = row_bytes<T>(kChunkQ<T>);
  static constexpr int STAGE =
      cmax((2 * kRowsF + 2 * kKeysF) * RS, kKeysF * RC);
  static constexpr size_t SMEM = (size_t)kStages * STAGE;
};

template <typename T>
__global__ void __launch_bounds__(kThreadsW, 1)
flash_bwd_dq_wide_kernel(const AttnArgs a, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ di, T* __restrict__ dq) {
  using Cfg = DqWide<T>;
  constexpr int DC = kChunkQ<T>, NT = kKeysF / 8, NO = DC / 8;
  constexpr int RS = Cfg::RS, RC = Cfg::RC, STAGE = Cfg::STAGE;
  extern __shared__ __align__(128) char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int D = a.D, nch = (D + DC - 1) / DC;
  const int chunk = blockIdx.y % nch, h = blockIdx.y / nch, b = blockIdx.z;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRowsF;
  const int hk = h / (a.H / a.H_kv), d_c = chunk * DC;
  const TileWalk walk =
      key_tiles(a, r0, min(r0 + kRowsF, a.Nq) - 1, kKeysF);
  const int nseg = (D + kSeg - 1) / kSeg, per = nseg + 1;
  const int n_items = walk.n_walk * per;
  const uint32_t bh = (uint32_t)(b * a.H + h);
  const size_t q_off = ((size_t)bh * a.Nq + r0) * D;
  const T* qg = static_cast<const T*>(a.q) + q_off;
  const T* dog = dout + q_off;
  const size_t kv_off = ((size_t)b * a.H_kv + hk) * a.Nk * D;
  const T* kg = static_cast<const T*>(a.k) + kv_off;
  const T* vg = static_cast<const T*>(a.v) + kv_off;
  const float scale_c = Num<T>::round(a.scale);

  // Segment item: q, dO (64 rows), K, V (32 keys); chunk item: K's chunk.
  auto issue = [&](int i) {
    char* st = smem + (i % kStages) * STAGE;
    const int j = i % per, c0 = walk.tile(i / per) * kKeysF;
    if (j < nseg) {
      const int d0 = j * kSeg;
      load_tile<T, kSeg>(st, RS, qg, kRowsF, a.Nq - r0, d0, D);
      load_tile<T, kSeg>(st + kRowsF * RS, RS, dog, kRowsF, a.Nq - r0, d0, D);
      load_tile<T, kSeg>(st + 2 * kRowsF * RS, RS, kg + (size_t)c0 * D,
                         kKeysF, a.Nk - c0, d0, D);
      load_tile<T, kSeg>(st + (2 * kRowsF + kKeysF) * RS, RS,
                         vg + (size_t)c0 * D, kKeysF, a.Nk - c0, d0, D);
    } else {
      load_tile<T, DC>(st, RC, kg + (size_t)c0 * D, kKeysF, a.Nk - c0, d_c,
                       D);
    }
  };

  const int row0 = r0 + 16 * warp;
  float lse_r[2], di_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    lse_r[r] = row < a.Nq ? lse[(size_t)bh * a.Nq + row] : 0.f;
    di_r[r] = row < a.Nq ? di[(size_t)bh * a.Nq + row] : 0.f;
  }
  float acc[NO][4], sc[NT][4], dp[NT][4];
  zero(acc);
  zero(sc);
  zero(dp);
  ring_start(n_items, issue);
  for (int i = 0; i < n_items; ++i) {
    ring_step(i, n_items, issue);
    char* st = smem + (i % kStages) * STAGE;
    const int j = i % per, c0 = walk.tile(i / per) * kKeysF;
    if (j < nseg) {  // S += q_s . K^T, dP += dO . V^T over the segment
      scale_tile<T, kSeg>(st, RS, kRowsF, scale_c);
      __syncthreads();
      if (j == 0) {
        zero(sc);
        zero(dp);
      }
      seg_product<T, NT>(sc, st + 16 * warp * RS, st + 2 * kRowsF * RS, RS,
                         lane);
      seg_product<T, NT>(dp, st + (kRowsF + 16 * warp) * RS,
                         st + (2 * kRowsF + kKeysF) * RS, RS, lane);
      continue;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = row0 + g + 8 * (c >> 1);
        const int col = c0 + 8 * n + 2 * tq + (c & 1);
        const bool vis = row < a.Nq && visible(a, b, row, col);
        float dcap;
        const float s = post_score(a, h, row, col, sc[n][c], &dcap);
        const float p = vis ? expf(s - lse_r[c >> 1]) : 0.f;
        float dpv = dp[n][c];
        if (a.dropout) dpv = keep(a, bh, row, col) ? dpv * a.drop_inv : 0.f;
        sc[n][c] = p * (dpv - di_r[c >> 1]) * dcap;  // ds
      }
    }
    rs_product<T, NT, NO>(acc, sc, st, RC, lane);  // dQ[:, chunk] += dS . K
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= a.Nq) continue;
    const size_t base = ((size_t)bh * a.Nq + row) * D;
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
struct DkvWide {
  static constexpr int RS = row_bytes<T>(kSeg), RC = row_bytes<T>(kChunkKV<T>);
  static constexpr int STAGE =
      cmax((2 * kKeysB + 2 * kRowsB) * RS, 2 * kRowsB * RC);
  static constexpr size_t SMEM = (size_t)kStages * STAGE;
};

// One CTA a (64 keys, KV head, chunk, batch); warp w holds keys 16 w ..
// 16 w + 15 and the chunk's columns of their dK and dV, and walks the query
// heads of its GQA group and the 32-row tiles that see its keys, computing
// S^T = K . q_s^T and dP^T = V . dO^T (keys x rows) so that P_v^T and dS^T
// come out as the A operands of dV += P_v^T . dO and dK += dS^T . q_s.
template <typename T>
__global__ void __launch_bounds__(kThreadsW, 1)
flash_bwd_dkv_wide_kernel(const AttnArgs a, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ di, T* __restrict__ dk,
                          T* __restrict__ dv) {
  using Cfg = DkvWide<T>;
  constexpr int DC = kChunkKV<T>, NT = kRowsB / 8, NO = DC / 8;
  constexpr int RS = Cfg::RS, RC = Cfg::RC, STAGE = Cfg::STAGE;
  extern __shared__ __align__(128) char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int D = a.D, nch = (D + DC - 1) / DC;
  const int chunk = blockIdx.y % nch, hk = blockIdx.y / nch, b = blockIdx.z;
  const int c0 = blockIdx.x * kKeysB, d_c = chunk * DC;
  const int G = a.H / a.H_kv;
  // Query rows that can see some key of [c0, c0 + 64).
  const int c_last = min(c0 + kKeysB, a.Nk) - 1;
  int r_begin = 0, r_end = a.Nq;
  if (a.causal) {
    r_begin = max(0, c0 - a.offset);
    if (a.window > 0 && !(a.sinks > 0 && c0 < a.sinks)) {
      r_end = min(a.Nq, c_last - a.offset + a.window);
    }
  }
  const int t0 = (r_begin / kRowsB) * kRowsB;
  const int n_rt = r_end > t0 ? (r_end - t0 + kRowsB - 1) / kRowsB : 0;
  const int nseg = (D + kSeg - 1) / kSeg, per = nseg + 1;
  const int n_items = G * n_rt * per;
  const size_t kv_off = ((size_t)b * a.H_kv + hk) * a.Nk * D;
  const T* kg = static_cast<const T*>(a.k) + kv_off + (size_t)c0 * D;
  const T* vg = static_cast<const T*>(a.v) + kv_off + (size_t)c0 * D;
  const float scale_c = Num<T>::round(a.scale);
  auto step_rows = [&](int i, int* h, int* r0) {
    const int it = i / per;
    *h = hk * G + it / n_rt;
    *r0 = t0 + (it % n_rt) * kRowsB;
  };

  // Segment item: K, V (64 keys), q, dO (32 rows); chunk item: the chunk
  // of q and dO.
  auto issue = [&](int i) {
    char* st = smem + (i % kStages) * STAGE;
    int h, r0;
    step_rows(i, &h, &r0);
    const size_t q_off = (((size_t)b * a.H + h) * a.Nq + r0) * D;
    const T* qg = static_cast<const T*>(a.q) + q_off;
    const T* dog = dout + q_off;
    const int j = i % per;
    if (j < nseg) {
      const int d0 = j * kSeg;
      load_tile<T, kSeg>(st, RS, kg, kKeysB, a.Nk - c0, d0, D);
      load_tile<T, kSeg>(st + kKeysB * RS, RS, vg, kKeysB, a.Nk - c0, d0, D);
      load_tile<T, kSeg>(st + 2 * kKeysB * RS, RS, qg, kRowsB, a.Nq - r0, d0,
                         D);
      load_tile<T, kSeg>(st + (2 * kKeysB + kRowsB) * RS, RS, dog, kRowsB,
                         a.Nq - r0, d0, D);
    } else {
      load_tile<T, DC>(st, RC, qg, kRowsB, a.Nq - r0, d_c, D);
      load_tile<T, DC>(st + kRowsB * RC, RC, dog, kRowsB, a.Nq - r0, d_c, D);
    }
  };

  const int key0 = c0 + 16 * warp;
  float dk_acc[NO][4], dv_acc[NO][4], sc[NT][4], dp[NT][4];
  zero(dk_acc);
  zero(dv_acc);
  zero(sc);
  zero(dp);
  ring_start(n_items, issue);
  for (int i = 0; i < n_items; ++i) {
    ring_step(i, n_items, issue);
    char* st = smem + (i % kStages) * STAGE;
    const int j = i % per;
    if (j < nseg) {  // S^T += K . q_s^T, dP^T += V . dO^T over the segment
      scale_tile<T, kSeg>(st + 2 * kKeysB * RS, RS, kRowsB, scale_c);
      __syncthreads();
      if (j == 0) {
        zero(sc);
        zero(dp);
      }
      seg_product<T, NT>(sc, st + 16 * warp * RS, st + 2 * kKeysB * RS, RS,
                         lane);
      seg_product<T, NT>(dp, st + (kKeysB + 16 * warp) * RS,
                         st + (2 * kKeysB + kRowsB) * RS, RS, lane);
      continue;
    }
    scale_tile<T, DC>(st, RC, kRowsB, scale_c);
    __syncthreads();
    int h, r0;
    step_rows(i, &h, &r0);
    const uint32_t bh = (uint32_t)(b * a.H + h);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = r0 + 8 * n + 2 * tq + e;
        const float lse_v = row < a.Nq ? lse[(size_t)bh * a.Nq + row] : 0.f;
        const float di_v = row < a.Nq ? di[(size_t)bh * a.Nq + row] : 0.f;
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int c = 2 * hi + e;
          const int key = key0 + g + 8 * hi;
          const bool vis = row < a.Nq && visible(a, b, row, key);
          float dcap;
          const float s = post_score(a, h, row, key, sc[n][c], &dcap);
          const float p = vis ? expf(s - lse_v) : 0.f;
          float p_v = p, dpv = dp[n][c];
          if (a.dropout) {
            const bool kp = keep(a, bh, row, key);
            p_v = kp ? p * a.drop_inv : 0.f;
            dpv = kp ? dpv * a.drop_inv : 0.f;
          }
          sc[n][c] = p_v;
          dp[n][c] = p * (dpv - di_v) * dcap;  // ds
        }
      }
    }
    rs_product<T, NT, NO>(dv_acc, sc, st + kRowsB * RC, RC, lane);
    rs_product<T, NT, NO>(dk_acc, dp, st, RC, lane);
  }

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int key = key0 + g + 8 * hi;
    if (key >= a.Nk) continue;
    const size_t base = (((size_t)b * a.H_kv + hk) * a.Nk + key) * D;
#pragma unroll
    for (int dn = 0; dn < NO; ++dn) {
      const int col = d_c + 8 * dn + 2 * tq;
      if (col < D) {
        store2(dk + base + col, dk_acc[dn][2 * hi], dk_acc[dn][2 * hi + 1]);
        store2(dv + base + col, dv_acc[dn][2 * hi], dv_acc[dn][2 * hi + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

template <typename T>
cudaError_t launch_fwd(const AttnArgs& a, void* o, float* lse,
                       cudaStream_t st) {
  auto kernel = flash_fwd_wide_kernel<T>;
  cudaError_t err = set_smem(kernel, FwdWide<T>::SMEM);
  if (err != cudaSuccess) return err;
  const int nch = (a.D + kChunkO - 1) / kChunkO;
  const dim3 grid((a.Nq + kRowsF - 1) / kRowsF, a.H * nch, a.B);
  kernel<<<grid, kThreadsW, FwdWide<T>::SMEM, st>>>(a, static_cast<T*>(o),
                                                     lse);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const AttnArgs& a, const void* dout, const float* lse,
                       const float* di, void* dq, void* dk, void* dv,
                       cudaStream_t st) {
  auto dkv = flash_bwd_dkv_wide_kernel<T>;
  auto dqk = flash_bwd_dq_wide_kernel<T>;
  cudaError_t err = set_smem(dkv, DkvWide<T>::SMEM);
  if (err == cudaSuccess) err = set_smem(dqk, DqWide<T>::SMEM);
  if (err != cudaSuccess) return err;
  const T* d_o = static_cast<const T*>(dout);
  const int nkv = (a.D + kChunkKV<T> - 1) / kChunkKV<T>;
  const dim3 grid_kv((a.Nk + kKeysB - 1) / kKeysB, a.H_kv * nkv, a.B);
  dkv<<<grid_kv, kThreadsW, DkvWide<T>::SMEM, st>>>(
      a, d_o, lse, di, static_cast<T*>(dk), static_cast<T*>(dv));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nq = (a.D + kChunkQ<T> - 1) / kChunkQ<T>;
  const dim3 grid_q((a.Nq + kRowsF - 1) / kRowsF, a.H * nq, a.B);
  dqk<<<grid_q, kThreadsW, DqWide<T>::SMEM, st>>>(a, d_o, lse, di,
                                                   static_cast<T*>(dq));
  return cudaGetLastError();
}

// The grid's y dimension (heads x chunks of the narrowest chunk) bounds H.
inline bool bad_shape(int B, int H, int H_kv, int Nq, int Nk, int D,
                      int dtype) {
  return dtype < 0 || dtype > 1 || D <= 256 || D % 8 != 0 || H_kv < 1 ||
         H % H_kv != 0 || B < 1 || Nq < 1 || Nk < 1 || B > 65535 ||
         (long long)H * ((D + 63) / 64) > 65535;
}

}  // namespace wide

// ---------------------------------------------------------------------------
// The backward (bf16): cluster kernels on wgmma
// ---------------------------------------------------------------------------

namespace wbwd {

using sm90::acc_col;
using sm90::acc_row;
using sm90::desc_k;
using sm90::desc_mn;
using sm90::fence_proxy_async;
using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::named_sync;
using sm90::scale_bf16;
using sm90::smem_u32;
using sm90::tma_load;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_ss;
using sm90::wgmma_wait;
using sm90::fence_regs;

constexpr int kW = 256;        // head-dim columns of a CTA (bf16)
constexpr int kHalves = kW / 64;
constexpr int kKeysKV = 64;    // keys of a dK/dV CTA
constexpr int kRowsKV = 32;    // query rows of a dK/dV step
constexpr int kRowsQ = 64;     // query rows of a dQ CTA
constexpr int kKeysQ = 32;     // keys of a dQ step
constexpr int kStagesW = 3;
constexpr int kMaxCluster = 8;
constexpr int kThreadsC = 384;  // warpgroup 0 loads, 1-2 compute
// A 64 x 32 score tile (keys x rows in dK/dV, rows x keys in dQ) as m64n32
// fragments: 16 floats a thread, 4 float4s, [float4 index][thread].
constexpr int kPartF4 = 4 * 128;
// round(p)^T / round(ds)^T (dK/dV) or round(ds) (dQ): 64 x 32 bf16 at a
// row stride of 40 elements (80 bytes: 32-bit reads of an A fragment hit
// 32 distinct banks)
constexpr int kXStride = 80;
constexpr int kXBytes = 64 * kXStride;

// The call's plan (ops/flash_attn._wide_bwd_plan): the head dim in nch
// chunks of kW columns, clusters of C CTAs, `groups` clusters along D (C *
// groups >= nch); dK/dV's query-head walk of a KV head cut over `splits`.
struct Plan {
  int nch, C, groups, splits;
};

// ---- cluster ---------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// The shared::cluster address of `p` (this CTA's shared memory) in CTA
// `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(const void* p, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(smem_u32(p)), "r"(rank));
  return out;
}

// One arrival, releasing at cluster scope, on the mbarrier at the
// shared::cluster address `bar` (another CTA's, or this one's). The release
// is cumulative: the accesses that other threads ordered before it with a
// named barrier are visible to the CTA that acquires the phase.
__device__ __forceinline__ void arrive_remote(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(bar)
      : "memory");
}

// mbar_wait, acquiring at cluster scope (the arrivals of other CTAs).
__device__ __forceinline__ void wait_cluster(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Every thread of every CTA of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;" ::: "memory");
}

// The half-tiles [h0, h0 + n) of 64 columns from column col0 of a map of
// R-row boxes: rows [row, row + R) of `plane` into `dst` (halves of R x 64,
// R * 128 bytes apart). Boxes past D land as zeros.
template <int R>
__device__ __forceinline__ void tma_cols(char* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col0, int n,
                                         int row, int plane) {
  for (int hf = 0; hf < n; ++hf) {
    tma_load(dst + hf * R * 128, map, bar, col0 + hf * 64, row, plane);
  }
}

// ---- the exchange of partial scores ----------------------------------------
//
// Each CTA of a cluster multiplies its own columns: consumer 0 the partial
// S (or S^T), consumer 1 the partial dP, an m64nN fragment each (NF4
// float4s a thread). A step's exchange: wait until every CTA has read this
// CTA's buffer b of two steps before (freed[b]); write the fragment into
// buffer b's region of this consumer (region[b][0] S, region[b][1] dP),
// thread t's float4 i4 at off(t, i4); after named barrier 4 one thread
// arrives on ready[b] of every CTA; once this CTA's ready[b] has all C
// arrivals, consumer cw reads its half of the elements (float4s cw NF4 / 2
// .. (cw + 1) NF4 / 2 of both regions) from every CTA in rank order and
// sums them, so every CTA holds the same sums bit for bit; after named
// barrier 5 one thread arrives on freed[b] of every CTA. FREE: the regions
// are the free columns 16-31 of 64-row fp32 tiles (free_off), else plain
// arrays of NF4 x 128 float4s.
__device__ __forceinline__ int free_off(int t, int i4) {
  return sm90::sw_off<64>(t >> 1, 16 + 4 * (2 * (t & 1) + i4));
}

template <int NF4, bool FREE>
struct Exchange {
  char* region[2][2];  // [buffer][S, dP]
  uint64_t* ready;     // [2], C arrivals a phase
  uint64_t* freed;     // [2], C arrivals a phase
  int C;

  static __device__ __forceinline__ int off(int t, int i4) {
    return FREE ? free_off(t, i4) : (i4 * 128 + t) * 16;
  }

  __device__ __forceinline__ void sum(int step, int cw, int t,
                                      const float (&mine)[4 * NF4],
                                      float (&s)[2 * NF4],
                                      float (&dp)[2 * NF4]) const {
    const int b = step & 1, u = step >> 1;
    if (u > 0) wait_cluster(&freed[b], (u - 1) & 1);
#pragma unroll
    for (int i4 = 0; i4 < NF4; ++i4) {
      *reinterpret_cast<float4*>(region[b][cw] + off(t, i4)) =
          make_float4(mine[4 * i4], mine[4 * i4 + 1], mine[4 * i4 + 2],
                      mine[4 * i4 + 3]);
    }
    named_sync(4, 256);
    if (cw == 0 && t == 0) {
      for (int dst = 0; dst < C; ++dst) arrive_remote(map_rank(&ready[b], dst));
    }
    wait_cluster(&ready[b], u & 1);
    // BATCH sources' loads in flight at once (a remote load waited for
    // before the next is issued cost most of the exchange), then their sums
    // in rank order; 4 sources' spilled the fp32 dQ consumer
    constexpr int H = NF4 / 2, BATCH = 2;
    for (int s0 = 0; s0 < C; s0 += BATCH) {
      float4 xv[BATCH][H], yv[BATCH][H];
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        if (s0 + j < C) {
          const uint32_t sb = map_rank(region[b][0], s0 + j);
          const uint32_t db = map_rank(region[b][1], s0 + j);
#pragma unroll
          for (int h = 0; h < H; ++h) {
            xv[j][h] = ld_cluster4(sb + off(t, cw * H + h));
            yv[j][h] = ld_cluster4(db + off(t, cw * H + h));
          }
        }
      }
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        if (s0 + j >= C) break;
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const float xs[4] = {xv[j][h].x, xv[j][h].y, xv[j][h].z, xv[j][h].w};
          const float ys[4] = {yv[j][h].x, yv[j][h].y, yv[j][h].z, yv[j][h].w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            s[4 * h + k] = s0 + j == 0 ? xs[k] : s[4 * h + k] + xs[k];
            dp[4 * h + k] = s0 + j == 0 ? ys[k] : dp[4 * h + k] + ys[k];
          }
        }
      }
    }
    named_sync(5, 256);
    if (cw == 0 && t == 0) {
      for (int dst = 0; dst < C; ++dst) arrive_remote(map_rank(&freed[b], dst));
    }
  }
};

// The m64n32 fragment's A operands of the two k16 steps from a 64 x 32
// bf16 tile at x (row stride kXStride): register j of step kk holds (row
// acc_row(t, 2 j), columns 16 kk + 8 (j / 2) + 2 (t % 4) + {0, 1}).
__device__ __forceinline__ void load_a(const char* x, int t,
                                       uint32_t (&a)[2][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = acc_row(t, 2 * j), c = 16 * kk + 8 * (j >> 1) + 2 * (t & 3);
      a[kk][j] = *reinterpret_cast<const uint32_t*>(x + r * kXStride + c * 2);
    }
  }
}

__device__ __forceinline__ void store_x(char* x, int r, int c, float v0,
                                        float v1) {
  *reinterpret_cast<uint32_t*>(x + r * kXStride + c * 2) =
      sm90::pack_bf16(v0, v1);
}

// ---- dK, dV ----------------------------------------------------------------

struct DkvCfg {
  static constexpr int KV_BYTES = kKeysKV * kW * 2;         // K or V
  static constexpr int MAIN_BYTES = 2 * kRowsKV * kW * 2;   // q, dO
  static constexpr int SEG_BYTES = 2 * (kKeysKV + kRowsKV) * 64 * 2;
  static constexpr int STAGE = MAIN_BYTES;  // >= SEG_BYTES
  static constexpr size_t SMEM =
      1024 + 2 * KV_BYTES + (size_t)kStagesW * STAGE +
      2 * 2 * kPartF4 * 16 + 2 * kXBytes + 2 * kStagesW * kRowsKV * 4 +
      8 * (1 + 2 * kStagesW + 4);
};
static_assert(DkvCfg::SEG_BYTES <= DkvCfg::STAGE, "dkv segment item");

// One CTA a (column chunk, 64 keys, KV head x split, batch); the C CTAs of
// a cluster are C chunks of one key tile. Warpgroup 0's warp 0 loads: K
// and V of the chunk, resident; then per step of the walk ((query head,
// 32-row tile) pairs of its split) the step's items: where the scores need
// columns of other chunks (groups > 1), 64-column segments of K, V, q and
// dO of the chunks r, r + C, ... (the same for every group), then the main
// item, q and dO of the chunk. Consumer 0 (warpgroup 1) computes the
// partial S^T = K.q_s^T, consumer 1 dP^T = V.dO^T, both 64 keys x 32 rows,
// from the segments or (groups == 1) from the resident tiles and the main
// item; the cluster sums the partials (Exchange); each consumer takes half
// the elements through the score pipeline, writes round(p_v)^T and
// round(ds)^T into shared memory, and after a named barrier both run dV +=
// P_v^T.dO and dK += dS^T.q_s for their 128 of the chunk's columns, P_v^T
// and dS^T as register A operands.
__global__ void __launch_bounds__(kThreadsC, 1)
flash_bwd_dkv_wide_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const AttnArgs a, const Plan pl,
                               const float* __restrict__ lse,
                               const float* __restrict__ di,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv,
                               float* __restrict__ part_out) {
  using Cfg = DkvCfg;
  extern __shared__ char smem_raw[];
  char* k_s = sm90::align_1024(smem_raw);
  char* v_s = k_s + Cfg::KV_BYTES;
  char* ring = v_s + Cfg::KV_BYTES;
  float4* part = reinterpret_cast<float4*>(ring + kStagesW * Cfg::STAGE);
  char* xp = reinterpret_cast<char*>(part + 4 * kPartF4);
  char* xds = xp + kXBytes;
  float* lse_s = reinterpret_cast<float*>(xds + kXBytes);
  float* di_s = lse_s + kStagesW * kRowsKV;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(di_s + kStagesW * kRowsKV);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStagesW;
  uint64_t* ready = empty + kStagesW;
  uint64_t* freed = ready + 2;

  const int C = pl.C;
  const int rank = (int)cluster_rank();
  const int chunk = blockIdx.x;  // group * C + rank
  const int c0 = blockIdx.y * kKeysKV;
  const int zz = blockIdx.z, b = zz / (a.H_kv * pl.splits);
  const int hk = zz / pl.splits % a.H_kv, sp = zz % pl.splits;
  const int G = a.H / a.H_kv, Gs = G / pl.splits;
  const int d_o = chunk * kW;  // the chunk's first column
  // Query rows that can see some key of [c0, c0 + 64).
  const int c_last = min(c0 + kKeysKV, a.Nk) - 1;
  int r_begin = 0, r_end = a.Nq;
  if (a.causal) {
    r_begin = max(0, c0 - a.offset);
    if (a.window > 0 && !(a.sinks > 0 && c0 < a.sinks)) {
      r_end = min(a.Nq, c_last - a.offset + a.window);
    }
  }
  const int t0 = (r_begin / kRowsKV) * kRowsKV;
  const int n_rt = r_end > t0 ? (r_end - t0 + kRowsKV - 1) / kRowsKV : 0;
  const int n_it = Gs * n_rt;  // this split's (query head, row tile) steps
  const int h_base = hk * G + sp * Gs;
  // 64-column segments of the chunks r, r + C, ... below D, where the
  // scores need columns beyond the CTA's own (groups > 1)
  int nseg = 0;
  if (pl.groups > 1) {
    for (int c = rank; c < pl.nch; c += C) {
      nseg += min(kHalves, (a.D - c * kW + 63) / 64);
    }
  }
  const int per = nseg + 1;  // items a step
  auto seg_col = [&](int j) {  // first column of segment j
    return (rank + (j / kHalves) * C) * kW + (j % kHalves) * 64;
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStagesW; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&ready[i], C);
      mbar_init(&freed[i], C);
    }
    sm90::fence_barrier_init();
  }
  cluster_sync();

  if (threadIdx.x < 128) {  // producer: warp 0
    sm90::reg_dealloc<sm90::kProducerRegs>();
    const int lane = threadIdx.x;
    if (lane < 32 && n_it > 0) {
      const int kvp = b * a.H_kv + hk;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * Cfg::KV_BYTES);
        tma_cols<kKeysKV>(k_s, &tk, kv_full, d_o, kHalves, c0, kvp);
        tma_cols<kKeysKV>(v_s, &tv, kv_full, d_o, kHalves, c0, kvp);
      }
      for (int i = 0; i < n_it * per; ++i) {
        const int s = i % kStagesW, it = i / per, j = i % per;
        const int plane = b * a.H + h_base + it / n_rt;
        const int r0 = t0 + (it % n_rt) * kRowsKV;
        char* st = ring + s * Cfg::STAGE;
        mbar_wait(&empty[s], ((i / kStagesW) & 1) ^ 1);
        if (j < nseg) {  // [K, V: 64 x 64][q, dO: 32 x 64]
          if (lane == 0) {
            const int col = seg_col(j);
            mbar_expect_tx(&full[s], Cfg::SEG_BYTES);
            tma_load(st, &tk, &full[s], col, c0, kvp);
            tma_load(st + kKeysKV * 128, &tv, &full[s], col, c0, kvp);
            tma_load(st + 2 * kKeysKV * 128, &tq, &full[s], col, r0, plane);
            tma_load(st + (2 * kKeysKV + kRowsKV) * 128, &tdo, &full[s], col,
                     r0, plane);
          }
          continue;
        }
        {
          const int row = r0 + lane;
          const size_t at = (size_t)plane * a.Nq + row;
          lse_s[s * kRowsKV + lane] = row < a.Nq ? lse[at] : 0.f;
          di_s[s * kRowsKV + lane] = row < a.Nq ? di[at] : 0.f;
        }
        __threadfence_block();
        __syncwarp();  // the rows above land before lane 0 arrives
        if (lane == 0) {
          mbar_expect_tx(&full[s], Cfg::MAIN_BYTES);
          tma_cols<kRowsKV>(st, &tq, &full[s], d_o, kHalves, r0, plane);
          tma_cols<kRowsKV>(st + kRowsKV * kW * 2, &tdo, &full[s], d_o,
                            kHalves, r0, plane);
        }
      }
    }
  } else {  // consumers
    sm90::reg_alloc<sm90::kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    char* pb = reinterpret_cast<char*>(part);
    constexpr int RB = kPartF4 * 16;  // bytes of a region
    const Exchange<4, false> ex{{{pb, pb + RB}, {pb + 2 * RB, pb + 3 * RB}},
                                ready, freed, C};
    const float scale_c = Num<__nv_bfloat16>::round(a.scale);
    const bool post = a.slopes != nullptr || a.softcap > 0.f;
    float dk_acc[64], dv_acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    const char* a_res = cw == 0 ? k_s : v_s;  // A of this consumer's partial

    if (n_it > 0) mbar_wait(kv_full, 0);
    for (int i = 0, it = 0; it < n_it; ++it) {
      const int h = h_base + it / n_rt;
      const int r0 = t0 + (it % n_rt) * kRowsKV;
      const uint32_t bh = (uint32_t)(b * a.H + h);
      float acc[16];  // the partial S^T (consumer 0) or dP^T (consumer 1)
      for (int j = 0; j < nseg; ++j, ++i) {  // other chunks' segments
        const int s = i % kStagesW;
        char* st = ring + s * Cfg::STAGE;
        char* qseg = st + 2 * kKeysKV * 128;
        mbar_wait(&full[s], (i / kStagesW) & 1);
        if (cw == 0) {  // q_s of the segment, for S^T
          scale_bf16(qseg, kRowsKV * 128, scale_c, t, 128);
          fence_proxy_async();
          named_sync(6, 128);
        }
        const char* ta = st + cw * kKeysKV * 128;
        const char* tb = qseg + cw * kRowsKV * 128;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_ss<32>(acc, desc_k<kKeysKV>(ta, 0, kk),
                       desc_k<kRowsKV>(tb, 0, kk), j > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(&empty[s]);
      }
      const int s = i % kStagesW;
      char* qt = ring + s * Cfg::STAGE;
      const char* dot = qt + kRowsKV * kW * 2;
      const float* ls = lse_s + s * kRowsKV;
      const float* di_t = di_s + s * kRowsKV;
      mbar_wait(&full[s], (i / kStagesW) & 1);
      // q_s = bf16(q * bf16(scale)) in place, before any wgmma reads it
      scale_bf16(qt, kRowsKV * kW * 2, scale_c, threadIdx.x - 128, 256);
      fence_proxy_async();
      named_sync(1, 256);
      if (nseg == 0) {
        const char* tb = cw == 0 ? qt : dot;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kW / 16; ++kk) {
          wgmma_ss<32>(acc, desc_k<kKeysKV>(a_res, 0, kk),
                       desc_k<kRowsKV>(tb, 0, kk), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
      float sv[8], dpv[8];
      ex.sum(it, cw, t, acc, sv, dpv);

      // The score pipeline over this consumer's half: elements 8 cw ..
      // 8 cw + 7 of the fragment (key acc_row, query row acc_col).
      const int cls = sm90::tile_class(a, r0, r0 + kRowsKV - 1, c0,
                                       c0 + kKeysKV - 1);
      uint32_t seg[2] = {0u, 0u};
      if (cls == sm90::kSegments) {
        sm90::segment_bits<32>(a.kv_ids + (size_t)b * a.Nk, c0, a.Nk,
                               a.q_ids + (size_t)b * a.Nq, r0, a.Nq, t, seg);
      }
      sm90::dispatch_tile(cls, post, [&](auto c, auto pp) {
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          float pv[2], ds[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int i8 = 8 * cw + e + u;
            const int kr = acc_row(t, i8), j = acc_col(t, i8);
            const int key = c0 + kr, row = r0 + j;
            pv[u] = 0.f;
            ds[u] = 0.f;
            if (sm90::tile_visible<decltype(c)::value>(a, b, row, key, seg,
                                                       i8)) {
              float dcap;
              const float x = sm90::tile_score<decltype(pp)::value>(
                  a, h, row, key, sv[e + u], &dcap);
              const float p = expf(x - ls[j]);
              float dp = dpv[e + u];
              pv[u] = p;
              if (a.dropout) {
                const bool kept = keep(a, bh, row, key);
                pv[u] = kept ? p * a.drop_inv : 0.f;
                dp = kept ? dp * a.drop_inv : 0.f;
              }
              ds[u] = p * (dp - di_t[j]);
              ds[u] = ds[u] * dcap;
            }
          }
          const int i8 = 8 * cw + e;
          store_x(xp, acc_row(t, i8), acc_col(t, i8), pv[0], pv[1]);
          store_x(xds, acc_row(t, i8), acc_col(t, i8), ds[0], ds[1]);
        }
      });
      named_sync(2, 256);

      // dV[:, half] += P_v^T.dO[:, half], dK[:, half] += dS^T.q_s[:, half]
      uint32_t pa[2][4], da[2][4];
      load_a(xp, t, pa);
      load_a(xds, t, da);
      const int hoff = 2 * cw * kRowsKV * 128;
      wgmma_fence();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        sm90::wgmma_rs<128>(dv_acc, pa[kk], desc_mn<kRowsKV>(dot + hoff, kk));
        sm90::wgmma_rs<128>(dk_acc, da[kk], desc_mn<kRowsKV>(qt + hoff, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      mbar_arrive(&empty[s]);
      ++i;
    }

    // This chunk's columns of dK and dV (keys no row sees write zeros):
    // the outputs, or with splits this split's fp32 partials.
    const size_t kv_off = ((size_t)b * a.H_kv + hk) * a.Nk;
    const size_t nk = (size_t)a.B * a.H_kv * a.Nk * a.D;
    float* pk = part_out + 2 * (size_t)sp * nk;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int key = c0 + acc_row(t, i);
      const int col = d_o + 128 * cw + acc_col(t, i);
      if (key < a.Nk && col < a.D) {
        const size_t at = (kv_off + key) * a.D + col;
        if (pl.splits > 1) {
          *reinterpret_cast<float2*>(pk + at) =
              make_float2(dk_acc[i], dk_acc[i + 1]);
          *reinterpret_cast<float2*>(pk + nk + at) =
              make_float2(dv_acc[i], dv_acc[i + 1]);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(dk + at) =
              __floats2bfloat162_rn(dk_acc[i], dk_acc[i + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dv + at) =
              __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
        }
      }
    }
  }
  cluster_sync();  // no CTA leaves while the cluster reads its memory
}

// ---- dQ --------------------------------------------------------------------

struct DqCfg {
  static constexpr int Q_BYTES = kRowsQ * kW * 2;           // q or dO
  static constexpr int MAIN_BYTES = 2 * kKeysQ * kW * 2;    // K, V
  static constexpr int SEG_BYTES = 2 * (kKeysQ + kRowsQ) * 64 * 2;
  static constexpr int STAGE = MAIN_BYTES;
  static constexpr size_t SMEM = 1024 + 2 * Q_BYTES +
                                 (size_t)kStagesW * STAGE +
                                 2 * 2 * kPartF4 * 16 + kXBytes +
                                 8 * (1 + 2 * kStagesW + 4);
};
static_assert(DqCfg::SEG_BYTES <= DqCfg::STAGE, "dq segment item");

// One CTA a (column chunk, 64 query rows, head, batch); the C CTAs of a
// cluster are C chunks of one row tile. q and dO of the chunk resident (q
// rounded to q_s once); per key tile of the rows' walk, the other chunks'
// segments (groups > 1) and the main item, K and V of the chunk (32 keys).
// Consumer 0 computes the partial S = q_s.K^T, consumer 1 dP = dO.V^T (64
// rows x 32 keys); the cluster sums them; each consumer takes half the
// elements to ds, written as round(ds); both run dQ[:, half] += dS.K[:,
// half], dS as the register A operand; dQ is scaled at the store.
__global__ void __launch_bounds__(kThreadsC, 1)
flash_bwd_dq_wide_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const AttnArgs a, const Plan pl,
                              const float* __restrict__ lse,
                              const float* __restrict__ di,
                              __nv_bfloat16* __restrict__ dq) {
  using Cfg = DqCfg;
  extern __shared__ char smem_raw[];
  char* q_s = sm90::align_1024(smem_raw);
  char* do_s = q_s + Cfg::Q_BYTES;
  char* ring = do_s + Cfg::Q_BYTES;
  float4* part = reinterpret_cast<float4*>(ring + kStagesW * Cfg::STAGE);
  char* xds = reinterpret_cast<char*>(part + 4 * kPartF4);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(xds + kXBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStagesW;
  uint64_t* ready = empty + kStagesW;
  uint64_t* freed = ready + 2;

  const int C = pl.C;
  const int rank = (int)cluster_rank();
  const int chunk = blockIdx.x;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kRowsQ;  // heavy first
  const int h = blockIdx.z % a.H, b = blockIdx.z / a.H;
  const int hk = h / (a.H / a.H_kv), d_o = chunk * kW;
  const TileWalk walk = key_tiles(a, r0, min(r0 + kRowsQ, a.Nq) - 1, kKeysQ);
  int nseg = 0;
  if (pl.groups > 1) {
    for (int c = rank; c < pl.nch; c += C) {
      nseg += min(kHalves, (a.D - c * kW + 63) / 64);
    }
  }
  const int per = nseg + 1;
  auto seg_col = [&](int j) {
    return (rank + (j / kHalves) * C) * kW + (j % kHalves) * 64;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStagesW; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&ready[i], C);
      mbar_init(&freed[i], C);
    }
    sm90::fence_barrier_init();
  }
  cluster_sync();

  if (threadIdx.x < 128) {  // producer
    sm90::reg_dealloc<sm90::kProducerRegs>();
    if (threadIdx.x == 0 && walk.n_walk > 0) {
      const int kvp = b * a.H_kv + hk, qp = b * a.H + h;
      mbar_expect_tx(q_full, 2 * Cfg::Q_BYTES);
      tma_cols<kRowsQ>(q_s, &tq, q_full, d_o, kHalves, r0, qp);
      tma_cols<kRowsQ>(do_s, &tdo, q_full, d_o, kHalves, r0, qp);
      for (int i = 0; i < walk.n_walk * per; ++i) {
        const int s = i % kStagesW, j = i % per;
        const int c0 = walk.tile(i / per) * kKeysQ;
        char* st = ring + s * Cfg::STAGE;
        mbar_wait(&empty[s], ((i / kStagesW) & 1) ^ 1);
        if (j < nseg) {  // [K, V: 32 x 64][q, dO: 64 x 64]
          const int col = seg_col(j);
          mbar_expect_tx(&full[s], Cfg::SEG_BYTES);
          tma_load(st, &tk, &full[s], col, c0, kvp);
          tma_load(st + kKeysQ * 128, &tv, &full[s], col, c0, kvp);
          tma_load(st + 2 * kKeysQ * 128, &tq, &full[s], col, r0, qp);
          tma_load(st + (2 * kKeysQ + kRowsQ) * 128, &tdo, &full[s], col, r0,
                   qp);
          continue;
        }
        mbar_expect_tx(&full[s], Cfg::MAIN_BYTES);
        tma_cols<kKeysQ>(st, &tk, &full[s], d_o, kHalves, c0, kvp);
        tma_cols<kKeysQ>(st + kKeysQ * kW * 2, &tv, &full[s], d_o, kHalves, c0,
                         kvp);
      }
    }
  } else {  // consumers
    sm90::reg_alloc<sm90::kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    char* pb = reinterpret_cast<char*>(part);
    constexpr int RB = kPartF4 * 16;  // bytes of a region
    const Exchange<4, false> ex{{{pb, pb + RB}, {pb + 2 * RB, pb + 3 * RB}},
                                ready, freed, C};
    const uint32_t bh = (uint32_t)(b * a.H + h);
    const float scale_c = Num<__nv_bfloat16>::round(a.scale);
    const bool post = a.slopes != nullptr || a.softcap > 0.f;
    float lse_r[2], di_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + acc_row(t, 2 * r);
      lse_r[r] = row < a.Nq ? lse[(size_t)bh * a.Nq + row] : 0.f;
      di_r[r] = row < a.Nq ? di[(size_t)bh * a.Nq + row] : 0.f;
    }
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    const char* a_res = cw == 0 ? q_s : do_s;

    if (walk.n_walk > 0) {
      mbar_wait(q_full, 0);
      // q_s = bf16(q * bf16(scale)), once
      scale_bf16(q_s, Cfg::Q_BYTES, scale_c, threadIdx.x - 128, 256);
      fence_proxy_async();
      named_sync(1, 256);
    }
    for (int i = 0, w = 0; w < walk.n_walk; ++w) {
      const int c0 = walk.tile(w) * kKeysQ;
      float sp[16];  // the partial S (consumer 0) or dP (consumer 1)
      for (int j = 0; j < nseg; ++j, ++i) {
        const int s = i % kStagesW;
        char* st = ring + s * Cfg::STAGE;
        char* qseg = st + 2 * kKeysQ * 128;
        mbar_wait(&full[s], (i / kStagesW) & 1);
        if (cw == 0) {
          scale_bf16(qseg, kRowsQ * 128, scale_c, t, 128);
          fence_proxy_async();
          named_sync(6, 128);
        }
        const char* ta = qseg + cw * kRowsQ * 128;
        const char* tb = st + cw * kKeysQ * 128;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_ss<32>(sp, desc_k<kRowsQ>(ta, 0, kk),
                       desc_k<kKeysQ>(tb, 0, kk), j > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sp);
        mbar_arrive(&empty[s]);
      }
      const int s = i % kStagesW;
      const char* kt = ring + s * Cfg::STAGE;
      mbar_wait(&full[s], (i / kStagesW) & 1);
      if (nseg == 0) {
        const char* tb = kt + cw * kKeysQ * kW * 2;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kW / 16; ++kk) {
          wgmma_ss<32>(sp, desc_k<kRowsQ>(a_res, 0, kk),
                       desc_k<kKeysQ>(tb, 0, kk), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sp);
      }
      float sv[8], dpv[8];
      ex.sum(w, cw, t, sp, sv, dpv);

      const int cls = sm90::tile_class(a, r0, r0 + kRowsQ - 1, c0,
                                       c0 + kKeysQ - 1);
      uint32_t seg[2] = {0u, 0u};
      if (cls == sm90::kSegments) {
        sm90::segment_bits<32>(a.q_ids + (size_t)b * a.Nq, r0, a.Nq,
                               a.kv_ids + (size_t)b * a.Nk, c0, a.Nk, t, seg);
      }
      sm90::dispatch_tile(cls, post, [&](auto c, auto pp) {
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          float ds[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int i8 = 8 * cw + e + u;
            const int row = r0 + acc_row(t, i8), col = c0 + acc_col(t, i8);
            const int r = (i8 >> 1) & 1;
            ds[u] = 0.f;
            if (sm90::tile_visible<decltype(c)::value>(a, b, row, col, seg,
                                                       i8)) {
              float dcap;
              const float x = sm90::tile_score<decltype(pp)::value>(
                  a, h, row, col, sv[e + u], &dcap);
              const float p = expf(x - lse_r[r]);
              float d = dpv[e + u];
              if (a.dropout) d = keep(a, bh, row, col) ? d * a.drop_inv : 0.f;
              ds[u] = p * (d - di_r[r]);
              ds[u] = ds[u] * dcap;
            }
          }
          const int i8 = 8 * cw + e;
          store_x(xds, acc_row(t, i8), acc_col(t, i8), ds[0], ds[1]);
        }
      });
      named_sync(2, 256);

      uint32_t da[2][4];
      load_a(xds, t, da);
      const int hoff = 2 * cw * kKeysQ * 128;
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        sm90::wgmma_rs<128>(acc, da[kk], desc_mn<kKeysQ>(kt + hoff, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[s]);
      ++i;
    }

#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int row = r0 + acc_row(t, i);
      const int col = d_o + 128 * cw + acc_col(t, i);
      if (row < a.Nq && col < a.D) {
        *reinterpret_cast<__nv_bfloat162*>(dq + ((size_t)bh * a.Nq + row) *
                                                    a.D + col) =
            __floats2bfloat162_rn(acc[i] * a.scale, acc[i + 1] * a.scale);
      }
    }
  }
  cluster_sync();
}

// dk and dv in T as the sums, in split order, of `splits` fp32 partials
// (part: [splits][dk, dv][n]), two elements a thread.
template <typename T>
__global__ void kv_sum_kernel(const float2* __restrict__ part,
                                             int splits, T* __restrict__ dk,
                                             T* __restrict__ dv, size_t n2) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n2;
       i += (size_t)gridDim.x * blockDim.x) {
    float2 k = part[i], v = part[n2 + i];
    for (int s = 1; s < splits; ++s) {
      const float2 pk = part[2 * s * n2 + i], pv = part[(2 * s + 1) * n2 + i];
      k = make_float2(k.x + pk.x, k.y + pk.y);
      v = make_float2(v.x + pv.x, v.y + pv.y);
    }
    wide::store2(dk + 2 * i, k.x, k.y);
    wide::store2(dv + 2 * i, v.x, v.y);
  }
}

template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, dim3 grid, int C, size_t smem,
                           cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreadsC);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

inline bool bad_plan(const AttnArgs& a, const Plan& pl, const void* scratch) {
  return pl.nch != (a.D + kW - 1) / kW || pl.C < 1 || pl.C > kMaxCluster ||
         pl.groups < 1 || (pl.C - 1) * pl.groups >= pl.nch ||
         pl.C * pl.groups < pl.nch || pl.splits < 1 ||
         (a.H / a.H_kv) % pl.splits != 0 ||
         (pl.splits > 1 && scratch == nullptr) ||
         (long long)a.B * a.H_kv * pl.splits > 65535 ||
         (a.Nk + kKeysKV - 1) / kKeysKV > 65535 ||
         (a.Nq + kRowsQ - 1) / kRowsQ > 65535 ||
         (long long)a.B * a.H > 65535;
}

// The dK/dV kernel, with splits the sum, then the dQ kernel.
inline cudaError_t launch_bwd_bf16(const AttnArgs& a, const Plan& pl,
                                   const void* dout, const float* lse,
                                   const float* di, void* dq, void* dk,
                                   void* dv, float* scratch, cudaStream_t st) {
  using Bf = __nv_bfloat16;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = sm90::make_map(&tq, a.q, a.B * a.H, a.Nq, a.D, kRowsKV);
  if (err == cudaSuccess) {
    err = sm90::make_map(&tdo, dout, a.B * a.H, a.Nq, a.D, kRowsKV);
  }
  if (err == cudaSuccess) {
    err = sm90::make_map(&tk, a.k, a.B * a.H_kv, a.Nk, a.D, kKeysKV);
  }
  if (err == cudaSuccess) {
    err = sm90::make_map(&tv, a.v, a.B * a.H_kv, a.Nk, a.D, kKeysKV);
  }
  if (err != cudaSuccess) return err;
  const dim3 grid_kv(pl.C * pl.groups, (a.Nk + kKeysKV - 1) / kKeysKV,
                     a.B * a.H_kv * pl.splits);
  err = launch_cluster(flash_bwd_dkv_wide_sm90_kernel, grid_kv, pl.C,
                       DkvCfg::SMEM, st, tq, tk, tv, tdo, a, pl, lse, di,
                       static_cast<Bf*>(dk), static_cast<Bf*>(dv), scratch);
  if (err != cudaSuccess) return err;
  if (pl.splits > 1) {
    const size_t n2 = (size_t)a.B * a.H_kv * a.Nk * a.D / 2;
    kv_sum_kernel<Bf><<<sm90::stream_blocks(n2 / 2), 256, 0, st>>>(
        reinterpret_cast<const float2*>(scratch), pl.splits,
        static_cast<Bf*>(dk), static_cast<Bf*>(dv), n2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  err = sm90::make_map(&tq, a.q, a.B * a.H, a.Nq, a.D, kRowsQ);
  if (err == cudaSuccess) {
    err = sm90::make_map(&tdo, dout, a.B * a.H, a.Nq, a.D, kRowsQ);
  }
  if (err == cudaSuccess) {
    err = sm90::make_map(&tk, a.k, a.B * a.H_kv, a.Nk, a.D, kKeysQ);
  }
  if (err == cudaSuccess) {
    err = sm90::make_map(&tv, a.v, a.B * a.H_kv, a.Nk, a.D, kKeysQ);
  }
  if (err != cudaSuccess) return err;
  const dim3 grid_q(pl.C * pl.groups, (a.Nq + kRowsQ - 1) / kRowsQ,
                    a.B * a.H);
  return launch_cluster(flash_bwd_dq_wide_sm90_kernel, grid_q, pl.C,
                        DqCfg::SMEM, st, tq, tk, tv, tdo, a, pl, lse, di,
                        static_cast<Bf*>(dq));
}


// ---- fp32: the same clusters on 3xTF32 wgmma ------------------------------
//
// Each CTA is flash_bwd.cu's fp32 pair at D = 256 (DkvWideCfg, DqWideCfg:
// K and V, or q and dO, as landed, the A operands split in registers; the
// wrapper's scratch holds the B operands' two parts, split once a call;
// dV^T, dK^T and dQ^T computed transposed) for its chunk of 256 columns,
// with the consumers' hand-over replaced by the cluster's exchange. Shared
// memory has no room for more buffers (224 KB), so the exchange uses the
// 16 columns of the round(p_v)^T, round(ds)^T (or round(ds)) tiles that no
// product reads, as the hand-over did: buffer b's S (consumer 0's) region
// is the free half of one tile, its dP region that of another.

using sm90::DkvWideCfg;
using sm90::DqWideCfg;
using sm90::mma3_ra;
using sm90::mma3_rs_m;
using sm90::keep_regs;
using sm90::store_split2;
using sm90::sw_off1;
using sm90::tile_at;

// Rows [row, row + R) of `plane`, columns [col0, col0 + DP), into the fp32
// tile at dst (DP / 32 halves of R x 32); boxes past D land as zeros.
template <int R, int DP>
__device__ __forceinline__ void tma_cols32(char* dst, const CUtensorMap* map,
                                           uint64_t* bar, int col0, int row,
                                           int plane) {
  constexpr int BOX = sm90::box_rows<R>();
#pragma unroll
  for (int hf = 0; hf < DP / sm90::kHalf32; ++hf) {
#pragma unroll
    for (int rb = 0; rb < R / BOX; ++rb) {
      tma_load(dst + (hf * R + rb * BOX) * 128, map, bar,
               col0 + hf * sm90::kHalf32, row + rb * BOX, plane);
    }
  }
}

template <int R, int DP>
__device__ __forceinline__ void prefetch_cols32(const CUtensorMap* map,
                                                int col0, int row, int plane) {
  constexpr int BOX = sm90::box_rows<R>();
#pragma unroll
  for (int hf = 0; hf < DP / sm90::kHalf32; ++hf) {
#pragma unroll
    for (int rb = 0; rb < R / BOX; ++rb) {
      asm volatile(
          "cp.async.bulk.prefetch.tensor.3d.L2.global.tile [%0, {%1, %2, %3}];"
          ::"l"(reinterpret_cast<uint64_t>(map)),
          "r"(col0 + hf * sm90::kHalf32), "r"(row + rb * BOX), "r"(plane)
          : "memory");
    }
  }
}

// One CTA a (chunk of 256 columns, 64 keys, KV head x split, batch); the C
// CTAs of a cluster are the chunks of one key tile (groups == 1).
__global__ void __launch_bounds__(DkvWideCfg<kW>::THREADS, 1)
flash_bwd_dkv_wide_f32_sm90_kernel(const __grid_constant__ CUtensorMap tqb,
                                   const __grid_constant__ CUtensorMap tqs,
                                   const __grid_constant__ CUtensorMap tk,
                                   const __grid_constant__ CUtensorMap tv,
                                   const __grid_constant__ CUtensorMap tdob,
                                   const __grid_constant__ CUtensorMap tdos,
                                   const AttnArgs a, const Plan pl,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ di,
                                   float* __restrict__ dk,
                                   float* __restrict__ dv,
                                   float* __restrict__ part) {
  using Cfg = DkvWideCfg<kW>;
  constexpr int DP = kW, KEYS = Cfg::KEYS, R = Cfg::R, KVB = Cfg::KV_BYTES;
  constexpr int TB = Cfg::T_BYTES, XB = Cfg::X_BYTES;
  extern __shared__ char smem_raw[];
  char* kx = sm90::align_1024(smem_raw);  // [DP/32][KEYS][32] as landed
  char* vx = kx + KVB;
  char* qb = vx + KVB;  // q_s and dO in two parts, as split before the call
  char* qs = qb + TB;
  char* dob = qs + TB;
  char* dos = dob + TB;
  char* ptb = dos + TB;  // P_v^T and dS^T: [KEYS][32], query rows as columns
  char* pts = ptb + XB;
  char* dtb = pts + XB;
  char* dts = dtb + XB;
  float* lse_s = reinterpret_cast<float*>(dts + XB);
  float* di_s = lse_s + R;
  uint64_t* kv_landed = reinterpret_cast<uint64_t*>(di_s + R);
  uint64_t* landed = kv_landed + 1;
  uint64_t* ready_s = kv_landed + 2;  // the producer's rows of LSE and di
  uint64_t* empty = kv_landed + 3;
  uint64_t* ready = kv_landed + 4;
  uint64_t* freed = ready + 2;

  const int C = pl.C;
  const int chunk = blockIdx.x, d_o = chunk * kW;
  const int c0 = blockIdx.y * KEYS;
  const int zz = blockIdx.z, b = zz / (a.H_kv * pl.splits);
  const int hk = zz / pl.splits % a.H_kv, sp = zz % pl.splits;
  const int G = a.H / a.H_kv, GW = G / pl.splits;
  const int h_first = hk * G + sp * GW;  // first query head walked
  const int c_last = min(c0 + KEYS, a.Nk) - 1;
  int r_begin = 0, r_end = a.Nq;
  if (a.causal) {
    r_begin = max(0, c0 - a.offset);
    if (a.window > 0 && !(a.sinks > 0 && c0 < a.sinks)) {
      r_end = min(a.Nq, c_last - a.offset + a.window);
    }
  }
  const int t0 = (r_begin / R) * R;
  const int n_rt = r_end > t0 ? (r_end - t0 + R - 1) / R : 0;
  const int n_it = GW * n_rt;  // (query head, row tile) steps

  if (threadIdx.x == 0) {
    mbar_init(kv_landed, 1);
    mbar_init(landed, 1);
    mbar_init(ready_s, sm90::kPrepThreads);
    mbar_init(empty, 256);
    for (int i = 0; i < 2; ++i) {
      mbar_init(&ready[i], C);
      mbar_init(&freed[i], C);
    }
    sm90::fence_barrier_init();
  }
  cluster_sync();

  if (threadIdx.x < 128) {  // producer
    sm90::reg_dealloc<sm90::kProducerRegsWide>();
    if (threadIdx.x == 0 && n_it > 0) {
      const int kvp = b * a.H_kv + hk;
      mbar_expect_tx(kv_landed, 2 * KVB);
      tma_cols32<KEYS, DP>(kx, &tk, kv_landed, d_o, c0, kvp);
      tma_cols32<KEYS, DP>(vx, &tv, kv_landed, d_o, c0, kvp);
      for (int it = 0; it < n_it; ++it) {
        const int plane = b * a.H + h_first + it / n_rt;
        const int r0 = t0 + (it % n_rt) * R;
        mbar_wait(empty, (it & 1) ^ 1);
        mbar_expect_tx(landed, 4 * TB);
        tma_cols32<R, DP>(qb, &tqb, landed, d_o, r0, plane);
        tma_cols32<R, DP>(qs, &tqs, landed, d_o, r0, plane);
        tma_cols32<R, DP>(dob, &tdob, landed, d_o, r0, plane);
        tma_cols32<R, DP>(dos, &tdos, landed, d_o, r0, plane);
        if (it + 1 < n_it) {  // the next step's tiles, into L2
          const int p1 = b * a.H + h_first + (it + 1) / n_rt;
          const int r1 = t0 + ((it + 1) % n_rt) * R;
          prefetch_cols32<R, DP>(&tqb, d_o, r1, p1);
          prefetch_cols32<R, DP>(&tqs, d_o, r1, p1);
          prefetch_cols32<R, DP>(&tdob, d_o, r1, p1);
          prefetch_cols32<R, DP>(&tdos, d_o, r1, p1);
        }
      }
    } else if (threadIdx.x >= 32 && n_it > 0) {
      const int tid = threadIdx.x - 32;
      for (int it = 0; it < n_it; ++it) {
        const int plane = b * a.H + h_first + it / n_rt;
        const int r0 = t0 + (it % n_rt) * R;
        mbar_wait(landed, it & 1);
        for (int j = tid; j < R; j += sm90::kPrepThreads) {
          const int row = r0 + j;
          const size_t at = (size_t)plane * a.Nq + row;
          lse_s[j] = row < a.Nq ? lse[at] : 0.f;
          di_s[j] = row < a.Nq ? di[at] : 0.f;
        }
        mbar_arrive(ready_s);
      }
    }
  } else {  // consumers: 64 keys, 128 of the chunk's columns each
    sm90::reg_alloc<sm90::kConsumerRegsWide>();
    const int cw = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const bool post = a.slopes != nullptr || a.softcap > 0.f;
    const Exchange<2, true> ex{{{ptb, pts}, {dtb, dts}}, ready, freed, C};
    float dk_acc[2][32], dv_acc[2][32];  // dK^T, dV^T: 2 x (64 cols x 64 keys)
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int i = 0; i < 32; ++i) dk_acc[m][i] = dv_acc[m][i] = 0.f;
    }

    if (n_it > 0) mbar_wait(kv_landed, 0);
    for (int it = 0; it < n_it; ++it) {
      const int h = h_first + it / n_rt;
      const int r0 = t0 + (it % n_rt) * R;
      const uint32_t bh = (uint32_t)(b * a.H + h);

      // the partial S^T (consumer 0) or dP^T (consumer 1): 64 keys x R rows
      float x[R / 2];
#pragma unroll
      for (int i = 0; i < R / 2; ++i) x[i] = 0.f;
      mbar_wait(ready_s, it & 1);
      mma3_ra<KEYS, R, DP / 8, Cfg::GS, Cfg::NB>(
          x, cw == 0 ? kx : vx, 1.f, cw == 0 ? qb : dob, cw == 0 ? qs : dos,
          t);
      float sv[4], dpv[4];  // the cluster's sums at this consumer's elements
      ex.sum(it, cw, t, x, sv, dpv);

      const int jc = 8 * cw + 2 * (t & 3);  // = acc_col(t, 4 cw)
      const float ls[2] = {lse_s[jc], lse_s[jc + 1]};
      const float dd[2] = {di_s[jc], di_s[jc + 1]};
      const int cls = sm90::tile_class(a, r0 + 8 * cw, r0 + 8 * cw + 7, c0,
                                       c0 + KEYS - 1);
      uint32_t seg[2] = {0u, 0u};
      if (cls == sm90::kSegments) {
        sm90::segment_bits<R>(a.kv_ids + (size_t)b * a.Nk, c0, a.Nk,
                              a.q_ids + (size_t)b * a.Nq, r0, a.Nq, t, seg);
      }
      float pv[4], ds[4];
      sm90::dispatch_tile(cls, post, [&](auto c, auto pp) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * cw + e;
          const int key = c0 + acc_row(t, i), j = acc_col(t, i);
          const int row = r0 + j;
          pv[e] = 0.f;
          ds[e] = 0.f;
          if (sm90::tile_visible<decltype(c)::value>(a, b, row, key, seg, i)) {
            float dcap;
            const float s = sm90::tile_score<decltype(pp)::value>(
                a, h, row, key, sv[e], &dcap);
            const float p = expf(s - ls[e & 1]);
            float dp = dpv[e];
            pv[e] = p;
            if (a.dropout) {
              const bool kept = keep(a, bh, row, key);
              pv[e] = kept ? p * a.drop_inv : 0.f;
              dp = kept ? dp * a.drop_inv : 0.f;
            }
            ds[e] = p * (dp - dd[e & 1]) * dcap;
          }
        }
      });
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int i = 4 * cw + e;
        const int at = sw_off1<KEYS>(acc_row(t, i), acc_col(t, i));
        store_split2(ptb, pts, at, pv[e], pv[e + 1]);
        store_split2(dtb, dts, at, ds[e], ds[e + 1]);
      }
      fence_proxy_async();

      // dV^T[cols] += dO^T[cols].P_v and dK^T[cols] += q_s^T[cols].dS, A
      // read across the stage's tiles; the stage is free once they are
      // loaded.
      uint32_t ob[2][R / 8][4], os[2][R / 8][4];
      uint32_t qab[2][R / 8][4], qas[2][R / 8][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int kk = 0; kk < R / 8; ++kk) {
          const int m0 = 128 * cw + 64 * m;
          tile_at<R>(dob, dos, m0, kk, t, ob[m][kk], os[m][kk]);
          tile_at<R>(qb, qs, m0, kk, t, qab[m][kk], qas[m][kk]);
        }
      }
      mbar_arrive(empty);
      named_sync(3, 256);  // P_v^T and dS^T are in place

      wgmma_fence();
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        fence_regs(dv_acc[m]);
        fence_regs(dk_acc[m]);
      }
      mma3_rs_m<KEYS, R / 8, 2>(dv_acc, ob, os, ptb, pts);
      mma3_rs_m<KEYS, R / 8, 2>(dk_acc, qab, qas, dtb, dts);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        fence_regs(dv_acc[m]);
        fence_regs(dk_acc[m]);
        keep_regs(ob[m]);
        keep_regs(os[m]);
        keep_regs(qab[m]);
        keep_regs(qas[m]);
      }
    }

    // dK^T and dV^T fragments: rows are head-dim columns, columns keys;
    // with splits, this split's partial sums.
    const size_t kv_off = ((size_t)b * a.H_kv + hk) * a.Nk;
    if (pl.splits > 1) {
      const size_t nk = (size_t)a.B * a.H_kv * a.Nk * a.D;
      dk = part + 2 * sp * nk;
      dv = dk + nk;
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = d_o + 128 * cw + 64 * m + acc_row(t, i);
        const int key = c0 + acc_col(t, i);
        if (key < a.Nk && col < a.D) {
          const size_t at = (kv_off + key) * a.D + col;
          dk[at] = dk_acc[m][i];
          dv[at] = dv_acc[m][i];
        }
      }
    }
  }
  cluster_sync();
}

// dQ: one CTA a (chunk, 64 query rows, head, batch). Its two tiles of
// round(ds) give buffer 0, and two spare tiles (16 KB, 224 KB in all)
// buffer 1, of the exchange.
struct DqF32Cfg {
  using Base = DqWideCfg<kW>;
  static constexpr size_t SMEM = Base::SMEM + 2 * Base::X_BYTES + 8 * 4;
};

__global__ void __launch_bounds__(DqWideCfg<kW>::THREADS, 1)
flash_bwd_dq_wide_f32_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tkb,
                                  const __grid_constant__ CUtensorMap tks,
                                  const __grid_constant__ CUtensorMap tvb,
                                  const __grid_constant__ CUtensorMap tvs,
                                  const __grid_constant__ CUtensorMap tdo,
                                  const AttnArgs a, const Plan pl,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ di,
                                  float* __restrict__ dq) {
  using Cfg = DqWideCfg<kW>;
  constexpr int DP = kW, ROWS = Cfg::ROWS, KEYS = Cfg::KEYS;
  constexpr int QB = Cfg::Q_BYTES, TB = Cfg::T_BYTES, XB = Cfg::X_BYTES;
  extern __shared__ char smem_raw[];
  char* qx = sm90::align_1024(smem_raw);  // [DP/32][ROWS][32] as landed
  char* dox = qx + QB;
  char* kb = dox + QB;  // K and V in two parts, as split before the call
  char* ks = kb + TB;
  char* vb = ks + TB;
  char* vs = vb + TB;
  char* dsb = vs + TB;  // dS: [ROWS][32], keys as columns
  char* dss = dsb + XB;
  char* xs0 = dss + XB;  // the exchange's second buffer
  char* xs1 = xs0 + XB;
  uint64_t* q_landed = reinterpret_cast<uint64_t*>(xs1 + XB);
  uint64_t* landed = q_landed + 1;
  uint64_t* empty = q_landed + 2;
  uint64_t* ready = q_landed + 3;
  uint64_t* freed = ready + 2;

  const int C = pl.C;
  const int chunk = blockIdx.x, d_o = chunk * kW;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * ROWS;  // heavy first
  const int h = blockIdx.z % a.H, b = blockIdx.z / a.H;
  const int hk = h / (a.H / a.H_kv);
  const TileWalk walk = key_tiles(a, r0, min(r0 + ROWS, a.Nq) - 1, KEYS);

  if (threadIdx.x == 0) {
    mbar_init(q_landed, 1);
    mbar_init(landed, 1);
    mbar_init(empty, 256);
    for (int i = 0; i < 2; ++i) {
      mbar_init(&ready[i], C);
      mbar_init(&freed[i], C);
    }
    sm90::fence_barrier_init();
  }
  cluster_sync();

  if (threadIdx.x < 128) {  // producer: thread 0 issues TMA
    sm90::reg_dealloc<sm90::kProducerRegsWide>();
    if (threadIdx.x == 0 && walk.n_walk > 0) {
      const int kplane = b * a.H_kv + hk;
      mbar_expect_tx(q_landed, 2 * QB);
      tma_cols32<ROWS, DP>(qx, &tq, q_landed, d_o, r0, b * a.H + h);
      tma_cols32<ROWS, DP>(dox, &tdo, q_landed, d_o, r0, b * a.H + h);
      for (int w = 0; w < walk.n_walk; ++w) {
        const int c0 = walk.tile(w) * KEYS;
        mbar_wait(empty, (w & 1) ^ 1);
        mbar_expect_tx(landed, 4 * TB);
        tma_cols32<KEYS, DP>(kb, &tkb, landed, d_o, c0, kplane);
        tma_cols32<KEYS, DP>(ks, &tks, landed, d_o, c0, kplane);
        tma_cols32<KEYS, DP>(vb, &tvb, landed, d_o, c0, kplane);
        tma_cols32<KEYS, DP>(vs, &tvs, landed, d_o, c0, kplane);
        if (w + 1 < walk.n_walk) {  // the next step's tiles, into L2
          const int c1 = walk.tile(w + 1) * KEYS;
          prefetch_cols32<KEYS, DP>(&tkb, d_o, c1, kplane);
          prefetch_cols32<KEYS, DP>(&tks, d_o, c1, kplane);
          prefetch_cols32<KEYS, DP>(&tvb, d_o, c1, kplane);
          prefetch_cols32<KEYS, DP>(&tvs, d_o, c1, kplane);
        }
      }
    }
  } else {  // consumers: 64 query rows, 128 of the chunk's columns each
    sm90::reg_alloc<sm90::kConsumerRegsWide>();
    const int cw = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const uint32_t bh = (uint32_t)(b * a.H + h);
    const bool post = a.slopes != nullptr || a.softcap > 0.f;
    const Exchange<2, true> ex{{{dsb, dss}, {xs0, xs1}}, ready, freed, C};
    float lse_r[2], di_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + acc_row(t, 2 * r);
      lse_r[r] = row < a.Nq ? lse[(size_t)bh * a.Nq + row] : 0.f;
      di_r[r] = row < a.Nq ? di[(size_t)bh * a.Nq + row] : 0.f;
    }
    float acc[2][32];  // dQ^T: 2 tiles of 64 cols x 64 rows
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[m][i] = 0.f;
    }

    if (walk.n_walk > 0) mbar_wait(q_landed, 0);
    for (int w = 0; w < walk.n_walk; ++w) {
      const int c0 = walk.tile(w) * KEYS;

      float x[KEYS / 2];  // the partial S (consumer 0) or dP (consumer 1)
#pragma unroll
      for (int i = 0; i < KEYS / 2; ++i) x[i] = 0.f;
      mbar_wait(landed, w & 1);
      mma3_ra<ROWS, KEYS, DP / 8, Cfg::GS, Cfg::NB>(
          x, cw == 0 ? qx : dox, cw == 0 ? a.scale : 1.f, cw == 0 ? kb : vb,
          cw == 0 ? ks : vs, t);
      // dQ^T[cols] += K^T[cols].dS^T: its A operands, read across the K
      // tile; then the stage is free.
      uint32_t kab[2][KEYS / 8][4], kas[2][KEYS / 8][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int kk = 0; kk < KEYS / 8; ++kk) {
          tile_at<KEYS>(kb, ks, 128 * cw + 64 * m, kk, t, kab[m][kk],
                        kas[m][kk]);
        }
      }
      mbar_arrive(empty);
      float sv[4], dpv[4];
      ex.sum(w, cw, t, x, sv, dpv);

      const int cls =
          sm90::tile_class(a, r0, r0 + 63, c0 + 8 * cw, c0 + 8 * cw + 7);
      uint32_t seg[2] = {0u, 0u};
      if (cls == sm90::kSegments) {
        sm90::segment_bits<KEYS>(a.q_ids + (size_t)b * a.Nq, r0, a.Nq,
                                 a.kv_ids + (size_t)b * a.Nk, c0, a.Nk, t,
                                 seg);
      }
      float ds[4];
      sm90::dispatch_tile(cls, post, [&](auto c, auto pp) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * cw + e;
          const int r = (i >> 1) & 1;
          const int row = r0 + acc_row(t, i), col = c0 + acc_col(t, i);
          ds[e] = 0.f;
          if (sm90::tile_visible<decltype(c)::value>(a, b, row, col, seg, i)) {
            float dcap;
            const float s = sm90::tile_score<decltype(pp)::value>(
                a, h, row, col, sv[e], &dcap);
            const float p = expf(s - lse_r[r]);
            float d = dpv[e];
            if (a.dropout) d = keep(a, bh, row, col) ? d * a.drop_inv : 0.f;
            ds[e] = p * (d - di_r[r]) * dcap;
          }
        }
      });
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int i = 4 * cw + e;
        store_split2(dsb, dss, sw_off1<ROWS>(acc_row(t, i), acc_col(t, i)),
                     ds[e], ds[e + 1]);
      }
      fence_proxy_async();
      named_sync(3, 256);  // dS is in place

      wgmma_fence();
#pragma unroll
      for (int m = 0; m < 2; ++m) fence_regs(acc[m]);
      mma3_rs_m<ROWS, KEYS / 8, 2>(acc, kab, kas, dsb, dss);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        fence_regs(acc[m]);
        keep_regs(kab[m]);
        keep_regs(kas[m]);
      }
    }

    // dQ^T fragments: rows are head-dim columns, columns query rows.
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = d_o + 128 * cw + 64 * m + acc_row(t, i);
        const int row = r0 + acc_col(t, i);
        if (row < a.Nq && col < a.D) {
          dq[((size_t)bh * a.Nq + row) * a.D + col] = acc[m][i] * a.scale;
        }
      }
    }
  }
  cluster_sync();
}

// The fp32 backward: the operands split into the scratch, the dK/dV
// kernel, with splits the sum, then the dQ kernel.
inline cudaError_t launch_bwd_f32(const AttnArgs& a, const Plan& pl,
                                  const void* dout, const float* lse,
                                  const float* di, void* dq, void* dk,
                                  void* dv, float* scratch, cudaStream_t st) {
  using Kv = DkvWideCfg<kW>;
  const sm90::WideScratch w = sm90::wide_scratch(a, scratch, pl.splits);
  cudaError_t err = sm90::split_operands(a, dout, a.scale, w, st);
  if (err != cudaSuccess) return err;
  CUtensorMap m[6];
  err = sm90::dkv_wide_maps<kW>(m, a, w);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv(pl.C * pl.groups, (a.Nk + Kv::KEYS - 1) / Kv::KEYS,
                     a.B * a.H_kv * pl.splits);
  err = launch_cluster(flash_bwd_dkv_wide_f32_sm90_kernel, grid_kv, pl.C,
                       Kv::SMEM + 8 * 4, st, m[0], m[1], m[2], m[3], m[4],
                       m[5], a, pl, lse, di, static_cast<float*>(dk),
                       static_cast<float*>(dv), w.part);
  if (err == cudaSuccess) err = sm90::sum_partials(w, pl.splits, dk, dv, st);
  if (err == cudaSuccess) err = sm90::dq_wide_maps<kW>(m, a, dout, w);
  if (err != cudaSuccess) return err;
  const dim3 grid_q(pl.C * pl.groups,
                    (a.Nq + DqWideCfg<kW>::ROWS - 1) / DqWideCfg<kW>::ROWS,
                    a.B * a.H);
  return launch_cluster(flash_bwd_dq_wide_f32_sm90_kernel, grid_q, pl.C,
                        DqF32Cfg::SMEM, st, m[0], m[1], m[2], m[3], m[4],
                        m[5], a, pl, lse, di, static_cast<float*>(dq));
}

}  // namespace wbwd

}  // namespace fat

extern "C" {

// The forward above D = 256, bf16 (dtype 0) or fp32 (dtype 1); D % 8 == 0,
// q, k, v and o contiguous and 16-byte aligned. Same arguments as
// fat_flash_fwd in flash_fwd.cu. Returns cudaGetLastError().
int fat_flash_fwd_wide(const void* q, const void* k, const void* v, void* o,
                       void* lse, const void* q_ids, const void* kv_ids,
                       const void* slopes, int B, int H, int H_kv, int Nq,
                       int Nk, int D, float scale, int causal, int offset,
                       int window, int sinks, float softcap, float softcap_inv,
                       int dropout, uint32_t drop_threshold, uint32_t seed,
                       float drop_inv, int dtype, void* stream) {
  using namespace fat;
  if (wide::bad_shape(B, H, H_kv, Nq, Nk, D, dtype)) {
    return (int)cudaErrorInvalidValue;
  }
  AttnArgs a{q, k, v, static_cast<const int32_t*>(q_ids),
             static_cast<const int32_t*>(kv_ids),
             static_cast<const float*>(slopes), B, H, H_kv, Nq, Nk, D, scale,
             causal, offset, window, sinks, softcap, softcap_inv, dropout,
             drop_threshold, seed, drop_inv};
  auto st = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  return (int)(dtype == 0 ? wide::launch_fwd<__nv_bfloat16>(a, o, l, st)
                          : wide::launch_fwd<float>(a, o, l, st));
}

// The backward above D = 256: the dK/dV kernel (with kv_splits > 1 the
// sum of its partials), then the dQ kernel. The arguments of fat_flash_bwd
// in flash_bwd.cu, then the plan (ops/flash_attn._wide_bwd_plan): fp32
// scratch of 2 kv_splits B H_kv Nk D floats where kv_splits > 1 (else
// null), and the clusters (cluster CTAs, groups of them along D) of
// kv_splits.
int fat_flash_bwd_wide(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* di,
                       void* dq, void* dk, void* dv, const void* q_ids,
                       const void* kv_ids, const void* slopes, int B, int H,
                       int H_kv, int Nq, int Nk, int D, float scale,
                       int causal, int offset, int window, int sinks,
                       float softcap, float softcap_inv, int dropout,
                       uint32_t drop_threshold, uint32_t seed, float drop_inv,
                       int dtype, void* stream, void* scratch, int cluster,
                       int groups, int kv_splits) {
  using namespace fat;
  if (wide::bad_shape(B, H, H_kv, Nq, Nk, D, dtype)) {
    return (int)cudaErrorInvalidValue;
  }
  AttnArgs a{q, k, v, static_cast<const int32_t*>(q_ids),
             static_cast<const int32_t*>(kv_ids),
             static_cast<const float*>(slopes), B, H, H_kv, Nq, Nk, D, scale,
             causal, offset, window, sinks, softcap, softcap_inv, dropout,
             drop_threshold, seed, drop_inv};
  auto st = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const float*>(lse);
  const auto* d = static_cast<const float*>(di);
  if (dtype == 1 && cluster == 0) {  // fp32 above 8 chunks: the chunks
    return (int)wide::launch_bwd<float>(a, dout, l, d, dq, dk, dv, st);
  }
  const wbwd::Plan pl{(D + wbwd::kW - 1) / wbwd::kW, cluster, groups,
                      kv_splits};
  if (wbwd::bad_plan(a, pl, scratch) || (dtype == 1 && groups != 1) ||
      (dtype == 1 && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  auto* sc = static_cast<float*>(scratch);
  return (int)(dtype == 0 ? wbwd::launch_bwd_bf16(a, pl, dout, l, d, dq, dk,
                                                  dv, sc, st)
                          : wbwd::launch_bwd_f32(a, pl, dout, l, d, dq, dk,
                                                 dv, sc, st));
}

}  // extern "C"
