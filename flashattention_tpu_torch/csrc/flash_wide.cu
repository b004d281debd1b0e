// Flash attention above head dim 256 on Hopper (sm_90a): the forward (o and
// the fp32 LSE) and the backward's dK/dV and dQ kernels for any head dim,
// bf16 on mma.sync m16n8k16 and fp32 in 3xTF32 on mma.sync m16n8k8.
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
// What the design does about the head dim. An output with D columns (O, dQ,
// dK, dV) is cut into chunks of DC columns, one CTA a chunk (grid y = head
// x chunks): 128 for O, 128 (bf16) or 64 (fp32) for dQ and for dK/dV, whose
// CTA holds both; wider chunks spilled. Every
// product that reduces over D (S = Q.K^T, dP = dO.V^T and their transposes)
// runs over all of D in every chunk's CTA, in 64-column segments taken in
// one order by the same instructions, so the CTAs of one (row tile, head)
// compute the same scores bit for bit, the same running max and the same
// dropout mask, and their chunks of O share one normaliser. Tiles stream
// through a ring of kStages stages by cp.async, the same shared memory at
// every D: for each outer step (a key tile in the forward and dQ, a (query
// head, row tile) in dK/dV) ceil(D / 64) segment items, each the 64-column
// slices of the operands of S (and dP), then one chunk item, the DC-column
// tile that the step's P.V, dS.K, P^T.dO or dS^T.q_s reads. The CTA's
// operands are re-read from L2 once per outer step and chunk; the LSE is
// written by chunk 0. The segment and chunk tiles keep an odd number of
// 16-byte units a row (tc_row_bytes, f32_row_bytes), so ldmatrix reads
// them without bank conflicts; a column at or past D reads zeros.
//
// Layout of the work: 4 warps, a warp 16 query rows (forward, dQ: 64 rows a
// CTA, row tiles taken last to first) or 16 keys (dK/dV: 64 keys a CTA, 32
// query rows a step). Fragments as mma_sync.cuh and sparse_mma.cuh set
// out: A operands and N-major B operands by ldmatrix, MN-major bf16 B by
// ldmatrix.trans, MN-major fp32 B by 32-bit loads at the permuted k of
// sparse_mma.cuh (f32_b); an accumulator of P or dS is the A operand of its
// product without a shuffle.

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

// The backward above D = 256: the dK/dV kernel, then the dQ kernel. Same
// arguments as fat_flash_bwd in flash_bwd.cu.
int fat_flash_bwd_wide(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* di,
                       void* dq, void* dk, void* dv, const void* q_ids,
                       const void* kv_ids, const void* slopes, int B, int H,
                       int H_kv, int Nq, int Nk, int D, float scale,
                       int causal, int offset, int window, int sinks,
                       float softcap, float softcap_inv, int dropout,
                       uint32_t drop_threshold, uint32_t seed, float drop_inv,
                       int dtype, void* stream) {
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
  return (int)(dtype == 0 ? wide::launch_bwd<__nv_bfloat16>(a, dout, l, d, dq,
                                                            dk, dv, st)
                          : wide::launch_bwd<float>(a, dout, l, d, dq, dk, dv,
                                                    st));
}

}  // extern "C"
