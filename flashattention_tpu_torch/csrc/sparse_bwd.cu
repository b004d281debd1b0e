// Block-sparse flash-attention backward on Hopper (sm_90a): kernels B9, B10.
//
// Replaces: flashattention_tpu/ops/pallas_sparse.py, _sparse_bwd_dkv_kernel
// (B9) and _sparse_bwd_dq_kernel (B10). One call launches two kernels, as
// flash_bwd.cu does, and uses no atomics, so the result does not depend on
// block order:
//
//   dkv: one block per (key sub-tile of one KV block, KV head, batch). It
//        walks its KV block's transposed list q_list[ik][0 .. q_count[ik])
//        and, for each, the rows of that q block that can see its keys,
//        looping over the query heads of its GQA group, so dK and dV sum in
//        fp32 registers (the TPU kernel writes per-query-head fp32 partials
//        and group-sums them in XLA: the same sum). A KV block with count 0
//        stores zeros.
//   dq:  one block per (query sub-tile of one q block, head, batch). It
//        walks the q block's list kv_list[iq][0 .. kv_count[iq]) as the
//        forward does.
//
// Per kept element, with the TPU kernels' rounding points (not the dense
// backward's): s = (q . k in fp32) * scale (no q * scale rounded first);
// p = exp(s - lse) (zero where masked); dV += round_T(p) . do;
// dp = do . v; ds = p * (dp - di); dK += round_T(ds) . q and
// dQ += round_T(ds) . k, both unscaled and times the scale at the store.
// di = rowsum(o . do) - dlse comes from the caller; the element mask is the
// forward's (col < Nk and, when causal, col <= r + offset inside an active
// block). The grid is never sized from the counts.
//
// What bounds it on this card: 10 D flops per kept (head, row, key) on the
// tensor cores (989 TFLOP/s bf16; 165 fp32 on 3xTF32) against q, k, v, do
// and the three gradients moved once, so the operations. Both kernels
// recompute the scores (7 products per element instead of 5), the price of
// having no atomics.
//
// Four routes, chosen by the caller (ops/sparse_attn.py), and the first
// kernels, on no route:
//
//   fat_sparse_bwd_sm90 (bf16, D <= 256, block_q and block_k multiples of
//     64): every product on the tensor cores (wgmma, bf16 in, fp32
//     accumulate), tiles by TMA into mbarrier-guarded two-stage rings,
//     warpgroup 0 loading and NC consumer warpgroups computing (NC = 2
//     where the block holds 128 rows or keys, else 1: a CTA never spans two
//     blocks of the pattern). Instantiated at D 64, 128 and 256 (any D in
//     (128, 256] runs the 256 kernels; TMA reads zeros past D, a 64-column
//     half wholly past it included).
//     dkv, D <= 128: 64 NC keys per CTA, K and V resident in shared memory;
//       the producer walks the transposed list for each query head of the
//       group and streams q, dO (and the LSE and di rows) in tiles of 64
//       rows. The consumers compute transposed products so that Pᵀ and dSᵀ
//       come out in the register A layout: Sᵀ = K.qᵀ and dPᵀ = V.dOᵀ from
//       shared memory, dV += round(p)ᵀ.dO and dK += round(ds)ᵀ.q from
//       registers (dO, q MN-major; over 32 rows at a time at D = 128, for
//       registers).
//     dkv, 128 < D <= 256 (the D split, as flash_bwd.cu): one consumer's dK
//       and dV over 64 keys would take 256 registers a thread, above the
//       240 it has. So a CTA takes 64 keys whatever block_k is (a 128-key
//       block is two CTAs), both consumers share them, and each holds
//       columns [128 cw, 128 cw + 128) of dK and dV (128 registers). For
//       each (query head, q tile) step of the walk, each consumer computes
//       Sᵀ and dPᵀ for the 64 keys over its 32 of the tile's 64 rows,
//       writes round(p)ᵀ and round(ds)ᵀ into shared memory (swizzled as TMA
//       would, so wgmma reads them K-major), and after a named barrier both
//       run dV[:, half] += Pᵀ.dO[:, half] and dK[:, half] += dSᵀ.q[:, half]
//       over all 64 rows from shared memory. Nothing else orders the reuse
//       of the two buffers (the sparse backward rounds no q tile in place,
//       which orders it in flash_bwd.cu), so a second named barrier before
//       the writes waits until both consumers' products of the step before
//       have completed. K and V (32 KB each) stay resident; q and dO tiles
//       (32 KB each) in two stages; Pᵀ and dSᵀ 8 KB each: ~210 KB.
//     dq: 64 NC query rows per CTA, q and dO resident, K and V sub-tiles
//       streamed over the q block's list up to the causal stop (64 keys; 32
//       at D = 256, where dQ takes 128 registers, so a 64- or 128-key block
//       is walked in 32-key steps): S = q.Kᵀ, dP = dO.Vᵀ, dQ += round(ds).K
//       (K MN-major).
//     Each product's tile is classified once, interior or band, and the
//     element loop specialised for it.
//   fat_sparse_bwd_sm90_f32 (fp32, D <= 256, block_q and block_k multiples
//     of 64): the same two kernels with every product in 3xTF32, on the
//     schedules of flash_bwd.cu's fp32 kernels: up to D = 128 its D <= 128
//     pair, above (any D in (128, 256] runs the 256 instances) its wide
//     pair, whose B operands are split once a call into the wrapper's
//     scratch and whose dK/dV CTAs share a KV head's query heads, partials
//     summed in split order (tf32_wide_bwd.cuh). The tiles and stages are
//     set out where the kernels are defined, below.
//   fat_sparse_bwd_mma (bf16, D <= 256, block_q and block_k not both
//     multiples of 64): every product by mma.sync m16n8k16 on 16-row
//     slices anchored at each block's start (sparse_fwd.cu, sparse_mma.cuh).
//     dkv: 16 keys a warp, up to 4 slices of one KV block a CTA, K and V
//       resident; the CTA walks its share of the block's (query head, q
//       block) entries in 16-row steps of q, dO, LSE and di (a two-stage
//       ring), S^T = K.q^T and dP^T = V.dO^T, then dV += round(p)^T.dO and
//       dK += round(ds)^T.q with dO and q by ldmatrix.trans. Where the
//       trouble was: (1) at D = 256 one warp's dK and dV over 16 keys would
//       take 256 registers a thread, so two warps share a slice, each
//       holding half of D and adding the other's partial S^T and dP^T
//       through shared memory (fp32 adds commute, so both hold the same
//       sums); (2) a key slice past its block's end, or a step's rows past
//       their q block's end, are masked, and an idle warp keeps to every
//       barrier; (3) a global KV block (or, under GQA/MQA, any block: every
//       head of the group walks it) walked by one CTA set the backward's
//       time: 8x the others' steps at phase 7f's call, 2048 steps at phase
//       7b's MQA call (PERF.md rows 10s-11s). So a block's walk is cut
//       into chunks of MMA_CHUNK_STEPS (32) 16-row steps, one CTA each (in
//       fewer, longer chunks where the partials would pass
//       MMA_SCRATCH_BYTES, ops/sparse_attn.py), whose fp32 partials
//       sparse_bwd_sum_mma_kernel adds in chunk order
//       (a walk of one chunk stores bf16 itself); the grid covers the
//       longest walk the pattern allows and a chunk past its block's walk
//       exits, so the grid is still never sized from the counts; (4)
//       blocks that are multiples of 64 on one side only (128 x 32) take
//       this route, one q block's 8 slices over two CTAs.
//     dq: the forward's layout over the list (K and V sub-tiles in a
//       ring), S = q.K^T, dP = dO.V^T, dQ += round(ds).K with K by
//       ldmatrix.trans; q and dO held in registers up to D = 128.
//     A KV block no q block visits stores exact zeros.
//   fat_sparse_bwd_mma_f32 (fp32, D <= 256, blocks not both multiples of
//     64): the bf16 mma kernels' layouts, walks and chunks with every
//     product in 3xTF32 on mma.sync m16n8k8, each operand split in
//     registers where a warp reads it (sparse_mma.cuh). A operands and the
//     N-major B operands (K, V, q, dO in S^T, dP^T, S, dP) by ldmatrix; the
//     MN-major B operands (dO in P^T.dO, q in dS^T.q, K in dS.K) by 32-bit
//     loads in the permuted k order, P^T, dS^T and dS coming from their
//     accumulators without shuffles. A walk of one chunk stores fp32 dK and
//     dV itself; else sparse_bwd_sum_mma_kernel<float> adds the chunks'
//     partials in chunk order (deterministic). dQ streams 16-key sub-tiles
//     at D = 256 (q and dO, 33 KB a warp, beside 32-key stages would pass
//     227 KB), else 16 or 32 keys as bf16.
//   fat_sparse_bwd (on no route since the fp32 mma kernels; in bf16 and
//     fp32 the comparison chip_smoke.py times beside the other routes):
//     the first version below, fp32 FMAs on the CUDA cores (for the reasons
//     given in sparse_fwd.cu), 32-row / 32-key sub-tiles staged as fp32.

#include <climits>

#include "flash_common.cuh"
#include "sparse_mma.cuh"
#include "sparse_sm90.cuh"
#include "tf32_wide_bwd.cuh"

namespace fat {

// The call's four lists and block sizes.
struct Lists {
  const int32_t *kv_list, *kv_count, *q_list, *q_count;
  int kv_stride, q_stride, block_q, block_k;
};

}  // namespace fat

namespace {

using namespace fat;

// ---------------------------------------------------------------------------
// dK, dV
// ---------------------------------------------------------------------------

constexpr int kQRows = 32;  // query rows per staged tile: one per lane

template <int DMAX>
struct DkvCfg {
  static constexpr int KPW = 1024 / DMAX;  // keys per warp
  static constexpr int KEYS = kWarps * KPW;
  static constexpr int C = DMAX / 32;
  static constexpr int LD = DMAX + 4;
  static constexpr size_t SMEM =
      sizeof(float) * (2 * KEYS * LD + 2 * kQRows * LD + 2 * kWarps * KPW * kQRows);
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
sparse_bwd_dkv_kernel(AttnArgs a, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ di,
                      const int32_t* __restrict__ q_list,
                      const int32_t* __restrict__ q_count, int stride,
                      int block_q, int block_k, T* __restrict__ dk,
                      T* __restrict__ dv) {
  using Cfg = DkvCfg<DMAX>;
  constexpr int KPW = Cfg::KPW, KEYS = Cfg::KEYS, C = Cfg::C, LD = Cfg::LD;
  const int sub = (block_k + KEYS - 1) / KEYS;
  const int ik = blockIdx.x / sub;
  const int c0 = ik * block_k + (blockIdx.x % sub) * KEYS;
  const int c_end = min(ik * block_k + block_k, a.Nk);  // this KV block's keys
  if (c0 >= c_end) return;

  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [KEYS][LD]
  float* v_s = k_s + KEYS * LD;                  // [KEYS][LD]
  float* q_s = v_s + KEYS * LD;                  // [kQRows][LD]
  float* do_s = q_s + kQRows * LD;               // [kQRows][LD]
  float* pv_s = do_s + kQRows * LD;              // [kWarps][KPW][kQRows]
  float* ds_s = pv_s + kWarps * KPW * kQRows;    // [kWarps][KPW][kQRows]

  const int b = blockIdx.z, hk = blockIdx.y;
  const int G = a.H / a.H_kv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int D = a.D;
  const size_t kv_off = ((size_t)b * a.H_kv + hk) * a.Nk * D;
  const T* k = static_cast<const T*>(a.k) + kv_off;
  const T* v = static_cast<const T*>(a.v) + kv_off;

  for (int i = threadIdx.x; i < KEYS * DMAX; i += kThreads) {
    const int j = i / DMAX, d = i % DMAX, col = c0 + j;
    const bool ok = col < c_end && d < D;
    k_s[j * LD + d] = ok ? Num<T>::load(k[(size_t)col * D + d]) : 0.f;
    v_s[j * LD + d] = ok ? Num<T>::load(v[(size_t)col * D + d]) : 0.f;
  }

  float dk_acc[KPW][C], dv_acc[KPW][C];
#pragma unroll
  for (int j = 0; j < KPW; ++j) {
#pragma unroll
    for (int c = 0; c < C; ++c) dk_acc[j][c] = dv_acc[j][c] = 0.f;
  }
  float* my_pv = pv_s + warp * KPW * kQRows;
  float* my_ds = ds_s + warp * KPW * kQRows;
  const float* my_k = k_s + warp * KPW * LD;
  const float* my_v = v_s + warp * KPW * LD;
  const int n_active = q_count[ik];
  const int32_t* blocks = q_list + (size_t)ik * stride;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const size_t q_off = ((size_t)b * a.H + h) * a.Nq;
    const T* q = static_cast<const T*>(a.q) + q_off * D;
    const T* dO = dout + q_off * D;
    for (int w = 0; w < n_active; ++w) {
      const int r_lo = blocks[w] * block_q;
      const int r_hi = min(r_lo + block_q, a.Nq);  // this q block's rows
      // rows below c0 - offset see none of this block's keys
      const int r_begin = a.causal ? max(r_lo, c0 - a.offset) : r_lo;
      for (int r0 = r_begin; r0 < r_hi; r0 += kQRows) {
        __syncthreads();  // the previous tile is consumed (and K/V staged)
        for (int i = threadIdx.x; i < kQRows * DMAX; i += kThreads) {
          const int rr = i / DMAX, d = i % DMAX, r = r0 + rr;
          const bool ok = r < r_hi && d < D;
          q_s[rr * LD + d] = ok ? Num<T>::load(q[(size_t)r * D + d]) : 0.f;
          do_s[rr * LD + d] = ok ? Num<T>::load(dO[(size_t)r * D + d]) : 0.f;
        }
        __syncthreads();

        // Lane = query row; each warp scores its KPW keys.
        const int row = r0 + lane;
        float s[KPW], dp[KPW];
#pragma unroll
        for (int j = 0; j < KPW; ++j) s[j] = dp[j] = 0.f;
        const float4* qrow = reinterpret_cast<const float4*>(q_s + lane * LD);
        const float4* dorow = reinterpret_cast<const float4*>(do_s + lane * LD);
#pragma unroll 2
        for (int d4 = 0; d4 < DMAX / 4; ++d4) {
          const float4 qv = qrow[d4], dov = dorow[d4];
#pragma unroll
          for (int j = 0; j < KPW; ++j) {
            s[j] = dot4(qv, reinterpret_cast<const float4*>(my_k + j * LD)[d4], s[j]);
            dp[j] = dot4(dov, reinterpret_cast<const float4*>(my_v + j * LD)[d4], dp[j]);
          }
        }
        const bool row_ok = row < r_hi;
        const float lse_r = row_ok ? lse[q_off + row] : 0.f;
        const float di_r = row_ok ? di[q_off + row] : 0.f;
#pragma unroll
        for (int j = 0; j < KPW; ++j) {
          const int col = c0 + warp * KPW + j;
          float p = 0.f, ds = 0.f;
          if (row_ok && col < c_end && (!a.causal || col <= row + a.offset)) {
            p = expf(s[j] * a.scale - lse_r);
            ds = p * (dp[j] - di_r);
          }
          my_pv[j * kQRows + lane] = Num<T>::round(p);
          my_ds[j * kQRows + lane] = Num<T>::round(ds);
        }
        __syncwarp();

        // Lane = output columns lane, lane + 32, ...; sum over the 32 rows.
#pragma unroll 2
        for (int rr = 0; rr < kQRows; rr += 4) {
          float dov[4][C], qv[4][C];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
#pragma unroll
            for (int c = 0; c < C; ++c) {
              dov[t][c] = do_s[(rr + t) * LD + c * 32 + lane];
              qv[t][c] = q_s[(rr + t) * LD + c * 32 + lane];
            }
          }
#pragma unroll
          for (int j = 0; j < KPW; ++j) {
            const float4 p4 = *reinterpret_cast<const float4*>(my_pv + j * kQRows + rr);
            const float4 s4 = *reinterpret_cast<const float4*>(my_ds + j * kQRows + rr);
#pragma unroll
            for (int c = 0; c < C; ++c) {
              float x = dv_acc[j][c], y = dk_acc[j][c];
              x = fmaf(p4.x, dov[0][c], x);
              x = fmaf(p4.y, dov[1][c], x);
              x = fmaf(p4.z, dov[2][c], x);
              dv_acc[j][c] = fmaf(p4.w, dov[3][c], x);
              y = fmaf(s4.x, qv[0][c], y);
              y = fmaf(s4.y, qv[1][c], y);
              y = fmaf(s4.z, qv[2][c], y);
              dk_acc[j][c] = fmaf(s4.w, qv[3][c], y);
            }
          }
        }
        __syncwarp();
      }
    }
  }

#pragma unroll
  for (int j = 0; j < KPW; ++j) {
    const int col = c0 + warp * KPW + j;
    if (col >= c_end) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = c * 32 + lane;
      if (d < D) {
        dk[kv_off + (size_t)col * D + d] = Num<T>::store(dk_acc[j][c] * a.scale);
        dv[kv_off + (size_t)col * D + d] = Num<T>::store(dv_acc[j][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

constexpr int kTile = 32;  // keys per staged sub-tile: one per lane

template <int DMAX>
struct DqCfg {
  static constexpr int RPW = DMAX <= 64 ? 16 : (DMAX <= 128 ? 8 : 4);
  static constexpr int ROWS = kWarps * RPW;
  static constexpr int C = DMAX / 32;
  static constexpr int LD = DMAX + 4;
  static constexpr size_t SMEM =
      sizeof(float) * (2 * ROWS * LD + 2 * kTile * LD + kWarps * RPW * kTile);
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
sparse_bwd_dq_kernel(AttnArgs a, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di,
                     const int32_t* __restrict__ kv_list,
                     const int32_t* __restrict__ kv_count, int stride,
                     int block_q, int block_k, T* __restrict__ dq) {
  using Cfg = DqCfg<DMAX>;
  constexpr int RPW = Cfg::RPW, ROWS = Cfg::ROWS, C = Cfg::C, LD = Cfg::LD;
  const int sub = (block_q + ROWS - 1) / ROWS;
  const int iq = blockIdx.x / sub;
  const int r0 = iq * block_q + (blockIdx.x % sub) * ROWS;
  const int r_end = min(iq * block_q + block_q, a.Nq);  // this q block's rows
  if (r0 >= r_end) return;

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [ROWS][LD]
  float* do_s = q_s + ROWS * LD;                 // [ROWS][LD]
  float* k_s = do_s + ROWS * LD;                 // [kTile][LD]
  float* v_s = k_s + kTile * LD;                 // [kTile][LD]
  float* ds_s = v_s + kTile * LD;                // [kWarps][RPW][kTile]

  const int b = blockIdx.z, h = blockIdx.y;
  const int hk = h / (a.H / a.H_kv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int D = a.D;
  const size_t q_off = ((size_t)b * a.H + h) * a.Nq;
  const T* q = static_cast<const T*>(a.q) + q_off * D;
  const T* dO = dout + q_off * D;
  const T* k = static_cast<const T*>(a.k) + ((size_t)b * a.H_kv + hk) * a.Nk * D;
  const T* v = static_cast<const T*>(a.v) + ((size_t)b * a.H_kv + hk) * a.Nk * D;

  for (int i = threadIdx.x; i < ROWS * DMAX; i += kThreads) {
    const int rr = i / DMAX, d = i % DMAX, r = r0 + rr;
    const bool ok = r < r_end && d < D;
    q_s[rr * LD + d] = ok ? Num<T>::load(q[(size_t)r * D + d]) : 0.f;
    do_s[rr * LD + d] = ok ? Num<T>::load(dO[(size_t)r * D + d]) : 0.f;
  }

  float lse_r[RPW], di_r[RPW], acc[RPW][C];
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int row = r0 + warp * RPW + j;
    lse_r[j] = row < r_end ? lse[q_off + row] : 0.f;
    di_r[j] = row < r_end ? di[q_off + row] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[j][c] = 0.f;
  }
  float* my_ds = ds_s + warp * RPW * kTile;
  const int n_active = kv_count[iq];
  const int32_t* blocks = kv_list + (size_t)iq * stride;
  const int r_last = min(r0 + ROWS, r_end) - 1;

  for (int w = 0; w < n_active; ++w) {
    const int c_lo = blocks[w] * block_k;
    const int c_end = min(c_lo + block_k, a.Nk);  // this KV block's keys
    const int c_stop = a.causal ? min(c_end, r_last + a.offset + 1) : c_end;
    for (int c0 = c_lo; c0 < c_stop; c0 += kTile) {
      __syncthreads();
      for (int i = threadIdx.x; i < kTile * DMAX; i += kThreads) {
        const int j = i / DMAX, d = i % DMAX, col = c0 + j;
        const bool ok = col < c_end && d < D;
        k_s[j * LD + d] = ok ? Num<T>::load(k[(size_t)col * D + d]) : 0.f;
        v_s[j * LD + d] = ok ? Num<T>::load(v[(size_t)col * D + d]) : 0.f;
      }
      __syncthreads();

      // Lane = key; each warp scores its RPW rows.
      float s[RPW], dp[RPW];
#pragma unroll
      for (int j = 0; j < RPW; ++j) s[j] = dp[j] = 0.f;
      const float4* krow = reinterpret_cast<const float4*>(k_s + lane * LD);
      const float4* vrow = reinterpret_cast<const float4*>(v_s + lane * LD);
#pragma unroll 2
      for (int d4 = 0; d4 < DMAX / 4; ++d4) {
        const float4 kv = krow[d4], vv = vrow[d4];
#pragma unroll
        for (int j = 0; j < RPW; ++j) {
          const int rr = warp * RPW + j;
          s[j] = dot4(reinterpret_cast<const float4*>(q_s + rr * LD)[d4], kv, s[j]);
          dp[j] = dot4(reinterpret_cast<const float4*>(do_s + rr * LD)[d4], vv, dp[j]);
        }
      }
      const int col = c0 + lane;
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        const int row = r0 + warp * RPW + j;
        float ds = 0.f;
        if (row < r_end && col < c_end && (!a.causal || col <= row + a.offset)) {
          const float p = expf(s[j] * a.scale - lse_r[j]);
          ds = p * (dp[j] - di_r[j]);
        }
        my_ds[j * kTile + lane] = Num<T>::round(ds);
      }
      __syncwarp();

#pragma unroll 2
      for (int jj = 0; jj < kTile; jj += 4) {
        float kk[4][C];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
#pragma unroll
          for (int c = 0; c < C; ++c) kk[t][c] = k_s[(jj + t) * LD + c * 32 + lane];
        }
#pragma unroll
        for (int j = 0; j < RPW; ++j) {
          const float4 d4 = *reinterpret_cast<const float4*>(my_ds + j * kTile + jj);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            float x = acc[j][c];
            x = fmaf(d4.x, kk[0][c], x);
            x = fmaf(d4.y, kk[1][c], x);
            x = fmaf(d4.z, kk[2][c], x);
            acc[j][c] = fmaf(d4.w, kk[3][c], x);
          }
        }
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int row = r0 + warp * RPW + j;
    if (row >= r_end) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = c * 32 + lane;
      if (d < D) dq[(q_off + row) * D + d] = Num<T>::store(acc[j][c] * a.scale);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const AttnArgs& a, const Lists& s, const void* dout,
                   const float* lse, const float* di, void* dq, void* dk,
                   void* dv, cudaStream_t st) {
  const T* d_o = static_cast<const T*>(dout);
  using Kv = DkvCfg<DMAX>;
  auto dkv_kernel = sparse_bwd_dkv_kernel<T, DMAX>;
  cudaError_t err = set_smem(dkv_kernel, Kv::SMEM);
  if (err != cudaSuccess) return err;
  const int n_k_blocks = (a.Nk + s.block_k - 1) / s.block_k;
  const dim3 grid_kv(n_k_blocks * ((s.block_k + Kv::KEYS - 1) / Kv::KEYS),
                     a.H_kv, a.B);
  dkv_kernel<<<grid_kv, kThreads, Kv::SMEM, st>>>(
      a, d_o, lse, di, s.q_list, s.q_count, s.q_stride, s.block_q, s.block_k,
      static_cast<T*>(dk), static_cast<T*>(dv));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  using Q = DqCfg<DMAX>;
  auto dq_kernel = sparse_bwd_dq_kernel<T, DMAX>;
  err = set_smem(dq_kernel, Q::SMEM);
  if (err != cudaSuccess) return err;
  const int n_q_blocks = (a.Nq + s.block_q - 1) / s.block_q;
  const dim3 grid_q(n_q_blocks * ((s.block_q + Q::ROWS - 1) / Q::ROWS), a.H,
                    a.B);
  dq_kernel<<<grid_q, kThreads, Q::SMEM, st>>>(
      a, d_o, lse, di, s.kv_list, s.kv_count, s.kv_stride, s.block_q,
      s.block_k, static_cast<T*>(dq));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const AttnArgs& a, const Lists& s, const void* dout,
                     const float* lse, const float* di, void* dq, void* dk,
                     void* dv, cudaStream_t st) {
  if (a.D <= 64) return launch<T, 64>(a, s, dout, lse, di, dq, dk, dv, st);
  if (a.D <= 128) return launch<T, 128>(a, s, dout, lse, di, dq, dk, dv, st);
  return launch<T, 256>(a, s, dout, lse, di, dq, dk, dv, st);
}

}  // namespace

// ---------------------------------------------------------------------------
// The tensor-core route (bf16, D <= 256, blocks multiples of 64)
// ---------------------------------------------------------------------------

namespace fat {
namespace sm90 {

constexpr int kSpRows = 64;  // query rows per streamed q / dO tile (dkv)

template <int DP, int NC>
struct SparseDkvCfg {
  // Above D = 128 the two consumers split the head dim of one 64-key tile
  // (file header; NC is 2 there); below, each owns 64 of the CTA's keys.
  static constexpr bool SPLIT = DP > 128;
  static_assert(!SPLIT || NC == 2, "the D split takes two consumers");
  static constexpr int KEYS = SPLIT ? 64 : 64 * NC;  // keys per CTA, resident
  static constexpr int STAGES = 2;
  static constexpr int THREADS = 128 * (1 + NC);
  static constexpr int KV_BYTES = KEYS * DP * 2;     // K or V
  static constexpr int T_BYTES = kSpRows * DP * 2;   // one q or dO tile
  static constexpr int X_BYTES = SPLIT ? KEYS * kSpRows * 2 : 0;  // Pᵀ, dSᵀ
  static constexpr int BARS = 1 + 2 * STAGES;
  static constexpr size_t SMEM = 1024 + 2 * KV_BYTES + 2 * STAGES * T_BYTES +
                                 2 * X_BYTES + 2 * STAGES * kSpRows * 4 +
                                 8 * BARS;
};

template <int DP, int NC>
struct SparseDqCfg {
  static constexpr int ROWS = 64 * NC;  // query rows per CTA, resident
  // Keys per streamed K/V tile: at D = 256 the dQ accumulator (128
  // registers) leaves room for S and dP of 32 keys (16 + 16), as in
  // flash_bwd.cu.
  static constexpr int KEYS = DP <= 128 ? 64 : 32;
  static constexpr int STAGES = 2;
  static constexpr int THREADS = 128 * (1 + NC);
  static constexpr int Q_BYTES = ROWS * DP * 2;   // q or dO
  static constexpr int KV_BYTES = KEYS * DP * 2;  // one K or V tile
  static constexpr int BARS = 1 + 2 * STAGES;
  static constexpr size_t SMEM =
      1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARS;
};

// The tiles of `rows` rows [first, end) of the q block starting at row r_lo
// whose rows can see keys from c0 on.
struct RowTiles {
  int first, end;
};

__device__ __forceinline__ RowTiles row_tiles(const AttnArgs& a, int r_lo,
                                              int block_q, int c0,
                                              int rows = kSpRows) {
  const int r_hi = min(r_lo + block_q, a.Nq);
  // rows below c0 - offset see none of the CTA's keys
  const int r_begin = a.causal ? max(r_lo, c0 - a.offset) : r_lo;
  return {r_begin >= r_hi ? r_hi : r_lo + (r_begin - r_lo) / rows * rows,
          r_hi};
}

template <int DP, int NC>
__global__ void __launch_bounds__(SparseDkvCfg<DP, NC>::THREADS, 1)
sparse_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo, AttnArgs a,
                           const float* __restrict__ lse,
                           const float* __restrict__ di,
                           const int32_t* __restrict__ q_list,
                           const int32_t* __restrict__ q_count, int stride,
                           int block_q, int block_k,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv) {
  using Cfg = SparseDkvCfg<DP, NC>;
  constexpr int STAGES = Cfg::STAGES, KEYS = Cfg::KEYS;
  // Query rows per Sᵀ/dPᵀ product: at D = 128 the dK and dV accumulators
  // (128 registers) leave room for 32 rows of both, not 64; in the D split
  // each consumer takes 32 of the 64.
  constexpr int QS = DP <= 64 ? kSpRows : kSpRows / 2;
  // Heavy first: causal, an earlier KV block is seen by more q blocks, so
  // the grid's slowest dimension takes the KV blocks from the first one.
  const int sub = block_k / KEYS;
  const int ik = blockIdx.z / sub;
  const int c0 = ik * block_k + (blockIdx.z % sub) * KEYS;
  const int c_end = min(ik * block_k + block_k, a.Nk);  // this KV block's keys
  if (c0 >= c_end) return;

  extern __shared__ char smem_raw[];
  char* k_s = align_1024(smem_raw);          // [DP/64][KEYS][64], resident
  char* v_s = k_s + Cfg::KV_BYTES;           // resident
  char* q_s = v_s + Cfg::KV_BYTES;           // [STAGES] tiles of 64 rows
  char* do_s = q_s + STAGES * Cfg::T_BYTES;  // [STAGES] tiles of 64 rows
  char* pt_s = do_s + STAGES * Cfg::T_BYTES;  // D split: round(p)ᵀ
  char* dst_s = pt_s + Cfg::X_BYTES;          // D split: round(ds)ᵀ
  float* lse_s = reinterpret_cast<float*>(dst_s + Cfg::X_BYTES);
  float* di_s = lse_s + STAGES * kSpRows;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(di_s + STAGES * kSpRows);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int b = blockIdx.y, hk = blockIdx.x;
  const int G = a.H / a.H_kv;
  const int n_active = q_count[ik];
  const int32_t* blocks = q_list + (size_t)ik * stride;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * NC);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer: warp 0
    if constexpr (NC == 2) reg_dealloc<kProducerRegs>();
    const int lane = threadIdx.x;
    if (lane < 32) {
      int it = 0;
      for (int g = 0; g < G; ++g) {
        const int plane = b * a.H + hk * G + g;
        for (int w = 0; w < n_active; ++w) {
          const RowTiles rt = row_tiles(a, blocks[w] * block_q, block_q, c0);
          for (int r0 = rt.first; r0 < rt.end; r0 += kSpRows, ++it) {
            if (it == 0 && lane == 0) {
              mbar_expect_tx(kv_full, 2 * Cfg::KV_BYTES);
              tma_tile<KEYS, DP>(k_s, &tk, kv_full, c0, b * a.H_kv + hk);
              tma_tile<KEYS, DP>(v_s, &tv, kv_full, c0, b * a.H_kv + hk);
            }
            const int s = it % STAGES;
            mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
            for (int j = lane; j < kSpRows; j += 32) {
              const int row = r0 + j;
              const size_t at = (size_t)plane * a.Nq + row;
              lse_s[s * kSpRows + j] = row < a.Nq ? lse[at] : 0.f;
              di_s[s * kSpRows + j] = row < a.Nq ? di[at] : 0.f;
            }
            __threadfence_block();
            __syncwarp();  // the rows above land before lane 0 arrives
            if (lane == 0) {
              mbar_expect_tx(&full[s], 2 * Cfg::T_BYTES);
              tma_tile<kSpRows, DP>(q_s + s * Cfg::T_BYTES, &tq, &full[s], r0,
                                    plane);
              tma_tile<kSpRows, DP>(do_s + s * Cfg::T_BYTES, &tdo, &full[s],
                                    r0, plane);
            }
          }
        }
      }
    }
  } else {  // consumers: 64 keys each, or in the D split 64 keys shared
    if constexpr (NC == 2) reg_alloc<kConsumerRegs>();
    constexpr bool SPLIT = Cfg::SPLIT;
    constexpr int DA = SPLIT ? DP / 2 : DP;  // columns of dK, dV held here
    const int cw = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const int krow = SPLIT ? 0 : 64 * cw;  // first key in the K/V tiles
    const int key0 = c0 + krow, col0 = SPLIT ? DA * cw : 0;
    // Query rows of Sᵀ and dPᵀ this consumer takes: all 64, QS at a time,
    // or in the D split its QS.
    const int q_lo = SPLIT ? QS * cw : 0, q_hi = SPLIT ? q_lo + QS : kSpRows;
    float dk_acc[DA / 2], dv_acc[DA / 2];
#pragma unroll
    for (int i = 0; i < DA / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    int it = 0;
    for (int g = 0; g < G; ++g) {
      for (int w = 0; w < n_active; ++w) {
        const RowTiles rt = row_tiles(a, blocks[w] * block_q, block_q, c0);
        for (int r0 = rt.first; r0 < rt.end; r0 += kSpRows, ++it) {
          const int s = it % STAGES, ph = (it / STAGES) & 1;
          const char* qt = q_s + s * Cfg::T_BYTES;
          const char* dot = do_s + s * Cfg::T_BYTES;
          const float* ls = lse_s + s * kSpRows;
          const float* di_t = di_s + s * kSpRows;
          if (it == 0) mbar_wait(kv_full, 0);
          mbar_wait(&full[s], ph);

          // Sᵀ and dPᵀ over QS query rows at a time (64 keys x QS each),
          // one slice after the other (kept rolled: unrolled, the slices'
          // values overlap and spill at D = 128).
#pragma unroll 1
          for (int q0 = q_lo; q0 < q_hi; q0 += QS) {
            float st[QS / 2], dpt[QS / 2];
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < DP / 16; ++kk) {
              wgmma_ss<QS>(st, desc_k<KEYS>(k_s, krow, kk),
                           desc_k<kSpRows>(qt, q0, kk), kk > 0);
            }
#pragma unroll
            for (int kk = 0; kk < DP / 16; ++kk) {
              wgmma_ss<QS>(dpt, desc_k<KEYS>(v_s, krow, kk),
                           desc_k<kSpRows>(dot, q0, kk), kk > 0);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(st);
            fence_regs(dpt);

            // Rows of the slice: r0 + q0 ..; interior: every pair kept.
            const int rq = r0 + q0;
            const bool interior =
                key0 + 63 < c_end && rq + QS - 1 < a.Nq &&
                (!a.causal || key0 + 63 <= rq + a.offset);
            auto loop = [&](auto in) {
#pragma unroll
              for (int i = 0; i < QS / 2; ++i) {
                const int key = key0 + acc_row(t, i), j = q0 + acc_col(t, i);
                const int row = r0 + j;
                const bool vis = decltype(in)::value ||
                                 (row < a.Nq && kept(a, row, key, c_end));
                const float p = vis ? expf(st[i] * a.scale - ls[j]) : 0.f;
                st[i] = p;
                dpt[i] = p * (dpt[i] - di_t[j]);
              }
            };
            if (interior) {
              loop(Int<1>{});
            } else {
              loop(Int<0>{});
            }
            if constexpr (!SPLIT) {
              uint32_t pa[QS / 16][4], da[QS / 16][4];
              acc_to_a<QS>(st, pa);
              acc_to_a<QS>(dpt, da);

              wgmma_fence();
              fence_regs(dv_acc);
              fence_regs(dk_acc);
#pragma unroll
              for (int kk = 0; kk < QS / 16; ++kk) {
                const int k16 = q0 / 16 + kk;
                wgmma_rs<DP>(dv_acc, pa[kk], desc_mn<kSpRows>(dot, k16));
                wgmma_rs<DP>(dk_acc, da[kk], desc_mn<kSpRows>(qt, k16));
              }
            } else {
              // Both consumers' products of the step before, which read
              // Pᵀ and dSᵀ, have completed once both pass this barrier.
              named_sync(1, 256);
              // dV[:, half] += Pᵀ·dO[:, half], dK[:, half] += dSᵀ·q[:, half]
              // over the tile's 64 rows, through shared memory.
              dsplit_products<KEYS, kSpRows, QS>(st, dpt, pt_s, dst_s, dot,
                                                 qt, q0, cw, t, dv_acc,
                                                 dk_acc);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dv_acc);
            fence_regs(dk_acc);
          }
          mbar_arrive(&empty[s]);
        }
      }
    }

    // Keys of a KV block no q block visits write zeros.
    const size_t kv_off = ((size_t)b * a.H_kv + hk) * a.Nk;
#pragma unroll
    for (int i = 0; i < DA / 2; i += 2) {
      const int key = key0 + acc_row(t, i), col = col0 + acc_col(t, i);
      if (key < c_end && col < a.D) {
        const size_t at = (kv_off + key) * a.D + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
            dk_acc[i] * a.scale, dk_acc[i + 1] * a.scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
      }
    }
  }
}

template <int DP, int NC>
__global__ void __launch_bounds__(SparseDqCfg<DP, NC>::THREADS, 1)
sparse_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo, AttnArgs a,
                          const float* __restrict__ lse,
                          const float* __restrict__ di,
                          const int32_t* __restrict__ kv_list,
                          const int32_t* __restrict__ kv_count, int stride,
                          int block_q, int block_k,
                          __nv_bfloat16* __restrict__ dq) {
  using Cfg = SparseDqCfg<DP, NC>;
  constexpr int STAGES = Cfg::STAGES, ROWS = Cfg::ROWS, KEYS = Cfg::KEYS;
  // Heavy first, as the forward: the q blocks from the last one.
  const int sub = block_q / ROWS;
  const int iq = (a.Nq + block_q - 1) / block_q - 1 - blockIdx.z / sub;
  const int r0 = iq * block_q + (blockIdx.z % sub) * ROWS;
  const int r_end = min(iq * block_q + block_q, a.Nq);  // this q block's rows
  if (r0 >= r_end) return;

  extern __shared__ char smem_raw[];
  char* q_s = align_1024(smem_raw);          // [DP/64][ROWS][64], resident
  char* do_s = q_s + Cfg::Q_BYTES;           // resident
  char* k_s = do_s + Cfg::Q_BYTES;           // [STAGES] tiles
  char* v_s = k_s + STAGES * Cfg::KV_BYTES;  // [STAGES] tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + STAGES * Cfg::KV_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int b = blockIdx.y, h = blockIdx.x;
  const int hk = h / (a.H / a.H_kv);
  const ListWalk walk = list_walk(a, kv_list, kv_count, stride, iq, block_k,
                                  min(r0 + ROWS, r_end) - 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * NC);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer
    if constexpr (NC == 2) reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      const int kplane = b * a.H_kv + hk;
      int it = 0;
      for (int w = 0; w < walk.n_active; ++w) {
        for (int c0 = walk.lo(w); c0 < walk.stop_of(w); c0 += KEYS, ++it) {
          if (it == 0) {
            mbar_expect_tx(q_full, 2 * Cfg::Q_BYTES);
            tma_tile<ROWS, DP>(q_s, &tq, q_full, r0, b * a.H + h);
            tma_tile<ROWS, DP>(do_s, &tdo, q_full, r0, b * a.H + h);
          }
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], 2 * Cfg::KV_BYTES);
          tma_tile<KEYS, DP>(k_s + s * Cfg::KV_BYTES, &tk, &full[s], c0,
                             kplane);
          tma_tile<KEYS, DP>(v_s + s * Cfg::KV_BYTES, &tv, &full[s], c0,
                             kplane);
        }
      }
    }
  } else {  // consumers: 64 query rows each
    if constexpr (NC == 2) reg_alloc<kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const int row0 = r0 + 64 * cw;
    const size_t bh = (size_t)b * a.H + h;
    float lse_r[2], di_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + acc_row(t, 2 * r);
      lse_r[r] = row < a.Nq ? lse[bh * a.Nq + row] : 0.f;
      di_r[r] = row < a.Nq ? di[bh * a.Nq + row] : 0.f;
    }
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

    int it = 0;
    for (int w = 0; w < walk.n_active; ++w) {
      const int c_end = walk.end(w);
      for (int c0 = walk.lo(w); c0 < walk.stop_of(w); c0 += KEYS, ++it) {
        const int s = it % STAGES, ph = (it / STAGES) & 1;
        const char* kt = k_s + s * Cfg::KV_BYTES;
        const char* vt = v_s + s * Cfg::KV_BYTES;
        if (it == 0) mbar_wait(q_full, 0);

        float sc[KEYS / 2], dp[KEYS / 2];  // S and dP: 64 rows x KEYS
        mbar_wait(&full[s], ph);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          wgmma_ss<KEYS>(sc, desc_k<ROWS>(q_s, 64 * cw, kk),
                         desc_k<KEYS>(kt, 0, kk), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          wgmma_ss<KEYS>(dp, desc_k<ROWS>(do_s, 64 * cw, kk),
                         desc_k<KEYS>(vt, 0, kk), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);

        const bool interior = c0 + KEYS <= c_end &&
                              (!a.causal || c0 + KEYS - 1 <= row0 + a.offset);
        auto loop = [&](auto in) {
#pragma unroll
          for (int i = 0; i < KEYS / 2; ++i) {
            const int r = (i >> 1) & 1;
            const int row = row0 + acc_row(t, i), col = c0 + acc_col(t, i);
            const bool vis = decltype(in)::value || kept(a, row, col, c_end);
            const float p = vis ? expf(sc[i] * a.scale - lse_r[r]) : 0.f;
            sc[i] = p * (dp[i] - di_r[r]);
          }
        };
        if (interior) {
          loop(Int<1>{});
        } else {
          loop(Int<0>{});
        }
        uint32_t da[KEYS / 16][4];
        acc_to_a<KEYS>(sc, da);

        wgmma_fence();
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < KEYS / 16; ++kk) {
          wgmma_rs<DP>(acc, da[kk], desc_mn<KEYS>(kt, kk));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(&empty[s]);
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + acc_row(t, 2 * r);
      if (row >= r_end) continue;
      const size_t base = (bh * a.Nq + row) * a.D;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int col = acc_col(t, 4 * n);
        if (col < a.D) {
          *reinterpret_cast<__nv_bfloat162*>(dq + base + col) =
              __floats2bfloat162_rn(acc[4 * n + 2 * r] * a.scale,
                                    acc[4 * n + 2 * r + 1] * a.scale);
        }
      }
    }
  }
}

template <int DP, int NC>
cudaError_t launch_dkv_sm90(const CUtensorMap (&maps)[4], const AttnArgs& a,
                            const float* lse, const float* di,
                            const int32_t* q_list, const int32_t* q_count,
                            int stride, int block_q, int block_k, void* dk,
                            void* dv, cudaStream_t st) {
  using Cfg = SparseDkvCfg<DP, NC>;
  auto kernel = sparse_bwd_dkv_sm90_kernel<DP, NC>;
  const cudaError_t err = set_smem(kernel, Cfg::SMEM);
  if (err != cudaSuccess) return err;
  const int n_k_blocks = (a.Nk + block_k - 1) / block_k;
  const dim3 grid(a.H_kv, a.B, n_k_blocks * (block_k / Cfg::KEYS));
  kernel<<<grid, Cfg::THREADS, Cfg::SMEM, st>>>(
      maps[0], maps[1], maps[2], maps[3], a, lse, di, q_list, q_count, stride,
      block_q, block_k, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv));
  return cudaGetLastError();
}

template <int DP, int NC>
cudaError_t launch_dq_sm90(const CUtensorMap (&maps)[4], const AttnArgs& a,
                           const float* lse, const float* di,
                           const int32_t* kv_list, const int32_t* kv_count,
                           int stride, int block_q, int block_k, void* dq,
                           cudaStream_t st) {
  using Cfg = SparseDqCfg<DP, NC>;
  auto kernel = sparse_bwd_dq_sm90_kernel<DP, NC>;
  const cudaError_t err = set_smem(kernel, Cfg::SMEM);
  if (err != cudaSuccess) return err;
  const int n_q_blocks = (a.Nq + block_q - 1) / block_q;
  const dim3 grid(a.H, a.B, n_q_blocks * (block_q / Cfg::ROWS));
  kernel<<<grid, Cfg::THREADS, Cfg::SMEM, st>>>(
      maps[0], maps[1], maps[2], maps[3], a, lse, di, kv_list, kv_count,
      stride, block_q, block_k, static_cast<__nv_bfloat16*>(dq));
  return cudaGetLastError();
}

// The dK/dV kernel, then the dQ kernel; maps: q, k, v, dout. At D = 256
// the dK/dV kernel is the D split (two consumers on 64 keys whatever
// block_k is).
template <int DP>
cudaError_t sparse_bwd_sm90(const AttnArgs& a, const Lists& s,
                            const void* dout, const float* lse,
                            const float* di, void* dq, void* dk, void* dv,
                            cudaStream_t st) {
  CUtensorMap maps[4];
  cudaError_t err = make_map(&maps[0], a.q, a.B * a.H, a.Nq, a.D);
  if (err == cudaSuccess) err = make_map(&maps[1], a.k, a.B * a.H_kv, a.Nk, a.D);
  if (err == cudaSuccess) err = make_map(&maps[2], a.v, a.B * a.H_kv, a.Nk, a.D);
  if (err == cudaSuccess) err = make_map(&maps[3], dout, a.B * a.H, a.Nq, a.D);
  if (err != cudaSuccess) return err;
  if constexpr (SparseDkvCfg<DP, 2>::SPLIT) {
    err = launch_dkv_sm90<DP, 2>(maps, a, lse, di, s.q_list, s.q_count,
                                 s.q_stride, s.block_q, s.block_k, dk, dv, st);
  } else {
    err = s.block_k % 128 == 0
              ? launch_dkv_sm90<DP, 2>(maps, a, lse, di, s.q_list, s.q_count,
                                       s.q_stride, s.block_q, s.block_k, dk,
                                       dv, st)
              : launch_dkv_sm90<DP, 1>(maps, a, lse, di, s.q_list, s.q_count,
                                       s.q_stride, s.block_q, s.block_k, dk,
                                       dv, st);
  }
  if (err != cudaSuccess) return err;
  // The dQ kernel's K/V tiles of fewer than 64 keys need boxes of as many
  // rows (the launch above took its maps by value).
  constexpr int DQ_KEYS = SparseDqCfg<DP, 1>::KEYS;
  if constexpr (DQ_KEYS < kBox) {
    err = make_map(&maps[1], a.k, a.B * a.H_kv, a.Nk, a.D, DQ_KEYS);
    if (err == cudaSuccess) {
      err = make_map(&maps[2], a.v, a.B * a.H_kv, a.Nk, a.D, DQ_KEYS);
    }
    if (err != cudaSuccess) return err;
  }
  return s.block_q % 128 == 0
             ? launch_dq_sm90<DP, 2>(maps, a, lse, di, s.kv_list, s.kv_count,
                                     s.kv_stride, s.block_q, s.block_k, dq, st)
             : launch_dq_sm90<DP, 1>(maps, a, lse, di, s.kv_list, s.kv_count,
                                     s.kv_stride, s.block_q, s.block_k, dq,
                                     st);
}

// ---------------------------------------------------------------------------
// The fp32 tensor-core route (3xTF32, D <= 128, blocks multiples of 64)
// ---------------------------------------------------------------------------
//
// flash_bwd.cu's fp32 kernels (every product in 3xTF32, tf32_sm90.cuh) with
// the list walks above: resident operands (K and V in dkv; q and dO in dq)
// land by TMA and are split in place (big) and into a small part once;
// streamed tiles land in their stage, and warps 1-3 of the producer
// warpgroup transpose (for the products that read them MN-major) and split
// them, then release the stage. q is split unscaled: s = (q·k) * scale, and
// dK, dQ are scaled at the store, as the bf16 route. Shared memory holds
// ~225 KB where NC = 2 or D = 128:
//   dkv: 64 keys per consumer (NC = 2 only at D <= 64 where block_k % 128
//     == 0, so a CTA never spans two KV blocks), K and V in two parts
//     resident (128 KB); for each (query head, q block of the transposed
//     list) step of the walk, tiles of 16 of the block's rows that can see
//     the CTA's keys: q and dO in two parts, and qᵀ and dOᵀ in two parts,
//     padded to 32 columns, per stage (48 KB at D = 64, two stages; 96 KB at
//     D = 128, one stage).
//   dq: 64 query rows per consumer (NC = 2 only at D <= 64 where block_q %
//     128 == 0), q and dO in two parts resident (128 KB); K and V sub-tiles
//     of 32 keys in two parts and Kᵀ in two parts per stage, over the q
//     block's list up to the causal stop (48 KB at D = 64, two stages; 96 KB
//     at D = 128, one stage).

template <int DP, int NC>
struct SparseDkvF32Cfg {
  static_assert(DP <= 128 && (NC == 1 || DP <= 64), "fp32: D <= 128");
  static constexpr int KEYS = 64 * NC;  // keys per CTA
  static constexpr int R = 16;          // query rows per step
  static constexpr int STAGES = DP <= 64 ? 2 : 1;
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int KV_BYTES = KEYS * DP * 4;  // K or V, one part
  static constexpr int T_BYTES = R * DP * 4;      // q or dO, one part
  static constexpr int TT_BYTES = transposed_bytes<R, DP>();  // qᵀ, dOᵀ
  // stage: q big, q small, dO big, dO small, qᵀ b, s, dOᵀ b, s
  static constexpr int STAGE_BYTES = 4 * T_BYTES + 4 * TT_BYTES;
  static constexpr int BARS = 2 + 3 * STAGES;
  static constexpr size_t SMEM = 1024 + 4 * KV_BYTES + STAGES * STAGE_BYTES +
                                 2 * STAGES * R * 4 + 8 * BARS;
};

template <int DP, int NC>
struct SparseDqF32Cfg {
  static_assert(DP <= 128 && (NC == 1 || DP <= 64), "fp32: D <= 128");
  static constexpr int ROWS = 64 * NC;  // query rows per CTA
  static constexpr int KEYS = 32;       // keys per step
  static constexpr int STAGES = DP <= 64 ? 2 : 1;
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int Q_BYTES = ROWS * DP * 4;  // q or dO, one part
  static constexpr int T_BYTES = KEYS * DP * 4;  // K, V or Kᵀ, one part
  static_assert(transposed_bytes<KEYS, DP>() == T_BYTES, "Kᵀ tile size");
  // stage: K big, K small, V big, V small, Kᵀ big, Kᵀ small
  static constexpr int STAGE_BYTES = 6 * T_BYTES;
  static constexpr int BARS = 2 + 3 * STAGES;
  static constexpr size_t SMEM =
      1024 + 4 * Q_BYTES + STAGES * STAGE_BYTES + 8 * BARS;
};

template <int DP, int NC>
__global__ void __launch_bounds__(SparseDkvF32Cfg<DP, NC>::THREADS, 1)
sparse_bwd_dkv_f32_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               AttnArgs a, const float* __restrict__ lse,
                               const float* __restrict__ di,
                               const int32_t* __restrict__ q_list,
                               const int32_t* __restrict__ q_count,
                               int stride, int block_q, int block_k,
                               float* __restrict__ dk, float* __restrict__ dv) {
  using Cfg = SparseDkvF32Cfg<DP, NC>;
  constexpr int KEYS = Cfg::KEYS, R = Cfg::R, STAGES = Cfg::STAGES;
  constexpr int KVB = Cfg::KV_BYTES, TB = Cfg::T_BYTES, TT = Cfg::TT_BYTES;
  // Heavy first, as the bf16 route: the KV blocks from the first one.
  const int sub = block_k / KEYS;
  const int ik = blockIdx.z / sub;
  const int c0 = ik * block_k + (blockIdx.z % sub) * KEYS;
  const int c_end = min(ik * block_k + block_k, a.Nk);  // this KV block's keys
  if (c0 >= c_end) return;

  extern __shared__ char smem_raw[];
  char* kb = align_1024(smem_raw);  // [DP/32][KEYS][32] fp32
  char* ks = kb + KVB;
  char* vb = ks + KVB;
  char* vs = vb + KVB;
  char* stage0 = vs + KVB;
  float* lse_s = reinterpret_cast<float*>(stage0 + STAGES * Cfg::STAGE_BYTES);
  float* di_s = lse_s + STAGES * R;
  uint64_t* kv_landed = reinterpret_cast<uint64_t*>(di_s + STAGES * R);
  uint64_t* kv_ready = kv_landed + 1;
  uint64_t* landed = kv_ready + 1;
  uint64_t* ready = landed + STAGES;
  uint64_t* empty = ready + STAGES;

  const int b = blockIdx.y, hk = blockIdx.x;
  const int G = a.H / a.H_kv;
  const int n_active = q_count[ik];
  const int32_t* blocks = q_list + (size_t)ik * stride;

  if (threadIdx.x == 0) {
    mbar_init(kv_landed, 1);
    mbar_init(kv_ready, kPrepThreads);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&landed[s], 1);
      mbar_init(&ready[s], kPrepThreads);
      mbar_init(&empty[s], 128 * NC);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer
    if constexpr (NC == 2) reg_dealloc<kProducerRegs32>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int g = 0; g < G; ++g) {
        const int plane = b * a.H + hk * G + g;
        for (int w = 0; w < n_active; ++w) {
          const RowTiles rt =
              row_tiles(a, blocks[w] * block_q, block_q, c0, R);
          for (int r0 = rt.first; r0 < rt.end; r0 += R, ++it) {
            if (it == 0) {
              mbar_expect_tx(kv_landed, 2 * KVB);
              tma_tile32<KEYS, DP>(kb, &tk, kv_landed, c0, b * a.H_kv + hk);
              tma_tile32<KEYS, DP>(vb, &tv, kv_landed, c0, b * a.H_kv + hk);
            }
            const int s = it % STAGES;
            char* st = stage0 + s * Cfg::STAGE_BYTES;
            mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
            mbar_expect_tx(&landed[s], 2 * TB);
            tma_tile32<R, DP>(st, &tq, &landed[s], r0, plane);
            tma_tile32<R, DP>(st + 2 * TB, &tdo, &landed[s], r0, plane);
          }
        }
      }
    } else if (threadIdx.x >= 32) {
      const int tid = threadIdx.x - 32;
      int it = 0;
      for (int g = 0; g < G; ++g) {
        const int plane = b * a.H + hk * G + g;
        for (int w = 0; w < n_active; ++w) {
          const RowTiles rt =
              row_tiles(a, blocks[w] * block_q, block_q, c0, R);
          for (int r0 = rt.first; r0 < rt.end; r0 += R, ++it) {
            if (it == 0) {
              mbar_wait(kv_landed, 0);
              split_tile(kb, kb, ks, KVB, 1.f, tid, kPrepThreads);
              split_tile(vb, vb, vs, KVB, 1.f, tid, kPrepThreads);
              fence_proxy_async();
              mbar_arrive(kv_ready);
            }
            const int s = it % STAGES;
            char* st = stage0 + s * Cfg::STAGE_BYTES;
            char* tt = st + 4 * TB;  // qᵀ b, s, dOᵀ b, s
            // The stage is free once its tiles have landed (thread 0
            // waited for the consumers before loading them).
            mbar_wait(&landed[s], (it / STAGES) & 1);
            for (int j = tid; j < R; j += kPrepThreads) {
              const int row = r0 + j;
              const size_t at = (size_t)plane * a.Nq + row;
              lse_s[s * R + j] = row < a.Nq ? lse[at] : 0.f;
              di_s[s * R + j] = row < a.Nq ? di[at] : 0.f;
            }
            // qᵀ and dOᵀ from the landed tiles, then (once every thread
            // has read them) both split in place.
            transpose_split<R, DP>(st, tt, tt + TT, 1.f, tid, kPrepThreads);
            transpose_split<R, DP>(st + 2 * TB, tt + 2 * TT, tt + 3 * TT,
                                   1.f, tid, kPrepThreads);
            named_sync(1, kPrepThreads);
            split_tile(st, st, st + TB, TB, 1.f, tid, kPrepThreads);
            split_tile(st + 2 * TB, st + 2 * TB, st + 3 * TB, TB, 1.f, tid,
                       kPrepThreads);
            fence_proxy_async();
            mbar_arrive(&ready[s]);
          }
        }
      }
    }
  } else {  // consumers: 64 keys each
    if constexpr (NC == 2) reg_alloc<kConsumerRegs32>();
    const int cw = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const int key0 = c0 + 64 * cw;
    float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    int it = 0;
    for (int g = 0; g < G; ++g) {
      for (int w = 0; w < n_active; ++w) {
        const RowTiles rt = row_tiles(a, blocks[w] * block_q, block_q, c0, R);
        for (int r0 = rt.first; r0 < rt.end; r0 += R, ++it) {
          const int s = it % STAGES;
          const char* st = stage0 + s * Cfg::STAGE_BYTES;
          const char* tt = st + 4 * TB;
          const float* ls = lse_s + s * R;
          const float* di_t = di_s + s * R;
          if (it == 0) mbar_wait(kv_ready, 0);

          // Sᵀ = K·qᵀ and dPᵀ = V·dOᵀ (64 keys x R rows each). The
          // resident tiles' addresses pass through an empty asm each step:
          // else ptxas keeps their 4 DP / 8 descriptors live across the
          // walk, and at D = 128 that spilled (255 registers; 202 so).
          const char *kb_ = kb, *ks_ = ks, *vb_ = vb, *vs_ = vs;
          asm volatile("" : "+l"(kb_), "+l"(ks_), "+l"(vb_), "+l"(vs_));
          float sct[R / 2], dpt[R / 2];
          mbar_wait(&ready[s], (it / STAGES) & 1);
          wgmma_fence();
          mma3_ss<KEYS, R, DP / 8>(sct, kb_, ks_, 64 * cw, st, st + TB);
          mma3_ss<KEYS, R, DP / 8>(dpt, vb_, vs_, 64 * cw, st + 2 * TB,
                                   st + 3 * TB);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sct);
          fence_regs(dpt);

          // Interior: every (key, row) pair kept; else the mask per element.
          const bool interior =
              key0 + 63 < c_end && r0 + R - 1 < a.Nq &&
              (!a.causal || key0 + 63 <= r0 + a.offset);
          auto loop = [&](auto in) {
#pragma unroll
            for (int i = 0; i < R / 2; ++i) {
              const int key = key0 + acc_row(t, i), j = acc_col(t, i);
              const int row = r0 + j;
              const bool vis = decltype(in)::value ||
                               (row < a.Nq && kept(a, row, key, c_end));
              const float p = vis ? expf(sct[i] * a.scale - ls[j]) : 0.f;
              sct[i] = p;
              dpt[i] = p * (dpt[i] - di_t[j]);
            }
          };
          if (interior) {
            loop(Int<1>{});
          } else {
            loop(Int<0>{});
          }
          uint32_t pb[R / 8][4], ps[R / 8][4], db[R / 8][4], dsm[R / 8][4];
          acc_to_tf32_a<R>(sct, pb, ps);
          acc_to_tf32_a<R>(dpt, db, dsm);

          // dV += pᵀ·dO and dK += dsᵀ·q, against dOᵀ and qᵀ.
          wgmma_fence();
          fence_regs(dv_acc);
          fence_regs(dk_acc);
          mma3_rs<DP, R / 8>(dv_acc, pb, ps, tt + 2 * TT, tt + 3 * TT);
          mma3_rs<DP, R / 8>(dk_acc, db, dsm, tt, tt + TT);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dv_acc);
          fence_regs(dk_acc);
          keep_regs(pb);
          keep_regs(ps);
          keep_regs(db);
          keep_regs(dsm);
          mbar_arrive(&empty[s]);
        }
      }
    }

    // Keys of a KV block no q block visits write zeros.
    const size_t kv_off = ((size_t)b * a.H_kv + hk) * a.Nk;
#pragma unroll
    for (int i = 0; i < DP / 2; i += 2) {
      const int key = key0 + acc_row(t, i), col = acc_col(t, i);
      if (key < c_end && col < a.D) {
        const size_t at = (kv_off + key) * a.D + col;
        *reinterpret_cast<float2*>(dk + at) =
            make_float2(dk_acc[i] * a.scale, dk_acc[i + 1] * a.scale);
        *reinterpret_cast<float2*>(dv + at) =
            make_float2(dv_acc[i], dv_acc[i + 1]);
      }
    }
  }
}

template <int DP, int NC>
__global__ void __launch_bounds__(SparseDqF32Cfg<DP, NC>::THREADS, 1)
sparse_bwd_dq_f32_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              AttnArgs a, const float* __restrict__ lse,
                              const float* __restrict__ di,
                              const int32_t* __restrict__ kv_list,
                              const int32_t* __restrict__ kv_count, int stride,
                              int block_q, int block_k,
                              float* __restrict__ dq) {
  using Cfg = SparseDqF32Cfg<DP, NC>;
  constexpr int ROWS = Cfg::ROWS, KEYS = Cfg::KEYS, STAGES = Cfg::STAGES;
  constexpr int QB = Cfg::Q_BYTES, TB = Cfg::T_BYTES;
  // Heavy first, as the forward: the q blocks from the last one.
  const int sub = block_q / ROWS;
  const int iq = (a.Nq + block_q - 1) / block_q - 1 - blockIdx.z / sub;
  const int r0 = iq * block_q + (blockIdx.z % sub) * ROWS;
  const int r_end = min(iq * block_q + block_q, a.Nq);  // this q block's rows
  if (r0 >= r_end) return;

  extern __shared__ char smem_raw[];
  char* qb = align_1024(smem_raw);  // [DP/32][ROWS][32] fp32
  char* qs = qb + QB;
  char* dob = qs + QB;
  char* dos = dob + QB;
  char* stage0 = dos + QB;  // [STAGES][K b, s, V b, s, Kᵀ b, s]
  uint64_t* q_landed =
      reinterpret_cast<uint64_t*>(stage0 + STAGES * Cfg::STAGE_BYTES);
  uint64_t* q_ready = q_landed + 1;
  uint64_t* landed = q_ready + 1;
  uint64_t* ready = landed + STAGES;
  uint64_t* empty = ready + STAGES;

  const int b = blockIdx.y, h = blockIdx.x;
  const int hk = h / (a.H / a.H_kv);
  const ListWalk walk = list_walk(a, kv_list, kv_count, stride, iq, block_k,
                                  min(r0 + ROWS, r_end) - 1);

  if (threadIdx.x == 0) {
    mbar_init(q_landed, 1);
    mbar_init(q_ready, kPrepThreads);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&landed[s], 1);
      mbar_init(&ready[s], kPrepThreads);
      mbar_init(&empty[s], 128 * NC);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer
    if constexpr (NC == 2) reg_dealloc<kProducerRegs32>();
    if (threadIdx.x == 0) {
      const int kplane = b * a.H_kv + hk;
      int it = 0;
      for (int w = 0; w < walk.n_active; ++w) {
        for (int c0 = walk.lo(w); c0 < walk.stop_of(w); c0 += KEYS, ++it) {
          if (it == 0) {
            mbar_expect_tx(q_landed, 2 * QB);
            tma_tile32<ROWS, DP>(qb, &tq, q_landed, r0, b * a.H + h);
            tma_tile32<ROWS, DP>(dob, &tdo, q_landed, r0, b * a.H + h);
          }
          const int s = it % STAGES;
          char* st = stage0 + s * Cfg::STAGE_BYTES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&landed[s], 2 * TB);
          tma_tile32<KEYS, DP>(st, &tk, &landed[s], c0, kplane);
          tma_tile32<KEYS, DP>(st + 2 * TB, &tv, &landed[s], c0, kplane);
        }
      }
    } else if (threadIdx.x >= 32) {
      const int tid = threadIdx.x - 32;
      int it = 0;
      for (int w = 0; w < walk.n_active; ++w) {
        for (int c0 = walk.lo(w); c0 < walk.stop_of(w); c0 += KEYS, ++it) {
          if (it == 0) {
            mbar_wait(q_landed, 0);
            split_tile(qb, qb, qs, QB, 1.f, tid, kPrepThreads);
            split_tile(dob, dob, dos, QB, 1.f, tid, kPrepThreads);
            fence_proxy_async();
            mbar_arrive(q_ready);
          }
          const int s = it % STAGES;
          char* st = stage0 + s * Cfg::STAGE_BYTES;
          mbar_wait(&landed[s], (it / STAGES) & 1);
          // Kᵀ from the landed K, V split; K split in place once every
          // thread has read it.
          transpose_split<KEYS, DP>(st, st + 4 * TB, st + 5 * TB, 1.f, tid,
                                    kPrepThreads);
          split_tile(st + 2 * TB, st + 2 * TB, st + 3 * TB, TB, 1.f, tid,
                     kPrepThreads);
          named_sync(1, kPrepThreads);
          split_tile(st, st, st + TB, TB, 1.f, tid, kPrepThreads);
          fence_proxy_async();
          mbar_arrive(&ready[s]);
        }
      }
    }
  } else {  // consumers: 64 query rows each
    if constexpr (NC == 2) reg_alloc<kConsumerRegs32>();
    const int cw = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const int row0 = r0 + 64 * cw;
    const size_t bh = (size_t)b * a.H + h;
    float lse_r[2], di_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + acc_row(t, 2 * r);
      lse_r[r] = row < a.Nq ? lse[bh * a.Nq + row] : 0.f;
      di_r[r] = row < a.Nq ? di[bh * a.Nq + row] : 0.f;
    }
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

    int it = 0;
    for (int w = 0; w < walk.n_active; ++w) {
      const int c_end = walk.end(w);
      for (int c0 = walk.lo(w); c0 < walk.stop_of(w); c0 += KEYS, ++it) {
        const int s = it % STAGES;
        const char* st = stage0 + s * Cfg::STAGE_BYTES;
        if (it == 0) mbar_wait(q_ready, 0);

        float sc[KEYS / 2], dp[KEYS / 2];  // S and dP: 64 rows x KEYS
        mbar_wait(&ready[s], (it / STAGES) & 1);
        wgmma_fence();
        mma3_ss<ROWS, KEYS, DP / 8>(sc, qb, qs, 64 * cw, st, st + TB);
        mma3_ss<ROWS, KEYS, DP / 8>(dp, dob, dos, 64 * cw, st + 2 * TB,
                                    st + 3 * TB);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);

        const bool interior = c0 + KEYS <= c_end &&
                              (!a.causal || c0 + KEYS - 1 <= row0 + a.offset);
        auto loop = [&](auto in) {
#pragma unroll
          for (int i = 0; i < KEYS / 2; ++i) {
            const int r = (i >> 1) & 1;
            const int row = row0 + acc_row(t, i), col = c0 + acc_col(t, i);
            const bool vis = decltype(in)::value || kept(a, row, col, c_end);
            const float p = vis ? expf(sc[i] * a.scale - lse_r[r]) : 0.f;
            sc[i] = p * (dp[i] - di_r[r]);
          }
        };
        if (interior) {
          loop(Int<1>{});
        } else {
          loop(Int<0>{});
        }
        uint32_t db[KEYS / 8][4], dsm[KEYS / 8][4];
        acc_to_tf32_a<KEYS>(sc, db, dsm);

        wgmma_fence();
        fence_regs(acc);
        mma3_rs<DP, KEYS / 8>(acc, db, dsm, st + 4 * TB, st + 5 * TB);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        keep_regs(db);
        keep_regs(dsm);
        mbar_arrive(&empty[s]);
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + acc_row(t, 2 * r);
      if (row >= r_end) continue;
      const size_t base = (bh * a.Nq + row) * a.D;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int col = acc_col(t, 4 * n);
        if (col < a.D) {
          *reinterpret_cast<float2*>(dq + base + col) =
              make_float2(acc[4 * n + 2 * r] * a.scale,
                          acc[4 * n + 2 * r + 1] * a.scale);
        }
      }
    }
  }
}

template <int DP, int NC>
cudaError_t launch_dkv_f32_sm90(const CUtensorMap (&maps)[4],
                                const AttnArgs& a, const float* lse,
                                const float* di, const Lists& s, void* dk,
                                void* dv, cudaStream_t st) {
  using Cfg = SparseDkvF32Cfg<DP, NC>;
  auto kernel = sparse_bwd_dkv_f32_sm90_kernel<DP, NC>;
  const cudaError_t err = set_smem(kernel, Cfg::SMEM);
  if (err != cudaSuccess) return err;
  const int n_k_blocks = (a.Nk + s.block_k - 1) / s.block_k;
  const dim3 grid(a.H_kv, a.B, n_k_blocks * (s.block_k / Cfg::KEYS));
  kernel<<<grid, Cfg::THREADS, Cfg::SMEM, st>>>(
      maps[0], maps[1], maps[2], maps[3], a, lse, di, s.q_list, s.q_count,
      s.q_stride, s.block_q, s.block_k, static_cast<float*>(dk),
      static_cast<float*>(dv));
  return cudaGetLastError();
}

template <int DP, int NC>
cudaError_t launch_dq_f32_sm90(const CUtensorMap (&maps)[4],
                               const AttnArgs& a, const float* lse,
                               const float* di, const Lists& s, void* dq,
                               cudaStream_t st) {
  using Cfg = SparseDqF32Cfg<DP, NC>;
  auto kernel = sparse_bwd_dq_f32_sm90_kernel<DP, NC>;
  const cudaError_t err = set_smem(kernel, Cfg::SMEM);
  if (err != cudaSuccess) return err;
  const int n_q_blocks = (a.Nq + s.block_q - 1) / s.block_q;
  const dim3 grid(a.H, a.B, n_q_blocks * (s.block_q / Cfg::ROWS));
  kernel<<<grid, Cfg::THREADS, Cfg::SMEM, st>>>(
      maps[0], maps[1], maps[2], maps[3], a, lse, di, s.kv_list, s.kv_count,
      s.kv_stride, s.block_q, s.block_k, static_cast<float*>(dq));
  return cudaGetLastError();
}

// Maps q, k, v, dout of an fp32 call, in boxes of q_rows and kv_rows rows.
inline cudaError_t f32_maps(CUtensorMap (&maps)[4], const AttnArgs& a,
                            const void* dout, int q_rows, int kv_rows) {
  cudaError_t err = make_map32(&maps[0], a.q, a.B * a.H, a.Nq, a.D, q_rows);
  if (err == cudaSuccess) {
    err = make_map32(&maps[1], a.k, a.B * a.H_kv, a.Nk, a.D, kv_rows);
  }
  if (err == cudaSuccess) {
    err = make_map32(&maps[2], a.v, a.B * a.H_kv, a.Nk, a.D, kv_rows);
  }
  if (err == cudaSuccess) {
    err = make_map32(&maps[3], dout, a.B * a.H, a.Nq, a.D, q_rows);
  }
  return err;
}

// The fp32 dK/dV kernel, then the fp32 dQ kernel. Two consumers only at
// D <= 64 (shared memory) and where the block holds 128 keys (dK/dV) or
// rows (dQ), so a CTA never spans two blocks of the pattern.
template <int DP>
cudaError_t sparse_bwd_f32_sm90(const AttnArgs& a, const Lists& s,
                                const void* dout, const float* lse,
                                const float* di, void* dq, void* dk, void* dv,
                                cudaStream_t st) {
  using Kv = SparseDkvF32Cfg<DP, 1>;
  using Dq = SparseDqF32Cfg<DP, 1>;
  CUtensorMap maps[4];
  cudaError_t err = f32_maps(maps, a, dout, box_rows<Kv::R>(), box_rows<64>());
  if (err != cudaSuccess) return err;
  if constexpr (DP <= 64) {
    err = s.block_k % 128 == 0
              ? launch_dkv_f32_sm90<DP, 2>(maps, a, lse, di, s, dk, dv, st)
              : launch_dkv_f32_sm90<DP, 1>(maps, a, lse, di, s, dk, dv, st);
  } else {
    err = launch_dkv_f32_sm90<DP, 1>(maps, a, lse, di, s, dk, dv, st);
  }
  if (err != cudaSuccess) return err;
  // The dQ kernel reads q and dO in tiles of 64 or 128 rows (boxes of 64),
  // K and V of 32 (the launch above took its maps by value).
  err = f32_maps(maps, a, dout, box_rows<64>(), box_rows<Dq::KEYS>());
  if (err != cudaSuccess) return err;
  if constexpr (DP <= 64) {
    return s.block_q % 128 == 0
               ? launch_dq_f32_sm90<DP, 2>(maps, a, lse, di, s, dq, st)
               : launch_dq_f32_sm90<DP, 1>(maps, a, lse, di, s, dq, st);
  } else {
    return launch_dq_f32_sm90<DP, 1>(maps, a, lse, di, s, dq, st);
  }
}

// ---------------------------------------------------------------------------
// The fp32 tensor-core route at 128 < D <= 256 (3xTF32, operands split in
// registers)
// ---------------------------------------------------------------------------
//
// flash_bwd.cu's wide pair (DkvWideCfg, DqWideCfg: resident operands kept as
// landed and split in registers, products transposed, the B operands split
// once a call into the wrapper's scratch, two consumers splitting the
// small-N products and handing each other half of their fragments) with the
// list walks above and the sparse rounding points: q is split unscaled, s =
// (q·k) * scale, and dK and dQ are scaled at the store.
//   dkv: 64 keys a CTA (a 128-key block is two CTAs), walking for each
//     query head of its share of the group the transposed list and, for
//     each q block on it, the 16-row steps of the block's rows that can see
//     the CTA's keys (QTileWalk). A KV head's group is spread over `splits`
//     CTAs by the rule of ops/flash_attn._kv_splits, each writing its
//     partial sums (zeros where it walks nothing) for kv_sum_kernel to add
//     in split order.
//   dq: 64 query rows a CTA (one q block's), row tiles last to first,
//     walking the q block's list in 16-key steps up to the causal stop
//     (SubTileWalk).

// The steps of one dK/dV CTA, whose keys start at c0: for each of `heads`
// query heads, for each q block of its KV block's transposed list, the
// R-row tiles of that block that hold a row able to see key c0 or later
// (row_tiles). Producer, prep warps and consumers walk it alike; the
// producer looks one step ahead for its L2 prefetch.
template <int R>
struct QTileWalk {
  const int32_t* blocks;
  int n_active, block_q, Nq;
  int r_first;  // rows below it see none of the CTA's keys (causal), else 0
  int heads;
  int g, w, r0, r_hi;  // the step: head g of the share, list entry w, rows

  __device__ __forceinline__ void seek() {
    for (; g < heads; ++g, w = 0) {
      for (; w < n_active; ++w) {
        const int r_lo = blocks[w] * block_q;
        r_hi = min(r_lo + block_q, Nq);
        const int r_begin = max(r_lo, r_first);
        if (r_begin < r_hi) {
          r0 = r_lo + (r_begin - r_lo) / R * R;
          return;
        }
      }
    }
  }
  __device__ __forceinline__ bool more() const { return g < heads; }
  __device__ __forceinline__ void next() {
    r0 += R;
    if (r0 >= r_hi) {
      ++w;
      seek();
    }
  }
};

// The sub-tiles of KEYS keys of a q block's list walk, in order.
template <int KEYS>
struct SubTileWalk {
  ListWalk lw;
  int w, c0;

  __device__ __forceinline__ void seek() {
    for (; w < lw.n_active; ++w) {
      c0 = lw.lo(w);
      if (c0 < lw.stop_of(w)) return;
    }
  }
  __device__ __forceinline__ bool more() const { return w < lw.n_active; }
  __device__ __forceinline__ void next() {
    c0 += KEYS;
    if (c0 >= lw.stop_of(w)) {
      ++w;
      seek();
    }
  }
};

template <int DP>
__global__ void __launch_bounds__(DkvWideCfg<DP>::THREADS, 1)
sparse_bwd_dkv_f32_wide_sm90_kernel(
    const __grid_constant__ CUtensorMap tqb,
    const __grid_constant__ CUtensorMap tqs,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdob,
    const __grid_constant__ CUtensorMap tdos, AttnArgs a,
    const float* __restrict__ lse, const float* __restrict__ di,
    const int32_t* __restrict__ q_list, const int32_t* __restrict__ q_count,
    int stride, int block_q, int block_k, float* __restrict__ dk,
    float* __restrict__ dv, int splits, float* __restrict__ part) {
  using Cfg = DkvWideCfg<DP>;
  constexpr int KEYS = Cfg::KEYS, R = Cfg::R, KVB = Cfg::KV_BYTES;
  constexpr int TB = Cfg::T_BYTES, XB = Cfg::X_BYTES;
  extern __shared__ char smem_raw[];
  char* kx = align_1024(smem_raw);  // [DP/32][KEYS][32] fp32 as landed
  char* vx = kx + KVB;
  char* qb = vx + KVB;  // q and dO in two parts, as split before the call
  char* qs = qb + TB;
  char* dob = qs + TB;
  char* dos = dob + TB;
  char* ptb = dos + TB;  // Pᵀ and dSᵀ: [KEYS][32], query rows as columns
  char* pts = ptb + XB;
  char* dtb = pts + XB;
  char* dts = dtb + XB;
  float* lse_s = reinterpret_cast<float*>(dts + XB);
  float* di_s = lse_s + R;
  uint64_t* kv_landed = reinterpret_cast<uint64_t*>(di_s + R);
  uint64_t* landed = kv_landed + 1;
  uint64_t* ready = kv_landed + 2;
  uint64_t* empty = kv_landed + 3;

  // Heavy first: the key tiles from the first one, on the grid's slower
  // dimension, so that every split of a heavy KV block (the global column
  // of a local + global pattern) starts in the first wave. A KV head's
  // group of query heads is split over `splits` CTAs, each walking
  // G / splits of them and writing its sums to `part` (null when splits is
  // 1: dk and dv directly).
  const int b = blockIdx.z, c0 = blockIdx.y * KEYS;
  const int hk = blockIdx.x / splits, sp = blockIdx.x % splits;
  const int G = a.H / a.H_kv, GW = G / splits;
  const int h_first = hk * G + sp * GW;  // first query head walked
  const int ik = c0 / block_k;
  const int c_end = min(ik * block_k + block_k, a.Nk);  // this KV block's keys
  QTileWalk<R> walk{q_list + (size_t)ik * stride, q_count[ik], block_q, a.Nq,
                    a.causal ? c0 - a.offset : 0, GW, 0, 0, 0, 0};
  walk.seek();

  if (threadIdx.x == 0) {
    mbar_init(kv_landed, 1);
    mbar_init(landed, 1);
    mbar_init(ready, kPrepThreads);
    mbar_init(empty, 256);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer
    reg_dealloc<kProducerRegsWide>();
    if (threadIdx.x == 0 && walk.more()) {
      mbar_expect_tx(kv_landed, 2 * KVB);
      tma_tile32<KEYS, DP>(kx, &tk, kv_landed, c0, b * a.H_kv + hk);
      tma_tile32<KEYS, DP>(vx, &tv, kv_landed, c0, b * a.H_kv + hk);
      for (int it = 0; walk.more(); ++it) {
        const int plane = b * a.H + h_first + walk.g, r0 = walk.r0;
        mbar_wait(empty, (it & 1) ^ 1);
        mbar_expect_tx(landed, 4 * TB);
        tma_tile32<R, DP>(qb, &tqb, landed, r0, plane);
        tma_tile32<R, DP>(qs, &tqs, landed, r0, plane);
        tma_tile32<R, DP>(dob, &tdob, landed, r0, plane);
        tma_tile32<R, DP>(dos, &tdos, landed, r0, plane);
        walk.next();
        if (walk.more()) {  // the next step's tiles, into L2
          const int p1 = b * a.H + h_first + walk.g;
          tma_prefetch32<R, DP>(&tqb, walk.r0, p1);
          tma_prefetch32<R, DP>(&tqs, walk.r0, p1);
          tma_prefetch32<R, DP>(&tdob, walk.r0, p1);
          tma_prefetch32<R, DP>(&tdos, walk.r0, p1);
        }
      }
    } else if (threadIdx.x >= 32) {
      const int tid = threadIdx.x - 32;
      for (int it = 0; walk.more(); walk.next(), ++it) {
        const size_t plane = (size_t)b * a.H + h_first + walk.g;
        // The stage is free once its tiles have landed (thread 0 waited
        // for the consumers before loading them).
        mbar_wait(landed, it & 1);
        for (int j = tid; j < R; j += kPrepThreads) {
          const int row = walk.r0 + j;
          lse_s[j] = row < a.Nq ? lse[plane * a.Nq + row] : 0.f;
          di_s[j] = row < a.Nq ? di[plane * a.Nq + row] : 0.f;
        }
        mbar_arrive(ready);
      }
    }
  } else {  // consumers: 64 keys, 128 of the head dim's columns each
    reg_alloc<kConsumerRegsWide>();
    const int cw = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    float dk_acc[2][32], dv_acc[2][32];  // dKᵀ, dVᵀ: 2 x (64 cols x 64 keys)
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int i = 0; i < 32; ++i) dk_acc[m][i] = dv_acc[m][i] = 0.f;
    }

    for (int it = 0; walk.more(); walk.next(), ++it) {
      const int r0 = walk.r0;
      if (it == 0) mbar_wait(kv_landed, 0);

      // Sᵀ (consumer 0) or dPᵀ (consumer 1): 64 keys x R query rows
      float x[R / 2];
#pragma unroll
      for (int i = 0; i < R / 2; ++i) x[i] = 0.f;
      mbar_wait(ready, it & 1);
      mma3_ra<KEYS, R, DP / 8, Cfg::GS, Cfg::NB>(
          x, cw == 0 ? kx : vx, 1.f, cw == 0 ? qb : dob, cw == 0 ? qs : dos,
          t);

      // The LSE and di of this consumer's two query rows.
      const int jc = 8 * cw + 2 * (t & 3);  // = acc_col(t, 4 cw)
      const float ls[2] = {lse_s[jc], lse_s[jc + 1]};
      const float dd[2] = {di_s[jc], di_s[jc + 1]};

      // The element mask and p, ds on this consumer's half of the pairs
      // (elements [4 HF, 4 HF + 4): query rows 8 HF .. 8 HF + 7 of the
      // step); Pᵀ and dSᵀ split into their tiles.
      auto half = [&](auto hf) {
        constexpr int HF = decltype(hf)::value;
        float y[4];  // the other product at this consumer's elements
        hand_over<HF>(x, y, ptb, dtb, t);
        float pv[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * HF + e;
          const int key = c0 + acc_row(t, i), row = r0 + acc_col(t, i);
          pv[e] = 0.f;
          ds[e] = 0.f;
          if (row < a.Nq && kept(a, row, key, c_end)) {
            const float s = (HF == 0 ? x[i] : y[e]) * a.scale;
            const float p = expf(s - ls[e & 1]);
            pv[e] = p;
            ds[e] = p * ((HF == 0 ? y[e] : x[i]) - dd[e & 1]);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int i = 4 * HF + e;
          const int at = sw_off1<KEYS>(acc_row(t, i), acc_col(t, i));
          store_split2(ptb, pts, at, pv[e], pv[e + 1]);
          store_split2(dtb, dts, at, ds[e], ds[e + 1]);
        }
      };
      if (cw == 0) {
        half(Int<0>{});
      } else {
        half(Int<1>{});
      }
      fence_proxy_async();

      // dVᵀ[cols] += dOᵀ[cols]·P and dKᵀ[cols] += qᵀ[cols]·dS, A read
      // across the stage's tiles; the stage is free once they are loaded.
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
      named_sync(3, 256);  // Pᵀ and dSᵀ are in place

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

    // dKᵀ and dVᵀ fragments: rows are head-dim columns, columns keys. Keys
    // no step reached (a KV block no q block visits) write zeros, in every
    // split's partial too.
    const size_t kv_off = ((size_t)b * a.H_kv + hk) * a.Nk;
    if (part != nullptr) {  // partial sums of split sp, summed later
      const size_t nk = (size_t)a.B * a.H_kv * a.Nk * a.D;
      dk = part + 2 * sp * nk;
      dv = dk + nk;
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 128 * cw + 64 * m + acc_row(t, i);
        const int key = c0 + acc_col(t, i);
        if (key < c_end && col < a.D) {
          const size_t at = (kv_off + key) * a.D + col;
          dk[at] = dk_acc[m][i] * a.scale;
          dv[at] = dv_acc[m][i];
        }
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(DqWideCfg<DP>::THREADS, 1)
sparse_bwd_dq_f32_wide_sm90_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tkb,
    const __grid_constant__ CUtensorMap tks,
    const __grid_constant__ CUtensorMap tvb,
    const __grid_constant__ CUtensorMap tvs,
    const __grid_constant__ CUtensorMap tdo, AttnArgs a,
    const float* __restrict__ lse, const float* __restrict__ di,
    const int32_t* __restrict__ kv_list, const int32_t* __restrict__ kv_count,
    int stride, int block_q, int block_k, float* __restrict__ dq) {
  using Cfg = DqWideCfg<DP>;
  constexpr int ROWS = Cfg::ROWS, KEYS = Cfg::KEYS, QB = Cfg::Q_BYTES;
  constexpr int TB = Cfg::T_BYTES, XB = Cfg::X_BYTES;
  extern __shared__ char smem_raw[];
  char* qx = align_1024(smem_raw);  // [DP/32][ROWS][32] fp32 as landed
  char* dox = qx + QB;
  char* kb = dox + QB;  // K and V in two parts, as split before the call
  char* ks = kb + TB;
  char* vb = ks + TB;
  char* vs = vb + TB;
  char* dsb = vs + TB;  // dS: [ROWS][32], keys as columns
  char* dss = dsb + XB;
  uint64_t* q_landed = reinterpret_cast<uint64_t*>(dss + XB);
  uint64_t* landed = q_landed + 1;
  uint64_t* empty = q_landed + 2;

  // Heavy first, as the forward: the row tiles from the last one. A CTA's
  // 64 rows never span two q blocks (block_q is a multiple of 64).
  const int b = blockIdx.z, h = blockIdx.y;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * ROWS;
  const int iq = r0 / block_q;
  const int r_end = min(iq * block_q + block_q, a.Nq);  // this q block's rows
  const int hk = h / (a.H / a.H_kv);
  SubTileWalk<KEYS> walk{list_walk(a, kv_list, kv_count, stride, iq, block_k,
                                   min(r0 + ROWS, r_end) - 1),
                         0, 0};
  walk.seek();

  if (threadIdx.x == 0) {
    mbar_init(q_landed, 1);
    mbar_init(landed, 1);
    mbar_init(empty, 256);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer: thread 0 issues TMA
    reg_dealloc<kProducerRegsWide>();
    if (threadIdx.x == 0 && walk.more()) {
      const int kplane = b * a.H_kv + hk;
      mbar_expect_tx(q_landed, 2 * QB);
      tma_tile32<ROWS, DP>(qx, &tq, q_landed, r0, b * a.H + h);
      tma_tile32<ROWS, DP>(dox, &tdo, q_landed, r0, b * a.H + h);
      for (int it = 0; walk.more(); ++it) {
        const int c0 = walk.c0;
        mbar_wait(empty, (it & 1) ^ 1);
        mbar_expect_tx(landed, 4 * TB);
        tma_tile32<KEYS, DP>(kb, &tkb, landed, c0, kplane);
        tma_tile32<KEYS, DP>(ks, &tks, landed, c0, kplane);
        tma_tile32<KEYS, DP>(vb, &tvb, landed, c0, kplane);
        tma_tile32<KEYS, DP>(vs, &tvs, landed, c0, kplane);
        walk.next();
        if (walk.more()) {  // the next step's tiles, into L2
          tma_prefetch32<KEYS, DP>(&tkb, walk.c0, kplane);
          tma_prefetch32<KEYS, DP>(&tks, walk.c0, kplane);
          tma_prefetch32<KEYS, DP>(&tvb, walk.c0, kplane);
          tma_prefetch32<KEYS, DP>(&tvs, walk.c0, kplane);
        }
      }
    }
  } else {  // consumers: 64 query rows, 128 of the head dim's columns each
    reg_alloc<kConsumerRegsWide>();
    const int cw = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const size_t bh = (size_t)b * a.H + h;
    float lse_r[2], di_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + acc_row(t, 2 * r);
      lse_r[r] = row < a.Nq ? lse[bh * a.Nq + row] : 0.f;
      di_r[r] = row < a.Nq ? di[bh * a.Nq + row] : 0.f;
    }
    float acc[2][32];  // dQᵀ: 2 tiles of 64 cols x 64 rows
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[m][i] = 0.f;
    }

    for (int it = 0; walk.more(); walk.next(), ++it) {
      const int c0 = walk.c0, c_end = walk.lw.end(walk.w);
      if (it == 0) mbar_wait(q_landed, 0);

      float x[KEYS / 2];  // S (consumer 0) or dP (consumer 1): 64 x KEYS
#pragma unroll
      for (int i = 0; i < KEYS / 2; ++i) x[i] = 0.f;
      mbar_wait(landed, it & 1);
      mma3_ra<ROWS, KEYS, DP / 8, Cfg::GS, Cfg::NB>(
          x, cw == 0 ? qx : dox, 1.f, cw == 0 ? kb : vb, cw == 0 ? ks : vs,
          t);
      // dQᵀ[cols] += Kᵀ[cols]·dSᵀ: its A operands, read across the K tile;
      // then the stage is free.
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

      // The element mask and ds on this consumer's half of the pairs
      // (elements [4 HF, 4 HF + 4): keys 8 HF .. 8 HF + 7 of the step); dS
      // in two parts at (row, key), dQᵀ's B operand, K-major over keys.
      auto half = [&](auto hf) {
        constexpr int HF = decltype(hf)::value;
        float y[4];  // the other product at this consumer's elements
        hand_over<HF>(x, y, dsb, dss, t);
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * HF + e;
          const int r = (i >> 1) & 1;
          const int row = r0 + acc_row(t, i), col = c0 + acc_col(t, i);
          ds[e] = 0.f;
          if (row < a.Nq && kept(a, row, col, c_end)) {
            const float s = (HF == 0 ? x[i] : y[e]) * a.scale;
            const float p = expf(s - lse_r[r]);
            ds[e] = p * ((HF == 0 ? y[e] : x[i]) - di_r[r]);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int i = 4 * HF + e;
          store_split2(dsb, dss,
                       sw_off1<ROWS>(acc_row(t, i), acc_col(t, i)), ds[e],
                       ds[e + 1]);
        }
      };
      if (cw == 0) {
        half(Int<0>{});
      } else {
        half(Int<1>{});
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

    // dQᵀ fragments: rows are head-dim columns, columns query rows; rows of
    // a q block with count 0 write zeros.
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 128 * cw + 64 * m + acc_row(t, i);
        const int row = r0 + acc_col(t, i);
        if (row < r_end && col < a.D) {
          dq[(bh * a.Nq + row) * a.D + col] = acc[m][i] * a.scale;
        }
      }
    }
  }
}

// The wide dK/dV kernel (a KV head's group over `splits` CTAs), the sum of
// its partials where splits > 1, then the wide dQ kernel, after the split
// of q (unscaled), dO, K and V into `scratch` (tf32_wide_bwd.cuh).
template <int DP>
cudaError_t sparse_bwd_f32_wide_sm90(const AttnArgs& a, const Lists& s,
                                     const void* dout, const float* lse,
                                     const float* di, void* dq, void* dk,
                                     void* dv, float* scratch, int splits,
                                     cudaStream_t st) {
  using Kv = DkvWideCfg<DP>;
  using Dq = DqWideCfg<DP>;
  const WideScratch w = wide_scratch(a, scratch, splits);
  cudaError_t err = split_operands(a, dout, 1.f, w, st);
  if (err != cudaSuccess) return err;
  CUtensorMap m[6];
  err = dkv_wide_maps<DP>(m, a, w);
  if (err != cudaSuccess) return err;
  auto dkv_kernel = sparse_bwd_dkv_f32_wide_sm90_kernel<DP>;
  err = set_smem(dkv_kernel, Kv::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv(a.H_kv * splits, (a.Nk + Kv::KEYS - 1) / Kv::KEYS, a.B);
  dkv_kernel<<<grid_kv, Kv::THREADS, Kv::SMEM, st>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], a, lse, di, s.q_list, s.q_count,
      s.q_stride, s.block_q, s.block_k, static_cast<float*>(dk),
      static_cast<float*>(dv), splits, w.part);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = sum_partials(w, splits, dk, dv, st);
  if (err == cudaSuccess) err = dq_wide_maps<DP>(m, a, dout, w);
  if (err != cudaSuccess) return err;
  auto dq_kernel = sparse_bwd_dq_f32_wide_sm90_kernel<DP>;
  err = set_smem(dq_kernel, Dq::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((a.Nq + Dq::ROWS - 1) / Dq::ROWS, a.H, a.B);
  dq_kernel<<<grid_q, Dq::THREADS, Dq::SMEM, st>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], a, lse, di, s.kv_list, s.kv_count,
      s.kv_stride, s.block_q, s.block_k, static_cast<float*>(dq));
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace fat

// ---------------------------------------------------------------------------
// The mma route (bf16, D <= 256, blocks not both multiples of 64)
// ---------------------------------------------------------------------------

namespace fat {
namespace mma {

template <int DP>
struct DkvMmaCfg {
  // At D = 256 one warp's dK and dV over 16 keys would take 256 registers
  // a thread, above the 255 it has: two warps share the keys, each holding
  // half of the head dim, and add their partial S^T and dP^T through
  // shared memory.
  static constexpr int SPLIT = DP == 256 ? 2 : 1;
  static constexpr int DW = DP / SPLIT;  // dK / dV columns a warp holds
  // a ring step: 16 rows of q and of dO, their LSE and di
  __host__ __device__ static constexpr int stage(int rs) {
    return 2 * kSlice * rs + 2 * kSlice * 4;
  }
  __host__ __device__ static constexpr size_t smem(int warps, int rs) {
    return (size_t)2 * (warps / SPLIT) * kSlice * rs +
           (size_t)kStages * stage(rs) +
           (SPLIT == 2 ? (size_t)2 * warps * 32 * 16 * sizeof(float) : 0);
  }
};

// One CTA takes up to 4 slices of 16 keys of one KV block (2 at D = 256,
// two warps a slice), K and V resident in shared memory, and walks the
// block's transposed list for each query head of its share of the GQA
// group in 16-row steps of q, dO, LSE and di staged by all threads into a
// ring. Products are transposed so that P^T and dS^T come out of S^T's
// accumulator in the A layout: S^T = K.q^T and dP^T = V.dO^T, then dV +=
// round(p)^T.dO and dK += round(ds)^T.q with dO and q read by
// ldmatrix.trans. A KV block's walk is E = G * count entries (query head,
// q block); CTAs take chunks of `chunk_len` of them (blockIdx.y = KV head *
// chunks + chunk), so that a block many q blocks visit (a global column,
// and every block under MQA) is not walked by one CTA. Where E <= chunk_len
// chunk 0 takes it all and stores dK and dV in bf16; else each chunk
// writes fp32 partials of dK (scaled) and dV into `part` ([chunk][dk,
// dv][B, H_kv, Nk, D]) and sparse_bwd_sum_mma_kernel adds them in chunk
// order.
template <int DP>
__global__ void __launch_bounds__(kMaxWarps * 32)
sparse_bwd_dkv_mma_kernel(AttnArgs a, const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ di,
                          const int32_t* __restrict__ q_list,
                          const int32_t* __restrict__ q_count, int stride,
                          int block_q, int block_k,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv,
                          float* __restrict__ part, int chunk_len,
                          int chunks) {
  using Cfg = DkvMmaCfg<DP>;
  constexpr int SPLIT = Cfg::SPLIT, STAGES = kStages, KS = DP / 16;
  constexpr int DWS = Cfg::DW / 16;  // 16-column steps of a warp's dK / dV
  extern __shared__ __align__(128) char smem[];
  __shared__ __align__(16) uint4 zero_row;

  const int W = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int G = a.H / a.H_kv, D = a.D, rs = tc_row_bytes(D);
  const int ksteps = (D + 15) / 16;
  const int kslices = W / SPLIT;  // key slices a CTA
  const int per = ((block_k + kSlice - 1) / kSlice + kslices - 1) / kslices;
  const int ik = blockIdx.x / per;
  const int c_first = ik * block_k + blockIdx.x % per * kslices * kSlice;
  const int c_end = min(ik * block_k + block_k, a.Nk);  // this KV block's keys
  if (c_first >= c_end) return;  // the whole CTA past Nk
  const int half = warp % SPLIT;
  const int kb = c_first + warp / SPLIT * kSlice;  // this warp's first key
  const bool live = kb < c_end;
  const int b = blockIdx.z, hk = blockIdx.y / chunks;
  const int chunk = blockIdx.y % chunks, n = q_count[ik];
  const int e_lo = chunk * chunk_len, n_entries = G * n;
  if (chunk > 0 && e_lo >= n_entries) return;  // chunk 0 stores the zeros
  const bool direct = n_entries <= chunk_len;  // one CTA takes the block
  RowWalk ld{q_list + (size_t)ik * stride, n, block_q, a.Nq,
             a.causal ? c_first - a.offset : INT_MIN,
             min(n_entries, e_lo + chunk_len), 0, 0};
  ld.seek(e_lo);

  const auto* qg = static_cast<const __nv_bfloat16*>(a.q);
  const size_t kv_off = ((size_t)b * a.H_kv + hk) * a.Nk;
  char* k_s = smem;
  char* v_s = k_s + kslices * kSlice * rs;
  char* ring = v_s + kslices * kSlice * rs;
  const int stage_bytes = Cfg::stage(rs);
  float* xbuf = reinterpret_cast<float*>(ring + STAGES * stage_bytes);
  if (threadIdx.x == 0) zero_row = make_uint4(0u, 0u, 0u, 0u);
  const uint32_t zero = smem_u32(&zero_row);
  const RowCopy rc = row_copy<__nv_bfloat16>(D, threadIdx.x, blockDim.x);

  auto issue = [&](int st) {
    char* qt = ring + st * stage_bytes;
    float* ls = reinterpret_cast<float*>(qt + 2 * kSlice * rs);
    const size_t row0 =
        ((size_t)b * a.H + hk * G + ld.g()) * a.Nq + ld.r0;
    const int n_ok = ld.r_hi() - ld.r0;
    load_rows(rc, qt, qg + row0 * D, kSlice, n_ok, rs);
    load_rows(rc, qt + kSlice * rs, dout + row0 * D, kSlice, n_ok, rs);
    if (threadIdx.x < 2 * kSlice) {  // the LSE, then di
      const int j = threadIdx.x % kSlice;
      const bool ok = j < n_ok;
      cp_async4(smem_u32(ls + threadIdx.x),
                (threadIdx.x < kSlice ? lse : di) + row0 + (ok ? j : 0), ok);
    }
  };

  float dka[2 * DWS][4], dva[2 * DWS][4];
#pragma unroll
  for (int i = 0; i < 2 * DWS; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[i][c] = dva[i][c] = 0.f;
  }

  if (!ld.done()) {
    const size_t k0 = (kv_off + c_first) * D;
    load_rows(rc, k_s, static_cast<const __nv_bfloat16*>(a.k) + k0,
              kslices * kSlice, c_end - c_first, rs);
    load_rows(rc, v_s, static_cast<const __nv_bfloat16*>(a.v) + k0,
              kslices * kSlice, c_end - c_first, rs);
    RowWalk cw = ld;  // the products' cursor
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (!ld.done()) {
        issue(s);
        ld.next();
      }
      cp_async_commit();
    }
    const char* kt = k_s + (warp / SPLIT) * kSlice * rs;
    const char* vt = v_s + (warp / SPLIT) * kSlice * rs;
    for (int it = 0; !cw.done(); ++it, cw.next()) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // step `it` landed; every warp is past step it - 1
      if (!ld.done()) {
        issue((it + STAGES - 1) % STAGES);
        ld.next();
      }
      cp_async_commit();
      const char* qt = ring + it % STAGES * stage_bytes;
      const char* dot = qt + kSlice * rs;
      const float* ls = reinterpret_cast<const float*>(dot + kSlice * rs);
      const float* dis = ls + kSlice;

      // S^T and dP^T (16 keys x 16 rows) over this warp's columns
      float st[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) st[n][c] = dp[n][c] = 0.f;
      }
      if (live) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          if (ks >= ksteps || ks / (KS / SPLIT) != half) continue;
          uint32_t ak[4], av[4], bq[4], bo[4];
          const int da = ks * 16 + a_col(lane), db = ks * 16 + b_col(lane);
          ldsm_x4(ak, da < D ? smem_u32(kt + a_row(lane) * rs + da * 2) : zero);
          ldsm_x4(av, da < D ? smem_u32(vt + a_row(lane) * rs + da * 2) : zero);
          ldsm_x4(bq, db < D ? smem_u32(qt + b_row(lane) * rs + db * 2) : zero);
          ldsm_x4(bo, db < D ? smem_u32(dot + b_row(lane) * rs + db * 2)
                             : zero);
          mma_16816(st[0], ak, bq[0], bq[1]);
          mma_16816(st[1], ak, bq[2], bq[3]);
          mma_16816(dp[0], av, bo[0], bo[1]);
          mma_16816(dp[1], av, bo[2], bo[3]);
        }
      }
      if constexpr (SPLIT == 2) {  // add the other half's partials
        float4* xb = reinterpret_cast<float4*>(xbuf) + (it & 1) * W * 32 * 4;
        float4* mine = xb + (warp * 32 + lane) * 4;
        mine[0] = make_float4(st[0][0], st[0][1], st[0][2], st[0][3]);
        mine[1] = make_float4(st[1][0], st[1][1], st[1][2], st[1][3]);
        mine[2] = make_float4(dp[0][0], dp[0][1], dp[0][2], dp[0][3]);
        mine[3] = make_float4(dp[1][0], dp[1][1], dp[1][2], dp[1][3]);
        __syncthreads();
        const float4* other = xb + ((warp ^ 1) * 32 + lane) * 4;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float4 x = other[n], y = other[2 + n];
          st[n][0] += x.x;
          st[n][1] += x.y;
          st[n][2] += x.z;
          st[n][3] += x.w;
          dp[n][0] += y.x;
          dp[n][1] += y.y;
          dp[n][2] += y.z;
          dp[n][3] += y.w;
        }
      }
      if (!live) continue;

      // p^T and ds^T, rounded to bf16 in the A layout (k = the step's rows)
      const int r0 = cw.r0, r_hi = cw.r_hi();
      uint32_t pa[4], sa[4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float p[4], ds[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = kb + g + 8 * (c >> 1);
          const int rr = 8 * n + 2 * tq + (c & 1), row = r0 + rr;
          p[c] = row < r_hi && kept(a, row, key, c_end)
                     ? expf(st[n][c] * a.scale - ls[rr])
                     : 0.f;
          ds[c] = p[c] * (dp[n][c] - dis[rr]);
        }
        pa[2 * n] = pack_bf16(p[0], p[1]);
        pa[2 * n + 1] = pack_bf16(p[2], p[3]);
        sa[2 * n] = pack_bf16(ds[0], ds[1]);
        sa[2 * n + 1] = pack_bf16(ds[2], ds[3]);
      }
      // dV += round(p)^T.dO and dK += round(ds)^T.q over this warp's columns
#pragma unroll
      for (int j = 0; j < DWS; ++j) {
        const int dn = half * DWS + j;
        if (dn >= ksteps) continue;
        const int d = dn * 16 + a_col(lane);
        uint32_t bo[4], bq[4];
        ldsm_x4_t(bo, d < D ? smem_u32(dot + a_row(lane) * rs + d * 2) : zero);
        ldsm_x4_t(bq, d < D ? smem_u32(qt + a_row(lane) * rs + d * 2) : zero);
        mma_16816(dva[2 * j], pa, bo[0], bo[1]);
        mma_16816(dva[2 * j + 1], pa, bo[2], bo[3]);
        mma_16816(dka[2 * j], sa, bq[0], bq[1]);
        mma_16816(dka[2 * j + 1], sa, bq[2], bq[3]);
      }
    }
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
    for (int n = 0; n < 2 * DWS; ++n) {
      const int col = half * Cfg::DW + 8 * n + 2 * tq;
      if (col >= D) continue;
      const float2 k2 = make_float2(dka[n][2 * r] * a.scale,
                                    dka[n][2 * r + 1] * a.scale);
      const float2 v2 = make_float2(dva[n][2 * r], dva[n][2 * r + 1]);
      if (direct) {
        *reinterpret_cast<__nv_bfloat162*>(dk + base + col) =
            __float22bfloat162_rn(k2);
        *reinterpret_cast<__nv_bfloat162*>(dv + base + col) =
            __float22bfloat162_rn(v2);
      } else {
        float* pk = part + 2 * chunk * nk + base + col;
        *reinterpret_cast<float2*>(pk) = k2;
        *reinterpret_cast<float2*>(pk + nk) = v2;
      }
    }
  }
}

template <int DP, int KEYS>
struct DqMmaCfg {
  // q and dO held as A fragments in registers up to D = 128; at D = 256
  // dQ takes 128 registers a thread, so both are read by ldmatrix.
  static constexpr bool QREG = DP <= 128;
  __host__ __device__ static constexpr size_t smem(int warps, int rs) {
    return (size_t)warps * 2 * kSlice * rs + (size_t)kStages * 2 * KEYS * rs;
  }
};

// The forward's layout over the q block's list (units of 16 rows of one
// query head, all warps of a CTA on one list and one KV head, K and V
// sub-tiles in a ring): S = q.K^T and dP = dO.V^T, then dQ += round(ds).K
// with K read by ldmatrix.trans.
template <int DP, int KEYS>
__global__ void __launch_bounds__(kMaxWarps * 32)
sparse_bwd_dq_mma_kernel(AttnArgs a, const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ di,
                         const int32_t* __restrict__ kv_list,
                         const int32_t* __restrict__ kv_count, int stride,
                         int block_q, int block_k,
                         __nv_bfloat16* __restrict__ dq) {
  using Cfg = DqMmaCfg<DP, KEYS>;
  constexpr int STAGES = kStages, KS = DP / 16, NT = KEYS / 8;
  extern __shared__ __align__(128) char smem[];
  __shared__ __align__(16) uint4 zero_row;

  const int W = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int G = a.H / a.H_kv, D = a.D, rs = tc_row_bytes(D);
  const int ksteps = (D + 15) / 16;
  const int units = (block_q + kSlice - 1) / kSlice * G;
  const int per = (units + W - 1) / W;
  const int n_q_blocks = (a.Nq + block_q - 1) / block_q;
  const int iq = n_q_blocks - 1 - blockIdx.x / per;  // heavy first
  const int u0 = blockIdx.x % per * W, u = u0 + warp;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int r_end = min(iq * block_q + block_q, a.Nq);  // this q block's rows
  const int h = hk * G + u % G;
  const int r0 = iq * block_q + u / G * kSlice;
  const bool live = u < units && r0 < r_end;
  const int r_last = min(iq * block_q + (min(units, u0 + W) - 1) / G * kSlice +
                             kSlice - 1, r_end - 1);
  KeyWalk ld = key_walk(a, kv_list + (size_t)iq * stride, kv_count[iq],
                        block_k, r_last, KEYS, 1);

  const size_t kv_off = ((size_t)b * a.H_kv + hk) * a.Nk * D;
  const auto* kg = static_cast<const __nv_bfloat16*>(a.k) + kv_off;
  const auto* vg = static_cast<const __nv_bfloat16*>(a.v) + kv_off;
  char* q_s = smem + warp * 2 * kSlice * rs;  // this warp's q, then dO
  char* do_s = q_s + kSlice * rs;
  char* ring = smem + W * 2 * kSlice * rs;
  const int stage_bytes = 2 * KEYS * rs;
  if (threadIdx.x == 0) zero_row = make_uint4(0u, 0u, 0u, 0u);
  const uint32_t zero = smem_u32(&zero_row);
  const RowCopy rc = row_copy<__nv_bfloat16>(D, threadIdx.x, blockDim.x);
  const RowCopy rc_warp = row_copy<__nv_bfloat16>(D, lane, 32);
  const size_t bh = (size_t)b * a.H + h;

  auto issue = [&](int st) {
    char* kt = ring + st * stage_bytes;
    const int n_ok = ld.end() - ld.c0;
    load_rows(rc, kt, kg + (size_t)ld.c0 * D, KEYS, n_ok, rs);
    load_rows(rc, kt + KEYS * rs, vg + (size_t)ld.c0 * D, KEYS, n_ok, rs);
  };

  float acc[2 * KS][4];
#pragma unroll
  for (int i = 0; i < 2 * KS; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  }
  float lse_r[2] = {0.f, 0.f}, di_r[2] = {0.f, 0.f};
  uint32_t qf[Cfg::QREG ? KS : 1][4], of[Cfg::QREG ? KS : 1][4];

  if (!ld.done()) {
    if (live) {
      const size_t q0 = (bh * a.Nq + r0) * D;
      load_rows(rc_warp, q_s, static_cast<const __nv_bfloat16*>(a.q) + q0,
                kSlice, r_end - r0, rs);
      load_rows(rc_warp, do_s, dout + q0, kSlice, r_end - r0, rs);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + g + 8 * r;
        if (row < r_end) {
          lse_r[r] = lse[bh * a.Nq + row];
          di_r[r] = di[bh * a.Nq + row];
        }
      }
    }
    KeyWalk cw = ld;  // the products' cursor
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (!ld.done()) {
        issue(s);
        ld.next();
      }
      cp_async_commit();
    }
    for (int it = 0; !cw.done(); ++it, cw.next()) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // tile `it` landed; every warp is past tile it - 1
      if (!ld.done()) {
        issue((it + STAGES - 1) % STAGES);
        ld.next();
      }
      cp_async_commit();
      if (!live) continue;
      const char* kt = ring + it % STAGES * stage_bytes;
      const char* vt = kt + KEYS * rs;
      if constexpr (Cfg::QREG) {
        if (it == 0) {
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            const int d = ks * 16 + a_col(lane);
            if (ks < ksteps) {
              const int off = a_row(lane) * rs + d * 2;
              ldsm_x4(qf[ks], d < D ? smem_u32(q_s + off) : zero);
              ldsm_x4(of[ks], d < D ? smem_u32(do_s + off) : zero);
            }
          }
        }
      }

      // S = q.K^T and dP = dO.V^T (16 rows x KEYS keys)
      float sc[NT][4], dp[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[n][c] = dp[n][c] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (ks >= ksteps) continue;
        uint32_t aq[4], ao[4];
        if constexpr (Cfg::QREG) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            aq[i] = qf[ks][i];
            ao[i] = of[ks][i];
          }
        } else {
          const int d = ks * 16 + a_col(lane);
          const int off = a_row(lane) * rs + d * 2;
          ldsm_x4(aq, d < D ? smem_u32(q_s + off) : zero);
          ldsm_x4(ao, d < D ? smem_u32(do_s + off) : zero);
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bk[4], bv[4];
          const int d = ks * 16 + b_col(lane);
          const int off = (np * 16 + b_row(lane)) * rs + d * 2;
          ldsm_x4(bk, d < D ? smem_u32(kt + off) : zero);
          ldsm_x4(bv, d < D ? smem_u32(vt + off) : zero);
          mma_16816(sc[2 * np], aq, bk[0], bk[1]);
          mma_16816(sc[2 * np + 1], aq, bk[2], bk[3]);
          mma_16816(dp[2 * np], ao, bv[0], bv[1]);
          mma_16816(dp[2 * np + 1], ao, bv[2], bv[3]);
        }
      }

      // ds rounded to bf16 in the A layout (k = the sub-tile's keys)
      const int c0 = cw.c0, c_end = cw.end();
      uint32_t sa[NT / 2][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float ds[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = r0 + g + 8 * (c >> 1);
          const int col = c0 + 8 * n + 2 * tq + (c & 1);
          const float p = row < r_end && kept(a, row, col, c_end)
                              ? expf(sc[n][c] * a.scale - lse_r[c >> 1])
                              : 0.f;
          ds[c] = p * (dp[n][c] - di_r[c >> 1]);
        }
        sa[n / 2][2 * (n & 1)] = pack_bf16(ds[0], ds[1]);
        sa[n / 2][2 * (n & 1) + 1] = pack_bf16(ds[2], ds[3]);
      }
      // dQ += round(ds).K: K's rows are this product's K, ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
        for (int dn = 0; dn < KS; ++dn) {
          if (dn >= ksteps) continue;
          uint32_t bf[4];
          const int d = dn * 16 + a_col(lane);
          ldsm_x4_t(bf, d < D ? smem_u32(kt + (kk * 16 + a_row(lane)) * rs +
                                         d * 2)
                              : zero);
          mma_16816(acc[2 * dn], sa[kk], bf[0], bf[1]);
          mma_16816(acc[2 * dn + 1], sa[kk], bf[2], bf[3]);
        }
      }
    }
  }
  if (!live) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= r_end) continue;
    const size_t base = (bh * a.Nq + row) * D;
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n) {
      const int col = 8 * n + 2 * tq;
      if (col < D) {
        *reinterpret_cast<__nv_bfloat162*>(dq + base + col) =
            __floats2bfloat162_rn(acc[n][2 * r] * a.scale,
                                  acc[n][2 * r + 1] * a.scale);
      }
    }
  }
}

template <int KEYS, int DP>
cudaError_t launch_sparse_bwd_dq_mma(const AttnArgs& a, const Lists& s,
                                     const void* dout, const float* lse,
                                     const float* di, void* dq,
                                     cudaStream_t st) {
  const int units = (s.block_q + kSlice - 1) / kSlice * (a.H / a.H_kv);
  const int warps = cta_warps(units);
  const size_t smem = DqMmaCfg<DP, KEYS>::smem(warps, tc_row_bytes(a.D));
  auto kernel = sparse_bwd_dq_mma_kernel<DP, KEYS>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long ctas = (long long)((a.Nq + s.block_q - 1) / s.block_q) *
                         ((units + warps - 1) / warps);
  if (ctas > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)ctas, a.H_kv, a.B), 32 * warps, smem, st>>>(
      a, static_cast<const __nv_bfloat16*>(dout), lse, di, s.kv_list,
      s.kv_count, s.kv_stride, s.block_q, s.block_k,
      static_cast<__nv_bfloat16*>(dq));
  return cudaGetLastError();
}

// dK/dV (each KV block's walk in chunks of chunk_len entries over up to
// `chunks` CTAs, then the sum of the partials where chunks > 1), then dQ
// (sub-tiles of 16 keys for blocks of 16 keys or fewer, else 32), on `st`.
template <int DP>
cudaError_t sparse_bwd_mma(const AttnArgs& a, const Lists& s,
                           const void* dout, const float* lse,
                           const float* di, void* dq, void* dk, void* dv,
                           float* part, int chunk_len, int chunks,
                           cudaStream_t st) {
  using Cfg = DkvMmaCfg<DP>;
  const int slices = (s.block_k + kSlice - 1) / kSlice;
  const int warps = cta_warps(slices * Cfg::SPLIT);
  const size_t smem = Cfg::smem(warps, tc_row_bytes(a.D));
  auto kernel = sparse_bwd_dkv_mma_kernel<DP>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int per_block = (slices + warps / Cfg::SPLIT - 1) / (warps / Cfg::SPLIT);
  const long long ctas =
      (long long)((a.Nk + s.block_k - 1) / s.block_k) * per_block;
  if (ctas > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)ctas, a.H_kv * chunks, a.B), 32 * warps, smem,
           st>>>(a, static_cast<const __nv_bfloat16*>(dout), lse, di,
                 s.q_list, s.q_count, s.q_stride, s.block_q, s.block_k,
                 static_cast<__nv_bfloat16*>(dk),
                 static_cast<__nv_bfloat16*>(dv), part, chunk_len, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (chunks > 1) {
    const size_t n4 = (size_t)a.B * a.H_kv * a.Nk * a.D / 4;
    sparse_bwd_sum_mma_kernel<__nv_bfloat16>
        <<<sm90::stream_blocks(n4), 256, 0, st>>>(
        a, reinterpret_cast<const float4*>(part), s.q_count, s.block_k,
        chunk_len, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return s.block_k <= 16
             ? launch_sparse_bwd_dq_mma<16, DP>(a, s, dout, lse, di, dq, st)
             : launch_sparse_bwd_dq_mma<32, DP>(a, s, dout, lse, di, dq, st);
}

// ---------------------------------------------------------------------------
// The fp32 mma route (3xTF32 on m16n8k8, D <= 256, blocks not both
// multiples of 64)
// ---------------------------------------------------------------------------

// The bf16 mma dK/dV kernel's layout, walk and chunks (DkvMmaCfg's shared
// memory at f32_row_bytes(D) a row; at D = 256 two warps a key slice, each
// holding half of the head dim) with every product in 3xTF32: S^T = K.q^T
// and dP^T = V.dO^T with K, V (A) and q, dO (N-major B) from ldmatrix,
// then dV += P^T.dO and dK += dS^T.q with P^T and dS^T from the
// accumulators and dO, q by 32-bit loads (f32_b). Where one chunk takes
// the block's walk it stores dK and dV itself; else each chunk writes its
// fp32 partials into `part`, summed in chunk order by
// sparse_bwd_sum_mma_kernel<float>.
template <int DP>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
sparse_bwd_dkv_f32_mma_kernel(AttnArgs a, const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ di,
                              const int32_t* __restrict__ q_list,
                              const int32_t* __restrict__ q_count, int stride,
                              int block_q, int block_k,
                              float* __restrict__ dk, float* __restrict__ dv,
                              float* __restrict__ part, int chunk_len,
                              int chunks) {
  using Cfg = DkvMmaCfg<DP>;
  constexpr int SPLIT = Cfg::SPLIT, STAGES = kStages, KS = DP / 8;
  constexpr int DWN = Cfg::DW / 8;  // 8-column steps of a warp's dK / dV
  extern __shared__ __align__(128) char smem[];

  const int W = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int G = a.H / a.H_kv, D = a.D, rs = f32_row_bytes(D);
  const int ksteps = D / 8;
  const int kslices = W / SPLIT;  // key slices a CTA
  const int per = ((block_k + kSlice - 1) / kSlice + kslices - 1) / kslices;
  const int ik = blockIdx.x / per;
  const int c_first = ik * block_k + blockIdx.x % per * kslices * kSlice;
  const int c_end = min(ik * block_k + block_k, a.Nk);  // this KV block's keys
  if (c_first >= c_end) return;  // the whole CTA past Nk
  const int half = warp % SPLIT;
  const int kb = c_first + warp / SPLIT * kSlice;  // this warp's first key
  const bool live = kb < c_end;
  const int b = blockIdx.z, hk = blockIdx.y / chunks;
  const int chunk = blockIdx.y % chunks, n = q_count[ik];
  const int e_lo = chunk * chunk_len, n_entries = G * n;
  if (chunk > 0 && e_lo >= n_entries) return;  // chunk 0 stores the zeros
  const bool direct = n_entries <= chunk_len;  // one CTA takes the block
  RowWalk ld{q_list + (size_t)ik * stride, n, block_q, a.Nq,
             a.causal ? c_first - a.offset : INT_MIN,
             min(n_entries, e_lo + chunk_len), 0, 0};
  ld.seek(e_lo);

  const float* qg = static_cast<const float*>(a.q);
  const size_t kv_off = ((size_t)b * a.H_kv + hk) * a.Nk;
  char* k_s = smem;
  char* v_s = k_s + kslices * kSlice * rs;
  char* ring = v_s + kslices * kSlice * rs;
  const int stage_bytes = Cfg::stage(rs);
  float* xbuf = reinterpret_cast<float*>(ring + STAGES * stage_bytes);
  const RowCopy rc = row_copy<float>(D, threadIdx.x, blockDim.x);
  // lane maps: ldmatrix A and N-major B rows and column bytes, f32_b's
  const int oa = a_row(lane) * rs + 2 * a_col(lane);
  const int ob = b_row(lane) * rs + 2 * b_col(lane);
  const int ov = 2 * tq * rs + 4 * g;

  auto issue = [&](int st) {
    char* qt = ring + st * stage_bytes;
    float* ls = reinterpret_cast<float*>(qt + 2 * kSlice * rs);
    const size_t row0 =
        ((size_t)b * a.H + hk * G + ld.g()) * a.Nq + ld.r0;
    const int n_ok = ld.r_hi() - ld.r0;
    load_rows(rc, qt, qg + row0 * D, kSlice, n_ok, rs);
    load_rows(rc, qt + kSlice * rs, dout + row0 * D, kSlice, n_ok, rs);
    if (threadIdx.x < 2 * kSlice) {  // the LSE, then di
      const int j = threadIdx.x % kSlice;
      const bool ok = j < n_ok;
      cp_async4(smem_u32(ls + threadIdx.x),
                (threadIdx.x < kSlice ? lse : di) + row0 + (ok ? j : 0), ok);
    }
  };

  float dka[DWN][4], dva[DWN][4];
#pragma unroll
  for (int i = 0; i < DWN; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[i][c] = dva[i][c] = 0.f;
  }

  if (!ld.done()) {
    const size_t k0 = (kv_off + c_first) * D;
    load_rows(rc, k_s, static_cast<const float*>(a.k) + k0, kslices * kSlice,
              c_end - c_first, rs);
    load_rows(rc, v_s, static_cast<const float*>(a.v) + k0, kslices * kSlice,
              c_end - c_first, rs);
    RowWalk cw = ld;  // the products' cursor
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (!ld.done()) {
        issue(s);
        ld.next();
      }
      cp_async_commit();
    }
    const char* kt = k_s + (warp / SPLIT) * kSlice * rs;
    const char* vt = v_s + (warp / SPLIT) * kSlice * rs;
    for (int it = 0; !cw.done(); ++it, cw.next()) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // step `it` landed; every warp is past step it - 1
      if (!ld.done()) {
        issue((it + STAGES - 1) % STAGES);
        ld.next();
      }
      cp_async_commit();
      const char* qt = ring + it % STAGES * stage_bytes;
      const char* dot = qt + kSlice * rs;
      const float* ls = reinterpret_cast<const float*>(dot + kSlice * rs);
      const float* dis = ls + kSlice;

      // S^T and dP^T (16 keys x 16 rows) over this warp's columns
      float st[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) st[n][c] = dp[n][c] = 0.f;
      }
      if (live) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          if (ks >= ksteps || ks / (KS / SPLIT) != half) continue;
          uint32_t x[4], kb_[4], ks_[4], vb[4], vs[4];
          ldsm_x4(x, smem_u32(kt + oa + ks * 32));
          split_frag(x, kb_, ks_);
          ldsm_x4(x, smem_u32(vt + oa + ks * 32));
          split_frag(x, vb, vs);
          uint32_t bb[4], bs[4];
          ldsm_x4(x, smem_u32(qt + ob + ks * 32));
          split_frag(x, bb, bs);
          mma3_1688(st[0], kb_, ks_, bb[0], bb[1], bs[0], bs[1]);
          mma3_1688(st[1], kb_, ks_, bb[2], bb[3], bs[2], bs[3]);
          ldsm_x4(x, smem_u32(dot + ob + ks * 32));
          split_frag(x, bb, bs);
          mma3_1688(dp[0], vb, vs, bb[0], bb[1], bs[0], bs[1]);
          mma3_1688(dp[1], vb, vs, bb[2], bb[3], bs[2], bs[3]);
        }
      }
      if constexpr (SPLIT == 2) {  // add the other half's partials
        float4* xb = reinterpret_cast<float4*>(xbuf) + (it & 1) * W * 32 * 4;
        float4* mine = xb + (warp * 32 + lane) * 4;
        mine[0] = make_float4(st[0][0], st[0][1], st[0][2], st[0][3]);
        mine[1] = make_float4(st[1][0], st[1][1], st[1][2], st[1][3]);
        mine[2] = make_float4(dp[0][0], dp[0][1], dp[0][2], dp[0][3]);
        mine[3] = make_float4(dp[1][0], dp[1][1], dp[1][2], dp[1][3]);
        __syncthreads();
        const float4* other = xb + ((warp ^ 1) * 32 + lane) * 4;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float4 x = other[n], y = other[2 + n];
          st[n][0] += x.x;
          st[n][1] += x.y;
          st[n][2] += x.z;
          st[n][3] += x.w;
          dp[n][0] += y.x;
          dp[n][1] += y.y;
          dp[n][2] += y.z;
          dp[n][3] += y.w;
        }
      }
      if (!live) continue;

      // p^T and ds^T as split A fragments (k step n = the step's rows
      // 8 n .. 8 n + 7)
      const int r0 = cw.r0, r_hi = cw.r_hi();
      uint32_t pb[2][4], ps[2][4], sb[2][4], ss[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float p[4], ds[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = kb + g + 8 * (c >> 1);
          const int rr = 8 * n + 2 * tq + (c & 1), row = r0 + rr;
          p[c] = row < r_hi && kept(a, row, key, c_end)
                     ? expf(st[n][c] * a.scale - ls[rr])
                     : 0.f;
          ds[c] = p[c] * (dp[n][c] - dis[rr]);
        }
        acc_split(p, pb[n], ps[n]);
        acc_split(ds, sb[n], ss[n]);
      }
      // dV += p^T.dO and dK += ds^T.q over this warp's columns
#pragma unroll
      for (int j = 0; j < DWN; ++j) {
        const int dn = half * DWN + j;
        if (dn >= ksteps) continue;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int at = n * 8 * rs + ov + dn * 32;
          uint32_t bb[2], bs[2];
          f32_b(dot, at, rs, bb, bs);
          mma3_1688(dva[j], pb[n], ps[n], bb[0], bb[1], bs[0], bs[1]);
          f32_b(qt, at, rs, bb, bs);
          mma3_1688(dka[j], sb[n], ss[n], bb[0], bb[1], bs[0], bs[1]);
        }
      }
    }
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
    for (int j = 0; j < DWN; ++j) {
      const int col = half * Cfg::DW + 8 * j + 2 * tq;
      if (col >= D) continue;
      const float2 k2 = make_float2(dka[j][2 * r] * a.scale,
                                    dka[j][2 * r + 1] * a.scale);
      const float2 v2 = make_float2(dva[j][2 * r], dva[j][2 * r + 1]);
      float* pk = direct ? dk + base + col : part + 2 * chunk * nk + base + col;
      float* pv = direct ? dv + base + col : pk + nk;
      *reinterpret_cast<float2*>(pk) = k2;
      *reinterpret_cast<float2*>(pv) = v2;
    }
  }
}

// The bf16 mma dQ kernel's layout and walk (DqMmaCfg's shared memory at
// f32_row_bytes(D) a row) in 3xTF32: S = q.K^T and dP = dO.V^T with q, dO
// (A) and K, V (N-major B) from ldmatrix, then dQ += dS.K with dS from the
// accumulators and K by 32-bit loads (f32_b). q and dO are read and split
// at each k8 step: two parts of both beside dQ would not fit in registers.
template <int DP, int KEYS>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
sparse_bwd_dq_f32_mma_kernel(AttnArgs a, const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ di,
                             const int32_t* __restrict__ kv_list,
                             const int32_t* __restrict__ kv_count, int stride,
                             int block_q, int block_k,
                             float* __restrict__ dq) {
  constexpr int STAGES = kStages, KS = DP / 8, NT = KEYS / 8;
  extern __shared__ __align__(128) char smem[];

  const int W = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int G = a.H / a.H_kv, D = a.D, rs = f32_row_bytes(D);
  const int ksteps = D / 8;
  const int units = (block_q + kSlice - 1) / kSlice * G;
  const int per = (units + W - 1) / W;
  const int n_q_blocks = (a.Nq + block_q - 1) / block_q;
  const int iq = n_q_blocks - 1 - blockIdx.x / per;  // heavy first
  const int u0 = blockIdx.x % per * W, u = u0 + warp;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int r_end = min(iq * block_q + block_q, a.Nq);  // this q block's rows
  const int h = hk * G + u % G;
  const int r0 = iq * block_q + u / G * kSlice;
  const bool live = u < units && r0 < r_end;
  const int r_last = min(iq * block_q + (min(units, u0 + W) - 1) / G * kSlice +
                             kSlice - 1, r_end - 1);
  KeyWalk ld = key_walk(a, kv_list + (size_t)iq * stride, kv_count[iq],
                        block_k, r_last, KEYS, 1);

  const size_t kv_off = ((size_t)b * a.H_kv + hk) * a.Nk * D;
  const float* kg = static_cast<const float*>(a.k) + kv_off;
  const float* vg = static_cast<const float*>(a.v) + kv_off;
  char* q_s = smem + warp * 2 * kSlice * rs;  // this warp's q, then dO
  char* do_s = q_s + kSlice * rs;
  char* ring = smem + W * 2 * kSlice * rs;
  const int stage_bytes = 2 * KEYS * rs;
  const RowCopy rc = row_copy<float>(D, threadIdx.x, blockDim.x);
  const RowCopy rc_warp = row_copy<float>(D, lane, 32);
  const size_t bh = (size_t)b * a.H + h;
  const int oa = a_row(lane) * rs + 2 * a_col(lane);
  const int ob = b_row(lane) * rs + 2 * b_col(lane);
  const int ov = 2 * tq * rs + 4 * g;

  auto issue = [&](int st) {
    char* kt = ring + st * stage_bytes;
    const int n_ok = ld.end() - ld.c0;
    load_rows(rc, kt, kg + (size_t)ld.c0 * D, KEYS, n_ok, rs);
    load_rows(rc, kt + KEYS * rs, vg + (size_t)ld.c0 * D, KEYS, n_ok, rs);
  };

  float acc[KS][4];
#pragma unroll
  for (int i = 0; i < KS; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  }
  float lse_r[2] = {0.f, 0.f}, di_r[2] = {0.f, 0.f};

  if (!ld.done()) {
    if (live) {
      const size_t q0 = (bh * a.Nq + r0) * D;
      load_rows(rc_warp, q_s, static_cast<const float*>(a.q) + q0, kSlice,
                r_end - r0, rs);
      load_rows(rc_warp, do_s, dout + q0, kSlice, r_end - r0, rs);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + g + 8 * r;
        if (row < r_end) {
          lse_r[r] = lse[bh * a.Nq + row];
          di_r[r] = di[bh * a.Nq + row];
        }
      }
    }
    KeyWalk cw = ld;  // the products' cursor
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (!ld.done()) {
        issue(s);
        ld.next();
      }
      cp_async_commit();
    }
    for (int it = 0; !cw.done(); ++it, cw.next()) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // tile `it` landed; every warp is past tile it - 1
      if (!ld.done()) {
        issue((it + STAGES - 1) % STAGES);
        ld.next();
      }
      cp_async_commit();
      if (!live) continue;
      const char* kt = ring + it % STAGES * stage_bytes;
      const char* vt = kt + KEYS * rs;

      // S = q.K^T and dP = dO.V^T (16 rows x KEYS keys)
      float sc[NT][4], dp[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[n][c] = dp[n][c] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (ks >= ksteps) continue;
        uint32_t x[4], qb[4], qsm[4], ob_[4], os_[4];
        ldsm_x4(x, smem_u32(q_s + oa + ks * 32));
        split_frag(x, qb, qsm);
        ldsm_x4(x, smem_u32(do_s + oa + ks * 32));
        split_frag(x, ob_, os_);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bb[4], bs[4];
          const int off = np * 16 * rs + ob + ks * 32;
          ldsm_x4(x, smem_u32(kt + off));
          split_frag(x, bb, bs);
          mma3_1688(sc[2 * np], qb, qsm, bb[0], bb[1], bs[0], bs[1]);
          mma3_1688(sc[2 * np + 1], qb, qsm, bb[2], bb[3], bs[2], bs[3]);
          ldsm_x4(x, smem_u32(vt + off));
          split_frag(x, bb, bs);
          mma3_1688(dp[2 * np], ob_, os_, bb[0], bb[1], bs[0], bs[1]);
          mma3_1688(dp[2 * np + 1], ob_, os_, bb[2], bb[3], bs[2], bs[3]);
        }
      }

      // dQ += ds.K: k step kk is keys 8 kk .. 8 kk + 7, K by f32_b
      const int c0 = cw.c0, c_end = cw.end();
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        float ds[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = r0 + g + 8 * (c >> 1);
          const int col = c0 + 8 * kk + 2 * tq + (c & 1);
          const float p = row < r_end && kept(a, row, col, c_end)
                              ? expf(sc[kk][c] * a.scale - lse_r[c >> 1])
                              : 0.f;
          ds[c] = p * (dp[kk][c] - di_r[c >> 1]);
        }
        uint32_t sb[4], ss[4];
        acc_split(ds, sb, ss);
#pragma unroll
        for (int dn = 0; dn < KS; ++dn) {
          if (dn >= ksteps) continue;
          uint32_t bb[2], bs[2];
          f32_b(kt, kk * 8 * rs + ov + dn * 32, rs, bb, bs);
          mma3_1688(acc[dn], sb, ss, bb[0], bb[1], bs[0], bs[1]);
        }
      }
    }
  }
  if (!live) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= r_end) continue;
    const size_t base = (bh * a.Nq + row) * D;
#pragma unroll
    for (int dn = 0; dn < KS; ++dn) {
      const int col = 8 * dn + 2 * tq;
      if (col < D) {
        *reinterpret_cast<float2*>(dq + base + col) =
            make_float2(acc[dn][2 * r] * a.scale, acc[dn][2 * r + 1] * a.scale);
      }
    }
  }
}

template <int KEYS, int DP>
cudaError_t launch_sparse_bwd_dq_f32_mma(const AttnArgs& a, const Lists& s,
                                         const float* dout, const float* lse,
                                         const float* di, float* dq,
                                         cudaStream_t st) {
  const int units = (s.block_q + kSlice - 1) / kSlice * (a.H / a.H_kv);
  const int warps = cta_warps(units);
  const size_t smem = DqMmaCfg<DP, KEYS>::smem(warps, f32_row_bytes(a.D));
  auto kernel = sparse_bwd_dq_f32_mma_kernel<DP, KEYS>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long ctas = (long long)((a.Nq + s.block_q - 1) / s.block_q) *
                         ((units + warps - 1) / warps);
  if (ctas > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)ctas, a.H_kv, a.B), 32 * warps, smem, st>>>(
      a, dout, lse, di, s.kv_list, s.kv_count, s.kv_stride, s.block_q,
      s.block_k, dq);
  return cudaGetLastError();
}

// dK/dV (chunks as the bf16 route), the sum of the partials where chunks >
// 1, then dQ, on `st`. dQ's sub-tiles: 16 keys for blocks of 16 keys or
// fewer and at D = 256 (q and dO, 33 KB a warp, beside two stages of
// 32-key K and V tiles would pass 227 KB), else 32.
template <int DP>
cudaError_t sparse_bwd_f32_mma(const AttnArgs& a, const Lists& s,
                               const float* dout, const float* lse,
                               const float* di, float* dq, float* dk,
                               float* dv, float* part, int chunk_len,
                               int chunks, cudaStream_t st) {
  using Cfg = DkvMmaCfg<DP>;
  const int slices = (s.block_k + kSlice - 1) / kSlice;
  const int warps = cta_warps(slices * Cfg::SPLIT);
  const size_t smem = Cfg::smem(warps, f32_row_bytes(a.D));
  auto kernel = sparse_bwd_dkv_f32_mma_kernel<DP>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int per_block = (slices + warps / Cfg::SPLIT - 1) / (warps / Cfg::SPLIT);
  const long long ctas =
      (long long)((a.Nk + s.block_k - 1) / s.block_k) * per_block;
  if (ctas > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)ctas, a.H_kv * chunks, a.B), 32 * warps, smem,
           st>>>(a, dout, lse, di, s.q_list, s.q_count, s.q_stride,
                 s.block_q, s.block_k, dk, dv, part, chunk_len, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (chunks > 1) {
    const size_t n4 = (size_t)a.B * a.H_kv * a.Nk * a.D / 4;
    sparse_bwd_sum_mma_kernel<float><<<sm90::stream_blocks(n4), 256, 0, st>>>(
        a, reinterpret_cast<const float4*>(part), s.q_count, s.block_k,
        chunk_len, dk, dv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if constexpr (DP == 256) {
    return launch_sparse_bwd_dq_f32_mma<16, DP>(a, s, dout, lse, di, dq, st);
  } else {
    return s.block_k <= 16 ? launch_sparse_bwd_dq_f32_mma<16, DP>(
                                 a, s, dout, lse, di, dq, st)
                           : launch_sparse_bwd_dq_f32_mma<32, DP>(
                                 a, s, dout, lse, di, dq, st);
  }
}

}  // namespace mma
}  // namespace fat

extern "C" {

// dtype: 0 = bfloat16, 1 = float32 (q, k, v, do and the gradients share
// it); lse and di are fp32 (B, H, Nq). kv_list (ceil(Nq / block_q),
// kv_stride) with kv_count, and q_list (ceil(Nk / block_k), q_stride) with
// q_count, are int32 on the device. Launches the dK/dV kernel, then the dQ
// kernel, on `stream`; returns the first CUDA error.
int fat_sparse_bwd(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* di, void* dq,
                   void* dk, void* dv, const void* kv_list,
                   const void* kv_count, const void* q_list,
                   const void* q_count, int B, int H, int H_kv, int Nq, int Nk,
                   int D, float scale, int causal, int block_q, int block_k,
                   int kv_stride, int q_stride, int dtype, void* stream) {
  if (D < 8 || D > 256 || D % 8 != 0 || H_kv < 1 || H % H_kv != 0 || B < 1 ||
      Nq < 1 || Nk < 1 || H > 65535 || B > 65535 || block_q < 1 ||
      block_k < 1 || kv_stride < (Nk + block_k - 1) / block_k ||
      q_stride < (Nq + block_q - 1) / block_q) {
    return (int)cudaErrorInvalidValue;
  }
  AttnArgs a{q, k, v, nullptr, nullptr, nullptr, B, H, H_kv, Nq, Nk, D, scale,
             causal, Nk - Nq, 0, 0, 0.f, 0.f, 0, 0u, 0u, 1.f};
  const Lists s{static_cast<const int32_t*>(kv_list),
                static_cast<const int32_t*>(kv_count),
                static_cast<const int32_t*>(q_list),
                static_cast<const int32_t*>(q_count),
                kv_stride, q_stride, block_q, block_k};
  auto st = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const float*>(lse);
  const auto* d = static_cast<const float*>(di);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<__nv_bfloat16>(a, s, dout, l, d, dq, dk, dv, st);
  } else if (dtype == 1) {
    err = dispatch<float>(a, s, dout, l, d, dq, dk, dv, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

// The mma route: bf16 only, D <= 256, any block_q and block_k (the caller
// sends blocks that are not both multiples of 64); q, k, v and dout 16-byte
// aligned (cp.async). Same arguments as fat_sparse_bwd (dtype must be 0),
// then `scratch`, `chunk_len` and `chunks`: a KV block's walk of (H / H_kv)
// * q_count entries (query head, q block) is cut into chunks of chunk_len
// entries, one dK/dV CTA each, chunks * chunk_len covering (H / H_kv) *
// ceil(Nq / block_q); where chunks > 1 scratch holds their fp32 partials,
// 2 chunks |k| values, 16-byte aligned (null otherwise).
int fat_sparse_bwd_mma(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* di,
                       void* dq, void* dk, void* dv, const void* kv_list,
                       const void* kv_count, const void* q_list,
                       const void* q_count, int B, int H, int H_kv, int Nq,
                       int Nk, int D, float scale, int causal, int block_q,
                       int block_k, int kv_stride, int q_stride, int dtype,
                       void* stream, void* scratch, int chunk_len,
                       int chunks) {
  using namespace fat;
  if (dtype != 0 || D < 8 || D > 256 || D % 8 != 0 || H_kv < 1 ||
      H % H_kv != 0 || B < 1 || Nq < 1 || Nk < 1 || B > 65535 ||
      block_q < 1 || block_k < 1 || chunk_len < 1 || chunks < 1 ||
      (long long)chunks * chunk_len <
          (long long)(H / H_kv) * ((Nq + block_q - 1) / block_q) ||
      (long long)H_kv * chunks > 65535 ||
      (chunks > 1 && (scratch == nullptr ||
                      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)) ||
      kv_stride < (Nk + block_k - 1) / block_k ||
      q_stride < (Nq + block_q - 1) / block_q ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) %
              16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  AttnArgs a{q, k, v, nullptr, nullptr, nullptr, B, H, H_kv, Nq, Nk, D, scale,
             causal, Nk - Nq, 0, 0, 0.f, 0.f, 0, 0u, 0u, 1.f};
  const Lists s{static_cast<const int32_t*>(kv_list),
                static_cast<const int32_t*>(kv_count),
                static_cast<const int32_t*>(q_list),
                static_cast<const int32_t*>(q_count),
                kv_stride, q_stride, block_q, block_k};
  auto st = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const float*>(lse);
  const auto* d = static_cast<const float*>(di);
  auto* run = D <= 64    ? mma::sparse_bwd_mma<64>
              : D <= 128 ? mma::sparse_bwd_mma<128>
                         : mma::sparse_bwd_mma<256>;
  return (int)run(a, s, dout, l, d, dq, dk, dv,
                  static_cast<float*>(scratch), chunk_len, chunks, st);
}

// The fp32 mma route (3xTF32): fp32 only, otherwise as fat_sparse_bwd_mma
// (dtype must be 1); where chunks > 1 scratch holds the chunks' fp32
// partials, 2 chunks |k| values.
int fat_sparse_bwd_mma_f32(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse, const void* di,
                           void* dq, void* dk, void* dv, const void* kv_list,
                           const void* kv_count, const void* q_list,
                           const void* q_count, int B, int H, int H_kv,
                           int Nq, int Nk, int D, float scale, int causal,
                           int block_q, int block_k, int kv_stride,
                           int q_stride, int dtype, void* stream,
                           void* scratch, int chunk_len, int chunks) {
  using namespace fat;
  if (dtype != 1 || D < 8 || D > 256 || D % 8 != 0 || H_kv < 1 ||
      H % H_kv != 0 || B < 1 || Nq < 1 || Nk < 1 || B > 65535 ||
      block_q < 1 || block_k < 1 || chunk_len < 1 || chunks < 1 ||
      (long long)chunks * chunk_len <
          (long long)(H / H_kv) * ((Nq + block_q - 1) / block_q) ||
      (long long)H_kv * chunks > 65535 ||
      (chunks > 1 && (scratch == nullptr ||
                      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)) ||
      kv_stride < (Nk + block_k - 1) / block_k ||
      q_stride < (Nq + block_q - 1) / block_q ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) %
              16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  AttnArgs a{q, k, v, nullptr, nullptr, nullptr, B, H, H_kv, Nq, Nk, D, scale,
             causal, Nk - Nq, 0, 0, 0.f, 0.f, 0, 0u, 0u, 1.f};
  const Lists s{static_cast<const int32_t*>(kv_list),
                static_cast<const int32_t*>(kv_count),
                static_cast<const int32_t*>(q_list),
                static_cast<const int32_t*>(q_count),
                kv_stride, q_stride, block_q, block_k};
  auto st = static_cast<cudaStream_t>(stream);
  auto* run = D <= 64    ? mma::sparse_bwd_f32_mma<64>
              : D <= 128 ? mma::sparse_bwd_f32_mma<128>
                         : mma::sparse_bwd_f32_mma<256>;
  return (int)run(a, s, static_cast<const float*>(dout),
                  static_cast<const float*>(lse), static_cast<const float*>(di),
                  static_cast<float*>(dq), static_cast<float*>(dk),
                  static_cast<float*>(dv), static_cast<float*>(scratch),
                  chunk_len, chunks, st);
}

// The tensor-core route: bf16 only, D <= 256, block_q and block_k multiples
// of 64; q, k, v and dout 16-byte aligned (TMA). Same arguments as
// fat_sparse_bwd (dtype must be 0).
int fat_sparse_bwd_sm90(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* di,
                        void* dq, void* dk, void* dv, const void* kv_list,
                        const void* kv_count, const void* q_list,
                        const void* q_count, int B, int H, int H_kv, int Nq,
                        int Nk, int D, float scale, int causal, int block_q,
                        int block_k, int kv_stride, int q_stride, int dtype,
                        void* stream) {
  using namespace fat;
  if (dtype != 0 || D < 8 || D > 256 || D % 8 != 0 || H_kv < 1 ||
      H % H_kv != 0 || B < 1 || Nq < 1 || Nk < 1 || H > 65535 || B > 65535 ||
      block_q < 64 || block_k < 64 || block_q % 64 != 0 ||
      block_k % 64 != 0 || kv_stride < (Nk + block_k - 1) / block_k ||
      q_stride < (Nq + block_q - 1) / block_q || (Nq + 63) / 64 > 65535 ||
      (Nk + 63) / 64 > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  AttnArgs a{q, k, v, nullptr, nullptr, nullptr, B, H, H_kv, Nq, Nk, D, scale,
             causal, Nk - Nq, 0, 0, 0.f, 0.f, 0, 0u, 0u, 1.f};
  const Lists s{static_cast<const int32_t*>(kv_list),
                static_cast<const int32_t*>(kv_count),
                static_cast<const int32_t*>(q_list),
                static_cast<const int32_t*>(q_count),
                kv_stride, q_stride, block_q, block_k};
  auto st = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const float*>(lse);
  const auto* d = static_cast<const float*>(di);
  auto* run = D <= 64    ? sm90::sparse_bwd_sm90<64>
              : D <= 128 ? sm90::sparse_bwd_sm90<128>
                         : sm90::sparse_bwd_sm90<256>;
  const cudaError_t err = run(a, s, dout, l, d, dq, dk, dv, st);
  return (int)err;
}

// The fp32 tensor-core route (3xTF32): fp32 only, D <= 256, block_q and
// block_k multiples of 64; q, k, v and dout 16-byte aligned (TMA). Same
// arguments as fat_sparse_bwd (dtype must be 1), then `scratch` and
// `kv_splits`, both unused (null, 1) for D <= 128. For D > 128 a KV head's
// query heads are walked by kv_splits dK/dV CTAs (it divides H / H_kv), and
// scratch holds 2 (|q| + |dout| + |k| + |v|) fp32 values, plus 2 kv_splits
// |k| where kv_splits > 1, 16-byte aligned.
int fat_sparse_bwd_sm90_f32(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* di,
                            void* dq, void* dk, void* dv, const void* kv_list,
                            const void* kv_count, const void* q_list,
                            const void* q_count, int B, int H, int H_kv,
                            int Nq, int Nk, int D, float scale, int causal,
                            int block_q, int block_k, int kv_stride,
                            int q_stride, int dtype, void* stream,
                            void* scratch, int kv_splits) {
  using namespace fat;
  if (dtype != 1 || D < 8 || D > 256 || D % 8 != 0 || H_kv < 1 ||
      H % H_kv != 0 || B < 1 || Nq < 1 || Nk < 1 || H > 65535 || B > 65535 ||
      block_q < 64 || block_k < 64 || block_q % 64 != 0 ||
      block_k % 64 != 0 || kv_stride < (Nk + block_k - 1) / block_k ||
      q_stride < (Nq + block_q - 1) / block_q || (Nq + 63) / 64 > 65535 ||
      (Nk + 63) / 64 > 65535 ||
      (D > 128 && (scratch == nullptr ||
                   reinterpret_cast<uintptr_t>(scratch) % 16 != 0 ||
                   kv_splits < 1 || (H / H_kv) % kv_splits != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  AttnArgs a{q, k, v, nullptr, nullptr, nullptr, B, H, H_kv, Nq, Nk, D, scale,
             causal, Nk - Nq, 0, 0, 0.f, 0.f, 0, 0u, 0u, 1.f};
  const Lists s{static_cast<const int32_t*>(kv_list),
                static_cast<const int32_t*>(kv_count),
                static_cast<const int32_t*>(q_list),
                static_cast<const int32_t*>(q_count),
                kv_stride, q_stride, block_q, block_k};
  auto st = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const float*>(lse);
  const auto* d = static_cast<const float*>(di);
  // Any D in (128, 256] runs the wide pair's 256 instance (TMA reads zeros
  // past D).
  const cudaError_t err =
      D > 128 ? sm90::sparse_bwd_f32_wide_sm90<256>(
                    a, s, dout, l, d, dq, dk, dv, static_cast<float*>(scratch),
                    kv_splits, st)
      : D > 64 ? sm90::sparse_bwd_f32_sm90<128>(a, s, dout, l, d, dq, dk, dv, st)
               : sm90::sparse_bwd_f32_sm90<64>(a, s, dout, l, d, dq, dk, dv, st);
  return (int)err;
}

}  // extern "C"
