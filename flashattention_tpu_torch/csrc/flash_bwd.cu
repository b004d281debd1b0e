// Flash-attention backward on Hopper (sm_90a): dQ, dK and dV from the LSE.
//
// Replaces: flashattention_tpu/ops/pallas_attn.py, _bwd_fused_kernel (its
// resident-dQ launch and its dQ-partials launch) and the split pair
// _bwd_dkv_kernel + _bwd_dq_kernel. The four are TPU schedules of one
// contract, different only because the TPU grid is sequential and has no
// atomics. One call here serves the contract with two kernels and no
// atomics, so its result does not depend on block order:
//
//   dkv: one block per (key tile, KV head, batch). It loops over the query
//        heads of its GQA group and the query tiles that can see its keys,
//        and sums dK and dV in fp32 registers; the group needs no separate
//        reduction.
//   dq:  one block per (query tile, head, batch). It loops over the key
//        tiles its rows can see (the forward's walk) and sums dQ in fp32.
//
// Per element, as the TPU kernels: q_s = q * scale rounded to the input
// type; s = q_s · k (fp32) through ALiBi, soft-cap and mask; p = exp(s - lse)
// (zero where masked); dp = do · v; with dropout p_v = keep ? p / (1 - rate)
// : 0 and dp likewise; dV += round(p_v) · do; ds = p * (dp - di) times the
// soft-cap chain 1 - tanh²; dK += round(ds) · q_s; dQ += round(ds) · k, times
// the scale at the end. di = rowsum(o · do) - dlse comes from the caller.
//
// What bounds it on this card: 10·B·H·Nq·Nk·D flops (half of that causal)
// against q, k, v, o, do and the three gradients read or written once, so
// the tensor-core rate (989 TFLOP/s bf16; 165 fp32 on 3xTF32). Both
// kernels recompute the scores (7 products per element instead of 5), the
// price of having no atomics.
//
// Three entry points; the caller (ops/flash_attn.py) takes the first two:
//
//   fat_flash_bwd_sm90 (bf16, D <= 256): every product on the tensor cores
//     (wgmma, bf16 in, fp32 accumulate), tiles by TMA into mbarrier-guarded
//     rings, warpgroup 0 loading and warpgroups 1-2 computing.
//     dkv, D <= 128: 128 keys per CTA, 64 per consumer, K and V resident in
//       shared memory; q, dO (and the LSE and di rows) stream in tiles of 64
//       rows (products over fewer of them at a time at D = 128, for
//       registers). The consumers first round the landed q tile to q_s in
//       place, behind a named barrier, then compute transposed products so
//       that Pᵀ and dSᵀ come out in the register A layout: Sᵀ = K·q_sᵀ and
//       dPᵀ = V·dOᵀ from shared memory, dV += round(p_v)ᵀ·dO and dK +=
//       round(ds)ᵀ·q_s from registers (dO, q_s MN-major). dK and dV stay in
//       registers.
//     dkv, 128 < D <= 256 (the D split): one consumer's dK and dV over 64
//       keys at D = 256 would take 256 registers a thread, above the 240 it
//       has. So both consumers share one CTA's 64 keys, and each holds
//       columns [128 cw, 128 cw + 128) of dK and dV (128 registers). Each
//       computes Sᵀ and dPᵀ for all 64 keys over its 32 of the tile's 64
//       query rows, writes round(p_v)ᵀ and round(ds)ᵀ into shared memory
//       (swizzled as TMA would, so wgmma reads them K-major), and after a
//       named barrier both run dV[:, half] += P_vᵀ·dO[:, half] and
//       dK[:, half] += dSᵀ·q_s[:, half] over all 64 rows from shared memory.
//       K and V (32 KB each) stay resident; q and dO tiles (32 KB each) in
//       two stages; Pᵀ and dSᵀ 8 KB each: ~210 KB.
//     dq: 128 query rows per CTA (64 per consumer), q and dO resident, K and
//       V tiles streamed over the forward's walk (64 keys; 32 at D = 256,
//       where dQ takes 128 registers): S = q_s·Kᵀ, dP = dO·Vᵀ, dQ +=
//       round(ds)·K (K MN-major), scaled at the store.
//   fat_flash_bwd_sm90_f32 (fp32, D <= 256): the same two kernels with
//     every product in 3xTF32 (tf32_sm90.cuh; the tiles and stages are set
//     out where the kernels are defined, below). Above D = 128 the wide
//     pair keeps its resident operands as landed and splits them in
//     registers, and computes dVᵀ, dKᵀ and dQᵀ instead of dV, dK and dQ.
//   fat_flash_bwd (fp32 FMAs on the CUDA cores): the first version, below.
//     The wrapper no longer takes it (every call goes to a tensor-core
//     entry; above D = 256 to flash_wide.cu's); it stays as the comparison
//     that chip_smoke.py times on the tensor-core cases' inputs.

#include "flash_common.cuh"
#include "flash_sm90.cuh"
#include "tf32_wide_bwd.cuh"

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
flash_bwd_dkv_kernel(AttnArgs a, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     T* __restrict__ dk, T* __restrict__ dv) {
  using Cfg = DkvCfg<DMAX>;
  constexpr int KPW = Cfg::KPW, KEYS = Cfg::KEYS, C = Cfg::C, LD = Cfg::LD;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [KEYS][LD]
  float* v_s = k_s + KEYS * LD;                  // [KEYS][LD]
  float* q_s = v_s + KEYS * LD;                  // [kQRows][LD], q * scale
  float* do_s = q_s + kQRows * LD;               // [kQRows][LD]
  float* pv_s = do_s + kQRows * LD;              // [kWarps][KPW][kQRows]
  float* ds_s = pv_s + kWarps * KPW * kQRows;    // [kWarps][KPW][kQRows]

  const int b = blockIdx.z, hk = blockIdx.y, c0 = blockIdx.x * KEYS;
  const int G = a.H / a.H_kv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int D = a.D;
  const size_t kv_off = ((size_t)b * a.H_kv + hk) * a.Nk * D;
  const T* k = static_cast<const T*>(a.k) + kv_off;
  const T* v = static_cast<const T*>(a.v) + kv_off;
  const float scale_c = Num<T>::round(a.scale);

  for (int i = threadIdx.x; i < KEYS * DMAX; i += kThreads) {
    const int j = i / DMAX, d = i % DMAX, col = c0 + j;
    const bool ok = col < a.Nk && d < D;
    k_s[j * LD + d] = ok ? Num<T>::load(k[(size_t)col * D + d]) : 0.f;
    v_s[j * LD + d] = ok ? Num<T>::load(v[(size_t)col * D + d]) : 0.f;
  }

  // Query rows that can see some key of [c0, c0 + KEYS).
  const int c_last = min(c0 + KEYS, a.Nk) - 1;
  int r_begin = 0, r_end = a.Nq;
  if (a.causal) {
    r_begin = max(0, c0 - a.offset);
    if (a.window > 0 && !(a.sinks > 0 && c0 < a.sinks)) {
      r_end = min(a.Nq, c_last - a.offset + a.window);
    }
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

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const size_t q_off = ((size_t)b * a.H + h) * a.Nq;
    const T* q = static_cast<const T*>(a.q) + q_off * D;
    const T* dO = dout + q_off * D;
    const uint32_t bh = (uint32_t)(b * a.H + h);
    for (int r0 = (r_begin / kQRows) * kQRows; r0 < r_end; r0 += kQRows) {
      __syncthreads();  // the previous tile is consumed (and K/V are staged)
      for (int i = threadIdx.x; i < kQRows * DMAX; i += kThreads) {
        const int rr = i / DMAX, d = i % DMAX, r = r0 + rr;
        const bool ok = r < a.Nq && d < D;
        q_s[rr * LD + d] =
            ok ? Num<T>::round(Num<T>::load(q[(size_t)r * D + d]) * scale_c)
               : 0.f;
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
      const bool row_ok = row < a.Nq;
      const float lse_r = row_ok ? lse[q_off + row] : 0.f;
      const float di_r = row_ok ? di[q_off + row] : 0.f;
#pragma unroll
      for (int j = 0; j < KPW; ++j) {
        const int col = c0 + warp * KPW + j;
        float pv = 0.f, ds = 0.f;
        if (row_ok && visible(a, b, row, col)) {
          float dcap;
          const float sc = post_score(a, h, row, col, s[j], &dcap);
          const float p = expf(sc - lse_r);
          float dpj = dp[j];
          pv = p;
          if (a.dropout) {
            const bool kept = keep(a, bh, row, col);
            pv = kept ? p * a.drop_inv : 0.f;
            dpj = kept ? dpj * a.drop_inv : 0.f;
          }
          ds = p * (dpj - di_r);
          ds = ds * dcap;
        }
        my_pv[j * kQRows + lane] = Num<T>::round(pv);
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

#pragma unroll
  for (int j = 0; j < KPW; ++j) {
    const int col = c0 + warp * KPW + j;
    if (col >= a.Nk) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = c * 32 + lane;
      if (d < D) {
        dk[kv_off + (size_t)col * D + d] = Num<T>::store(dk_acc[j][c]);
        dv[kv_off + (size_t)col * D + d] = Num<T>::store(dv_acc[j][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

constexpr int kTile = 32;  // keys per staged tile: one per lane

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
flash_bwd_dq_kernel(AttnArgs a, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    T* __restrict__ dq) {
  using Cfg = DqCfg<DMAX>;
  constexpr int RPW = Cfg::RPW, ROWS = Cfg::ROWS, C = Cfg::C, LD = Cfg::LD;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [ROWS][LD], q * scale
  float* do_s = q_s + ROWS * LD;                 // [ROWS][LD]
  float* k_s = do_s + ROWS * LD;                 // [kTile][LD]
  float* v_s = k_s + kTile * LD;                 // [kTile][LD]
  float* ds_s = v_s + kTile * LD;                // [kWarps][RPW][kTile]

  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * ROWS;
  const int hk = h / (a.H / a.H_kv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int D = a.D;
  const size_t q_off = ((size_t)b * a.H + h) * a.Nq;
  const T* q = static_cast<const T*>(a.q) + q_off * D;
  const T* dO = dout + q_off * D;
  const T* k = static_cast<const T*>(a.k) + ((size_t)b * a.H_kv + hk) * a.Nk * D;
  const T* v = static_cast<const T*>(a.v) + ((size_t)b * a.H_kv + hk) * a.Nk * D;
  const uint32_t bh = (uint32_t)(b * a.H + h);
  const float scale_c = Num<T>::round(a.scale);

  for (int i = threadIdx.x; i < ROWS * DMAX; i += kThreads) {
    const int rr = i / DMAX, d = i % DMAX, r = r0 + rr;
    const bool ok = r < a.Nq && d < D;
    q_s[rr * LD + d] =
        ok ? Num<T>::round(Num<T>::load(q[(size_t)r * D + d]) * scale_c) : 0.f;
    do_s[rr * LD + d] = ok ? Num<T>::load(dO[(size_t)r * D + d]) : 0.f;
  }

  float lse_r[RPW], di_r[RPW], acc[RPW][C];
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int row = r0 + warp * RPW + j;
    lse_r[j] = row < a.Nq ? lse[q_off + row] : 0.f;
    di_r[j] = row < a.Nq ? di[q_off + row] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[j][c] = 0.f;
  }
  float* my_ds = ds_s + warp * RPW * kTile;
  const TileWalk walk = key_tiles(a, r0, min(r0 + ROWS, a.Nq) - 1, kTile);

  for (int w = 0; w < walk.n_walk; ++w) {
    const int c0 = walk.tile(w) * kTile;
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * DMAX; i += kThreads) {
      const int j = i / DMAX, d = i % DMAX, col = c0 + j;
      const bool ok = col < a.Nk && d < D;
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
      if (row < a.Nq && visible(a, b, row, col)) {
        float dcap;
        const float sc = post_score(a, h, row, col, s[j], &dcap);
        const float p = expf(sc - lse_r[j]);
        float dpj = dp[j];
        if (a.dropout) dpj = keep(a, bh, row, col) ? dpj * a.drop_inv : 0.f;
        ds = p * (dpj - di_r[j]);
        ds = ds * dcap;
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

#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int row = r0 + warp * RPW + j;
    if (row >= a.Nq) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = c * 32 + lane;
      if (d < D) dq[(q_off + row) * D + d] = Num<T>::store(acc[j][c] * a.scale);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const AttnArgs& a, const void* dout, const float* lse,
                   const float* di, void* dq, void* dk, void* dv,
                   cudaStream_t st) {
  const T* d_o = static_cast<const T*>(dout);
  auto dkv_kernel = flash_bwd_dkv_kernel<T, DMAX>;
  cudaError_t err = set_smem(dkv_kernel, DkvCfg<DMAX>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((a.Nk + DkvCfg<DMAX>::KEYS - 1) / DkvCfg<DMAX>::KEYS,
                     a.H_kv, a.B);
  dkv_kernel<<<grid_kv, kThreads, DkvCfg<DMAX>::SMEM, st>>>(
      a, d_o, lse, di, static_cast<T*>(dk), static_cast<T*>(dv));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dq_kernel = flash_bwd_dq_kernel<T, DMAX>;
  err = set_smem(dq_kernel, DqCfg<DMAX>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((a.Nq + DqCfg<DMAX>::ROWS - 1) / DqCfg<DMAX>::ROWS, a.H,
                    a.B);
  dq_kernel<<<grid_q, kThreads, DqCfg<DMAX>::SMEM, st>>>(a, d_o, lse, di,
                                                         static_cast<T*>(dq));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const AttnArgs& a, const void* dout, const float* lse,
                     const float* di, void* dq, void* dk, void* dv,
                     cudaStream_t st) {
  if (a.D <= 64) return launch<T, 64>(a, dout, lse, di, dq, dk, dv, st);
  if (a.D <= 128) return launch<T, 128>(a, dout, lse, di, dq, dk, dv, st);
  return launch<T, 256>(a, dout, lse, di, dq, dk, dv, st);
}

}  // namespace

// ---------------------------------------------------------------------------
// The tensor-core route (bf16, D <= 256)
// ---------------------------------------------------------------------------

namespace fat {
namespace sm90 {

constexpr int kDkvRows = 64;   // query rows per streamed q / dO tile
constexpr int kDqRows = 128;   // query rows per dQ CTA, 64 per consumer

template <int DP>
struct DkvSm90Cfg {
  // Above D = 128 the two consumers split the head dim of one 64-key tile
  // (file header); below, each owns 64 of the CTA's 128 keys.
  static constexpr bool SPLIT = DP > 128;
  static constexpr int KEYS = SPLIT ? 64 : 128;  // keys per CTA
  static constexpr int STAGES = 2;
  static constexpr int KV_BYTES = KEYS * DP * 2;     // K or V, resident
  static constexpr int T_BYTES = kDkvRows * DP * 2;  // one q or dO tile
  static constexpr int X_BYTES = SPLIT ? KEYS * kDkvRows * 2 : 0;  // Pᵀ, dSᵀ
  static constexpr int BARS = 1 + 2 * STAGES;
  static constexpr size_t SMEM = 1024 + 2 * KV_BYTES + 2 * STAGES * T_BYTES +
                                 2 * X_BYTES + 2 * STAGES * kDkvRows * 4 +
                                 8 * BARS;
};

template <int DP>
struct DqSm90Cfg {
  // Keys per K/V tile: 128 spills at D = 64; at D = 256 the dQ accumulator
  // (128 registers) leaves room for S and dP of 32 keys (16 + 16).
  static constexpr int KEYS = DP <= 128 ? 64 : 32;
  static constexpr int STAGES = 2;
  static constexpr int Q_BYTES = kDqRows * DP * 2;  // q or dO, resident
  static constexpr int KV_BYTES = KEYS * DP * 2;    // one K or V tile
  static constexpr int BARS = 1 + 2 * STAGES;
  static constexpr size_t SMEM =
      1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARS;
};

template <int DP>
__global__ void __launch_bounds__(kThreadsWS, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo, AttnArgs a,
                          const float* __restrict__ lse,
                          const float* __restrict__ di,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv) {
  using Cfg = DkvSm90Cfg<DP>;
  constexpr int STAGES = Cfg::STAGES, KEYS = Cfg::KEYS;
  // Query rows per Sᵀ/dPᵀ product: at D = 128 the dK and dV accumulators
  // (128 registers) leave room for 32 rows of both, not 64; in the D split
  // each consumer takes 32 of the 64.
  constexpr int QS = DP <= 64 ? kDkvRows : kDkvRows / 2;
  extern __shared__ char smem_raw[];
  char* k_s = align_1024(smem_raw);          // [DP/64][KEYS][64], resident
  char* v_s = k_s + Cfg::KV_BYTES;           // resident
  char* q_s = v_s + Cfg::KV_BYTES;           // [STAGES] tiles of 64 rows
  char* do_s = q_s + STAGES * Cfg::T_BYTES;  // [STAGES] tiles of 64 rows
  char* pt_s = do_s + STAGES * Cfg::T_BYTES;  // D split: round(p_v)ᵀ
  char* dst_s = pt_s + Cfg::X_BYTES;          // D split: round(ds)ᵀ
  float* lse_s = reinterpret_cast<float*>(dst_s + Cfg::X_BYTES);
  float* di_s = lse_s + STAGES * kDkvRows;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(di_s + STAGES * kDkvRows);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int b = blockIdx.z, hk = blockIdx.y, c0 = blockIdx.x * KEYS;
  const int G = a.H / a.H_kv;
  // Query rows that can see some key of [c0, c0 + KEYS).
  const int c_last = min(c0 + KEYS, a.Nk) - 1;
  int r_begin = 0, r_end = a.Nq;
  if (a.causal) {
    r_begin = max(0, c0 - a.offset);
    if (a.window > 0 && !(a.sinks > 0 && c0 < a.sinks)) {
      r_end = min(a.Nq, c_last - a.offset + a.window);
    }
  }
  const int t0 = (r_begin / kDkvRows) * kDkvRows;
  const int n_rt = r_end > t0 ? (r_end - t0 + kDkvRows - 1) / kDkvRows : 0;
  const int n_it = G * n_rt;  // (query head, row tile) steps

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer: warp 0
    reg_dealloc<kProducerRegs>();
    const int lane = threadIdx.x;
    if (lane < 32 && n_it > 0) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * Cfg::KV_BYTES);
        tma_tile<KEYS, DP>(k_s, &tk, kv_full, c0, b * a.H_kv + hk);
        tma_tile<KEYS, DP>(v_s, &tv, kv_full, c0, b * a.H_kv + hk);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % STAGES;
        const int plane = b * a.H + hk * G + it / n_rt;
        const int r0 = t0 + (it % n_rt) * kDkvRows;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        for (int j = lane; j < kDkvRows; j += 32) {
          const int row = r0 + j;
          const size_t at = (size_t)plane * a.Nq + row;
          lse_s[s * kDkvRows + j] = row < a.Nq ? lse[at] : 0.f;
          di_s[s * kDkvRows + j] = row < a.Nq ? di[at] : 0.f;
        }
        __threadfence_block();
        __syncwarp();  // the rows above land before lane 0 arrives
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * Cfg::T_BYTES);
          tma_tile<kDkvRows, DP>(q_s + s * Cfg::T_BYTES, &tq, &full[s], r0,
                                 plane);
          tma_tile<kDkvRows, DP>(do_s + s * Cfg::T_BYTES, &tdo, &full[s], r0,
                                 plane);
        }
      }
    }
  } else {  // consumers: 64 keys each, or in the D split 64 keys shared
    reg_alloc<kConsumerRegs>();
    constexpr bool SPLIT = Cfg::SPLIT;
    constexpr int DA = SPLIT ? DP / 2 : DP;  // columns of dK, dV held here
    const int cw = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const int krow = SPLIT ? 0 : 64 * cw;  // first key in the K/V tiles
    const int key0 = c0 + krow, col0 = SPLIT ? DA * cw : 0;
    // Query rows of Sᵀ and dPᵀ this consumer takes: all 64, QS at a time,
    // or in the D split its QS.
    const int q_lo = SPLIT ? QS * cw : 0, q_hi = SPLIT ? q_lo + QS : kDkvRows;
    const float scale_c = Num<__nv_bfloat16>::round(a.scale);
    const bool post = a.slopes != nullptr || a.softcap > 0.f;
    float dk_acc[DA / 2], dv_acc[DA / 2];
#pragma unroll
    for (int i = 0; i < DA / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    if (n_it > 0) mbar_wait(kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % STAGES, ph = (it / STAGES) & 1;
      const int h = hk * G + it / n_rt;
      const int r0 = t0 + (it % n_rt) * kDkvRows;
      const uint32_t bh = (uint32_t)(b * a.H + h);
      char* qt = q_s + s * Cfg::T_BYTES;
      const char* dot = do_s + s * Cfg::T_BYTES;
      const float* ls = lse_s + s * kDkvRows;
      const float* di_t = di_s + s * kDkvRows;

      mbar_wait(&full[s], ph);
      // q_s = bf16(q * bf16(scale)), in place, before any wgmma reads it.
      // In the D split, passing this barrier also means both consumers'
      // products of the step before, which read Pᵀ and dSᵀ, have completed.
      scale_bf16(qt, Cfg::T_BYTES, scale_c, threadIdx.x - 128, 256);
      fence_proxy_async();
      named_sync(1, 256);

      // Sᵀ and dPᵀ over QS query rows at a time (64 keys x QS each), one
      // slice after the other (unrolled, the slices' values overlap and
      // spill at D = 128).
#pragma unroll 1
      for (int q0 = q_lo; q0 < q_hi; q0 += QS) {
        float st[QS / 2], dpt[QS / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          wgmma_ss<QS>(st, desc_k<KEYS>(k_s, krow, kk),
                       desc_k<kDkvRows>(qt, q0, kk), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          wgmma_ss<QS>(dpt, desc_k<KEYS>(v_s, krow, kk),
                       desc_k<kDkvRows>(dot, q0, kk), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);

        const int cls =
            tile_class(a, r0 + q0, r0 + q0 + QS - 1, key0, key0 + 63);
        uint32_t seg[2] = {0u, 0u};  // rows: keys; columns: query rows
        if (cls == kSegments) {
          segment_bits<QS>(a.kv_ids + (size_t)b * a.Nk, key0, a.Nk,
                           a.q_ids + (size_t)b * a.Nq, r0 + q0, a.Nq, t, seg);
        }
        dispatch_tile(cls, post, [&](auto c, auto pp) {
#pragma unroll
          for (int i = 0; i < QS / 2; ++i) {
            const int key = key0 + acc_row(t, i), j = q0 + acc_col(t, i);
            const int row = r0 + j;
            float pv = 0.f, ds = 0.f;
            if (tile_visible<decltype(c)::value>(a, b, row, key, seg, i)) {
              float dcap;
              const float x = tile_score<decltype(pp)::value>(
                  a, h, row, key, st[i], &dcap);
              const float p = expf(x - ls[j]);
              float dp = dpt[i];
              pv = p;
              if (a.dropout) {
                const bool kept = keep(a, bh, row, key);
                pv = kept ? p * a.drop_inv : 0.f;
                dp = kept ? dp * a.drop_inv : 0.f;
              }
              ds = p * (dp - di_t[j]);
              ds = ds * dcap;
            }
            st[i] = pv;
            dpt[i] = ds;
          }
        });

        if constexpr (!SPLIT) {
          // dV += round(p_v)ᵀ·dO, dK += round(ds)ᵀ·q_s over this slice's
          // rows, Pᵀ and dSᵀ as register A operands.
          uint32_t pa[QS / 16][4], da[QS / 16][4];
          acc_to_a<QS>(st, pa);
          acc_to_a<QS>(dpt, da);

          wgmma_fence();
          fence_regs(dv_acc);
          fence_regs(dk_acc);
#pragma unroll
          for (int kk = 0; kk < QS / 16; ++kk) {
            const int k16 = q0 / 16 + kk;
            wgmma_rs<DP>(dv_acc, pa[kk], desc_mn<kDkvRows>(dot, k16));
            wgmma_rs<DP>(dk_acc, da[kk], desc_mn<kDkvRows>(qt, k16));
          }
        } else {
          // dV[:, half] += P_vᵀ·dO[:, half], dK[:, half] += dSᵀ·q_s[:, half]
          // over the tile's 64 rows, through shared memory; the next
          // step's q-scaling barrier orders the buffers' reuse.
          dsplit_products<KEYS, kDkvRows, QS>(st, dpt, pt_s, dst_s, dot, qt,
                                              q0, cw, t, dv_acc, dk_acc);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
      }
      mbar_arrive(&empty[s]);
    }

    // Keys no row sees write zeros.
    const size_t kv_off = ((size_t)b * a.H_kv + hk) * a.Nk;
#pragma unroll
    for (int i = 0; i < DA / 2; i += 2) {
      const int key = key0 + acc_row(t, i), col = col0 + acc_col(t, i);
      if (key < a.Nk && col < a.D) {
        const size_t at = (kv_off + key) * a.D + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) =
            __floats2bfloat162_rn(dk_acc[i], dk_acc[i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreadsWS, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo, AttnArgs a,
                         const float* __restrict__ lse,
                         const float* __restrict__ di,
                         __nv_bfloat16* __restrict__ dq) {
  using Cfg = DqSm90Cfg<DP>;
  constexpr int STAGES = Cfg::STAGES, KEYS = Cfg::KEYS;
  extern __shared__ char smem_raw[];
  char* q_s = align_1024(smem_raw);          // [DP/64][128][64], resident
  char* do_s = q_s + Cfg::Q_BYTES;           // resident
  char* k_s = do_s + Cfg::Q_BYTES;           // [STAGES] tiles
  char* v_s = k_s + STAGES * Cfg::KV_BYTES;  // [STAGES] tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + STAGES * Cfg::KV_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * kDqRows;
  const int hk = h / (a.H / a.H_kv);
  const TileWalk walk = key_tiles(a, r0, min(r0 + kDqRows, a.Nq) - 1, KEYS);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0 && walk.n_walk > 0) {
      const int kplane = b * a.H_kv + hk;
      mbar_expect_tx(q_full, 2 * Cfg::Q_BYTES);
      tma_tile<kDqRows, DP>(q_s, &tq, q_full, r0, b * a.H + h);
      tma_tile<kDqRows, DP>(do_s, &tdo, q_full, r0, b * a.H + h);
      for (int w = 0; w < walk.n_walk; ++w) {
        const int s = w % STAGES;
        mbar_wait(&empty[s], ((w / STAGES) & 1) ^ 1);
        const int c0 = walk.tile(w) * KEYS;
        mbar_expect_tx(&full[s], 2 * Cfg::KV_BYTES);
        tma_tile<KEYS, DP>(k_s + s * Cfg::KV_BYTES, &tk, &full[s], c0, kplane);
        tma_tile<KEYS, DP>(v_s + s * Cfg::KV_BYTES, &tv, &full[s], c0, kplane);
      }
    }
  } else {  // consumers: 64 query rows each
    reg_alloc<kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const int row0 = r0 + 64 * cw;
    const uint32_t bh = (uint32_t)(b * a.H + h);
    const bool post = a.slopes != nullptr || a.softcap > 0.f;
    float lse_r[2], di_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + acc_row(t, 2 * r);
      lse_r[r] = row < a.Nq ? lse[(size_t)bh * a.Nq + row] : 0.f;
      di_r[r] = row < a.Nq ? di[(size_t)bh * a.Nq + row] : 0.f;
    }
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

    if (walk.n_walk > 0) {
      mbar_wait(q_full, 0);
      // q_s = bf16(q * bf16(scale)) over this warpgroup's 64 rows.
      const float scale_c = Num<__nv_bfloat16>::round(a.scale);
#pragma unroll
      for (int hf = 0; hf < DP / 64; ++hf) {
        scale_bf16(q_s + (hf * kDqRows + 64 * cw) * 128, 64 * 128, scale_c, t,
                   128);
      }
      fence_proxy_async();
      if (cw == 0) {  // a constant id each: the CTA keeps 3 of 16 barriers
        named_sync(1, 128);
      } else {
        named_sync(2, 128);
      }
    }
    for (int w = 0; w < walk.n_walk; ++w) {
      const int s = w % STAGES, ph = (w / STAGES) & 1;
      const int c0 = walk.tile(w) * KEYS;
      const char* kt = k_s + s * Cfg::KV_BYTES;
      const char* vt = v_s + s * Cfg::KV_BYTES;

      float sc[KEYS / 2], dp[KEYS / 2];  // S and dP: 64 rows x KEYS
      mbar_wait(&full[s], ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wgmma_ss<KEYS>(sc, desc_k<kDqRows>(q_s, 64 * cw, kk),
                       desc_k<KEYS>(kt, 0, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wgmma_ss<KEYS>(dp, desc_k<kDqRows>(do_s, 64 * cw, kk),
                       desc_k<KEYS>(vt, 0, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      const int cls = tile_class(a, row0, row0 + 63, c0, c0 + KEYS - 1);
      uint32_t seg[2] = {0u, 0u};
      if (cls == kSegments) {
        segment_bits<KEYS>(a.q_ids + (size_t)b * a.Nq, row0, a.Nq,
                           a.kv_ids + (size_t)b * a.Nk, c0, a.Nk, t, seg);
      }
      dispatch_tile(cls, post, [&](auto c, auto pp) {
#pragma unroll
        for (int i = 0; i < KEYS / 2; ++i) {
          const int r = (i >> 1) & 1;
          const int row = row0 + acc_row(t, i), col = c0 + acc_col(t, i);
          float ds = 0.f;
          if (tile_visible<decltype(c)::value>(a, b, row, col, seg, i)) {
            float dcap;
            const float x =
                tile_score<decltype(pp)::value>(a, h, row, col, sc[i], &dcap);
            const float p = expf(x - lse_r[r]);
            float d = dp[i];
            if (a.dropout) d = keep(a, bh, row, col) ? d * a.drop_inv : 0.f;
            ds = p * (d - di_r[r]);
            ds = ds * dcap;
          }
          sc[i] = ds;
        }
      });
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

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + acc_row(t, 2 * r);
      if (row >= a.Nq) continue;
      const size_t base = ((size_t)bh * a.Nq + row) * a.D;
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

template <int DP>
cudaError_t launch_bwd_sm90(const AttnArgs& a, const void* dout,
                            const float* lse, const float* di, void* dq,
                            void* dk, void* dv, cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = make_map(&tq, a.q, a.B * a.H, a.Nq, a.D);
  if (err == cudaSuccess) err = make_map(&tdo, dout, a.B * a.H, a.Nq, a.D);
  if (err == cudaSuccess) err = make_map(&tk, a.k, a.B * a.H_kv, a.Nk, a.D);
  if (err == cudaSuccess) err = make_map(&tv, a.v, a.B * a.H_kv, a.Nk, a.D);
  if (err != cudaSuccess) return err;
  using Bf = __nv_bfloat16;
  using Kv = DkvSm90Cfg<DP>;

  auto dkv_kernel = flash_bwd_dkv_sm90_kernel<DP>;
  err = set_smem(dkv_kernel, Kv::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((a.Nk + Kv::KEYS - 1) / Kv::KEYS, a.H_kv, a.B);
  dkv_kernel<<<grid_kv, kThreadsWS, Kv::SMEM, st>>>(
      tq, tk, tv, tdo, a, lse, di, static_cast<Bf*>(dk), static_cast<Bf*>(dv));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // The dQ kernel's K/V tiles of fewer than 64 keys need boxes of as many
  // rows (the launch above took its maps by value).
  constexpr int DQ_KEYS = DqSm90Cfg<DP>::KEYS;
  if constexpr (DQ_KEYS < kBox) {
    err = make_map(&tk, a.k, a.B * a.H_kv, a.Nk, a.D, DQ_KEYS);
    if (err == cudaSuccess) {
      err = make_map(&tv, a.v, a.B * a.H_kv, a.Nk, a.D, DQ_KEYS);
    }
    if (err != cudaSuccess) return err;
  }
  auto dq_kernel = flash_bwd_dq_sm90_kernel<DP>;
  err = set_smem(dq_kernel, DqSm90Cfg<DP>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((a.Nq + kDqRows - 1) / kDqRows, a.H, a.B);
  dq_kernel<<<grid_q, kThreadsWS, DqSm90Cfg<DP>::SMEM, st>>>(
      tq, tk, tv, tdo, a, lse, di, static_cast<Bf*>(dq));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The fp32 tensor-core route (3xTF32, D <= 128)
// ---------------------------------------------------------------------------
//
// The bf16 route's two kernels with every product in 3xTF32. Operands that
// stay resident (K and V in dkv; q_s and dO in dq) land by TMA and are split
// in place (big) and into a small part once; streamed tiles land in their
// stage and warps 1-3 of the producer warpgroup transpose (for the products
// that read them MN-major) and split them, then release the stage. Shared
// memory holds ~225 KB in each instantiation:
//   dkv: 64 keys per consumer (NC of them), K and V in two parts resident
//     (128 KB); q and dO tiles of 16 rows in two parts, and q_sᵀ and dOᵀ in
//     two parts, padded to 32 columns, per stage (48 KB at D = 64: NC = 2,
//     two stages; 96 KB at D = 128: NC = 1, one stage).
//   dq: 64 query rows per consumer, q_s and dO in two parts resident (128
//     KB); K and V tiles of 32 keys in two parts and Kᵀ in two parts per
//     stage (48 KB at D = 64: NC = 2, two stages; 96 KB at D = 128: NC = 1,
//     one stage).

template <int DP>
struct DkvF32Cfg {
  static constexpr int NC = DP <= 64 ? 2 : 1;
  static constexpr int KEYS = 64 * NC;          // keys per CTA
  static constexpr int R = 16;                  // query rows per step
  static constexpr int STAGES = DP <= 64 ? 2 : 1;
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int KV_BYTES = KEYS * DP * 4;  // K or V, one part
  static constexpr int T_BYTES = R * DP * 4;      // q or dO, one part
  static constexpr int TT_BYTES = transposed_bytes<R, DP>();  // q_sᵀ, dOᵀ
  // stage: q big, q small, dO big, dO small, q_sᵀ b, s, dOᵀ b, s
  static constexpr int STAGE_BYTES = 4 * T_BYTES + 4 * TT_BYTES;
  static constexpr int BARS = 2 + 3 * STAGES;
  static constexpr size_t SMEM = 1024 + 4 * KV_BYTES + STAGES * STAGE_BYTES +
                                 2 * STAGES * R * 4 + 8 * BARS;
};

template <int DP>
struct DqF32Cfg {
  static constexpr int NC = DP <= 64 ? 2 : 1;
  static constexpr int ROWS = 64 * NC;  // query rows per CTA
  static constexpr int KEYS = 32;       // keys per step
  static constexpr int STAGES = DP <= 64 ? 2 : 1;
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int Q_BYTES = ROWS * DP * 4;  // q_s or dO, one part
  static constexpr int T_BYTES = KEYS * DP * 4;  // K, V or Kᵀ, one part
  static_assert(transposed_bytes<KEYS, DP>() == T_BYTES, "Kᵀ tile size");
  // stage: K big, K small, V big, V small, Kᵀ big, Kᵀ small
  static constexpr int STAGE_BYTES = 6 * T_BYTES;
  static constexpr int BARS = 2 + 3 * STAGES;
  static constexpr size_t SMEM =
      1024 + 4 * Q_BYTES + STAGES * STAGE_BYTES + 8 * BARS;
};

template <int DP>
__global__ void __launch_bounds__(DkvF32Cfg<DP>::THREADS, 1)
flash_bwd_dkv_f32_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              AttnArgs a, const float* __restrict__ lse,
                              const float* __restrict__ di,
                              float* __restrict__ dk, float* __restrict__ dv) {
  using Cfg = DkvF32Cfg<DP>;
  constexpr int NC = Cfg::NC, KEYS = Cfg::KEYS, R = Cfg::R;
  constexpr int STAGES = Cfg::STAGES, KVB = Cfg::KV_BYTES;
  constexpr int TB = Cfg::T_BYTES, TT = Cfg::TT_BYTES;
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

  const int b = blockIdx.z, hk = blockIdx.y, c0 = blockIdx.x * KEYS;
  const int G = a.H / a.H_kv;
  // Query rows that can see some key of [c0, c0 + KEYS).
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
  const int n_it = G * n_rt;  // (query head, row tile) steps

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
    if (threadIdx.x == 0 && n_it > 0) {
      mbar_expect_tx(kv_landed, 2 * KVB);
      tma_tile32<KEYS, DP>(kb, &tk, kv_landed, c0, b * a.H_kv + hk);
      tma_tile32<KEYS, DP>(vb, &tv, kv_landed, c0, b * a.H_kv + hk);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % STAGES;
        char* st = stage0 + s * Cfg::STAGE_BYTES;
        const int plane = b * a.H + hk * G + it / n_rt;
        const int r0 = t0 + (it % n_rt) * R;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(&landed[s], 2 * TB);
        tma_tile32<R, DP>(st, &tq, &landed[s], r0, plane);
        tma_tile32<R, DP>(st + 2 * TB, &tdo, &landed[s], r0, plane);
      }
    } else if (threadIdx.x >= 32 && n_it > 0) {
      const int tid = threadIdx.x - 32;
      mbar_wait(kv_landed, 0);
      split_tile(kb, kb, ks, KVB, 1.f, tid, kPrepThreads);
      split_tile(vb, vb, vs, KVB, 1.f, tid, kPrepThreads);
      fence_proxy_async();
      mbar_arrive(kv_ready);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % STAGES;
        char* st = stage0 + s * Cfg::STAGE_BYTES;
        char* tt = st + 4 * TB;  // q_sᵀ b, s, dOᵀ b, s
        const int plane = b * a.H + hk * G + it / n_rt;
        const int r0 = t0 + (it % n_rt) * R;
        // The stage is free once its tiles have landed (thread 0 waited
        // for the consumers before loading them).
        mbar_wait(&landed[s], (it / STAGES) & 1);
        for (int j = tid; j < R; j += kPrepThreads) {
          const int row = r0 + j;
          const size_t at = (size_t)plane * a.Nq + row;
          lse_s[s * R + j] = row < a.Nq ? lse[at] : 0.f;
          di_s[s * R + j] = row < a.Nq ? di[at] : 0.f;
        }
        // q_s = q * scale (fp32) and dO, transposed from the landed tiles,
        // then (once every thread has read them) split in place.
        transpose_split<R, DP>(st, tt, tt + TT, a.scale, tid, kPrepThreads);
        transpose_split<R, DP>(st + 2 * TB, tt + 2 * TT, tt + 3 * TT, 1.f,
                               tid, kPrepThreads);
        named_sync(1, kPrepThreads);
        split_tile(st, st, st + TB, TB, a.scale, tid, kPrepThreads);
        split_tile(st + 2 * TB, st + 2 * TB, st + 3 * TB, TB, 1.f, tid,
                   kPrepThreads);
        fence_proxy_async();
        mbar_arrive(&ready[s]);
      }
    }
  } else {  // consumers: 64 keys each
    if constexpr (NC == 2) reg_alloc<kConsumerRegs32>();
    const int cw = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const int key0 = c0 + 64 * cw;
    const bool post = a.slopes != nullptr || a.softcap > 0.f;
    float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    if (n_it > 0) mbar_wait(kv_ready, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % STAGES;
      const int h = hk * G + it / n_rt;
      const int r0 = t0 + (it % n_rt) * R;
      const uint32_t bh = (uint32_t)(b * a.H + h);
      const char* st = stage0 + s * Cfg::STAGE_BYTES;
      const char* tt = st + 4 * TB;
      const float* ls = lse_s + s * R;
      const float* di_t = di_s + s * R;

      // Sᵀ = K·q_sᵀ and dPᵀ = V·dOᵀ (64 keys x R rows each).
      float sct[R / 2], dpt[R / 2];
      mbar_wait(&ready[s], (it / STAGES) & 1);
      wgmma_fence();
      mma3_ss<KEYS, R, DP / 8>(sct, kb, ks, 64 * cw, st, st + TB);
      mma3_ss<KEYS, R, DP / 8>(dpt, vb, vs, 64 * cw, st + 2 * TB,
                               st + 3 * TB);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sct);
      fence_regs(dpt);

      const int cls = tile_class(a, r0, r0 + R - 1, key0, key0 + 63);
      uint32_t seg[2] = {0u, 0u};  // rows: keys; columns: query rows
      if (cls == kSegments) {
        segment_bits<R>(a.kv_ids + (size_t)b * a.Nk, key0, a.Nk,
                        a.q_ids + (size_t)b * a.Nq, r0, a.Nq, t, seg);
      }
      dispatch_tile(cls, post, [&](auto c, auto pp) {
#pragma unroll
        for (int i = 0; i < R / 2; ++i) {
          const int key = key0 + acc_row(t, i), j = acc_col(t, i);
          const int row = r0 + j;
          float pv = 0.f, ds = 0.f;
          if (tile_visible<decltype(c)::value>(a, b, row, key, seg, i)) {
            float dcap;
            const float x = tile_score<decltype(pp)::value>(
                a, h, row, key, sct[i], &dcap);
            const float p = expf(x - ls[j]);
            float dp = dpt[i];
            pv = p;
            if (a.dropout) {
              const bool kept = keep(a, bh, row, key);
              pv = kept ? p * a.drop_inv : 0.f;
              dp = kept ? dp * a.drop_inv : 0.f;
            }
            ds = p * (dp - di_t[j]);
            ds = ds * dcap;
          }
          sct[i] = pv;
          dpt[i] = ds;
        }
      });
      uint32_t pb[R / 8][4], ps[R / 8][4], db[R / 8][4], dsm[R / 8][4];
      acc_to_tf32_a<R>(sct, pb, ps);
      acc_to_tf32_a<R>(dpt, db, dsm);

      // dV += p_vᵀ·dO and dK += dsᵀ·q_s, against dOᵀ and q_sᵀ.
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

    // Keys no row sees write zeros.
    const size_t kv_off = ((size_t)b * a.H_kv + hk) * a.Nk;
#pragma unroll
    for (int i = 0; i < DP / 2; i += 2) {
      const int key = key0 + acc_row(t, i), col = acc_col(t, i);
      if (key < a.Nk && col < a.D) {
        const size_t at = (kv_off + key) * a.D + col;
        *reinterpret_cast<float2*>(dk + at) =
            make_float2(dk_acc[i], dk_acc[i + 1]);
        *reinterpret_cast<float2*>(dv + at) =
            make_float2(dv_acc[i], dv_acc[i + 1]);
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(DqF32Cfg<DP>::THREADS, 1)
flash_bwd_dq_f32_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo,
                             AttnArgs a, const float* __restrict__ lse,
                             const float* __restrict__ di,
                             float* __restrict__ dq) {
  using Cfg = DqF32Cfg<DP>;
  constexpr int NC = Cfg::NC, ROWS = Cfg::ROWS, KEYS = Cfg::KEYS;
  constexpr int STAGES = Cfg::STAGES, QB = Cfg::Q_BYTES, TB = Cfg::T_BYTES;
  extern __shared__ char smem_raw[];
  char* qb = align_1024(smem_raw);  // [DP/32][ROWS][32] fp32, q * scale
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

  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * ROWS;
  const int hk = h / (a.H / a.H_kv);
  const TileWalk walk = key_tiles(a, r0, min(r0 + ROWS, a.Nq) - 1, KEYS);

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
    if (threadIdx.x == 0 && walk.n_walk > 0) {
      const int kplane = b * a.H_kv + hk;
      mbar_expect_tx(q_landed, 2 * QB);
      tma_tile32<ROWS, DP>(qb, &tq, q_landed, r0, b * a.H + h);
      tma_tile32<ROWS, DP>(dob, &tdo, q_landed, r0, b * a.H + h);
      for (int w = 0; w < walk.n_walk; ++w) {
        const int s = w % STAGES;
        char* st = stage0 + s * Cfg::STAGE_BYTES;
        mbar_wait(&empty[s], ((w / STAGES) & 1) ^ 1);
        const int c0 = walk.tile(w) * KEYS;
        mbar_expect_tx(&landed[s], 2 * TB);
        tma_tile32<KEYS, DP>(st, &tk, &landed[s], c0, kplane);
        tma_tile32<KEYS, DP>(st + 2 * TB, &tv, &landed[s], c0, kplane);
      }
    } else if (threadIdx.x >= 32 && walk.n_walk > 0) {
      const int tid = threadIdx.x - 32;
      mbar_wait(q_landed, 0);
      split_tile(qb, qb, qs, QB, a.scale, tid, kPrepThreads);
      split_tile(dob, dob, dos, QB, 1.f, tid, kPrepThreads);
      fence_proxy_async();
      mbar_arrive(q_ready);
      for (int w = 0; w < walk.n_walk; ++w) {
        const int s = w % STAGES;
        char* st = stage0 + s * Cfg::STAGE_BYTES;
        mbar_wait(&landed[s], (w / STAGES) & 1);
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
  } else {  // consumers: 64 query rows each
    if constexpr (NC == 2) reg_alloc<kConsumerRegs32>();
    const int cw = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const int row0 = r0 + 64 * cw;
    const uint32_t bh = (uint32_t)(b * a.H + h);
    const bool post = a.slopes != nullptr || a.softcap > 0.f;
    float lse_r[2], di_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + acc_row(t, 2 * r);
      lse_r[r] = row < a.Nq ? lse[(size_t)bh * a.Nq + row] : 0.f;
      di_r[r] = row < a.Nq ? di[(size_t)bh * a.Nq + row] : 0.f;
    }
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

    if (walk.n_walk > 0) mbar_wait(q_ready, 0);
    for (int w = 0; w < walk.n_walk; ++w) {
      const int s = w % STAGES;
      const int c0 = walk.tile(w) * KEYS;
      const char* st = stage0 + s * Cfg::STAGE_BYTES;

      float sc[KEYS / 2], dp[KEYS / 2];  // S and dP: 64 rows x KEYS
      mbar_wait(&ready[s], (w / STAGES) & 1);
      wgmma_fence();
      mma3_ss<ROWS, KEYS, DP / 8>(sc, qb, qs, 64 * cw, st, st + TB);
      mma3_ss<ROWS, KEYS, DP / 8>(dp, dob, dos, 64 * cw, st + 2 * TB,
                                  st + 3 * TB);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      const int cls = tile_class(a, row0, row0 + 63, c0, c0 + KEYS - 1);
      uint32_t seg[2] = {0u, 0u};
      if (cls == kSegments) {
        segment_bits<KEYS>(a.q_ids + (size_t)b * a.Nq, row0, a.Nq,
                           a.kv_ids + (size_t)b * a.Nk, c0, a.Nk, t, seg);
      }
      dispatch_tile(cls, post, [&](auto c, auto pp) {
#pragma unroll
        for (int i = 0; i < KEYS / 2; ++i) {
          const int r = (i >> 1) & 1;
          const int row = row0 + acc_row(t, i), col = c0 + acc_col(t, i);
          float ds = 0.f;
          if (tile_visible<decltype(c)::value>(a, b, row, col, seg, i)) {
            float dcap;
            const float x =
                tile_score<decltype(pp)::value>(a, h, row, col, sc[i], &dcap);
            const float p = expf(x - lse_r[r]);
            float d = dp[i];
            if (a.dropout) d = keep(a, bh, row, col) ? d * a.drop_inv : 0.f;
            ds = p * (d - di_r[r]);
            ds = ds * dcap;
          }
          sc[i] = ds;
        }
      });
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

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + acc_row(t, 2 * r);
      if (row >= a.Nq) continue;
      const size_t base = ((size_t)bh * a.Nq + row) * a.D;
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

template <int DP>
cudaError_t launch_bwd_f32_sm90(const AttnArgs& a, const void* dout,
                                const float* lse, const float* di, void* dq,
                                void* dk, void* dv, cudaStream_t st) {
  using Kv = DkvF32Cfg<DP>;
  using Dq = DqF32Cfg<DP>;
  const int QH = a.B * a.H, KH = a.B * a.H_kv;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = make_map32(&tq, a.q, QH, a.Nq, a.D, box_rows<Kv::R>());
  if (err == cudaSuccess) {
    err = make_map32(&tdo, dout, QH, a.Nq, a.D, box_rows<Kv::R>());
  }
  if (err == cudaSuccess) {
    err = make_map32(&tk, a.k, KH, a.Nk, a.D, box_rows<Kv::KEYS>());
  }
  if (err == cudaSuccess) {
    err = make_map32(&tv, a.v, KH, a.Nk, a.D, box_rows<Kv::KEYS>());
  }
  if (err != cudaSuccess) return err;
  auto dkv_kernel = flash_bwd_dkv_f32_sm90_kernel<DP>;
  err = set_smem(dkv_kernel, Kv::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((a.Nk + Kv::KEYS - 1) / Kv::KEYS, a.H_kv, a.B);
  dkv_kernel<<<grid_kv, Kv::THREADS, Kv::SMEM, st>>>(
      tq, tk, tv, tdo, a, lse, di, static_cast<float*>(dk),
      static_cast<float*>(dv));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // The dQ kernel reads q and dO in tiles of ROWS, K and V of KEYS rows.
  err = make_map32(&tq, a.q, QH, a.Nq, a.D, box_rows<Dq::ROWS>());
  if (err == cudaSuccess) {
    err = make_map32(&tdo, dout, QH, a.Nq, a.D, box_rows<Dq::ROWS>());
  }
  if (err == cudaSuccess) {
    err = make_map32(&tk, a.k, KH, a.Nk, a.D, box_rows<Dq::KEYS>());
  }
  if (err == cudaSuccess) {
    err = make_map32(&tv, a.v, KH, a.Nk, a.D, box_rows<Dq::KEYS>());
  }
  if (err != cudaSuccess) return err;
  auto dq_kernel = flash_bwd_dq_f32_sm90_kernel<DP>;
  err = set_smem(dq_kernel, Dq::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((a.Nq + Dq::ROWS - 1) / Dq::ROWS, a.H, a.B);
  dq_kernel<<<grid_q, Dq::THREADS, Dq::SMEM, st>>>(
      tq, tk, tv, tdo, a, lse, di, static_cast<float*>(dq));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The fp32 tensor-core route at 128 < D <= 256 (3xTF32, A operands split in
// registers)
// ---------------------------------------------------------------------------
//
// At D = 256 a fp32 row is 1 KB, so the D <= 128 layout (both parts of the
// resident operands, transposed copies of the streamed ones) does not fit.
// Resident operands stay as TMA landed them and are the A operands of their
// products, split in registers k8 step by k8 step (mma3_ra); the products
// that would read a transposed copy are computed transposed, with the
// transposed side as a register A operand read across a two-part tile
// (tile_at): dVᵀ += dOᵀ·P_v, dKᵀ += q_sᵀ·dS and dQᵀ += Kᵀ·dSᵀ. Only B
// operands hold two parts in shared memory; split_operands makes them once a
// call into the wrapper's scratch, and TMA lands both parts (split by the
// producer in each CTA, once a tile, they sat on the one stage's critical
// path). A tf32 wgmma of small N runs far below the tensor rate (at N = 16
// about a quarter of it, its A from registers or from shared memory
// alike), and two warpgroups issuing at once raise that by a quarter or
// more (scripts/tf32_wgmma_rates.py), so both kernels have two consumer
// warpgroups that split the small-N products between them; with one
// stage, the producer also fetches the next step's tiles into L2.
//   dkv: 64 keys a CTA; K and V as landed (128 KB, A of Sᵀ = K·q_sᵀ and
//     dPᵀ = V·dOᵀ). Per step of 16 query rows (one stage): q_s and dO in
//     two parts (64 KB), the B operands of Sᵀ and dPᵀ and, read across,
//     the A operands of the transposed products; P_vᵀ and dSᵀ in two parts
//     (32 KB), their B operands: 224 KB. Warps 1-3 of the producer stage
//     the rows' LSE and di. Consumer 0 computes Sᵀ while consumer 1 computes
//     dPᵀ; each hands the other the half of its fragment the other needs
//     (through the 16 columns of P_vᵀ's and dSᵀ's tiles that no product
//     reads), runs the score pipeline on half of the 64 x 16 pairs and
//     writes its half of P_vᵀ and dSᵀ; then each takes 128 of the head
//     dim's columns of dVᵀ and dKᵀ (2 x 64 registers), as the bf16 D split
//     does.
//   dq: 64 query rows a CTA, row tiles taken last to first (in a causal
//     call the longest walks start first); q and dO as landed (128 KB, A
//     of S = q_s·Kᵀ and dP = dO·Vᵀ, q times the scale before the split).
//     Per step of 16 keys (one stage): K and V in two parts (64 KB), dS in
//     two parts (16 KB): 208 KB. Consumer 0 computes S while consumer 1
//     computes dP, the hand-over and the score pipeline as in dkv; each
//     holds 128 columns of dQᵀ (2 x 64 x 64, 64 registers).
// The shapes (DkvWideCfg, DqWideCfg) and the hand-over are in tf32_sm90.cuh,
// the split and the sum kernels in tf32_wide_bwd.cuh: sparse_bwd.cu's wide
// pair shares them.

template <int DP>
__global__ void __launch_bounds__(DkvWideCfg<DP>::THREADS, 1)
flash_bwd_dkv_f32_wide_sm90_kernel(const __grid_constant__ CUtensorMap tqb,
                                   const __grid_constant__ CUtensorMap tqs,
                                   const __grid_constant__ CUtensorMap tk,
                                   const __grid_constant__ CUtensorMap tv,
                                   const __grid_constant__ CUtensorMap tdob,
                                   const __grid_constant__ CUtensorMap tdos,
                                   AttnArgs a, const float* __restrict__ lse,
                                   const float* __restrict__ di,
                                   float* __restrict__ dk,
                                   float* __restrict__ dv, int splits,
                                   float* __restrict__ part) {
  using Cfg = DkvWideCfg<DP>;
  constexpr int KEYS = Cfg::KEYS, R = Cfg::R, KVB = Cfg::KV_BYTES;
  constexpr int TB = Cfg::T_BYTES, XB = Cfg::X_BYTES;
  extern __shared__ char smem_raw[];
  char* kx = align_1024(smem_raw);  // [DP/32][KEYS][32] fp32 as landed
  char* vx = kx + KVB;
  char* qb = vx + KVB;  // q_s and dO in two parts, as split before the call
  char* qs = qb + TB;
  char* dob = qs + TB;
  char* dos = dob + TB;
  char* ptb = dos + TB;  // P_vᵀ and dSᵀ: [KEYS][32], query rows as columns
  char* pts = ptb + XB;
  char* dtb = pts + XB;
  char* dts = dtb + XB;
  float* lse_s = reinterpret_cast<float*>(dts + XB);
  float* di_s = lse_s + R;
  uint64_t* kv_landed = reinterpret_cast<uint64_t*>(di_s + R);
  uint64_t* landed = kv_landed + 1;
  uint64_t* ready = kv_landed + 2;
  uint64_t* empty = kv_landed + 3;

  // A KV head's group of query heads is split over `splits` CTAs, each
  // walking G / splits of them and writing its sums to `part` (null when
  // splits is 1: dk and dv directly).
  const int b = blockIdx.z, c0 = blockIdx.x * KEYS;
  const int hk = blockIdx.y / splits, sp = blockIdx.y % splits;
  const int G = a.H / a.H_kv, GW = G / splits;
  const int h_first = hk * G + sp * GW;  // first query head walked
  // Query rows that can see some key of [c0, c0 + KEYS).
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
    mbar_init(ready, kPrepThreads);
    mbar_init(empty, 256);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer
    reg_dealloc<kProducerRegsWide>();
    if (threadIdx.x == 0 && n_it > 0) {
      mbar_expect_tx(kv_landed, 2 * KVB);
      tma_tile32<KEYS, DP>(kx, &tk, kv_landed, c0, b * a.H_kv + hk);
      tma_tile32<KEYS, DP>(vx, &tv, kv_landed, c0, b * a.H_kv + hk);
      for (int it = 0; it < n_it; ++it) {
        const int plane = b * a.H + h_first + it / n_rt;
        const int r0 = t0 + (it % n_rt) * R;
        mbar_wait(empty, (it & 1) ^ 1);
        mbar_expect_tx(landed, 4 * TB);
        tma_tile32<R, DP>(qb, &tqb, landed, r0, plane);
        tma_tile32<R, DP>(qs, &tqs, landed, r0, plane);
        tma_tile32<R, DP>(dob, &tdob, landed, r0, plane);
        tma_tile32<R, DP>(dos, &tdos, landed, r0, plane);
        if (it + 1 < n_it) {  // the next step's tiles, into L2
          const int p1 = b * a.H + h_first + (it + 1) / n_rt;
          const int r1 = t0 + ((it + 1) % n_rt) * R;
          tma_prefetch32<R, DP>(&tqb, r1, p1);
          tma_prefetch32<R, DP>(&tqs, r1, p1);
          tma_prefetch32<R, DP>(&tdob, r1, p1);
          tma_prefetch32<R, DP>(&tdos, r1, p1);
        }
      }
    } else if (threadIdx.x >= 32 && n_it > 0) {
      const int tid = threadIdx.x - 32;
      for (int it = 0; it < n_it; ++it) {
        const int plane = b * a.H + h_first + it / n_rt;
        const int r0 = t0 + (it % n_rt) * R;
        // The stage is free once its tiles have landed (thread 0 waited
        // for the consumers before loading them).
        mbar_wait(landed, it & 1);
        for (int j = tid; j < R; j += kPrepThreads) {
          const int row = r0 + j;
          const size_t at = (size_t)plane * a.Nq + row;
          lse_s[j] = row < a.Nq ? lse[at] : 0.f;
          di_s[j] = row < a.Nq ? di[at] : 0.f;
        }
        mbar_arrive(ready);
      }
    }
  } else {  // consumers: 64 keys, 128 of the head dim's columns each
    reg_alloc<kConsumerRegsWide>();
    const int cw = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const bool post = a.slopes != nullptr || a.softcap > 0.f;
    float dk_acc[2][32], dv_acc[2][32];  // dKᵀ, dVᵀ: 2 x (64 cols x 64 keys)
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

      // The score pipeline on this consumer's half of the pairs (elements
      // [4 HF, 4 HF + 4): query rows 8 HF .. 8 HF + 7 of the step).
      auto half = [&](auto hf) {
        constexpr int HF = decltype(hf)::value;
        float y[4];  // the other product at this consumer's elements
        hand_over<HF>(x, y, ptb, dtb, t);
        const int cls = tile_class(a, r0 + 8 * HF, r0 + 8 * HF + 7, c0,
                                   c0 + KEYS - 1);
        uint32_t seg[2] = {0u, 0u};  // rows: keys; columns: query rows
        if (cls == kSegments) {
          segment_bits<R>(a.kv_ids + (size_t)b * a.Nk, c0, a.Nk,
                          a.q_ids + (size_t)b * a.Nq, r0, a.Nq, t, seg);
        }
        float pv[4], ds[4];
        dispatch_tile(cls, post, [&](auto c, auto pp) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * HF + e;
            const int key = c0 + acc_row(t, i), j = acc_col(t, i);
            const int row = r0 + j;
            pv[e] = 0.f;
            ds[e] = 0.f;
            if (tile_visible<decltype(c)::value>(a, b, row, key, seg, i)) {
              float dcap;
              const float s = tile_score<decltype(pp)::value>(
                  a, h, row, key, HF == 0 ? x[i] : y[e], &dcap);
              const float p = expf(s - ls[e & 1]);
              float dp = HF == 0 ? y[e] : x[i];
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

      // dVᵀ[cols] += dOᵀ[cols]·P_v and dKᵀ[cols] += q_sᵀ[cols]·dS, A read
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
      named_sync(3, 256);  // P_vᵀ and dSᵀ are in place

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
    // no row sees write zeros.
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
        if (key < a.Nk && col < a.D) {
          const size_t at = (kv_off + key) * a.D + col;
          dk[at] = dk_acc[m][i];
          dv[at] = dv_acc[m][i];
        }
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(DqWideCfg<DP>::THREADS, 1)
flash_bwd_dq_f32_wide_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tkb,
                                  const __grid_constant__ CUtensorMap tks,
                                  const __grid_constant__ CUtensorMap tvb,
                                  const __grid_constant__ CUtensorMap tvs,
                                  const __grid_constant__ CUtensorMap tdo,
                                  AttnArgs a, const float* __restrict__ lse,
                                  const float* __restrict__ di,
                                  float* __restrict__ dq) {
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

  // Row tiles last to first: in a causal call the tiles that walk the
  // most keys start first and the short ones fill the last wave.
  const int b = blockIdx.z, h = blockIdx.y;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * ROWS;
  const int hk = h / (a.H / a.H_kv);
  const TileWalk walk = key_tiles(a, r0, min(r0 + ROWS, a.Nq) - 1, KEYS);

  if (threadIdx.x == 0) {
    mbar_init(q_landed, 1);
    mbar_init(landed, 1);
    mbar_init(empty, 256);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer: thread 0 issues TMA
    reg_dealloc<kProducerRegsWide>();
    if (threadIdx.x == 0 && walk.n_walk > 0) {
      const int kplane = b * a.H_kv + hk;
      mbar_expect_tx(q_landed, 2 * QB);
      tma_tile32<ROWS, DP>(qx, &tq, q_landed, r0, b * a.H + h);
      tma_tile32<ROWS, DP>(dox, &tdo, q_landed, r0, b * a.H + h);
      for (int w = 0; w < walk.n_walk; ++w) {
        const int c0 = walk.tile(w) * KEYS;
        mbar_wait(empty, (w & 1) ^ 1);
        mbar_expect_tx(landed, 4 * TB);
        tma_tile32<KEYS, DP>(kb, &tkb, landed, c0, kplane);
        tma_tile32<KEYS, DP>(ks, &tks, landed, c0, kplane);
        tma_tile32<KEYS, DP>(vb, &tvb, landed, c0, kplane);
        tma_tile32<KEYS, DP>(vs, &tvs, landed, c0, kplane);
        if (w + 1 < walk.n_walk) {  // the next step's tiles, into L2
          const int c1 = walk.tile(w + 1) * KEYS;
          tma_prefetch32<KEYS, DP>(&tkb, c1, kplane);
          tma_prefetch32<KEYS, DP>(&tks, c1, kplane);
          tma_prefetch32<KEYS, DP>(&tvb, c1, kplane);
          tma_prefetch32<KEYS, DP>(&tvs, c1, kplane);
        }
      }
    }
  } else {  // consumers: 64 query rows, 128 of the head dim's columns each
    reg_alloc<kConsumerRegsWide>();
    const int cw = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const uint32_t bh = (uint32_t)(b * a.H + h);
    const bool post = a.slopes != nullptr || a.softcap > 0.f;
    float lse_r[2], di_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + acc_row(t, 2 * r);
      lse_r[r] = row < a.Nq ? lse[(size_t)bh * a.Nq + row] : 0.f;
      di_r[r] = row < a.Nq ? di[(size_t)bh * a.Nq + row] : 0.f;
    }
    float acc[2][32];  // dQᵀ: 2 tiles of 64 cols x 64 rows
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[m][i] = 0.f;
    }

    if (walk.n_walk > 0) mbar_wait(q_landed, 0);
    for (int w = 0; w < walk.n_walk; ++w) {
      const int c0 = walk.tile(w) * KEYS;

      float x[KEYS / 2];  // S (consumer 0) or dP (consumer 1): 64 x KEYS
#pragma unroll
      for (int i = 0; i < KEYS / 2; ++i) x[i] = 0.f;
      mbar_wait(landed, w & 1);
      mma3_ra<ROWS, KEYS, DP / 8, Cfg::GS, Cfg::NB>(
          x, cw == 0 ? qx : dox, cw == 0 ? a.scale : 1.f, cw == 0 ? kb : vb,
          cw == 0 ? ks : vs, t);
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

      // The score pipeline on this consumer's half of the pairs (elements
      // [4 HF, 4 HF + 4): keys 8 HF .. 8 HF + 7 of the step); dS in two
      // parts at (row, key), dQᵀ's B operand, K-major over keys.
      auto half = [&](auto hf) {
        constexpr int HF = decltype(hf)::value;
        float y[4];  // the other product at this consumer's elements
        hand_over<HF>(x, y, dsb, dss, t);
        const int cls =
            tile_class(a, r0, r0 + 63, c0 + 8 * HF, c0 + 8 * HF + 7);
        uint32_t seg[2] = {0u, 0u};
        if (cls == kSegments) {
          segment_bits<KEYS>(a.q_ids + (size_t)b * a.Nq, r0, a.Nq,
                             a.kv_ids + (size_t)b * a.Nk, c0, a.Nk, t, seg);
        }
        float ds[4];
        dispatch_tile(cls, post, [&](auto c, auto pp) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * HF + e;
            const int r = (i >> 1) & 1;
            const int row = r0 + acc_row(t, i), col = c0 + acc_col(t, i);
            ds[e] = 0.f;
            if (tile_visible<decltype(c)::value>(a, b, row, col, seg, i)) {
              float dcap;
              const float s = tile_score<decltype(pp)::value>(
                  a, h, row, col, HF == 0 ? x[i] : y[e], &dcap);
              const float p = expf(s - lse_r[r]);
              float d = HF == 0 ? y[e] : x[i];
              if (a.dropout) d = keep(a, bh, row, col) ? d * a.drop_inv : 0.f;
              ds[e] = p * (d - di_r[r]) * dcap;
            }
          }
        });
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

    // dQᵀ fragments: rows are head-dim columns, columns query rows.
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 128 * cw + 64 * m + acc_row(t, i);
        const int row = r0 + acc_col(t, i);
        if (row < a.Nq && col < a.D) {
          dq[((size_t)bh * a.Nq + row) * a.D + col] = acc[m][i] * a.scale;
        }
      }
    }
  }
}

// `scratch` holds 2 (|q| + |do| + |k| + |v|) floats: q times the scale, dO,
// K and V, each split into its two parts (split_operands); with `splits` > 1
// (query heads of a KV head's group walked by that many dK/dV CTAs) then
// 2 splits |k| more for their partial sums (tf32_wide_bwd.cuh).
template <int DP>
cudaError_t launch_bwd_f32_wide_sm90(const AttnArgs& a, const void* dout,
                                     const float* lse, const float* di,
                                     void* dq, void* dk, void* dv,
                                     float* scratch, int splits,
                                     cudaStream_t st) {
  using Kv = DkvWideCfg<DP>;
  using Dq = DqWideCfg<DP>;
  const WideScratch w = wide_scratch(a, scratch, splits);
  cudaError_t err = split_operands(a, dout, a.scale, w, st);
  if (err != cudaSuccess) return err;
  CUtensorMap m[6];
  err = dkv_wide_maps<DP>(m, a, w);
  if (err != cudaSuccess) return err;
  auto dkv_kernel = flash_bwd_dkv_f32_wide_sm90_kernel<DP>;
  err = set_smem(dkv_kernel, Kv::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((a.Nk + Kv::KEYS - 1) / Kv::KEYS, a.H_kv * splits, a.B);
  dkv_kernel<<<grid_kv, Kv::THREADS, Kv::SMEM, st>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], a, lse, di,
      static_cast<float*>(dk), static_cast<float*>(dv), splits, w.part);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = sum_partials(w, splits, dk, dv, st);
  if (err == cudaSuccess) err = dq_wide_maps<DP>(m, a, dout, w);
  if (err != cudaSuccess) return err;
  auto dq_kernel = flash_bwd_dq_f32_wide_sm90_kernel<DP>;
  err = set_smem(dq_kernel, Dq::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((a.Nq + Dq::ROWS - 1) / Dq::ROWS, a.H, a.B);
  dq_kernel<<<grid_q, Dq::THREADS, Dq::SMEM, st>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], a, lse, di,
      static_cast<float*>(dq));
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace fat

extern "C" {

// dtype: 0 = bfloat16, 1 = float32 (q, k, v, do and the gradients share
// it); lse and di are fp32 (B, H, Nq). Launches the dK/dV kernel, then the
// dQ kernel, on `stream`; returns the first CUDA error.
int fat_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* di, void* dq, void* dk,
                  void* dv, const void* q_ids, const void* kv_ids,
                  const void* slopes, int B, int H, int H_kv, int Nq, int Nk,
                  int D, float scale, int causal, int offset, int window,
                  int sinks, float softcap, float softcap_inv, int dropout,
                  uint32_t drop_threshold, uint32_t seed, float drop_inv,
                  int dtype, void* stream) {
  if (D < 8 || D > 256 || D % 8 != 0 || H_kv < 1 || H % H_kv != 0 || B < 1 ||
      Nq < 1 || Nk < 1 || H > 65535 || B > 65535) {
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
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<__nv_bfloat16>(a, dout, l, d, dq, dk, dv, st);
  } else if (dtype == 1) {
    err = dispatch<float>(a, dout, l, d, dq, dk, dv, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

// The tensor-core route: bf16 only, D <= 256; q, k, v and dout 16-byte
// aligned (TMA). Same arguments as fat_flash_bwd (dtype must be 0).
int fat_flash_bwd_sm90(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* di,
                       void* dq, void* dk, void* dv, const void* q_ids,
                       const void* kv_ids, const void* slopes, int B, int H,
                       int H_kv, int Nq, int Nk, int D, float scale,
                       int causal, int offset, int window, int sinks,
                       float softcap, float softcap_inv, int dropout,
                       uint32_t drop_threshold, uint32_t seed, float drop_inv,
                       int dtype, void* stream) {
  using namespace fat;
  if (dtype != 0 || D < 8 || D > 256 || D % 8 != 0 || H_kv < 1 ||
      H % H_kv != 0 || B < 1 || Nq < 1 || Nk < 1 || H > 65535 || B > 65535) {
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
  const cudaError_t err =
      D <= 64    ? sm90::launch_bwd_sm90<64>(a, dout, l, d, dq, dk, dv, st)
      : D <= 128 ? sm90::launch_bwd_sm90<128>(a, dout, l, d, dq, dk, dv, st)
                 : sm90::launch_bwd_sm90<256>(a, dout, l, d, dq, dk, dv, st);
  return (int)err;
}

// The fp32 tensor-core route (3xTF32): fp32 only, D <= 256; q, k, v and
// dout 16-byte aligned (TMA). Same arguments as fat_flash_bwd (dtype must
// be 1), then `scratch` and `kv_splits`, both unused (null, 1) for
// D <= 128. For D > 128 a KV head's query heads are walked by kv_splits
// dK/dV CTAs (it divides H / H_kv), and scratch holds 2 (|q| + |dout| + |k|
// + |v|) fp32 values, plus 2 kv_splits |k| where kv_splits > 1, 16-byte
// aligned.
int fat_flash_bwd_sm90_f32(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse, const void* di,
                           void* dq, void* dk, void* dv, const void* q_ids,
                           const void* kv_ids, const void* slopes, int B,
                           int H, int H_kv, int Nq, int Nk, int D, float scale,
                           int causal, int offset, int window, int sinks,
                           float softcap, float softcap_inv, int dropout,
                           uint32_t drop_threshold, uint32_t seed,
                           float drop_inv, int dtype, void* stream,
                           void* scratch, int kv_splits) {
  using namespace fat;
  if (dtype != 1 || D < 8 || D > 256 || D % 8 != 0 || H_kv < 1 ||
      H % H_kv != 0 || B < 1 || Nq < 1 || Nk < 1 || H > 65535 || B > 65535 ||
      (D > 128 && (scratch == nullptr ||
                   reinterpret_cast<uintptr_t>(scratch) % 16 != 0 ||
                   kv_splits < 1 || (H / H_kv) % kv_splits != 0 ||
                   H_kv * kv_splits > 65535))) {
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
  const cudaError_t err =
      D <= 64 ? sm90::launch_bwd_f32_sm90<64>(a, dout, l, d, dq, dk, dv, st)
      : D <= 128
          ? sm90::launch_bwd_f32_sm90<128>(a, dout, l, d, dq, dk, dv, st)
          : sm90::launch_bwd_f32_wide_sm90<256>(
                a, dout, l, d, dq, dk, dv, static_cast<float*>(scratch),
                kv_splits, st);
  return (int)err;
}

}  // extern "C"
