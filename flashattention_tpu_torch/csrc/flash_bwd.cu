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
// the tensor-core rate. Like the forward, this first version runs fp32 FMAs
// on the CUDA cores and recomputes the scores in both kernels (7 products
// per element instead of 5).

#include "flash_common.cuh"

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

}  // extern "C"
