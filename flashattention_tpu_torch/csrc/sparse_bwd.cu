// Block-sparse flash-attention backward on Hopper (sm_90a): kernels B9, B10.
//
// Replaces: flashattention_tpu/ops/pallas_sparse.py, _sparse_bwd_dkv_kernel
// (B9) and _sparse_bwd_dq_kernel (B10). One call launches two kernels, as
// flash_bwd.cu does, and uses no atomics, so the result does not depend on
// block order:
//
//   dkv: one block per (sub-tile of KEYS keys of one KV block, KV head,
//        batch). It walks its KV block's transposed list q_list[ik][0 ..
//        q_count[ik]) and, for each, the rows of that q block that can see
//        its keys, looping over the query heads of its GQA group, so dK and
//        dV sum in fp32 registers (the TPU kernel writes per-query-head fp32
//        partials and group-sums them in XLA: the same sum). A KV block with
//        count 0 stores zeros.
//   dq:  one block per (sub-tile of ROWS rows of one q block, head, batch).
//        It walks the q block's list kv_list[iq][0 .. kv_count[iq]) in 32-key
//        sub-tiles, as the forward does.
//
// Per kept element, with the TPU kernels' rounding points (not the dense
// backward's): s = (q . k in fp32) * scale; p = exp(s - lse) (zero where
// masked); dV += round_T(p) . do; dp = do . v; ds = p * (dp - di);
// dK += round_T(ds) . q and dQ += round_T(ds) . k, both unscaled and times
// the scale at the store. di = rowsum(o . do) - dlse comes from the caller;
// the element mask is the forward's (col < Nk and, when causal,
// col <= r + offset inside an active block).
//
// What bounds it on this card: 10 D flops per kept (head, row, key) against
// q, k, v, do and the three gradients moved once, so the tensor-core rate.
// This first version runs fp32 FMAs on the CUDA cores and recomputes the
// scores in both kernels (7 products per element instead of 5).

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

// The call's four lists and block sizes.
struct Lists {
  const int32_t *kv_list, *kv_count, *q_list, *q_count;
  int kv_stride, q_stride, block_q, block_k;
};

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

}  // extern "C"
