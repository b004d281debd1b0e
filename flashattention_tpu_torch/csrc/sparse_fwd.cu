// Block-sparse flash-attention forward on Hopper (sm_90a): kernel B8.
//
// Replaces: flashattention_tpu/ops/pallas_sparse.py, _sparse_fwd_kernel. The
// TPU kernel walks a grid of (q block, slot) and re-points the KV BlockSpec at
// the slot's entry of a compacted list of active KV blocks; its lagged-max
// frame is a TPU schedule and is not ported.
//
// Function. Query row r sits at key position r + offset (offset = Nk - Nq).
// A q block i attends only to the KV blocks kv_list[i][0 .. kv_count[i]),
// built by ops/sparse_attn.compact_rows from the pattern ANDed with
// tile-granular causal reachability. Inside an active block an element is
// kept iff col < Nk and, when causal, col <= r + offset. s = (q . k in fp32)
// * scale; a masked score takes the finite mask value and its p is zeroed;
// p is rounded to the input type before P.V. Rows of a block with count 0
// give o = 0 and lse = -inf; a row of a visited block that sees no key gives
// o = 0 and lse = the mask value, as the TPU kernel does.
//
// Design. The pattern's blocks (block_q, block_k) set the function only; the
// CUDA tile is free of them. Grid (q block x its sub-tiles of ROWS rows, H,
// B): a block of 4 warps owns ROWS rows of one q block, staged once in shared
// memory as fp32, reads its list and count from device memory (the grid is
// never sized from the counts) and walks each active KV block in 32-key
// sub-tiles, skipping sub-tiles wholly above the causal diagonal. GQA: query
// head h reads KV head h / (H / H_kv), so K/V are never repeated. A lane owns
// one key for the scores and output columns lane, lane + 32, ... for P.V (as
// in flash_fwd.cuh). The walk runs twice: the first pass stages K only and
// takes each row's max, the second computes p = exp(s - max), l and P.V.
// Rounding p to bf16 at the row's final max, as the plain version does, keeps
// kernel and plain within two bf16 ulps; an online softmax rounds p at the
// running max, and at a cancelling output that difference exceeded the limit
// (case d of tests/test_torch_cuda.py). The price is a third product per
// element (Q.K twice).
//
// What bounds it on this card: 4 D flops per kept (head, row, key) on the
// tensor cores against q, the active K/V blocks, o and the LSE moved once, so
// the operations. Like B1, this first version runs fp32 FMAs on the CUDA
// cores, without cp.async, TMA or mma.

#include "flash_common.cuh"

namespace {

using namespace fat;

constexpr int kTile = 32;  // keys per staged sub-tile: one per lane

template <int DMAX>
struct FwdCfg {
  static constexpr int RPW = DMAX <= 64 ? 16 : (DMAX <= 128 ? 8 : 4);
  static constexpr int ROWS = kWarps * RPW;
  static constexpr int C = DMAX / 32;  // output columns per lane
  static constexpr int LD = DMAX + 4;  // padded row stride of q_s, k_s
  static constexpr size_t SMEM =
      sizeof(float) * (ROWS * LD + kTile * LD + kTile * DMAX + kWarps * RPW * kTile);
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
sparse_fwd_kernel(AttnArgs a, const int32_t* __restrict__ kv_list,
                  const int32_t* __restrict__ kv_count, int stride,
                  int block_q, int block_k, T* __restrict__ o,
                  float* __restrict__ lse) {
  using Cfg = FwdCfg<DMAX>;
  constexpr int RPW = Cfg::RPW, ROWS = Cfg::ROWS, C = Cfg::C, LD = Cfg::LD;
  const int sub = (block_q + ROWS - 1) / ROWS;
  const int iq = blockIdx.x / sub;
  const int r0 = iq * block_q + (blockIdx.x % sub) * ROWS;
  const int r_end = min(iq * block_q + block_q, a.Nq);  // this q block's rows
  if (r0 >= r_end) return;

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [ROWS][LD]
  float* k_s = q_s + ROWS * LD;                  // [kTile][LD]
  float* v_s = k_s + kTile * LD;                 // [kTile][DMAX]
  float* p_s = v_s + kTile * DMAX;               // [kWarps][RPW][kTile]

  const int b = blockIdx.z, h = blockIdx.y;
  const int hk = h / (a.H / a.H_kv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int D = a.D;
  const T* q = static_cast<const T*>(a.q) + ((size_t)b * a.H + h) * a.Nq * D;
  const T* k = static_cast<const T*>(a.k) + ((size_t)b * a.H_kv + hk) * a.Nk * D;
  const T* v = static_cast<const T*>(a.v) + ((size_t)b * a.H_kv + hk) * a.Nk * D;

  for (int i = threadIdx.x; i < ROWS * DMAX; i += kThreads) {
    const int rr = i / DMAX, d = i % DMAX, r = r0 + rr;
    q_s[rr * LD + d] = (r < r_end && d < D) ? Num<T>::load(q[(size_t)r * D + d]) : 0.f;
  }

  float m[RPW], l[RPW], acc[RPW][C];
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[j][c] = 0.f;
  }
  float* my_p = p_s + warp * RPW * kTile;

  const int n_active = kv_count[iq];
  const int32_t* blocks = kv_list + (size_t)iq * stride;
  const int r_last = min(r0 + ROWS, r_end) - 1;

  // Stage the 32 keys from c0 (of a block ending at c_end) as fp32, and V
  // beside them when with_v.
  auto stage = [&](int c0, int c_end, bool with_v) {
    __syncthreads();  // the previous sub-tile is consumed (and q_s staged)
    for (int i = threadIdx.x; i < kTile * DMAX; i += kThreads) {
      const int j = i / DMAX, d = i % DMAX, col = c0 + j;
      const bool ok = col < c_end && d < D;
      k_s[j * LD + d] = ok ? Num<T>::load(k[(size_t)col * D + d]) : 0.f;
      if (with_v) v_s[j * DMAX + d] = ok ? Num<T>::load(v[(size_t)col * D + d]) : 0.f;
    }
    __syncthreads();
  };

  // Scaled scores of this warp's rows with the staged keys (lane = key);
  // a masked score takes the mask value.
  auto scores = [&](float* s, bool* vis, int c0, int c_end) {
#pragma unroll
    for (int j = 0; j < RPW; ++j) s[j] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(k_s + lane * LD);
#pragma unroll 4
    for (int d4 = 0; d4 < DMAX / 4; ++d4) {
      const float4 kv = krow[d4];
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        const float4 qv =
            reinterpret_cast<const float4*>(q_s + (warp * RPW + j) * LD)[d4];
        s[j] = dot4(qv, kv, s[j]);
      }
    }
    const int col = c0 + lane;
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int row = r0 + warp * RPW + j;
      vis[j] = col < c_end && (!a.causal || col <= row + a.offset);
      s[j] = vis[j] ? s[j] * a.scale : kMaskValue;
    }
  };

  // The walk: each active KV block's 32-key sub-tiles that some row of this
  // block can see. Pass 0 takes each row's max, pass 1 the softmax and P.V
  // at that max, so p is rounded in the frame the plain version uses.
  for (int pass = 0; pass < 2; ++pass) {
    for (int w = 0; w < n_active; ++w) {
      const int c_lo = blocks[w] * block_k;
      const int c_end = min(c_lo + block_k, a.Nk);  // this KV block's keys
      const int c_stop = a.causal ? min(c_end, r_last + a.offset + 1) : c_end;
      for (int c0 = c_lo; c0 < c_stop; c0 += kTile) {
        stage(c0, c_end, pass == 1);
        float s[RPW];
        bool vis[RPW];
        scores(s, vis, c0, c_end);
        if (pass == 0) {
#pragma unroll
          for (int j = 0; j < RPW; ++j) m[j] = fmaxf(m[j], warp_max(s[j]));
          continue;
        }
#pragma unroll
        for (int j = 0; j < RPW; ++j) {
          const float p = vis[j] ? expf(s[j] - m[j]) : 0.f;
          l[j] += warp_sum(p);
          my_p[j * kTile + lane] = Num<T>::round(p);
        }
        __syncwarp();

#pragma unroll 2
        for (int jj = 0; jj < kTile; jj += 4) {
          float vv[4][C];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
#pragma unroll
            for (int c = 0; c < C; ++c) vv[t][c] = v_s[(jj + t) * DMAX + c * 32 + lane];
          }
#pragma unroll
          for (int j = 0; j < RPW; ++j) {
            const float4 p4 = *reinterpret_cast<const float4*>(my_p + j * kTile + jj);
#pragma unroll
            for (int c = 0; c < C; ++c) {
              float x = acc[j][c];
              x = fmaf(p4.x, vv[0][c], x);
              x = fmaf(p4.y, vv[1][c], x);
              x = fmaf(p4.z, vv[2][c], x);
              acc[j][c] = fmaf(p4.w, vv[3][c], x);
            }
          }
        }
        __syncwarp();  // my_p is rewritten by the next sub-tile
      }
    }
  }

#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int row = r0 + warp * RPW + j;
    if (row >= r_end) continue;
    const float l_safe = l[j] == 0.f ? 1.f : l[j];
    const size_t base = ((size_t)b * a.H + h) * a.Nq + row;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = c * 32 + lane;
      if (d < D) o[base * D + d] = Num<T>::store(acc[j][c] / l_safe);
    }
    // A visited block's row that met no key (or whose sub-tiles were all
    // skipped) holds the mask value, as the TPU kernel's masked tile max.
    const float mr = n_active > 0 ? fmaxf(m[j], kMaskValue) : m[j];
    if (lane == 0) lse[base] = mr + logf(l_safe);
  }
}

template <typename T, int DMAX>
cudaError_t launch(const AttnArgs& a, const int32_t* kv_list,
                   const int32_t* kv_count, int stride, int block_q,
                   int block_k, void* o, float* lse, cudaStream_t st) {
  using Cfg = FwdCfg<DMAX>;
  auto kernel = sparse_fwd_kernel<T, DMAX>;
  cudaError_t err = set_smem(kernel, Cfg::SMEM);
  if (err != cudaSuccess) return err;
  const int n_q_blocks = (a.Nq + block_q - 1) / block_q;
  const int sub = (block_q + Cfg::ROWS - 1) / Cfg::ROWS;
  const dim3 grid(n_q_blocks * sub, a.H, a.B);
  kernel<<<grid, kThreads, Cfg::SMEM, st>>>(a, kv_list, kv_count, stride,
                                           block_q, block_k,
                                           static_cast<T*>(o), lse);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const AttnArgs& a, const int32_t* kv_list,
                     const int32_t* kv_count, int stride, int block_q,
                     int block_k, void* o, float* lse, cudaStream_t st) {
  if (a.D <= 64) {
    return launch<T, 64>(a, kv_list, kv_count, stride, block_q, block_k, o, lse, st);
  }
  if (a.D <= 128) {
    return launch<T, 128>(a, kv_list, kv_count, stride, block_q, block_k, o, lse, st);
  }
  return launch<T, 256>(a, kv_list, kv_count, stride, block_q, block_k, o, lse, st);
}

}  // namespace

extern "C" {

// dtype: 0 = bfloat16, 1 = float32 (q, k, v and o share it); lse is fp32
// (B, H, Nq). kv_list (ceil(Nq / block_q), stride) and kv_count are int32 on
// the device. Launches one kernel on `stream`; returns the CUDA error.
int fat_sparse_fwd(const void* q, const void* k, const void* v, void* o,
                   void* lse, const void* kv_list, const void* kv_count,
                   int B, int H, int H_kv, int Nq, int Nk, int D, float scale,
                   int causal, int block_q, int block_k, int stride, int dtype,
                   void* stream) {
  if (D < 8 || D > 256 || D % 8 != 0 || H_kv < 1 || H % H_kv != 0 || B < 1 ||
      Nq < 1 || Nk < 1 || H > 65535 || B > 65535 || block_q < 1 ||
      block_k < 1 || stride < (Nk + block_k - 1) / block_k) {
    return (int)cudaErrorInvalidValue;
  }
  AttnArgs a{q, k, v, nullptr, nullptr, nullptr, B, H, H_kv, Nq, Nk, D, scale,
             causal, Nk - Nq, 0, 0, 0.f, 0.f, 0, 0u, 0u, 1.f};
  auto st = static_cast<cudaStream_t>(stream);
  const auto* list = static_cast<const int32_t*>(kv_list);
  const auto* count = static_cast<const int32_t*>(kv_count);
  auto* l = static_cast<float*>(lse);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<__nv_bfloat16>(a, list, count, stride, block_q, block_k, o, l, st);
  } else if (dtype == 1) {
    err = dispatch<float>(a, list, count, stride, block_q, block_k, o, l, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"
