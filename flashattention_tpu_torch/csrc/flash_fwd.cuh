// The flash-attention forward kernel, shared by flash_fwd.cu (bf16/fp32
// inputs, kernel B1) and flash_fwd_fp8.cu (one-byte payloads with per-block
// fp32 scales, kernel B4). One body serves both: a payload type `In` says
// how an input element becomes fp32 and how p is rounded before P.V, and
// In::kQuant turns on the per-block scales and the s8 re-quantization of p,
// which compile out of the plain instantiations.
//
// Design. Grid (q tiles, H, B); a block of 4 warps owns ROWS query rows (RPW
// per warp), staged once in shared memory as fp32. It walks only the key
// tiles its rows can see (tiles above the causal diagonal or below the window
// band are skipped; sink tiles kept), staging 32 keys of K and V at a time
// (with each key's two scales beside them when quantized). For scores a lane
// owns one key and reads K and q as float4; for P·V a lane owns the output
// columns lane, lane + 32, ... and reads p from a per-warp buffer as float4.
// The online softmax keeps m and l per row in registers. No tensor cores, no
// cp.async or TMA: a later version moves the two products to mma/wgmma.
#pragma once

#include "flash_common.cuh"

namespace fat {

constexpr int kTile = 32;  // keys per staged tile: one per lane

// Plain inputs: q, k, v and o share T, and p is rounded to T.
template <typename T>
struct PlainIn {
  using Elem = T;
  static constexpr bool kQuant = false;
  static __device__ __forceinline__ float load(T x) { return Num<T>::load(x); }
  static __device__ __forceinline__ float round_p(float p) {
    return Num<T>::round(p);
  }
};

// Per-block fp32 scales of quantized inputs (unread by plain ones).
struct Scales {
  const float* sq;  // (B, H, nqb)
  const float* sk;  // (B, H_kv, nkb)
  const float* sv;  // (B, H_kv, nkb)
  int bq, bk, nqb, nkb;
  int s8;  // re-quantize p to int8 per row and key block
  // s8 on the tensor-core route (flash_fwd_fp8.cu): (B, H, Nq, nkb) fp32
  // scratch of each row's largest kept score in each key block
  float* bmax = nullptr;
};

template <int DMAX, bool kQuant>
struct FwdCfg {
  static constexpr int RPW = DMAX <= 64 ? 16 : (DMAX <= 128 ? 8 : 4);
  static constexpr int ROWS = kWarps * RPW;
  static constexpr int C = DMAX / 32;  // output columns per lane
  static constexpr int LD = DMAX + 4;  // padded row stride of q_s, k_s
  static constexpr size_t SMEM =
      sizeof(float) * (ROWS * LD + kTile * LD + kTile * DMAX +
                       kWarps * RPW * kTile + (kQuant ? 2 * kTile : 0));
};

template <typename T, typename In, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(AttnArgs a, Scales f, T* __restrict__ o,
                 float* __restrict__ lse) {
  using Cfg = FwdCfg<DMAX, In::kQuant>;
  using E = typename In::Elem;
  constexpr int RPW = Cfg::RPW, ROWS = Cfg::ROWS, C = Cfg::C, LD = Cfg::LD;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [ROWS][LD]
  float* k_s = q_s + ROWS * LD;                  // [kTile][LD]
  float* v_s = k_s + kTile * LD;                 // [kTile][DMAX]
  float* p_s = v_s + kTile * DMAX;               // [kWarps][RPW][kTile]
  float* sk_s = p_s + kWarps * RPW * kTile;      // [kTile], quantized only
  float* sv_s = sk_s + kTile;                    // [kTile], quantized only

  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * ROWS;
  const int hk = h / (a.H / a.H_kv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int D = a.D;
  const E* q = static_cast<const E*>(a.q) + ((size_t)b * a.H + h) * a.Nq * D;
  const E* k = static_cast<const E*>(a.k) + ((size_t)b * a.H_kv + hk) * a.Nk * D;
  const E* v = static_cast<const E*>(a.v) + ((size_t)b * a.H_kv + hk) * a.Nk * D;
  const uint32_t bh = (uint32_t)(b * a.H + h);

  for (int i = threadIdx.x; i < ROWS * DMAX; i += kThreads) {
    const int rr = i / DMAX, d = i % DMAX, r = r0 + rr;
    q_s[rr * LD + d] = (r < a.Nq && d < D) ? In::load(q[(size_t)r * D + d]) : 0.f;
  }

  const TileWalk walk = key_tiles(a, r0, min(r0 + ROWS, a.Nq) - 1, kTile);

  // sqr: each row's q scale; ps: its p scale in the current key block (s8).
  float m[RPW], l[RPW], acc[RPW][C], sqr[RPW], ps[RPW];
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    if constexpr (In::kQuant) {
      const int row = r0 + warp * RPW + j;
      sqr[j] = row < a.Nq ? f.sq[((size_t)b * a.H + h) * f.nqb + row / f.bq]
                          : 0.f;
      ps[j] = 1.f;
    }
    m[j] = -INFINITY;
    l[j] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[j][c] = 0.f;
  }
  float* my_p = p_s + warp * RPW * kTile;

  // Stage key tile c0 (and its V when with_v) in shared memory as fp32.
  auto stage = [&](int c0, bool with_v) {
    __syncthreads();  // the previous tile is consumed (and q_s is staged)
    for (int i = threadIdx.x; i < kTile * DMAX; i += kThreads) {
      const int j = i / DMAX, d = i % DMAX, col = c0 + j;
      const bool ok = col < a.Nk && d < D;
      k_s[j * LD + d] = ok ? In::load(k[(size_t)col * D + d]) : 0.f;
      if (with_v) v_s[j * DMAX + d] = ok ? In::load(v[(size_t)col * D + d]) : 0.f;
    }
    if constexpr (In::kQuant) {
      if (threadIdx.x < kTile) {
        const size_t kv = ((size_t)b * a.H_kv + hk) * f.nkb;
        const int col = c0 + threadIdx.x;
        sk_s[threadIdx.x] = col < a.Nk ? f.sk[kv + col / f.bk] : 0.f;
        sv_s[threadIdx.x] = col < a.Nk ? f.sv[kv + col / f.bk] : 0.f;
      }
    }
    __syncthreads();
  };

  // Raw dots of this warp's rows with the staged tile: lane = key.
  auto dots = [&](float* s) {
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
  };

  // Scaled score of row j at column col, through ALiBi and the soft-cap.
  auto score = [&](int j, int row, int col, float raw) {
    float dcap;
    if constexpr (In::kQuant) {
      raw *= (sqr[j] * sk_s[lane]) * a.scale;
    } else {
      raw *= a.scale;
    }
    return post_score(a, h, row, col, raw, &dcap);
  };

  for (int w = 0; w < walk.n_walk; ++w) {
    const int c0 = walk.tile(w) * kTile;
    if constexpr (In::kQuant) {
      const int blk = c0 / f.bk;
      if (f.s8 && (w == 0 || walk.tile(w - 1) * kTile / f.bk != blk)) {
        // Pre-pass over this key block's tiles in the walk: per row, the
        // largest visible score and the largest kept one.
        float mx[RPW], mk[RPW];
#pragma unroll
        for (int j = 0; j < RPW; ++j) mx[j] = mk[j] = -INFINITY;
        for (int w2 = w; w2 < walk.n_walk &&
                         walk.tile(w2) * kTile / f.bk == blk; ++w2) {
          const int e0 = walk.tile(w2) * kTile;
          stage(e0, false);
          float s[RPW];
          dots(s);
          const int col = e0 + lane;
#pragma unroll
          for (int j = 0; j < RPW; ++j) {
            const int row = r0 + warp * RPW + j;
            if (row >= a.Nq) continue;  // uniform across the warp
            const bool vis = visible(a, b, row, col);
            const float sc = vis ? score(j, row, col, s[j]) : -INFINITY;
            const bool kept = vis && (!a.dropout || keep(a, bh, row, col));
            mx[j] = fmaxf(mx[j], warp_max(sc));
            mk[j] = fmaxf(mk[j], warp_max(kept ? sc : -INFINITY));
          }
        }
#pragma unroll
        for (int j = 0; j < RPW; ++j) {
          if (mx[j] > m[j]) {  // the block's max becomes the running max
            const float alpha = expf(m[j] - mx[j]);
            l[j] *= alpha;
#pragma unroll
            for (int c = 0; c < C; ++c) acc[j][c] *= alpha;
            m[j] = mx[j];
          }
          float pmax = mk[j] == -INFINITY ? 0.f : expf(mk[j] - m[j]);
          if (a.dropout) pmax *= a.drop_inv;
          ps[j] = fmaxf(pmax, 1e-30f) * (1.f / 127.f);
        }
      }
    }

    stage(c0, true);
    float s[RPW];
    dots(s);
    const int col = c0 + lane;
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int row = r0 + warp * RPW + j;
      float pc = 0.f;
      if (row < a.Nq) {  // uniform across the warp
        const bool vis = visible(a, b, row, col);
        float sc = score(j, row, col, s[j]);
        sc = vis ? sc : kMaskValue;
        const float m_new = fmaxf(m[j], warp_max(sc));
        const float alpha = expf(m[j] - m_new);
        float p = vis ? expf(sc - m_new) : 0.f;
        l[j] = alpha * l[j] + warp_sum(p);
        m[j] = m_new;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[j][c] *= alpha;
        if (a.dropout) p = keep(a, bh, row, col) ? p * a.drop_inv : 0.f;
        if constexpr (In::kQuant) {
          pc = (f.s8 ? rintf(p / ps[j]) * ps[j] : In::round_p(p)) * sv_s[lane];
        } else {
          pc = In::round_p(p);
        }
      }
      my_p[j * kTile + lane] = pc;
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
    __syncwarp();  // my_p is rewritten by the next tile
  }

#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int row = r0 + warp * RPW + j;
    if (row >= a.Nq) continue;
    const float l_safe = l[j] == 0.f ? 1.f : l[j];
    const size_t base = ((size_t)b * a.H + h) * a.Nq + row;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = c * 32 + lane;
      if (d < D) o[base * D + d] = Num<T>::store(acc[j][c] / l_safe);
    }
    if (lane == 0) lse[base] = m[j] + logf(l_safe);
  }
}

template <typename T, typename In, int DMAX>
cudaError_t launch_fwd(const AttnArgs& a, const Scales& f, void* o,
                       float* lse, cudaStream_t st) {
  using Cfg = FwdCfg<DMAX, In::kQuant>;
  auto kernel = flash_fwd_kernel<T, In, DMAX>;
  cudaError_t err = set_smem(kernel, Cfg::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Nq + Cfg::ROWS - 1) / Cfg::ROWS, a.H, a.B);
  kernel<<<grid, kThreads, Cfg::SMEM, st>>>(a, f, static_cast<T*>(o), lse);
  return cudaGetLastError();
}

// The instantiation for head dim a.D (<= 64, <= 128, <= 256).
template <typename T, typename In>
cudaError_t fwd_by_dim(const AttnArgs& a, const Scales& f, void* o,
                       float* lse, cudaStream_t st) {
  if (a.D <= 64) return launch_fwd<T, In, 64>(a, f, o, lse, st);
  if (a.D <= 128) return launch_fwd<T, In, 128>(a, f, o, lse, st);
  return launch_fwd<T, In, 256>(a, f, o, lse, st);
}

}  // namespace fat
