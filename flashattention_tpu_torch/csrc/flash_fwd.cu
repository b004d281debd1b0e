// Flash-attention forward on Hopper (sm_90a): o and the fp32 LSE.
//
// Replaces: flashattention_tpu/ops/pallas_attn.py, _fwd_kernel (launched by
// _flash_fwd). Same contract: causal with a query offset, window + sinks,
// GQA, segment ids, soft-cap, in-kernel ALiBi and murmur3 dropout applied
// after the LSE (the LSE and the normaliser l use the pre-dropout p). A row
// with no visible key writes o = 0; its LSE is the running max (-inf or the
// mask value) plus log 1.
//
// Numerics follow the TPU kernel's rounding points: the scores are the fp32
// dot of the input values times the scale; p (after dropout scaling) is
// rounded to the input type before P·V; m, l and the output accumulate in
// fp32; o is written in the input type.
//
// What bounds it on this card: at D = 64 a (query row, key) pair costs
// 4·D flops against a few bytes, so the tensor-core rate bounds it
// (4·B·H·Nq·Nk·D flops, half of that causal, over 989 TFLOP/s). This first
// version does not reach for that bound: it runs fp32 FMAs on the CUDA cores.
//
// Design. Grid (q tiles, H, B); a block of 4 warps owns ROWS query rows (RPW
// per warp), staged once in shared memory as fp32. It walks only the key
// tiles its rows can see (tiles above the causal diagonal or below the window
// band are skipped; sink tiles kept), staging 32 keys of K and V at a time.
// For scores a lane owns one key and reads K and q as float4; for P·V a lane
// owns the output columns lane, lane + 32, ... and reads p from a per-warp
// buffer as float4. The online softmax keeps m and l per row in registers.
// No tensor cores, no cp.async or TMA: a later version moves the two
// products to mma/wgmma.

#include "flash_common.cuh"

namespace {

using namespace fat;

constexpr int kTile = 32;  // keys per staged tile: one per lane

template <int DMAX>
struct FwdCfg {
  static constexpr int RPW = DMAX <= 64 ? 16 : (DMAX <= 128 ? 8 : 4);
  static constexpr int ROWS = kWarps * RPW;
  static constexpr int C = DMAX / 32;  // output columns per lane
  static constexpr int LD = DMAX + 4;  // padded row stride of q_s, k_s
  static constexpr size_t SMEM =
      sizeof(float) *
      (ROWS * LD + kTile * LD + kTile * DMAX + kWarps * RPW * kTile);
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(AttnArgs a, T* __restrict__ o, float* __restrict__ lse) {
  using Cfg = FwdCfg<DMAX>;
  constexpr int RPW = Cfg::RPW, ROWS = Cfg::ROWS, C = Cfg::C, LD = Cfg::LD;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [ROWS][LD]
  float* k_s = q_s + ROWS * LD;                  // [kTile][LD]
  float* v_s = k_s + kTile * LD;                 // [kTile][DMAX]
  float* p_s = v_s + kTile * DMAX;               // [kWarps][RPW][kTile]

  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * ROWS;
  const int hk = h / (a.H / a.H_kv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int D = a.D;
  const T* q = static_cast<const T*>(a.q) + ((size_t)b * a.H + h) * a.Nq * D;
  const T* k = static_cast<const T*>(a.k) + ((size_t)b * a.H_kv + hk) * a.Nk * D;
  const T* v = static_cast<const T*>(a.v) + ((size_t)b * a.H_kv + hk) * a.Nk * D;
  const uint32_t bh = (uint32_t)(b * a.H + h);

  for (int i = threadIdx.x; i < ROWS * DMAX; i += kThreads) {
    const int rr = i / DMAX, d = i % DMAX, r = r0 + rr;
    q_s[rr * LD + d] =
        (r < a.Nq && d < D) ? Num<T>::load(q[(size_t)r * D + d]) : 0.f;
  }

  const TileWalk walk = key_tiles(a, r0, min(r0 + ROWS, a.Nq) - 1, kTile);

  float m[RPW], l[RPW], acc[RPW][C];
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[j][c] = 0.f;
  }
  float* my_p = p_s + warp * RPW * kTile;

  for (int w = 0; w < walk.n_walk; ++w) {
    const int c0 = walk.tile(w) * kTile;
    __syncthreads();  // the previous tile is consumed (and q_s is staged)
    for (int i = threadIdx.x; i < kTile * DMAX; i += kThreads) {
      const int j = i / DMAX, d = i % DMAX, col = c0 + j;
      const bool ok = col < a.Nk && d < D;
      k_s[j * LD + d] = ok ? Num<T>::load(k[(size_t)col * D + d]) : 0.f;
      v_s[j * DMAX + d] = ok ? Num<T>::load(v[(size_t)col * D + d]) : 0.f;
    }
    __syncthreads();

    float s[RPW];
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
      float pc = 0.f;
      if (row < a.Nq) {  // uniform across the warp
        float dcap;
        const bool vis = visible(a, b, row, col);
        float sc = post_score(a, h, row, col, s[j] * a.scale, &dcap);
        sc = vis ? sc : kMaskValue;
        const float m_new = fmaxf(m[j], warp_max(sc));
        const float alpha = expf(m[j] - m_new);
        float p = vis ? expf(sc - m_new) : 0.f;
        l[j] = alpha * l[j] + warp_sum(p);
        m[j] = m_new;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[j][c] *= alpha;
        if (a.dropout) p = keep(a, bh, row, col) ? p * a.drop_inv : 0.f;
        pc = Num<T>::round(p);
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

template <typename T, int DMAX>
cudaError_t launch(const AttnArgs& a, void* o, float* lse, cudaStream_t st) {
  using Cfg = FwdCfg<DMAX>;
  auto kernel = flash_fwd_kernel<T, DMAX>;
  cudaError_t err = set_smem(kernel, Cfg::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Nq + Cfg::ROWS - 1) / Cfg::ROWS, a.H, a.B);
  kernel<<<grid, kThreads, Cfg::SMEM, st>>>(a, static_cast<T*>(o), lse);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const AttnArgs& a, void* o, float* lse, cudaStream_t st) {
  if (a.D <= 64) return launch<T, 64>(a, o, lse, st);
  if (a.D <= 128) return launch<T, 128>(a, o, lse, st);
  return launch<T, 256>(a, o, lse, st);
}

}  // namespace

extern "C" {

// dtype: 0 = bfloat16, 1 = float32 (q, k, v and o share it). Returns
// cudaGetLastError() after the launch.
int fat_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, const void* q_ids, const void* kv_ids,
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
  auto* l = static_cast<float*>(lse);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<__nv_bfloat16>(a, o, l, st);
  } else if (dtype == 1) {
    err = dispatch<float>(a, o, l, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"
