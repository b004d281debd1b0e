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
// Rounding point. In bf16, p is rounded at each row's final max, as the
// plain version does, so the bf16 routes walk each q block's list twice: the
// first pass takes each row's max, the second computes p = exp(s - max), l
// and P.V. An online softmax rounds p at the running max, and at a
// cancelling output that difference exceeded the two-ulp limit (case d of
// tests/test_torch_cuda.py). The price is a third product per element (Q.K
// twice). In fp32, rounding p to v's type rounds nothing, so the fp32
// routes (tensor-core and mma) walk once with an online softmax.
//
// What bounds it on this card: 4 D flops per kept (head, row, key) on the
// tensor cores (989 TFLOP/s bf16; 165 fp32 on 3xTF32) against q, the active
// K/V blocks, o and the LSE moved once, so the operations. The grid is never
// sized from the counts: every block reads its list and count from device
// memory. GQA: query head h reads KV head h / (H / H_kv), so K/V are never
// repeated.
//
// Four routes, chosen by the caller (ops/sparse_attn.py), and the first
// kernels, on no route:
//
//   fat_sparse_fwd_sm90 (bf16, D <= 256, block_q and block_k multiples of
//     64): every product on the tensor cores. One CTA per (64 NC query rows
//     of one q block, head, batch): NC = 2 consumer warpgroups of 64 rows
//     where block_q % 128 == 0, else 1, so a CTA never spans two q blocks
//     (each has its own list). Warpgroup 0 loads: one thread reads the count
//     and the list, issues TMA for the Q tile once, then walks each active
//     block's sub-tiles of KEYS keys (128 at D <= 64, 64 above, for the
//     consumers' registers) up to the causal stop into a two-stage ring
//     guarded by mbarriers; pass 1 loads K only, pass 2 K and V again (the
//     K tiles of pass 1 are not kept: L2 holds them). The consumers compute
//     S = Q.Kᵀ by wgmma from shared memory in both passes (the same
//     instructions on the same tiles, so pass 2 meets the scores whose max
//     pass 1 took), and O += round(p).V with p as the register A operand (V
//     MN-major). Each sub-tile is classified once, interior (every element
//     kept) or band (the causal diagonal, the end of the KV block or of Nk),
//     and the element loop specialised for it. A sub-tile that runs past
//     its KV block (block_k = 64 at D <= 64) is masked there. A q block
//     with count 0 issues nothing: its consumers skip every wait and still
//     write o = 0 and lse = -inf. Instantiated at D 64, 128 and 256 (any D
//     in (128, 256] runs the 256 kernel; TMA reads zeros past D). At D = 256
//     O holds 128 registers a thread beside the 64-key score fragment's 32,
//     P.V is two n128 products over V's column halves (wgmma_rs<256>), and
//     shared memory holds Q (32 KB a consumer) and two stages of K and V
//     (32 KB each): 192 KB at NC = 2, 160 KB at NC = 1.
//   fat_sparse_fwd_sm90_f32 (fp32, D <= 256, block_q and block_k multiples
//     of 64): both products in 3xTF32 (tf32_sm90.cuh: each fp32 operand
//     split into two TF32 parts, three wgmmas a product, which keeps the
//     fp32 1e-4 limit where one TF32 product would miss it). Up to D = 128,
//     on the schedule of flash_fwd.cu's fp32 kernel with the list walk
//     above: Q resident in two parts, K/V sub-tiles of 64 keys (D <= 64) or
//     32 (D <= 128) in two stages, warps 1-3 of the loading warpgroup
//     splitting each landed K tile and writing Vᵀ in two parts (TF32 wgmma
//     reads shared memory K-major only); NC = 2 only at D <= 64 where
//     block_q % 128 == 0. Above (any D in (128, 256] runs the 256 instance),
//     two parts of a 64-row Q tile alone would take 128 KB, so the list walk
//     runs on the schedule of flash_fwd.cu's wide kernel: Q kept as landed
//     (64 KB) and split in registers k8 step by k8 step as S's A operand,
//     one stage of 32 keys with K and V on barriers of their own (224 KB),
//     one consumer of 64 rows. One pass with an online softmax (above). A q
//     block with count 0 issues nothing and writes o = 0, lse = -inf.
//   fat_sparse_fwd_mma (bf16, D <= 256, block_q and block_k not both
//     multiples of 64): every product on the tensor cores by mma.sync
//     m16n8k16. A wgmma tile has 64 rows; kept inside a q block of 16 or
//     32 rows it would be mostly masked rows, and a CTA never spans two q
//     blocks (each has its own list). So the unit of work is a 16-row slice
//     anchored at its block's start (sparse_mma.cuh), one warp a slice:
//     a CTA takes up to 4 slices of one q block, of the query heads of one
//     KV head (slice-major), so all its warps walk one list and share each
//     K/V sub-tile of 16 keys (blocks of 16 keys or fewer) or 32, anchored
//     at the active KV block's start and staged by cp.async (16 bytes a
//     lane, odd-16-byte rows, so ldmatrix is conflict-free) into a
//     two-stage ring (deeper rings cost more resident CTAs than they hid,
//     scripts/sparse_mma_variants.py). S = Q.K^T with K from ldmatrix,
//     O += round(p).V with p as the register A operand and V from
//     ldmatrix.trans; two passes as the other bf16 route. Q's fragments
//     stay in registers up to D = 128; at D = 256 O takes 128 registers a
//     thread, so Q is read by ldmatrix at each k-step. Where the trouble
//     was: a slice past its block's end or past Nq (block_q = 24, 96)
//     makes its warp idle, which still takes part in every barrier and
//     ring step and stores nothing; a sub-tile past its KV block's end
//     (block_k = 40) reads zeros there and masks them; a column block past
//     D reads a zero row; a q block of 128 rows beside 32-key blocks (128 x
//     32) is two CTAs of 4 slices on one list. Instantiated at D 64, 128
//     and 256, each with 16- and 32-key sub-tiles.
//   fat_sparse_fwd_mma_f32 (fp32, D <= 256, block_q and block_k not both
//     multiples of 64): the bf16 mma route's layout, walk and ring with
//     every product in 3xTF32 on mma.sync m16n8k8 (sparse_mma.cuh), in one
//     pass with an online softmax as the fp32 tensor-core route. Each
//     operand is split into its TF32 parts in registers where a warp reads
//     it: Q's fragment by ldmatrix at each k8 step, K's likewise (a k8
//     step of fp32 is 32 bytes, as a k16 step of bf16), P from S's
//     accumulator, and V, which
//     P.V reads MN-major where ldmatrix.trans would cut an fp32 apart, by
//     32-bit loads at rows 8 j + 2 tq, 8 j + 2 tq + 1 (the permuted k of
//     tf32_sm90.cuh), free of bank conflicts at a row of D + 4 floats.
//     Shared memory doubles bf16's: 200 KB at D = 256 (4 slices of Q and
//     two stages of 32-key K and V), one CTA an SM there. Instantiated at
//     D 64, 128 and 256, each with 16- and 32-key sub-tiles.
//   fat_sparse_fwd (on no route since the fp32 mma kernels; in bf16 and
//     fp32 the comparison chip_smoke.py times beside the other routes):
//     the first version, fp32 FMAs on the CUDA cores. A block of
//     4 warps owns ROWS rows of one q block, staged once in shared memory
//     as fp32, and walks each active KV block in 32-key sub-tiles, skipping
//     sub-tiles wholly above the causal diagonal; a lane owns one key for
//     the scores and output columns lane, lane + 32, ... for P.V.

#include "flash_common.cuh"
#include "sparse_mma.cuh"
#include "sparse_sm90.cuh"
#include "tf32_sm90.cuh"

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

// ---------------------------------------------------------------------------
// The tensor-core route (bf16, D <= 256, blocks multiples of 64)
// ---------------------------------------------------------------------------

namespace fat {
namespace sm90 {

template <int DP, int NC>
struct SparseFwdCfg {
  static constexpr int ROWS = 64 * NC;  // query rows per CTA
  // Keys per K/V sub-tile: 64 at D = 128 and 256, where the O accumulator
  // and a 128-key score fragment overflow a consumer's registers (as
  // flash_fwd.cu).
  static constexpr int KEYS = DP <= 64 ? 128 : 64;
  static constexpr int STAGES = 2;
  static constexpr int THREADS = 128 * (1 + NC);
  static constexpr int Q_BYTES = ROWS * DP * 2;
  static constexpr int KV_BYTES = KEYS * DP * 2;  // one K or V tile
  static constexpr int BARS = 1 + 3 * STAGES;
  static constexpr size_t SMEM =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARS;
};

template <int DP, int NC>
__global__ void __launch_bounds__(SparseFwdCfg<DP, NC>::THREADS, 1)
sparse_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, AttnArgs a,
                       const int32_t* __restrict__ kv_list,
                       const int32_t* __restrict__ kv_count, int stride,
                       int block_q, int block_k,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse) {
  using Cfg = SparseFwdCfg<DP, NC>;
  constexpr int STAGES = Cfg::STAGES, KEYS = Cfg::KEYS, ROWS = Cfg::ROWS;
  // Heavy first: causal, a later q block sees more keys, so the grid's
  // slowest dimension takes the q blocks from the last one.
  const int sub = block_q / ROWS;
  const int iq = (a.Nq + block_q - 1) / block_q - 1 - blockIdx.z / sub;
  const int r0 = iq * block_q + (blockIdx.z % sub) * ROWS;
  const int r_end = min(iq * block_q + block_q, a.Nq);  // this q block's rows
  if (r0 >= r_end) return;

  extern __shared__ char smem_raw[];
  char* q_s = align_1024(smem_raw);          // [DP/64][ROWS][64]
  char* k_s = q_s + Cfg::Q_BYTES;            // [STAGES] tiles
  char* v_s = k_s + STAGES * Cfg::KV_BYTES;  // [STAGES] tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + STAGES * Cfg::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int b = blockIdx.y, h = blockIdx.x;
  const int hk = h / (a.H / a.H_kv);
  const int r_last = min(r0 + ROWS, r_end) - 1;
  const ListWalk walk =
      list_walk(a, kv_list, kv_count, stride, iq, block_k, r_last);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 128 * NC);  // every consumer thread releases
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer
    if constexpr (NC == 2) reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      const int kplane = b * a.H_kv + hk;
      int it = 0;
      for (int pass = 0; pass < 2; ++pass) {
        for (int w = 0; w < walk.n_active; ++w) {
          for (int c0 = walk.lo(w); c0 < walk.stop_of(w); c0 += KEYS, ++it) {
            if (it == 0) {
              mbar_expect_tx(q_full, Cfg::Q_BYTES);
              tma_tile<ROWS, DP>(q_s, &tq, q_full, r0, b * a.H + h);
            }
            const int s = it % STAGES;
            mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
            mbar_expect_tx(&k_full[s], Cfg::KV_BYTES);
            tma_tile<KEYS, DP>(k_s + s * Cfg::KV_BYTES, &tk, &k_full[s], c0,
                               kplane);
            if (pass == 1) {
              mbar_expect_tx(&v_full[s], Cfg::KV_BYTES);
              tma_tile<KEYS, DP>(v_s + s * Cfg::KV_BYTES, &tv, &v_full[s], c0,
                                 kplane);
            }
          }
        }
      }
    }
  } else {  // consumers: 64 query rows each
    if constexpr (NC == 2) reg_alloc<kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const int row0 = r0 + 64 * cw;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

    int it = 0, it_v = 0;  // ring steps; it_v: the first step of pass 2
    for (int pass = 0; pass < 2; ++pass) {
      for (int w = 0; w < walk.n_active; ++w) {
        const int c_end = walk.end(w);
        for (int c0 = walk.lo(w); c0 < walk.stop_of(w); c0 += KEYS, ++it) {
          const int s = it % STAGES, ph = (it / STAGES) & 1;
          const char* kt = k_s + s * Cfg::KV_BYTES;
          const char* vt = v_s + s * Cfg::KV_BYTES;
          if (it == 0) mbar_wait(q_full, 0);

          float sc[KEYS / 2];  // S: 64 rows x KEYS
          mbar_wait(&k_full[s], ph);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk) {
            wgmma_ss<KEYS>(sc, desc_k<ROWS>(q_s, 64 * cw, kk),
                           desc_k<KEYS>(kt, 0, kk), kk > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sc);
          if (pass == 0) mbar_arrive(&empty[s]);  // K read; V not loaded

          // Interior: every element kept; else the band mask per element.
          // fn(i, r, kept, scaled score) on each element of the fragment.
          const bool interior =
              c0 + KEYS <= c_end &&
              (!a.causal || c0 + KEYS - 1 <= row0 + a.offset);
          auto visit = [&](auto fn) {
            auto loop = [&](auto in) {
#pragma unroll
              for (int i = 0; i < KEYS / 2; ++i) {
                const int row = row0 + acc_row(t, i), col = c0 + acc_col(t, i);
                const bool vis =
                    decltype(in)::value || kept(a, row, col, c_end);
                fn(i, (i >> 1) & 1, vis, sc[i] * a.scale);
              }
            };
            if (interior) {
              loop(Int<1>{});
            } else {
              loop(Int<0>{});
            }
          };
          if (pass == 0) {
            visit([&](int, int r, bool vis, float x) {
              m[r] = fmaxf(m[r], vis ? x : kMaskValue);
            });
            continue;
          }
          visit([&](int i, int r, bool vis, float x) {
            const float p = vis ? expf(x - m[r]) : 0.f;
            l[r] += p;
            sc[i] = p;
          });

          uint32_t pa[KEYS / 16][4];
          acc_to_a<KEYS>(sc, pa);
          mbar_wait(&v_full[s], ((it - it_v) / STAGES) & 1);
          wgmma_fence();
          fence_regs(acc);
#pragma unroll
          for (int kk = 0; kk < KEYS / 16; ++kk) {
            wgmma_rs<DP>(acc, pa[kk], desc_mn<KEYS>(vt, kk));
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
          mbar_arrive(&empty[s]);
        }
      }
      if (pass == 0) {
        // Each row's max is spread over the 4 threads of a quad. A visited
        // block's row that met no key (or whose sub-tiles were all past the
        // stop) holds the mask value, as the TPU kernel's masked tile max.
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          m[r] = fmaxf(m[r], __shfl_xor_sync(kFull, m[r], 1));
          m[r] = fmaxf(m[r], __shfl_xor_sync(kFull, m[r], 2));
          if (walk.n_active > 0) m[r] = fmaxf(m[r], kMaskValue);
        }
        it_v = it;
      }
    }

    // Epilogue: each row's l is spread over the 4 threads of a quad.
    const size_t bh = (size_t)b * a.H + h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(kFull, l[r], 1);
      l[r] += __shfl_xor_sync(kFull, l[r], 2);
      const int row = row0 + acc_row(t, 2 * r);
      if (row >= r_end) continue;
      const float l_safe = l[r] == 0.f ? 1.f : l[r];
      const size_t base = bh * a.Nq + row;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int col = acc_col(t, 4 * n);
        if (col < a.D) {
          *reinterpret_cast<__nv_bfloat162*>(o + base * a.D + col) =
              __floats2bfloat162_rn(acc[4 * n + 2 * r] / l_safe,
                                    acc[4 * n + 2 * r + 1] / l_safe);
        }
      }
      if ((t & 3) == 0) lse[base] = m[r] + logf(l_safe);
    }
  }
}

template <int DP, int NC>
cudaError_t launch_sparse_fwd_sm90(const AttnArgs& a, const int32_t* kv_list,
                                   const int32_t* kv_count, int stride,
                                   int block_q, int block_k, void* o,
                                   float* lse, cudaStream_t st) {
  using Cfg = SparseFwdCfg<DP, NC>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, a.q, a.B * a.H, a.Nq, a.D);
  if (err == cudaSuccess) err = make_map(&tk, a.k, a.B * a.H_kv, a.Nk, a.D);
  if (err == cudaSuccess) err = make_map(&tv, a.v, a.B * a.H_kv, a.Nk, a.D);
  if (err != cudaSuccess) return err;
  auto kernel = sparse_fwd_sm90_kernel<DP, NC>;
  err = set_smem(kernel, Cfg::SMEM);
  if (err != cudaSuccess) return err;
  const int n_q_blocks = (a.Nq + block_q - 1) / block_q;
  const dim3 grid(a.H, a.B, n_q_blocks * (block_q / Cfg::ROWS));
  kernel<<<grid, Cfg::THREADS, Cfg::SMEM, st>>>(
      tq, tk, tv, a, kv_list, kv_count, stride, block_q, block_k,
      static_cast<__nv_bfloat16*>(o), lse);
  return cudaGetLastError();
}

template <int DP>
cudaError_t sparse_fwd_sm90(const AttnArgs& a, const int32_t* kv_list,
                            const int32_t* kv_count, int stride, int block_q,
                            int block_k, void* o, float* lse,
                            cudaStream_t st) {
  if (block_q % 128 == 0) {
    return launch_sparse_fwd_sm90<DP, 2>(a, kv_list, kv_count, stride, block_q,
                                         block_k, o, lse, st);
  }
  return launch_sparse_fwd_sm90<DP, 1>(a, kv_list, kv_count, stride, block_q,
                                       block_k, o, lse, st);
}

// ---------------------------------------------------------------------------
// The fp32 tensor-core route (3xTF32, D <= 128, blocks multiples of 64)
// ---------------------------------------------------------------------------

// NC consumer warpgroups of 64 query rows of one q block (NC = 2 only at
// D <= 64 where block_q % 128 == 0); K/V sub-tiles of KEYS keys in STAGES
// stages, as flash_fwd.cu's FwdF32Cfg: Q in two parts (big, small), per
// stage K big (where TMA lands it, split in place), K small, V as landed,
// Vᵀ big and small. 64 + 2 x 80 KB at D = 64 (NC = 2) and at D = 128
// (64 rows, 32 keys); 32 + 2 x 80 KB at D = 64, NC = 1. A sub-tile never
// runs past its KV block: KEYS divides 64.
template <int DP, int NC>
struct SparseFwdF32Cfg {
  static_assert(DP <= 128 && (NC == 1 || DP <= 64), "fp32: D <= 128");
  static constexpr int ROWS = 64 * NC;
  static constexpr int KEYS = DP <= 64 ? 64 : 32;
  static constexpr int STAGES = 2;
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int Q_BYTES = ROWS * DP * 4;  // one part
  static constexpr int T_BYTES = KEYS * DP * 4;  // K, V or Vᵀ, one part
  static_assert(transposed_bytes<KEYS, DP>() == T_BYTES, "Vᵀ tile size");
  static constexpr int STAGE_BYTES = 5 * T_BYTES;
  static constexpr int BARS = 2 + 3 * STAGES;
  static constexpr size_t SMEM =
      1024 + 2 * Q_BYTES + STAGES * STAGE_BYTES + 8 * BARS;
};

// Warpgroup 0: thread 0 issues TMA (Q at the first sub-tile, then K and V
// per sub-tile of the list walk); warps 1-3 split Q and each landed K tile
// in place (big) and into small, and transpose and split V into Vᵀ, then
// release the stage. Consumers: S = Q·Kᵀ in 3xTF32, the element mask and
// an online softmax (in fp32, p rounded to v's type rounds nothing, so one
// pass meets the plain version's final-max frame within the fp32 limit),
// p split in registers as the A operands of O += P·V against Vᵀ.
template <int DP, int NC>
__global__ void __launch_bounds__(SparseFwdF32Cfg<DP, NC>::THREADS, 1)
sparse_fwd_f32_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, AttnArgs a,
                           const int32_t* __restrict__ kv_list,
                           const int32_t* __restrict__ kv_count, int stride,
                           int block_q, int block_k, float* __restrict__ o,
                           float* __restrict__ lse) {
  using Cfg = SparseFwdF32Cfg<DP, NC>;
  constexpr int ROWS = Cfg::ROWS, KEYS = Cfg::KEYS, STAGES = Cfg::STAGES;
  constexpr int TB = Cfg::T_BYTES;
  // Heavy first, as the bf16 route: the q blocks from the last one.
  const int sub = block_q / ROWS;
  const int iq = (a.Nq + block_q - 1) / block_q - 1 - blockIdx.z / sub;
  const int r0 = iq * block_q + (blockIdx.z % sub) * ROWS;
  const int r_end = min(iq * block_q + block_q, a.Nq);  // this q block's rows
  if (r0 >= r_end) return;

  extern __shared__ char smem_raw[];
  char* qb = align_1024(smem_raw);  // [DP/32][ROWS][32] fp32
  char* qs = qb + Cfg::Q_BYTES;
  char* stage0 = qs + Cfg::Q_BYTES;  // [STAGES][K big, K small, V, Vᵀ b, s]
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
            mbar_expect_tx(q_landed, Cfg::Q_BYTES);
            tma_tile32<ROWS, DP>(qb, &tq, q_landed, r0, b * a.H + h);
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
            split_tile(qb, qb, qs, Cfg::Q_BYTES, 1.f, tid, kPrepThreads);
            fence_proxy_async();
            mbar_arrive(q_ready);
          }
          const int s = it % STAGES;
          char* st = stage0 + s * Cfg::STAGE_BYTES;
          mbar_wait(&landed[s], (it / STAGES) & 1);
          split_tile(st, st, st + TB, TB, 1.f, tid, kPrepThreads);
          transpose_split<KEYS, DP>(st + 2 * TB, st + 3 * TB, st + 4 * TB,
                                    1.f, tid, kPrepThreads);
          fence_proxy_async();
          mbar_arrive(&ready[s]);
        }
      }
    }
  } else {  // consumers: 64 query rows each
    if constexpr (NC == 2) reg_alloc<kConsumerRegs32>();
    const int cw = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const int row0 = r0 + 64 * cw;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
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

        float sc[KEYS / 2];  // S: 64 rows x KEYS
        mbar_wait(&ready[s], (it / STAGES) & 1);
        wgmma_fence();
        mma3_ss<ROWS, KEYS, DP / 8>(sc, qb, qs, 64 * cw, st, st + TB);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);

        // Masked scores count in the row max as the mask value and give
        // p = 0 (held as -inf), so a row whose max is still the mask value
        // when its first kept key arrives drops them exactly. Interior:
        // every element kept.
        float mx[2] = {m[0], m[1]};
        const bool interior =
            c0 + KEYS <= c_end &&
            (!a.causal || c0 + KEYS - 1 <= row0 + a.offset);
        auto loop = [&](auto in) {
#pragma unroll
          for (int i = 0; i < KEYS / 2; ++i) {
            const int r = (i >> 1) & 1;
            const int row = row0 + acc_row(t, i), col = c0 + acc_col(t, i);
            const bool vis = decltype(in)::value || kept(a, row, col, c_end);
            const float x = sc[i] * a.scale;
            mx[r] = fmaxf(mx[r], vis ? x : kMaskValue);
            sc[i] = vis ? x : -INFINITY;
          }
        };
        if (interior) {
          loop(Int<1>{});
        } else {
          loop(Int<0>{});
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
          const float alpha = expf(m[r] - mx[r]);
          l[r] *= alpha;
          m[r] = mx[r];
#pragma unroll
          for (int i = 0; i < DP / 2; ++i) {
            if (((i >> 1) & 1) == r) acc[i] *= alpha;
          }
        }
#pragma unroll
        for (int i = 0; i < KEYS / 2; ++i) {
          const float p = expf(sc[i] - m[(i >> 1) & 1]);
          l[(i >> 1) & 1] += p;
          sc[i] = p;
        }
        uint32_t pb[KEYS / 8][4], ps[KEYS / 8][4];
        acc_to_tf32_a<KEYS>(sc, pb, ps);

        wgmma_fence();
        fence_regs(acc);
        mma3_rs<DP, KEYS / 8>(acc, pb, ps, st + 3 * TB, st + 4 * TB);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        keep_regs(pb);
        keep_regs(ps);
        mbar_arrive(&empty[s]);
      }
    }

    // Epilogue: each row's l is spread over the 4 threads of a quad. A
    // visited block's row that met no key (or whose sub-tiles were all
    // past the stop) holds the mask value, as the TPU kernel's masked tile
    // max; rows of a block with count 0 keep -inf.
    const size_t bh = (size_t)b * a.H + h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(kFull, l[r], 1);
      l[r] += __shfl_xor_sync(kFull, l[r], 2);
      if (walk.n_active > 0) m[r] = fmaxf(m[r], kMaskValue);
      const int row = row0 + acc_row(t, 2 * r);
      if (row >= r_end) continue;
      const float l_safe = l[r] == 0.f ? 1.f : l[r];
      const size_t base = bh * a.Nq + row;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int col = acc_col(t, 4 * n);
        if (col < a.D) {
          *reinterpret_cast<float2*>(o + base * a.D + col) =
              make_float2(acc[4 * n + 2 * r] / l_safe,
                          acc[4 * n + 2 * r + 1] / l_safe);
        }
      }
      if ((t & 3) == 0) lse[base] = m[r] + logf(l_safe);
    }
  }
}

template <int DP, int NC>
cudaError_t launch_sparse_fwd_f32_sm90(const AttnArgs& a,
                                       const int32_t* kv_list,
                                       const int32_t* kv_count, int stride,
                                       int block_q, int block_k, void* o,
                                       float* lse, cudaStream_t st) {
  using Cfg = SparseFwdF32Cfg<DP, NC>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map32(&tq, a.q, a.B * a.H, a.Nq, a.D,
                               box_rows<Cfg::ROWS>());
  if (err == cudaSuccess) {
    err = make_map32(&tk, a.k, a.B * a.H_kv, a.Nk, a.D, box_rows<Cfg::KEYS>());
  }
  if (err == cudaSuccess) {
    err = make_map32(&tv, a.v, a.B * a.H_kv, a.Nk, a.D, box_rows<Cfg::KEYS>());
  }
  if (err != cudaSuccess) return err;
  auto kernel = sparse_fwd_f32_sm90_kernel<DP, NC>;
  err = set_smem(kernel, Cfg::SMEM);
  if (err != cudaSuccess) return err;
  const int n_q_blocks = (a.Nq + block_q - 1) / block_q;
  const dim3 grid(a.H, a.B, n_q_blocks * (block_q / Cfg::ROWS));
  kernel<<<grid, Cfg::THREADS, Cfg::SMEM, st>>>(
      tq, tk, tv, a, kv_list, kv_count, stride, block_q, block_k,
      static_cast<float*>(o), lse);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The fp32 tensor-core route at 128 < D <= 256 (3xTF32, Q split in
// registers)
// ---------------------------------------------------------------------------

// flash_fwd.cu's wide kernel (FwdWideCfg: one consumer warpgroup of 64
// query rows, Q as landed and split in registers k8 step by k8 step as S's
// A operand, one stage of 32 keys with K and V on barriers of their own,
// 224 KB) walking the lists as sparse_fwd_f32_sm90_kernel does: thread 0
// reads the count and the list and issues TMA for Q at the first sub-tile,
// then K and V for each sub-tile of each active block up to the causal
// stop; warps 1-3 split each landed K tile in place and into small, and
// transpose and split each landed V tile into Vᵀ. A CTA's 64 rows never
// span two q blocks (block_q is a multiple of 64); a q block with count 0
// issues nothing and writes o = 0, lse = -inf. The consumer: S = Q·Kᵀ with
// Q split unscaled (s = (q·k) * scale), the element mask, one pass with an
// online softmax, O += P·V against Vᵀ (O is 128 registers a thread).
template <int DP>
__global__ void __launch_bounds__(FwdWideCfg<DP>::THREADS, 1)
sparse_fwd_f32_wide_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                AttnArgs a,
                                const int32_t* __restrict__ kv_list,
                                const int32_t* __restrict__ kv_count,
                                int stride, int block_q, int block_k,
                                float* __restrict__ o,
                                float* __restrict__ lse) {
  using Cfg = FwdWideCfg<DP>;
  constexpr int ROWS = Cfg::ROWS, KEYS = Cfg::KEYS, TB = Cfg::T_BYTES;
  // Heavy first, as the other routes: the row tiles from the last one.
  const int r0 = (gridDim.z - 1 - blockIdx.z) * ROWS;
  const int iq = r0 / block_q;
  const int r_end = min(iq * block_q + block_q, a.Nq);  // this q block's rows

  extern __shared__ char smem_raw[];
  char* qx = align_1024(smem_raw);  // [DP/32][ROWS][32] fp32 as landed
  char* kb = qx + Cfg::Q_BYTES;
  char* ks = kb + TB;
  char* vx = ks + TB;  // V as landed
  char* vtb = vx + TB;
  char* vts = vtb + TB;
  uint64_t* q_landed = reinterpret_cast<uint64_t*>(vts + TB);
  uint64_t* k_landed = q_landed + 1;
  uint64_t* k_ready = q_landed + 2;
  uint64_t* k_empty = q_landed + 3;
  uint64_t* v_landed = q_landed + 4;
  uint64_t* v_ready = q_landed + 5;
  uint64_t* v_empty = q_landed + 6;

  const int b = blockIdx.y, h = blockIdx.x;
  const int hk = h / (a.H / a.H_kv);
  const ListWalk walk = list_walk(a, kv_list, kv_count, stride, iq, block_k,
                                  min(r0 + ROWS, r_end) - 1);

  if (threadIdx.x == 0) {
    mbar_init(q_landed, 1);
    mbar_init(k_landed, 1);
    mbar_init(k_ready, kPrepThreads);
    mbar_init(k_empty, 128);
    mbar_init(v_landed, 1);
    mbar_init(v_ready, kPrepThreads);
    mbar_init(v_empty, 128);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer
    if (threadIdx.x == 0) {
      const int kplane = b * a.H_kv + hk;
      int it = 0;
      for (int w = 0; w < walk.n_active; ++w) {
        for (int c0 = walk.lo(w); c0 < walk.stop_of(w); c0 += KEYS, ++it) {
          if (it == 0) {
            mbar_expect_tx(q_landed, Cfg::Q_BYTES);
            tma_tile32<ROWS, DP>(qx, &tq, q_landed, r0, b * a.H + h);
          }
          mbar_wait(k_empty, (it & 1) ^ 1);
          mbar_expect_tx(k_landed, TB);
          tma_tile32<KEYS, DP>(kb, &tk, k_landed, c0, kplane);
          if (it > 0) mbar_wait(v_ready, (it - 1) & 1);  // V landed is free
          mbar_expect_tx(v_landed, TB);
          tma_tile32<KEYS, DP>(vx, &tv, v_landed, c0, kplane);
        }
      }
    } else if (threadIdx.x >= 32) {
      const int tid = threadIdx.x - 32;
      int it = 0;
      for (int w = 0; w < walk.n_active; ++w) {
        for (int c0 = walk.lo(w); c0 < walk.stop_of(w); c0 += KEYS, ++it) {
          const int ph = it & 1;
          mbar_wait(k_landed, ph);
          split_tile(kb, kb, ks, TB, 1.f, tid, kPrepThreads);
          fence_proxy_async();
          mbar_arrive(k_ready);
          mbar_wait(v_landed, ph);
          mbar_wait(v_empty, ph ^ 1);  // P·V of the last tile read Vᵀ
          transpose_split<KEYS, DP>(vx, vtb, vts, 1.f, tid, kPrepThreads);
          fence_proxy_async();
          mbar_arrive(v_ready);
        }
      }
    }
  } else {  // the consumer: 64 query rows
    const int t = threadIdx.x - 128;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

    int it = 0;
    for (int w = 0; w < walk.n_active; ++w) {
      const int c_end = walk.end(w);
      for (int c0 = walk.lo(w); c0 < walk.stop_of(w); c0 += KEYS, ++it) {
        const int ph = it & 1;
        if (it == 0) mbar_wait(q_landed, 0);

        float sc[KEYS / 2];  // S: 64 rows x KEYS
#pragma unroll
        for (int i = 0; i < KEYS / 2; ++i) sc[i] = 0.f;
        mbar_wait(k_ready, ph);
        mma3_ra<ROWS, KEYS, DP / 8, Cfg::GS, Cfg::NB>(sc, qx, 1.f, kb, ks, t);
        mbar_arrive(k_empty);

        // Masked scores count in the row max as the mask value and give
        // p = 0 (held as -inf), as the D <= 128 route. Interior: every
        // element kept.
        float mx[2] = {m[0], m[1]};
        const bool interior =
            c0 + KEYS <= c_end && (!a.causal || c0 + KEYS - 1 <= r0 + a.offset);
        auto loop = [&](auto in) {
#pragma unroll
          for (int i = 0; i < KEYS / 2; ++i) {
            const int r = (i >> 1) & 1;
            const int row = r0 + acc_row(t, i), col = c0 + acc_col(t, i);
            const bool vis = decltype(in)::value || kept(a, row, col, c_end);
            const float x = sc[i] * a.scale;
            mx[r] = fmaxf(mx[r], vis ? x : kMaskValue);
            sc[i] = vis ? x : -INFINITY;
          }
        };
        if (interior) {
          loop(Int<1>{});
        } else {
          loop(Int<0>{});
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
          const float alpha = expf(m[r] - mx[r]);
          l[r] *= alpha;
          m[r] = mx[r];
#pragma unroll
          for (int i = 0; i < DP / 2; ++i) {
            if (((i >> 1) & 1) == r) acc[i] *= alpha;
          }
        }
#pragma unroll
        for (int i = 0; i < KEYS / 2; ++i) {
          const float p = expf(sc[i] - m[(i >> 1) & 1]);
          l[(i >> 1) & 1] += p;
          sc[i] = p;
        }
        uint32_t pb[KEYS / 8][4], ps[KEYS / 8][4];
        acc_to_tf32_a<KEYS>(sc, pb, ps);

        mbar_wait(v_ready, ph);
        wgmma_fence();
        fence_regs(acc);
        mma3_rs<DP, KEYS / 8>(acc, pb, ps, vtb, vts);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        keep_regs(pb);
        keep_regs(ps);
        mbar_arrive(v_empty);
      }
    }

    // Epilogue, as the D <= 128 route: a visited block's row that met no
    // key holds the mask value; rows of a block with count 0 keep -inf.
    const size_t bh = (size_t)b * a.H + h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(kFull, l[r], 1);
      l[r] += __shfl_xor_sync(kFull, l[r], 2);
      if (walk.n_active > 0) m[r] = fmaxf(m[r], kMaskValue);
      const int row = r0 + acc_row(t, 2 * r);
      if (row >= r_end) continue;
      const float l_safe = l[r] == 0.f ? 1.f : l[r];
      const size_t base = bh * a.Nq + row;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int col = acc_col(t, 4 * n);
        if (col < a.D) {
          *reinterpret_cast<float2*>(o + base * a.D + col) =
              make_float2(acc[4 * n + 2 * r] / l_safe,
                          acc[4 * n + 2 * r + 1] / l_safe);
        }
      }
      if ((t & 3) == 0) lse[base] = m[r] + logf(l_safe);
    }
  }
}

template <int DP>
cudaError_t launch_sparse_fwd_f32_wide_sm90(const AttnArgs& a,
                                            const int32_t* kv_list,
                                            const int32_t* kv_count,
                                            int stride, int block_q,
                                            int block_k, void* o, float* lse,
                                            cudaStream_t st) {
  using Cfg = FwdWideCfg<DP>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map32(&tq, a.q, a.B * a.H, a.Nq, a.D,
                               box_rows<Cfg::ROWS>());
  if (err == cudaSuccess) {
    err = make_map32(&tk, a.k, a.B * a.H_kv, a.Nk, a.D, box_rows<Cfg::KEYS>());
  }
  if (err == cudaSuccess) {
    err = make_map32(&tv, a.v, a.B * a.H_kv, a.Nk, a.D, box_rows<Cfg::KEYS>());
  }
  if (err != cudaSuccess) return err;
  auto kernel = sparse_fwd_f32_wide_sm90_kernel<DP>;
  err = set_smem(kernel, Cfg::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, a.B, (a.Nq + Cfg::ROWS - 1) / Cfg::ROWS);
  kernel<<<grid, Cfg::THREADS, Cfg::SMEM, st>>>(
      tq, tk, tv, a, kv_list, kv_count, stride, block_q, block_k,
      static_cast<float*>(o), lse);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace fat

// ---------------------------------------------------------------------------
// The mma route (bf16, D <= 256, blocks not both multiples of 64)
// ---------------------------------------------------------------------------

namespace fat {
namespace mma {

template <int DP, int KEYS>
struct FwdMmaCfg {
  // Q held as A fragments in registers up to D = 128; at D = 256 O takes
  // 128 registers a thread, so Q is read by ldmatrix at each k-step.
  static constexpr bool QREG = DP <= 128;
  __host__ __device__ static constexpr size_t smem(int warps, int rs) {
    return (size_t)warps * kSlice * rs + (size_t)kStages * 2 * KEYS * rs;
  }
};

// One CTA takes W = blockDim.x / 32 units of one q block: unit u is slice
// u / G of query head hk * G + u % G, one warp a unit, so every warp of
// the CTA follows one list and reads one KV head, and the warps share each
// K/V sub-tile, staged by all threads into a ring of kStages.
template <int DP, int KEYS>
__global__ void __launch_bounds__(kMaxWarps * 32)
sparse_fwd_mma_kernel(AttnArgs a, const int32_t* __restrict__ kv_list,
                      const int32_t* __restrict__ kv_count, int stride,
                      int block_q, int block_k, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse) {
  using Cfg = FwdMmaCfg<DP, KEYS>;
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
  // heavy first: causal, a later q block sees more keys
  const int iq = n_q_blocks - 1 - blockIdx.x / per;
  const int u0 = blockIdx.x % per * W, u = u0 + warp;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int r_end = min(iq * block_q + block_q, a.Nq);  // this q block's rows
  const int h = hk * G + u % G;
  const int r0 = iq * block_q + u / G * kSlice;
  const bool live = u < units && r0 < r_end;  // past Nq: nothing to store
  const int r_last = min(iq * block_q + (min(units, u0 + W) - 1) / G * kSlice +
                             kSlice - 1, r_end - 1);
  const int n_active = kv_count[iq];
  KeyWalk ld = key_walk(a, kv_list + (size_t)iq * stride, n_active, block_k,
                        r_last, KEYS, 2);

  const size_t kv_off = ((size_t)b * a.H_kv + hk) * a.Nk * D;
  const auto* kg = static_cast<const __nv_bfloat16*>(a.k) + kv_off;
  const auto* vg = static_cast<const __nv_bfloat16*>(a.v) + kv_off;
  char* q_s = smem + warp * kSlice * rs;  // this warp's 16 rows
  char* ring = smem + W * kSlice * rs;
  const int stage_bytes = 2 * KEYS * rs;
  if (threadIdx.x == 0) zero_row = make_uint4(0u, 0u, 0u, 0u);
  const uint32_t zero = smem_u32(&zero_row);
  const RowCopy rc = row_copy<__nv_bfloat16>(D, threadIdx.x, blockDim.x);
  const RowCopy rc_warp = row_copy<__nv_bfloat16>(D, lane, 32);

  // Pass 0 stages K; pass 1 K and V.
  auto issue = [&](int st) {
    char* kt = ring + st * stage_bytes;
    const int n_ok = ld.end() - ld.c0;
    load_rows(rc, kt, kg + (size_t)ld.c0 * D, KEYS, n_ok, rs);
    if (ld.pass == 1) {
      load_rows(rc, kt + KEYS * rs, vg + (size_t)ld.c0 * D, KEYS, n_ok, rs);
    }
  };

  // A visited block's row that meets no key keeps the mask value as its
  // max (lse = the mask value); rows of a block with count 0 keep -inf.
  float m[2], l[2] = {0.f, 0.f}, acc[2 * KS][4];
  m[0] = m[1] = n_active > 0 ? kMaskValue : -INFINITY;
#pragma unroll
  for (int i = 0; i < 2 * KS; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  }
  uint32_t qf[Cfg::QREG ? KS : 1][4];

  if (!ld.done()) {
    if (live) {
      load_rows(rc_warp, q_s,
                static_cast<const __nv_bfloat16*>(a.q) +
                    (((size_t)b * a.H + h) * a.Nq + r0) * D,
                kSlice, r_end - r0, rs);
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
    bool reduced = false;
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
              ldsm_x4(qf[ks], d < D ? smem_u32(q_s + a_row(lane) * rs + d * 2)
                                    : zero);
            }
          }
        }
      }

      // S = Q.K^T over the sub-tile (16 rows x KEYS keys); the same
      // instructions in both passes, so pass 1 meets the scores whose max
      // pass 0 took.
      float sc[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[n][c] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (ks >= ksteps) continue;
        uint32_t af[4];
        if constexpr (Cfg::QREG) {
#pragma unroll
          for (int i = 0; i < 4; ++i) af[i] = qf[ks][i];
        } else {
          const int d = ks * 16 + a_col(lane);
          ldsm_x4(af, d < D ? smem_u32(q_s + a_row(lane) * rs + d * 2) : zero);
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bf[4];
          const int d = ks * 16 + b_col(lane);
          ldsm_x4(bf, d < D ? smem_u32(kt + (np * 16 + b_row(lane)) * rs +
                                       d * 2)
                            : zero);
          mma_16816(sc[2 * np], af, bf[0], bf[1]);
          mma_16816(sc[2 * np + 1], af, bf[2], bf[3]);
        }
      }

      const int c0 = cw.c0, c_end = cw.end();
      if (cw.pass == 0) {  // each lane's max over its elements
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
        continue;
      }
      if (!reduced) {  // the rows' final max, over the 4 lanes of a row
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          m[r] = fmaxf(m[r], __shfl_xor_sync(kFull, m[r], 1));
          m[r] = fmaxf(m[r], __shfl_xor_sync(kFull, m[r], 2));
        }
        reduced = true;
      }
      // p at the row's final max, rounded to bf16 as P.V's A operand
      uint32_t pa[NT / 2][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float p[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = r0 + g + 8 * (c >> 1);
          const int col = c0 + 8 * n + 2 * tq + (c & 1);
          p[c] = kept(a, row, col, c_end)
                     ? expf(sc[n][c] * a.scale - m[c >> 1])
                     : 0.f;
          l[c >> 1] += p[c];
        }
        pa[n / 2][2 * (n & 1)] = pack_bf16(p[0], p[1]);
        pa[n / 2][2 * (n & 1) + 1] = pack_bf16(p[2], p[3]);
      }
      // O += P.V: V's rows are P.V's K, read by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
        for (int dn = 0; dn < KS; ++dn) {
          if (dn >= ksteps) continue;
          uint32_t bf[4];
          const int d = dn * 16 + a_col(lane);
          ldsm_x4_t(bf, d < D ? smem_u32(vt + (kk * 16 + a_row(lane)) * rs +
                                         d * 2)
                              : zero);
          mma_16816(acc[2 * dn], pa[kk], bf[0], bf[1]);
          mma_16816(acc[2 * dn + 1], pa[kk], bf[2], bf[3]);
        }
      }
    }
  }
  if (!live) return;

  const size_t bh = (size_t)b * a.H + h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    const int row = r0 + g + 8 * r;
    if (row >= r_end) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    const size_t base = bh * a.Nq + row;
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n) {
      const int col = 8 * n + 2 * tq;
      if (col < D) {
        *reinterpret_cast<__nv_bfloat162*>(o + base * D + col) =
            __floats2bfloat162_rn(acc[n][2 * r] / l_safe,
                                  acc[n][2 * r + 1] / l_safe);
      }
    }
    if (tq == 0) lse[base] = m[r] + logf(l_safe);
  }
}

template <int DP, int KEYS>
cudaError_t launch_sparse_fwd_mma(const AttnArgs& a, const int32_t* kv_list,
                                  const int32_t* kv_count, int stride,
                                  int block_q, int block_k, void* o,
                                  float* lse, cudaStream_t st) {
  const int units = (block_q + kSlice - 1) / kSlice * (a.H / a.H_kv);
  const int warps = cta_warps(units);
  const size_t smem = FwdMmaCfg<DP, KEYS>::smem(warps, tc_row_bytes(a.D));
  auto kernel = sparse_fwd_mma_kernel<DP, KEYS>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long ctas = (long long)((a.Nq + block_q - 1) / block_q) *
                         ((units + warps - 1) / warps);
  if (ctas > 0x7fffffff) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)ctas, a.H_kv, a.B);
  kernel<<<grid, 32 * warps, smem, st>>>(a, kv_list, kv_count, stride,
                                         block_q, block_k,
                                         static_cast<__nv_bfloat16*>(o), lse);
  return cudaGetLastError();
}

// Sub-tiles of 16 keys for blocks of 16 keys or fewer, else 32.
template <int DP>
cudaError_t sparse_fwd_mma(const AttnArgs& a, const int32_t* kv_list,
                           const int32_t* kv_count, int stride, int block_q,
                           int block_k, void* o, float* lse,
                           cudaStream_t st) {
  return block_k <= 16
             ? launch_sparse_fwd_mma<DP, 16>(a, kv_list, kv_count, stride,
                                             block_q, block_k, o, lse, st)
             : launch_sparse_fwd_mma<DP, 32>(a, kv_list, kv_count, stride,
                                             block_q, block_k, o, lse, st);
}

// ---------------------------------------------------------------------------
// The fp32 mma route (3xTF32 on m16n8k8, D <= 256, blocks not both
// multiples of 64)
// ---------------------------------------------------------------------------

// The bf16 mma forward's layout and walk (units of 16 rows of one query
// head, all warps of a CTA on one list and one KV head, K and V sub-tiles
// in a ring, FwdMmaCfg's shared memory at f32_row_bytes(D) a row) in one
// pass with an online softmax: rounding p to v's type rounds nothing in
// fp32, so p at the running max is p at the final max. S = Q.K^T with K
// from ldmatrix, O += P.V with P from S's accumulator and V by 32-bit
// loads (f32_b), every product in 3xTF32. Q's fragment is read by ldmatrix
// and split at each k8 step: holding both parts in registers at D = 64 (64
// registers) cost resident CTAs and was 10% slower at phase 7g's call
// (scripts/sparse_mma_variants.py, "qreg"). The fp32 mma kernels name one
// CTA an SM as their minimum: with the thread count alone ptxas held some
// instances to 128 or 168 registers and spilled 32-56 bytes.
template <int DP, int KEYS>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
sparse_fwd_f32_mma_kernel(AttnArgs a, const int32_t* __restrict__ kv_list,
                          const int32_t* __restrict__ kv_count, int stride,
                          int block_q, int block_k, float* __restrict__ o,
                          float* __restrict__ lse) {
  constexpr int STAGES = kStages, KS = DP / 8, NT = KEYS / 8;
  extern __shared__ __align__(128) char smem[];

  const int W = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int G = a.H / a.H_kv, D = a.D, rs = f32_row_bytes(D);
  const int ksteps = D / 8;
  const int units = (block_q + kSlice - 1) / kSlice * G;
  const int per = (units + W - 1) / W;
  const int n_q_blocks = (a.Nq + block_q - 1) / block_q;
  // heavy first: causal, a later q block sees more keys
  const int iq = n_q_blocks - 1 - blockIdx.x / per;
  const int u0 = blockIdx.x % per * W, u = u0 + warp;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int r_end = min(iq * block_q + block_q, a.Nq);  // this q block's rows
  const int h = hk * G + u % G;
  const int r0 = iq * block_q + u / G * kSlice;
  const bool live = u < units && r0 < r_end;  // past Nq: nothing to store
  const int r_last = min(iq * block_q + (min(units, u0 + W) - 1) / G * kSlice +
                             kSlice - 1, r_end - 1);
  const int n_active = kv_count[iq];
  KeyWalk ld = key_walk(a, kv_list + (size_t)iq * stride, n_active, block_k,
                        r_last, KEYS, 1);

  const size_t kv_off = ((size_t)b * a.H_kv + hk) * a.Nk * D;
  const float* kg = static_cast<const float*>(a.k) + kv_off;
  const float* vg = static_cast<const float*>(a.v) + kv_off;
  char* q_s = smem + warp * kSlice * rs;  // this warp's 16 rows
  char* ring = smem + W * kSlice * rs;
  const int stage_bytes = 2 * KEYS * rs;
  const RowCopy rc = row_copy<float>(D, threadIdx.x, blockDim.x);
  const RowCopy rc_warp = row_copy<float>(D, lane, 32);
  // lane maps: ldmatrix A and N-major B rows and column bytes, f32_b's
  const int oa = a_row(lane) * rs + 2 * a_col(lane);
  const int ob = b_row(lane) * rs + 2 * b_col(lane);
  const int ov = 2 * tq * rs + 4 * g;

  auto issue = [&](int st) {
    char* kt = ring + st * stage_bytes;
    const int n_ok = ld.end() - ld.c0;
    load_rows(rc, kt, kg + (size_t)ld.c0 * D, KEYS, n_ok, rs);
    load_rows(rc, kt + KEYS * rs, vg + (size_t)ld.c0 * D, KEYS, n_ok, rs);
  };

  // Masked scores count in the row max as the mask value and give p = 0,
  // so a row whose max is still the mask value when its first kept key
  // arrives drops them exactly (alpha = 0).
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[KS][4];
#pragma unroll
  for (int i = 0; i < KS; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  }

  if (!ld.done()) {
    if (live) {
      load_rows(rc_warp, q_s,
                static_cast<const float*>(a.q) +
                    (((size_t)b * a.H + h) * a.Nq + r0) * D,
                kSlice, r_end - r0, rs);
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

      // S = Q.K^T over the sub-tile (16 rows x KEYS keys)
      float sc[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[n][c] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (ks >= ksteps) continue;
        uint32_t x[4], ab[4], as[4];
        ldsm_x4(x, smem_u32(q_s + oa + ks * 32));
        split_frag(x, ab, as);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bb[4], bs[4];
          ldsm_x4(x, smem_u32(kt + np * 16 * rs + ob + ks * 32));
          split_frag(x, bb, bs);
          mma3_1688(sc[2 * np], ab, as, bb[0], bb[1], bs[0], bs[1]);
          mma3_1688(sc[2 * np + 1], ab, as, bb[2], bb[3], bs[2], bs[3]);
        }
      }

      // the online softmax over the 4 lanes of a row
      const int c0 = cw.c0, c_end = cw.end();
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
        for (int dn = 0; dn < KS; ++dn) {
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
      // O += P.V: k step kk is keys 8 kk .. 8 kk + 7, V by f32_b
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        uint32_t pb[4], ps[4];
        acc_split(sc[kk], pb, ps);
#pragma unroll
        for (int dn = 0; dn < KS; ++dn) {
          if (dn >= ksteps) continue;
          uint32_t vb[2], vs[2];
          f32_b(vt, kk * 8 * rs + ov + dn * 32, rs, vb, vs);
          mma3_1688(acc[dn], pb, ps, vb[0], vb[1], vs[0], vs[1]);
        }
      }
    }
  }
  if (!live) return;

  // A visited block's row that met no key (or whose sub-tiles were all
  // past the stop) holds the mask value; rows of a block with count 0
  // keep -inf.
  const size_t bh = (size_t)b * a.H + h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    if (n_active > 0) m[r] = fmaxf(m[r], kMaskValue);
    const int row = r0 + g + 8 * r;
    if (row >= r_end) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    const size_t base = bh * a.Nq + row;
#pragma unroll
    for (int dn = 0; dn < KS; ++dn) {
      const int col = 8 * dn + 2 * tq;
      if (col < D) {
        *reinterpret_cast<float2*>(o + base * D + col) =
            make_float2(acc[dn][2 * r] / l_safe, acc[dn][2 * r + 1] / l_safe);
      }
    }
    if (tq == 0) lse[base] = m[r] + logf(l_safe);
  }
}

template <int DP, int KEYS>
cudaError_t launch_sparse_fwd_f32_mma(const AttnArgs& a,
                                      const int32_t* kv_list,
                                      const int32_t* kv_count, int stride,
                                      int block_q, int block_k, void* o,
                                      float* lse, cudaStream_t st) {
  const int units = (block_q + kSlice - 1) / kSlice * (a.H / a.H_kv);
  const int warps = cta_warps(units);
  const size_t smem = FwdMmaCfg<DP, KEYS>::smem(warps, f32_row_bytes(a.D));
  auto kernel = sparse_fwd_f32_mma_kernel<DP, KEYS>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long ctas = (long long)((a.Nq + block_q - 1) / block_q) *
                         ((units + warps - 1) / warps);
  if (ctas > 0x7fffffff) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)ctas, a.H_kv, a.B);
  kernel<<<grid, 32 * warps, smem, st>>>(a, kv_list, kv_count, stride,
                                         block_q, block_k,
                                         static_cast<float*>(o), lse);
  return cudaGetLastError();
}

// Sub-tiles of 16 keys for blocks of 16 keys or fewer, else 32.
template <int DP>
cudaError_t sparse_fwd_f32_mma(const AttnArgs& a, const int32_t* kv_list,
                               const int32_t* kv_count, int stride,
                               int block_q, int block_k, void* o, float* lse,
                               cudaStream_t st) {
  return block_k <= 16
             ? launch_sparse_fwd_f32_mma<DP, 16>(a, kv_list, kv_count, stride,
                                                 block_q, block_k, o, lse, st)
             : launch_sparse_fwd_f32_mma<DP, 32>(a, kv_list, kv_count, stride,
                                                 block_q, block_k, o, lse, st);
}

}  // namespace mma
}  // namespace fat

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

// The mma route: bf16 only, D <= 256, any block_q and block_k (the caller
// sends blocks that are not both multiples of 64); q, k and v 16-byte
// aligned (cp.async). Same arguments as fat_sparse_fwd (dtype must be 0).
int fat_sparse_fwd_mma(const void* q, const void* k, const void* v, void* o,
                       void* lse, const void* kv_list, const void* kv_count,
                       int B, int H, int H_kv, int Nq, int Nk, int D,
                       float scale, int causal, int block_q, int block_k,
                       int stride, int dtype, void* stream) {
  using namespace fat;
  if (dtype != 0 || D < 8 || D > 256 || D % 8 != 0 || H_kv < 1 ||
      H % H_kv != 0 || B < 1 || Nq < 1 || Nk < 1 || H_kv > 65535 ||
      B > 65535 || block_q < 1 || block_k < 1 ||
      stride < (Nk + block_k - 1) / block_k ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  AttnArgs a{q, k, v, nullptr, nullptr, nullptr, B, H, H_kv, Nq, Nk, D, scale,
             causal, Nk - Nq, 0, 0, 0.f, 0.f, 0, 0u, 0u, 1.f};
  auto st = static_cast<cudaStream_t>(stream);
  const auto* list = static_cast<const int32_t*>(kv_list);
  const auto* count = static_cast<const int32_t*>(kv_count);
  auto* l = static_cast<float*>(lse);
  auto* run = D <= 64    ? mma::sparse_fwd_mma<64>
              : D <= 128 ? mma::sparse_fwd_mma<128>
                         : mma::sparse_fwd_mma<256>;
  return (int)run(a, list, count, stride, block_q, block_k, o, l, st);
}

// The fp32 mma route (3xTF32): fp32 only, D <= 256, any block_q and
// block_k (the caller sends blocks that are not both multiples of 64); q, k
// and v 16-byte aligned (cp.async). Same arguments as fat_sparse_fwd (dtype
// must be 1).
int fat_sparse_fwd_mma_f32(const void* q, const void* k, const void* v,
                           void* o, void* lse, const void* kv_list,
                           const void* kv_count, int B, int H, int H_kv,
                           int Nq, int Nk, int D, float scale, int causal,
                           int block_q, int block_k, int stride, int dtype,
                           void* stream) {
  using namespace fat;
  if (dtype != 1 || D < 8 || D > 256 || D % 8 != 0 || H_kv < 1 ||
      H % H_kv != 0 || B < 1 || Nq < 1 || Nk < 1 || H_kv > 65535 ||
      B > 65535 || block_q < 1 || block_k < 1 ||
      stride < (Nk + block_k - 1) / block_k ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  AttnArgs a{q, k, v, nullptr, nullptr, nullptr, B, H, H_kv, Nq, Nk, D, scale,
             causal, Nk - Nq, 0, 0, 0.f, 0.f, 0, 0u, 0u, 1.f};
  auto st = static_cast<cudaStream_t>(stream);
  const auto* list = static_cast<const int32_t*>(kv_list);
  const auto* count = static_cast<const int32_t*>(kv_count);
  auto* l = static_cast<float*>(lse);
  auto* run = D <= 64    ? mma::sparse_fwd_f32_mma<64>
              : D <= 128 ? mma::sparse_fwd_f32_mma<128>
                         : mma::sparse_fwd_f32_mma<256>;
  return (int)run(a, list, count, stride, block_q, block_k, o, l, st);
}

// The tensor-core route: bf16 only, D <= 256, block_q and block_k multiples
// of 64; q, k and v 16-byte aligned (TMA). Same arguments as fat_sparse_fwd
// (dtype must be 0).
int fat_sparse_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                        void* lse, const void* kv_list, const void* kv_count,
                        int B, int H, int H_kv, int Nq, int Nk, int D,
                        float scale, int causal, int block_q, int block_k,
                        int stride, int dtype, void* stream) {
  using namespace fat;
  if (dtype != 0 || D < 8 || D > 256 || D % 8 != 0 || H_kv < 1 ||
      H % H_kv != 0 || B < 1 || Nq < 1 || Nk < 1 || H > 65535 || B > 65535 ||
      block_q < 64 || block_k < 64 || block_q % 64 != 0 ||
      block_k % 64 != 0 || stride < (Nk + block_k - 1) / block_k ||
      (Nq + 63) / 64 > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  AttnArgs a{q, k, v, nullptr, nullptr, nullptr, B, H, H_kv, Nq, Nk, D, scale,
             causal, Nk - Nq, 0, 0, 0.f, 0.f, 0, 0u, 0u, 1.f};
  auto st = static_cast<cudaStream_t>(stream);
  const auto* list = static_cast<const int32_t*>(kv_list);
  const auto* count = static_cast<const int32_t*>(kv_count);
  auto* l = static_cast<float*>(lse);
  const cudaError_t err =
      D <= 64    ? sm90::sparse_fwd_sm90<64>(a, list, count, stride, block_q,
                                             block_k, o, l, st)
      : D <= 128 ? sm90::sparse_fwd_sm90<128>(a, list, count, stride,
                                              block_q, block_k, o, l, st)
                 : sm90::sparse_fwd_sm90<256>(a, list, count, stride,
                                              block_q, block_k, o, l, st);
  return (int)err;
}

// The fp32 tensor-core route (3xTF32): fp32 only, D <= 256, block_q and
// block_k multiples of 64; q, k and v 16-byte aligned (TMA). Same arguments
// as fat_sparse_fwd (dtype must be 1).
int fat_sparse_fwd_sm90_f32(const void* q, const void* k, const void* v,
                            void* o, void* lse, const void* kv_list,
                            const void* kv_count, int B, int H, int H_kv,
                            int Nq, int Nk, int D, float scale, int causal,
                            int block_q, int block_k, int stride, int dtype,
                            void* stream) {
  using namespace fat;
  if (dtype != 1 || D < 8 || D > 256 || D % 8 != 0 || H_kv < 1 ||
      H % H_kv != 0 || B < 1 || Nq < 1 || Nk < 1 || H > 65535 || B > 65535 ||
      block_q < 64 || block_k < 64 || block_q % 64 != 0 ||
      block_k % 64 != 0 || stride < (Nk + block_k - 1) / block_k ||
      (Nq + 63) / 64 > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  AttnArgs a{q, k, v, nullptr, nullptr, nullptr, B, H, H_kv, Nq, Nk, D, scale,
             causal, Nk - Nq, 0, 0, 0.f, 0.f, 0, 0u, 0u, 1.f};
  auto st = static_cast<cudaStream_t>(stream);
  const auto* list = static_cast<const int32_t*>(kv_list);
  const auto* count = static_cast<const int32_t*>(kv_count);
  auto* l = static_cast<float*>(lse);
  // A CTA never spans two q blocks: two consumers only where a block holds
  // 128 rows, and at D <= 64 (shared memory). Any D in (128, 256] runs the
  // wide kernel's 256 instance (TMA reads zeros past D).
  const cudaError_t err =
      D > 128  ? sm90::launch_sparse_fwd_f32_wide_sm90<256>(
                    a, list, count, stride, block_q, block_k, o, l, st)
      : D > 64 ? sm90::launch_sparse_fwd_f32_sm90<128, 1>(
                     a, list, count, stride, block_q, block_k, o, l, st)
      : block_q % 128 == 0
          ? sm90::launch_sparse_fwd_f32_sm90<64, 2>(a, list, count, stride,
                                                    block_q, block_k, o, l, st)
          : sm90::launch_sparse_fwd_f32_sm90<64, 1>(
                a, list, count, stride, block_q, block_k, o, l, st);
  return (int)err;
}

}  // extern "C"
