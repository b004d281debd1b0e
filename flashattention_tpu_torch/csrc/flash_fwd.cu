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
// (4·B·H·Nq·Nk·D flops, half of that causal, over 989 TFLOP/s in bf16;
// over 165 in fp32, three TF32 products at 495 per fp32 product).
//
// Three entry points; the caller (ops/flash_attn.py) takes the first two:
//
//   fat_flash_fwd_sm90 (bf16, D <= 256): both products on the tensor cores.
//     One CTA per (128 query rows, head, batch), three warpgroups. Warpgroup
//     0 loads: one thread issues TMA for the Q tile once and for K and V
//     tiles (128 keys at D <= 64, 64 above, for the consumers' registers)
//     into a two-stage ring guarded by mbarriers ("full" per K and per V,
//     "empty" per stage), walking the tiles the rows can see (key_tiles:
//     sink tiles, then the band). Warpgroups 1-2 own 64 rows each: S = Q·Kᵀ
//     by wgmma from shared memory (both K-major), then the score pipeline
//     and the online softmax on the fp32 accumulator fragment at absolute
//     (row, col), then p, dropped and rounded to bf16, as the register A
//     operand of O += P·V (V MN-major). Head dims below the instantiation's
//     64, 128 or 256 read zeros from TMA. At D = 256 (the instantiation for
//     128 < D <= 256) O holds 128 registers a thread beside the 64-key score
//     fragment's 32, P·V is two n128 products over V's column halves, and
//     shared memory holds Q (64 KB) and two stages of K and V (128 KB).
//   fat_flash_fwd_sm90_f32 (fp32, D <= 256): the same schedule with both
//     products in 3xTF32 (tf32_sm90.cuh): each fp32 operand split into two
//     TF32 parts, three wgmmas a product, which keeps the fp32 1e-4 limit
//     where one TF32 product would miss it. TF32 wgmma reads shared memory
//     K-major only, so warps 1-3 of the loading warpgroup split each
//     landed K tile and write Vᵀ in two parts for P·V; p is split in
//     registers. Up to D = 128, Q (128 rows at D <= 64, 64 at D <= 128)
//     stays resident in two parts; K/V tiles of 64 or 32 keys in two stages
//     (~225 KB). Above (the wide kernel, D = 256), two parts of a 64-row Q
//     tile alone would take 128 KB, so Q stays as landed (64 KB) and each
//     k8 step of it is split in registers as S's A operand; one stage of
//     32 keys, K and V on barriers of their own (224 KB).
//   fat_flash_fwd (fp32 FMAs on the CUDA cores, body flash_fwd.cuh, shared
//     with B4): the first version. The wrapper no longer takes it (every
//     call goes to a tensor-core entry; above D = 256 to flash_wide.cu's);
//     it stays as the comparison that chip_smoke.py times on the
//     tensor-core cases' inputs.

#include "flash_fwd.cuh"
#include "flash_sm90.cuh"
#include "tf32_sm90.cuh"

namespace fat {
namespace sm90 {

constexpr int kFwdRows = 128;  // query rows per CTA, 64 per consumer

template <int DP>
struct FwdSm90Cfg {
  // Keys per K/V tile. At D = 128 the O accumulator (64 registers) and a
  // 64 x 128 score fragment (64 more) with the score pipeline's values
  // overflow a consumer's 240 registers: 64 keys there, and at D = 256
  // (O 128 registers).
  static constexpr int KEYS = DP <= 64 ? 128 : 64;
  static constexpr int STAGES = 2;
  static constexpr int Q_BYTES = kFwdRows * DP * 2;
  static constexpr int KV_BYTES = KEYS * DP * 2;  // one K or V tile
  static constexpr int BARS = 1 + 3 * STAGES;
  static constexpr size_t SMEM =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARS;
};

template <int DP>
__global__ void __launch_bounds__(kThreadsWS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, AttnArgs a,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse) {
  using Cfg = FwdSm90Cfg<DP>;
  constexpr int STAGES = Cfg::STAGES, KEYS = Cfg::KEYS;
  extern __shared__ char smem_raw[];
  char* q_s = align_1024(smem_raw);              // [DP/64][128][64]
  char* k_s = q_s + Cfg::Q_BYTES;                // [STAGES] tiles
  char* v_s = k_s + STAGES * Cfg::KV_BYTES;      // [STAGES] tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + STAGES * Cfg::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * kFwdRows;
  const int hk = h / (a.H / a.H_kv);
  const TileWalk walk =
      key_tiles(a, r0, min(r0 + kFwdRows, a.Nq) - 1, KEYS);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 256);  // every consumer thread releases a stage
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0 && walk.n_walk > 0) {
      const int kplane = b * a.H_kv + hk;
      mbar_expect_tx(q_full, Cfg::Q_BYTES);
      tma_tile<kFwdRows, DP>(q_s, &tq, q_full, r0, b * a.H + h);
      for (int w = 0; w < walk.n_walk; ++w) {
        const int s = w % STAGES;
        mbar_wait(&empty[s], ((w / STAGES) & 1) ^ 1);
        const int c0 = walk.tile(w) * KEYS;
        mbar_expect_tx(&k_full[s], Cfg::KV_BYTES);
        tma_tile<KEYS, DP>(k_s + s * Cfg::KV_BYTES, &tk, &k_full[s], c0,
                               kplane);
        mbar_expect_tx(&v_full[s], Cfg::KV_BYTES);
        tma_tile<KEYS, DP>(v_s + s * Cfg::KV_BYTES, &tv, &v_full[s], c0,
                               kplane);
      }
    }
  } else {  // consumers
    reg_alloc<kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1;  // 64-row slice of the q tile
    const int t = threadIdx.x % 128;
    const int row0 = r0 + 64 * cw;
    const uint32_t bh = (uint32_t)(b * a.H + h);
    const bool post = a.slopes != nullptr || a.softcap > 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

    if (walk.n_walk > 0) mbar_wait(q_full, 0);
    for (int w = 0; w < walk.n_walk; ++w) {
      const int s = w % STAGES, ph = (w / STAGES) & 1;
      const int c0 = walk.tile(w) * KEYS;
      const char* kt = k_s + s * Cfg::KV_BYTES;
      const char* vt = v_s + s * Cfg::KV_BYTES;

      float sc[KEYS / 2];  // S: 64 rows x KEYS
      mbar_wait(&k_full[s], ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wgmma_ss<KEYS>(sc, desc_k<kFwdRows>(q_s, 64 * cw, kk),
                       desc_k<KEYS>(kt, 0, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // Score pipeline at absolute (row, col); masked scores count in the
      // row max as the mask value and give p = 0 (held as -inf).
      float mx[2] = {m[0], m[1]};
      const int cls =
          tile_class(a, row0, row0 + 63, c0, c0 + KEYS - 1);
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
          const bool vis =
              tile_visible<decltype(c)::value>(a, b, row, col, seg, i);
          float dcap;
          const float x = tile_score<decltype(pp)::value>(
              a, h, row, col, sc[i] * a.scale, &dcap);
          mx[r] = fmaxf(mx[r], vis ? x : kMaskValue);
          sc[i] = vis ? x : -INFINITY;
        }
      });
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
        const int r = (i >> 1) & 1;
        float p = expf(sc[i] - m[r]);
        l[r] += p;
        if (a.dropout) {
          const int row = row0 + acc_row(t, i), col = c0 + acc_col(t, i);
          p = keep(a, bh, row, col) ? p * a.drop_inv : 0.f;
        }
        sc[i] = p;
      }
      uint32_t pa[KEYS / 16][4];
      acc_to_a<KEYS>(sc, pa);

      mbar_wait(&v_full[s], ph);
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

    // Epilogue: each row's l is spread over the 4 threads of a quad.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(kFull, l[r], 1);
      l[r] += __shfl_xor_sync(kFull, l[r], 2);
      const int row = row0 + acc_row(t, 2 * r);
      if (row >= a.Nq) continue;
      const float l_safe = l[r] == 0.f ? 1.f : l[r];
      const size_t base = (size_t)bh * a.Nq + row;
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

template <int DP>
cudaError_t launch_fwd_sm90(const AttnArgs& a, void* o, float* lse,
                            cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, a.q, a.B * a.H, a.Nq, a.D);
  if (err == cudaSuccess) err = make_map(&tk, a.k, a.B * a.H_kv, a.Nk, a.D);
  if (err == cudaSuccess) err = make_map(&tv, a.v, a.B * a.H_kv, a.Nk, a.D);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_sm90_kernel<DP>;
  err = set_smem(kernel, FwdSm90Cfg<DP>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Nq + kFwdRows - 1) / kFwdRows, a.H, a.B);
  kernel<<<grid, kThreadsWS, FwdSm90Cfg<DP>::SMEM, st>>>(
      tq, tk, tv, a, static_cast<__nv_bfloat16*>(o), lse);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The fp32 tensor-core route (3xTF32, D <= 128)
// ---------------------------------------------------------------------------

// NC consumer warpgroups of 64 query rows; K/V tiles of KEYS keys in STAGES
// stages. Shared memory: Q in two parts (big, small) and per stage K big
// (where TMA lands it, split in place), K small, V as landed (row-major),
// and Vᵀ big and small, which P·V reads K-major: 64 + 2 x 80 KB at D = 64
// (128 rows, 64 keys) and at D = 128 (64 rows, 32 keys).
template <int DP>
struct FwdF32Cfg {
  static constexpr int NC = DP <= 64 ? 2 : 1;
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

// Warpgroup 0: thread 0 issues TMA (Q once, K and V per tile of the walk);
// warps 1-3 split Q and each landed K tile in place (big) and into small,
// and transpose and split each V tile into Vᵀ (transpose_split), then
// release the stage to the consumers. Consumers: S = Q·Kᵀ in 3xTF32 from
// shared memory, the score pipeline and online softmax of the bf16 kernel
// on the fp32 fragment, p (after dropout) split in registers as the A
// operands of O += P·V against Vᵀ.
template <int DP>
__global__ void __launch_bounds__(FwdF32Cfg<DP>::THREADS, 1)
flash_fwd_f32_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, AttnArgs a,
                          float* __restrict__ o, float* __restrict__ lse) {
  using Cfg = FwdF32Cfg<DP>;
  constexpr int NC = Cfg::NC, ROWS = Cfg::ROWS, KEYS = Cfg::KEYS;
  constexpr int STAGES = Cfg::STAGES, TB = Cfg::T_BYTES;
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
      mbar_expect_tx(q_landed, Cfg::Q_BYTES);
      tma_tile32<ROWS, DP>(qb, &tq, q_landed, r0, b * a.H + h);
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
      split_tile(qb, qb, qs, Cfg::Q_BYTES, 1.f, tid, kPrepThreads);
      fence_proxy_async();
      mbar_arrive(q_ready);
      for (int w = 0; w < walk.n_walk; ++w) {
        const int s = w % STAGES;
        char* st = stage0 + s * Cfg::STAGE_BYTES;
        mbar_wait(&landed[s], (w / STAGES) & 1);
        split_tile(st, st, st + TB, TB, 1.f, tid, kPrepThreads);
        transpose_split<KEYS, DP>(st + 2 * TB, st + 3 * TB, st + 4 * TB, 1.f,
                                  tid, kPrepThreads);
        fence_proxy_async();
        mbar_arrive(&ready[s]);
      }
    }
  } else {  // consumers
    if constexpr (NC == 2) reg_alloc<kConsumerRegs32>();
    const int cw = threadIdx.x / 128 - 1;  // 64-row slice of the q tile
    const int t = threadIdx.x % 128;
    const int row0 = r0 + 64 * cw;
    const uint32_t bh = (uint32_t)(b * a.H + h);
    const bool post = a.slopes != nullptr || a.softcap > 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

    if (walk.n_walk > 0) mbar_wait(q_ready, 0);
    for (int w = 0; w < walk.n_walk; ++w) {
      const int s = w % STAGES;
      const int c0 = walk.tile(w) * KEYS;
      const char* st = stage0 + s * Cfg::STAGE_BYTES;

      float sc[KEYS / 2];  // S: 64 rows x KEYS
      mbar_wait(&ready[s], (w / STAGES) & 1);
      wgmma_fence();
      mma3_ss<ROWS, KEYS, DP / 8>(sc, qb, qs, 64 * cw, st, st + TB);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // Score pipeline at absolute (row, col); masked scores count in the
      // row max as the mask value and give p = 0 (held as -inf).
      float mx[2] = {m[0], m[1]};
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
          const bool vis =
              tile_visible<decltype(c)::value>(a, b, row, col, seg, i);
          float dcap;
          const float x = tile_score<decltype(pp)::value>(
              a, h, row, col, sc[i] * a.scale, &dcap);
          mx[r] = fmaxf(mx[r], vis ? x : kMaskValue);
          sc[i] = vis ? x : -INFINITY;
        }
      });
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
        const int r = (i >> 1) & 1;
        float p = expf(sc[i] - m[r]);
        l[r] += p;
        if (a.dropout) {
          const int row = row0 + acc_row(t, i), col = c0 + acc_col(t, i);
          p = keep(a, bh, row, col) ? p * a.drop_inv : 0.f;
        }
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

    // Epilogue: each row's l is spread over the 4 threads of a quad.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(kFull, l[r], 1);
      l[r] += __shfl_xor_sync(kFull, l[r], 2);
      const int row = row0 + acc_row(t, 2 * r);
      if (row >= a.Nq) continue;
      const float l_safe = l[r] == 0.f ? 1.f : l[r];
      const size_t base = (size_t)bh * a.Nq + row;
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
cudaError_t launch_fwd_f32_sm90(const AttnArgs& a, void* o, float* lse,
                                cudaStream_t st) {
  using Cfg = FwdF32Cfg<DP>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map32(&tq, a.q, a.B * a.H, a.Nq, a.D,
                               box_rows<Cfg::ROWS>());
  if (err == cudaSuccess) {
    err = make_map32(&tk, a.k, a.B * a.H_kv, a.Nk, a.D,
                     box_rows<Cfg::KEYS>());
  }
  if (err == cudaSuccess) {
    err = make_map32(&tv, a.v, a.B * a.H_kv, a.Nk, a.D,
                     box_rows<Cfg::KEYS>());
  }
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_f32_sm90_kernel<DP>;
  err = set_smem(kernel, Cfg::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Nq + Cfg::ROWS - 1) / Cfg::ROWS, a.H, a.B);
  kernel<<<grid, Cfg::THREADS, Cfg::SMEM, st>>>(tq, tk, tv, a,
                                                static_cast<float*>(o), lse);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The fp32 tensor-core route at 128 < D <= 256 (3xTF32, Q split in
// registers)
// ---------------------------------------------------------------------------

// Shapes: FwdWideCfg (tf32_sm90.cuh). Warpgroup 0: thread 0 issues TMA (Q
// once; per tile of the walk K, once the consumers are done with the last
// one, and V, once warps 1-3 have transposed the last one); warps 1-3 split
// each landed K tile in place and into small, and transpose and split each
// landed V tile into Vᵀ once P·V is done with the last. Consumers: S = Q·Kᵀ
// in 3xTF32 with Q split in registers (mma3_ra), the score pipeline and
// online softmax of the bf16 kernel, p split in registers as the A operands
// of O += P·V against Vᵀ (two n128 products a k8 step: O is 128 registers a
// thread).
template <int DP>
__global__ void __launch_bounds__(FwdWideCfg<DP>::THREADS, 1)
flash_fwd_f32_wide_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               AttnArgs a, float* __restrict__ o,
                               float* __restrict__ lse) {
  using Cfg = FwdWideCfg<DP>;
  constexpr int ROWS = Cfg::ROWS, KEYS = Cfg::KEYS, TB = Cfg::T_BYTES;
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

  // Row tiles last to first: in a causal call the tiles that walk the
  // most keys start first and the short ones fill the last wave.
  const int b = blockIdx.z, h = blockIdx.y;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * ROWS;
  const int hk = h / (a.H / a.H_kv);
  const TileWalk walk = key_tiles(a, r0, min(r0 + ROWS, a.Nq) - 1, KEYS);

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
    if (threadIdx.x == 0 && walk.n_walk > 0) {
      const int kplane = b * a.H_kv + hk;
      mbar_expect_tx(q_landed, Cfg::Q_BYTES);
      tma_tile32<ROWS, DP>(qx, &tq, q_landed, r0, b * a.H + h);
      for (int w = 0; w < walk.n_walk; ++w) {
        const int c0 = walk.tile(w) * KEYS;
        mbar_wait(k_empty, (w & 1) ^ 1);
        mbar_expect_tx(k_landed, TB);
        tma_tile32<KEYS, DP>(kb, &tk, k_landed, c0, kplane);
        if (w > 0) mbar_wait(v_ready, (w - 1) & 1);  // V landed is free
        mbar_expect_tx(v_landed, TB);
        tma_tile32<KEYS, DP>(vx, &tv, v_landed, c0, kplane);
      }
    } else if (threadIdx.x >= 32 && walk.n_walk > 0) {
      const int tid = threadIdx.x - 32;
      for (int w = 0; w < walk.n_walk; ++w) {
        const int ph = w & 1;
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
  } else {  // the consumer: 64 query rows
    const int t = threadIdx.x - 128;
    const uint32_t bh = (uint32_t)(b * a.H + h);
    const bool post = a.slopes != nullptr || a.softcap > 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

    if (walk.n_walk > 0) mbar_wait(q_landed, 0);
    for (int w = 0; w < walk.n_walk; ++w) {
      const int ph = w & 1;
      const int c0 = walk.tile(w) * KEYS;

      float sc[KEYS / 2];  // S: 64 rows x KEYS
#pragma unroll
      for (int i = 0; i < KEYS / 2; ++i) sc[i] = 0.f;
      mbar_wait(k_ready, ph);
      mma3_ra<ROWS, KEYS, DP / 8, Cfg::GS, Cfg::NB>(sc, qx, 1.f, kb, ks, t);
      mbar_arrive(k_empty);

      // Score pipeline at absolute (row, col); masked scores count in the
      // row max as the mask value and give p = 0 (held as -inf).
      float mx[2] = {m[0], m[1]};
      const int cls = tile_class(a, r0, r0 + 63, c0, c0 + KEYS - 1);
      uint32_t seg[2] = {0u, 0u};
      if (cls == kSegments) {
        segment_bits<KEYS>(a.q_ids + (size_t)b * a.Nq, r0, a.Nq,
                           a.kv_ids + (size_t)b * a.Nk, c0, a.Nk, t, seg);
      }
      dispatch_tile(cls, post, [&](auto c, auto pp) {
#pragma unroll
        for (int i = 0; i < KEYS / 2; ++i) {
          const int r = (i >> 1) & 1;
          const int row = r0 + acc_row(t, i), col = c0 + acc_col(t, i);
          const bool vis =
              tile_visible<decltype(c)::value>(a, b, row, col, seg, i);
          float dcap;
          const float x = tile_score<decltype(pp)::value>(
              a, h, row, col, sc[i] * a.scale, &dcap);
          mx[r] = fmaxf(mx[r], vis ? x : kMaskValue);
          sc[i] = vis ? x : -INFINITY;
        }
      });
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
        const int r = (i >> 1) & 1;
        float p = expf(sc[i] - m[r]);
        l[r] += p;
        if (a.dropout) {
          const int row = r0 + acc_row(t, i), col = c0 + acc_col(t, i);
          p = keep(a, bh, row, col) ? p * a.drop_inv : 0.f;
        }
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

    // Epilogue: each row's l is spread over the 4 threads of a quad.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(kFull, l[r], 1);
      l[r] += __shfl_xor_sync(kFull, l[r], 2);
      const int row = r0 + acc_row(t, 2 * r);
      if (row >= a.Nq) continue;
      const float l_safe = l[r] == 0.f ? 1.f : l[r];
      const size_t base = (size_t)bh * a.Nq + row;
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
cudaError_t launch_fwd_f32_wide_sm90(const AttnArgs& a, void* o, float* lse,
                                     cudaStream_t st) {
  using Cfg = FwdWideCfg<DP>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map32(&tq, a.q, a.B * a.H, a.Nq, a.D,
                               box_rows<Cfg::ROWS>());
  if (err == cudaSuccess) {
    err = make_map32(&tk, a.k, a.B * a.H_kv, a.Nk, a.D,
                     box_rows<Cfg::KEYS>());
  }
  if (err == cudaSuccess) {
    err = make_map32(&tv, a.v, a.B * a.H_kv, a.Nk, a.D,
                     box_rows<Cfg::KEYS>());
  }
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_f32_wide_sm90_kernel<DP>;
  err = set_smem(kernel, Cfg::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Nq + Cfg::ROWS - 1) / Cfg::ROWS, a.H, a.B);
  kernel<<<grid, Cfg::THREADS, Cfg::SMEM, st>>>(tq, tk, tv, a,
                                                static_cast<float*>(o), lse);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace fat

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
  using namespace fat;
  if (D < 8 || D > 256 || D % 8 != 0 || H_kv < 1 || H % H_kv != 0 || B < 1 ||
      Nq < 1 || Nk < 1 || H > 65535 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  AttnArgs a{q, k, v, static_cast<const int32_t*>(q_ids),
             static_cast<const int32_t*>(kv_ids),
             static_cast<const float*>(slopes), B, H, H_kv, Nq, Nk, D, scale,
             causal, offset, window, sinks, softcap, softcap_inv, dropout,
             drop_threshold, seed, drop_inv};
  const Scales none{};
  auto st = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  cudaError_t err;
  if (dtype == 0) {
    err = fwd_by_dim<__nv_bfloat16, PlainIn<__nv_bfloat16>>(a, none, o, l, st);
  } else if (dtype == 1) {
    err = fwd_by_dim<float, PlainIn<float>>(a, none, o, l, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

// The tensor-core route: bf16 only, D <= 256; q, k and v 16-byte aligned
// (TMA). Same arguments as fat_flash_fwd (dtype must be 0).
int fat_flash_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                       void* lse, const void* q_ids, const void* kv_ids,
                       const void* slopes, int B, int H, int H_kv, int Nq,
                       int Nk, int D, float scale, int causal, int offset,
                       int window, int sinks, float softcap, float softcap_inv,
                       int dropout, uint32_t drop_threshold, uint32_t seed,
                       float drop_inv, int dtype, void* stream) {
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
  auto* l = static_cast<float*>(lse);
  const cudaError_t err = D <= 64    ? sm90::launch_fwd_sm90<64>(a, o, l, st)
                          : D <= 128 ? sm90::launch_fwd_sm90<128>(a, o, l, st)
                                     : sm90::launch_fwd_sm90<256>(a, o, l, st);
  return (int)err;
}

// The fp32 tensor-core route (3xTF32): fp32 only, D <= 256; q, k and v
// 16-byte aligned (TMA). Same arguments as fat_flash_fwd (dtype must be 1).
int fat_flash_fwd_sm90_f32(const void* q, const void* k, const void* v,
                           void* o, void* lse, const void* q_ids,
                           const void* kv_ids, const void* slopes, int B,
                           int H, int H_kv, int Nq, int Nk, int D, float scale,
                           int causal, int offset, int window, int sinks,
                           float softcap, float softcap_inv, int dropout,
                           uint32_t drop_threshold, uint32_t seed,
                           float drop_inv, int dtype, void* stream) {
  using namespace fat;
  if (dtype != 1 || D < 8 || D > 256 || D % 8 != 0 || H_kv < 1 ||
      H % H_kv != 0 || B < 1 || Nq < 1 || Nk < 1 || H > 65535 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  AttnArgs a{q, k, v, static_cast<const int32_t*>(q_ids),
             static_cast<const int32_t*>(kv_ids),
             static_cast<const float*>(slopes), B, H, H_kv, Nq, Nk, D, scale,
             causal, offset, window, sinks, softcap, softcap_inv, dropout,
             drop_threshold, seed, drop_inv};
  auto st = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  const cudaError_t err =
      D <= 64    ? sm90::launch_fwd_f32_sm90<64>(a, o, l, st)
      : D <= 128 ? sm90::launch_fwd_f32_sm90<128>(a, o, l, st)
                 : sm90::launch_fwd_f32_wide_sm90<256>(a, o, l, st);
  return (int)err;
}

}  // extern "C"
