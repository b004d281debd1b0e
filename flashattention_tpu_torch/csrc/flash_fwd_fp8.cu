// FA3 8-bit attention forward on Hopper (sm_90a): o and the fp32 LSE from
// e4m3, e5m2 or int8 payloads with per-block fp32 scales.
//
// Replaces: flashattention_tpu/ops/pallas_fp8.py, _fp8_fwd_kernel (launched
// by _fp8_fwd). Same contract as flash_fwd.cu (causal with the offset
// Nk - Nq, window + sinks, GQA, segment ids, soft-cap, in-kernel ALiBi,
// murmur3 dropout after the LSE), on quantized inputs:
//
//   q8 (B, H, Nq, D), k8/v8 (B, H_kv, Nk, D) one-byte payloads;
//   sq (B, H, ceil(Nq / bq)), sk/sv (B, H_kv, ceil(Nk / bk)) fp32 scales,
//   one per sequence block of bq (q) or bk (k, v) positions.
//
// Scales are indexed by absolute row and column (row / bq, col / bk), so the
// kernel's own 32-key tiles are free of the quantization blocks, and ragged
// N is handled by bounds checks.
//
// Numerics, in the TPU kernel's order: payloads decode exactly (cuda_fp8.h
// conversions; int8 -> float). The score is the fp32 dot of the decoded q
// and k (for int8 an exact integer dot: |sum| <= 127^2 * 256 < 2^24), times
// (sq[row / bq] * sk[col / bk]) * scale, then ALiBi, the soft-cap and the
// mask. The online softmax keeps m and l in fp32; the LSE comes from these
// quantized scores. p (after dropout) is rounded to bf16 and each key's
// contribution to P.V is multiplied by sv[col / bk]. With pv_s8 (int8
// payloads, int8_pv="s8") p is re-quantized per row and key block instead:
// ps = max(max p, 1e-30) * (1/127), p8 = rint(p / ps), contribution
// p8 * ps * sv * v8.
//
// What bounds it on this card: the tensor-core rate. At the (1, 8, 8192, 128)
// causal shape the work is 4 * B * H * N^2 * D / 2 flops (about 0.137 TFLOP):
// Q.K, half of it, on 8-bit operands and P.V on bf16 p (both 8-bit with
// pv_s8), against 24 MB of payloads.
//
// Two routes, chosen by the caller (ops/fp8_attn._tensor_core_route):
//
//   fat_flash_fwd_fp8_sm90 (D <= 256 with D % 16 == 0, the caller padding
//     other head dims with zero bytes; key blocks bk a multiple of 128;
//     every format, both int8_pv settings, bf16 or fp32 output): the
//     structure of flash_fwd.cu's fat_flash_fwd_sm90. One CTA per (128
//     query rows, head, batch); warpgroup 0's thread 0 issues TMA loads of
//     the 1-byte Q tile once and of 1-byte K and V tiles (64 keys; 32 for
//     e4m3 and e5m2 at D = 256) into a two-stage ring; its warps 1-3 decode
//     tiles exactly to bf16 (e4m3 and e5m2 through f16, int8 directly) in
//     the layout flash_sm90.cuh's descriptors read and signal a second
//     mbarrier per stage. Warpgroups 1-2 own 64 rows each. S = Q·Kᵀ: for
//     int8 an s8 wgmma m64nNk32 straight from the 1-byte tiles, into s32,
//     which converts to float exactly (|sum| <= 127^2 * 256 < 2^24); for
//     e4m3 and e5m2 a bf16 wgmma on the decoded Q and K, exact products
//     with fp32 accumulation. (The e4m3 wgmma was tried first: its
//     accumulation keeps fewer bits than fp32, and the LSE missed the 1e-4
//     limit against fp8_fwd_plain; the bf16 decode is exact, so the scores
//     equal the plain version's but for summation order.) Scores are
//     float(S) * ((sq[row / bq] * sk[col / bk]) * scale), then B1's per-tile
//     score pipeline. Two passes over the walk, as the sparse forward's:
//     pass 0 brings K alone and takes each row's final max; pass 1 brings K
//     and V again, recomputes S with the same instructions, and rounds p =
//     exp(s - m) to bf16 at that max, as the plain version does (rounding
//     at the running max missed the two-ulp limit at near-zero outputs of a
//     ragged N_q != N_k case). p, dropped, is the register A operand of a
//     bf16 wgmma on the decoded V (p in 8 bits would be another function,
//     and 8-bit wgmma cannot read V, which is MN-major for P·V), up to D =
//     128 into a fresh fragment, folded in as acc += pv * sv[col / bk] (sv
//     is constant over a key tile, which divides bk). Maps, the s8 wgmma
//     and the decode are in fp8_sm90.cuh, so flash_sm90.cuh and B1-B3 do
//     not change.
//
//     At D = 256 (any 128 < D <= 256, zeros past D from TMA) registers and
//     shared memory bind; the choices below were measured with
//     scripts/fp8_tc_variants.py (PERF.md, row 6w). O alone is 128 of a
//     consumer's registers, and a fresh P·V fragment beside it spilled:
//     96-104 bytes as two n128 column halves each folded at once, 1368-1376
//     as four n64 chunks, the same at 24 / 240 registers as at 40 / 232. So
//     P·V accumulates straight into O, as B1's does, with O kept in units
//     of the tile's v scale su: where a tile's sv differs (a new key block:
//     sv is constant over bk, a multiple of 128 keys), O is first rescaled
//     by su / sv, and the epilogue multiplies by su. That rounds one ratio
//     into O at each key-block edge (a relative error near 2^-24 each,
//     against the plain version's acc + pv * sv), orders of magnitude
//     inside the bf16 flash limit. v scales must be positive (the
//     quantizers clamp them at 1e-6), and O's units stay finite while
//     N_k * max|v| / min sv < 3.4e38. A head dim below DP (D % 16 == 0, the
//     rows' stride a whole 16 bytes for TMA) reads zeros past D from TMA.
//     Shared memory: with 64-key tiles the
//     e4m3 and e5m2 kernels would need 289 KB (1-byte and bf16 Q, two
//     stages of 1-byte and bf16 K and V); they take 32-key tiles, 193 KB.
//     int8 (no bf16 Q or K) takes 64-key tiles, 161 KB, but S of a whole
//     tile beside O spilled 48 bytes (32 at 24 / 240), so its consumers
//     take S 32 keys at a time, and each half's P·V runs while the next
//     half's S is computed: at (1, 8, 8192, 256) 29% slower than the
//     spilling kernel, 6% faster than 32-key tiles. The 1-byte rows are
//     256 bytes there: two 128-byte column boxes, and the s8 product's
//     eight k32 steps run over two swizzle atoms as the bf16 product's k16
//     steps do over its 64-column halves.
//
//     int8_pv "s8" (the S8 kernels, int8 only) is the same two passes with
//     three changes. Pass 0 also takes each row's largest kept score in
//     each key block (visible and, with dropout, kept by the mask) and
//     stores it at a block edge in a (B, H, Nq, nkb) fp32 scratch the
//     wrapper allocates (4 B a row and block: 256 KB at (1, 8, 8192) with
//     bk = 1024, read back from L2; shared memory has no room for it at D =
//     256 beside the tiles, and nkb is unbounded). Pass 1 reads it where a
//     block starts and derives ps = max(exp(mk - m) * drop_inv, 1e-30) / 127
//     with the expression it uses for p, so the block's largest p quantizes
//     to exactly 127, as in the plain version; a block with no kept key
//     gets ps = 1e-30 / 127 and contributes 0. p8 = rint(p / ps) (the
//     quotient IEEE division gives, where the plain version divides: two
//     FMA corrections of p * (1 / ps), div_rn) is an integer in [0, 127],
//     exact in bf16, and stays the register A operand of the same bf16
//     wgmma on the decoded V: a 64-key tile's sums are at most 64 * 127^2
//     < 2^24, exact in fp32, so the tile's product is p8 . v8. (s8 wgmma
//     reads only K-major B, and V is MN-major for P.V.) Up to D = 128 the
//     tile folds in as acc += pv * (ps * sv). At D = 256 O is kept in
//     units of ps * sv per row (the unit in shared memory, unit_s),
//     rescaled by the old unit over the new where a block starts (a block
//     with no kept key keeps the unit: it adds 0).
//     Blocks whose ps lies below kPsFloor keep the unit kPsFloor * sv and
//     scale p8 by ps / kPsFloor (rounded to bf16: such a block's p are all
//     below 127 * kPsFloor = 1.1e-19 of the row's max), so a unit never
//     falls far enough below O for O's units to overflow.
//   fat_flash_fwd_fp8: the first version, flash_fwd.cu's FMA body
//     (flash_fwd.cuh) on payloads decoded into fp32 shared-memory tiles,
//     for key blocks that are not whole 128s (fp8_attention never
//     quantizes in such blocks; fp8_attention_prequant can be handed
//     them); chip_smoke holds it against the plain version and times it
//     beside the tensor-core route.

#include <cuda_fp8.h>

#include "flash_fwd.cuh"
#include "fp8_sm90.cuh"

namespace {

using namespace fat;

// One-byte payloads: 0 = e4m3, 1 = e5m2, 2 = int8; p is rounded to bf16.
template <int FMT>
struct QuantIn {
  using Elem = uint8_t;
  static constexpr bool kQuant = true;
  static __device__ __forceinline__ float load(uint8_t x) {
    if constexpr (FMT == 0) {
      __nv_fp8_e4m3 f;
      f.__x = x;
      return static_cast<float>(f);
    } else if constexpr (FMT == 1) {
      __nv_fp8_e5m2 f;
      f.__x = x;
      return static_cast<float>(f);
    } else {
      return (float)(int8_t)x;
    }
  }
  static __device__ __forceinline__ float round_p(float p) {
    return Num<__nv_bfloat16>::round(p);
  }
};

template <typename T>
cudaError_t by_fmt(int fmt, const AttnArgs& a, const Scales& f, void* o,
                   float* lse, cudaStream_t st) {
  if (fmt == 0) return fwd_by_dim<T, QuantIn<0>>(a, f, o, lse, st);
  if (fmt == 1) return fwd_by_dim<T, QuantIn<1>>(a, f, o, lse, st);
  if (fmt == 2) return fwd_by_dim<T, QuantIn<2>>(a, f, o, lse, st);
  return cudaErrorInvalidValue;
}

}  // namespace

namespace fat {
namespace sm90 {

// Producer warpgroup (TMA issue and the V decode) and consumer warpgroups:
// 40 + 2 x 232 registers of a 384-thread block fit the SM's 64K. s8 at D =
// 256 takes 24 + 2 x 240 (64,512, as 40 + 2 x 232): each row's p scale,
// its reciprocal and O's unit beside O's 128 registers spilled at 232,
// and at 240 until O's unit moved to shared memory.
constexpr int kFp8ProducerRegs = 40;
constexpr int kFp8ConsumerRegs = 232;
constexpr int kFp8Rows = 128;  // query rows per CTA, 64 per consumer
constexpr int kDecoders = 96;  // warps 1-3 of the producer warpgroup
// s8 at D = 256: the least p scale O's unit takes (the header)
constexpr float kPsFloor = 0x1p-70f;

template <int DP, int FMT>
struct Fp8Sm90Cfg {
  static constexpr bool kDecQK = FMT != 2;  // Q·Kᵀ on decoded bf16 tiles
  // Keys per tile: 64, where the O accumulator, the P·V fragment and the
  // score fragment fit the registers (with 128-key tiles at D = 64 the
  // two-pass kernels spilled 56-64 bytes: int8, e5m2). 32 for e4m3 and
  // e5m2 at D = 256, whose tiles (1-byte and bf16 Q, two stages of 1-byte
  // and bf16 K and V) fit one CTA's 227 KB only so: 193 KB, against 289 KB
  // with 64 keys (int8, with no bf16 Q or K: 161 KB).
  static constexpr int KEYS = DP > 128 && kDecQK ? 32 : 64;
  // Keys of S a consumer holds at once: the tile's, but 32 at D = 256,
  // where S of 64 keys beside O's 128 registers spilled (int8).
  static constexpr int SUB = DP > 128 ? 32 : KEYS;
  // P·V into a fresh fragment folded in as acc += pv * sv (D <= 128), or
  // straight into O, kept in units of the tile's v scale (D = 256: O alone
  // is 128 registers, and a fragment beside it spilled).
  static constexpr bool kFold = DP <= 128;
  static constexpr int STAGES = 2;
  static constexpr int ROW8 = halves8<DP>() * kRow8;  // bytes a 1-byte row
  static constexpr int Q_BYTES = kFp8Rows * ROW8;
  static constexpr int T_BYTES = KEYS * ROW8;     // one 1-byte K or V tile
  static constexpr int VB_BYTES = KEYS * DP * 2;  // a K or V tile in bf16
  static constexpr int QB_BYTES = kDecQK ? kFp8Rows * DP * 2 : 0;
  static constexpr int KB_BYTES = kDecQK ? VB_BYTES : 0;
  static constexpr int BARS = 2 + 5 * STAGES;
  // s8 at D = 256: O's unit of each consumer thread's two rows
  static constexpr int UNIT_BYTES = !kFold && FMT == 2 ? 256 * 2 * 4 : 0;
  static constexpr size_t SMEM = 1024 + Q_BYTES + QB_BYTES +
                                 STAGES * (2 * T_BYTES + VB_BYTES + KB_BYTES) +
                                 8 * BARS + UNIT_BYTES;
  static_assert(SMEM <= 232448, "above one CTA's shared memory");
};

// S8: int8_pv "s8" (FMT == 2 only), p re-quantized per row and key block.
template <int DP, int FMT, bool S8>
__global__ void __launch_bounds__(kThreadsWS, 1)
flash_fwd_fp8_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, AttnArgs a,
                          Scales f, void* __restrict__ o, int out_f32,
                          float* __restrict__ lse) {
  using Cfg = Fp8Sm90Cfg<DP, FMT>;
  constexpr int STAGES = Cfg::STAGES, KEYS = Cfg::KEYS, SUB = Cfg::SUB;
  constexpr bool kDecQK = Cfg::kDecQK;
  extern __shared__ char smem_raw[];
  char* q_s = align_1024(smem_raw);                 // 1-byte Q, 128 rows
  char* k_s = q_s + Cfg::Q_BYTES;                   // [STAGES] 1-byte tiles
  char* vr_s = k_s + STAGES * Cfg::T_BYTES;         // [STAGES] 1-byte tiles
  char* vb_s = vr_s + STAGES * Cfg::T_BYTES;        // [STAGES] bf16 tiles
  char* kb_s = vb_s + STAGES * Cfg::VB_BYTES;       // [STAGES] bf16 (e4m3,
  char* qb_s = kb_s + STAGES * Cfg::KB_BYTES;       //   e5m2) and Q in bf16
  uint64_t* q_full = reinterpret_cast<uint64_t*>(qb_s + Cfg::QB_BYTES);
  uint64_t* q_dec = q_full + 1;         // Q decoded to bf16 (e4m3, e5m2)
  uint64_t* k_full = q_dec + 1;
  uint64_t* k_dec = k_full + STAGES;    // K decoded to bf16 (e4m3, e5m2)
  uint64_t* v_full = k_dec + STAGES;    // the 1-byte V tile arrived
  uint64_t* v_dec = v_full + STAGES;    // ... and was decoded to bf16
  uint64_t* empty = v_dec + STAGES;
  float* unit_s = reinterpret_cast<float*>(empty + STAGES);  // UNIT_BYTES

  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * kFp8Rows;
  const int hk = h / (a.H / a.H_kv);
  const TileWalk walk =
      key_tiles(a, r0, min(r0 + kFp8Rows, a.Nq) - 1, KEYS);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_dec, kDecoders);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&k_dec[s], kDecoders);
      mbar_init(&v_full[s], 1);
      mbar_init(&v_dec[s], kDecoders);
      mbar_init(&empty[s], 256);  // every consumer thread releases a stage
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    reg_dealloc<(S8 && DP > 128) ? 24 : kFp8ProducerRegs>();
    if (threadIdx.x == 0 && walk.n_walk > 0) {
      const int kplane = b * a.H_kv + hk;
      mbar_expect_tx(q_full, Cfg::Q_BYTES);
      tma_tile8<kFp8Rows, DP>(q_s, &tq, q_full, r0, b * a.H + h);
      for (int i = 0; i < 2 * walk.n_walk; ++i) {  // pass 0 K, pass 1 K, V
        const int s = i % STAGES;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        const int c0 = walk.tile(i % walk.n_walk) * KEYS;
        mbar_expect_tx(&k_full[s], Cfg::T_BYTES);
        tma_tile8<KEYS, DP>(k_s + s * Cfg::T_BYTES, &tk, &k_full[s], c0,
                            kplane);
        if (i >= walk.n_walk) {
          mbar_expect_tx(&v_full[s], Cfg::T_BYTES);
          tma_tile8<KEYS, DP>(vr_s + s * Cfg::T_BYTES, &tv, &v_full[s], c0,
                              kplane);
        }
      }
    } else if (threadIdx.x >= 32) {  // the decoders
      const int tid = threadIdx.x - 32;
      if (kDecQK && walk.n_walk > 0) {
        mbar_wait(q_full, 0);
        decode_tile<FMT, kFp8Rows, DP>(q_s, qb_s, tid, kDecoders);
        fence_proxy_async();  // the bf16 tiles are read by wgmma
        mbar_arrive(q_dec);
      }
      for (int i = 0; i < 2 * walk.n_walk; ++i) {
        const int s = i % STAGES;
        if constexpr (kDecQK) {
          mbar_wait(&k_full[s], (i / STAGES) & 1);
          decode_tile<FMT, KEYS, DP>(k_s + s * Cfg::T_BYTES,
                                     kb_s + s * Cfg::KB_BYTES, tid, kDecoders);
          fence_proxy_async();
          mbar_arrive(&k_dec[s]);
        }
        if (i >= walk.n_walk) {  // V's barriers count pass 1's steps only
          const int w = i - walk.n_walk;
          mbar_wait(&v_full[s], (w / STAGES) & 1);
          decode_tile<FMT, KEYS, DP>(vr_s + s * Cfg::T_BYTES,
                                     vb_s + s * Cfg::VB_BYTES, tid, kDecoders);
          fence_proxy_async();
          mbar_arrive(&v_dec[s]);
        }
      }
    }
  } else {  // consumers
    reg_alloc<(S8 && DP > 128) ? 240 : kFp8ConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1;  // 64-row slice of the q tile
    const int t = threadIdx.x % 128;
    const int row0 = r0 + 64 * cw;
    const uint32_t bh = (uint32_t)(b * a.H + h);
    const bool post = a.slopes != nullptr || a.softcap > 0.f;
    const size_t kvb = ((size_t)b * a.H_kv + hk) * f.nkb;
    float sqr[2];  // the q scale of this thread's two rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + acc_row(t, 2 * r);
      sqr[r] = row < a.Nq ? f.sq[(size_t)bh * f.nqb + row / f.bq] : 0.f;
    }
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float su = 0.f;  // without kFold: the v scale O is counted in
    // S8: each row's p scale in the current key block and its reciprocal;
    // with kFold the factor its tiles fold in with (ps * sv); without, O's
    // unit (ps * sv, ps at least kPsFloor), kept in shared memory (beside
    // O's 128 registers, in registers it spilled 16 bytes at 240)
    float ps[2] = {1.f, 1.f}, rps[2] = {1.f, 1.f}, pfold[2] = {0.f, 0.f};
    float* unit = unit_s + 2 * (threadIdx.x - 128);
    if constexpr (S8 && !Cfg::kFold) unit[0] = unit[1] = 0.f;
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

    if (walk.n_walk > 0) mbar_wait(kDecQK ? q_dec : q_full, 0);
    // Step i of the ring: pass 0 (i < n_walk) brings K alone, pass 1 K and
    // V again; both passes run the same S instructions on the same tiles.
    // S of keys [sub * SUB, (sub + 1) * SUB) of the tile: returns its first
    // key.
    // S8 with `kept`: mk takes each row's largest kept score (pass 0).
    auto scores = [&](int i, int sub, float (&sc)[SUB / 2], float (&mx)[2],
                      float (&mk)[2], bool kept) {
      const int s = i % STAGES, ph = (i / STAGES) & 1;
      const int c0 = walk.tile(i % walk.n_walk) * KEYS + sub * SUB;
      const float skt = f.sk[kvb + c0 / f.bk];
      if constexpr (kDecQK) {  // exact bf16 decodes, fp32 accumulation
        mbar_wait(&k_dec[s], ph);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          wgmma_ss<SUB>(sc, desc_k<kFp8Rows>(qb_s, 64 * cw, kk),
                        desc_k<KEYS>(kb_s + s * Cfg::KB_BYTES, sub * SUB, kk),
                        kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
      } else {  // int8: s8 wgmma, exact, into sc's registers as s32
        auto& si = reinterpret_cast<uint32_t(&)[SUB / 2]>(sc);
        mbar_wait(&k_full[s], ph);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 32; ++kk) {
          wgmma_s8<SUB>(si, desc_k<kFp8Rows>(q_s, 64 * cw, kk),
                        desc_k<KEYS>(k_s + s * Cfg::T_BYTES, sub * SUB, kk),
                        kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(si);
#pragma unroll
        for (int k = 0; k < SUB / 2; ++k) {
          sc[k] = (float)__float_as_int(sc[k]);  // the s32 sum, exactly
        }
      }
      const float fac[2] = {(sqr[0] * skt) * a.scale,
                            (sqr[1] * skt) * a.scale};
      // Score pipeline at absolute (row, col), as B1's; masked scores count
      // in the row max as the mask value and are held as -inf.
      const int cls = tile_class(a, row0, row0 + 63, c0, c0 + SUB - 1);
      uint32_t seg[2] = {0u, 0u};
      if (cls == kSegments) {
        segment_bits<SUB>(a.q_ids + (size_t)b * a.Nq, row0, a.Nq,
                          a.kv_ids + (size_t)b * a.Nk, c0, a.Nk, t, seg);
      }
      dispatch_tile(cls, post, [&](auto c, auto pp) {
#pragma unroll
        for (int k = 0; k < SUB / 2; ++k) {
          const int r = (k >> 1) & 1;
          const int row = row0 + acc_row(t, k), col = c0 + acc_col(t, k);
          const bool vis =
              tile_visible<decltype(c)::value>(a, b, row, col, seg, k);
          float dcap;
          const float x = tile_score<decltype(pp)::value>(
              a, h, row, col, sc[k] * fac[r], &dcap);
          mx[r] = fmaxf(mx[r], vis ? x : kMaskValue);
          sc[k] = vis ? x : -INFINITY;
          if constexpr (S8) {
            if (kept && vis && (!a.dropout || keep(a, bh, row, col))) {
              mk[r] = fmaxf(mk[r], x);
            }
          }
        }
      });
      return c0;
    };
    // S8: scratch entry of (row, key block)
    auto bmax_at = [&](int row, int blk) {
      return f.bmax + ((size_t)bh * a.Nq + row) * f.nkb + blk;
    };
    auto block_of = [&](int w) { return walk.tile(w) * KEYS / f.bk; };

    // Pass 0: each row's final max, so that p is rounded to bf16 at it, as
    // fp8_fwd_plain rounds (a one-pass online softmax rounding at the
    // running max missed the two-ulp limit at near-zero outputs).
    float mk[2] = {-INFINITY, -INFINITY};  // S8: the block's kept max
    for (int w = 0; w < walk.n_walk; ++w) {
#pragma unroll
      for (int sub = 0; sub < KEYS / SUB; ++sub) {
        float sc[SUB / 2];
        scores(w, sub, sc, m, mk, true);
      }
      mbar_arrive(&empty[w % STAGES]);
      if constexpr (S8) {  // a block's last tile: store its rows' kept max
        if (w + 1 == walk.n_walk || block_of(w + 1) != block_of(w)) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            mk[r] = fmaxf(mk[r], __shfl_xor_sync(kFull, mk[r], 1));
            mk[r] = fmaxf(mk[r], __shfl_xor_sync(kFull, mk[r], 2));
            const int row = row0 + acc_row(t, 2 * r);
            if ((t & 3) == 0 && row < a.Nq) *bmax_at(row, block_of(w)) = mk[r];
            mk[r] = -INFINITY;
          }
        }
      }
    }
    if constexpr (S8) __syncwarp();  // the quad leaders' stores, for pass 1
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = fmaxf(m[r], __shfl_xor_sync(kFull, m[r], 1));
      m[r] = fmaxf(m[r], __shfl_xor_sync(kFull, m[r], 2));
    }

    // Pass 1: p = exp(s - m), l, and P·V.
    for (int w = 0; w < walk.n_walk; ++w) {
      const int i = walk.n_walk + w, s = i % STAGES;
      const char* vt = vb_s + s * Cfg::VB_BYTES;
      uint32_t pa[KEYS / 16][4];  // p in bf16, the A operand of P·V
      float svt = 0.f;            // the tile's v scale
      if constexpr (S8) {
        // A key block starts: its p scales from pass 0's kept maxima, at
        // the final max m, by the expression p takes below.
        if (w == 0 || block_of(w - 1) != block_of(w)) {
          const float svb = f.sv[kvb + block_of(w)];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = row0 + acc_row(t, 2 * r);
            const float mkr =
                row < a.Nq ? *bmax_at(row, block_of(w)) : -INFINITY;
            float pmax = mkr == -INFINITY ? 0.f : expf(mkr - m[r]);
            if (a.dropout) pmax *= a.drop_inv;
            ps[r] = fmaxf(pmax, 1e-30f) * (1.f / 127.f);
            rps[r] = 1.f / ps[r];
            if constexpr (Cfg::kFold) {
              pfold[r] = ps[r] * svb;
            } else if (mkr != -INFINITY) {  // else the block adds 0
              const float u = fmaxf(ps[r], kPsFloor) * svb;
              const float ratio = unit[r] == 0.f ? 0.f : unit[r] / u;
#pragma unroll
              for (int k = 0; k < DP / 2; ++k) {
                if (((k >> 1) & 1) == r) acc[k] *= ratio;
              }
              unit[r] = u;
            }
          }
        }
      }
#pragma unroll
      for (int sub = 0; sub < KEYS / SUB; ++sub) {
        // (the scores wait for the previous part's P·V too)
        float sc[SUB / 2], unused[2] = {-INFINITY, -INFINITY};
        const int cs = scores(i, sub, sc, unused, unused, false);
#pragma unroll
        for (int k = 0; k < SUB / 2; ++k) {
          const int r = (k >> 1) & 1;
          float p = expf(sc[k] - m[r]);
          l[r] += p;
          if (a.dropout) {
            const int row = row0 + acc_row(t, k), col = cs + acc_col(t, k);
            p = keep(a, bh, row, col) ? p * a.drop_inv : 0.f;
          }
          if constexpr (S8) {
            p = rintf(div_rn(p, ps[r], rps[r]));
            // below the floor O's unit is kPsFloor * sv: p8 * ps / kPsFloor
            // (kPsFloor a power of two)
            if (!Cfg::kFold && ps[r] < kPsFloor) p *= ps[r] * (1.f / kPsFloor);
          }
          sc[k] = p;
        }
        uint32_t pf[SUB / 16][4];
        acc_to_a<SUB>(sc, pf);
#pragma unroll
        for (int j = 0; j < SUB / 16; ++j) {
#pragma unroll
          for (int q = 0; q < 4; ++q) pa[sub * SUB / 16 + j][q] = pf[j][q];
        }
        if (sub == 0) svt = f.sv[kvb + cs / f.bk];
        if constexpr (!Cfg::kFold) {
          // O in units of su: where a tile's sv differs (a new key block),
          // O is rescaled by su / sv first (before the first tile O is 0;
          // S8 rescaled it above). This part's P·V runs while the next
          // part's S is computed.
          if (sub == 0) {
            if (!S8 && svt != su) {
              const float r = su == 0.f ? 0.f : su / svt;
#pragma unroll
              for (int k = 0; k < DP / 2; ++k) acc[k] *= r;
              su = svt;
            }
            mbar_wait(&v_dec[s], (w / STAGES) & 1);
          }
          wgmma_fence();
          fence_regs(acc);
#pragma unroll
          for (int kk = sub * SUB / 16; kk < (sub + 1) * SUB / 16; ++kk) {
            wgmma_rs<DP>(acc, pa[kk], desc_mn<KEYS>(vt, kk));
          }
          wgmma_commit();
        }
      }

      if constexpr (Cfg::kFold) {
        float pv[DP / 2];  // P·V of this tile, before its v scale
#pragma unroll
        for (int k = 0; k < DP / 2; ++k) pv[k] = 0.f;
        mbar_wait(&v_dec[s], (w / STAGES) & 1);
        wgmma_fence();
        fence_regs(pv);
#pragma unroll
        for (int kk = 0; kk < KEYS / 16; ++kk) {
          wgmma_rs<DP>(pv, pa[kk], desc_mn<KEYS>(vt, kk));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(pv);
        mbar_arrive(&empty[s]);
#pragma unroll
        for (int k = 0; k < DP / 2; ++k) {
          acc[k] = fmaf(pv[k], S8 ? pfold[(k >> 1) & 1] : svt, acc[k]);
        }
      } else {
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(&empty[s]);
      }
    }

    // Epilogue: each row's l is spread over the 4 threads of a quad.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(kFull, l[r], 1);
      l[r] += __shfl_xor_sync(kFull, l[r], 2);
      const int row = row0 + acc_row(t, 2 * r);
      if (row >= a.Nq) continue;
      const float l_safe = l[r] == 0.f ? 1.f : l[r];
      const float ou = Cfg::kFold ? 1.f : (S8 ? unit[r] : su);  // O's unit
      const size_t base = (size_t)bh * a.Nq + row;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int col = acc_col(t, 4 * n);
        if (col < a.D) {
          const float x0 = acc[4 * n + 2 * r] * ou / l_safe;
          const float x1 = acc[4 * n + 2 * r + 1] * ou / l_safe;
          if (out_f32) {
            *reinterpret_cast<float2*>(static_cast<float*>(o) +
                                       base * a.D + col) = make_float2(x0, x1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(
                static_cast<__nv_bfloat16*>(o) + base * a.D + col) =
                __floats2bfloat162_rn(x0, x1);
          }
        }
      }
      if ((t & 3) == 0) lse[base] = m[r] + logf(l_safe);
    }
  }
}

template <int DP, int FMT, bool S8>
cudaError_t launch_fp8_sm90(const AttnArgs& a, const Scales& f, void* o,
                            int out_f32, float* lse, cudaStream_t st) {
  using Cfg = Fp8Sm90Cfg<DP, FMT>;
  constexpr int kv_box = Cfg::KEYS < kBox ? Cfg::KEYS : kBox;
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map8(&tq, a.q, a.B * a.H, a.Nq, a.D);
  if (err == cudaSuccess) {
    err = make_map8(&tk, a.k, a.B * a.H_kv, a.Nk, a.D, kv_box);
  }
  if (err == cudaSuccess) {
    err = make_map8(&tv, a.v, a.B * a.H_kv, a.Nk, a.D, kv_box);
  }
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_fp8_sm90_kernel<DP, FMT, S8>;
  constexpr size_t smem = Cfg::SMEM;
  err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Nq + kFp8Rows - 1) / kFp8Rows, a.H, a.B);
  kernel<<<grid, kThreadsWS, smem, st>>>(tq, tk, tv, a, f, o, out_f32, lse);
  return cudaGetLastError();
}

template <int DP>
cudaError_t fp8_sm90_by_fmt(int fmt, const AttnArgs& a, const Scales& f,
                            void* o, int out_f32, float* lse,
                            cudaStream_t st) {
  if (f.s8) return launch_fp8_sm90<DP, 2, true>(a, f, o, out_f32, lse, st);
  switch (fmt) {
    case 0: return launch_fp8_sm90<DP, 0, false>(a, f, o, out_f32, lse, st);
    case 1: return launch_fp8_sm90<DP, 1, false>(a, f, o, out_f32, lse, st);
    case 2: return launch_fp8_sm90<DP, 2, false>(a, f, o, out_f32, lse, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace sm90
}  // namespace fat

extern "C" {

// fmt: 0 = e4m3, 1 = e5m2, 2 = int8 (q8, k8, v8 share it); pv_s8 only with
// int8. out_dtype: 0 = bfloat16, 1 = float32. Returns cudaGetLastError()
// after the launch.
int fat_flash_fwd_fp8(const void* q8, const void* k8, const void* v8,
                      const void* sq, const void* sk, const void* sv, void* o,
                      void* lse, const void* q_ids, const void* kv_ids,
                      const void* slopes, int B, int H, int H_kv, int Nq,
                      int Nk, int D, float scale, int causal, int offset,
                      int window, int sinks, float softcap, float softcap_inv,
                      int dropout, uint32_t drop_threshold, uint32_t seed,
                      float drop_inv, int bq, int bk, int fmt, int pv_s8,
                      int out_dtype, void* stream) {
  if (D < 8 || D > 256 || D % 8 != 0 || H_kv < 1 || H % H_kv != 0 || B < 1 ||
      Nq < 1 || Nk < 1 || H > 65535 || B > 65535 || bq < 1 || bk < 1 ||
      (pv_s8 && fmt != 2)) {
    return (int)cudaErrorInvalidValue;
  }
  AttnArgs a{q8, k8, v8, static_cast<const int32_t*>(q_ids),
             static_cast<const int32_t*>(kv_ids),
             static_cast<const float*>(slopes), B, H, H_kv, Nq, Nk, D, scale,
             causal, offset, window, sinks, softcap, softcap_inv, dropout,
             drop_threshold, seed, drop_inv};
  Scales f{static_cast<const float*>(sq), static_cast<const float*>(sk),
           static_cast<const float*>(sv), bq, bk, (Nq + bq - 1) / bq,
           (Nk + bk - 1) / bk, pv_s8};
  auto st = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  cudaError_t err;
  if (out_dtype == 0) {
    err = by_fmt<__nv_bfloat16>(fmt, a, f, o, l, st);
  } else if (out_dtype == 1) {
    err = by_fmt<float>(fmt, a, f, o, l, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}


// The tensor-core route: D <= 256 with D % 16 == 0 (the caller pads
// other head dims with zero bytes), bk a multiple of 128; q8, k8 and v8
// 16-byte aligned (TMA). The arguments of fat_flash_fwd_fp8, and bmax: with
// pv_s8 (int8 only) fp32 scratch of B * H * Nq * ceil(Nk / bk) floats,
// else unused. D <= 64 runs the DP = 64 kernels, D <= 128 the 128 ones,
// any other D the 256 ones.
int fat_flash_fwd_fp8_sm90(const void* q8, const void* k8, const void* v8,
                           const void* sq, const void* sk, const void* sv,
                           void* o, void* lse, const void* q_ids,
                           const void* kv_ids, const void* slopes, int B,
                           int H, int H_kv, int Nq, int Nk, int D, float scale,
                           int causal, int offset, int window, int sinks,
                           float softcap, float softcap_inv, int dropout,
                           uint32_t drop_threshold, uint32_t seed,
                           float drop_inv, int bq, int bk, int fmt, int pv_s8,
                           int out_dtype, void* bmax, void* stream) {
  using namespace fat;
  if (D < 16 || D > 256 || D % 16 != 0 || H_kv < 1 || H % H_kv != 0 ||
      B < 1 || Nq < 1 || Nk < 1 || H > 65535 || B > 65535 || bq < 1 ||
      bk < 1 || bk % 128 != 0 || fmt < 0 || fmt > 2 ||
      (pv_s8 && (fmt != 2 || bmax == nullptr)) || out_dtype < 0 ||
      out_dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  AttnArgs a{q8, k8, v8, static_cast<const int32_t*>(q_ids),
             static_cast<const int32_t*>(kv_ids),
             static_cast<const float*>(slopes), B, H, H_kv, Nq, Nk, D, scale,
             causal, offset, window, sinks, softcap, softcap_inv, dropout,
             drop_threshold, seed, drop_inv};
  Scales f{static_cast<const float*>(sq), static_cast<const float*>(sk),
           static_cast<const float*>(sv), bq, bk, (Nq + bq - 1) / bq,
           (Nk + bk - 1) / bk, pv_s8, static_cast<float*>(bmax)};
  auto st = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  cudaError_t err;
  if (D <= 64) {
    err = sm90::fp8_sm90_by_fmt<64>(fmt, a, f, o, out_dtype, l, st);
  } else if (D <= 128) {
    err = sm90::fp8_sm90_by_fmt<128>(fmt, a, f, o, out_dtype, l, st);
  } else {
    err = sm90::fp8_sm90_by_fmt<256>(fmt, a, f, o, out_dtype, l, st);
  }
  return (int)err;
}

}  // extern "C"
