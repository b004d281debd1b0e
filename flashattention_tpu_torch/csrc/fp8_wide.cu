// FA3 8-bit attention forward above head dim 256 on Hopper (sm_90a): o and
// the fp32 LSE from e4m3, e5m2 or int8 payloads with per-block fp32 scales,
// for any head dim, on mma.sync.
//
// Replaces: flashattention_tpu/ops/pallas_fp8.py, _fp8_fwd_kernel (launched
// by _fp8_fwd), at the head dims above 256 that pallas_fp8_attention
// computes and that flash_fwd_fp8.cu's kernels (D <= 256) do not take. Same
// contract and rounding points as those (flash_fwd_fp8.cu's header):
// payloads decoded exactly; the score is the dot of the decoded q and k
// (for int8 one exact s32 sum over all of D, converted to float once) times
// (sq[row / bq] * sk[col / bk]) * scale, then ALiBi, the soft-cap and the
// mask (causal with the offset Nk - Nq, window + sinks, segment ids); the
// LSE from these scores; p rounded to bf16 at each row's final max (two
// passes over the walk, as the D <= 256 kernels), dropped by the murmur3
// mask after the LSE, and each key tile's P.V folded in times sv[col / bk];
// with int8_pv "s8" p re-quantized per row and key block, ps = max(max p,
// 1e-30) / 127 from pass 0's kept maxima, p8 = rint(p / ps) (div_rn), and
// the tile's p8 . v8 folded in times ps * sv. Key blocks off the 32-key
// tile (bk not a multiple of 32, never with s8; the SPAN instantiation): a
// key's sk is its own block's, and a tile's P.V runs once for each block it
// spans, p zero past the block, each folded in times that block's sv, so
// the per-block sums of the plain version hold.
//
// What bounds it on this card: the tensor-core rate (4 D operations per
// visible (head, row, key): Q.K on 8-bit operands, P.V on bf16 p), as
// flash_fwd_fp8.cu's kernels.
//
// Design: flash_wide.cu's forward (wide_mma.cuh's ring of items) on 1-byte
// tiles. One CTA a (64 query rows, head, O chunk of 128 columns, batch), 4
// warps of 16 rows (row tiles taken last to first). Every chunk's CTA runs
// Q.K^T over all of D, in segments of 128 payload columns taken in one
// order by the same instructions, so the CTAs of a row tile compute the
// same scores bit for bit, the same maxima, the same dropout mask and (s8)
// the same p scales, and their chunks of O share one normaliser. The walk
// (key tiles of 32 keys, sink tiles then the band) runs twice: pass 0's
// items are the segments of each tile (row max, and with s8 each row's
// largest kept score in each key block, written at a block's last tile into
// this chunk's own slot of a scratch the wrapper allocates, (chunks, B, H,
// Nq, nkb) fp32, so no two CTAs write one slot); pass 1's are the segments
// and then the tile's V chunk (32 keys x 128 columns). Tiles land by
// cp.async into a ring of wide::kStages stages of 1-byte rows of an odd
// count of 16-byte units, which ldmatrix reads free of bank conflicts. A
// k32 step of an 8-bit operand is 32 bytes, as a k16 step of bf16 is, so
// the bf16 lane maps of ldmatrix (sparse_mma.cuh) hand each lane the four
// bytes m16n8k32 wants: int8 Q.K^T runs on mma.sync m16n8k32 s8 into s32
// accumulators that persist over the segments (exact while 127^2 * D <
// 2^31). e4m3 and e5m2 decode each lane's bytes in registers to f16 (exact:
// both are subsets of f16) and run m16n8k16 f16 with fp32 accumulation: a
// lane's four bytes of row g, columns 4 tq .. 4 tq + 3, stand for k = 2 tq,
// 2 tq + 1, 2 tq + 8, 2 tq + 9 of one k16 step, in A and in B alike, so
// the dot is the same sum. (The 8-bit mma.sync with fp32 accumulation
// exists on sm_89 and later, but flash_fwd_fp8.cu found e4m3 wgmma's
// accumulation missing the 1e-4 LSE limit; the f16 decode is exact.) P.V
// reads V MN-major, which ldmatrix.trans cannot do on 1-byte elements, so
// every thread first decodes the landed V chunk into a bf16 tile (exact for
// all three formats), and P.V runs on bf16 m16n8k16 with p as the register
// A operand, 4 output tiles at a time into a fresh accumulator that is
// folded into O times sv (or ps * sv). The head dim's padding to a multiple
// of 16 (ops/fp8_attn.kernel_head_dim) keeps every 16-byte copy wholly
// inside or past D; columns past D read zeros.

#include "flash_fwd.cuh"
#include "fp8_sm90.cuh"
#include "wide_mma.cuh"

namespace fat {
namespace fp8w {

using mma::a_col;
using mma::a_row;
using mma::b_col;
using mma::b_row;
using sm90::smem_u32;
using wide::cmax;
using wide::kGroup;
using wide::kStages;
using wide::kThreadsW;
using wide::zero;

constexpr int kRows = 64;       // query rows of a CTA
constexpr int kKeys = 32;       // keys of a tile
constexpr int kSeg8 = 128;      // payload columns (bytes) of a segment item
constexpr int kChunk = 128;     // columns of an O chunk
constexpr int RS8 = ((kSeg8 / 16) | 1) * 16;   // bytes a segment row
constexpr int RV8 = ((kChunk / 16) | 1) * 16;  // bytes a V chunk row
constexpr int RVB = tc_row_bytes(kChunk);      // bytes a decoded V row
constexpr int STAGE = cmax((kRows + kKeys) * RS8, kKeys * RV8);
constexpr size_t SMEM = (size_t)kStages * STAGE + (size_t)kKeys * RVB;

// d (16 x 8, s32) += a (16 x 32, s8, row) * b (32 x 8, s8, col)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d (16 x 8, fp32) += a (16 x 16, f16, row) * b (16 x 8, f16, col)
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four e4m3 (FMT 0) or e5m2 (FMT 1) bytes as two f16x2: bytes 0, 1 in lo
// and 2, 3 in hi, the lower byte in the lower half. Exact.
template <int FMT>
__device__ __forceinline__ void to_f16x2(uint32_t w, uint32_t& lo,
                                         uint32_t& hi) {
  constexpr auto kind = FMT == 0 ? __NV_E4M3 : __NV_E5M2;
  const __half2_raw x =
      __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(w & 0xffffu), kind);
  const __half2_raw y =
      __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(w >> 16), kind);
  lo = (uint32_t)x.x | ((uint32_t)x.y << 16);
  hi = (uint32_t)y.x | ((uint32_t)y.y << 16);
}

// S (16 rows x 32 keys) += Q[:, seg] . K[:, seg]^T over one segment of
// kSeg8 payload columns: Q's 16 rows at ta, K's 32 rows at tb (row stride
// RS8). int8 sums into sc's registers as s32.
template <int FMT>
__device__ __forceinline__ void seg_scores(float (&sc)[kKeys / 8][4],
                                           const char* ta, const char* tb,
                                           int lane) {
  constexpr int NT = kKeys / 8;
  const uint32_t pa = smem_u32(ta + a_row(lane) * RS8 + 2 * a_col(lane));
  const uint32_t pb = smem_u32(tb + b_row(lane) * RS8 + 2 * b_col(lane));
#pragma unroll
  for (int ks = 0; ks < kSeg8 / 32; ++ks) {
    uint32_t af[4];
    ldsm_x4(af, pa + ks * 32);
    if constexpr (FMT == 2) {
      auto& si = reinterpret_cast<int(&)[NT][4]>(sc);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, pb + np * 16 * RS8 + ks * 32);
        mma_s8(si[2 * np], af, bf[0], bf[1]);
        mma_s8(si[2 * np + 1], af, bf[2], bf[3]);
      }
    } else {
      // A: af[0] / af[1] are rows g / g + 8 at bytes 4 tq .. of the step's
      // first 16, af[2] / af[3] of its last 16: two k16 steps
      uint32_t x[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) to_f16x2<FMT>(af[i], x[i][0], x[i][1]);
      const uint32_t lo[4] = {x[0][0], x[1][0], x[0][1], x[1][1]};
      const uint32_t hi[4] = {x[2][0], x[3][0], x[2][1], x[3][1]};
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, pb + np * 16 * RS8 + ks * 32);
#pragma unroll
        for (int t = 0; t < 2; ++t) {  // n tile 2 np + t: bf[2 t], bf[2 t + 1]
          uint32_t b0, b1;
          to_f16x2<FMT>(bf[2 * t], b0, b1);
          mma_f16(sc[2 * np + t], lo, b0, b1);
          to_f16x2<FMT>(bf[2 * t + 1], b0, b1);
          mma_f16(sc[2 * np + t], hi, b0, b1);
        }
      }
    }
  }
}

// The landed 1-byte V chunk (kKeys rows of kChunk bytes at raw) decoded to
// bf16 at dst (row stride RVB), every thread of the CTA.
template <int FMT>
__device__ __forceinline__ void decode_chunk(const char* raw, char* dst) {
  constexpr int CPR = kChunk / 16;
  for (int u = threadIdx.x; u < kKeys * CPR; u += kThreadsW) {
    const int r = u / CPR, cs = u % CPR;
    const uint4 src = *reinterpret_cast<const uint4*>(raw + r * RV8 + cs * 16);
    uint32_t out[8];
    sm90::bytes_to_bf16<FMT>(src.x, out);
    sm90::bytes_to_bf16<FMT>(src.y, out + 2);
    sm90::bytes_to_bf16<FMT>(src.z, out + 4);
    sm90::bytes_to_bf16<FMT>(src.w, out + 6);
    uint4* d = reinterpret_cast<uint4*>(dst + r * RVB + cs * 32);
    d[0] = make_uint4(out[0], out[1], out[2], out[3]);
    d[1] = make_uint4(out[4], out[5], out[6], out[7]);
  }
}

// O (16 x 128) += fold[row] * (round(P) . V): P the tile's p (16 x 32),
// element (n, c) of the fragment given by p(n, c), as the bf16 A operand; V
// the decoded chunk at vb; kGroup output tiles at a time into a fresh
// accumulator.
template <typename P>
__device__ __forceinline__ void pv_fold(float (&acc)[kChunk / 8][4], P&& p,
                                        const char* vb, const float (&fold)[2],
                                        int lane) {
  constexpr int NT = kKeys / 8, NO = kChunk / 8;
  uint32_t pa[NT / 2][4];
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    pa[kk][0] = pack_bf16(p(2 * kk, 0), p(2 * kk, 1));
    pa[kk][1] = pack_bf16(p(2 * kk, 2), p(2 * kk, 3));
    pa[kk][2] = pack_bf16(p(2 * kk + 1, 0), p(2 * kk + 1, 1));
    pa[kk][3] = pack_bf16(p(2 * kk + 1, 2), p(2 * kk + 1, 3));
  }
  const int at = a_row(lane) * RVB + 2 * a_col(lane);
#pragma unroll
  for (int d0 = 0; d0 < NO; d0 += kGroup) {
    float tmp[kGroup][4];
    zero(tmp);
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
      for (int dn = 0; dn < kGroup / 2; ++dn) {
        uint32_t bf[4];
        ldsm_x4_t(bf, smem_u32(vb + kk * 16 * RVB + at + (d0 / 2 + dn) * 32));
        mma_16816(tmp[2 * dn], pa[kk], bf[0], bf[1]);
        mma_16816(tmp[2 * dn + 1], pa[kk], bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[d0 + j][c] = fmaf(tmp[j][c], fold[c >> 1], acc[d0 + j][c]);
      }
    }
  }
}

// S8: int8_pv "s8" (FMT == 2 only), p re-quantized per row and key block.
// SPAN: key blocks off the 32-key tile (never with S8), a key's sk and sv
// its own block's.
template <int FMT, bool S8, bool SPAN>
__global__ void __launch_bounds__(kThreadsW, 1)
flash_fwd_fp8_wide_kernel(const AttnArgs a, const Scales f,
                          void* __restrict__ o, int out_f32,
                          float* __restrict__ lse) {
  static_assert(!(S8 && SPAN), "s8 takes key blocks of whole tiles");
  constexpr int NT = kKeys / 8, NO = kChunk / 8;
  extern __shared__ __align__(128) char smem[];
  char* vb = smem + kStages * STAGE;  // V's chunk decoded to bf16
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int D = a.D, nch = (D + kChunk - 1) / kChunk;
  const int chunk = blockIdx.y % nch, h = blockIdx.y / nch, b = blockIdx.z;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heavy first
  const int hk = h / (a.H / a.H_kv), d_c = chunk * kChunk;
  const TileWalk walk = key_tiles(a, r0, min(r0 + kRows, a.Nq) - 1, kKeys);
  const int nseg = (D + kSeg8 - 1) / kSeg8, per = nseg + 1;
  const int n0 = walk.n_walk * nseg;              // pass 0's items
  const int n_items = n0 + walk.n_walk * per;     // and pass 1's
  const uint32_t bh = (uint32_t)(b * a.H + h);
  const auto* qg = static_cast<const uint8_t*>(a.q) + ((size_t)bh * a.Nq + r0) * D;
  const size_t kv_off = ((size_t)b * a.H_kv + hk) * a.Nk * D;
  const auto* kg = static_cast<const uint8_t*>(a.k) + kv_off;
  const auto* vg = static_cast<const uint8_t*>(a.v) + kv_off;
  // item i: its tile of the walk and its column item (segment j < nseg, or
  // pass 1's V chunk, j == nseg)
  auto item = [&](int i, int& w, int& j) {
    if (i < n0) {
      w = i / nseg;
      j = i % nseg;
    } else {
      w = (i - n0) / per;
      j = (i - n0) % per;
    }
  };

  auto issue = [&](int i) {
    char* st = smem + (i % kStages) * STAGE;
    int w, j;
    item(i, w, j);
    const int c0 = walk.tile(w) * kKeys;
    if (j < nseg) {
      wide::load_tile<uint8_t, kSeg8>(st, RS8, qg, kRows, a.Nq - r0,
                                      j * kSeg8, D);
      wide::load_tile<uint8_t, kSeg8>(st + kRows * RS8, RS8,
                                      kg + (size_t)c0 * D, kKeys, a.Nk - c0,
                                      j * kSeg8, D);
    } else {
      wide::load_tile<uint8_t, kChunk>(st, RV8, vg + (size_t)c0 * D, kKeys,
                                       a.Nk - c0, d_c, D);
    }
  };

  const int row0 = r0 + 16 * warp;
  const size_t kvb = ((size_t)b * a.H_kv + hk) * f.nkb;
  float sqr[2];  // the q scale of this lane's two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    sqr[r] = row < a.Nq ? f.sq[(size_t)bh * f.nqb + row / f.bq] : 0.f;
  }
  // S8: this chunk's slot of the kept maxima, (B, H, Nq, nkb) floats
  float* bmax = S8 ? f.bmax + (size_t)chunk * a.B * a.H * a.Nq * f.nkb
                   : nullptr;
  auto bmax_at = [&](int row, int blk) {
    return bmax + ((size_t)bh * a.Nq + row) * f.nkb + blk;
  };
  auto block_of = [&](int w) { return walk.tile(w) * kKeys / f.bk; };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float mk[2] = {-INFINITY, -INFINITY};  // S8: the block's kept max
  float ps[2] = {1.f, 1.f}, rps[2] = {1.f, 1.f};  // S8: p scales, 1 / them
  float acc[NO][4], sc[NT][4];
  zero(acc);
  zero(sc);
  wide::ring_start(n_items, issue);
  for (int i = 0; i < n_items; ++i) {
    wide::ring_step(i, n_items, issue);
    const char* st = smem + (i % kStages) * STAGE;
    int w, j;
    item(i, w, j);
    const bool pass1 = i >= n0;
    const int c0 = walk.tile(w) * kKeys;
    if (j < nseg) {  // S += Q[:, seg] . K[:, seg]^T
      if (j == 0) zero(sc);
      seg_scores<FMT>(sc, st + 16 * warp * RS8, st + kRows * RS8, lane);
      if (j < nseg - 1) continue;
      // The score pipeline at absolute (row, col), as flash_fwd_fp8.cu's;
      // masked scores count in the row max as the mask value and are held
      // as -inf.
      const float skt = f.sk[kvb + c0 / f.bk];
      const float fac[2] = {(sqr[0] * skt) * a.scale,
                            (sqr[1] * skt) * a.scale};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = c >> 1;
          const int row = row0 + g + 8 * r;
          const int col = c0 + 8 * n + 2 * tq + (c & 1);
          const float s = FMT == 2
                              ? (float)reinterpret_cast<const int&>(sc[n][c])
                              : sc[n][c];
          const bool vis = row < a.Nq && visible(a, b, row, col);
          float fr = fac[r];
          if constexpr (SPAN) {
            fr = (sqr[r] * f.sk[kvb + min(col, a.Nk - 1) / f.bk]) * a.scale;
          }
          float dcap;
          const float x = post_score(a, h, row, col, s * fr, &dcap);
          if (!pass1) {
            m[r] = fmaxf(m[r], vis ? x : kMaskValue);
            if (S8 && vis && (!a.dropout || keep(a, bh, row, col))) {
              mk[r] = fmaxf(mk[r], x);
            }
          }
          sc[n][c] = vis ? x : -INFINITY;
        }
      }
      if (pass1) continue;
      if constexpr (S8) {  // a block's last tile: store its rows' kept max
        if (w + 1 == walk.n_walk || block_of(w + 1) != block_of(w)) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            mk[r] = fmaxf(mk[r], __shfl_xor_sync(kFull, mk[r], 1));
            mk[r] = fmaxf(mk[r], __shfl_xor_sync(kFull, mk[r], 2));
            const int row = row0 + g + 8 * r;
            if (tq == 0 && row < a.Nq) *bmax_at(row, block_of(w)) = mk[r];
            mk[r] = -INFINITY;
          }
        }
      }
      if (w + 1 == walk.n_walk) {  // the rows' final max, over a quad
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          m[r] = fmaxf(m[r], __shfl_xor_sync(kFull, m[r], 1));
          m[r] = fmaxf(m[r], __shfl_xor_sync(kFull, m[r], 2));
        }
        if constexpr (S8) __syncwarp();  // the quad leaders' stores
      }
      continue;
    }

    // Pass 1's V chunk: p = exp(s - m), l, and O[:, chunk] += P . V.
    decode_chunk<FMT>(st, vb);
    __syncthreads();
    const float svt = f.sv[kvb + c0 / f.bk];
    if constexpr (S8) {
      // A key block starts: its p scales from pass 0's kept maxima, at the
      // final max m, by the expression p takes below.
      if (w == 0 || block_of(w - 1) != block_of(w)) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + g + 8 * r;
          const float mkr =
              row < a.Nq ? *bmax_at(row, block_of(w)) : -INFINITY;
          float pmax = mkr == -INFINITY ? 0.f : expf(mkr - m[r]);
          if (a.dropout) pmax *= a.drop_inv;
          ps[r] = fmaxf(pmax, 1e-30f) * (1.f / 127.f);
          rps[r] = 1.f / ps[r];
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1;
        float p = expf(sc[n][c] - m[r]);
        l[r] += p;
        if (a.dropout) {
          const int row = row0 + g + 8 * r;
          const int col = c0 + 8 * n + 2 * tq + (c & 1);
          p = keep(a, bh, row, col) ? p * a.drop_inv : 0.f;
        }
        if constexpr (S8) p = rintf(sm90::div_rn(p, ps[r], rps[r]));
        sc[n][c] = p;
      }
    }
    if constexpr (SPAN) {  // P.V once a key block of the tile
      const int last = (min(c0 + kKeys, a.Nk) - 1) / f.bk;
      for (int bl = c0 / f.bk; bl <= last; ++bl) {
        const float svb = f.sv[kvb + bl];
        const float fold[2] = {svb, svb};
        pv_fold(
            acc,
            [&](int n, int c) {
              const int col = c0 + 8 * n + 2 * tq + (c & 1);
              return col / f.bk == bl ? sc[n][c] : 0.f;
            },
            vb, fold, lane);
      }
    } else {
      const float fold[2] = {S8 ? ps[0] * svt : svt, S8 ? ps[1] * svt : svt};
      pv_fold(acc, [&](int n, int c) { return sc[n][c]; }, vb, fold, lane);
    }
  }

  // Epilogue: each row's l is spread over the 4 lanes of a quad.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    const int row = row0 + g + 8 * r;
    if (row >= a.Nq) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    const size_t base = (size_t)bh * a.Nq + row;
#pragma unroll
    for (int dn = 0; dn < NO; ++dn) {
      const int col = d_c + 8 * dn + 2 * tq;
      if (col >= D) continue;
      const float x0 = acc[dn][2 * r] / l_safe, x1 = acc[dn][2 * r + 1] / l_safe;
      if (out_f32) {
        *reinterpret_cast<float2*>(static_cast<float*>(o) + base * D + col) =
            make_float2(x0, x1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(o) +
                                           base * D + col) =
            __floats2bfloat162_rn(x0, x1);
      }
    }
    if (chunk == 0 && tq == 0) lse[base] = m[r] + logf(l_safe);
  }
}

template <int FMT, bool S8, bool SPAN>
cudaError_t launch(const AttnArgs& a, const Scales& f, void* o, int out_f32,
                   float* lse, cudaStream_t st) {
  auto kernel = flash_fwd_fp8_wide_kernel<FMT, S8, SPAN>;
  cudaError_t err = set_smem(kernel, SMEM);
  if (err != cudaSuccess) return err;
  const int nch = (a.D + kChunk - 1) / kChunk;
  const dim3 grid((a.Nq + kRows - 1) / kRows, a.H * nch, a.B);
  kernel<<<grid, kThreadsW, SMEM, st>>>(a, f, o, out_f32, lse);
  return cudaGetLastError();
}

}  // namespace fp8w
}  // namespace fat

extern "C" {

// The 8-bit forward above D = 256: D % 16 == 0 (the caller pads other head
// dims with zero bytes), any bk >= 1 (with pv_s8 a multiple of 32, so that
// a key tile never spans two key blocks); q8, k8 and v8 16-byte aligned
// (cp.async). The arguments of
// fat_flash_fwd_fp8_sm90 in flash_fwd_fp8.cu; bmax, with pv_s8 (int8
// only), is fp32 scratch of ceil(D / 128) * B * H * Nq * ceil(Nk / bk)
// floats (each O chunk's CTAs their own slot), else unused. Returns
// cudaGetLastError() after the launch.
int fat_flash_fwd_fp8_wide(const void* q8, const void* k8, const void* v8,
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
  if (D <= 256 || D % 16 != 0 || H_kv < 1 || H % H_kv != 0 || B < 1 ||
      Nq < 1 || Nk < 1 || B > 65535 || bq < 1 || bk < 1 ||
      (pv_s8 && bk % 32 != 0) ||
      fmt < 0 || fmt > 2 || (pv_s8 && (fmt != 2 || bmax == nullptr)) ||
      out_dtype < 0 || out_dtype > 1 ||
      (long long)H * ((D + 127) / 128) > 65535 ||
      (reinterpret_cast<uintptr_t>(q8) | reinterpret_cast<uintptr_t>(k8) |
       reinterpret_cast<uintptr_t>(v8)) % 16 != 0) {
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
  const bool span = bk % 32 != 0;
  if (pv_s8) {
    err = fp8w::launch<2, true, false>(a, f, o, out_dtype, l, st);
  } else if (fmt == 0) {
    err = span ? fp8w::launch<0, false, true>(a, f, o, out_dtype, l, st)
               : fp8w::launch<0, false, false>(a, f, o, out_dtype, l, st);
  } else if (fmt == 1) {
    err = span ? fp8w::launch<1, false, true>(a, f, o, out_dtype, l, st)
               : fp8w::launch<1, false, false>(a, f, o, out_dtype, l, st);
  } else {
    err = span ? fp8w::launch<2, false, true>(a, f, o, out_dtype, l, st)
               : fp8w::launch<2, false, false>(a, f, o, out_dtype, l, st);
  }
  return (int)err;
}

}  // extern "C"
