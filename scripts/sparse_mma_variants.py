"""Design readings of the block-sparse mma kernels (blocks that are not both
multiples of 64, ``mma.sync`` on 16-row slices: bf16 on m16n8k16, fp32 in
3xTF32 on m16n8k8) on one NVIDIA GPU: variants built from edited copies of
``csrc/sparse_fwd.cu``, ``csrc/sparse_bwd.cu`` and ``csrc/sparse_mma.cuh``,
or run with other arguments.

    python3 scripts/sparse_mma_variants.py [--variants a,b,...] [--cases o,p,q,r]

Cases: chip_smoke's sparse cases (o) (phase 7f's call, (2, 12, 4096, 64) at
blocks 32 x 32, local + global width 16), (p) (GQA 8/2 at D = 128, blocks
16 x 16), (q) (phase 7b's MQA call at blocks 32 x 32) and (r) (case (f)'s
edges at blocks 24 x 40) in bf16; (n) (GQA 8/2 at D = 256, blocks 96 x
80), (s) (phase 7g's call: case (o) in fp32), (t) (phase 7e's MQA call at
blocks 32 x 32: case (q) in fp32) and (u) (case (r) in fp32) in fp32.
Variants, with the ptxas registers and spill bytes of each mma kernel:

- ``kernel``: the sources as they are (two-stage rings);
- ``ring3``, ``ring4``: every mma kernel's ring (the forward's and dQ's
  K/V sub-tiles, dK/dV's q / dO steps) 3 or 4 stages deep: more loads in
  flight, more shared memory a CTA and so fewer CTAs an SM;
- ``chunk16``, ``chunk32``, ``chunk64``, ``chunk128``: the sources as they
  are, a KV block's dK/dV walk cut into chunks of 16 to 128 16-row steps
  (``sparse_attn.MMA_CHUNK_STEPS``, the wrapper's);
- ``fastexp``: p = ``__expf`` (ex2.approx) in the three kernels of both
  dtypes instead of ``expf``: what the element-wise softmax costs, and
  whether the case's limit (bf16 two ulps, fp32 1e-4) still holds;
- ``qreg``: the fp32 forward at D = 64 holds both TF32 parts of Q's
  fragments in registers (64 of them) instead of reading and splitting
  them at each k8 step (less split work, fewer resident CTAs);
- ``planes``: the fp32 forward splits each landed K/V stage once into big
  and small planes in shared memory (every thread a share, then a second
  barrier), so the warps load both parts and split nothing of K and V:
  twice the ring's bytes (16-key sub-tiles at D = 256 to fit), split work
  no longer repeated by each warp.

Each variant's forward and backward ms, kernels alone with the lists and
di built beforehand (chip_smoke's Timer: CUDA events, median of 30, L2
flushed), the device ms of each kernel (torch.profiler), and the largest
error against the plain version with the verdict at chip_smoke's limit
(bf16 two ulps + 1e-3 x max|plain|, fp32 1e-4). Variants build with nvcc into
``flashattention_tpu_torch/_build/ab/`` (all at once) from exact text
edits; the script stops if one no longer applies. Prints the card's name
and power limit, then one JSON line; writes
``chiprun_out/sparse_mma_variants.json``. Exits nonzero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from flashattention_tpu_torch import _build  # noqa: E402
from flashattention_tpu_torch.ops import flash_attn as fa  # noqa: E402
from flashattention_tpu_torch.ops import sparse_attn as sa  # noqa: E402

AB = _build.BUILD_DIR / "ab"
SOURCES = ("sparse_fwd", "sparse_bwd")


class Edit:
    """Exact text edits of one source; stops where one no longer applies
    (``count`` matches, all replaced)."""

    def __init__(self, src):
        self.src = src

    def __call__(self, old, new, count=1):
        if self.src.count(old) != count:
            raise SystemExit(f"sparse_mma_variants: an edit no longer "
                             f"applies ({self.src.count(old)} matches):\n{old}")
        self.src = self.src.replace(old, new)


def ring(stages):
    def edit(name, e):
        if name == "sparse_mma":
            e("constexpr int kStages = 2;",
              f"constexpr int kStages = {stages};")
    return edit


def fastexp(name, e):
    if name == "sparse_mma":
        return
    if name == "sparse_fwd":
        e("? expf(sc[n][c] * a.scale - m[c >> 1])",
          "? __expf(sc[n][c] * a.scale - m[c >> 1])")
        e("sc[n][c] = expf(sc[n][c] - m[c >> 1]);",
          "sc[n][c] = __expf(sc[n][c] - m[c >> 1]);")
        return
    e("? expf(st[n][c] * a.scale - ls[rr])",
      "? __expf(st[n][c] * a.scale - ls[rr])", 2)
    e("? expf(sc[n][c] * a.scale - lse_r[c >> 1])",
      "? __expf(sc[n][c] * a.scale - lse_r[c >> 1])")
    e("? expf(sc[kk][c] * a.scale - lse_r[c >> 1])",
      "? __expf(sc[kk][c] * a.scale - lse_r[c >> 1])")


def qreg(name, e):
    if name != "sparse_fwd":
        return
    e("""    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  }

  if (!ld.done()) {
    if (live) {
      load_rows(rc_warp, q_s,
                static_cast<const float*>(a.q) +""",
      """    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  }
  constexpr bool QREG = DP <= 64;
  uint32_t qb[QREG ? KS : 1][4], qsm[QREG ? KS : 1][4];

  if (!ld.done()) {
    if (live) {
      load_rows(rc_warp, q_s,
                static_cast<const float*>(a.q) +""")
    e("""        uint32_t x[4], ab[4], as[4];
        ldsm_x4(x, smem_u32(q_s + oa + ks * 32));
        split_frag(x, ab, as);""",
      """        uint32_t x[4], ab[4], as[4];
        if constexpr (QREG) {
          if (it == 0) {
            ldsm_x4(x, smem_u32(q_s + oa + ks * 32));
            split_frag(x, qb[ks], qsm[ks]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ab[i] = qb[ks][i];
            as[i] = qsm[ks][i];
          }
        } else {
          ldsm_x4(x, smem_u32(q_s + oa + ks * 32));
          split_frag(x, ab, as);
        }""")


def planes(name, e):
    if name != "sparse_fwd":
        return
    e("""  const int stage_bytes = 2 * KEYS * rs;
  const RowCopy rc = row_copy<float>(D, threadIdx.x, blockDim.x);""",
      """  const int stage_bytes = 4 * KEYS * rs;  // K, V, then their small parts
  const RowCopy rc = row_copy<float>(D, threadIdx.x, blockDim.x);""")
    e("""      cp_async_commit();
      if (!live) continue;
      const char* kt = ring + it % STAGES * stage_bytes;
      const char* vt = kt + KEYS * rs;

      // S = Q.K^T over the sub-tile (16 rows x KEYS keys)""",
      """      cp_async_commit();
      {
        char* st = ring + it % STAGES * stage_bytes;
        sm90::split_tile(st, st, st + 2 * KEYS * rs, 2 * KEYS * rs, 1.f,
                         threadIdx.x, blockDim.x);
      }
      __syncthreads();
      if (!live) continue;
      const char* kt = ring + it % STAGES * stage_bytes;
      const char* vt = kt + KEYS * rs;

      // S = Q.K^T over the sub-tile (16 rows x KEYS keys)""")
    e("""          uint32_t bb[4], bs[4];
          ldsm_x4(x, smem_u32(kt + np * 16 * rs + ob + ks * 32));
          split_frag(x, bb, bs);
          mma3_1688(sc[2 * np], ab, as, bb[0], bb[1], bs[0], bs[1]);""",
      """          uint32_t bb[4], bs[4];
          ldsm_x4(bb, smem_u32(kt + np * 16 * rs + ob + ks * 32));
          ldsm_x4(bs, smem_u32(kt + 2 * KEYS * rs + np * 16 * rs + ob +
                               ks * 32));
          mma3_1688(sc[2 * np], ab, as, bb[0], bb[1], bs[0], bs[1]);""")
    e("""          uint32_t vb[2], vs[2];
          f32_b(vt, kk * 8 * rs + ov + dn * 32, rs, vb, vs);""",
      """          uint32_t vb[2], vs[2];
          const int at = kk * 8 * rs + ov + dn * 32;
          vb[0] = *reinterpret_cast<const uint32_t*>(vt + at);
          vb[1] = *reinterpret_cast<const uint32_t*>(vt + at + rs);
          vs[0] = *reinterpret_cast<const uint32_t*>(vt + 2 * KEYS * rs + at);
          vs[1] = *reinterpret_cast<const uint32_t*>(vt + 2 * KEYS * rs + at +
                                                     rs);""")
    e("""  const size_t smem = FwdMmaCfg<DP, KEYS>::smem(warps, f32_row_bytes(a.D));""",
      """  const size_t smem = FwdMmaCfg<DP, KEYS>::smem(warps, f32_row_bytes(a.D)) +
                      (size_t)kStages * 2 * KEYS * f32_row_bytes(a.D);""")
    e("""  return block_k <= 16
             ? launch_sparse_fwd_f32_mma<DP, 16>(""",
      """  return block_k <= 16 || DP == 256
             ? launch_sparse_fwd_f32_mma<DP, 16>(""")


VARIANTS = {"kernel": None, "ring3": ring(3), "ring4": ring(4),
            "chunk16": None, "chunk32": None, "chunk64": None,
            "chunk128": None, "fastexp": fastexp, "qreg": qreg,
            "planes": planes}
# variants that run the unedited kernels with other arguments: the 16-row
# steps of a dK/dV chunk
CHUNK_STEPS = {"chunk16": 16, "chunk32": 32, "chunk64": 64,
               "chunk128": 128}


def build(variant):
    """Both libraries of one variant; {source: (lib path, ptxas report)}.
    The edited header lands beside the edited sources, where their quoted
    include finds it first."""
    out = {}
    d = AB / variant
    d.mkdir(parents=True, exist_ok=True)
    e = Edit((_build.CSRC_DIR / "sparse_mma.cuh").read_text())
    if VARIANTS[variant]:
        VARIANTS[variant]("sparse_mma", e)
    (d / "sparse_mma.cuh").write_text(e.src)
    for name in SOURCES:
        e = Edit((_build.CSRC_DIR / f"{name}.cu").read_text())
        if VARIANTS[variant]:
            VARIANTS[variant](name, e)
        cu = d / f"{name}.cu"
        cu.write_text(e.src)
        so = d / f"lib{name}.so"
        proc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
             "-o", str(so), str(cu)], capture_output=True, text=True,
            timeout=900)
        if proc.returncode:
            raise SystemExit(f"{variant} {name}: build failed\n"
                             f"{proc.stderr[-3000:]}")
        out[name] = (so, proc.stderr)
    return variant, out


def case(gen, dev, key):
    _, shape, dtype, causal, (bq, bk), pattern, use_dlse = \
        cs.SPARSE_CASES[key]
    q, k, v, do, dlse, _ = cs._flash_inputs(
        gen, dev, shape, dtype, ("dlse",) if use_dlse else ())
    spec = sa.SparseSpec(causal=causal, scale=shape[-1] ** -0.5, block_q=bq,
                         block_k=bk)
    active = sa.tile_pattern(pattern.to(dev), *pattern.shape, bq, bk, causal,
                             shape[4] - shape[3])
    if sa._route(dtype, shape[-1], spec) != "mma":
        raise SystemExit(f"case {key} is not on the mma route")
    o, lse = sa.sparse_fwd_plain(q, k, v, active, spec)
    di = (o.float() * do.float()).sum(-1)
    if dlse is not None:
        di = di - dlse
    ref = (o, lse, *sa.sparse_bwd_plain(q, k, v, do, lse, di, active, spec))
    return (q, k, v, do, o, lse, dlse, active, spec), ref


def launchers(lib_fwd, lib_bwd, args, chunk_steps=None):
    """(fwd, bwd) calls of the mma entries of q's dtype; each returns its
    outputs.
    ``chunk_steps``: the 16-row steps of a dK/dV chunk, where not the
    wrapper's."""
    q, k, v, do, o, lse, dlse, active, spec = args
    o_out, lse_out = torch.empty_like(o), torch.empty_like(lse)
    grads = [torch.empty_like(x) for x in (q, k, v)]
    di = (o.float() * do.float()).sum(-1)
    if dlse is not None:
        di = di - dlse
    kv_list, kv_count = sa.compact_rows(active)
    q_list, q_count = sa.compact_rows(active.t())
    stream = torch.cuda.current_stream().cuda_stream
    shape = sa._shape_args(q, k, spec)
    code = fa._DTYPE_CODE[q.dtype]
    fwd_fn = getattr(lib_fwd, sa._entry("fwd", q.dtype, "mma"))
    bwd_fn = getattr(lib_bwd, sa._entry("bwd", q.dtype, "mma"))
    chunk_len, chunks = sa._mma_chunks(q.shape[1], k.shape[1], q.shape[2],
                                       spec.block_q, k.numel())
    if chunk_steps is not None:
        chunk_len = max(1, chunk_steps // -(-spec.block_q // 16))
        longest = q.shape[1] // k.shape[1] * -(-q.shape[2] // spec.block_q)
        chunks = -(-longest // chunk_len)
    scratch = (torch.empty(2 * chunks * k.numel(), dtype=torch.float32,
                           device=q.device) if chunks > 1 else None)

    def fwd():
        _build.check(fwd_fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o_out.data_ptr(),
            lse_out.data_ptr(), kv_list.data_ptr(), kv_count.data_ptr(),
            *shape, kv_list.shape[1], code, stream), "fwd")
        return o_out, lse_out

    def bwd():
        _build.check(bwd_fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), *(g.data_ptr() for g in grads),
            kv_list.data_ptr(), kv_count.data_ptr(), q_list.data_ptr(),
            q_count.data_ptr(), *shape, kv_list.shape[1], q_list.shape[1],
            code, stream, fa._ptr(scratch), chunk_len, chunks), "bwd")
        return grads
    bwd.scratch = scratch
    return fwd, bwd


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--cases", default="o,p,q,r")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sparse_mma_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    names = args.variants.split(",")
    # a variant with other arguments runs the unedited build
    builds = sorted({n if VARIANTS[n] or n not in CHUNK_STEPS else "kernel"
                     for n in names})
    with ThreadPoolExecutor(len(builds)) as pool:
        built = dict(pool.map(build, builds))
    for n in names:
        if n not in built:
            built[n] = built["kernel"]
    libs, regs = {}, {}
    for variant, per in built.items():
        libs[variant] = {}
        for name, (so, log) in per.items():
            lib = ctypes.CDLL(str(so))
            (sa._declare_fwd if name == "sparse_fwd" else sa._declare_bwd)(lib)
            libs[variant][name] = lib
            regs.update({f"{variant}:{fn}": r for fn, r in
                         cs.ptxas_entries(log).items() if "mma" in fn})
    for fn, (r, spill) in sorted(regs.items()):
        print(f"[ptxas] {fn}: {r} registers, {spill} spill bytes", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(cs.SEED)
    timer = cs.Timer(dev)
    out = dict(card=torch.cuda.get_device_name(0), registers=regs, cases={})
    for key in args.cases.split(","):
        call, ref = case(gen, dev, key)
        rec = out["cases"][key] = {}
        for variant in names:
            fwd, bwd = launchers(libs[variant]["sparse_fwd"],
                                 libs[variant]["sparse_bwd"], call,
                                 CHUNK_STEPS.get(variant))
            r = dict(fwd_ms=timer(fwd), bwd_ms=timer(bwd),
                     kernel_ms=cs.sparse_kernel_ms(fwd, bwd))
            got = [*fwd(), *bwd()]
            torch.cuda.synchronize()
            err, ok = {}, True
            for n, g, w in zip(("o", "lse", "dq", "dk", "dv"), got, ref):
                seen = torch.isfinite(w) & (w > -1e30)
                d = (g[seen].float() - w[seen].float()).abs()
                rtol, atol = ((cs.LSE_TOL, cs.LSE_TOL) if n == "lse"
                              else cs.kernel_tol(call[0].dtype, w))
                err[n] = float(d.max()) if d.numel() else 0.0
                ok &= bool((d <= atol + rtol * w[seen].float().abs()).all())
            r.update(max_abs_err=err, within_limit=ok)
            rec[variant] = r
            print(f"[{key}] {variant}: " + json.dumps(r), flush=True)
        del call, ref
        torch.cuda.empty_cache()
    cs.OUT_DIR.mkdir(exist_ok=True)
    (cs.OUT_DIR / "sparse_mma_variants.json").write_text(
        json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
