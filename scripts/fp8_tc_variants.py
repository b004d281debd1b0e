"""Design readings of the 8-bit forward's tensor-core kernel at head dim
256 on one NVIDIA GPU: variants built from edited copies of
``csrc/flash_fwd_fp8.cu``, and an A/B of the D <= 128 cases against another
checkout.

    python3 scripts/fp8_tc_variants.py [--parent DIR] [--ab-cases a,b,...]
                                       [--variants a,b,...]

Cases: chip_smoke's fp8 case (h), int8 (1, 8, 8192, 256) causal (PERF.md
row 6w), and (i), Gemma 2B's MQA (1, 8/1, 4096, 256) in e4m3. Variants,
each built with its D = 256 instances alone, with the ptxas registers and
spill bytes of each:

- ``kernel``: the source as it is;
- ``fold``: acc += pv * sv at D = 256 too, the plain version's order, with
  P·V in two n128 column halves, each into a fresh 64-register fragment
  folded at once, and 32-key tiles for every format;
- ``fold_n64``: the same in four n64 chunks (32-register fragments);
- ``fold_r240``: ``fold`` at 24 / 240 registers (producer / consumers);
- ``r240``: the kernel at 24 / 240 registers;
- ``keys32``: int8 on 32-key tiles (e4m3 and e5m2 have them);
- ``stages3``: int8 on a three-stage ring (e4m3 and e5m2: no room);
- ``sub64``: int8's S of a whole 64-key tile at once, not in two 32-key
  halves; ``sub64_r240`` the same at 24 / 240 registers;
- ``nooverlap``: each half's P·V waited for before the next half's S;
- ``i2f``: int8 decoded through I2F, not the byte permute;
- ``nodecode`` (a diagnostic, wrong numbers): the decoders signal their
  K and V tiles without decoding them;
- ``nopass0`` (a diagnostic): pass 0 waits for its tiles and computes
  nothing;
- ``nopv`` (a diagnostic): no P·V products.

Each variant's ms (chip_smoke's Timer: CUDA events, median of 30, L2
flushed) and, but for the diagnostics, its largest error against the plain
version with the verdict of chip_smoke's limits. With ``--parent DIR``, fp8
cases (a)-(g) (D <= 128), or the chip_smoke fp8 cases ``--ab-cases`` names,
on this checkout's kernel and on DIR's (a tree whose entries take this
one's arguments), in turns A, B, B, A on the same inputs. Variants build
with nvcc into ``flashattention_tpu_torch/_build/ab/`` (all at once) from
exact text edits; the script stops if one no longer applies. Prints the
card's name and power limit, then one JSON line; writes
``chiprun_out/fp8_tc_variants.json``. Exits nonzero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from flashattention_tpu_torch import _build  # noqa: E402
from flashattention_tpu_torch.ops import fp8_attn as f8  # noqa: E402

AB_DIR = _build.BUILD_DIR / "ab"
SRC = "flash_fwd_fp8.cu"


class Edit:
    """Exact text edits of the kernel source; each must match once."""

    def __init__(self, src):
        self.s = src

    def __call__(self, old, new):
        n = self.s.count(old)
        if n != 1:
            raise SystemExit(f"fp8_tc_variants: an edit matches {n} times: "
                             f"{old[:70]!r}")
        self.s = self.s.replace(old, new)
        return self


def d256_only(e):
    """No FMA kernels and no D <= 128 instances: a quicker build."""
    e("    err = by_fmt<__nv_bfloat16>(fmt, a, f, o, l, st);",
      "    err = cudaErrorInvalidValue;")
    e("    err = by_fmt<float>(fmt, a, f, o, l, st);",
      "    err = cudaErrorInvalidValue;")
    e("    err = sm90::fp8_sm90_by_fmt<64>(fmt, a, f, o, out_dtype, l, st);",
      "    err = cudaErrorInvalidValue;")
    e("    err = sm90::fp8_sm90_by_fmt<128>(fmt, a, f, o, out_dtype, l, st);",
      "    err = cudaErrorInvalidValue;")
    return e


KEYS = "  static constexpr int KEYS = DP > 128 && kDecQK ? 32 : 64;"
IN_PLACE_PV = """#pragma unroll
          for (int kk = sub * SUB / 16; kk < (sub + 1) * SUB / 16; ++kk) {
            wgmma_rs<DP>(acc, pa[kk], desc_mn<KEYS>(vt, kk));
          }
          wgmma_commit();
"""
FOLD = """        float pv[DP / 2];  // P·V of this tile, before its v scale
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
"""
FOLD_CHUNKED = """        constexpr int PVN = DP > 128 ? {pvn} : DP;  // columns a product
        const uint64_t lbo16 = (KEYS * 128) >> 4;  // LBO in 16-byte units
        mbar_wait(&v_dec[s], (w / STAGES) & 1);
#pragma unroll
        for (int c = 0; c < DP / PVN; ++c) {{
          float pv[PVN / 2];  // before its v scale
#pragma unroll
          for (int k = 0; k < PVN / 2; ++k) pv[k] = 0.f;
          wgmma_fence();
          fence_regs(pv);
#pragma unroll
          for (int kk = 0; kk < KEYS / 16; ++kk) {{
            wgmma_rs<PVN>(pv, pa[kk],
                          desc_mn<KEYS>(vt, kk) + (PVN / 64) * c * lbo16);
          }}
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(pv);
#pragma unroll
          for (int k = 0; k < PVN / 2; ++k) {{
            acc[c * PVN / 2 + k] = fmaf(pv[k], S8 ? pfold[(k >> 1) & 1] : svt,
                                        acc[c * PVN / 2 + k]);
          }}
        }}
        mbar_arrive(&empty[s]);
"""


def keys32(e):
    return e(KEYS, "  static constexpr int KEYS = DP > 128 ? 32 : 64;")


def fold(e, pvn=128):
    """acc += pv * sv at D = 256 too (the plain version's order), P·V in
    column chunks of pvn, each into a fresh fragment folded at once, with
    32-key tiles."""
    keys32(e)
    e("  static constexpr bool kFold = DP <= 128;",
      "  static constexpr bool kFold = true;")
    return e(FOLD, FOLD_CHUNKED.format(pvn=pvn))


def fold_n64(e):
    return fold(e, 64)


def r240(e):
    e("constexpr int kFp8ProducerRegs = 40;",
      "constexpr int kFp8ProducerRegs = 24;")
    return e("constexpr int kFp8ConsumerRegs = 232;",
             "constexpr int kFp8ConsumerRegs = 240;")


def fold_r240(e):
    return r240(fold(e))


def stages3(e):
    return e("  static constexpr int STAGES = 2;",
             "  static constexpr int STAGES = DP > 128 && !kDecQK ? 3 : 2;")


def sub64(e):
    """int8's S of a whole 64-key tile at once."""
    return e("  static constexpr int SUB = DP > 128 ? 32 : KEYS;",
             "  static constexpr int SUB = KEYS;")


def sub64_r240(e):
    return r240(sub64(e))


def nooverlap(e):
    """Each part's P·V waited for before the next part's S."""
    return e(IN_PLACE_PV, IN_PLACE_PV + "          wgmma_wait<0>();\n")


def i2f(e):
    """int8 decoded through I2F, as the first version (an edit of
    fp8_sm90.cuh, which this variant includes as its own copy)."""
    return e('#include "fp8_sm90.cuh"', '#include "fp8_sm90_i2f.cuh"')


def i2f_header(h):
    """The header of ``i2f``."""
    return Edit(h)("""      const uint32_t u = w ^ 0x80808080u;
      f = make_float2(
          __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | (2 * j))) -
              8388736.f,
          __uint_as_float(
              __byte_perm(u, 0x4B000000u, 0x7540u | (2 * j + 1))) -
              8388736.f);""", """      f = make_float2((float)(int8_t)(pair & 0xffu),
                      (float)(int8_t)((pair >> 8) & 0xffu));""")


def nodecode(e):
    e("""          decode_tile<FMT, KEYS, DP>(k_s + s * Cfg::T_BYTES,
                                     kb_s + s * Cfg::KB_BYTES, tid, kDecoders);
""", "")
    return e("""          decode_tile<FMT, KEYS, DP>(vr_s + s * Cfg::T_BYTES,
                                     vb_s + s * Cfg::VB_BYTES, tid, kDecoders);
""", "")


def nopass0(e):
    return e("""    for (int w = 0; w < walk.n_walk; ++w) {
#pragma unroll
      for (int sub = 0; sub < KEYS / SUB; ++sub) {
        float sc[SUB / 2];
        scores(w, sub, sc, m, mk, true);
      }
      mbar_arrive(&empty[w % STAGES]);
""", """    for (int w = 0; w < walk.n_walk; ++w) {
      {
        const int s = w % STAGES;
        mbar_wait(kDecQK ? &k_dec[s] : &k_full[s], (w / STAGES) & 1);
      }
      mbar_arrive(&empty[w % STAGES]);
      m[0] = m[1] = 0.f;
""")


def nopv(e):
    return e(IN_PLACE_PV, "")


VARIANTS = {"kernel": None, "fold": fold, "fold_n64": fold_n64,
            "fold_r240": fold_r240, "r240": r240, "keys32": keys32,
            "stages3": stages3, "sub64": sub64, "sub64_r240": sub64_r240,
            "nooverlap": nooverlap, "i2f": i2f, "nodecode": nodecode,
            "nopass0": nopass0, "nopv": nopv}
DIAGNOSTIC = {"nodecode", "nopass0", "nopv"}
# they change the int8 kernel alone
INT8_ONLY = {"keys32", "stages3", "sub64", "sub64_r240", "nooverlap", "i2f"}


def _nvcc(name, src_dir):
    out = AB_DIR / f"lib{name}.so"
    p = subprocess.run([_build._nvcc()] + _build.NVCC_FLAGS + [
        "-o", str(out), str(src_dir / f"{name}.cu")],
        capture_output=True, text=True, timeout=900)
    if p.returncode:  # reported, and the variant left out
        return name, None, {"build_failed": (p.stdout + p.stderr)[-3000:]}
    lib = ctypes.CDLL(str(out))
    f8._declare(lib)
    regs = {fn: v for fn, v in cs.ptxas_entries(p.stderr).items()
            if "sm90" in fn}
    regs["warnings"] = sorted({line.strip() for line in p.stderr.splitlines()
                               if "warning" in line})
    return name, lib, regs


def build(parent: Path | None, names):
    """{name: (library, {kernel: [registers, spill bytes]})} of the
    variants ``names``."""
    AB_DIR.mkdir(parents=True, exist_ok=True)
    for h in _build.CSRC_DIR.glob("*.cuh"):
        shutil.copy(h, AB_DIR / h.name)
    src = (_build.CSRC_DIR / SRC).read_text()
    header = (_build.CSRC_DIR / "fp8_sm90.cuh").read_text()
    (AB_DIR / "fp8_sm90_i2f.cuh").write_text(i2f_header(header).s)
    for name in names:
        fn = VARIANTS[name]
        e = d256_only(Edit(src))
        if fn is not None:
            fn(e)
        (AB_DIR / f"{name}.cu").write_text(e.s)
    jobs = [(name, AB_DIR) for name in names]
    if parent is not None:  # the other checkout's sources, as they are
        pdir = AB_DIR / "parent"
        pdir.mkdir(exist_ok=True)
        for f in (parent / "flashattention_tpu_torch" / "csrc").glob("*.cu*"):
            shutil.copy(f, pdir / f.name)
        shutil.copy(pdir / SRC, pdir / "parent.cu")
        jobs.append(("parent", pdir))
    with ThreadPoolExecutor(min(len(jobs), 6)) as pool:
        done = list(pool.map(lambda j: _nvcc(*j), jobs))
    return {name: (lib, regs) for name, lib, regs in done}


def case_args(gen, dev, key):
    """fp8 case ``key``'s quantized inputs, as chip_smoke's fp8_case makes
    them: (args of fp8_fwd, int8_pv)."""
    _, shape, kw, extras = cs.FP8_CASES[key]
    b, h, h_kv, n, d = shape
    q, k, v, _, _, more = cs._flash_inputs(gen, dev, (b, h, h_kv, n, n, d),
                                           cs.BF16, extras)
    kw = dict(kw)
    fmt, int8_pv = kw.pop("fmt", "fp8"), kw.pop("int8_pv", "bf16")
    kw.pop("mode", None)
    opts = cs.fa.make_opts(q, k, **kw, **more)
    q8, k8, v8, sq, sk, sv, bq, bk = f8.quantize_inputs(
        q, k, v, f8.FP8_KERNEL_BLOCK_Q, f8.FP8_KERNEL_BLOCK_K, fmt)
    return (q8, k8, v8, sq, sk, sv, bq, bk, opts), int8_pv


def on(lib, args, int8_pv):
    """fp8_fwd's call on ``lib`` (a callable for the timer)."""
    def call():
        with mock.patch.object(f8._build, "load_kernel",
                               lambda name, declare: lib):
            return f8.fp8_fwd(*args, int8_pv=int8_pv, out_dtype=cs.BF16)
    return call


def errors(out, ref):
    """(largest |o - plain|, largest |lse - plain|, within the limits)."""
    (o, lse), (o_ref, lse_ref) = out, ref
    rtol, atol = cs.kernel_tol(cs.BF16, o_ref)
    do = (o.float() - o_ref.float()).abs()
    dl = (lse - lse_ref).abs()
    ok = bool((do <= atol + rtol * o_ref.float().abs()).all()) and bool(
        (dl <= cs.LSE_TOL + cs.LSE_TOL * lse_ref.abs()).all())
    return float(do.max()), float(dl.max()), ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout for the D <= 128 A/B")
    ap.add_argument("--ab-cases", default="a,b,c,d,e,f,g",
                    help="chip_smoke FP8_CASES keys of the --parent A/B "
                         "(default: the D <= 128 cases a-g)")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated variants (default: all)")
    args = ap.parse_args()
    names = args.variants.split(",")
    for name in names:
        if name not in VARIANTS:
            ap.error(f"no variant {name!r}; there are {', '.join(VARIANTS)}")
    if not torch.cuda.is_available():
        print("fp8_tc_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    parent = None if args.parent is None else args.parent.resolve()
    with ThreadPoolExecutor(2) as pool:  # this checkout's full library too
        base = pool.submit(_build.load_kernel, "flash_fwd_fp8", f8._declare)
        libs = build(parent, names)
        change = base.result()
    gen = torch.Generator().manual_seed(cs.SEED)
    timer = cs.Timer(dev)
    out = {"registers_spills": {n: r for n, (_, r) in libs.items()
                                if n != "parent"}}
    for key in ("h", "i"):
        a, pv = case_args(gen, dev, key)
        ref = f8.fp8_fwd_plain(*a, int8_pv=pv, out_dtype=cs.BF16)
        rec = {}
        for name, (lib, _) in libs.items():
            if name == "parent" or lib is None:
                continue
            if name in INT8_ONLY and key != "h":
                continue
            call = on(lib, a, pv)
            r = dict(ms=timer(call))
            if name not in DIAGNOSTIC:
                r["err_o"], r["err_lse"], r["ok"] = errors(call(), ref)
            rec[name] = r
            print(f"[{key}] {name}: {r}", flush=True)
        out[key] = rec
        del ref
        torch.cuda.empty_cache()
    if parent is not None and libs["parent"][0] is not None:
        # D <= 128, turns parent, change, change, parent
        ab = {}
        for key in args.ab_cases.split(","):
            a, pv = case_args(gen, dev, key)
            turns = [timer(on(lib, a, pv)) for lib in
                     (libs["parent"][0], change, change, libs["parent"][0])]
            ab[key] = dict(parent_ms=turns[::3], change_ms=turns[1:3],
                           ratio=sum(turns[1:3]) / (turns[0] + turns[3]))
            print(f"[ab] {key}: {ab[key]}", flush=True)
            torch.cuda.empty_cache()
        out["ab_d128"] = dict(tree=str(parent), cases=ab)
    cs.OUT_DIR.mkdir(exist_ok=True)
    (cs.OUT_DIR / "fp8_tc_variants.json").write_text(json.dumps(out,
                                                                default=str))
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
