"""Design readings of the fp32 block-sparse kernels (3xTF32 wgmma, D <=
256) on one NVIDIA GPU: variants built from edited copies of
``csrc/sparse_fwd.cu`` and ``csrc/sparse_bwd.cu``, or run with other
arguments.

    python3 scripts/sparse_f32_variants.py [--variants a,b,...] [--cases i,c,j]

Cases: chip_smoke's sparse cases (i) (phase 7d's call, (2, 12, 4096, 64)
causal, local + global on tiles of 128), (c) (GQA 12/4, N = 1000, blocks of
64) and (j) (D = 128, GQA 8/2, N_q 384 != N_k 512, blocks 64 x 128); and
at D = 256 on the wide kernels (k) (GQA 8/2, N = 1024), (l) (phase 7e's
MQA call, (1, 8, 1, 4096, 4096, 256)) and (m) (D = 136, GQA 8/2, N_q 384
!= N_k 512). Variants, with the ptxas registers and spill bytes of each
fp32 kernel:

- ``kernel``: the sources as they are;
- ``prefetch``: the producer thread asks L2 for a step's tiles
  (``tma_prefetch32``) before it waits for their stage to empty, in all
  three D <= 128 fp32 kernels;
- ``noprep`` (a diagnostic, wrong numbers): warps 1-3 of the loading
  warpgroup signal each landed tile without splitting or transposing it
  (the resident operands are still split once), D <= 128;
- ``noprep_wide`` (a diagnostic, wrong numbers): the same in the wide
  forward (no split of K, no transposed split of V);
- ``split1``: the sources as they are, the wide backward's dK/dV kernel
  run with one CTA a KV head's whole query-head group (``kv_splits`` 1,
  no partials to sum) instead of the wrapper's ``_kv_splits``;
- ``window_dkv`` (a diagnostic, wrong numbers): the wide dK/dV kernel
  walks at most 4 entries of its KV block's transposed list, so the
  global column's CTAs walk no more q blocks than a local block's (the
  local + global pattern's window is 4): the cost of that imbalance.

Each variant's forward and backward ms, kernels alone with the lists and
di built beforehand (chip_smoke's Timer: CUDA events, median of 30, L2
flushed), the backward's dK/dV and dQ ms (torch.profiler) and, but for
the diagnostics, the largest error against the plain version with the
verdict at chip_smoke's fp32 limit. Variants build with nvcc into
``flashattention_tpu_torch/_build/ab/`` (all at once) from exact text
edits; the script stops if one no longer applies. Prints the card's name
and power limit, then one JSON line; writes
``chiprun_out/sparse_f32_variants.json``. Exits nonzero without a card.
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
    """Exact text edits of one source; stops where one no longer applies."""

    def __init__(self, src):
        self.src = src

    def __call__(self, old, new):
        if self.src.count(old) != 1:
            raise SystemExit(f"sparse_f32_variants: an edit no longer "
                             f"applies ({self.src.count(old)} matches):\n{old}")
        self.src = self.src.replace(old, new)


def prefetch(name, e):
    if name == "sparse_fwd":
        e("""          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&landed[s], 2 * TB);
          tma_tile32<KEYS, DP>(st, &tk, &landed[s], c0, kplane);""",
          """          tma_prefetch32<KEYS, DP>(&tk, c0, kplane);
          tma_prefetch32<KEYS, DP>(&tv, c0, kplane);
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&landed[s], 2 * TB);
          tma_tile32<KEYS, DP>(st, &tk, &landed[s], c0, kplane);""")
        return
    e("""          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&landed[s], 2 * TB);
          tma_tile32<KEYS, DP>(st, &tk, &landed[s], c0, kplane);""",
      """          tma_prefetch32<KEYS, DP>(&tk, c0, kplane);
          tma_prefetch32<KEYS, DP>(&tv, c0, kplane);
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&landed[s], 2 * TB);
          tma_tile32<KEYS, DP>(st, &tk, &landed[s], c0, kplane);""")
    e("""            mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
            mbar_expect_tx(&landed[s], 2 * TB);
            tma_tile32<R, DP>(st, &tq, &landed[s], r0, plane);""",
      """            tma_prefetch32<R, DP>(&tq, r0, plane);
            tma_prefetch32<R, DP>(&tdo, r0, plane);
            mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
            mbar_expect_tx(&landed[s], 2 * TB);
            tma_tile32<R, DP>(st, &tq, &landed[s], r0, plane);""")


def noprep(name, e):
    if name == "sparse_fwd":
        e("""          split_tile(st, st, st + TB, TB, 1.f, tid, kPrepThreads);
          transpose_split<KEYS, DP>(st + 2 * TB, st + 3 * TB, st + 4 * TB,
                                    1.f, tid, kPrepThreads);
""", "")
        return
    e("""          transpose_split<KEYS, DP>(st, st + 4 * TB, st + 5 * TB, 1.f, tid,
                                    kPrepThreads);
          split_tile(st + 2 * TB, st + 2 * TB, st + 3 * TB, TB, 1.f, tid,
                     kPrepThreads);
          named_sync(1, kPrepThreads);
          split_tile(st, st, st + TB, TB, 1.f, tid, kPrepThreads);
""", "")
    e("""            transpose_split<R, DP>(st, tt, tt + TT, 1.f, tid, kPrepThreads);
            transpose_split<R, DP>(st + 2 * TB, tt + 2 * TT, tt + 3 * TT,
                                   1.f, tid, kPrepThreads);
            named_sync(1, kPrepThreads);
            split_tile(st, st, st + TB, TB, 1.f, tid, kPrepThreads);
            split_tile(st + 2 * TB, st + 2 * TB, st + 3 * TB, TB, 1.f, tid,
                       kPrepThreads);
""", "")


def noprep_wide(name, e):
    if name == "sparse_fwd":
        e("""          split_tile(kb, kb, ks, TB, 1.f, tid, kPrepThreads);
""", "")
        e("""          transpose_split<KEYS, DP>(vx, vtb, vts, 1.f, tid, kPrepThreads);
""", "")


def window_dkv(name, e):
    if name == "sparse_bwd":
        e("""  QTileWalk<R> walk{q_list + (size_t)ik * stride, q_count[ik], block_q, a.Nq,""",
          """  QTileWalk<R> walk{q_list + (size_t)ik * stride, min(q_count[ik], 4), block_q, a.Nq,""")


VARIANTS = {"kernel": None, "prefetch": prefetch, "noprep": noprep,
            "noprep_wide": noprep_wide, "split1": None,
            "window_dkv": window_dkv}
DIAGNOSTIC = {"noprep", "noprep_wide", "window_dkv"}
# variants that run the unedited kernels with other arguments: the wide
# backward's query-head splits
SPLITS = {"split1": 1}


def build(variant):
    """Both libraries of one variant; {source: (lib path, ptxas report)}."""
    out = {}
    for name in SOURCES:
        e = Edit((_build.CSRC_DIR / f"{name}.cu").read_text())
        if VARIANTS[variant]:
            VARIANTS[variant](name, e)
        d = AB / variant
        d.mkdir(parents=True, exist_ok=True)
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
    if dtype != torch.float32 or not sa._tensor_core_route(dtype, shape[-1],
                                                           spec):
        raise SystemExit(f"case {key} is not on the fp32 tensor-core route")
    o, lse = sa.sparse_fwd_plain(q, k, v, active, spec)
    di = (o.float() * do.float()).sum(-1)
    if dlse is not None:
        di = di - dlse
    ref = (o, lse, *sa.sparse_bwd_plain(q, k, v, do, lse, di, active, spec))
    return (q, k, v, do, o, lse, dlse, active, spec), ref


def launchers(lib_fwd, lib_bwd, args, splits=None):
    """(fwd, bwd) calls of the fp32 entries; each returns its outputs.
    ``splits``: the wide backward's query-head splits, where not the
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
    scratch, wrapper_splits = fa._wide_scratch(q, k)
    if splits is None or scratch is None:
        splits = wrapper_splits
    elif splits == 1:  # no partials: the operands' parts alone
        scratch = scratch[:4 * (q.numel() + k.numel())]

    def fwd():
        _build.check(lib_fwd.fat_sparse_fwd_sm90_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o_out.data_ptr(),
            lse_out.data_ptr(), kv_list.data_ptr(), kv_count.data_ptr(),
            *shape, kv_list.shape[1], 1, stream), "fwd")
        return o_out, lse_out

    def bwd():
        _build.check(lib_bwd.fat_sparse_bwd_sm90_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), *(g.data_ptr() for g in grads),
            kv_list.data_ptr(), kv_count.data_ptr(), q_list.data_ptr(),
            q_count.data_ptr(), *shape, kv_list.shape[1], q_list.shape[1], 1,
            stream, fa._ptr(scratch), splits), "bwd")
        return grads
    return fwd, bwd


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--cases", default="i,c,j")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sparse_f32_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    names = args.variants.split(",")
    # a variant with other arguments runs the unedited build
    builds = sorted({n if VARIANTS[n] or n not in SPLITS else "kernel"
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
                         cs.ptxas_entries(log).items() if "f32_" in fn})
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
                                 SPLITS.get(variant))
            r = dict(fwd_ms=timer(fwd), bwd_ms=timer(bwd),
                     kernel_ms=cs.sparse_kernel_ms(fwd, bwd))
            if variant not in DIAGNOSTIC:
                got = [*fwd(), *bwd()]
                torch.cuda.synchronize()
                err, ok = {}, True
                for n, g, w in zip(("o", "lse", "dq", "dk", "dv"), got, ref):
                    seen = torch.isfinite(w) & (w > -1e30)
                    d = (g[seen] - w[seen]).abs()
                    err[n] = float(d.max()) if d.numel() else 0.0
                    ok &= bool((d <= 1e-4 + 1e-4 * w[seen].abs()).all())
                r.update(max_abs_err=err, within_fp32_limit=ok)
            rec[variant] = r
            print(f"[{key}] {variant}: " + json.dumps(r), flush=True)
        del call, ref
        torch.cuda.empty_cache()
    cs.OUT_DIR.mkdir(exist_ok=True)
    (cs.OUT_DIR / "sparse_f32_variants.json").write_text(
        json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
