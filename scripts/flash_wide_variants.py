"""Readings of the flash backward above head dim 256 on one NVIDIA GPU: the
parent commit's chunked mma.sync kernels against the cluster kernels of
``csrc/flash_wide.cu``, in turns, at chip_smoke's wide flash cases (p)-(y).

    python3 scripts/flash_wide_variants.py --parent DIR [--variants a,b,...]
        [--cases p,q,...]

DIR holds the parent commit's tree (``git archive`` unpacked into a
git-ignored directory); its ``flashattention_tpu_torch/csrc/flash_wide.cu``
is the parent's source. Variants, each built with nvcc into
``flashattention_tpu_torch/_build/ab/`` (all at once) from exact text
edits of a copy (the script stops if an edit no longer applies), with the
ptxas registers and spill bytes of each backward kernel:

- ``parent``: the parent's flash_wide.cu as it is: dK/dV and dQ in chunks
  of 128 (bf16) or 64 (fp32) columns, one CTA a chunk, every chunk's CTA
  computing S and dP over all of D in 64-column segment items;
- ``noseg`` (a diagnostic, wrong numbers): the parent's kernels with the
  segment items (loads and products) of every chunk but the first
  skipped, so only chunk 0's CTAs compute the scores: parent less noseg is
  the share of the recompute;
- ``kernel``: this tree's flash_wide.cu as it is (the wrapper's plan,
  ``flash_attn._wide_bwd_plan``);
- ``split1``: the same sources with the dK/dV walk of a KV head in one
  cluster (kv_splits 1), where the plan splits it: the grid's share;
- ``noexch`` (a diagnostic, wrong numbers): no exchange, each CTA taking
  its own partial scores as the sums: the exchange's share.

Each variant's backward ms (chip_smoke's Timer: CUDA events, median of
30, L2 flushed) and the device ms of each of its kernels (dK/dV, dQ, the
sum of split partials; torch.profiler over 10 calls), and but for the
diagnostic its largest error against the plain version and the verdict at
chip_smoke's limits. The variants of a case run in the order given, then
again reversed (parent, kernel, kernel, parent), each reading recorded.
Prints the card's name and power limit, then one JSON line; writes
``chiprun_out/flash_wide_variants.json``. Exits nonzero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from flashattention_tpu_torch import _build  # noqa: E402
from flashattention_tpu_torch.ops import flash_attn as fa  # noqa: E402

AB = _build.BUILD_DIR / "ab"
SOURCE = "flashattention_tpu_torch/csrc/flash_wide.cu"
DIAGNOSTIC = ("noseg", "noexch")
CALLS = 10


class Edit:
    """Exact text edits of one source; stops where one no longer applies."""

    def __init__(self, src):
        self.src = src

    def __call__(self, old, new):
        if self.src.count(old) != 1:
            raise SystemExit(f"flash_wide_variants: an edit no longer "
                             f"applies ({self.src.count(old)} matches):\n{old}")
        self.src = self.src.replace(old, new)


def noseg(e):
    # dQ: the segment items' loads, then their products
    e("""    if (j < nseg) {
      const int d0 = j * kSeg;
      load_tile<T, kSeg>(st, RS, qg, kRowsF, a.Nq - r0, d0, D);""",
      """    if (j < nseg) {
      if (chunk > 0) return;
      const int d0 = j * kSeg;
      load_tile<T, kSeg>(st, RS, qg, kRowsF, a.Nq - r0, d0, D);""")
    e("""    if (j < nseg) {  // S += q_s . K^T, dP += dO . V^T over the segment
""", """    if (j < nseg) {  // S += q_s . K^T, dP += dO . V^T over the segment
      if (chunk > 0) continue;
""")
    # dK/dV
    e("""      const int d0 = j * kSeg;
      load_tile<T, kSeg>(st, RS, kg, kKeysB, a.Nk - c0, d0, D);""",
      """      if (chunk > 0) return;
      const int d0 = j * kSeg;
      load_tile<T, kSeg>(st, RS, kg, kKeysB, a.Nk - c0, d0, D);""")
    e("""    if (j < nseg) {  // S^T += K . q_s^T, dP^T += V . dO^T over the segment
""", """    if (j < nseg) {  // S^T += K . q_s^T, dP^T += V . dO^T over the segment
      if (chunk > 0) continue;
""")


def noexch(e):
    e("""    if (u > 0) wait_cluster(&freed[b], (u - 1) & 1);
""", "")
    e("""    wait_cluster(&ready[b], u & 1);
""", """    const int C = 1;  // this CTA's partials alone
""")
    for r in (0, 1):
        e(f"map_rank(region[b][{r}], s0 + j)",
          f"map_rank(region[b][{r}], cluster_rank())")


# variant: (source tree, edit); None: the parent's tree
VARIANTS = {"parent": (None, None), "noseg": (None, noseg),
            "kernel": (ROOT, None), "split1": (ROOT, None),
            "noexch": (ROOT, noexch)}


def build(variant, parent):
    tree, edit = VARIANTS[variant]
    src_dir = (tree or parent) / "flashattention_tpu_torch" / "csrc"
    e = Edit((src_dir / "flash_wide.cu").read_text())
    if edit:
        edit(e)
    d = AB / variant
    d.mkdir(parents=True, exist_ok=True)
    cu = d / "flash_wide.cu"
    cu.write_text(e.src)
    so = d / "libflash_wide.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src_dir), "-o",
         str(so), str(cu)], capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise SystemExit(f"{variant}: build failed\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(so))
    lib.fat_flash_bwd_wide.restype = ctypes.c_int
    args = [ctypes.c_void_p] * 12 + fa._scalar_argtypes()
    if tree is not None:  # this tree's entry takes the plan last
        args += [ctypes.c_void_p] + [ctypes.c_int] * 3
    lib.fat_flash_bwd_wide.argtypes = args
    return variant, (lib, proc.stderr)


def case(gen, dev, key):
    label, shape, dtype, kw, extras = cs.FLASH_CASES[key]
    q, k, v, do, dlse, more = cs._flash_inputs(gen, dev, shape, dtype, extras)
    opts = fa.make_opts(q, k, **kw, **more)
    o, lse = fa.flash_fwd_plain(q, k, v, opts)
    di = (o.float() * do.float()).sum(-1)
    if dlse is not None:
        di = di - dlse
    ref = fa.flash_bwd_plain(q, k, v, do, lse, di, opts)
    return label, (q, k, v, do, lse, di, opts), ref


def launcher(lib, variant, args):
    """The backward call of ``variant``'s entry; returns (dq, dk, dv)."""
    q, k, v, do, lse, di, opts = args
    grads = [torch.empty_like(x) for x in (q, k, v)]
    more = []
    if VARIANTS[variant][0] is not None:
        scratch, plan = fa._wide_bwd_scratch(q, k)
        splits = plan["kv_splits"]
        if variant == "split1":  # no partials: fp32's split operands alone
            splits = 1
            scratch = (scratch[:4 * (q.numel() + k.numel())]
                       if q.dtype == torch.float32 else None)
        more = [fa._ptr(scratch), plan["cluster"], plan["groups"], splits]

    def bwd():
        _build.check(lib.fat_flash_bwd_wide(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), *(g.data_ptr() for g in grads),
            fa._ptr(opts.q_ids), fa._ptr(opts.kv_ids), fa._ptr(opts.slopes),
            *fa._scalars(q, k, opts), *more), variant)
        return grads
    return bwd


def kernel_ms(bwd) -> dict[str, float]:
    """{kernel: mean device ms a call} over CALLS calls (torch.profiler)."""
    bwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            bwd()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        name = re.search(r"flash_\w+_kernel|kv_sum_kernel", e.key)
        if name:
            total = (e.device_time_total if hasattr(e, "device_time_total")
                     else e.cuda_time_total)
            out[name.group(0)] = total / e.count / 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--variants", default="parent,noseg,kernel,split1,noexch")
    ap.add_argument("--cases", default=",".join(cs.FLASH_WIDE))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_wide_variants: no CUDA device", file=sys.stderr)
        return 1
    if not (args.parent / SOURCE).exists():
        print(f"flash_wide_variants: no {SOURCE} under {args.parent}",
              file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    names = args.variants.split(",")
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(pool.map(lambda n: build(n, args.parent), names))
    regs = {}
    for variant, (_, log) in built.items():
        regs.update({f"{variant}:{fn}": r for fn, r in
                     cs.ptxas_entries(log).items() if "bwd" in fn})
    for fn, (r, spill) in sorted(regs.items()):
        print(f"[ptxas] {fn}: {r} registers, {spill} spill bytes", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(cs.SEED)
    timer = cs.Timer(dev)
    out = dict(card=torch.cuda.get_device_name(0), registers=regs, cases={})
    for key in args.cases.split(","):
        label, call, ref = case(gen, dev, key)
        rec = out["cases"][key] = dict(case=label, turns=[])
        dtype = call[0].dtype
        for variant in names + names[::-1]:
            bwd = launcher(built[variant][0], variant, call)
            r = dict(variant=variant, bwd_ms=timer(bwd),
                     kernel_ms=kernel_ms(bwd))
            if variant not in DIAGNOSTIC:
                got = bwd()
                torch.cuda.synchronize()
                err, ok = {}, True
                for n, g, w in zip(("dq", "dk", "dv"), got, ref):
                    rtol, atol = cs.kernel_tol(dtype, w)
                    d = (g.float() - w.float()).abs()
                    err[n] = float(d.max())
                    ok &= bool((d <= atol + rtol * w.float().abs()).all())
                r.update(max_abs_err=err, within_limit=ok)
            rec["turns"].append(r)
            print(f"[{key}] " + json.dumps(r), flush=True)
        del call, ref
        torch.cuda.empty_cache()
    cs.OUT_DIR.mkdir(exist_ok=True)
    (cs.OUT_DIR / "flash_wide_variants.json").write_text(
        json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
