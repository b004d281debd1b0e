"""Phase 2's block-sparse cases on the tensor-core routes (default: (a),
(b), (d) and (g) of ``chip_smoke.SPARSE_CASES``, bf16; (i), (c) and (j) are
fp32 at D <= 128 on 3xTF32) for the package of one checkout, on one NVIDIA
GPU: the kernels alone (``fat_sparse_fwd_sm90[_f32]`` /
``fat_sparse_bwd_sm90[_f32]`` with the lists and di built beforehand, as
phase 2's "kernels alone"), printed as one JSON line of ms per case, after
the ptxas spill report of the two libraries, built anew.

    python3 scripts/sparse_ab.py                    # this checkout
    python3 scripts/sparse_ab.py --tree DIR         # another checkout
    python3 scripts/sparse_ab.py --cases a,g,i,c,j

With ``--tree`` this checkout's ``chip_smoke.py`` sets up the inputs and
times the ``flashattention_tpu_torch`` package of DIR, so two versions
compare on one card in turns A, B, B, A (the inputs come from one seed, so
both see the same). Exits nonzero without a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="checkout whose package is measured")
    ap.add_argument("--cases", default="a,b,d,g",
                    help="comma-separated keys of chip_smoke.SPARSE_CASES")
    args = ap.parse_args()
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    if not torch.cuda.is_available():
        print("sparse_ab: no CUDA device", file=sys.stderr)
        return 1
    from flashattention_tpu_torch import _build
    from flashattention_tpu_torch.ops import flash_attn as fa
    from flashattention_tpu_torch.ops import sparse_attn as sa

    libs = {}
    for name, declare in (("sparse_fwd", sa._declare_fwd),
                          ("sparse_bwd", sa._declare_bwd)):
        _build.kernel_path(name).unlink(missing_ok=True)
        libs[name] = _build.load_kernel(name, declare)
    spills = {fn: spill for name in libs for fn, (_, spill) in
              cs.ptxas_entries(_build.BUILD_LOG[name]).items() if spill}
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(cs.SEED)
    timer = cs.Timer(dev)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for key in args.cases.split(","):
        _, shape, dtype, causal, (bq, bk), pattern, use_dlse = \
            cs.SPARSE_CASES[key]
        q, k, v, do, dlse, _ = cs._flash_inputs(
            gen, dev, shape, dtype, ("dlse",) if use_dlse else ())
        sp = sa.SparseSpec(causal=causal, scale=shape[-1] ** -0.5,
                           block_q=bq, block_k=bk)
        active = sa.tile_pattern(pattern.to(dev), *pattern.shape, bq, bk,
                                 causal, shape[4] - shape[3])
        if not sa._tensor_core_route(dtype, shape[-1], sp):
            raise SystemExit(f"sparse_ab: case {key} is not on a "
                             f"tensor-core route")
        o, lse = sa.sparse_fwd(q, k, v, active, sp)
        di = (o.float() * do.float()).sum(-1)
        if dlse is not None:
            di = di - dlse
        kv_list, kv_count = sa.compact_rows(active)
        q_list, q_count = sa.compact_rows(active.t())
        o2, lse2 = torch.empty_like(o), torch.empty_like(lse)
        grads = [torch.empty_like(x) for x in (q, k, v)]
        shape_args = sa._shape_args(q, k, sp)
        code = fa._DTYPE_CODE[dtype]
        fwd_fn = getattr(libs["sparse_fwd"], sa._entry("fwd", dtype, "tc"))
        bwd_fn = getattr(libs["sparse_bwd"], sa._entry("bwd", dtype, "tc"))
        # an fp32 backward that takes a scratch and query-head splits last
        # (unused at D <= 128) gets them
        more = []
        if len(bwd_fn.argtypes) > 13 + len(shape_args) + 4:
            scratch, splits = fa._wide_scratch(q, k)
            more = [fa._ptr(scratch), splits]

        def run_fwd():
            _build.check(fwd_fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o2.data_ptr(),
                lse2.data_ptr(), kv_list.data_ptr(), kv_count.data_ptr(),
                *shape_args, kv_list.shape[1], code, stream), "sparse fwd")

        def run_bwd():
            _build.check(bwd_fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), di.data_ptr(), *(g.data_ptr() for g in grads),
                kv_list.data_ptr(), kv_count.data_ptr(), q_list.data_ptr(),
                q_count.data_ptr(), *shape_args, kv_list.shape[1],
                q_list.shape[1], code, stream, *more), "sparse bwd")

        out[key] = dict(fwd_kernel_ms=timer(run_fwd),
                        bwd_kernel_ms=timer(run_bwd))
        del q, k, v, do, o, lse, o2, lse2, grads
        torch.cuda.empty_cache()
    print(json.dumps(dict(tree=str(tree), spills=spills, cases=out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
