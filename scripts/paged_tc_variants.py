"""Design readings of the split paged kernel's tensor-core walk on one
NVIDIA GPU: split sizes and ring stages, variants of the kernel built from
edited copies of ``csrc/paged_attention.cu``, and where a CTA's cycles go.

    python3 scripts/paged_tc_variants.py

Cases: Gemma 2B's MQA (8 query heads over 1 KV head, D = 256, page 16) at
the decode step (B = 32, lengths 256-4096) over bf16, e4m3 and int8 ("qk")
pages, a T = 64 chunk at length 2048 and the verify chunk (B = 32, T = 5);
GPT-3 Small's widths (12 heads, D = 64) at decode, GQA 12/4 decode, a T =
64 chunk at 448 and the verify chunk. Readings, each a call of the C entry
with the plan's other fields (CUDA events around the split and merge
kernels, median of 30, L2 flushed; the two kernels apart under
torch.profiler), held against the plain version:

- ``sweep``: D = 256 at 8- and 16-page splits and 2, 3 and 4 stages;
- ``walks``: D = 64 on the tensor cores at 4- and 8-page splits, and on
  the lane groups where they take the call (1 or 2 rows a KV head;
  ``scripts/paged_ab.py --tree`` times a tree whose lane groups take more);
- ``variants`` (D = 256, the plan's splits and stages): the kernel as it
  is; ``noload`` (no copy issued or waited for: the walk's arithmetic
  alone, on whatever shared memory holds); ``nocompute`` (copies, waits,
  decode and barriers, no products or softmax); ``slab`` (bf16 pages as two
  slab copies a page, rows D * 2 bytes apart: ldmatrix bank conflicts,
  32 fewer copies a page); ``producer`` (a fifth warp issues every copy as
  the consumer warps free stages, 160 threads a CTA);
- ``sections``: clock64 sections of warp 0's lane 0 in every CTA with a
  page (prologue to the page list, to the walk's first page, waits,
  products, the exchange barrier, softmax, P.V, the end-of-page barrier
  and refill, epilogue), cycles per CTA and per page.

Variants build with nvcc into ``flashattention_tpu_torch/_build/ab/``
(all at once); the variant sources are made by exact text edits and the
script stops if one no longer applies. Prints the card's name, power limit
and SM clock, and one JSON line; writes
``chiprun_out/paged_tc_variants.json``. Exits nonzero without a card.
"""

from __future__ import annotations

import ctypes
import json
import statistics
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
from flashattention_tpu_torch.bench import harness  # noqa: E402
from flashattention_tpu_torch.ops import paged_attention as pa  # noqa: E402

AB_DIR = _build.BUILD_DIR / "ab"


class Edit:
    """Exact text edits of the kernel source; each must match once."""

    def __init__(self, src):
        self.s = src

    def __call__(self, old, new):
        n = self.s.count(old)
        if n != 1:
            raise SystemExit(f"paged_tc_variants: an edit matches {n} "
                             f"times: {old[:70]!r}")
        self.s = self.s.replace(old, new)
        return self


def noload(src):
    e = Edit(src)
    e("  if (threadIdx.x == 0) {\n    for (int i = 0; i < min(n_items, "
      "a.stages); ++i) expect(i);\n  }\n  __syncthreads();\n  for (int i = "
      "0; i < min(n_items, a.stages); ++i) issue(i);\n", "")
    e("    mbar_wait(&full[st], (i / a.stages) & 1);\n    if (threadIdx.x == "
      "0 && i + a.stages < n_items) expect(i + a.stages);\n", "")
    e("          fat::sm90::fence_proxy_async();  // stage st is decoded: "
      "refill it\n          issue(i + a.stages);\n", "")
    e("        fat::sm90::fence_proxy_async();\n        issue(i + "
      "a.stages);\n", "")
    return e.s


def nocompute(src):
    i0 = src.index("      // This warp's partial S^T")
    i1 = src.index("    if constexpr (!kQuant) {\n      __syncthreads();  "
                   "// every warp is done with stage st")
    return src[:i0] + "      __syncthreads();\n    }\n" + src[i1:]


def slab(src):
    e = Edit(src)
    e("  const int rs = tc_row_bytes(D);\n  const int ksteps",
      "  const int rs = kQuant ? tc_row_bytes(D) : D * 2;\n  const int ksteps")
    e("""      const int row = D * 2;
      for (int j = lane * kWarps + warp; j < 2 * page; j += kSplitThreads) {
        const int kv = j / page, s = j % page;
        bulk_copy(dst + (size_t)j * rs,
                  (kv ? a.v_pages : a.k_pages) + (pg * page + s) * row, row,
                  &full[st]);
      }""", """      if (threadIdx.x < 2) {
        bulk_copy(dst + threadIdx.x * slab,
                  (threadIdx.x ? a.v_pages : a.k_pages) + pg * slab, slab,
                  &full[st]);
      }""")
    return e.s


def producer(src):
    e = Edit(src)
    e("""                                               uint64_t* full) {""",
      """                                               uint64_t* full,
                                               uint64_t* empty = nullptr,
                                               int empty_count = 0) {""")
    e("""    for (int s = 0; s < a.stages; ++s) mbar_init(&full[s], 1);
    fat::sm90::fence_barrier_init();""", """    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);
      if (empty != nullptr) mbar_init(&empty[s], empty_count);
    }
    fat::sm90::fence_barrier_init();""")
    e("""constexpr int tc_min_blocks(int nt, int mode, int kq) {
  return kq > kTcSteps ? 2
                       : (nt == 1 ? 4 : (nt == 2 ? (mode == 2 ? 2 : 3) : 2));
}""", """constexpr int kTcThreads = kSplitThreads + 32;
constexpr int tc_min_blocks(int nt, int mode, int kq) {
  return kq > kTcSteps ? 1 : (nt == 1 ? 3 : (nt == 2 ? 2 : 1));
}""")
    e("""__global__ void __launch_bounds__(kSplitThreads, tc_min_blocks(NT, MODE, KQ))
paged_split_tc_kernel(const SplitArgs a) {
  constexpr bool kQuant = FMT != 0;
  constexpr int kRows = kTcRows * NT;
  extern __shared__ __align__(128) char ring[];
  __shared__ uint64_t full[kMaxStages];""", """__global__ void __launch_bounds__(kTcThreads, tc_min_blocks(NT, MODE, KQ))
paged_split_tc_kernel(const SplitArgs a) {
  constexpr bool kQuant = FMT != 0;
  constexpr int kRows = kTcRows * NT;
  extern __shared__ __align__(128) char ring[];
  __shared__ uint64_t full[kMaxStages], empty[kMaxStages];""")
    e("""    for (int rr = warp; rr < kRows; rr += kWarps) {""",
      """    for (int rr = warp; warp < kWarps && rr < kRows; rr += kWarps) {""")
    e("""  const int n = split_page_list(a, walk, b, split, list_lg, list_ph, &n_list,
                                full);
  const int n_items""", """  const int n = split_page_list(a, walk, b, split, list_lg, list_ph, &n_list,
                                full, empty, kWarps);
  const int n_items""")
    i = e.s.index("  // Page i into its stage: thread 0 announces its bytes")
    j = e.s.index("  // q fragments: lane (g, tq) holds row g of each tile")
    e.s = e.s[:i] + """  if (warp == kWarps) {
    for (int i = 0; i < n; ++i) {
      const int st = i % a.stages;
      if (i >= a.stages) {
        mbar_wait(&empty[st], (i / a.stages - 1) & 1);
        fat::sm90::fence_proxy_async();
      }
      if (lane == 0) {
        mbar_expect_tx(&full[st], kQuant ? stage_bytes : 2 * slab);
      }
      __syncwarp();
      char* dst = ring + st * stage_bytes;
      const size_t pg = (size_t)hk * a.num_pages + list_ph[i];
      if constexpr (kQuant) {
        if (lane < 4) {
          const char* src[4] = {
              a.k_pages + pg * slab, a.v_pages + pg * slab,
              reinterpret_cast<const char*>(a.k_scales + pg * page),
              reinterpret_cast<const char*>(a.v_scales + pg * page)};
          bulk_copy(dst + (lane < 2 ? lane * slab
                                    : 2 * slab + (lane - 2) * 4 * page),
                    src[lane], lane < 2 ? slab : 4 * page, &full[st]);
        }
      } else {
        const int row = D * 2;
        for (int j = lane; j < 2 * page; j += 32) {
          const int kv = j / page, s = j % page;
          bulk_copy(dst + (size_t)j * rs,
                    (kv ? a.v_pages : a.k_pages) + (pg * page + s) * row,
                    row, &full[st]);
        }
      }
    }
    return;
  }

""" + e.s[j:]
    e("""    mbar_wait(&full[st], (i / a.stages) & 1);
    if (threadIdx.x == 0 && i + a.stages < n_items) expect(i + a.stages);
""", """    mbar_wait(&full[st], (i / a.stages) & 1);
""")
    e("""        __syncthreads();
        if (s0 + kTcSlots >= page && i + a.stages < n_items) {
          fat::sm90::fence_proxy_async();  // stage st is decoded: refill it
          issue(i + a.stages);
        }""", """        fat::sm90::named_sync(1, kSplitThreads);
        if (s0 + kTcSlots >= page && lane == 0) {
          fat::sm90::mbar_arrive(&empty[st]);
        }""")
    e("""              make_float4(sacc[nt][0], sacc[nt][1], sacc[nt][2], sacc[nt][3]);
        }
      }
      __syncthreads();
""", """              make_float4(sacc[nt][0], sacc[nt][1], sacc[nt][2], sacc[nt][3]);
        }
      }
      fat::sm90::named_sync(1, kSplitThreads);
""")
    e("""    if constexpr (!kQuant) {
      __syncthreads();  // every warp is done with stage st
      if (i + a.stages < n) {
        fat::sm90::fence_proxy_async();
        issue(i + a.stages);
      }
    }""", """    if constexpr (!kQuant) {
      __syncwarp();
      if (lane == 0) fat::sm90::mbar_arrive(&empty[st]);
    }""")
    e("""    kernel<<<grid, kSplitThreads, smem, st>>>(a);""",
      """    kernel<<<grid, walk == 1 ? kTcThreads : kSplitThreads, smem, st>>>(a);""")
    return e.s


SECTIONS = ["prologue", "to_walk", "wait", "qk", "exchange", "softmax", "pv",
            "end", "epilogue"]


def sections(src):
    """clock64 sections of warp 0 lane 0, 10 int64 a CTA past the
    partials: the SECTIONS, then the CTA's page count."""
    k0 = src.index("paged_split_tc_kernel(const SplitArgs a) {")
    e = Edit(src[k0:])
    e("  constexpr int kRows = kTcRows * NT;\n",
      "  constexpr int kRows = kTcRows * NT;\n"
      "  long long t0_ = clock64(), c_[10] = {0}, tt_;\n")
    e("                                full);\n  const int n_items",
      "                                full);\n  long long t1_ = clock64();\n"
      "  c_[0] = t1_ - t0_;\n  const int n_items")
    e("  int tile = 0;", "  long long t2_ = clock64();\n  c_[1] = t2_ - t1_;\n"
      "  int tile = 0;")
    e("    mbar_wait(&full[st], (i / a.stages) & 1);\n",
      "    tt_ = clock64();\n    mbar_wait(&full[st], (i / a.stages) & 1);\n"
      "    c_[2] += clock64() - tt_;\n")
    e("      // the warp's K fragments first",
      "      tt_ = clock64();\n      // the warp's K fragments first")
    e("      float4* sb = sbuf + par",
      "      c_[3] += clock64() - tt_;\n      tt_ = clock64();\n"
      "      float4* sb = sbuf + par")
    e("      __syncthreads();\n\n      // The tile's scores",
      "      __syncthreads();\n      c_[4] += clock64() - tt_;\n"
      "      tt_ = clock64();\n\n      // The tile's scores")
    e("      if constexpr (MODE != 2) pv_product(pb);",
      "      c_[5] += clock64() - tt_;\n      tt_ = clock64();\n"
      "      if constexpr (MODE != 2) pv_product(pb);")
    e("    }\n    if constexpr (!kQuant) {\n      __syncthreads();  // every "
      "warp is done", "      c_[6] += clock64() - tt_;\n    }\n"
      "    tt_ = clock64();\n    if constexpr (!kQuant) {\n"
      "      __syncthreads();  // every warp is done")
    e("  }\n\n  // The split's partials: m",
      "    c_[7] += clock64() - tt_;\n  }\n  long long t3_ = clock64();\n\n"
      "  // The split's partials: m")
    e("    }\n  }\n}\n\ntemplate <int FMT, int MODE>\ncudaError_t "
      "launch_split(", "    }\n  }\n  c_[8] = clock64() - t3_;\n  c_[9] = n;\n"
      "  if (threadIdx.x == 0) {\n    long long* dbg_ = reinterpret_cast<long "
      "long*>(a.part + (size_t)a.n_splits * a.B * a.H_kv * R * (D + 2)) + "
      "((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 10;\n"
      "    for (int k = 0; k < 10; ++k) dbg_[k] = c_[k];\n  }\n}\n\n"
      "template <int FMT, int MODE>\ncudaError_t launch_split(")
    return src[:k0] + e.s


VARIANTS = {"noload": noload, "nocompute": nocompute, "slab": slab,
            "producer": producer, "sections": sections}


def build_variants():
    AB_DIR.mkdir(parents=True, exist_ok=True)
    for h in _build.CSRC_DIR.glob("*.cuh"):
        (AB_DIR / h.name).write_text(h.read_text())
    src = (_build.CSRC_DIR / "paged_attention.cu").read_text()
    made = {name: fn(src) for name, fn in VARIANTS.items()}

    def one(name):
        (AB_DIR / f"{name}.cu").write_text(made[name])
        out = AB_DIR / f"lib{name}.so"
        p = subprocess.run([_build._nvcc()] + _build.NVCC_FLAGS + [
            "-o", str(out), str(AB_DIR / f"{name}.cu")],
            capture_output=True, text=True, timeout=900)
        if p.returncode:
            raise SystemExit(f"building {name} failed:\n{p.stderr[-3000:]}")
        lib = ctypes.CDLL(str(out))
        pa._declare(lib)
        return name, lib

    with ThreadPoolExecutor(len(made) + 1) as pool:
        base = pool.submit(_build.load_kernel, "paged_attention", pa._declare)
        libs = dict(pool.map(one, made))
        libs["kernel"] = base.result()
    return libs


def split_call(lib, args, kw, *, walk=None, split_pages=None, stages=None,
               extra=0):
    """A closure launching the C entry once (split and merge kernels) with
    ``split_plan``'s fields but those given; ``extra`` floats past the
    partials (the sections' counters)."""
    q, kp, vp, pi, ln = args
    qq = q[:, :, None] if q.dim() == 3 else q
    b, h, t, d = qq.shape
    h_kv, num_pages, page, _ = kp.shape
    pps = pi.shape[1]
    quant = "k_scales" in kw
    mode = pa.int8_mode(kp, q.dtype, t, None) if quant else "convert"
    pa.split_plan.cache_clear()
    rule = pa.split_walk
    with mock.patch.object(pa, "split_walk",
                           lambda d_, r_, m_: walk or rule(d_, r_, m_)):
        plan = pa.split_plan(h, h_kv, t, d, page, pps, quant, mode)
    pa.split_plan.cache_clear()
    sp = split_pages or plan["split_pages"]
    n_splits = -(-pps // sp)
    part = torch.zeros(n_splits * b * h * t * (d + 2) + extra,
                       dtype=torch.float32, device=q.device)
    out = torch.empty_like(qq)

    def call():
        err = lib.fat_paged_attention_split(
            qq.data_ptr(), kp.data_ptr(), vp.data_ptr(),
            kw["k_scales"].data_ptr() if quant else None,
            kw["v_scales"].data_ptr() if quant else None, pi.data_ptr(),
            ln.data_ptr(), part.data_ptr(), out.data_ptr(), b, h, h_kv, t, d,
            num_pages, page, pps, d ** -0.5, 0, 0, 0.0,
            pa._FMT_CODE.get(kp.dtype, 0), pa._MODE_CODE[mode], sp, n_splits,
            pa._WALK_CODE[plan["walk"]], plan["lg"], plan["rps"],
            plan["nrs"], stages or plan["stages"], plan["step_pages"],
            torch.cuda.current_stream().cuda_stream)
        _build.check(err, "paged_attention split launch")
        return out[:, :, 0] if q.dim() == 3 else out

    call.part, call.ctas = part, (b * h_kv * plan["row_groups"] * n_splits
                                  if plan["walk"] == "tc" else None)
    call.base = n_splits * b * h * t * (d + 2)
    return call


def kernel_ms(fn, n=5):
    """Device ms of one call's split kernel and merge kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {"split": 0.0, "merge": 0.0}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        for k in out:
            if f"paged_{k}_" in e.key:
                out[k] += us / n / 1e3
    return out


def measure(timer, fn, ref, turns):
    o = fn()
    torch.cuda.synchronize()
    err = float((o.float() - ref.float()).abs().max())
    if not torch.isfinite(o.float()).all() or err > 2e-2 * (
            1 + float(ref.float().abs().max())):
        raise SystemExit(f"paged_tc_variants: max |kernel - plain| {err}")
    turns.append(timer(fn))
    return err


def cases(gen, dev):
    gemma = dict(h=8, h_kv=1, d=256, page=16, max_len=4096)
    gpt = dict(h=12, h_kv=12, d=64, page=16, max_len=512)
    spec = {
        "d256_decode": (None, dict(b=32, q_len=0,
                                   lengths=cs.gemma_decode_lengths(gen)),
                        gemma),
        "d256_decode_fp8": ("fp8", dict(b=32, q_len=0,
                                        lengths=cs.gemma_decode_lengths(gen)),
                            gemma),
        "d256_decode_int8_qk": ("int8", dict(
            b=32, q_len=0, lengths=cs.gemma_decode_lengths(gen)), gemma),
        "d256_chunk": (None, dict(b=1, q_len=64, lengths=[2048]), gemma),
        "d256_verify": (None, dict(b=32, q_len=5, lengths=[
            n + 5 for n in cs.gemma_decode_lengths(gen)]), gemma),
        "d64_decode": (None, dict(b=32, q_len=0), gpt),
        "d64_gqa": (None, dict(b=32, q_len=0, h_kv=4), gpt),
        "d64_chunk": (None, dict(b=1, q_len=64, lengths=[448]), gpt),
        "d64_verify": (None, dict(b=32, q_len=5, lengths=(
            cs.verify_lengths(gen) + 5).tolist()), gpt),
    }
    out = {}
    for key, (quant, kw, widths) in spec.items():
        shape = dict(widths, **kw)
        q, kp, vp, pi, ln = cs._paged_inputs(
            gen, dev, torch.float32 if quant else torch.bfloat16, **shape)
        akw = {}
        if quant:
            q = q.bfloat16()
            kp, ks, vp, vs = cs.quantize_pages(kp, vp, quant)
            akw = dict(k_scales=ks, v_scales=vs)
        out[key] = ((q, kp, vp, pi, ln), akw)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("paged_tc_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    libs = build_variants()
    timer = cs.Timer(dev)
    flush = harness.l2_flush_buffer(dev)
    made = cases(torch.Generator().manual_seed(cs.SEED), dev)
    rec = dict(card=card, sweep={}, walks={}, variants={}, sections={})
    for key, (args, kw) in made.items():
        ref = pa.paged_attention_plain(*args, **kw)
        if key.startswith("d256"):
            runs = {f"split{sp}_stages{stg}": dict(
                lib=libs["kernel"], split_pages=sp, stages=stg)
                for sp in (8, 16) for stg in (2, 3, 4)}
            table = rec["sweep"][key] = {}
        else:  # the lane groups take 1 or 2 rows a KV head
            q, kp = args[0], args[1]
            rows = q.shape[1] // kp.shape[0] * (1 if q.dim() == 3
                                                 else q.shape[2])
            runs = ({"lanes": dict(lib=libs["kernel"], walk="lanes")}
                    if rows <= 2 else {})
            runs.update({f"tc_split{sp}": dict(lib=libs["kernel"], walk="tc",
                                               split_pages=sp)
                         for sp in (4, 8)})
            table = rec["walks"][key] = {}
        if key.startswith("d256"):
            more = {"kernel": dict(lib=libs["kernel"])}
            more.update({v: dict(lib=libs[v]) for v in (
                "noload", "nocompute", "slab", "producer")
                if not (v == "slab" and "k_scales" in kw)})
            runs.update({f"variant_{k}": v for k, v in more.items()})
        order = list(runs)
        for turn in (order, order[::-1]):
            for name in turn:
                r = runs[name]
                fn = split_call(r["lib"], args, kw, walk=r.get("walk"),
                                split_pages=r.get("split_pages"),
                                stages=r.get("stages"))
                t = table.setdefault(name, dict(ms=[]))
                if name in ("variant_noload", "variant_nocompute"):
                    fn()  # cuts of the kernel: their outputs are not held
                    torch.cuda.synchronize()
                    t["ms"].append(timer(fn))
                else:
                    t["max_abs_err"] = measure(timer, fn, ref, t["ms"])
                if "kernels_ms" not in t:
                    t["kernels_ms"] = kernel_ms(fn)
        for name in [n for n in table if n.startswith("variant_")]:
            rec["variants"].setdefault(key, {})[name[8:]] = table.pop(name)
        print(key, json.dumps({k: (v["ms"], v["kernels_ms"])
                               for k, v in table.items()}), flush=True)
        if key.startswith("d256"):
            print(key, "variants", json.dumps(
                {k: (v["ms"], v["kernels_ms"])
                 for k, v in rec["variants"][key].items()}), flush=True)
        # clock64 sections of the plan's launch (one flushed launch)
        probe = split_call(libs["sections"], args, kw, extra=1 << 20,
                           walk="tc")
        flush.zero_()
        torch.cuda.synchronize()
        probe()
        torch.cuda.synchronize()
        dbg = probe.part[probe.base: probe.base + probe.ctas * 20].view(
            torch.int64).view(probe.ctas, 10).cpu().double()
        busy = dbg[dbg[:, 9] > 0]
        n = busy[:, 9]
        rec["sections"][key] = dict(
            ctas=probe.ctas, ctas_with_pages=int(len(busy)),
            pages_a_cta=float(n.mean()),
            cycles_a_cta=float(busy[:, :9].sum(1).mean()),
            **{s: float(busy[:, k].mean()) for k, s in enumerate(SECTIONS)},
            **{f"{s}_a_page": float((busy[:, k] / n).mean())
               for k, s in enumerate(SECTIONS) if 2 <= k <= 7})
        print(key, "sections", json.dumps(rec["sections"][key]), flush=True)
        torch.cuda.empty_cache()
    for table in (rec["sweep"], rec["walks"]):
        for runs in table.values():
            for t in runs.values():
                t["median_ms"] = statistics.median(t["ms"])
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "paged_tc_variants.json").write_text(
        json.dumps(rec, indent=1))
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
