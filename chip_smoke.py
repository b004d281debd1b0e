"""Smoke run of the PyTorch port (flashattention_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                  # on a machine with an H100
    python3 chip_smoke.py --cpu-rehearsal  # control flow only, tiny, on CPU

``scripts/profile_serving.py`` runs phase 3's and 3b's serving profile
alone, also against the package of another checkout (an A/B on one card).

Phases, in order; any failure exits nonzero:

1. Identify the card (nvidia-smi name and power limit) and build every CUDA
   kernel from ``flashattention_tpu_torch/csrc`` anew (one nvcc per source,
   all at once). The tensor-core kernels (flash: forward, dK/dV, dQ at D 64
   and 128; sparse: the same three at D 64 and 128, each with one and two
   consumer warpgroups; the 8-bit forward at D 64 and 128 in e4m3, e5m2
   and int8; 24 in all) must show HGMMA (wgmma) and UTMALDG (TMA) in their
   SASS (cuobjdump) and spill nothing (ptxas report of this build); the 15
   paged split kernels must show UBLKCP (1-D bulk copies) and spill
   nothing; the 20 append kernels must spill nothing, and those of 8
   elements a lane show 16-byte loads (LDG.E.128).
2. Each kernel against its plain PyTorch version on the card: the paged
   kernels at the serving engine's shapes, each case on the route the
   wrapper picks (the split walk for bf16 q over bf16 and 1-byte pages,
   convert and "qk"; two calls bit-equal) and, beside it, the first kernel
   on the same inputs (time and "issued from the host" time both); the flash forward and backward
   at the training shape with dropout (a) and without (a0) and seven more
   cases (the JAX headline's shape, GQA with window, sinks and soft-cap,
   segment ids with ALiBi, fp32, a nonzero LSE cotangent, rows with no
   visible key, fp32 with dropout, fp32 non-causal, segment ids with
   dropout), each launched once on the route it
   must take (bf16 with D <= 128: the tensor cores; else the FMA kernels;
   checked by the route counters). Max error against the stated tolerance
   (fp32 1e-4; bf16 flash two ulps, 1.6e-2 relative, plus 1e-3 of the
   largest value; bf16 paged 2e-2), then the kernel's, the plain version's
   and one library call's time (CUDA events, median over launches, L2
   flushed before each; SDPA is the library call where it computes the
   case's function, else a yardstick), beside the least time the card could
   take (bytes over 3.35 TB/s or operations over 989 TFLOP/s bf16, 67
   TFLOP/s fp32); the flash cases also time the call as issued from the
   host, and (a), (a0), (b) the FMA kernels on the same bf16 inputs. Quantized pages:
   int8 (int8-qk and convert), e4m3 and e5m2 at the engine's decode shape,
   an e4m3 chunk, and bf16 vs int8 vs e4m3 at scripts/bench_decode.py's
   shape (paged limit; yardstick SDPA over pre-gathered dequantized K/V,
   another function). The append (paged_append) in every page format
   (bf16, fp32, int8, e4m3, e5m2) at the engine's decode step (B=32, T=1)
   and at a prefill chunk (B=1, T=64), tokens as views of a fused QKV
   projection: bit-exact against the plain version outside the dump page,
   payloads and scales; the kernel's time, append_to_pages issued from the
   host, the plain version, index_put_ (bf16 and fp32 pages), the byte
   bound and the card's smallest launch (a one-element zero_, a floor and
   not a bound). The speculative engine's verify chunk (B=32 slots of T=5
   rows, lengths 33-505 and one slot at 508 whose rows pass the 512-slot
   capacity, one chunk across a page boundary): paged attention over bf16
   and e4m3 pages (paged limit) and the append into bf16 and e4m3 pages
   (bit-exact, the rows past capacity dropped), timed as above. The FA3 8-bit
   forward (flash_fwd_fp8) in seven cases, each launched once through
   fp8_attention on the route it must take (checked: the tensor cores but
   for the s8 case), timed beside the FMA kernel on the same inputs, plus
   its straight-through backward (o and
   gradients at the bf16 flash limit: p is bf16 on the 8-bit path). The
   block-sparse forward (sparse_fwd) and backward (sparse_bwd) in four
   cases, each launched once on the route it must take (checked by the
   route counters): the model phase's call (2, 12, 4096, 64) and the
   BASELINE head dim (1, 8, 8192, 128) with the local + global pattern,
   and N_q != N_k with 64-row q blocks and an LSE cotangent, on the tensor
   cores; GQA 12/4 at a ragged N = 1000 in fp32 with an empty q-block row,
   on the FMA kernels. o and gradients at the flash limit, LSE at 1e-4
   where a row sees a key, -inf exactly on empty q blocks and the mask
   value exactly on rows of visited blocks that see no key, dK = dV = 0
   exactly on KV blocks no q block visits; bounds from the pairs the
   pattern keeps; times of the wrapper (which builds the lists on the
   device, and di in the backward), also issued from the host, and of the
   kernels alone with the lists built beforehand, for the tensor-core
   cases also of the FMA kernels on the same inputs; SDPA with the
   expanded boolean mask as the library call (a yardstick where a row sees
   no key).
3. The serving engine at GPT-3 Small widths (TransformerConfig defaults,
   bf16, random weights from a seed): 64 requests, prompts of 32-400
   tokens, 64 new tokens each. Every launch count is set to 0 just before
   and read just after; each kernel must have run, 12 paged-attention and
   12 append launches per decode step and per prefill chunk (those of
   the chunks counted apart, T > 1), every paged-attention launch on the
   split route. Then 32 admissions (128 prefill chunks) and 20 decode
   steps at batch 32, on the host clock and again under torch.profiler:
   wall ms, kernel ms and device ops per chunk and per step, the device's
   busy share and the top kernels; host syncs per chunk and per step (sync
   debug mode "warn") on the warm-up engine.
4. The card engine's first-token logits (bf16) against the same engine on
   the CPU in float32 (plain versions), and greedy agreement over 16 steps.
3b. Phase 3 with quant="fp8" pages (64 requests), then quant="int8" (16
   requests, decode through the int8-qk schedule), with the same launch
   checks; phase 3's profile with fp8 pages.
4b. The fp8 card engine's first-token logits against the fp8 engine on the
   CPU in float32, at the FP8 rung (1e-1 abs+rel); its distance to the bf16
   card engine and their greedy agreement are reported, not gated.
5. Training at GPT-3 Small widths (dropout 0.1, remat "full", bf16 compute,
   fp32 parameters), TrainConfig(batch_size=8, seq_len=512, grad_accum=2,
   warmup_steps=2) on the synthetic stream of seed 0: 2 untimed
   micro-steps, then 8 timed ones (4 optimizer updates), each timed on the
   host clock up to ``loss.item()``. Launch counts are set to 0 just before
   and read just after: exactly 24 forward launches per micro-step (12
   layers and their remat recompute) and 12 backward launches, all on the
   tensor-core route. Then one micro-step under torch.profiler, with the
   flash kernels' device time.
6. One training loss and its gradients at full width (B=1, N=512, dropout
   0): the bf16 card against the fp32 CPU (plain versions).
5b. fa3_attention(fp8=True) forward and backward at (1, 8, 8192, 128)
   causal, e4m3 (auto: predecode, one flash_fwd) and int8 (auto: fused, one
   flash_fwd_fp8 on the tensor cores), counts set to 0 before each and read
   after; o's distance
   to exact attention reported; at (1, 8, 1024, 128) the card held against
   the CPU (plain versions): o and gradients at the bf16 flash limit, LSE
   at 1e-4; the CPU's backward takes the card's o and LSE, so both read one
   di = rowsum(o * do).
7. The block-sparse model at GPT-3 Small widths (dropout 0, remat "full",
   bf16, max_seq_len 4096), B=2, N=4096, with the local + global pattern
   of Longformer/BigBird on 32 x 32 tiles (P[i, j] = 0 <= i - j < 4 or
   j == 0): one no-grad forward (exactly 12 sparse_fwd, no flash_fwd),
   then forward + CE + backward, one untimed and three timed (exactly 24
   sparse_fwd, 12 sparse_bwd and no flash launch per step, every sparse
   launch on the tensor-core route), one profiled (the sparse kernels'
   device time summed by name)
   step, card vs CPU loss and gradients at N=512 with a 4 x 4 pattern, and
   an all-ones pattern against no pattern (logits at the bf16 rung).
8. The speculative engine: phase 3's config with spec_gamma=4, 32 requests
   of 32-400-token prompts (phase 3's draws), 32 new tokens each, in three
   arms, each after a warm-up engine: plain (no draft; the reference
   tokens), self (the target as its own draft: the acceptance ceiling) and
   draft2 (GPT-3 Small widths at 2 layers, random weights from seed 1: the
   floor). Gates: every request served in full; exact launch counts (paged
   attention and append each 12 a verify plus L_d x 5 a tick, L_d = 12 or
   2, and 12 + L_d a prefill chunk; 12 of each inside every verify pass;
   every paged launch split); the self arm's acceptance >= 0.9; one tick's
   verify logits (B=32, T=5) on the card against the same call on the CPU
   in float32 (5e-2 abs+rel). Reported: tokens equal to the plain arm's,
   tokens a tick, spec tok/s beside plain decode tok/s, and for each spec
   arm 5 ticks at batch 32 (32-128-token prompts) on the host clock and under
   torch.profiler (wall, kernel ms, device ops a tick, busy share) with the
   host syncs a tick.
9. Multi-host serving: two ProcessEngine workers on the card (GPT-3 Small,
   param seeds 0 and 1, max_batch_size 8) under MultiHostScheduler, 16
   requests drained with run_async/wait_run, against two in-process engines
   from the same seeds under the same scheduler: the same routes and the
   same tokens exactly; then a speculative pair (the 2-layer draft, seed 1,
   gamma 4) likewise. All four workers start at once and are stopped at the
   end; a worker that fails to start or raises fails the phase.
10. Context parallelism and the parallel steps. At (1, 8, 8192, 128) bf16
   causal, and again with segment ids (8 documents a row across the shard
   boundaries), the ring, bidirectional-ring and all-gather schedules of 4
   ranks (shards of 2048) run rank by rank on the card
   (``parallel.ring.schedules_on_one_device``; NCCL puts no two ranks on
   one card): the concatenated o, the LSE and dq, dk, dv (with an LSE
   cotangent) against one flash call over the whole 8192 on the same route
   at the flash limit (LSE 1e-4); exactly 10 / 20 / 4 forward and backward
   flash launches (the ring r + 1 partials on rank r, the bidirectional
   ring twice as many halves, no launch for a future shard), all on the
   tensor cores; every partial held against its plain version (the whole
   call's flash limit); each rank's schedule timed (device time under a
   stream hold long enough for its host issue; kernels, merges and copies)
   beside the one call and the schedules on the plain versions. Then one
   NCCL rank (``tcp://127.0.0.1``): ``make_mesh``, the sharded step with
   ZeRO-1 and the pipelined step (S = 1, one microbatch) at phase 5's
   widths and batch with dropout 0, two micro-steps each, against
   ``models/train.py``'s ``train_step`` from the same parameters: loss and
   every gradient within 1e-6 relative, phase 5's flash launches a
   micro-step.
11. The MoE model: GPT-3 Small with 8 experts, top 2 (capacity 1.25,
   groups of 512, aux 0.01): phase 5's training at 2 + 4 micro-steps (24
   forward and 12 backward flash launches a micro-step, checked; one
   profiled), one loss and its gradients at (B=1, N=512) with fp32 compute
   on the card against the CPU (1e-3, and every token's experts equal;
   the bf16 card's distance and its tokens routed elsewhere reported), the
   engine serving 32 requests (32-400-token prompts, 32 new tokens each; 12
   paged-attention and 12 append launches a decode step and chunk,
   checked), and phase 4's first-token logits and greedy agreement.
12. The last modules. A BPE (vocab 512) learned from the repository's
   ``*.md`` text, the native engine's ids equal to the Python merge loop's
   on the whole text, each file one document packed into rows of 513
   (``data.pack_documents``). A reference-layout checkpoint at GPT-3 Small
   widths (fused QKV, biases, spare projections, vocab 50257, seed 0)
   through ``models.compat`` in fp32 on 8 packed rows: logits and loss on
   the card against the same calls on the CPU (1e-4 of the largest logit),
   exactly 24 flash_fwd launches a forward on the FMA route and nothing
   else, loss and perplexity, the forward's time, one forward traced by
   ``utils.profiling.trace`` (its Chrome trace must hold flash_fwd
   kernels). Phase 5's training on the packed rows through
   ``data.prefetch`` (2 + 4 micro-steps, 24 + 12 flash launches a
   micro-step on the tensor cores, the loss without dropout of a batch it
   never trains on falling). ``bench.sweep.run_config`` at phase-2 case
   (b)'s (1, 8, 8192, 128) causal: fa2 forward, fa2 forward + backward and
   fa3 int8 forward (the 8-bit kernel), each record "ok" with a roofline
   share of the card's peak in (0, 1.05] and a time within 1.25x of one
   traced call's kernels; ``profiling.timed`` on one flash call;
   ``bench.scaling`` at size 1 on one NCCL rank.

The last two lines are the kernels' JSON record and the device line
``{"ok": true, "device": {...}}``; the kernels' record carries the verify
chunk's two rows (``paged_attention[verify]``, ``paged_append[verify]``:
launches inside phase 8's self-arm verify passes, numbers of the phase-2
verify cases) and the rows of phases 10-11's paths
(``flash_fwd[ring]`` ... ``[all_gather]`` with the schedules' summed
per-rank times, ``[sharded_zero1]``, ``[pipelined]``, ``[moe]`` with the
numbers of phase 2's matching cases) and of phase 12's
(``flash_fwd[compat]`` with the numbers of phase-2 cases (e) and (i),
``flash_fwd[packed]`` and ``flash_bwd[packed]`` with case (j),
``flash_fwd[sweep]`` and ``flash_bwd[sweep]`` with case (b),
``flash_fwd_fp8[sweep]`` with fp8 case (b)).
``--cpu-rehearsal`` skips phases 1-2, runs the others at a tiny width on
the CPU (phase 9's workers on the CPU, phase 10's rank over gloo) and
never prints the device line.
Details also go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import collections
import copy
import dataclasses
import json
import math
import shutil
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from flashattention_tpu_torch import _build
from flashattention_tpu_torch import data as tdata
from flashattention_tpu_torch.bench import harness, scaling, sweep
from flashattention_tpu_torch.models import compat
from flashattention_tpu_torch.models import moe
from flashattention_tpu_torch.models import train as ttrain
from flashattention_tpu_torch.models.transformer import (
    TransformerConfig,
    apply_transformer,
    init_params,
)
from flashattention_tpu_torch.ops import flash_attn as fa
from flashattention_tpu_torch.ops import fp8_attn as f8
from flashattention_tpu_torch.ops import paged_append as pap
from flashattention_tpu_torch.ops import paged_attention as pa
from flashattention_tpu_torch.ops import sparse_attn as sa
from flashattention_tpu_torch.ops.api import fa3_attention
from flashattention_tpu_torch.ops.quant import quantize_tokens
from flashattention_tpu_torch.parallel import (
    make_mesh,
    make_pipelined_train_state,
    make_pipelined_train_step,
    make_sharded_train_state,
    make_sharded_train_step,
    ring,
)
from flashattention_tpu_torch.serving import (
    EngineConfig,
    GenerationRequest,
    MultiHostScheduler,
    ProcessEngine,
    ServingEngine,
)
from flashattention_tpu_torch.serving import engine as eng_mod
from flashattention_tpu_torch.serving.paged_kv import (
    PagedKVCache,
    append_to_pages,
)
from flashattention_tpu_torch.tokenizer import BPETokenizer
from flashattention_tpu_torch.utils.testing import reference_state_dict

HBM_BYTES_PER_S = 3.35e12     # H100 SXM
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor rate
INT8_FP8_OPS_PER_S = 1979e12  # H100 SXM dense fp8 (TFLOP/s) and int8 (TOPS)
FP32_FLOPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"
SEED = 0

# Flash kernels vs plain: |kernel - plain| <= atol + rtol * |plain|, for
# outputs and gradients alike. fp32: 1e-4 each. bf16: the two versions
# round at the same points and sum in another order, so they differ by
# about one bf16 ulp; rtol is two ulps (1.6e-2) and atol 1e-3 * max|plain|
# covers elements that cancel to near zero.
KERNEL_RTOL = {torch.bfloat16: 1.6e-2, torch.float32: 1e-4}
KERNEL_ATOL = {torch.bfloat16: 1e-3, torch.float32: 1e-4}  # bf16: x max|plain|
# The paged kernel rounds p at each 32-slot tile's running max, the plain
# version at the row's final max: at outputs below 0.1 they differ by more
# than two bf16 ulps (1.95e-3 in the chunk case), so bf16 keeps 2e-2 abs+rel.
PAGED_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
LSE_TOL = 1e-4     # both versions take the LSE from the same fp32 scores
LOGITS_TOL = 5e-2  # bf16 rung of the ladder: bf16 card engine vs fp32 CPU
FP8_TOL = 1e-1     # FP8 rung: the fp8 card engine vs the fp32 CPU fp8 engine
TRAIN_TOL = 5e-2   # bf16 card training loss and grads vs the fp32 CPU
MOE_TOL = 1e-3     # the MoE loss and grads, fp32 card vs fp32 CPU

KERNELS = {
    "paged_attention": dict(
        route="cuda", source="flashattention_tpu_torch/csrc/paged_attention.cu",
        replaces="flashattention_tpu/ops/pallas_paged.py:322"),
    "paged_append": dict(
        route="cuda", source="flashattention_tpu_torch/csrc/paged_append.cu",
        replaces="flashattention_tpu/ops/pallas_append.py:49"),
    "flash_fwd": dict(
        route="cuda", source="flashattention_tpu_torch/csrc/flash_fwd.cu",
        replaces="flashattention_tpu/ops/pallas_attn.py:391"),
    "flash_bwd": dict(
        route="cuda", source="flashattention_tpu_torch/csrc/flash_bwd.cu",
        replaces="flashattention_tpu/ops/pallas_attn.py:885"),
    "flash_fwd_fp8": dict(
        route="cuda", source="flashattention_tpu_torch/csrc/flash_fwd_fp8.cu",
        replaces="flashattention_tpu/ops/pallas_fp8.py:92"),
    "sparse_fwd": dict(
        route="cuda", source="flashattention_tpu_torch/csrc/sparse_fwd.cu",
        replaces="flashattention_tpu/ops/pallas_sparse.py:96"),
    # one call of two kernels: dK/dV (:259), then dQ (:311)
    "sparse_bwd": dict(
        route="cuda", source="flashattention_tpu_torch/csrc/sparse_bwd.cu",
        replaces="flashattention_tpu/ops/pallas_sparse.py:259",
        also_replaces=["flashattention_tpu/ops/pallas_sparse.py:311"]),
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


class Timer:
    """Median device time of one call of ``fn``, from CUDA events
    (``bench.harness.time_calls``, the sweep's timer).

    Before each timed call a 128 MB write evicts the 50 MB L2 (as the
    engine's other layers do between two calls on one layer's cache), then
    a sleep kernel holds the stream while the host enqueues the start event,
    the call and the end event, so the events bracket device work only and
    not the host's time to issue it. ``wall`` instead times the call the way
    the engine meets it: the host issuing it to an idle card, in sequence."""

    SLEEP_CYCLES = harness.HOLD_CYCLES  # ~1 ms

    def __init__(self, device, sleep_cycles=SLEEP_CYCLES):
        self.flush = harness.l2_flush_buffer(device)
        self.sleep_cycles = sleep_cycles

    def __call__(self, fn, reps=30, warmup=3) -> float:
        return statistics.median(harness.time_calls(
            fn, self.flush, reps=reps, warmup=warmup,
            hold_cycles=self.sleep_cycles)[0])

    def wall(self, fn, reps=30, warmup=3) -> float:
        return statistics.median(harness.time_calls(
            fn, self.flush, reps=reps, warmup=warmup, hold_cycles=None)[0])


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _paged_inputs(gen, dev, dtype, *, b, h, h_kv, d, page, max_len, q_len,
                  lengths=None):
    pps = -(-max_len // page)
    num_pages = b * pps + 1
    kp = torch.randn((h_kv, num_pages, page, d), generator=gen).to(dev, dtype)
    vp = torch.randn((h_kv, num_pages, page, d), generator=gen).to(dev, dtype)
    perm = torch.randperm(num_pages - 1, generator=gen)[: b * pps] + 1
    pi = perm.reshape(b, pps).to(torch.int32)
    if lengths is None:
        lengths = torch.randint(1, max_len + 1, (b,), generator=gen)
    lengths = torch.as_tensor(lengths, dtype=torch.int32)
    shape = (b, h, d) if q_len == 0 else (b, h, q_len, d)
    q = torch.randn(shape, generator=gen).to(dev, dtype)
    return q, kp, vp, pi.to(dev), lengths.to(dev)


def _visible(q, kp, pi, lengths, window, sinks):
    """(B, R, L) bool: query row r sees slot l (the kernel's mask)."""
    b = pi.shape[0]
    t = 1 if q.dim() == 3 else q.shape[2]
    h_kv, _, page, _ = kp.shape
    rows = (q.shape[1] // h_kv) * t
    pos = pa.row_positions(lengths, t, rows)[:, :, None]
    slots = torch.arange(pi.shape[1] * page, device=q.device)[None, None, :]
    vis = slots <= pos
    if window is not None:
        band = slots > pos - window
        if sinks:
            band = band | (slots < sinks)
        vis = vis & band
    return vis


def attention_bound(q, kp, pi, lengths, window=None, sinks=0,
                    quantized=False, schedule=None):
    """Least time for the work these inputs need: every visible K/V slot
    read once per KV head (payload, and its two fp32 scales when
    quantized), q read and o written once; 4·D flops per visible (query
    head, row, slot), half of them Q.K and half P.V, each at the rate of
    its operands' type (int8 for Q.K under the int8 schedules "qk" and
    "full", and for P.V under "full")."""
    h_kv, _, page, d = kp.shape
    vis = _visible(q, kp, pi, lengths, window, sinks)
    slots = int(vis.any(dim=1).sum())             # per sequence, any row
    pairs = int(vis.sum()) * h_kv                  # (kv head, row, slot)
    el = kp.element_size() + (4 / d if quantized else 0)
    nbytes = 2 * slots * h_kv * d * el + 2 * q.numel() * q.element_size()
    peak = FP32_FLOPS_PER_S if q.dtype == torch.float32 else BF16_FLOPS_PER_S
    qk_peak = INT8_FP8_OPS_PER_S if schedule in ("qk", "full") else peak
    pv_peak = INT8_FP8_OPS_PER_S if schedule == "full" else peak
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * pairs * d / qk_peak + 2 * pairs * d / pv_peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sdpa_yardstick(q, kp, vp, pi, lengths, scale, window, sinks):
    """A closure timing one scaled_dot_product_attention call over K/V
    gathered to contiguous tensors beforehand (the gather is not timed)."""
    b = pi.shape[0]
    h_kv, _, page, d = kp.shape
    h = q.shape[1]
    qq = q[:, :, None] if q.dim() == 3 else q
    k = kp[:, pi.long()].transpose(0, 1).reshape(b, h_kv, -1, d)
    v = vp[:, pi.long()].transpose(0, 1).reshape(b, h_kv, -1, d)
    k = k.repeat_interleave(h // h_kv, dim=1).contiguous()
    v = v.repeat_interleave(h // h_kv, dim=1).contiguous()
    t = qq.shape[2]
    pos = lengths.long()[:, None] - t + torch.arange(t, device=q.device)
    slots = torch.arange(k.shape[2], device=q.device)
    mask = slots[None, None, :] <= pos[:, :, None]
    if window is not None:
        band = slots[None, None, :] > pos[:, :, None] - window
        if sinks:
            band = band | (slots < sinks)[None, None, :]
        mask = mask & band
    mask = mask[:, None]
    f = torch.nn.functional.scaled_dot_product_attention
    return lambda: f(qq, k, v, attn_mask=mask, scale=scale)


def kernel_tol(dtype, ref):
    """(rtol, atol) of a kernel output against its plain version ``ref``."""
    atol = KERNEL_ATOL[dtype]
    if dtype == torch.bfloat16:
        atol *= float(ref.float().abs().max())
    return KERNEL_RTOL[dtype], atol


def tol_text(dtype):
    if dtype == torch.bfloat16:
        return (f"rtol {KERNEL_RTOL[dtype]:g} + atol {KERNEL_ATOL[dtype]:g}"
                f" x max|plain|")
    return f"{KERNEL_RTOL[dtype]:g} abs+rel"


def check_close(name, out, ref, rtol, atol=None):
    atol = rtol if atol is None else atol
    err = (out.float() - ref.float()).abs()
    max_err = float(err.max())
    bad = err > atol + rtol * ref.float().abs()
    if not torch.isfinite(out.float()).all():
        fail(f"{name}: non-finite output")
    if bool(bad.any()):
        fail(f"{name}: max |kernel - plain| {max_err:.3e}; "
             f"{int(bad.sum())} elements over rtol {rtol:g} + atol {atol:.3e}")
    return max_err


def quantize_pages(kp, vp, quant):
    """(k payload, k scales, v payload, v scales) of float pages, quantized
    per slot as the engine writes them."""
    out = []
    for x in (kp, vp):
        p, sc = quantize_tokens(x, quant)
        out += [p, sc[..., None].contiguous()]
    return out


def attention_case(timer, gen, dev, name, dtype, *, window=None, sinks=0,
                   softcap=None, quant=None, int8_qk=None, **shape):
    q, kp, vp, pi, ln = _paged_inputs(
        gen, dev, torch.float32 if quant else dtype, **shape)
    kw = dict(window=window, sinks=sinks, softcap=softcap)
    library_pages = None
    if quant:
        q = q.to(dtype)
        kp, ks, vp, vs = quantize_pages(kp, vp, quant)
        kw.update(k_scales=ks, v_scales=vs, int8_qk=int8_qk)
        # the yardstick attends over the dequantized pages, in bf16
        library_pages = [(x.float() * sc).to(torch.bfloat16)
                         for x, sc in ((kp, ks), (vp, vs))]
    scale = q.shape[-1] ** -0.5
    s0 = pa.paged_attention.split_launches
    out = pa.paged_attention(q, kp, vp, pi, ln, softmax_scale=scale, **kw)
    torch.cuda.synchronize()
    route = "split" if pa.paged_attention.split_launches > s0 else "first"
    ref = pa.paged_attention_plain(q, kp, vp, pi, ln, softmax_scale=scale, **kw)
    max_err = check_close(name, out, ref, PAGED_TOL[dtype])
    if route == "split":
        if not torch.equal(out, pa.paged_attention(
                q, kp, vp, pi, ln, softmax_scale=scale, **kw)):
            fail(f"{name}: two split-route calls differ")
    call = lambda: pa.paged_attention(q, kp, vp, pi, ln, softmax_scale=scale,
                                      **kw)
    ms, wall_ms = timer(call), timer.wall(call)
    first = {}
    if route == "split":  # the first kernel on the same inputs
        with mock.patch.object(pa, "split_route", lambda *a_: False):
            first["first_max_abs_err"] = check_close(
                f"{name} (first kernel)", call(), ref, PAGED_TOL[dtype])
            first["first_ms"] = timer(call)
            first["first_wall_ms"] = timer.wall(call)
    plain_ms = timer(lambda: pa.paged_attention_plain(
        q, kp, vp, pi, ln, softmax_scale=scale, **kw), reps=10)
    sdpa_ms = None
    if softcap is None:  # SDPA has no soft-capping
        lk, lv = library_pages or (kp, vp)
        sdpa_ms = timer(sdpa_yardstick(q, lk, lv, pi, ln, scale, window,
                                       sinks))
    mode = (pa.int8_mode(kp, q.dtype, 1 if q.dim() == 3 else q.shape[2],
                         int8_qk) if quant else None)
    bound_ms, bound_by = attention_bound(q, kp, pi, ln, window, sinks,
                                         quantized=quant is not None,
                                         schedule=mode)
    # over quantized pages SDPA (on the dequantized pages) computes another
    # function: a yardstick, not the library call
    library_ms, yardstick_ms = (None, sdpa_ms) if quant else (sdpa_ms, None)
    rec = dict(case=name, route=route, max_abs_err=max_err,
               tol=PAGED_TOL[dtype], ms=ms, wall_ms=wall_ms, **first,
               plain_ms=plain_ms, library_ms=library_ms,
               yardstick_ms=yardstick_ms, bound_ms=bound_ms,
               bound_by=bound_by, shape={k: v for k, v in shape.items()},
               window=window, sinks=sinks, softcap=softcap, quant=quant,
               schedule=mode, dtype=str(dtype).replace("torch.", ""))
    log(f"[kernel] paged_attention {name}: {route} route, max_abs_err "
        f"{max_err:.3e} (tol {PAGED_TOL[dtype]:g} abs+rel)  kernel_ms "
        f"{ms:.4f} (issued from the host: {wall_ms:.4f})"
        + ("" if not first else
           f"  first kernel {first['first_ms']:.4f} (issued from the host: "
           f"{first['first_wall_ms']:.4f})")
        + f"  plain_ms "
        f"{plain_ms:.4f}  library_ms "
        f"{'n/a' if library_ms is None else f'{library_ms:.4f}'}"
        + ("" if yardstick_ms is None else
           f" (SDPA on the dequantized pages {yardstick_ms:.4f})")
        + f"  bound_us {bound_ms * 1e3:.2f} ({bound_by})")
    return rec


APPEND_FORMATS = ("bf16", "fp32", "int8", "fp8", "e5m2")


def verify_lengths(gen, b=32, t=5, max_len=512):
    """Slot lengths before a speculative verify chunk of ``t`` rows: drawn
    from [33, 505], then slot 0 at 508 (its rows pass the 512-slot page
    capacity), slot 1 at 46 (its chunk crosses a page boundary), slots 2
    and 3 at the range's ends."""
    lengths = torch.randint(33, 506, (b,), generator=gen)
    lengths[:4] = torch.tensor([max_len - t + 1, 46, 33, 505])
    return lengths


def append_case(timer, gen, dev, fmt, kind, *, h=12, d=64, page=16,
                max_len=512):
    """B7 through ``paged_append`` at the engine's decode step (B = 32, T =
    1), at a prefill chunk (B = 1, T = 64 from position 384) or at a
    speculative verify chunk (B = 32, T = 5 from ``verify_lengths``),
    ``fmt`` pages, tokens as the head views of a fused QKV projection
    (bf16; fp32 for fp32 pages), against its plain version: bit-exact
    outside the dump page, payloads and scales. Decode and verify: a
    quarter of the slots idle on the dump page as the engine routes them;
    decode: one sequence full (its token drops); verify: the rows of the
    slot at 508 past position 511 drop. Times: the kernel,
    ``append_to_pages`` issued from the host, the plain version,
    ``index_put_`` of the kept tokens (bf16 and fp32 pages; a quantizing
    append has no library call), the byte bound and, beside it, a floor
    that is not a bound: the card's smallest launch on this stream (a
    one-element ``zero_``)."""
    quant = None if fmt in ("bf16", "fp32") else fmt
    src = torch.float32 if fmt == "fp32" else torch.bfloat16
    pps = -(-max_len // page)
    b, t = {"decode": (32, 1), "chunk": (1, 64), "verify": (32, 5)}[kind]
    num_pages, dump = b * pps + 1, 0
    noise = [torch.randn((h, num_pages, page, d), generator=gen).to(dev)
             for _ in range(2)]
    if quant:
        pages = quantize_pages(*noise, quant)
    else:
        pages = [noise[0].to(src), None, noise[1].to(src), None]
    qkv = torch.randn((b, t, 3 * h * d), generator=gen).to(dev, src)
    k, v = (x.reshape(b, t, h, d).transpose(1, 2)
            for x in torch.split(qkv, h * d, dim=-1)[1:])
    pi = (torch.randperm(num_pages - 1, generator=gen)[: b * pps] + 1
          ).reshape(b, pps)
    if kind in ("decode", "verify"):
        if kind == "decode":
            lengths = torch.randint(0, max_len, (b,), generator=gen)
            lengths[b - 1] = max_len   # full: its token drops
        else:
            lengths = verify_lengths(gen, b, t, max_len)
        idle = torch.arange(b) % 4 == 3
        pi[idle], lengths[idle] = dump, 0
        valid = None
    else:
        lengths, valid = torch.tensor([max_len - 2 * t]), torch.tensor([t])
    pi, lengths = pi.to(dev, torch.int32), lengths.to(dev, torch.int32)
    if valid is not None:
        valid = valid.to(dev, torch.int32)
    got = [x if x is None else x.clone() for x in pages]
    want = [x if x is None else x.clone() for x in pages]

    def kernel():
        pap.paged_append(got[0], got[2], k, v, pi, lengths, valid, got[1],
                         got[3])

    def plain():
        pap.paged_append_plain(want[0], want[2], k, v, pi, lengths, valid,
                               want[1], want[3])

    before = pap.paged_append.launches
    kernel()
    torch.cuda.synchronize()
    if pap.paged_append.launches != before + 1:
        fail(f"paged_append {fmt} {kind}: not one launch")
    plain()
    keep = torch.arange(num_pages, device=dev) != dump
    diff = sum(int((g[:, keep].view(torch.uint8)
                    != w[:, keep].view(torch.uint8)).sum())
               for g, w in zip(got, want) if g is not None)
    if diff:
        fail(f"paged_append {fmt} {kind}: {diff} bytes differ from the plain "
             f"version")
    cache = PagedKVCache(k_pages=got[0], v_pages=got[2], k_scales=got[1],
                         v_scales=got[3], quant=quant)
    ms = timer(kernel, reps=50)
    wall_ms = timer.wall(lambda: append_to_pages(cache, k, v, pi, lengths,
                                                 valid), reps=50)
    plain_ms = timer(plain, reps=20)
    tiny = torch.zeros(1, device=dev)
    floor_ms = timer(tiny.zero_, reps=50)
    # the tokens the kernel writes, as the plain version selects them
    pos = lengths.long()[:, None] + torch.arange(t, device=dev)[None, :]
    sel = pos < pps * page
    if valid is not None:
        sel &= torch.arange(t, device=dev)[None, :] < valid.long()[:, None]
    n_kept = int(sel.sum())
    library_ms = None
    if not quant:
        p_ok = pi.long().gather(1, (pos // page).clamp(max=pps - 1))[sel]
        s_ok = (pos % page)[sel]
        k_ok, v_ok = (x.transpose(1, 2)[sel].transpose(0, 1) for x in (k, v))

        def library():  # advanced-index assignment: index_put_
            want[0][:, p_ok, s_ok] = k_ok
            want[2][:, p_ok, s_ok] = v_ok

        library_ms = timer(library, reps=50)
    # each input read once, each output written once: tokens, lengths,
    # valid_len and the page-table entry of every written page in; the
    # payloads (and scales) out
    src_el, dst_el = qkv.element_size(), got[0].element_size()
    n_pages = int(torch.unique((pos // page)[sel] + pps * torch.arange(
        b, device=dev)[:, None].expand_as(pos)[sel]).numel())
    nbytes = (2 * n_kept * h * (d * (src_el + dst_el) + (4 if quant else 0))
              + 4 * b * (1 if valid is None else 2) + 4 * n_pages)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    rec = dict(case=f"{fmt} {kind} append B={b} T={t} H_kv={h} D={d} "
                    f"page={page}, tokens as fused-projection views, "
                    + {"decode": "8 idle slots on the dump page, 1 full "
                                 "sequence",
                       "verify": "8 idle slots on the dump page, lengths "
                                 "33-505 and one at 508 (rows past 511 "
                                 "drop)",
                       "chunk": f"position {max_len - 2 * t}, valid_len "
                                f"{t}"}[kind],
               max_abs_err=0.0, tol=0.0, ms=ms, wall_ms=wall_ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
               bound_by="bytes", floor_ms=floor_ms, tokens_written=n_kept)
    log(f"[kernel] paged_append {fmt} {kind}: bit-exact (dump page excluded)"
        f"  kernel_ms {ms:.4f} (append_to_pages issued from the host: "
        f"{wall_ms:.4f})  plain_ms {plain_ms:.4f}  library_ms "
        f"{'n/a' if library_ms is None else f'{library_ms:.4f}'}  bound_us "
        f"{bound_ms * 1e3:.3f} (bytes)  floor_us {floor_ms * 1e3:.3f} "
        f"(one-element zero_: the smallest launch, a floor, not a bound)")
    return rec


BF16, FP32 = torch.bfloat16, torch.float32
# Cases whose bf16 D <= 128 inputs are also timed on the FMA route (the
# first kernels, which fp32 and D > 128 keep): the redesign's before/after
# on one card in one call.
FMA_COMPARE = ("a", "a0", "b")
TRAIN_SHAPE = (8, 12, 12, 512, 512, 64)  # B, H, H_kv, N_q, N_k, D
# key: (label, shape, dtype, kernel_attention kwargs, extras)
FLASH_CASES = {
    "a": ("training B=8 H=12 N=512 D=64 bf16 causal dropout 0.1",
          TRAIN_SHAPE, BF16,
          dict(causal=True, dropout_rate=0.1, dropout_seed=1234), ()),
    "a0": ("training shape B=8 H=12 N=512 D=64 bf16 causal, no dropout",
           TRAIN_SHAPE, BF16, dict(causal=True), ()),
    "b": ("bench.py shape B=1 H=8 N=8192 D=128 bf16 causal",
          (1, 8, 8, 8192, 8192, 128), BF16, dict(causal=True), ()),
    "c": ("GQA 12/4 window 128 sinks 4 softcap 30, B=8 N=512 bf16",
          (8, 12, 4, 512, 512, 64), BF16,
          dict(causal=True, window=128, sinks=4, softcap=30.0), ()),
    "d": ("segment ids (4 per row) + ALiBi, B=8 H=12 N=512 bf16 causal",
          TRAIN_SHAPE, BF16, dict(causal=True), ("segments", "alibi")),
    "e": ("fp32 B=8 H=12 N=512 causal", TRAIN_SHAPE, FP32,
          dict(causal=True), ()),
    "f": ("nonzero LSE cotangent, B=8 H=12 N=512 bf16 causal", TRAIN_SHAPE,
          BF16, dict(causal=True), ("dlse",)),
    "g": ("q_offset -64: 64 rows per head with no visible key, bf16",
          TRAIN_SHAPE, BF16, dict(causal=True, q_offset=-64), ()),
    "h": ("fp32 training shape, causal, dropout 0.1", TRAIN_SHAPE, FP32,
          dict(causal=True, dropout_rate=0.1, dropout_seed=99), ()),
    # phase 12's calls: compat's "ffn" block (case e is its causal MHA) and
    # training on packed documents
    "i": ("fp32 B=8 H=12 N=512 non-causal (compat's ffn block)", TRAIN_SHAPE,
          FP32, dict(causal=False), ()),
    "j": ("packed rows: segment ids (4 per row) + dropout 0.1, B=8 H=12 "
          "N=512 bf16 causal", TRAIN_SHAPE, BF16,
          dict(causal=True, dropout_rate=0.1, dropout_seed=7), ("segments",)),
}


def _flash_inputs(gen, dev, shape, dtype, extras):
    b, h, h_kv, n_q, n_k, d = shape

    def rand(*s):
        return torch.randn(s, generator=gen).to(dev, dtype)

    q, k, v = rand(b, h, n_q, d), rand(b, h_kv, n_k, d), rand(b, h_kv, n_k, d)
    do = rand(b, h, n_q, d)
    dlse = (torch.randn((b, h, n_q), generator=gen).to(dev)
            if "dlse" in extras else None)
    more = {}
    if "segments" in extras:
        ids = torch.sort(torch.randint(0, 4, (b, n_q), generator=gen))[0]
        more["segment_ids"] = ids.to(dev, torch.int32)
    if "alibi" in extras:
        more["alibi_slopes"] = (0.5 ** torch.arange(1, h + 1)).to(dev)
    return q, k, v, do, dlse, more


def flash_bound(q, k, opts, dlse):
    """Least times (ms) of the forward and the backward for the pairs these
    inputs keep: 4·D (forward) and 10·D (backward) flops per visible
    (head, row, key), against each input read once and each output written
    once."""
    b, h, n_q, d = q.shape
    n_k = k.shape[2]
    vis = fa.visible_mask(opts, n_q, n_k, q.device)
    pairs = (b * h * n_q * n_k if vis is None
             else int(vis.expand(b, 1, n_q, n_k).sum()) * h)
    return attention_bounds(q, k, pairs, dlse), pairs / (b * h * n_q * n_k)


def attention_bounds(q, k, pairs, dlse):
    """{"fwd"|"bwd": (least ms, what bounds it)} for ``pairs`` visible
    (head, row, key) triples: 4·D and 10·D flops per pair against q, k, v
    read and o, the LSE written once (forward), and q, k, v, o, do, the
    LSE (and its cotangent) read and dq, dk, dv written once (backward)."""
    b, h, n_q, d = q.shape
    el = q.element_size()
    qo = q.numel() * el                      # q, o, do, dq each
    kv = k.numel() * el                      # k, v, dk, dv each
    rows = b * h * n_q * 4                   # lse, dlse
    peak = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    out = {}
    for name, nbytes, flops in (
        ("fwd", 2 * qo + 2 * kv + rows, 4 * pairs * d),
        ("bwd", 4 * qo + 4 * kv + rows * (2 if dlse is not None else 1),
         10 * pairs * d),
    ):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
        out[name] = (max(t_bytes, t_ops) * 1e3,
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def fma_route(q, k, v, o, lse, do, dlse, opts):
    """(forward, backward) callables that launch the FMA-route entry points
    (``fat_flash_fwd`` / ``fat_flash_bwd``) on bf16 inputs the wrapper would
    send to the tensor cores: the first kernels' time on the same card."""
    fwd = _build.load_kernel("flash_fwd", fa._declare_fwd)
    bwd = _build.load_kernel("flash_bwd", fa._declare_bwd)
    o_out, lse_out = torch.empty_like(o), torch.empty_like(lse)
    grads = [torch.empty_like(x) for x in (q, k, v)]
    di = (o.float() * do.float()).sum(-1)
    if dlse is not None:
        di = di - dlse
    ext = (fa._ptr(opts.q_ids), fa._ptr(opts.kv_ids), fa._ptr(opts.slopes))

    def run_fwd():
        _build.check(fwd.fat_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o_out.data_ptr(),
            lse_out.data_ptr(), *ext, *fa._scalars(q, k, opts)), "fma fwd")

    def run_bwd():
        _build.check(bwd.fat_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), *(g.data_ptr() for g in grads),
            *ext, *fa._scalars(q, k, opts)), "fma bwd")
    return run_fwd, run_bwd


def flash_case(timer, gen, dev, key):
    label, shape, dtype, kw, extras = FLASH_CASES[key]
    q, k, v, do, dlse, more = _flash_inputs(gen, dev, shape, dtype, extras)
    opts = fa.make_opts(q, k, **kw, **more)
    tc = fa._tensor_core_route(dtype, shape[-1])
    reset_counts()
    o, lse = fa.flash_fwd(q, k, v, opts)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, opts)
    tols = {"o": kernel_tol(dtype, o_ref)}
    err = {"o": check_close(f"flash_fwd {key} o", o, o_ref, *tols["o"])}
    seen = lse_ref > -1e30  # rows without a key: LSE only <= -1e30
    if not bool((lse[~seen] <= -1e30).all()):
        fail(f"flash_fwd {key}: a row without keys has an LSE above -1e30")
    err["lse"] = check_close(f"flash_fwd {key} lse", lse[seen], lse_ref[seen],
                             LSE_TOL)
    grads = fa.flash_bwd(q, k, v, o_ref, lse_ref, do, dlse, opts)
    torch.cuda.synchronize()
    c = read_counts()
    if (c["flash_fwd"], c["flash_bwd"], c["flash_fwd_tc"],
            c["flash_bwd_tc"]) != (1, 1, int(tc), int(tc)):
        fail(f"flash {key}: launches {c}; want the "
             f"{'tensor-core' if tc else 'FMA'} route once each way")
    route = "tensor cores (wgmma + TMA)" if tc else "FMA"

    def plain_bwd():
        di = (o_ref.float() * do.float()).sum(-1)
        if dlse is not None:
            di = di - dlse
        return fa.flash_bwd_plain(q, k, v, do, lse_ref, di, opts)

    for name, g, r in zip(("dq", "dk", "dv"), grads, plain_bwd()):
        tols[name] = kernel_tol(dtype, r)
        err[name] = check_close(f"flash_bwd {key} {name}", g, r, *tols[name])
    del grads
    big = q.shape[2] > 4096
    fwd_call = lambda: fa.flash_fwd(q, k, v, opts)
    bwd_call = lambda: fa.flash_bwd(q, k, v, o_ref, lse_ref, do, dlse, opts)
    t = dict(
        fwd_ms=timer(fwd_call),
        fwd_wall_ms=timer.wall(fwd_call),
        fwd_plain_ms=timer(lambda: fa.flash_fwd_plain(q, k, v, opts),
                           reps=3 if big else 10, warmup=1),
        bwd_ms=timer(bwd_call),
        bwd_wall_ms=timer.wall(bwd_call),
        bwd_plain_ms=timer(plain_bwd, reps=3 if big else 10, warmup=1),
    )
    if tc and key in FMA_COMPARE:
        fma_fwd, fma_bwd = fma_route(q, k, v, o_ref, lse_ref, do, dlse, opts)
        t["fwd_fma_ms"] = timer(fma_fwd, reps=10 if big else 30)
        t["bwd_fma_ms"] = timer(fma_bwd, reps=10 if big else 30)
    # SDPA(is_causal=causal), no dropout: the library call where the case
    # has no other feature (the same function), else a yardstick.
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gqa = q.shape[1] != k.shape[1]
    causal = kw.get("causal", False)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    sdpa_fwd = timer(lambda: sdpa(
        q, k, v, is_causal=causal, scale=opts.scale, enable_gqa=gqa))
    o_lib = sdpa(*leaves, is_causal=causal, scale=opts.scale, enable_gqa=gqa)
    sdpa_bwd = timer(lambda: torch.autograd.grad(
        o_lib, leaves, do, retain_graph=True))
    same = (not extras or extras == ("dlse",)) and kw == dict(causal=causal)
    lib_key = "library" if same else "yardstick"
    t[f"{lib_key}_fwd_ms"], t[f"{lib_key}_bwd_ms"] = sdpa_fwd, sdpa_bwd
    bounds, frac = flash_bound(q, k, opts, dlse)
    rec = dict(case=label, shape=shape, dtype=str(dtype).replace("torch.", ""),
               route=route, max_abs_err=err,
               tol={n: dict(rtol=r, atol=a) for n, (r, a) in tols.items()},
               visited_fraction=frac, library_same_function=same,
               fwd_bound_ms=bounds["fwd"][0], fwd_bound_by=bounds["fwd"][1],
               bwd_bound_ms=bounds["bwd"][0], bwd_bound_by=bounds["bwd"][1],
               **t)
    log(f"[kernel] flash {key} ({label}) on the {route} route: max_abs_err "
        + " ".join(f"{n} {e:.2e}" for n, e in err.items())
        + f" ({tol_text(dtype)}; lse {LSE_TOL:g} abs+rel)")
    fma = (f"; FMA route fwd {t['fwd_fma_ms']:.4f} bwd {t['bwd_fma_ms']:.4f}"
           if "fwd_fma_ms" in t else "")
    log(f"[kernel]   fwd {t['fwd_ms']:.4f} ms (issued from the host "
        f"{t['fwd_wall_ms']:.4f}, plain {t['fwd_plain_ms']:.4f}, SDPA "
        f"{sdpa_fwd:.4f}, bound {bounds['fwd'][0]:.4f} {bounds['fwd'][1]})  "
        f"bwd {t['bwd_ms']:.4f} ms (issued from the host "
        f"{t['bwd_wall_ms']:.4f}, plain {t['bwd_plain_ms']:.4f}, SDPA "
        f"{sdpa_bwd:.4f}, bound {bounds['bwd'][0]:.4f} {bounds['bwd'][1]})"
        + fma + ("" if same else "  [SDPA, a yardstick: it computes a "
                 "different function here]"))
    return rec


def local_global(n_q_tiles, n_k_tiles, width=4):
    """The local + global block layout of Longformer/BigBird (no random
    blocks): q tile i sees tiles i - width + 1 .. i and tile 0."""
    i = torch.arange(n_q_tiles)[:, None]
    j = torch.arange(n_k_tiles)[None, :]
    return ((i - j >= 0) & (i - j < width)) | (j == 0)


def random_pattern(n_q_tiles, n_k_tiles, density, empty_row, seed):
    gen = torch.Generator().manual_seed(seed)
    p = torch.rand((n_q_tiles, n_k_tiles), generator=gen) < density
    p[empty_row] = False
    return p


# key: (label, shape, dtype, causal, (block_q, block_k), pattern, use dlse)
SPARSE_CASES = {
    "a": ("the model phase's call (2, 12, 4096, 64) bf16 causal, local+global "
          "on 32 x 32 tiles of 128", (2, 12, 12, 4096, 4096, 64), BF16, True,
          (128, 128), local_global(32, 32), False),
    "b": ("BASELINE head dim (1, 8, 8192, 128) bf16 causal, local+global on "
          "64 x 64 tiles of 128", (1, 8, 8, 8192, 8192, 128), BF16, True,
          (128, 128), local_global(64, 64), False),
    "c": ("GQA 12/4, N=1000 fp32 non-causal, random density 0.3 with an "
          "empty q-block row, tiles of 64", (1, 12, 4, 1000, 1000, 64), FP32,
          False, (64, 64), random_pattern(16, 16, 0.3, 5, SEED), False),
    "d": ("N_q 384 != N_k 512 bf16 causal, blocks 64 x 128, local+global, "
          "LSE cotangent", (2, 8, 8, 384, 512, 64), BF16, True, (64, 128),
          local_global(6, 4), True),
}


def sparse_launch(q, k, v, o, lse, do, dlse, active, spec, sm90):
    """(forward, backward) callables that launch one route's entry points
    (``fat_sparse_*_sm90`` where ``sm90``, else the FMA kernels'
    ``fat_sparse_*``) with the lists and di built once beforehand: the
    kernels' own time, without the wrapper's list building."""
    fwd = _build.load_kernel("sparse_fwd", sa._declare_fwd)
    bwd = _build.load_kernel("sparse_bwd", sa._declare_bwd)
    fwd_fn = fwd.fat_sparse_fwd_sm90 if sm90 else fwd.fat_sparse_fwd
    bwd_fn = bwd.fat_sparse_bwd_sm90 if sm90 else bwd.fat_sparse_bwd
    o_out, lse_out = torch.empty_like(o), torch.empty_like(lse)
    grads = [torch.empty_like(x) for x in (q, k, v)]
    di = (o.float() * do.float()).sum(-1)
    if dlse is not None:
        di = di - dlse
    kv_list, kv_count = sa.compact_rows(active)
    q_list, q_count = sa.compact_rows(active.t())
    code = fa._DTYPE_CODE[q.dtype]
    stream = torch.cuda.current_stream().cuda_stream

    def run_fwd():
        _build.check(fwd_fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o_out.data_ptr(),
            lse_out.data_ptr(), kv_list.data_ptr(), kv_count.data_ptr(),
            *sa._shape_args(q, k, spec), kv_list.shape[1], code, stream),
            "sparse fwd")

    def run_bwd():
        _build.check(bwd_fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), *(g.data_ptr() for g in grads),
            kv_list.data_ptr(), kv_count.data_ptr(), q_list.data_ptr(),
            q_count.data_ptr(), *sa._shape_args(q, k, spec),
            kv_list.shape[1], q_list.shape[1], code, stream),
            "sparse bwd")
    return run_fwd, run_bwd


def sparse_case(timer, gen, dev, key):
    """The sparse forward and backward kernels against their plain versions
    (o and gradients at the flash limit; LSE at 1e-4 where a row sees a
    key, -inf exactly on empty q blocks, the mask value exactly on rows of
    visited blocks that see no key; dK = dV = 0 exactly on KV blocks no q
    block visits), each launched once on the route it must take (checked
    by the route counters), their times (also issued from the host, and on
    the FMA route where the tensor cores take the case), the bound of the
    pairs the pattern keeps, and SDPA with the expanded boolean mask."""
    label, shape, dtype, causal, (bq, bk), pattern, use_dlse = SPARSE_CASES[key]
    q, k, v, do, dlse, _ = _flash_inputs(gen, dev, shape, dtype,
                                         ("dlse",) if use_dlse else ())
    spec = sa.SparseSpec(causal=causal, scale=shape[-1] ** -0.5, block_q=bq,
                         block_k=bk)
    n_q, n_k = shape[3], shape[4]
    active = sa.tile_pattern(pattern.to(dev), *pattern.shape, bq, bk, causal,
                             n_k - n_q)
    tc = sa._tensor_core_route(dtype, shape[-1], spec)
    reset_counts()
    o, lse = sa.sparse_fwd(q, k, v, active, spec)
    torch.cuda.synchronize()
    o_ref, lse_ref = sa.sparse_fwd_plain(q, k, v, active, spec)
    tols = {"o": kernel_tol(dtype, o_ref)}
    err = {"o": check_close(f"sparse_fwd {key} o", o, o_ref, *tols["o"])}
    empty = torch.isneginf(lse_ref)
    if not torch.equal(torch.isneginf(lse), empty):
        fail(f"sparse_fwd {key}: -inf LSE rows differ from the plain version's")
    seen = lse_ref > -1e30
    if not torch.equal(lse[~seen & ~empty], lse_ref[~seen & ~empty]):
        fail(f"sparse_fwd {key}: rows that see no key differ in LSE")
    err["lse"] = check_close(f"sparse_fwd {key} lse", lse[seen], lse_ref[seen],
                             LSE_TOL)
    grads = sa.sparse_bwd(q, k, v, o_ref, lse_ref, do, dlse, active, spec)
    torch.cuda.synchronize()
    c = read_counts()
    if (c["sparse_fwd"], c["sparse_bwd"], c["sparse_fwd_tc"],
            c["sparse_bwd_tc"]) != (1, 1, int(tc), int(tc)):
        fail(f"sparse {key}: launches {c}; want the "
             f"{'tensor-core' if tc else 'FMA'} route once each way")
    route = "tensor cores (wgmma + TMA)" if tc else "FMA"

    def plain_bwd():
        di = (o_ref.float() * do.float()).sum(-1)
        if dlse is not None:
            di = di - dlse
        return sa.sparse_bwd_plain(q, k, v, do, lse_ref, di, active, spec)

    for name, g, r in zip(("dq", "dk", "dv"), grads, plain_bwd()):
        tols[name] = kernel_tol(dtype, r)
        err[name] = check_close(f"sparse_bwd {key} {name}", g, r, *tols[name])
    unvisited = (~active.any(0)).repeat_interleave(bk)[:n_k]
    if any(bool(g[:, :, unvisited].any()) for g in grads[1:]):
        fail(f"sparse_bwd {key}: dK or dV is nonzero on an unvisited KV block")
    del grads
    big = n_q * n_k * shape[1] * shape[0] > 2 ** 27
    fwd_call = lambda: sa.sparse_fwd(q, k, v, active, spec)
    bwd_call = lambda: sa.sparse_bwd(q, k, v, o_ref, lse_ref, do, dlse,
                                     active, spec)
    t = dict(
        fwd_ms=timer(fwd_call),
        fwd_wall_ms=timer.wall(fwd_call),
        fwd_plain_ms=timer(lambda: sa.sparse_fwd_plain(q, k, v, active, spec),
                           reps=3 if big else 10, warmup=1),
        bwd_ms=timer(bwd_call),
        bwd_wall_ms=timer.wall(bwd_call),
        bwd_plain_ms=timer(plain_bwd, reps=3 if big else 10, warmup=1),
    )
    # the kernels alone (lists and di built beforehand), and for the
    # tensor-core cases the FMA kernels on the same inputs
    for which in ("kernel", "fma") if tc else ("kernel",):
        run_fwd, run_bwd = sparse_launch(q, k, v, o_ref, lse_ref, do, dlse,
                                         active, spec, tc and which == "kernel")
        reps = 30 if which == "kernel" else 10
        t[f"fwd_{which}_ms"] = timer(run_fwd, reps=reps)
        t[f"bwd_{which}_ms"] = timer(run_bwd, reps=reps)
    # SDPA with the expanded element mask: the same function only where
    # every row sees a key (an all-masked row gives NaN there, 0 here)
    vis = sa.element_mask(active, n_q, n_k, spec)
    every_row = bool(vis.any(dim=-1).all())
    same = dict(fwd=every_row, bwd=every_row and not use_dlse,
                fwd_bwd=every_row and not use_dlse)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gqa = q.shape[1] != k.shape[1]
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    lib = dict(fwd=timer(lambda: sdpa(q, k, v, attn_mask=vis, scale=spec.scale,
                                      enable_gqa=gqa)))
    o_lib = sdpa(*leaves, attn_mask=vis, scale=spec.scale, enable_gqa=gqa)
    lib["bwd"] = timer(lambda: torch.autograd.grad(o_lib, leaves, do,
                                                   retain_graph=True))
    lib["fwd_bwd"] = timer(lambda: torch.autograd.grad(
        sdpa(*leaves, attn_mask=vis, scale=spec.scale, enable_gqa=gqa),
        leaves, do))
    del o_lib, leaves
    pairs = int(vis.sum()) * shape[0] * shape[1]
    bounds = attention_bounds(q, k, pairs, dlse)
    rec = dict(case=label, shape=shape, dtype=str(dtype).replace("torch.", ""),
               blocks=(bq, bk), route=route, active_tiles=int(active.sum()),
               visible_pairs=pairs, max_abs_err=err,
               tol={n: dict(rtol=r, atol=a) for n, (r, a) in tols.items()},
               empty_rows=int(empty.sum()), library_same_function=same,
               fwd_bound_ms=bounds["fwd"][0], fwd_bound_by=bounds["fwd"][1],
               bwd_bound_ms=bounds["bwd"][0], bwd_bound_by=bounds["bwd"][1],
               **{f"{'library' if same[n] else 'yardstick'}_{n}_ms": x
                  for n, x in lib.items()}, **t)
    log(f"[kernel] sparse {key} ({label}) on the {route} route: "
        f"{int(active.sum())} active tiles, {pairs} visible pairs; "
        f"max_abs_err " + " ".join(f"{n} {e:.2e}" for n, e in err.items())
        + f" ({tol_text(dtype)}; lse {LSE_TOL:g} abs+rel, -inf and "
        f"mask-value rows exact)")
    fma = (f"; FMA kernels fwd {t['fwd_fma_ms']:.4f} bwd "
           f"{t['bwd_fma_ms']:.4f}" if tc else "")
    log(f"[kernel]   kernels alone: fwd {t['fwd_kernel_ms']:.4f} bwd "
        f"{t['bwd_kernel_ms']:.4f} ms" + fma)
    log(f"[kernel]   wrapper (lists built on the device): fwd "
        f"{t['fwd_ms']:.4f} ms (issued from the host "
        f"{t['fwd_wall_ms']:.4f}, plain {t['fwd_plain_ms']:.4f}, SDPA "
        f"{lib['fwd']:.4f}, bound {bounds['fwd'][0]:.4f} {bounds['fwd'][1]})  "
        f"bwd {t['bwd_ms']:.4f} ms (issued from the host "
        f"{t['bwd_wall_ms']:.4f}, plain {t['bwd_plain_ms']:.4f}, SDPA "
        f"backward {lib['bwd']:.4f}, forward + backward {lib['fwd_bwd']:.4f}, "
        f"bound {bounds['bwd'][0]:.4f} {bounds['bwd'][1]})"
        + ("" if same["bwd"] else "  [SDPA computes another function here"
           + (" in the backward" if same["fwd"] else "") + ": a yardstick]"))
    return rec


# key: (label, (B, H, H_kv, N, D), fp8_attention kwargs, extras)
FP8_CASES = {
    "a": ("BASELINE (1, 8, 8192, 128) e4m3 causal, mode fused",
          (1, 8, 8, 8192, 128), dict(causal=True, mode="fused"), ()),
    "b": ("(1, 8, 8192, 128) int8 causal, auto (fused)",
          (1, 8, 8, 8192, 128), dict(causal=True, fmt="int8"), ()),
    "c": ("(1, 8, 8192, 128) e5m2 causal, mode fused",
          (1, 8, 8, 8192, 128), dict(causal=True, mode="fused", fmt="e5m2"),
          ()),
    "d": ("(8, 12, 512, 64) e4m3 causal, auto (one q block: fused), "
          "dropout 0.1", (8, 12, 12, 512, 64),
          dict(causal=True, dropout_rate=0.1, dropout_seed=77), ()),
    "e": ("GQA 12/4 window 128 sinks 4 softcap 30, B=8 N=512 e4m3",
          (8, 12, 4, 512, 64),
          dict(causal=True, window=128, sinks=4, softcap=30.0), ()),
    "f": ("segment ids (4 per row) + ALiBi, B=8 H=12 N=512 e4m3",
          (8, 12, 12, 512, 64), dict(causal=True), ("segments", "alibi")),
    "g": ("int8 PV s8, (1, 8, 2048, 128) causal", (1, 8, 8, 2048, 128),
          dict(causal=True, fmt="int8", int8_pv="s8"), ()),
}
FP8_STE_SHAPE = (8, 12, 12, 512, 64)


def fp8_bound(q8, k8, opts, bq, bk, out_el, int8_pv):
    """Least time of one 8-bit forward: payloads and scales read once, o and
    the LSE written once; 4·D operations per visible (head, row, key): 2·D
    of Q.K on 8-bit operands at the fp8/int8 tensor rate, 2·D of P.V at the
    bf16 rate (p is bf16), or at the int8 rate with ``int8_pv="s8"``."""
    b, h, n_q, d = q8.shape
    n_k = k8.shape[2]
    vis = fa.visible_mask(opts, n_q, n_k, q8.device)
    pairs = (b * h * n_q * n_k if vis is None
             else int(vis.expand(b, 1, n_q, n_k).sum()) * h)
    nbytes = (q8.numel() + 2 * k8.numel()
              + 4 * (b * h * -(-n_q // bq) + 2 * k8.shape[0] * k8.shape[1]
                     * -(-n_k // bk))
              + q8.numel() * out_el + b * h * n_q * 4)
    pv_peak = INT8_FP8_OPS_PER_S if int8_pv == "s8" else BF16_FLOPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * pairs * d / INT8_FP8_OPS_PER_S + 2 * pairs * d / pv_peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def fp8_case(timer, gen, dev, key):
    label, shape, kw, extras = FP8_CASES[key]
    b, h, h_kv, n, d = shape
    q, k, v, _, _, more = _flash_inputs(gen, dev, (b, h, h_kv, n, n, d), BF16,
                                        extras)
    kw = dict(kw)
    fmt, int8_pv = kw.pop("fmt", "fp8"), kw.pop("int8_pv", "bf16")
    mode = kw.pop("mode", "auto")
    # the public call: it must launch the 8-bit kernel once
    f8.fp8_attention.launches = f8.fp8_attention.tc_launches = 0
    o_api, _ = f8.fp8_attention(q, k, v, fmt=fmt, int8_pv=int8_pv, mode=mode,
                                **kw, **more)
    torch.cuda.synchronize()
    want_tc = int(int8_pv != "s8")  # every case but (g) has D 64 or 128
    if (f8.fp8_attention.launches, f8.fp8_attention.tc_launches) != (
            1, want_tc):
        fail(f"fp8 {key}: fp8_attention launched flash_fwd_fp8 "
             f"{f8.fp8_attention.launches} times, {f8.fp8_attention.tc_launches}"
             f" on the tensor cores; want 1, {want_tc}")
    del o_api
    opts = fa.make_opts(q, k, **kw, **more)
    q8, k8, v8, sq, sk, sv, bq, bk = f8.quantize_inputs(
        q, k, v, f8.FP8_KERNEL_BLOCK_Q, f8.FP8_KERNEL_BLOCK_K, fmt)
    args = (q8, k8, v8, sq, sk, sv, bq, bk, opts)
    o, lse = f8.fp8_fwd(*args, int8_pv=int8_pv, out_dtype=BF16)
    torch.cuda.synchronize()
    o_ref, lse_ref = f8.fp8_fwd_plain(*args, int8_pv=int8_pv, out_dtype=BF16)
    tol = kernel_tol(BF16, o_ref)
    err = {"o": check_close(f"fp8 {key} o", o, o_ref, *tol)}
    err["lse"] = check_close(f"fp8 {key} lse", lse, lse_ref, LSE_TOL)
    del o_ref, lse_ref
    big = n > 4096
    ms = timer(lambda: f8.fp8_fwd(*args, int8_pv=int8_pv, out_dtype=BF16))
    fma_ms = None
    if want_tc:  # the FMA kernel on the same inputs, through the wrapper
        with mock.patch.object(f8, "_tensor_core_route", lambda *a_: False):
            fma = lambda: f8.fp8_fwd(*args, int8_pv=int8_pv, out_dtype=BF16)
            fma_ms = timer(fma, reps=3 if big else 10, warmup=1)
    plain_ms = timer(lambda: f8.fp8_fwd_plain(*args, int8_pv=int8_pv,
                                              out_dtype=BF16),
                     reps=3 if big else 10, warmup=1)
    # yardstick: SDPA on the dequantized inputs (another function)
    qd, kd, vd = (f8.dequantize_bf16(x, sc, blk) for x, sc, blk in
                  ((q8, sq, bq), (k8, sk, bk), (v8, sv, bk)))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    yardstick_ms = timer(lambda: sdpa(qd, kd, vd, is_causal=True,
                                      scale=opts.scale, enable_gqa=h != h_kv))
    bound_ms, bound_by = fp8_bound(q8, k8, opts, bq, bk, 2, int8_pv)
    rec = dict(case=label, shape=shape, fmt=fmt, int8_pv=int8_pv,
               blocks=(bq, bk), max_abs_err=err,
               tol=dict(o=dict(rtol=tol[0], atol=tol[1]), lse=LSE_TOL),
               route="tensor cores" if want_tc else "FMA", ms=ms,
               fma_ms=fma_ms, plain_ms=plain_ms, library_ms=None,
               yardstick_ms=yardstick_ms, bound_ms=bound_ms,
               bound_by=bound_by, api_launches=1)
    log(f"[kernel] flash_fwd_fp8 {key} ({label}): {rec['route']}, "
        f"max_abs_err o "
        f"{err['o']:.2e} lse {err['lse']:.2e} ({tol_text(BF16)}: p is bf16; "
        f"lse {LSE_TOL:g})  kernel {ms:.4f} ms ("
        + ("" if fma_ms is None else f"FMA kernel {fma_ms:.4f}, ")
        + f"plain {plain_ms:.4f}, SDPA on "
        f"the dequantized inputs {yardstick_ms:.4f}, bound {bound_ms:.4f} "
        f"{bound_by}); fp8_attention launched it once (checked)")
    return rec


def fp8_ste_case(timer, gen, dev):
    """The straight-through backward of fp8_attention on the card (kernel
    B4, then the flash backward kernels on the dequantized inputs) against
    the plain versions on the same inputs."""
    b, h, h_kv, n, d = FP8_STE_SHAPE
    q, k, v, do, _, _ = _flash_inputs(gen, dev, (b, h, h_kv, n, n, d), BF16, ())
    kw = dict(causal=True, dropout_rate=0.1, dropout_seed=5)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    f8.fp8_attention.launches = 0
    b0 = fa.kernel_attention.bwd_launches
    o, _ = f8.fp8_attention(*leaves, **kw)
    o.backward(do)
    torch.cuda.synchronize()
    if (f8.fp8_attention.launches, fa.kernel_attention.bwd_launches - b0) != (1, 1):
        fail("fp8 STE: want one flash_fwd_fp8 and one flash_bwd launch")
    opts = fa.make_opts(q, k, **kw)
    q8, k8, v8, sq, sk, sv, bq, bk = f8.quantize_inputs(
        q, k, v, f8.FP8_KERNEL_BLOCK_Q, f8.FP8_KERNEL_BLOCK_K, "fp8")
    o_p, lse_p = f8.fp8_fwd_plain(q8, k8, v8, sq, sk, sv, bq, bk, opts,
                                  out_dtype=BF16)
    qd, kd, vd = (f8.dequantize_bf16(x, sc, blk) for x, sc, blk in
                  ((q8, sq, bq), (k8, sk, bk), (v8, sv, bk)))
    di = (o_p.float() * do.float()).sum(-1)
    refs = fa.flash_bwd_plain(qd, kd, vd, do, lse_p, di, opts)
    err, tols = {}, {}
    for name, leaf, r in zip(("dq", "dk", "dv"), leaves, refs):
        tols[name] = kernel_tol(BF16, r)
        err[name] = check_close(f"fp8 STE {name}", leaf.grad, r, *tols[name])

    def step():
        for x in leaves:
            x.grad = None
        o, _ = f8.fp8_attention(*leaves, **kw)
        o.backward(do)

    ms = timer(step)
    log(f"[kernel] fp8 STE backward {FP8_STE_SHAPE} e4m3 dropout 0.1: max_abs_err "
        + " ".join(f"{k_} {e:.2e}" for k_, e in err.items())
        + f" ({tol_text(BF16)})  forward+backward {ms:.4f} ms")
    return dict(case=f"STE backward {FP8_STE_SHAPE} e4m3 causal dropout 0.1",
                max_abs_err=err, tol={n_: dict(rtol=r, atol=a)
                                      for n_, (r, a) in tols.items()},
                fwd_bwd_ms=ms)


def phase_kernels(dev):
    gen = torch.Generator().manual_seed(SEED)
    timer = Timer(dev)
    bf = torch.bfloat16
    gpt3 = dict(h=12, h_kv=12, d=64, max_len=512)
    recs = {
        "decode": attention_case(timer, gen, dev, "decode B=32 page=16", bf,
                                 b=32, page=16, q_len=0, **gpt3),
        "chunk": attention_case(timer, gen, dev, "chunk B=1 T=64 page=16", bf,
                                b=1, page=16, q_len=64, lengths=[448], **gpt3),
        "page24": attention_case(timer, gen, dev, "decode B=32 page=24", bf,
                                 b=32, page=24, q_len=0, **gpt3),
        "gqa": attention_case(timer, gen, dev,
                              "GQA 12/4 window=128 sinks=4 softcap=30 B=32",
                              bf, b=32, h=12, h_kv=4, d=64, page=16,
                              max_len=512, q_len=0, window=128, sinks=4,
                              softcap=30.0),
        "fp32": attention_case(timer, gen, dev, "decode fp32 B=8 page=16",
                               torch.float32, b=8, page=16, q_len=0, **gpt3),
    }
    # B7 at the engine's decode step and at a prefill chunk, every format
    for fmt in APPEND_FORMATS:
        for kind in ("decode", "chunk"):
            recs[f"append_{fmt}_{kind}"] = append_case(timer, gen, dev, fmt,
                                                       kind)
    # B5/B6 and B7 at the speculative engine's verify chunk (phase 8): B=32
    # slots of T = gamma + 1 = 5 rows, each slot at its own length
    for key, quant in (("", None), ("_fp8", "fp8")):
        recs[f"verify{key}"] = attention_case(
            timer, gen, dev, f"verify B=32 T=5 page=16 lengths 33-505 + one "
            f"at capacity{' fp8' if quant else ''}", bf, b=32, page=16,
            q_len=5, lengths=(verify_lengths(gen) + 5).tolist(), quant=quant,
            **gpt3)
        fmt = quant or "bf16"
        recs[f"append_{fmt}_verify"] = append_case(timer, gen, dev, fmt,
                                                   "verify")
    # Quantized pages: the engine's decode shape in every format and the
    # int8 schedules, an e4m3 chunk, and scripts/bench_decode.py's shape.
    for key, quant, int8_qk in (("int8_qk", "int8", None),
                                ("int8_convert", "int8", False),
                                ("fp8", "fp8", None), ("e5m2", "e5m2", None)):
        recs[f"decode_{key}"] = attention_case(
            timer, gen, dev, f"decode B=32 page=16 {key}", bf, b=32, page=16,
            q_len=0, quant=quant, int8_qk=int8_qk, **gpt3)
    recs["chunk_fp8"] = attention_case(
        timer, gen, dev, "chunk B=1 T=64 page=16 fp8", bf, b=1, page=16,
        q_len=64, lengths=[448], quant="fp8", **gpt3)
    bench = dict(b=64, h=8, h_kv=8, d=128, page=64, max_len=2048, q_len=0,
                 lengths=[2048] * 64)
    for quant in (None, "int8", "fp8"):
        recs[f"bench_decode_{quant or 'bf16'}"] = attention_case(
            timer, gen, dev, f"bench_decode B=64 H=8 D=128 len 2048 page 64 "
            f"{quant or 'bf16'}", bf, quant=quant, **bench)
    for key in FLASH_CASES:
        recs[f"flash_{key}"] = flash_case(timer, gen, dev, key)
        torch.cuda.empty_cache()
    for key in SPARSE_CASES:
        recs[f"sparse_{key}"] = sparse_case(timer, gen, dev, key)
        torch.cuda.empty_cache()
    for key in FP8_CASES:
        recs[f"fp8_{key}"] = fp8_case(timer, gen, dev, key)
        torch.cuda.empty_cache()
    recs["fp8_ste"] = fp8_ste_case(timer, gen, dev)
    return recs


# ---------------------------------------------------------------------------
# Phases 3-4: the engine
# ---------------------------------------------------------------------------


def reset_counts():
    pa.paged_attention.launches = 0
    pa.paged_attention.split_launches = 0
    pa.paged_attention.chunk_launches = 0
    f8.fp8_attention.tc_launches = 0
    pap.paged_append.launches = 0
    pap.paged_append.chunk_launches = 0
    fa.kernel_attention.fwd_launches = 0
    fa.kernel_attention.bwd_launches = 0
    fa.kernel_attention.fwd_tc_launches = 0
    fa.kernel_attention.bwd_tc_launches = 0
    f8.fp8_attention.launches = 0
    sa.sparse_attention.fwd_launches = 0
    sa.sparse_attention.bwd_launches = 0
    sa.sparse_attention.fwd_tc_launches = 0
    sa.sparse_attention.bwd_tc_launches = 0


def read_counts():
    return {"paged_attention": pa.paged_attention.launches,
            "paged_attention_split": pa.paged_attention.split_launches,
            "paged_attention_chunk": pa.paged_attention.chunk_launches,
            "flash_fwd_fp8_tc": f8.fp8_attention.tc_launches,
            "paged_append": pap.paged_append.launches,
            "paged_append_chunk": pap.paged_append.chunk_launches,
            "flash_fwd": fa.kernel_attention.fwd_launches,
            "flash_bwd": fa.kernel_attention.bwd_launches,
            "flash_fwd_tc": fa.kernel_attention.fwd_tc_launches,
            "flash_bwd_tc": fa.kernel_attention.bwd_tc_launches,
            "flash_fwd_fp8": f8.fp8_attention.launches,
            "sparse_fwd": sa.sparse_attention.fwd_launches,
            "sparse_bwd": sa.sparse_attention.bwd_launches,
            "sparse_fwd_tc": sa.sparse_attention.fwd_tc_launches,
            "sparse_bwd_tc": sa.sparse_attention.bwd_tc_launches}


def serving_config():
    """Phase 3's model and engine: GPT-3 Small widths in bf16, batch 32."""
    return (TransformerConfig(dropout_rate=0.0),
            EngineConfig(max_batch_size=32, page_size=16,
                         num_pages=32 * 32 + 1, max_seq_len=512,
                         prefill_pad=64))


def phase_engine(cfg, params, ecfg, dev, n_req, prompt_range, n_new, on_card):
    rng = np.random.default_rng(SEED)
    lens = rng.integers(prompt_range[0], prompt_range[1] + 1, size=n_req)
    reqs = [GenerationRequest(i, [int(t) for t in
                                  rng.integers(0, cfg.vocab_size, size=n)],
                              n_new) for i, n in enumerate(lens)]
    # warm-up on a separate engine: library handles, allocator build
    warm = ServingEngine(params, cfg, dataclasses.replace(ecfg, num_pages=64),
                         device=dev)
    warm.submit(GenerationRequest(-1, reqs[0].prompt[:40], 4))
    warm.run()
    del warm
    eng = ServingEngine(params, cfg, ecfg, device=dev)
    for r in reqs:
        eng.submit(r)
    if on_card:
        torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    results = eng.run()
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    st = eng.stats
    if len(results) != n_req or any(len(results[r.request_id]) != n_new
                                    for r in reqs):
        fail(f"engine served {len(results)} of {n_req} requests in full")
    rec = dict(
        requests=n_req, new_tokens=n_new,
        prompt_tokens=int(lens.sum()), wall_s=wall,
        prefill_s=st["prefill_s"], decode_s=st["decode_s"],
        prefill_chunks=st["prefill_chunks"], decode_steps=st["decode_steps"],
        decode_tokens=st["decode_tokens"],
        prefill_tok_per_s=st["prefill_tokens"] / st["prefill_s"],
        decode_tok_per_s=st["decode_tokens"] / st["decode_s"],
        launches=counts, allocator="native" if eng.allocator.is_native
        else "python",
    )
    log(f"[engine] {n_req} requests, {int(lens.sum())} prompt tokens, "
        f"{n_new} new each: wall {wall:.3f} s, prefill {rec['prefill_s']:.3f} s "
        f"({rec['prefill_tok_per_s']:.1f} tok/s), decode {rec['decode_s']:.3f} s "
        f"({rec['decode_tok_per_s']:.1f} tok/s over {st['decode_steps']} steps), "
        f"allocator {rec['allocator']}")
    log(f"[engine] launches: {counts}  prefill chunks {st['prefill_chunks']}, "
        f"decode steps {st['decode_steps']}")
    if on_card:
        n_layers = cfg.n_layers
        want_att = n_layers * (st["decode_steps"] + st["prefill_chunks"])
        for name in ("paged_attention", "paged_append"):
            if counts[name] <= 0:
                fail(f"engine phase launched {name} no time")
        if counts["paged_append"] != want_att:
            fail(f"paged_append launched {counts['paged_append']} times, "
                 f"want {n_layers} per decode step and prefill chunk = "
                 f"{want_att}")
        if counts["paged_attention"] != want_att:
            fail(f"paged_attention launched {counts['paged_attention']} times,"
                 f" want {n_layers} per decode step and prefill chunk = "
                 f"{want_att}")
        if counts["paged_attention_split"] != want_att:
            fail(f"paged_attention took the split route "
                 f"{counts['paged_attention_split']} times, want every one of"
                 f" its {want_att} launches")
        want_chunk = n_layers * st["prefill_chunks"]
        for name in ("paged_attention", "paged_append"):
            if counts[f"{name}_chunk"] != want_chunk:
                fail(f"{name} launched {counts[f'{name}_chunk']} times at "
                     f"T > 1, want {n_layers} per prefill chunk = "
                     f"{want_chunk}")
        log(f"[engine] per decode step and per prefill chunk: {n_layers} "
            f"paged_attention + {n_layers} paged_append launches, every "
            f"paged_attention launch ({n_layers * st['decode_steps']} decode,"
            f" {want_chunk} chunk, counted) on the split route (checked)")
    return rec


def device_kernels(prof) -> dict[str, float]:
    """Device microseconds by kernel name from a torch.profiler run."""
    kernels = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and getattr(e, "device_type", None) is not None and \
                "CUDA" in str(e.device_type):
            kernels[e.key] = kernels.get(e.key, 0.0) + us
    return kernels


def device_ops(prof) -> int:
    """Device operations (kernels, copies, memsets) of a torch.profiler
    run."""
    return sum(e.count for e in prof.key_averages()
               if (getattr(e, "self_device_time_total", 0) or 0) > 0
               and "CUDA" in str(getattr(e, "device_type", "")))


def count_syncs(fn) -> int:
    """Host syncs that PyTorch ops made in ``fn()`` (sync debug mode
    "warn": one warning each)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def _window(prof, wall, n, unit, tag):
    """Per-``unit`` wall ms, kernel ms, device ops, busy share and top
    kernels of a profiled window of ``n`` units."""
    kernels = device_kernels(prof)
    busy = sum(kernels.values()) / 1e6
    rec = dict(count=n, wall_ms=wall / n * 1e3,
               kernel_ms=busy / n * 1e3 if kernels else None,
               device_ops=device_ops(prof) / n if kernels else None,
               device_busy_share=busy / wall if kernels else None,
               top=sorted(((k, v / n / 1e3) for k, v in kernels.items()),
                          key=lambda kv: -kv[1])[:10])
    if not kernels:
        log(f"[profile{tag}] the profiler recorded no device time: not "
            f"measured")
        return rec
    log(f"[profile{tag}] {n} {unit}s: {rec['wall_ms']:.3f} ms/{unit} wall, "
        f"kernels {rec['kernel_ms']:.3f} ms/{unit}, {rec['device_ops']:.1f} "
        f"device ops/{unit}, device busy {100 * rec['device_busy_share']:.1f}%")
    for k, v in rec["top"]:
        log(f"[profile{tag}]   {v:.4f} ms/{unit}  {k[:90]}")
    return rec


def phase_profile(cfg, params, ecfg, dev, steps=20):
    """Where a prefill chunk's and a decode step's time goes. 32 requests
    of 200-token prompts: their admission (128 chunks of 64; each
    admission's first-token logits and readback included), then ``steps``
    decode-only steps at batch 32, first timed on the host clock alone,
    then on a fresh engine under torch.profiler. Per chunk and per step:
    wall ms (both), kernel ms, device ops (kernels, copies, memsets), the
    device's busy share (kernel time over the profiled wall time) and the
    top kernels. On the card, the warm-up engine (first calls: library
    handles, kernel loads) counts the host syncs per chunk and per step.
    Admission is timed apart from decoding through the engine's
    ``_admit``."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED + 2)
    plen = min(200, ecfg.max_seq_len // 2)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, size=plen)]
               for _ in range(ecfg.max_batch_size)]
    tag = f" {ecfg.quant}" if ecfg.quant else ""

    def engine():
        eng = ServingEngine(params, cfg, ecfg, device=dev)
        for i, prompt in enumerate(prompts):
            eng.submit(GenerationRequest(i, prompt, steps + 8))
        return eng

    warm = engine()
    if torch.device(dev).type == "cuda":
        syncs = (count_syncs(warm._admit) / warm.stats["prefill_chunks"],
                 count_syncs(lambda: [warm.step() for _ in range(4)]) / 4)
    else:
        warm.step()
    del warm
    # the same windows without the profiler: wall ms per chunk and step
    eng = engine()
    sync(dev)
    t0 = time.perf_counter()
    eng._admit()
    sync(dev)
    chunk_ms = (time.perf_counter() - t0) / eng.stats["prefill_chunks"] * 1e3
    eng.step()
    eng.step()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    sync(dev)
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    log(f"[profile{tag}] unprofiled: {chunk_ms:.3f} ms/chunk, {step_ms:.3f} "
        f"ms/step wall")
    del eng
    eng = engine()
    sync(dev)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng._admit()
        sync(dev)
        wall = time.perf_counter() - t0
    rec = {"prefill": _window(prof, wall, eng.stats["prefill_chunks"],
                              "chunk", tag)}
    eng.step()
    eng.step()
    if eng._num_active() != ecfg.max_batch_size:
        fail("profile window: not every decode slot is busy")
    sync(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        sync(dev)
        wall = time.perf_counter() - t0
    rec["decode"] = _window(prof, wall, steps, "step", tag)
    rec["prefill"]["unprofiled_wall_ms"] = chunk_ms
    rec["decode"]["unprofiled_wall_ms"] = step_ms
    rec["batch"] = ecfg.max_batch_size
    if torch.device(dev).type == "cuda":
        rec["prefill"]["syncs"], rec["decode"]["syncs"] = syncs
        log(f"[profile{tag}] host syncs: {rec['prefill']['syncs']:.2f} a "
            f"prefill chunk, {rec['decode']['syncs']:.2f} a decode step")
    return rec


def _first_logits(params, cfg, dev, prompt, steps, quant=None):
    """First-token logits (float32, host) and greedy tokens of a one-slot
    engine serving ``prompt``."""
    ecfg = EngineConfig(max_batch_size=1, page_size=16, num_pages=40,
                        max_seq_len=cfg.max_seq_len, prefill_pad=64,
                        quant=quant)
    eng = ServingEngine(params, cfg, ecfg, device=dev)
    eng.submit(GenerationRequest(0, prompt, steps))
    toks = eng.run()[0]
    return eng.last_prefill_logits.float().cpu(), toks


def _agreement(tc, tr):
    agree = sum(a == b for a, b in zip(tc, tr))
    prefix = next((i for i, (a, b) in enumerate(zip(tc, tr)) if a != b),
                  len(tc))
    return agree, prefix


def phase_vs_cpu(cfg, params, dev, prompt_len, steps, quant=None):
    """The card engine's first-token logits against the same engine on the
    CPU in float32 (plain versions): the bf16 rung for bf16 pages, the FP8
    rung for quantized pages; the latter also reports, ungated, its distance
    to the bf16 unquantized card engine."""
    rng = np.random.default_rng(SEED + 1)
    prompt = [int(t) for t in rng.integers(0, cfg.vocab_size, size=prompt_len)]
    tol = LOGITS_TOL if quant is None else FP8_TOL
    lc, tc = _first_logits(params, cfg, dev, prompt, steps, quant)
    lr, tr = _first_logits(params, dataclasses.replace(cfg, dtype=torch.float32),
                           "cpu", prompt, steps, quant)
    err = (lc - lr).abs()
    max_err = float(err.max())
    if not torch.isfinite(lc).all():
        fail("card engine logits are not finite")
    if bool((err > tol + tol * lr.abs()).any()):
        fail(f"first-token logits ({quant or 'bf16'} pages) differ by "
             f"{max_err:.3e}, over tolerance {tol:g} (abs + rel)")
    agree, prefix = _agreement(tc, tr)
    tag = f"{quant} pages" if quant else "bf16"
    log(f"[vs_cpu] {tag}: first-token logits max |card - cpu fp32| "
        f"{max_err:.3e} (tol {tol:g} abs+rel; max |logit| "
        f"{float(lr.abs().max()):.3e}); greedy tokens equal at {agree}/{steps}"
        f" steps, first {prefix} identical")
    rec = dict(quant=quant, max_abs_err=max_err, tol=tol, greedy_agree=agree,
               greedy_prefix=prefix, steps=steps)
    if quant is not None:
        lb, tb = _first_logits(params, cfg, dev, prompt, steps)
        agree_b, prefix_b = _agreement(tc, tb)
        rec.update(vs_bf16_card_max_abs=float((lc - lb).abs().max()),
                   vs_bf16_card_greedy_agree=agree_b,
                   vs_bf16_card_greedy_prefix=prefix_b)
        log(f"[vs_cpu] {tag} vs bf16 pages on the card (not gated): max "
            f"|diff| {rec['vs_bf16_card_max_abs']:.3e}; greedy tokens equal "
            f"at {agree_b}/{steps} steps, first {prefix_b} identical")
    return rec


# ---------------------------------------------------------------------------
# Phase 8: the speculative engine; phase 9: multi-host serving
# ---------------------------------------------------------------------------

SPEC_GAMMA = 4
# A self-draft proposes the target's own greedy tokens; only ties that the
# T = 1 draft steps and the T = 5 verify break differently in bf16 reject.
SPEC_ACCEPT_MIN = 0.9


def _requests(cfg, seed, n_req, prompt_range, n_new):
    """``n_req`` requests of random prompts, lengths in ``prompt_range``,
    drawn as phase 3 draws them."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt_range[0], prompt_range[1] + 1, size=n_req)
    return [GenerationRequest(i, [int(t) for t in
                                  rng.integers(0, cfg.vocab_size, size=n)],
                              n_new) for i, n in enumerate(lens)]


def _count_verify(tally):
    """Patch the engine's verify pass to add the paged-attention and append
    launches made inside each call to ``tally``."""
    real = eng_mod.verify_logits

    def counted(*args):
        p0, a0 = pa.paged_attention.launches, pap.paged_append.launches
        out = real(*args)
        tally["verify_calls"] += 1
        tally["verify_paged"] += pa.paged_attention.launches - p0
        tally["verify_append"] += pap.paged_append.launches - a0
        return out

    return mock.patch.object(eng_mod, "verify_logits", counted)


def _spec_kw(draft):
    return {} if draft is None else dict(draft_params=draft[0],
                                         draft_cfg=draft[1])


def spec_arm(name, cfg, params, ecfg, dev, reqs, draft, on_card):
    """One arm of phase 8: a warm-up engine, then the engine serving
    ``reqs`` with every launch count set to 0 just before and read just
    after. ``draft`` = (params, cfg) or None for the plain engine."""
    ecfg = ecfg if draft else dataclasses.replace(ecfg, spec_gamma=0)
    warm = ServingEngine(params, cfg, dataclasses.replace(ecfg, num_pages=64),
                         device=dev, **_spec_kw(draft))
    warm.submit(GenerationRequest(-1, reqs[0].prompt[:40], 4))
    warm.run()
    del warm
    eng = ServingEngine(params, cfg, ecfg, device=dev, **_spec_kw(draft))
    for r in reqs:
        eng.submit(r)
    sync(dev)
    tally = collections.Counter()
    reset_counts()
    with _count_verify(tally):
        t0 = time.perf_counter()
        results = eng.run()
        sync(dev)
        wall = time.perf_counter() - t0
    counts = read_counts()
    st = eng.stats
    if len(results) != len(reqs) or any(
            len(results[r.request_id]) != r.max_new_tokens for r in reqs):
        fail(f"phase 8 {name}: served {len(results)} of {len(reqs)} requests "
             f"in full")
    rec = dict(arm=name, requests=len(reqs), wall_s=wall,
               prefill_s=st["prefill_s"], prefill_chunks=st["prefill_chunks"],
               decode_tokens=st["decode_tokens"], launches=counts)
    lt, chunks = cfg.n_layers, st["prefill_chunks"]
    if draft is None:
        rec.update(decode_steps=st["decode_steps"], decode_s=st["decode_s"],
                   decode_tok_per_s=st["decode_tokens"] / st["decode_s"])
        want, want_chunk = lt * (st["decode_steps"] + chunks), lt * chunks
        log(f"[spec] {name}: {st['decode_tokens']} decode tokens in "
            f"{st['decode_steps']} steps, {rec['decode_tok_per_s']:.1f} tok/s "
            f"(decode_s {st['decode_s']:.3f}), wall {wall:.3f} s")
    else:
        ld, ticks = draft[1].n_layers, st["spec_ticks"]
        rec.update(
            draft_layers=ld, spec_ticks=ticks, spec_s=st["spec_s"],
            spec_tok_per_s=st["decode_tokens"] / st["spec_s"],
            tokens_per_tick=st["decode_tokens"] / ticks,
            tokens_per_slot_tick=st["decode_tokens"] / st["spec_slot_ticks"],
            proposed=eng.spec_proposed, accepted=eng.spec_accepted,
            acceptance=eng.spec_accepted / max(eng.spec_proposed, 1),
            verify=dict(tally))
        # L_t per verify, L_d per draft step (gamma + 1 a tick), L_t + L_d
        # per prefill chunk
        want = (lt + ld * (SPEC_GAMMA + 1)) * ticks + (lt + ld) * chunks
        want_chunk = lt * ticks + (lt + ld) * chunks
        log(f"[spec] {name} ({ld}-layer draft, gamma {SPEC_GAMMA}): "
            f"{st['decode_tokens']} decode tokens in {ticks} ticks "
            f"({rec['tokens_per_tick']:.3f} a tick, "
            f"{rec['tokens_per_slot_tick']:.3f} a busy slot), "
            f"{rec['spec_tok_per_s']:.1f}"
            f" tok/s (spec_s {st['spec_s']:.3f}), acceptance "
            f"{eng.spec_accepted}/{eng.spec_proposed} = "
            f"{rec['acceptance']:.4f}, wall {wall:.3f} s")
    log(f"[spec] {name} launches: {counts}  prefill chunks {chunks}")
    if on_card:
        for kname in ("paged_attention", "paged_append"):
            if counts[kname] != want or counts[f"{kname}_chunk"] != want_chunk:
                fail(f"phase 8 {name}: {kname} launched {counts[kname]} times "
                     f"({counts[f'{kname}_chunk']} at T > 1), want {want} "
                     f"({want_chunk})")
        if counts["paged_attention_split"] != want:
            fail(f"phase 8 {name}: {counts['paged_attention_split']} of "
                 f"{want} paged launches on the split route")
        if draft is not None and not (
                tally["verify_calls"] == st["spec_ticks"]
                and tally["verify_paged"] == tally["verify_append"]
                == lt * st["spec_ticks"]):
            fail(f"phase 8 {name}: verify launches {dict(tally)}, want "
                 f"{lt} paged + {lt} append in each of {st['spec_ticks']} "
                 f"ticks")
        log(f"[spec] {name}: launch counts exact (paged and append {want} "
            f"each, {want_chunk} at T > 1, every paged launch split)")
    return rec, results


def _verify_vs_cpu(cfg, params, eng):
    """One speculative tick of ``eng`` with its verify pass's inputs
    snapshotted (caches copied to the CPU, page rows, lengths, chunk
    tokens); ``verify_logits`` on the same inputs on the CPU in float32
    against the card's."""
    snap = {}
    real = eng_mod.verify_logits

    def capture(w, c, caches, tokens, pi, ln):
        if not snap:
            snap["args"] = (
                [PagedKVCache(k_pages=x.k_pages.float().cpu(),
                              v_pages=x.v_pages.float().cpu())
                 for x in caches], tokens.cpu(), pi.cpu(), ln.cpu())
            out = real(w, c, caches, tokens, pi, ln)
            snap["logits"] = out.float().cpu()
            return out
        return real(w, c, caches, tokens, pi, ln)

    with mock.patch.object(eng_mod, "verify_logits", capture):
        eng.step()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    w32 = eng_mod._serving_weights(params, cfg32, "cpu")
    lr = eng_mod.verify_logits(w32, cfg32, *snap["args"])
    lc = snap["logits"]
    err = (lc - lr).abs()
    max_err = float(err.max())
    if not torch.isfinite(lc).all():
        fail("phase 8: card verify logits are not finite")
    if bool((err > LOGITS_TOL + LOGITS_TOL * lr.abs()).any()):
        fail(f"phase 8: verify logits differ from the CPU's by {max_err:.3e}, "
             f"over {LOGITS_TOL:g} abs+rel")
    lengths = snap["args"][3]
    log(f"[spec] verify logits {tuple(lc.shape)} at lengths "
        f"{int(lengths.min())}-{int(lengths.max())}: max |card - cpu fp32| "
        f"{max_err:.3e} (tol {LOGITS_TOL:g} abs+rel)")
    return dict(max_abs_err=max_err, tol=LOGITS_TOL, shape=list(lc.shape),
                lengths=lengths.tolist())


def spec_profile(name, cfg, params, ecfg, dev, draft, ticks=5,
                 snapshot=False):
    """Where a speculative tick's time goes: 32 requests of 32-128-token
    prompts (64 new tokens each) admitted, two ticks, then ``ticks`` ticks
    on the host clock, then on a fresh engine ``ticks`` ticks under
    torch.profiler (wall ms, kernel ms, device ops per tick, the device's
    busy share, the top kernels); host syncs per tick on a warm-up engine
    (card only). ``snapshot``: one more tick first, with its verify pass
    held against the CPU (``_verify_vs_cpu``)."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED + 2)
    plen = min(128, ecfg.max_seq_len // 4)
    n_new = min(64, ecfg.max_seq_len // 2)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, size=n)]
               for n in rng.integers(plen // 4, plen + 1,
                                     size=ecfg.max_batch_size)]
    tag = f" {name}"

    def engine():
        eng = ServingEngine(params, cfg, ecfg, device=dev, **_spec_kw(draft))
        for i, prompt in enumerate(prompts):
            eng.submit(GenerationRequest(i, prompt, n_new))
        eng._admit()
        eng.step()
        eng.step()
        sync(dev)
        return eng

    rec = {}
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        warm = engine()
        rec["syncs"] = count_syncs(
            lambda: [warm.step() for _ in range(ticks)]) / ticks
        del warm
    eng = engine()
    if snapshot:
        rec["verify_vs_cpu"] = _verify_vs_cpu(cfg, params, eng)
    tokens0 = eng.stats["decode_tokens"]
    t0 = time.perf_counter()
    for _ in range(ticks):
        eng.step()
    sync(dev)
    rec["unprofiled_wall_ms"] = (time.perf_counter() - t0) / ticks * 1e3
    rec["tokens_per_tick"] = (eng.stats["decode_tokens"] - tokens0) / ticks
    if eng._num_active() != ecfg.max_batch_size:
        fail(f"phase 8 {name} profile: not every slot stayed busy")
    del eng
    eng = engine()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.step()
        sync(dev)
        wall = time.perf_counter() - t0
    rec.update(_window(prof, wall, ticks, "tick", tag))
    log(f"[profile{tag}] unprofiled: {rec['unprofiled_wall_ms']:.3f} ms/tick "
        f"wall, {rec['tokens_per_tick']:.2f} tokens a tick"
        + (f"; host syncs {rec['syncs']:.2f} a tick" if on_card else ""))
    return rec


def _agreements(results, ref):
    """Per request: (tokens equal to ``ref``'s, length of the equal
    prefix)."""
    return {rid: _agreement(results[rid], ref[rid]) for rid in ref}


def phase_spec(cfg, params, ecfg, dev, n_req, prompt_range, n_new, draft2,
               on_card):
    """The speculative engine (spec_gamma 4) in three arms on the same
    requests: plain (no draft; its tokens are the reference), self (the
    target as its own draft: the acceptance ceiling) and draft2 (a 2-layer
    draft of random weights: the floor); then each spec arm's profile, the
    self arm's with the verify pass held against the CPU."""
    reqs = _requests(cfg, SEED, n_req, prompt_range, n_new)
    ecfg = dataclasses.replace(ecfg, spec_gamma=SPEC_GAMMA)
    arms = {"plain": None, "self": (params, cfg), "draft2": draft2}
    rec, results = {}, {}
    for name, draft in arms.items():
        rec[name], results[name] = spec_arm(name, cfg, params, ecfg, dev, reqs,
                                            draft, on_card)
    for name in ("self", "draft2"):
        agree = _agreements(results[name], results["plain"])
        rec[name]["agreement"] = {
            "tokens_equal": sum(a for a, _ in agree.values()),
            "tokens": sum(len(v) for v in results["plain"].values()),
            "requests_identical": sum(p == n_new for _, p in agree.values())}
        log(f"[spec] {name} vs plain: {rec[name]['agreement']} (not gated)")
    acc = rec["self"]["acceptance"]
    if acc < SPEC_ACCEPT_MIN:
        fail(f"phase 8: self-draft acceptance {acc:.4f} < {SPEC_ACCEPT_MIN}")
    log(f"[spec] self-draft acceptance {acc:.4f} >= {SPEC_ACCEPT_MIN}")
    for name in ("self", "draft2"):
        rec[name]["profile"] = spec_profile(name, cfg, params, ecfg, dev,
                                            arms[name],
                                            snapshot=name == "self")
    return rec


def phase_multihost(cfg, ecfg, dev, n_req, prompt_range, n_new, draft_cfg):
    """Two ProcessEngine workers on ``dev`` (seeds 0 and 1) under
    MultiHostScheduler, drained with run_async / wait_run, against two
    in-process engines from the same seeds under the same scheduler: the
    same routes and the same tokens, exactly. Plain, then speculative
    (``draft_cfg``, draft seed SEED + 1, gamma 4). All four workers start
    at once; a worker that fails to start or raises fails the phase."""
    reqs = _requests(cfg, SEED + 3, n_req, prompt_range, n_new)
    arms = {"plain": (ecfg, None),
            "spec": (dataclasses.replace(ecfg, spec_gamma=SPEC_GAMMA),
                     draft_cfg)}
    procs, rec = {}, {}
    try:
        for arm, (e, dcfg) in arms.items():
            procs[arm] = [ProcessEngine(cfg, e, param_seed=i, device=dev,
                                        draft_cfg=dcfg, draft_seed=SEED + 1)
                          for i in range(2)]
        for arm, (e, dcfg) in arms.items():
            kw = ({} if dcfg is None else
                  dict(draft_params=init_params(dcfg, SEED + 1, device=dev),
                       draft_cfg=dcfg))
            sched = MultiHostScheduler([
                ServingEngine(init_params(cfg, i, device=dev), cfg, e,
                              device=dev, **kw) for i in range(2)])
            routes = [sched.submit(r) for r in reqs]
            t1 = time.perf_counter()
            expected = sched.run()
            sync(dev)
            in_process_s = time.perf_counter() - t1
            del sched, kw
            t1 = time.perf_counter()
            psched = MultiHostScheduler(procs[arm])
            proutes = [psched.submit(r) for r in reqs]
            submit_s = time.perf_counter() - t1
            t1 = time.perf_counter()
            for p in procs[arm]:
                p.run_async()
            got = {}
            for p in procs[arm]:
                got.update(p.wait_run())
            workers_s = time.perf_counter() - t1
            if proutes != routes:
                fail(f"phase 9 {arm}: workers routed {proutes}, in-process "
                     f"{routes}")
            if len(got) != n_req or any(len(v) != n_new for v in got.values()):
                fail(f"phase 9 {arm}: workers served {len(got)} of {n_req} "
                     f"requests in full")
            if got != expected:
                bad = [r for r in expected if got.get(r) != expected[r]]
                fail(f"phase 9 {arm}: worker tokens differ from the "
                     f"in-process engines' for requests {bad}")
            rec[arm] = dict(routes=routes, in_process_s=in_process_s,
                            submit_s=submit_s, workers_run_s=workers_s)
            log(f"[multihost] {arm}: {n_req} requests routed {routes.count(0)}"
                f"/{routes.count(1)}; two workers on {dev} equal two "
                f"in-process engines exactly (workers drained in "
                f"{workers_s:.3f} s, in-process {in_process_s:.3f} s; first "
                f"submits {submit_s:.3f} s, worker start included)")
    except RuntimeError as e:
        fail(f"phase 9: {e}")
    finally:
        for ps in procs.values():
            for p in ps:
                p.close()
    return rec


def _fa3_fp8_run(q, k, v, do, fmt, saved=None):
    """fa3_attention(fp8=True) forward and backward: (o, lse, dq, dk, dv).
    With ``saved`` = (o, lse) of another run, the straight-through backward
    takes those in place of this forward's own: its di = rowsum(o * do) then
    reads the same o as that run's backward did."""
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    o, lse = fa3_attention(*leaves, causal=True, fp8=True, fp8_fmt=fmt)
    if saved is None:
        o.backward(do)
    else:
        flash_bwd = fa.flash_bwd

        def with_saved(qd, kd, vd, o_, lse_, *rest):
            return flash_bwd(qd, kd, vd, saved[0].to(o_), saved[1].to(lse_),
                             *rest)

        with mock.patch.object(fa, "flash_bwd", with_saved):
            o.backward(do)
    return [o.detach(), lse.detach()] + [x.grad for x in leaves]


def phase_fa3_fp8(dev, shape, check_shape, on_card):
    """The FA3 8-bit path through its public entry point:
    ``fa3_attention(fp8=True)`` forward and backward on the kernel backend,
    e4m3 (auto mode: more than one q block, so predecode = dequantize +
    flash_fwd) and int8 (auto mode: fused = flash_fwd_fp8).

    At ``shape`` counts are set to 0 just before each run and read just
    after (one 8-bit or flash forward and one flash backward), outputs must
    be finite, and the distance of o to exact attention is reported (the
    quantization's error, not gated). At ``check_shape`` the card's o, LSE
    and gradients are held against the same call on the CPU (plain
    versions), all at the kernels' limits; the CPU's backward takes the
    card's o and LSE, so both backward runs read the same di."""
    gen = torch.Generator().manual_seed(SEED + 4)
    base = [torch.randn(shape, generator=gen) for _ in range(4)]
    q, k, v, do = (x.to(dev, torch.bfloat16) for x in base)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    exact = sdpa(q.float(), k.float(), v.float(), is_causal=True)
    small = [x[:, :, :check_shape[2]].contiguous() for x in base]
    out = {}
    for fmt, want in (("fp8", "flash_fwd"), ("int8", "flash_fwd_fp8")):
        sync(dev)
        reset_counts()
        t0 = time.perf_counter()
        res = _fa3_fp8_run(q, k, v, do, fmt)
        sync(dev)
        wall = time.perf_counter() - t0
        counts = read_counts()
        o = res[0]
        if (not all(torch.isfinite(x.float()).all() for x in res)
                or o.shape != q.shape):
            fail(f"fa3_attention(fp8=True, {fmt}): non-finite or misshapen "
                 f"output")
        if on_card:
            other = "flash_fwd_fp8" if want == "flash_fwd" else "flash_fwd"
            if (counts[want], counts[other], counts["flash_bwd"]) != (1, 0, 1):
                fail(f"fa3_attention(fp8=True, {fmt}) launched {counts}; want "
                     f"one {want} and one flash_bwd")
            if want == "flash_fwd_fp8" and counts["flash_fwd_fp8_tc"] != 1:
                fail(f"fa3_attention(fp8=True, {fmt}): flash_fwd_fp8 did not "
                     f"take the tensor-core route")
        vs_exact = float((o.float() - exact).abs().max())
        del res, o
        # the same call on the CPU at the small shape
        card = _fa3_fp8_run(*(x.to(dev, torch.bfloat16) for x in small), fmt)
        cpu = _fa3_fp8_run(*(x.to(torch.bfloat16) for x in small), fmt,
                           saved=[x.cpu() for x in card[:2]])
        err = {}
        for name, a, r in zip(("o", "lse", "dq", "dk", "dv"), card, cpu):
            tol = ((LSE_TOL, LSE_TOL) if name == "lse"
                   else kernel_tol(BF16, r))
            err[name] = check_close(f"fa3 fp8 {fmt} {name} card vs cpu",
                                    a.cpu(), r, *tol)
        out[fmt] = dict(max_abs_vs_exact=vs_exact, fwd_bwd_wall_ms=wall * 1e3,
                        launches=counts, check_shape=check_shape,
                        card_vs_cpu_max_abs=err)
        log(f"[fa3_fp8] {shape} causal {fmt}: forward+backward {wall * 1e3:.2f}"
            f" ms wall (first call); launches {counts}; max |o - exact| "
            f"{vs_exact:.3e} (quantization error, not gated); at "
            f"{check_shape} card vs cpu: "
            + " ".join(f"{n_} {e:.2e}" for n_, e in err.items())
            + f" (o and gradients {tol_text(BF16)}; lse {LSE_TOL:g}; the "
            f"cpu backward takes the card's o and lse)")
    return out


# ---------------------------------------------------------------------------
# Phases 5-6: training
# ---------------------------------------------------------------------------


def phase_train(cfg, tc, dev, on_card, n_warm=2, n_timed=8,
                tag="train", batches=None, check_batch=None):
    """The port's training main path: ``train_step`` (forward, backward,
    optimizer) on the synthetic stream, or on ``batches`` (an iterator of
    CPU batches, moved to the card as ``train`` moves them); host-clock
    time per micro-step up to ``loss.item()``; exact launch counts; one
    profiled micro-step. ``check_batch``: a batch whose loss (no dropout)
    is taken before the first micro-step and after the timed ones."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device=dev)
    opt = ttrain.make_optimizer(params, tc)
    if batches is None:
        batches = list(ttrain.synthetic_batches(
            tc, cfg.vocab_size, n_warm + n_timed + 1, device=dev))
    batches = iter(batches)
    log(f"[{tag}] {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
        f"heads, vocab {cfg.vocab_size}, dropout {cfg.dropout_rate}, remat "
        f"{cfg.remat_policy if cfg.remat else 'off'}, {cfg.dtype}; batch "
        f"{tc.batch_size} x {tc.seq_len}, grad_accum {tc.grad_accum} "
        f"(set-up {time.perf_counter() - t0:.1f} s)")

    def micro(step):
        batch = {k: v.to(dev) for k, v in next(batches).items()}
        return ttrain.train_step(params, opt, batch,
                                 ttrain.step_seed(tc, step), cfg)

    def check_loss():
        if check_batch is None:
            return None
        with torch.no_grad():
            return float(ttrain.loss_fn(
                params, {k: v.to(dev) for k, v in check_batch.items()},
                dataclasses.replace(cfg, dropout_rate=0.0), None))

    check_before = check_loss()
    warm_losses = [float(micro(step)) for step in range(n_warm)]
    sync(dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    updates0 = opt.updates
    times, losses = [], []
    for step in range(n_warm, n_warm + n_timed):
        t0 = time.perf_counter()
        losses.append(micro(step).item())
        times.append(time.perf_counter() - t0)
    counts = read_counts()
    if not all(np.isfinite(losses)):
        fail(f"training losses are not finite: {losses}")
    check_after = check_loss()
    tokens = tc.batch_size * tc.seq_len
    step_ms = [t * 1e3 for t in times]
    rec = dict(
        micro_steps=n_timed, updates=opt.updates - updates0, losses=losses,
        warm_losses=warm_losses, check_loss_before=check_before,
        check_loss_after=check_after,
        step_ms=step_ms, median_step_ms=statistics.median(step_ms),
        tokens_per_s=tokens * n_timed / sum(times), launches=counts,
        max_memory_allocated=(torch.cuda.max_memory_allocated()
                              if on_card else None),
    )
    log(f"[{tag}] {n_timed} micro-steps ({rec['updates']} optimizer "
        f"updates): median {rec['median_step_ms']:.2f} ms/micro-step, "
        f"{rec['tokens_per_s']:.1f} tokens/s; losses "
        + " ".join(f"{x:.4f}" for x in losses))
    log(f"[{tag}] launches: {counts}")
    if on_card:
        per = (2 if cfg.remat else 1) * cfg.n_layers
        want = {"flash_fwd": per * n_timed, "flash_bwd": cfg.n_layers * n_timed}
        want["flash_fwd_tc"] = want["flash_fwd"]  # bf16, D = 64: every one
        want["flash_bwd_tc"] = want["flash_bwd"]  # on the tensor cores
        for name, n in want.items():
            if counts[name] != n:
                fail(f"training launched {name} {counts[name]} times, want "
                     f"{n} ({n // n_timed} per micro-step)")
        log(f"[{tag}] per micro-step: {per} flash_fwd + {cfg.n_layers} "
            f"flash_bwd launches, all on the tensor-core route (checked); "
            f"max_memory_allocated "
            f"{rec['max_memory_allocated'] / 2 ** 30:.3f} GiB")
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        micro(n_warm + n_timed).item()
        wall = time.perf_counter() - t0
    kernels = device_kernels(prof)
    busy = sum(kernels.values()) / 1e6
    flash = {part: sum(v for k, v in kernels.items() if part in k) / 1e3
             for part in ("flash_fwd", "flash_bwd")}
    rec["profile"] = dict(
        wall_ms=wall * 1e3, kernel_ms=busy * 1e3,
        device_busy_share=busy / wall if kernels else None,
        flash_ms=flash,
        top=sorted(((k, v / 1e3) for k, v in kernels.items()),
                   key=lambda kv: -kv[1])[:12])
    if kernels:
        log(f"[{tag}] profiled micro-step: {wall * 1e3:.2f} ms wall, kernels "
            f"{busy * 1e3:.2f} ms, device busy {100 * busy / wall:.1f}%; "
            f"flash kernels: forward {flash['flash_fwd']:.4f} ms, backward "
            f"{flash['flash_bwd']:.4f} ms")
        for k, v in rec["profile"]["top"]:
            log(f"[{tag}]   {v:.4f} ms  {k[:90]}")
    else:
        log(f"[{tag}] the profiler recorded no device time: not measured")
    return rec


def phase_train_vs_cpu(cfg, dev, n=512):
    """One training loss and its gradients (B=1, dropout 0): the bf16 card
    against the fp32 CPU, from the same fp32 parameters."""
    cfg = dataclasses.replace(cfg, dropout_rate=0.0)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    ref_params = init_params(cfg32, seed=SEED + 3, device="cpu")
    card_params = copy.deepcopy(ref_params).to(dev)
    toks = torch.from_numpy(np.random.default_rng(SEED + 3).integers(
        0, cfg.vocab_size, size=(1, n + 1)))
    out = {}
    for tag, params, c in (("card", card_params, cfg),
                           ("cpu_fp32", ref_params, cfg32)):
        loss = ttrain.loss_fn(params, {"tokens": toks.to(
            next(params.parameters()).device)}, c, None)
        loss.backward()
        out[tag] = (loss.item(), {name: p.grad.float().cpu()
                                  for name, p in params.named_parameters()})
    (lc, gc), (lr, gr) = out["card"], out["cpu_fp32"]
    if not np.isfinite(lc):
        fail("card training loss is not finite")
    loss_err = abs(lc - lr)
    num = sum(float((gc[k] - gr[k]).square().sum()) for k in gr)
    den = sum(float(gr[k].square().sum()) for k in gr)
    rel = (num / den) ** 0.5
    per = {k: float((gc[k] - gr[k]).norm() / gr[k].norm().clamp(min=1e-30))
           for k in gr}
    worst = max(per, key=per.get)
    log(f"[train_vs_cpu] loss card bf16 {lc:.6f} vs cpu fp32 {lr:.6f} (|diff| "
        f"{loss_err:.3e}, tol {TRAIN_TOL:g} abs+rel); gradient global "
        f"relative L2 {rel:.3e} (tol {TRAIN_TOL:g}); worst tensor {worst} "
        f"{per[worst]:.3e}")
    if loss_err > TRAIN_TOL + TRAIN_TOL * abs(lr):
        fail(f"training loss differs by {loss_err:.3e}")
    if not rel <= TRAIN_TOL:
        fail(f"gradient relative L2 error {rel:.3e} over {TRAIN_TOL:g}")
    return dict(loss_card=lc, loss_cpu=lr, loss_abs_err=loss_err,
                grad_rel_l2=rel, worst_tensor=worst, worst_rel_l2=per[worst],
                tol=TRAIN_TOL)


# ---------------------------------------------------------------------------
# Phase 7: the block-sparse model
# ---------------------------------------------------------------------------


def _sparse_loss(params, toks, cfg, pattern):
    """Next-token CE of toks (B, N+1) through the model with a pattern."""
    logits = apply_transformer(params, toks[:, :-1], cfg,
                               sparse_pattern=pattern)
    return ttrain.token_nll(logits, toks[:, 1:]).mean()


def _sparse_vs_cpu(cfg, dev, n, pattern):
    """Loss and gradients through the sparse route: the bf16 card against
    the fp32 CPU (plain versions), from the same fp32 parameters."""
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    ref_params = init_params(cfg32, seed=SEED + 5, device="cpu")
    card_params = copy.deepcopy(ref_params).to(dev)
    toks = torch.from_numpy(np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab_size, size=(1, n + 1)))
    out = {}
    for tag, params, c, d in (("card", card_params, cfg, dev),
                              ("cpu_fp32", ref_params, cfg32, "cpu")):
        loss = _sparse_loss(params, toks.to(d), c, pattern.to(d))
        loss.backward()
        out[tag] = (loss.item(), {name: p.grad.float().cpu()
                                  for name, p in params.named_parameters()})
    (lc, gc), (lr, gr) = out["card"], out["cpu_fp32"]
    loss_err = abs(lc - lr)
    rel = (sum(float((gc[k] - gr[k]).square().sum()) for k in gr)
           / sum(float(gr[k].square().sum()) for k in gr)) ** 0.5
    log(f"[sparse] card vs cpu at N={n}, pattern {pattern.int().tolist()}: "
        f"loss bf16 {lc:.6f} vs fp32 {lr:.6f} (|diff| {loss_err:.3e}, tol "
        f"{TRAIN_TOL:g} abs+rel); gradient global relative L2 {rel:.3e} (tol "
        f"{TRAIN_TOL:g})")
    if not np.isfinite(lc) or loss_err > TRAIN_TOL + TRAIN_TOL * abs(lr):
        fail(f"sparse model loss card vs cpu differs by {loss_err:.3e}")
    if not rel <= TRAIN_TOL:
        fail(f"sparse model gradient relative L2 error {rel:.3e} over "
             f"{TRAIN_TOL:g}")
    return dict(n=n, loss_card=lc, loss_cpu=lr, loss_abs_err=loss_err,
                grad_rel_l2=rel, tol=TRAIN_TOL)


def phase_sparse_model(cfg, dev, on_card, b, n, check_n, n_timed=3):
    """The block-sparse slice's main path at ``cfg``: the local + global
    pattern on the n / block_size square of tiles, through
    ``apply_transformer(sparse_pattern=...)``. (1) one no-grad forward;
    (2) forward, next-token CE and backward, one untimed then ``n_timed``
    timed on the host clock up to ``loss.item()``; counts set to 0 just
    before each and read just after; (3) one step under torch.profiler;
    (4) loss and gradients, bf16 card vs fp32 CPU, at ``check_n`` with the
    4 x 4 pattern of tests/test_sparse.py; (5) an all-ones pattern (the
    sparse route) against no pattern (the flash route), logits at the bf16
    rung."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device=dev)
    n_tiles = -(-n // cfg.block_size)
    pattern = local_global(n_tiles, n_tiles).to(dev)
    toks = torch.from_numpy(np.random.default_rng(SEED + 6).integers(
        0, cfg.vocab_size, size=(b, n + 1))).to(dev)
    reach = sa.tile_pattern(pattern, n_tiles, n_tiles, cfg.block_size,
                            cfg.block_size, True, 0)
    log(f"[sparse] {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, vocab {cfg.vocab_size}, remat "
        f"{cfg.remat_policy if cfg.remat else 'off'}, {cfg.dtype}; B={b} "
        f"N={n}; local+global pattern: {int(reach.sum())} of "
        f"{n_tiles * (n_tiles + 1) // 2} causally reachable tiles (set-up "
        f"{time.perf_counter() - t0:.1f} s)")
    L = cfg.n_layers
    rec = dict(b=b, n=n, active_tiles=int(reach.sum()),
               reachable_tiles=n_tiles * (n_tiles + 1) // 2)

    sync(dev)
    reset_counts()
    with torch.no_grad():
        logits = apply_transformer(params, toks[:, :-1], cfg,
                                   sparse_pattern=pattern)
    sync(dev)
    rec["forward_launches"] = counts = read_counts()
    if logits.shape != (b, n, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        fail("sparse model logits are misshapen or not finite")
    del logits
    log(f"[sparse] no-grad forward launches: {counts}")
    if on_card and (counts["sparse_fwd"], counts["sparse_fwd_tc"],
                    counts["flash_fwd"]) != (L, L, 0):
        fail(f"no-grad forward launched {counts}; want {L} sparse_fwd on the "
             f"tensor-core route and no flash_fwd")

    def step():
        params.zero_grad(set_to_none=True)
        loss = _sparse_loss(params, toks, cfg, pattern)
        loss.backward()
        return loss.item()

    step()
    sync(dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, losses = [], []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        losses.append(step())
        times.append(time.perf_counter() - t0)
    rec["launches"] = counts = read_counts()
    step_ms = [x * 1e3 for x in times]
    rec.update(step_ms=step_ms, median_step_ms=statistics.median(step_ms),
               losses=losses, tokens_per_s=b * n * n_timed / sum(times),
               max_memory_allocated=(torch.cuda.max_memory_allocated()
                                     if on_card else None))
    if not all(np.isfinite(losses)):
        fail(f"sparse model losses are not finite: {losses}")
    log(f"[sparse] {n_timed} forward+backward steps: median "
        f"{rec['median_step_ms']:.2f} ms, {rec['tokens_per_s']:.1f} tokens/s; "
        f"losses " + " ".join(f"{x:.4f}" for x in losses))
    log(f"[sparse] launches: {counts}")
    if on_card:
        want = dict(sparse_fwd=2 * L * n_timed, sparse_bwd=L * n_timed,
                    sparse_fwd_tc=2 * L * n_timed, sparse_bwd_tc=L * n_timed,
                    flash_fwd=0, flash_bwd=0)
        got = {k: counts[k] for k in want}
        if got != want:
            fail(f"sparse steps launched {got}; want {want} ({2 * L} "
                 f"sparse_fwd and {L} sparse_bwd per step, all on the "
                 f"tensor-core route)")
        log(f"[sparse] per step: {2 * L} sparse_fwd + {L} sparse_bwd, all on "
            f"the tensor-core route, no flash launch (checked); "
            f"max_memory_allocated "
            f"{rec['max_memory_allocated'] / 2 ** 30:.3f} GiB")

    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        wall = time.perf_counter() - t0
    kernels = device_kernels(prof)
    busy = sum(kernels.values()) / 1e6
    sparse_ms = {k: v / 1e3 for k, v in kernels.items() if "sparse_" in k}
    rec["profile"] = dict(
        wall_ms=wall * 1e3, kernel_ms=busy * 1e3,
        device_busy_share=busy / wall if kernels else None,
        sparse_kernels_ms=sparse_ms,
        top=sorted(((k, v / 1e3) for k, v in kernels.items()),
                   key=lambda kv: -kv[1])[:12])
    if kernels:
        log(f"[sparse] profiled step: {wall * 1e3:.2f} ms wall, kernels "
            f"{busy * 1e3:.2f} ms, device busy {100 * busy / wall:.1f}%; "
            f"sparse kernels {sum(sparse_ms.values()):.4f} ms ("
            + ", ".join(f"{k.split('<')[0].split('::')[-1]} {v:.4f}"
                        for k, v in sorted(sparse_ms.items())) + ")")
        for k, v in rec["profile"]["top"]:
            log(f"[sparse]   {v:.4f} ms  {k[:90]}")
    else:
        log("[sparse] the profiler recorded no device time: not measured")
    del params
    if on_card:
        torch.cuda.empty_cache()

    p4 = torch.tensor([[1, 0, 0, 0], [1, 1, 0, 0], [0, 1, 1, 0], [1, 0, 1, 1]],
                      dtype=torch.bool)
    rec["vs_cpu"] = _sparse_vs_cpu(cfg, dev, check_n, p4)

    params = init_params(cfg, seed=SEED + 7, device=dev)
    with torch.no_grad():
        ones = apply_transformer(params, toks[:, :-1], cfg,
                                 sparse_pattern=torch.ones_like(pattern))
        dense = apply_transformer(params, toks[:, :-1], cfg)
    err = (ones - dense).abs()
    rec["ones_vs_dense_max_abs"] = max_err = float(err.max())
    log(f"[sparse] all-ones pattern vs no pattern (flash route): logits max "
        f"|diff| {max_err:.3e} (tol {LOGITS_TOL:g} abs+rel; max |logit| "
        f"{float(dense.abs().max()):.3e})")
    if bool((err > LOGITS_TOL + LOGITS_TOL * dense.abs()).any()):
        fail(f"all-ones pattern logits differ from the dense route by "
             f"{max_err:.3e}")
    return rec


# ---------------------------------------------------------------------------
# Phase 10: context parallelism on one card; the parallel steps on one rank
# ---------------------------------------------------------------------------

CP_WORLD = 4
CP_KINDS = ring.KINDS
# Forward (and backward) partials of the causal schedules of 4 ranks: r + 1
# on rank r for the ring (10), twice as many halves for the bidirectional
# ring, one call a rank for all-gather. A future shard launches nothing.
CP_LAUNCHES = {"ring": 10, "bidir": 20, "all_gather": 4}
STEP_TOL = 1e-6  # the parallel steps on one rank against models/train.py


def _plain_schedules():
    """Sends the schedules' flash calls to the plain versions (on the card
    too): the schedules' plain time."""
    return (mock.patch.object(fa, "flash_fwd", fa.flash_fwd_plain),
            mock.patch.object(fa, "flash_bwd_di", fa.flash_bwd_plain))


def _checked_schedules(err, tag, atol):
    """Holds every flash launch of the schedules against its plain version
    on the same inputs, keeping the largest error of each output in
    ``err``: the flash limit of the whole attention the partials make up
    (rtol two ulps, ``atol[name]`` 1e-3 of the whole call's largest value,
    as phase 2 holds the same kernel on a whole call: a partial over one
    shard of keys has only small outputs, so its own largest value would
    set no limit), the LSE at 1e-4 where a row sees a key, else the mask
    value. Each partial is checked, not the sum of bf16 partials, which a
    kernel and its plain version round apart."""
    kernel_fwd, kernel_bwd = fa.flash_fwd, fa.flash_bwd_di

    def keep(name, a, r, dtype):
        e = check_close(f"phase 10 {tag} partial {name}", a, r,
                        KERNEL_RTOL[dtype], atol[name])
        err[name] = max(err.get(name, 0.0), e)

    def fwd(q, k, v, opts):
        o, lse = kernel_fwd(q, k, v, opts)
        o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, opts)
        keep("o", o, o_ref, q.dtype)
        seen = lse_ref > -1e30
        if not bool((lse[~seen] <= -1e30).all()):
            fail(f"phase 10 {tag}: a row without keys has an LSE above -1e30")
        if bool(seen.any()):  # segment ids can hide a whole shard
            e = check_close(f"phase 10 {tag} partial lse", lse[seen],
                            lse_ref[seen], LSE_TOL)
            err["lse"] = max(err.get("lse", 0.0), e)
        return o, lse

    def bwd(q, k, v, do, lse, di, opts):
        out = kernel_bwd(q, k, v, do, lse, di, opts)
        for name, a, r in zip(("dq", "dk", "dv"), out,
                              fa.flash_bwd_plain(q, k, v, do, lse, di, opts)):
            keep(name, a, r, q.dtype)
        return out

    return (mock.patch.object(fa, "flash_fwd", fwd),
            mock.patch.object(fa, "flash_bwd_di", bwd))


def cp_case(gen, dev, shape, dtype, seg, on_card):
    """The ring, bidirectional-ring and all-gather schedules of CP_WORLD
    ranks, rank by rank on one device, against one flash call over the whole
    sequence (causal, same route): o, dq, dk, dv at the flash limit, the LSE
    at 1e-4; exact launches; every partial launch held against its plain
    version; each rank's schedule timed (a stream hold long enough for the
    host to issue all its partials, so the events bracket device work), and
    on the plain versions."""
    b, h, n, d = shape
    q, k, v, do = (torch.randn(shape, generator=gen).to(dev, dtype)
                   for _ in range(4))
    dlse = torch.randn((b, h, n), generator=gen).to(dev)
    ids = None
    if seg:  # 8 documents of random lengths a row, across shard boundaries
        cuts = torch.sort(torch.randint(1, n, (b, 7), generator=gen)).values
        ids = (torch.arange(n)[None, :, None] >= cuts[:, None, :]).sum(-1)
        ids = ids.to(dev, torch.int32)
    opts = fa.make_opts(q, k, causal=True, segment_ids=ids)
    o_ref, lse_ref = fa.flash_fwd(q, k, v, opts)
    grads = fa.flash_bwd(q, k, v, o_ref, lse_ref, do, dlse, opts)
    refs = dict(zip(("o", "lse", "dq", "dk", "dv"), (o_ref, lse_ref, *grads)))
    bounds, _ = flash_bound(q, k, opts, dlse)
    tag = "segment ids" if seg else "causal"
    rec = dict(shape=list(shape), dtype=str(dtype).replace("torch.", ""),
               segments=seg, fwd_bound_ms=bounds["fwd"][0],
               fwd_bound_by=bounds["fwd"][1], bwd_bound_ms=bounds["bwd"][0],
               bwd_bound_by=bounds["bwd"][1])
    if on_card:
        timer = Timer(dev, sleep_cycles=40 * Timer.SLEEP_CYCLES)  # 8 partials
        rec["single_fwd_ms"] = timer(lambda: fa.flash_fwd(q, k, v, opts),
                                     reps=10)
        rec["single_bwd_ms"] = timer(lambda: fa.flash_bwd(
            q, k, v, o_ref, lse_ref, do, dlse, opts), reps=10)
    w = CP_WORLD
    qs, dos, dlses = q.chunk(w, 2), do.chunk(w, 2), dlse.chunk(w, 2)
    q_ids = [None] * w if ids is None else ids.chunk(w, 1)
    names = ("o", "lse", "dq", "dk", "dv")
    for kind in CP_KINDS:
        sync(dev)
        reset_counts()
        out = ring.schedules_on_one_device(kind, q, k, v, w, causal=True,
                                           segment_ids=ids, do=do, dlse=dlse)
        sync(dev)
        counts = read_counts()
        err = {}
        for name, a in zip(names, out):
            r = refs[name]
            tol = (LSE_TOL, LSE_TOL) if name == "lse" else kernel_tol(dtype, r)
            err[name] = check_close(f"phase 10 {kind} ({tag}) {name} vs one "
                                    "call", a, r, *tol)
        kr = dict(launches=counts, max_abs_err_vs_single=err)
        if on_card:
            want = CP_LAUNCHES[kind]
            got = [counts[c] for c in ("flash_fwd", "flash_fwd_tc",
                                       "flash_bwd", "flash_bwd_tc")]
            if got != [want] * 4:
                fail(f"phase 10 {kind} ({tag}): flash launches (fwd, fwd on "
                     f"the tensor cores, bwd, bwd on the tensor cores) {got},"
                     f" want {want} each")
            o_r, lse_r = out[0].chunk(w, 2), out[1].chunk(w, 2)
            dk, dv = (torch.zeros(k.shape, device=dev) for _ in range(2))
            kw = dict(causal=True, kv_ids=ids)

            def fwd(r):
                return ring.rank_forward(kind, qs[r], k, v, r, w,
                                         q_ids=q_ids[r], **kw)

            def bwd(r):
                return ring.rank_backward(kind, qs[r], k, v, o_r[r], lse_r[r],
                                          dos[r], dlses[r], dk, dv, r, w,
                                          q_ids=q_ids[r], **kw)

            kr["fwd_rank_ms"] = [timer(lambda r=r: fwd(r), reps=10)
                                 for r in range(w)]
            kr["bwd_rank_ms"] = [timer(lambda r=r: bwd(r), reps=10)
                                 for r in range(w)]
            kr["max_abs_err"] = {}
            atol = {n: kernel_tol(dtype, r)[1] for n, r in refs.items()}
            patch_f, patch_b = _checked_schedules(kr["max_abs_err"],
                                                  f"{kind} ({tag})", atol)
            with patch_f, patch_b:
                ring.schedules_on_one_device(kind, q, k, v, w, causal=True,
                                             segment_ids=ids, do=do, dlse=dlse)
            patch_f, patch_b = _plain_schedules()
            with patch_f, patch_b:
                kr["plain_fwd_ms"] = sum(timer(lambda r=r: fwd(r), reps=3,
                                               warmup=1) for r in range(w))
                kr["plain_bwd_ms"] = sum(timer(lambda r=r: bwd(r), reps=3,
                                               warmup=1) for r in range(w))
            kr["fwd_ms"], kr["bwd_ms"] = sum(kr["fwd_rank_ms"]), \
                sum(kr["bwd_rank_ms"])
            log(f"[cp] {kind} ({tag}, {w} ranks on one card): max |schedule -"
                f" one call| " + " ".join(f"{n} {e:.2e}" for n, e in err.items())
                + f"; {want} fwd + {want} bwd partials on the tensor cores "
                f"(checked); per-rank schedule ms fwd "
                + " ".join(f"{t:.4f}" for t in kr["fwd_rank_ms"])
                + f" (sum {kr['fwd_ms']:.4f}, one call "
                f"{rec['single_fwd_ms']:.4f}, plain {kr['plain_fwd_ms']:.4f},"
                f" bound {bounds['fwd'][0]:.4f}) bwd "
                + " ".join(f"{t:.4f}" for t in kr["bwd_rank_ms"])
                + f" (sum {kr['bwd_ms']:.4f}, one call "
                f"{rec['single_bwd_ms']:.4f}, plain {kr['plain_bwd_ms']:.4f},"
                f" bound {bounds['bwd'][0]:.4f})")
        else:
            log(f"[cp] {kind} ({tag}): max |schedule - one call| "
                + " ".join(f"{n} {e:.2e}" for n, e in err.items()))
        rec[kind] = kr
    return rec


def phase_cp(dev, shape, dtype, on_card):
    gen = torch.Generator().manual_seed(SEED + 10)
    return {("segments" if seg else "causal"):
            cp_case(gen, dev, shape, dtype, seg, on_card)
            for seg in (False, True)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm().clamp(
        min=1e-30))


def phase_parallel_steps(cfg, tc, dev, on_card):
    """One NCCL rank (gloo only in the CPU rehearsal): ``make_mesh``, the
    sharded step with ZeRO-1 and the pipelined step (S = 1, one
    microbatch) against ``models/train.py``'s step from the same parameters
    and batches: two micro-steps (grad_accum 2: gradients after the first,
    the update after the second). Gates: loss and every gradient within
    STEP_TOL relative; phase 5's launch counts per micro-step."""
    backend = "nccl" if on_card else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh()
        params = init_params(cfg, seed=SEED + 5, device=dev)
        batches = list(ttrain.synthetic_batches(tc, cfg.vocab_size, 2,
                                                device=dev))
        seeds = [ttrain.step_seed(tc, i) for i in range(2)]
        ref = copy.deepcopy(params)
        ref_opt = ttrain.make_optimizer(ref, tc)
        local, sopt, _ = make_sharded_train_state(mesh, params, tc, zero1=True)
        sstep = make_sharded_train_step(mesh, cfg)
        stage, popt, _ = make_pipelined_train_state(mesh, params, tc)
        pstep = make_pipelined_train_step(mesh, cfg, n_micro=1)
        del params
        runs = {
            "train_step": (ref, lambda i: ttrain.train_step(
                ref, ref_opt, batches[i], seeds[i], cfg)),
            "sharded_zero1": (local, lambda i: sstep(local, sopt, batches[i],
                                                     seeds[i])),
            "pipelined": (stage, lambda i: pstep(stage, popt, batches[i],
                                                 seeds[i])),
        }
        got = {}
        for name, (p, run) in runs.items():
            sync(dev)
            reset_counts()
            loss = float(run(0))
            sync(dev)
            counts = read_counts()
            grads = {n: t.grad.detach().clone() for n, t in p.named_parameters()}
            loss2 = float(run(1))
            got[name] = dict(loss=loss, loss2=loss2, counts=counts, grads=grads,
                             after={n: t.detach().clone()
                                    for n, t in p.named_parameters()})
        want = got.pop("train_step")
        rec = dict(backend=backend, loss=want["loss"], loss2=want["loss2"])
        per = (2 if cfg.remat else 1) * cfg.n_layers
        for name, g in got.items():
            loss_rel = abs(g["loss"] - want["loss"]) / abs(want["loss"])
            grad_rel = max(_rel(g["grads"][n], want["grads"][n])
                           for n in want["grads"])
            param_rel = max(_rel(g["after"][n], want["after"][n])
                            for n in want["after"])
            rec[name] = dict(loss=g["loss"], loss_rel=loss_rel,
                             grad_max_rel_l2=grad_rel, loss2=g["loss2"],
                             params_after_max_rel_l2=param_rel,
                             launches=g["counts"])
            log(f"[parallel] {name} on one {backend} rank vs train_step: loss "
                f"{g['loss']:.6f} vs {want['loss']:.6f} (rel {loss_rel:.2e}), "
                f"worst gradient rel L2 {grad_rel:.2e}, after the update: "
                f"loss {g['loss2']:.6f} vs {want['loss2']:.6f}, worst "
                f"parameter rel L2 {param_rel:.2e} (tol {STEP_TOL:g}); "
                f"launches {g['counts']['flash_fwd']} fwd "
                f"{g['counts']['flash_bwd']} bwd")
            if loss_rel > STEP_TOL or grad_rel > STEP_TOL:
                fail(f"phase 10 {name}: loss rel {loss_rel:.2e}, worst "
                     f"gradient rel L2 {grad_rel:.2e}, over {STEP_TOL:g}")
            if on_card:
                c = g["counts"]
                have = (c["flash_fwd"], c["flash_fwd_tc"], c["flash_bwd"],
                        c["flash_bwd_tc"])
                if have != (per, per, cfg.n_layers, cfg.n_layers):
                    fail(f"phase 10 {name}: flash launches {have} in a "
                         f"micro-step, want ({per}, {per}, {cfg.n_layers}, "
                         f"{cfg.n_layers}) as phase 5")
        return rec
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Phase 11: the MoE model
# ---------------------------------------------------------------------------


def _record_routes():
    """(patch, calls): while the patch is on, every ``moe.route`` call
    appends its expert indices (BG, G, k) to ``calls``."""
    calls = []
    orig = moe.route

    def route(*args, **kwargs):
        out = orig(*args, **kwargs)
        calls.append(out[4].detach().cpu())
        return out

    return mock.patch.object(moe, "route", route), calls


def phase_moe_vs_cpu(cfg, dev, n=512):
    """One MoE training loss and its gradients (B=1, dropout 0, capacity
    routing) on the card with fp32 compute against the CPU in fp32: loss
    and gradients within 1e-3 and the same experts for every token of every
    layer (gated); the bf16 card's distance and its tokens routed to another
    expert set (reported)."""
    cfg = dataclasses.replace(cfg, dropout_rate=0.0)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    ref = init_params(cfg32, seed=SEED + 7, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(SEED + 7).integers(
        0, cfg.vocab_size, size=(1, n + 1)))
    out = {}
    for tag, c, device in (("cpu_fp32", cfg32, "cpu"), ("card_fp32", cfg32, dev),
                           ("card_bf16", cfg, dev)):
        params = copy.deepcopy(ref).to(device)
        patch, calls = _record_routes()
        with patch:
            loss = ttrain.loss_fn(params, {"tokens": toks.to(device)}, c, None)
            loss.backward()
        out[tag] = (loss.item(), {k: p.grad.float().cpu()
                                  for k, p in params.named_parameters()},
                    calls[:cfg.n_layers])  # the forward's; then the recompute
        del params
    lr, gr, er = out["cpu_fp32"]
    rec = dict(loss_cpu=lr, tol=MOE_TOL)
    for tag in ("card_fp32", "card_bf16"):
        lc, gc, ec = out[tag]
        sets = [(torch.sort(a, -1).values != torch.sort(b, -1).values).any(-1)
                for a, b in zip(ec, er)]
        moved = [int(x.sum()) for x in sets]
        num = sum(float((gc[k] - gr[k]).square().sum()) for k in gr)
        den = sum(float(gr[k].square().sum()) for k in gr)
        rel = (num / den) ** 0.5
        rec[tag] = dict(loss=lc, loss_abs_err=abs(lc - lr), grad_rel_l2=rel,
                        tokens_other_experts=moved,
                        first_choice_differs=sum(int((a[..., 0] != b[..., 0])
                                                     .sum())
                                                 for a, b in zip(ec, er)))
        log(f"[moe_vs_cpu] {tag}: loss {lc:.6f} vs cpu fp32 {lr:.6f} (|diff| "
            f"{abs(lc - lr):.3e}), gradient relative L2 {rel:.3e}; tokens with"
            f" another expert set, per layer: {moved} of {n}")
        if tag == "card_fp32":
            if not np.isfinite(lc) or abs(lc - lr) > MOE_TOL * (1 + abs(lr)):
                fail(f"MoE loss on the card (fp32) differs by {abs(lc - lr):.3e}")
            if not rel <= MOE_TOL:
                fail(f"MoE gradient relative L2 {rel:.3e} over {MOE_TOL:g}")
            if any(moved) or rec[tag]["first_choice_differs"]:
                fail(f"MoE experts differ between the card (fp32) and the "
                     f"CPU: {moved} tokens per layer")
    return rec


# ---------------------------------------------------------------------------
# Phase 12: tokenizer and data, compat, training on packed documents, the
# bench harness and profiling
# ---------------------------------------------------------------------------

REPO_DIR = Path(__file__).resolve().parent
BPE_VOCAB = 512
COMPAT_TOL = 1e-4  # fp32 rung: card vs CPU, relative to the largest logit
ROOFLINE_MAX = 1.05


def phase_text(vocab, seq_len):
    """A BPE learned from the repository's ``*.md`` text; the native
    engine's ids against the Python loop's on the whole text; each file one
    document, packed into rows of seq_len + 1."""
    docs = [p.read_text(encoding="utf-8") for p in sorted(REPO_DIR.glob("*.md"))]
    text = "".join(docs)
    t0 = time.perf_counter()
    tok = BPETokenizer.train(text, vocab)
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ids = tok.encode(text)
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = tok.encode_plain(text)
    plain_s = time.perf_counter() - t0
    if not np.array_equal(ids, plain):
        fail("the BPE engine's ids differ from the Python merge loop's")
    if tok.decode(ids) != text:
        fail("the BPE round trip changed the text")
    tokens, seg = tdata.pack_documents([tok.encode(d) for d in docs], seq_len)
    rec = dict(files=len(docs), text_bytes=len(text.encode("utf-8")),
               vocab=tok.vocab_size, tokens=len(ids), train_s=train_s,
               encode_s=encode_s, encode_plain_s=plain_s,
               rows=tokens.shape[0], row_len=tokens.shape[1],
               padded_share=float((seg < 0).float().mean()))
    log(f"[text] BPE vocab {tok.vocab_size} learned from {len(docs)} *.md "
        f"files ({rec['text_bytes']} bytes) in {train_s:.2f} s; {len(ids)} "
        f"tokens, engine {encode_s:.3f} s = Python loop {plain_s:.3f} s "
        f"(ids equal); packed into {rec['rows']} rows of {rec['row_len']} "
        f"({100 * rec['padded_share']:.2f}% padding)")
    return tokens, seg, rec


def phase_compat(tokens, dev, on_card, size, heads, rows=8, timer=None):
    """A seeded reference-layout checkpoint (fused QKV, biases, spare
    projections) converted and evaluated on ``rows`` packed rows in fp32:
    logits and loss against the same calls on the CPU, exact flash launch
    counts, the forward's time, and one profiled forward."""
    from flashattention_tpu_torch.utils import profiling

    sd = reference_state_dict(**size, fused=True, bias=True, spare=True,
                              seed=SEED)
    ids, tgt = tokens[:rows, :-1], tokens[:rows, 1:]
    out = {}
    for tag, d in (("card", dev), ("cpu", "cpu")):
        params = compat.convert_reference_state_dict(sd, heads, device=d)
        with torch.no_grad():
            reset_counts()
            logits = compat.apply_reference_transformer(params, ids)
            sync(d)
            counts = read_counts()
            loss = float(compat.reference_lm_loss(params, ids, tgt))
        out[tag] = (params, logits.cpu(), loss, counts)
    params, logits, loss, counts = out["card"]
    _, ref, ref_loss, _ = out["cpu"]
    if not (torch.isfinite(logits).all() and np.isfinite(loss)):
        fail("compat logits or loss are not finite")
    if logits.shape != (rows, ids.shape[1], size["vocab"]):
        fail(f"compat logits of shape {tuple(logits.shape)}")
    scale = float(ref.abs().max())
    err = float((logits - ref).abs().max())
    loss_err = abs(loss - ref_loss)
    rec = dict(heads=heads, **size, rows=rows, loss=loss, perplexity=math.exp(loss),
               loss_cpu=ref_loss, logits_max_abs_err=err, logits_scale=scale,
               loss_abs_err=loss_err, tol=COMPAT_TOL, launches=counts)
    log(f"[compat] reference checkpoint ({size['n_layers']} layers, d_model "
        f"{size['d_model']}, {heads} heads, vocab {size['vocab']}, fp32) on "
        f"{rows} packed rows: loss {loss:.6f}, perplexity "
        f"{rec['perplexity']:.2f}; card vs CPU logits max |diff| {err:.3e} "
        f"of max |logit| {scale:.3f}, loss |diff| {loss_err:.3e} (tol "
        f"{COMPAT_TOL:g} relative)")
    if err > COMPAT_TOL * scale or loss_err > COMPAT_TOL * abs(ref_loss):
        fail(f"compat on the card differs from the CPU: logits {err:.3e}, "
             f"loss {loss_err:.3e}")
    want = 2 * size["n_layers"]
    if on_card:
        others = {k: v for k, v in counts.items() if v and k != "flash_fwd"}
        if counts["flash_fwd"] != want or others:
            fail(f"compat forward launched {counts}; want {want} flash_fwd on "
                 "the FMA route and nothing else")
        log(f"[compat] {want} flash_fwd launches a forward, all on the FMA "
            "route (checked)")
        fwd = lambda: compat.apply_reference_transformer(params, ids)
        with torch.no_grad():
            # from an idle card, host issue included: the forward issues
            # more work than the timer's stream hold covers
            rec["forward_ms"] = timer.wall(fwd, reps=10, warmup=2)
            with profiling.trace(OUT_DIR / "traces") as prof:
                fwd()
        kernels = device_kernels(prof)
        flash = {k: v / 1e3 for k, v in kernels.items()
                 if "flash_fwd_kernel" in k}
        rec["profile"] = dict(trace=str(prof.trace_path.relative_to(REPO_DIR)),
                              kernel_ms=sum(kernels.values()) / 1e3,
                              flash_fwd_ms=flash)
        if not flash:
            fail("the compat forward's trace holds no flash_fwd kernel")
        log(f"[compat] forward {rec['forward_ms']:.3f} ms (median of 10); "
            f"traced: {rec['profile']['kernel_ms']:.3f} ms of kernels, "
            f"flash_fwd {sum(flash.values()):.3f} ms, trace "
            f"{rec['profile']['trace']}")
    return rec


def packed_batches(tokens, seg, batch_size):
    """Batches of packed rows, built on a host thread (``data.prefetch``)."""
    rows = tokens.shape[0] - tokens.shape[0] % batch_size
    return tdata.prefetch(
        {"tokens": tokens[i:i + batch_size],
         "segment_ids": seg[i:i + batch_size]}
        for i in range(0, rows, batch_size))


def phase_packed_train(cfg, tc, tokens, seg, dev, on_card, n_warm=2,
                       n_timed=4):
    """Phase 5's training on packed documents; the loss (no dropout) of the
    last full batch of rows, which the micro-steps never train on, must
    fall over them (two updates at a nonzero learning rate)."""
    bs = tc.batch_size
    last = tokens.shape[0] - tokens.shape[0] % bs - bs
    if last < (n_warm + n_timed + 1) * bs:  # + phase_train's profiled step
        fail(f"{tokens.shape[0]} packed rows leave no batch unseen by the "
             "micro-steps")
    held_out = {"tokens": tokens[last:last + bs],
                "segment_ids": seg[last:last + bs]}
    rec = phase_train(cfg, tc, dev, on_card, n_warm=n_warm, n_timed=n_timed,
                      tag="packed_train", check_batch=held_out,
                      batches=packed_batches(tokens, seg, bs))
    before, after = rec["check_loss_before"], rec["check_loss_after"]
    log(f"[packed_train] loss of rows {last}-{last + bs - 1} (never trained "
        f"on), no dropout: {before:.6f} before, {after:.6f} after the "
        "micro-steps")
    if not after < before:
        fail(f"the loss on packed documents did not fall: {before} -> {after}")
    return rec


# The sweep cells run at phase-2 case (b)'s shape, where flash case (b) and
# fp8 case (b) hold B1-B3 and B4 against their plain versions.
BENCH_SHAPE = (1, 8, 8192, 128)  # (B, H, N, D), causal
BENCH_CELLS = {
    # name: sweep cell (bench.sweep.cell arguments), counter that must move
    "fa2_fwd": (("fa2", "forward"), {}, "flash_fwd_tc"),
    "fa2_bwd": (("fa2", "backward"), {}, "flash_bwd_tc"),
    "fa3_int8_fwd": (("fa3", "forward"), dict(fp8=True, fp8_fmt="int8"),
                     "flash_fwd_fp8_tc"),
}
# a cell's events may exceed its traced kernel time by the gaps between
# its kernels and the cold L2; a host wait inside them would add far more
DEVICE_TIME_SLACK = 1.25


def traced_kernel_ms(fn, tries=3) -> float | None:
    """Summed device ms of the kernels ``fn()`` runs, from torch.profiler,
    between two one-element marker fills; None where no try recorded the
    whole window. CUPTI now and then misses the first milliseconds of a
    profile, so a ~5 ms sleep kernel opens it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    marker = torch.empty(1, device="cuda")
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(5 * harness.HOLD_CYCLES)
            marker.fill_(1.0)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            marker.fill_(2.0)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        fills = [i for i, e in enumerate(events) if "FillFunctor" in e.name]
        # the markers: the first fill after the sleep and the last event
        # (fn may run fills of its own in between)
        if fills and fills[0] > 0 and "spin" in events[fills[0] - 1].name \
                and fills[-1] == len(events) - 1 > fills[0] + 1:
            return sum(e.time_range.elapsed_us()
                       for e in events[fills[0] + 1:-1]) / 1e3
    return None


def phase_bench(dev, on_card, scaling_kw):
    """Sweep cells in-process (records with status "ok" and a roofline share
    in (0, 1.05] of the card's peak; each cell's time against the kernel
    time of one traced call of the same function), ``profiling.timed`` on
    one flash call, and ``bench.scaling`` at size 1 on one rank."""
    from flashattention_tpu_torch.ops.api import flash_attention
    from flashattention_tpu_torch.utils import profiling

    rec = {}
    if on_card:
        b, h, n, d = BENCH_SHAPE
        launches = collections.Counter()
        for name, (args, kw, counter) in BENCH_CELLS.items():
            ns = sweep.cell(*args, n, d, batch=b, heads=h, causal=True, **kw)
            reset_counts()
            r = sweep.run_config(ns)
            counts = read_counts()
            launches.update(counts)
            fn, fn_args, _ = sweep.cell_call(ns)
            fn(*fn_args)
            traced = traced_kernel_ms(lambda: fn(*fn_args))
            rec[name] = dict(record=r.row(), launches=counts,
                             traced_kernel_ms=traced)
            log(f"[bench] {name} {BENCH_SHAPE} causal: {r.status} "
                f"{r.mean_ms:.4f} ms (pstdev {r.pstdev_ms:.4f}; one traced "
                f"call's kernels "
                + ("not measured" if traced is None else f"{traced:.4f} ms")
                + f"), {r.tflops:.1f} TFLOP/s = "
                f"{100 * r.roofline_frac:.2f}% of the card's {r.dtype} peak, "
                f"peak memory {r.peak_mem_mb:.1f} MB; {counter} "
                f"{counts[counter]}")
            if r.status != "ok" or not 0 < r.roofline_frac <= ROOFLINE_MAX:
                fail(f"bench cell {name}: {r.status} {r.error} roofline "
                     f"{r.roofline_frac}")
            if counts[counter] <= 0:
                fail(f"bench cell {name} launched no {counter}")
            if traced is not None and r.mean_ms > DEVICE_TIME_SLACK * traced:
                fail(f"bench cell {name}: {r.mean_ms} ms against {traced} ms "
                     "of kernels: the events held more than device work")
        rec["launches"] = dict(launches)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        q, k, v = (torch.randn((b, h, n, d), generator=gen, device=dev,
                               dtype=BF16) for _ in range(3))
        rec["timed_fwd_ms"] = 1e3 * profiling.timed(
            lambda q_, k_, v_: flash_attention(q_, k_, v_, causal=True),
            q, k, v)
        log(f"[bench] profiling.timed flash forward {BENCH_SHAPE} bf16 "
            f"causal, 20 chained calls: {rec['timed_fwd_ms']:.4f} ms a call")
    backend = "nccl" if on_card else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        tps = scaling.measure_train_tokens_per_s(make_mesh(), device=dev,
                                                 **scaling_kw)
    finally:
        dist.destroy_process_group()
    rec["scaling_size1_tokens_per_s"] = tps
    log(f"[bench] bench.scaling at size 1 on one {backend} rank: {tps:.1f} "
        "tokens/s")
    return rec


# ---------------------------------------------------------------------------


def ptxas_entries(text):
    """{mangled kernel: (registers, spill bytes)} from a ptxas -v report."""
    out, name = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "spill stores" in line:
            words = line.replace(",", "").split()
            spill = (int(words[words.index("spill") - 2])
                     + int(words[words.index("spill", words.index("spill") + 1)
                                 - 2]))
            out[name] = [None, spill]
        elif name and "Used" in line and "registers" in line:
            words = line.replace(",", "").split()
            out.setdefault(name, [None, None])[0] = int(
                words[words.index("registers") - 1])
    return out


# Tensor-core kernels per library: forward at D 64 and 128; dK/dV and dQ at
# D 64 and 128; the sparse ones each with one and two consumer warpgroups;
# the 8-bit forward at D 64 and 128 for e4m3, e5m2 and int8.
SM90_KERNELS = {"flash_fwd": 2, "flash_bwd": 4, "sparse_fwd": 4,
                "sparse_bwd": 8, "flash_fwd_fp8": 6}
# The paged split kernels: bf16, int8 (convert and "qk"), e4m3 and e5m2
# pages, each at 1, 2 and 4 rows a row set.
SPLIT_KERNELS = 15


def split_report():
    """Phase 1's report of the paged split route: per split kernel its
    registers and spill bytes (this build's ptxas report) and the 1-D bulk
    copies (UBLKCP) in its SASS. Fails if one has no bulk copy, spills, or
    is missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass",
                           str(_build.kernel_path("paged_attention"))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    ptxas = ptxas_entries(_build.BUILD_LOG.get("paged_attention", ""))
    out = {}
    for part in sass.split("Function : ")[1:]:
        fn = part.split()[0]
        if "paged_split_kernel" not in fn:
            continue
        regs, spill = ptxas.get(fn, (None, None))
        out[fn] = dict(ublkcp=part.count("UBLKCP"), registers=regs,
                       spill_bytes=spill)
        log(f"[sass] paged_attention: {fn}: {out[fn]['ublkcp']} UBLKCP (1-D "
            f"bulk copies); ptxas: {regs} registers, {spill} spill bytes")
        if not out[fn]["ublkcp"]:
            fail(f"{fn}: the split kernel has no bulk copy")
        if spill is None:
            fail(f"{fn}: no ptxas report from this run's build")
        if spill:
            fail(f"{fn}: spills {spill} bytes")
    if len(out) != SPLIT_KERNELS:
        fail(f"paged_attention: expected {SPLIT_KERNELS} split kernels, "
             f"found {len(out)}")
    return out


# The append kernels: bf16 and fp32 tokens into five page formats, each
# with 8 elements a lane (16-byte accesses) and with one.
APPEND_KERNELS = 20


def append_report():
    """Phase 1's report of B7: per append kernel its registers and spill
    bytes (this build's ptxas report) and its 16-byte global loads
    (LDG.E.128) in the SASS. Fails if one spills or is missing, or if an
    instantiation of 8 elements a lane has no 16-byte load."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass",
                           str(_build.kernel_path("paged_append"))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    ptxas = ptxas_entries(_build.BUILD_LOG.get("paged_append", ""))
    out = {}
    for part in sass.split("Function : ")[1:]:
        fn = part.split()[0]
        if "paged_append_tokens_kernel" not in fn:
            continue
        regs, spill = ptxas.get(fn, (None, None))
        out[fn] = dict(ldg128=part.count("LDG.E.128"), registers=regs,
                       spill_bytes=spill)
        log(f"[sass] paged_append: {fn}: {out[fn]['ldg128']} LDG.E.128; "
            f"ptxas: {regs} registers, {spill} spill bytes")
        if spill is None:
            fail(f"{fn}: no ptxas report from this run's build")
        if spill:
            fail(f"{fn}: spills {spill} bytes")
        if fn.endswith("Li8EEEvNS_10AppendArgsE") and not out[fn]["ldg128"]:
            fail(f"{fn}: 8 elements a lane but no 16-byte load")
    if len(out) != APPEND_KERNELS:
        fail(f"paged_append: expected {APPEND_KERNELS} kernels, found "
             f"{len(out)}")
    return out


def sass_report():
    """Phase 1's check that the tensor-core routes are what they claim: per
    kernel of the flash and sparse libraries, the HGMMA (wgmma) and UTMALDG
    (TMA load) instructions in its SASS (cuobjdump) and, for the
    tensor-core kernels, registers and spill bytes from the build's ptxas
    report. Fails if a tensor-core kernel has no HGMMA or no UTMALDG, or
    spills, or one is missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for name, want in SM90_KERNELS.items():
        sass = subprocess.run([tool, "--dump-sass",
                               str(_build.kernel_path(name))],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        ptxas = ptxas_entries(_build.BUILD_LOG.get(name, ""))
        found = 0
        for part in sass.split("Function : ")[1:]:
            fn = part.split()[0]
            if "sm90" not in fn:
                continue
            found += 1
            regs, spill = ptxas.get(fn, (None, None))
            rec = dict(hgmma=part.count("HGMMA"), igmma=part.count("IGMMA"),
                       utmaldg=part.count("UTMALDG"), registers=regs,
                       spill_bytes=spill)
            out[fn] = rec
            log(f"[sass] {name}: {fn}: {rec['hgmma']} HGMMA, {rec['igmma']} "
                f"IGMMA, {rec['utmaldg']} UTMALDG; ptxas: {regs} registers at "
                f"entry, {spill} spill bytes")
            if not rec["hgmma"] or not rec["utmaldg"]:
                fail(f"{fn}: the tensor-core kernel has no HGMMA or no UTMALDG")
            if spill is None:
                fail(f"{fn}: no ptxas report from this run's build")
            if spill:
                fail(f"{fn}: spills {spill} bytes")
        if found != want:
            fail(f"{name}: expected {want} tensor-core kernels, found {found}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="skip phases 1-2; run the others tiny on the CPU")
    args = ap.parse_args()
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT_DIR.mkdir(exist_ok=True)
    report = {}

    if args.cpu_rehearsal:
        cfg = TransformerConfig(vocab_size=97, d_model=64, n_layers=2,
                                n_heads=4, d_ff=128, max_seq_len=128,
                                dropout_rate=0.0)
        params = init_params(cfg, seed=SEED, device="cpu")
        ecfg = EngineConfig(max_batch_size=4, page_size=16, num_pages=4 * 8 + 1,
                            max_seq_len=128, prefill_pad=16)
        report["engine"] = phase_engine(cfg, params, ecfg, "cpu", 8, (8, 60),
                                        8, on_card=False)
        report["profile"] = phase_profile(cfg, params, ecfg, "cpu", steps=4)
        report["vs_cpu"] = phase_vs_cpu(cfg, params, "cpu", 40, 8)
        for quant, n_req in (("fp8", 8), ("int8", 4)):
            report[f"engine_{quant}"] = phase_engine(
                cfg, params, dataclasses.replace(ecfg, quant=quant), "cpu",
                n_req, (8, 60), 8, on_card=False)
        report["vs_cpu_fp8"] = phase_vs_cpu(cfg, params, "cpu", 40, 8,
                                            quant="fp8")
        report["fa3_fp8"] = phase_fa3_fp8("cpu", (1, 2, 1024, 64),
                                          (1, 2, 640, 64), False)
        tcfg = dataclasses.replace(cfg, dropout_rate=0.1)
        tc = ttrain.TrainConfig(batch_size=2, seq_len=64, grad_accum=2,
                                warmup_steps=2)
        report["train"] = phase_train(tcfg, tc, "cpu", on_card=False)
        report["train_vs_cpu"] = phase_train_vs_cpu(tcfg, "cpu", n=64)
        report["sparse_model"] = phase_sparse_model(
            dataclasses.replace(cfg, block_size=16), "cpu", False, b=2, n=128,
            check_n=64)
        draft = dataclasses.replace(cfg, n_layers=1)
        report["spec"] = phase_spec(
            cfg, params, ecfg, "cpu", 8, (8, 60), 8,
            (init_params(draft, seed=SEED + 1, device="cpu"), draft), False)
        report["multihost"] = phase_multihost(
            cfg, dataclasses.replace(ecfg, max_batch_size=2,
                                     num_pages=2 * 8 + 1),
            "cpu", 4, (8, 40), 6, draft)
        report["cp"] = phase_cp("cpu", (1, 2, 256, 64), torch.float32, False)
        report["parallel_steps"] = phase_parallel_steps(cfg, tc, "cpu", False)
        mcfg = dataclasses.replace(cfg, moe_experts=4, moe_group_size=32)
        report["moe_train"] = phase_train(
            dataclasses.replace(mcfg, dropout_rate=0.1), tc, "cpu", False,
            n_timed=4, tag="moe_train")
        report["moe_vs_cpu"] = phase_moe_vs_cpu(mcfg, "cpu", n=64)
        mparams = init_params(mcfg, seed=SEED, device="cpu")
        report["moe_engine"] = phase_engine(mcfg, mparams, ecfg, "cpu", 8,
                                            (8, 60), 8, on_card=False)
        report["moe_vs_cpu_engine"] = phase_vs_cpu(mcfg, mparams, "cpu", 40, 8)
        tokens, seg, report["text"] = phase_text(300, tc.seq_len)
        report["compat"] = phase_compat(
            tokens, "cpu", False, dict(vocab=300, d_model=64, n_layers=2,
                                       max_len=tc.seq_len), 4)
        report["packed_train"] = phase_packed_train(
            dataclasses.replace(tcfg, vocab_size=300), tc, tokens, seg, "cpu",
            False)
        report["bench"] = phase_bench("cpu", False, dict(
            cfg=scaling.bench_config(seq_len=32, vocab_size=97, d_model=32,
                                     n_layers=2, n_heads=4, d_ff=64,
                                     dtype=torch.float32),
            batch_per_device=2, seq_len=32, steps=2))
        log("[rehearsal] control flow ran on the CPU; no device result")
        return 0

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was measured",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[card] {smi}")
    cfg, ecfg = serving_config()

    # Phase 1
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    # every kernel is built anew, so the ptxas report checked below is
    # this build's, also where an earlier run left its libraries
    for name in _build.KERNELS:
        _build.kernel_path(name).unlink(missing_ok=True)
    t0 = time.perf_counter()
    per = _build.build_all()
    log(f"[build] {len(per)} kernels in {time.perf_counter() - t0:.2f} s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in per.items())})")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas] {name}: {line.strip()}")
    report.update(card=smi, build_s=per, tensor_core_kernels=sass_report(),
                  paged_split_kernels=split_report(),
                  append_kernels=append_report())

    # Phase 2
    report["kernels"] = phase_kernels(dev)

    # Phase 3
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device="cpu")  # float32, host
    log(f"[engine] GPT-3 Small widths ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads, vocab {cfg.vocab_size}), "
        f"random weights seed {SEED} in {time.perf_counter() - t0:.1f} s")
    report["engine"] = phase_engine(cfg, params, ecfg, dev, 64, (32, 400), 64,
                                    on_card=True)

    report["profile"] = phase_profile(cfg, params, ecfg, dev)

    # Phase 4
    report["vs_cpu"] = phase_vs_cpu(cfg, params, dev, 100, 16)

    # Phase 3b: quantized pages, same config and traffic (int8: 16 requests)
    for quant, n_req in (("fp8", 64), ("int8", 16)):
        report[f"engine_{quant}"] = phase_engine(
            cfg, params, dataclasses.replace(ecfg, quant=quant), dev, n_req,
            (32, 400), 64, on_card=True)
    report["profile_fp8"] = phase_profile(
        cfg, params, dataclasses.replace(ecfg, quant="fp8"), dev)

    # Phase 4b
    report["vs_cpu_fp8"] = phase_vs_cpu(cfg, params, dev, 100, 16, quant="fp8")

    # Phase 5
    tcfg = TransformerConfig()  # GPT-3 Small, dropout 0.1, remat full, bf16
    tc = ttrain.TrainConfig(batch_size=8, seq_len=512, grad_accum=2,
                            warmup_steps=2)
    report["train"] = phase_train(tcfg, tc, dev, on_card=True)
    torch.cuda.empty_cache()

    # Phase 6
    report["train_vs_cpu"] = phase_train_vs_cpu(tcfg, dev)
    torch.cuda.empty_cache()

    # Phase 5b: the FA3 8-bit path at the BASELINE shape
    report["fa3_fp8"] = phase_fa3_fp8(dev, (1, 8, 8192, 128),
                                      (1, 8, 1024, 128), True)
    torch.cuda.empty_cache()

    # Phase 7: the block-sparse model at GPT-3 Small widths, N = 4096 (only
    # the position table grows)
    scfg = TransformerConfig(dropout_rate=0.0, max_seq_len=4096)
    report["sparse_model"] = phase_sparse_model(scfg, dev, True, b=2, n=4096,
                                                check_n=512)
    torch.cuda.empty_cache()

    # Phase 8: the speculative engine, phase 3's config with gamma 4; the
    # floor's draft is GPT-3 Small at 2 layers
    t0 = time.perf_counter()
    draft2 = dataclasses.replace(cfg, n_layers=2)
    report["spec"] = phase_spec(
        cfg, params, ecfg, dev, 32, (32, 400), 32,
        (init_params(draft2, seed=SEED + 1, device="cpu"), draft2), True)
    del params
    torch.cuda.empty_cache()
    report["spec"]["phase_s"] = time.perf_counter() - t0

    # Phase 9: two engine processes on the card under the scheduler
    t0 = time.perf_counter()
    report["multihost"] = phase_multihost(
        cfg, dataclasses.replace(ecfg, max_batch_size=8, num_pages=8 * 32 + 1),
        dev, 16, (32, 200), 16, draft2)
    report["multihost"]["phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # Phase 10: the context-parallel schedules of 4 ranks on the card at the
    # BASELINE shape; the sharded and pipelined steps on one NCCL rank at
    # phase 5's widths and batch, dropout 0
    t0 = time.perf_counter()
    report["cp"] = phase_cp(dev, (1, 8, 8192, 128), torch.bfloat16, True)
    torch.cuda.empty_cache()
    report["parallel_steps"] = phase_parallel_steps(
        dataclasses.replace(tcfg, dropout_rate=0.0), tc, dev, True)
    torch.cuda.empty_cache()
    report["cp"]["phase_s"] = time.perf_counter() - t0

    # Phase 11: GPT-3 Small with 8 experts, top 2 (JAX defaults otherwise)
    t0 = time.perf_counter()
    mcfg = TransformerConfig(moe_experts=8)
    report["moe_train"] = phase_train(mcfg, tc, dev, on_card=True, n_warm=2,
                                      n_timed=4, tag="moe_train")
    torch.cuda.empty_cache()
    report["moe_vs_cpu"] = phase_moe_vs_cpu(mcfg, dev)
    torch.cuda.empty_cache()
    mserve = dataclasses.replace(cfg, moe_experts=8)
    mparams = init_params(mserve, seed=SEED, device="cpu")
    report["moe_engine"] = phase_engine(mserve, mparams, ecfg, dev, 32,
                                        (32, 400), 32, on_card=True)
    report["moe_vs_cpu_engine"] = phase_vs_cpu(mserve, mparams, dev, 100, 16)
    del mparams
    torch.cuda.empty_cache()
    report["moe_train"]["phase_s"] = time.perf_counter() - t0

    # Phase 12: a BPE learned from the repository's text, packed documents,
    # a full-width reference checkpoint through compat (fp32), phase 5's
    # training on the packed rows, the bench harness and profiling
    t0 = time.perf_counter()
    tokens, seg, report["text"] = phase_text(BPE_VOCAB, tc.seq_len)
    report["compat"] = phase_compat(
        tokens, dev, True, dict(vocab=tcfg.vocab_size, d_model=tcfg.d_model,
                                n_layers=tcfg.n_layers,
                                max_len=tcfg.max_seq_len),
        tcfg.n_heads, timer=Timer(dev))
    torch.cuda.empty_cache()
    report["packed_train"] = phase_packed_train(tcfg, tc, tokens, seg, dev,
                                                True)
    log(f"[packed_train] median {report['packed_train']['median_step_ms']:.2f}"
        f" ms a micro-step on packed documents, phase 5's synthetic stream "
        f"{report['train']['median_step_ms']:.2f}")
    torch.cuda.empty_cache()
    report["bench"] = phase_bench(dev, True, {})
    torch.cuda.empty_cache()
    report["text"]["phase_s"] = time.perf_counter() - t0
    report["total_s"] = time.perf_counter() - t_start
    log(f"[card] phase 8 {report['spec']['phase_s']:.1f} s, phase 9 "
        f"{report['multihost']['phase_s']:.1f} s, phase 10 "
        f"{report['cp']['phase_s']:.1f} s, phase 11 "
        f"{report['moe_train']['phase_s']:.1f} s, phase 12 "
        f"{report['text']['phase_s']:.1f} s, whole run "
        f"{report['total_s']:.1f} s")

    counts = {**report["engine"]["launches"],
              **{k: report["train"]["launches"][k]
                 for k in ("flash_fwd", "flash_bwd", "flash_fwd_tc",
                           "flash_bwd_tc")}}
    kernels = []
    layers = cfg.n_layers

    def by_kind(run, name):  # counted launches of an engine run by kind
        c = report[run]["launches"]
        more = dict(launches_decode=c[name] - c[f"{name}_chunk"],
                    launches_chunk=c[f"{name}_chunk"])
        if name == "paged_attention":
            more["launches_split"] = c["paged_attention_split"]
        return c[name], c[f"{name}_chunk"], more

    # (kernel, name in the record, phase-2 case, launches of its main path,
    # more keys), every launch count as counted in phase 3/3b: the decode
    # rows carry the whole run's launches and their split by kind (T = 1,
    # T > 1), the chunk rows the run's T > 1 launches.
    rows = []
    for name, cases in (
        ("paged_attention", (("engine", "", "decode", "chunk"),
                             ("engine_int8", "int8", "decode_int8_qk", None),
                             ("engine_fp8", "fp8", "decode_fp8",
                              "chunk_fp8"))),
        ("paged_append", tuple((f"engine{q and '_' + q}", q,
                                f"append_{q or 'bf16'}_decode",
                                f"append_{q or 'bf16'}_chunk")
                               for q in ("", "int8", "fp8"))),
    ):
        for run, q, decode_case, chunk_case in cases:
            n, n_chunk, more = by_kind(run, name)
            rows.append((name, f"{name}[{q}]" if q else name, decode_case, n,
                         more))
            if chunk_case:
                rows.append((name, f"{name}[chunk{q and ',' + q}]",
                             chunk_case, n_chunk, {}))
    # the verify chunk (B = 32, T = 5): launches inside the verify passes of
    # phase 8's self arm, numbers of the phase-2 verify cases
    verify = report["spec"]["self"]["verify"]
    rows += [("paged_attention", "paged_attention[verify]", "verify",
              verify["verify_paged"], {}),
             ("paged_append", "paged_append[verify]", "append_bf16_verify",
              verify["verify_append"], {})]
    for name, tag, case, n, more in rows:
        r = report["kernels"][case]
        kernels.append(dict(
            name=tag, **KERNELS[name], launches=n, **more,
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], yardstick_ms=r.get("yardstick_ms"),
            case=r["case"], **{k: r[k] for k in (
                "wall_ms", "first_ms", "first_wall_ms", "floor_ms") if k in r},
            **({"path": r["route"]} if "route" in r else {}),
        ))
    # flash_fwd / flash_bwd: launches of the training phase (all on the
    # tensor-core route); numbers of case (a), the training call, whose
    # dropout no PyTorch call computes (its SDPA is a yardstick). The library
    # call is SDPA at (a0), the same shape without dropout, beside the
    # kernel's (a0) time; (b) is the 8K shape; fma_ms the first kernels.
    r, r0, rb = (report["kernels"][f"flash_{c}"] for c in ("a", "a0", "b"))
    for name, part, errs in (("flash_fwd", "fwd", ("o", "lse")),
                             ("flash_bwd", "bwd", ("dq", "dk", "dv"))):
        kernels.append(dict(
            name=name, **KERNELS[name], launches=counts[name],
            launches_tensor_core=counts[f"{name}_tc"],
            max_abs_err=max(r["max_abs_err"][e] for e in errs),
            ms=r[f"{part}_ms"], plain_ms=r[f"{part}_plain_ms"],
            bound_ms=r[f"{part}_bound_ms"], bound_by=r[f"{part}_bound_by"],
            library_ms=r0[f"library_{part}_ms"],
            yardstick_ms=r[f"yardstick_{part}_ms"], case=r["case"],
            fma_ms=r[f"{part}_fma_ms"], wall_ms=r[f"{part}_wall_ms"],
            ms_a0=r0[f"{part}_ms"], library_case=r0["case"],
            ms_b=rb[f"{part}_ms"], plain_ms_b=rb[f"{part}_plain_ms"],
            bound_ms_b=rb[f"{part}_bound_ms"],
            library_ms_b=rb[f"library_{part}_ms"],
            fma_ms_b=rb[f"{part}_fma_ms"], case_b=rb["case"],
        ))
    # flash_fwd_fp8: its main path is fa3_attention(fp8=True, int8) (phase
    # 5b); its numbers come from phase-2 case (b), that call's shape.
    r = report["kernels"]["fp8_b"]
    fa3_int8 = report["fa3_fp8"]["int8"]["launches"]
    kernels.append(dict(
        name="flash_fwd_fp8", **KERNELS["flash_fwd_fp8"],
        launches=fa3_int8["flash_fwd_fp8"],
        launches_tensor_core=fa3_int8["flash_fwd_fp8_tc"],
        max_abs_err=max(r["max_abs_err"].values()), ms=r["ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=None,
        yardstick_ms=r["yardstick_ms"], case=r["case"], path=r["route"],
        fma_ms=r["fma_ms"],
    ))
    # sparse_fwd / sparse_bwd: launches of phase 7's forward+backward
    # steps; numbers of phase-2 case (a), the model phase's call
    r = report["kernels"]["sparse_a"]
    sparse_counts = report["sparse_model"]["launches"]
    for name, part, errs in (("sparse_fwd", "fwd", ("o", "lse")),
                             ("sparse_bwd", "bwd", ("dq", "dk", "dv"))):
        kernels.append(dict(
            name=name, **KERNELS[name], launches=sparse_counts[name],
            launches_tensor_core=sparse_counts[f"{name}_tc"],
            max_abs_err=max(r["max_abs_err"][e] for e in errs),
            ms=r[f"{part}_ms"], plain_ms=r[f"{part}_plain_ms"],
            bound_ms=r[f"{part}_bound_ms"], bound_by=r[f"{part}_bound_by"],
            library_ms=r.get(f"library_{part}_ms"),
            yardstick_ms=r.get(f"yardstick_{part}_ms"), case=r["case"],
            kernel_ms=r[f"{part}_kernel_ms"], fma_ms=r[f"{part}_fma_ms"],
            wall_ms=r[f"{part}_wall_ms"],
        ))
    # Phase 10: the context-parallel schedules (causal, no segment ids):
    # launches of the 4 ranks' schedules, times summed over the ranks
    # (kernels and merge), held against the schedules on the plain versions;
    # the bound and SDPA are those of the whole causal attention, the same
    # function.
    cp = report["cp"]["causal"]
    for kind in CP_KINDS:
        kr = cp[kind]
        for name, part, errs in (("flash_fwd", "fwd", ("o", "lse")),
                                 ("flash_bwd", "bwd", ("dq", "dk", "dv"))):
            kernels.append(dict(
                name=f"{name}[{kind}]", **KERNELS[name],
                launches=kr["launches"][name],
                launches_tensor_core=kr["launches"][f"{name}_tc"],
                max_abs_err=max(kr["max_abs_err"][e] for e in errs),
                ms=kr[f"{part}_ms"], plain_ms=kr[f"plain_{part}_ms"],
                bound_ms=cp[f"{part}_bound_ms"],
                bound_by=cp[f"{part}_bound_by"],
                library_ms=rb[f"library_{part}_ms"],
                rank_ms=kr[f"{part}_rank_ms"],
                single_call_ms=cp[f"single_{part}_ms"],
                case=f"{CP_WORLD} ranks of {kind} on one card, "
                     f"{tuple(cp['shape'])} bf16 causal"))
    # Phase 10's steps on one NCCL rank and phase 11's MoE model: launches
    # of each path, numbers of the phase-2 cases their calls match (the
    # training call (a); the engine's decode and append cases)
    r = report["kernels"]["flash_a"]
    paths = [(f"[{n}]", report["parallel_steps"][n]["launches"])
             for n in ("sharded_zero1", "pipelined")]
    paths.append(("[moe]", report["moe_train"]["launches"]))
    for tag, c in paths:
        for name, part, errs in (("flash_fwd", "fwd", ("o", "lse")),
                                 ("flash_bwd", "bwd", ("dq", "dk", "dv"))):
            kernels.append(dict(
                name=name + tag, **KERNELS[name], launches=c[name],
                launches_tensor_core=c[f"{name}_tc"],
                max_abs_err=max(r["max_abs_err"][e] for e in errs),
                ms=r[f"{part}_ms"], plain_ms=r[f"{part}_plain_ms"],
                bound_ms=r[f"{part}_bound_ms"], bound_by=r[f"{part}_bound_by"],
                library_ms=r0[f"library_{part}_ms"], case=r["case"]))
    for name, case in (("paged_attention", "decode"),
                       ("paged_append", "append_bf16_decode")):
        r = report["kernels"][case]
        n, n_chunk, more = by_kind("moe_engine", name)
        kernels.append(dict(
            name=f"{name}[moe]", **KERNELS[name], launches=n, **more,
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], case=r["case"]))
    # Phase 12: compat's forward (fp32, every launch on the FMA route),
    # numbers of case (e), its causal attention call, with case (i), the
    # "ffn" block's non-causal call, beside them; training on packed
    # documents, numbers of case (j), the same call (no PyTorch call
    # computes its dropout: SDPA is a yardstick)
    r, ri = report["kernels"]["flash_e"], report["kernels"]["flash_i"]
    c = report["compat"]["launches"]
    kernels.append(dict(
        name="flash_fwd[compat]", **KERNELS["flash_fwd"],
        launches=c["flash_fwd"], launches_tensor_core=c["flash_fwd_tc"],
        max_abs_err=max(r["max_abs_err"][e] for e in ("o", "lse")),
        ms=r["fwd_ms"], plain_ms=r["fwd_plain_ms"], bound_ms=r["fwd_bound_ms"],
        bound_by=r["fwd_bound_by"], library_ms=r["library_fwd_ms"],
        case=r["case"], ms_noncausal=ri["fwd_ms"],
        plain_ms_noncausal=ri["fwd_plain_ms"],
        bound_ms_noncausal=ri["fwd_bound_ms"],
        library_ms_noncausal=ri["library_fwd_ms"], case_noncausal=ri["case"],
        compat_logits_max_abs_err=report["compat"]["logits_max_abs_err"]))
    r, c = report["kernels"]["flash_j"], report["packed_train"]["launches"]
    for name, part, errs in (("flash_fwd", "fwd", ("o", "lse")),
                             ("flash_bwd", "bwd", ("dq", "dk", "dv"))):
        kernels.append(dict(
            name=f"{name}[packed]", **KERNELS[name], launches=c[name],
            launches_tensor_core=c[f"{name}_tc"],
            max_abs_err=max(r["max_abs_err"][e] for e in errs),
            ms=r[f"{part}_ms"], plain_ms=r[f"{part}_plain_ms"],
            bound_ms=r[f"{part}_bound_ms"], bound_by=r[f"{part}_bound_by"],
            library_ms=None, yardstick_ms=r[f"yardstick_{part}_ms"],
            case=r["case"]))
    # the sweep cells: launches of the three cells, numbers of flash case
    # (b) and fp8 case (b), the cells' shape and calls
    bench = report["bench"]
    rb, c = report["kernels"]["flash_b"], bench["launches"]
    for name, part, errs, cell in (
            ("flash_fwd", "fwd", ("o", "lse"), "fa2_fwd"),
            ("flash_bwd", "bwd", ("dq", "dk", "dv"), "fa2_bwd")):
        kernels.append(dict(
            name=f"{name}[sweep]", **KERNELS[name], launches=c[name],
            launches_tensor_core=c[f"{name}_tc"],
            max_abs_err=max(rb["max_abs_err"][e] for e in errs),
            ms=rb[f"{part}_ms"], plain_ms=rb[f"{part}_plain_ms"],
            bound_ms=rb[f"{part}_bound_ms"], bound_by=rb[f"{part}_bound_by"],
            library_ms=rb[f"library_{part}_ms"], case=rb["case"],
            sweep_cell=cell, sweep_ms=bench[cell]["record"]["mean_ms"]))
    r = report["kernels"]["fp8_b"]
    kernels.append(dict(
        name="flash_fwd_fp8[sweep]", **KERNELS["flash_fwd_fp8"],
        launches=c["flash_fwd_fp8"],
        launches_tensor_core=c["flash_fwd_fp8_tc"],
        max_abs_err=max(r["max_abs_err"].values()), ms=r["ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=None,
        yardstick_ms=r["yardstick_ms"], case=r["case"],
        sweep_cell="fa3_int8_fwd",
        sweep_ms=bench["fa3_int8_fwd"]["record"]["mean_ms"]))
    for k in kernels:
        if k["launches"] <= 0:
            fail(f"{k['name']} was launched no time on its main path")
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
