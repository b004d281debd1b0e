"""Smoke run of the PyTorch port (flashattention_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                  # on a machine with an H100
    python3 chip_smoke.py --cpu-rehearsal  # control flow only, tiny, on CPU

``scripts/profile_serving.py`` runs phase 3's and 3b's serving profile
alone, also against the package of another checkout (an A/B on one card).

Phases, in order; any failure exits nonzero:

1. Identify the card (nvidia-smi name and power limit) and build every CUDA
   kernel from ``flashattention_tpu_torch/csrc`` anew (one nvcc per source,
   all at once). The tensor-core kernels (flash: forward, dK/dV, dQ at D
   64, 128 and 256, each in bf16 and in fp32 on 3xTF32, the bf16 dK/dV one
   at 256 split over the head dim, the fp32 three at 256 the wide kernels
   that split operands in registers; sparse: the same three at D 64 and
   128, each with one and two consumer warpgroups, and at D 256 the
   forward and dQ with one and two and the dK/dV one split over the head
   dim, and the same three in fp32 on 3xTF32 at D 64 with one and two, at
   D 128 with one and at D 256 the wide kernels; the 8-bit forward at D 64,
   128 and 256 in e4m3, e5m2 and int8, whose int8 kernels must also show
   IGMMA; 56 in all) must show
   HGMMA (wgmma) and UTMALDG (TMA) in their
   SASS (cuobjdump) and spill nothing (ptxas report of this build); the 6
   chunked flash kernels above D = 256 (flash_wide: forward, dK/dV and dQ
   in bf16 and in fp32 on 3xTF32) must show HMMA (mma.sync) and spill
   nothing, as must the 12 sparse kernels above D = 256 (sparse_wide: the
   forward and dQ in bf16 and fp32 with 16- and 32-key sub-tiles, dK/dV in
   each dtype, and the sum of the dK/dV chunks in each dtype, which has no
   product) and the 7 8-bit forward kernels above D = 256 (fp8_wide: e4m3,
   e5m2, int8 and int8 "s8", and the first three again for key blocks off
   the 32-key tile, whose int8 ones must also show IMMA); the 40
   paged split kernels (10 on the lane-group walk, D <= 128 at 1 or 2 rows
   a KV head; 30 on the tensor-core walk, 12 of them above D = 256, which
   must also show HMMA, mma.sync) must show
   UBLKCP (1-D bulk copies) and spill nothing, as must the first paged
   kernel's 36 D = 256 and 36 chunked (D <= 1024) instantiations and the 4
   merge kernels; the 29
   sparse mma kernels (bf16: forward and dQ at D 64, 128 and 256 with 16-
   and 32-key sub-tiles, dK/dV at D 64, 128 and 256; fp32 on 3xTF32: the
   forward likewise, dQ at D 64 and 128 with 16- and 32-key sub-tiles and
   at 256 with 16, dK/dV at D 64, 128 and 256) must show HMMA and spill
   nothing, as must the sum of the dK/dV chunks in bf16 and fp32 (no
   HMMA); the 20 append
   kernels (any D) must
   spill nothing, and those of 8 elements a lane show 16-byte loads
   (LDG.E.128).
2. Each kernel against its plain PyTorch version on the card: the paged
   kernels at the serving engine's shapes, each case on the route the
   wrapper picks (the split walk for bf16 q over bf16 and 1-byte pages,
   convert and "qk"; two calls bit-equal) and, beside it, the first kernel
   on the same inputs (time and "issued from the host" time both); the flash forward and backward
   at the training shape with dropout (a) and without (a0) and more cases
   (the JAX headline's shape, GQA with window, sinks and soft-cap,
   segment ids with ALiBi, fp32, a nonzero LSE cotangent, rows with no
   visible key, fp32 with dropout, fp32 non-causal, segment ids with
   dropout, the sweep's d = 256 cell at 8K (k), GQA with window, sinks,
   soft-cap and dropout at D = 256 (l), both in fp32 (m), (n), and phase
   7c's MQA call (o)), each launched once each way (bf16 on bf16 wgmma,
   fp32 on 3xTF32 wgmma, both up to D = 256); cases (k), (m) and (o) also
   time the backward's kernels apart (torch.profiler), whose names must be
   those of the case's route. Max error against the stated tolerance
   (fp32 1e-4; bf16 flash two ulps, 1.6e-2 relative, plus 1e-3 of the
   largest value; bf16 paged 2e-2), then the kernel's, the plain version's
   and one library call's time (CUDA events, median over launches, L2
   flushed before each; SDPA is the library call where it computes the
   case's function, else a yardstick), beside the least time the card could
   take (bytes over 3.35 TB/s or operations over 989 TFLOP/s bf16, 165
   TFLOP/s fp32 on the tensor cores (3xTF32: three TF32 products at 495),
   67 on the FMA route); the flash cases also time the call as issued from
   the host, and (a), (a0), (b), (e), (h), (i), (k), (l), (m)-(o) the FMA
   kernels on the same inputs, held against the plain version at the
   case's limits, with the FMA route's bound beside them; fp32
   SDPA runs with TF32 off for matmuls and cuDNN. Quantized pages:
   int8 (int8-qk and convert), e4m3 and e5m2 at the engine's decode shape,
   an e4m3 chunk, and bf16 vs int8 vs e4m3 at scripts/bench_decode.py's
   shape (paged limit; yardstick SDPA over pre-gathered dequantized K/V,
   another function). At head dim 256 (Gemma 2B's MQA, 8 query heads over
   1 KV head: phase 3c's calls): decode B=32 at lengths 256-4096 over
   bf16, int8 ("qk") and e4m3 pages, a T=64 chunk at 2048 and the verify
   chunk (B=32, T=5) on the split route's tensor-core walk (each case
   reports its walk, checked); fp32 decode (B=8) and the int8
   "full" schedule on the first kernel (routes checked); the append at
   decode and a chunk; SDPA reads the KV head itself (enable_gqa) there.
   The append (paged_append) in every page format
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
   forward (flash_fwd_fp8) in ten cases, each launched once through
   fp8_attention on the route it must take (checked: the tensor cores but
   for the s8 case; (h) int8 at (1, 8, 8192, 256), row 6w's shape, (i)
   e4m3 at Gemma 2B's MQA, (1, 8, 1, 4096, 256), and (j) e5m2 at (h)'s
   shape, on the D = 256 kernels; above D = 256 on the wide kernels, phase
   5bx's call (1, 4, 2048, 512) in int8, s8, e4m3 and e5m2 (p)-(s), int8 at
   D = 264 (t) and D = 1024 (u), and int8 at D = 512 with GQA, window,
   sinks, soft-cap and dropout (v), each with SDPA's backend named),
   timed beside the FMA kernel on the same inputs (D <= 256), plus
   its straight-through backward (o and
   gradients at the bf16 flash limit: p is bf16 on the 8-bit path). The
   block-sparse forward (sparse_fwd) and backward (sparse_bwd) in twenty-nine
   cases, each launched once on the route it must take (checked by the
   route counters): the model phase's call (2, 12, 4096, 64) and the
   BASELINE head dim (1, 8, 8192, 128) with the local + global pattern,
   and N_q != N_k with 64-row q blocks and an LSE cotangent, on the tensor
   cores; GQA 12/4 at a ragged N = 1000 in fp32 with an empty q-block row
   (c), on the fp32 tensor-core kernels (3xTF32); at head dim 256 on the
   tensor cores, flash case
   (k)'s shape (1, 8, 8192, 256) with the local + global pattern (e),
   GQA 8/2 at D = 136 with N_q != N_k, blocks 64 x 128, an emptied q-block
   row and an LSE cotangent (f), phase 7b's call (1, 8, 1, 4096, 4096, 256)
   (g: MQA, phase 7's pattern) and the same at the attention widths of
   Qwen3.8-Flash-Next's block-sparse (QSA) layers, 24 query heads over 2
   KV heads (h); in fp32 on 3xTF32, phase 7d's call (i: case (a) in fp32)
   and GQA 8/2 at D = 128 with N_q != N_k, blocks 64 x 128, an emptied
   q-block row and an LSE cotangent (j); fp32 at D = 256 on the wide
   3xTF32 kernels, GQA 8/2 at (1, 8, 2, 1024, 1024, 256) (k), phase 7e's
   call (1, 8, 1, 4096, 4096, 256) (l: MQA, the dK/dV kernel's query-head
   split and the sum of its partials) and case (f) in fp32 (m); in bf16
   with blocks that are not multiples of 64, on the mma kernels, phase
   7f's call (2, 12, 4096, 64) at blocks 32 x 32 with the local + global
   pattern at width 16 (o), GQA 8/2 at (1, 8, 2, 2048, 2048, 128) with
   blocks 16 x 16 at width 32 (p), phase 7b's MQA call at blocks 32 x 32
   and width 16 (q) and case (f)'s edges at blocks 24 x 40 (r); in fp32
   with such blocks, on the fp32 mma kernels (3xTF32 on m16n8k8), blocks
   96 x 80 at D = 256 with GQA (n), phase 7g's call (s: case (o) in fp32),
   phase 7e's MQA call at blocks 32 x 32 and width 16 (t: case (q) in
   fp32) and case (r) in fp32 (u); above D = 256 on the wide kernels, in
   bf16 and in fp32 each, phase 7x's call (1, 4, 1, 4096, 4096, 512) (v;
   fp32 at N = 2048, vf), GQA 8/2 at D = 264 with blocks 96 x 80, an
   emptied q-block row and an LSE cotangent (w, wf), MQA at D = 512 on
   blocks of 32 at width 16 (x, xf) and (1, 2, 1, 1024, 1024, 1024) (y, yf),
   with no FMA comparison (those kernels stop at 256) and SDPA's backend
   named; the fp32 cases (c), (i)-(n), (s)-(u), the mma cases (o), (q) and
   the wide cases also name their kernels under
   torch.profiler (those of the route, with the wide route's split and
   sum and the mma route's sum of its chunks, checked). o and
   gradients at the flash limit (fp32 1e-4), LSE
   at 1e-4 where a row sees a key, -inf exactly on empty q blocks and the mask
   value exactly on rows of visited blocks that see no key, dK = dV = 0
   exactly on KV blocks no q block visits; bounds from the pairs the
   pattern keeps; times of the wrapper (which builds the lists on the
   device, and di in the backward), also issued from the host, and of the
   kernels alone with the lists built beforehand, and of the FMA kernels
   on the same inputs, which no call takes any more (fp32: with their
   bound at 67 TFLOP/s beside the route's at 165); both launched alone
   are first held against the plain version at the case's limits; SDPA
   with the expanded
   boolean mask as the library call (a yardstick where a row sees no key;
   fp32 with TF32 off).
3. The serving engine at GPT-3 Small widths (TransformerConfig defaults,
   bf16, random weights from a seed): 64 requests, prompts of 32-400
   tokens, 64 new tokens each. Every launch count is set to 0 just before
   and read just after; each kernel must have run, 12 paged-attention and
   12 append launches per decode step and per prefill chunk (those of
   the chunks counted apart, T > 1), every paged-attention launch on the
   split route, and on its tensor-core walk exactly those of calls with 3
   rows or more a KV head (here the prefill chunks). Then 32 admissions
   (128 prefill chunks) and 20 decode
   steps at batch 32, on the host clock and again under torch.profiler:
   wall ms, kernel ms and device ops per chunk and per step, the device's
   busy share and the top kernels; host syncs per chunk and per step (sync
   debug mode "warn") on the warm-up engine.
4. The card engine's first-token logits (bf16) against the same engine on
   the CPU in float32 (plain versions), and greedy agreement over 16 steps;
   every paged call of the card engine held against its plain version on
   the same inputs (paged limit); beside it, not gated, the CPU engine in
   bf16: the step where its tokens leave the fp32 ones, and its agreement
   with the card's.
3b. Phase 3 with quant="fp8" pages (64 requests), then quant="int8" (16
   requests, decode through the int8-qk schedule), with the same launch
   checks; phase 3's profile with fp8 pages.
4b. The fp8 card engine's first-token logits against the fp8 engine on the
   CPU in float32, at the FP8 rung (1e-1 abs+rel); its distance to the bf16
   card engine and their greedy agreement are reported, not gated.
3c. Serving a head-dim-256 model: Gemma 2B's attention widths cut to 6 of
   its 18 layers (``gemma_serving_config``: hidden 2048, 8 query heads over 1 KV
   head, head dim 256, d_ff 16384, rope, bf16, the port's vocab; weights
   drawn on the card from the seed), batch 32 on 16-slot pages up to 4096
   slots: 32 requests of 256-3072-token prompts, 64 new tokens each, with
   bf16, e4m3 and int8 pages, phase 3's launch checks (every paged launch
   on the split route's tensor-core walk at D = 256); phase 3's profile with 1024-token
   prompts, the decode window alone under the profiler (20 steps), with
   the paged kernels' share.
4c. Phase 4 at phase 3c's widths cut to 2 layers (``gemma_sparse_config``,
   served dense): bf16 pages at 5e-2 and e4m3 pages at 1e-1.
3d. Serving a head-dim-512 model (``wide_config``: Gemma 2B's widths with
   its query heads halved, 4 over 1 KV head, 2 layers, bf16, weights drawn
   on the host from the seed) on phase 3c's engine and traffic with 16
   requests, bf16, e4m3 and int8 pages, phase 3's launch checks (every
   paged launch on the split route's tensor-core walk, its output cut into
   two chunks of 256 columns; every append on the kernel). Phase 2 holds
   its calls (decode, T = 64 chunk and verify chunk, each over bf16, int8
   "convert", "qk" and "full", e4m3 and e5m2 pages; fp32 on the first
   kernel's chunked instantiation; D = 264, 384 and 1024 decode; above
   D = 1024, the scores summed over passes: D = 1032 and 2048 over bf16
   pages, 2048 over int8 and 1032 over e4m3 pages, on both kernels; the
   append in every format at D = 512, decode and chunk, and at 264, 384,
   1024) against their plain versions, the 8-bit forward at key blocks of
   48 (int8, e4m3), and the flash cases (p)-(y) (phase 5d's call, D = 264,
   384, 1024 and GQA with every feature at 512, bf16 and fp32) on
   flash_wide's kernels (the forward's chunks, the backward's clusters),
   naming SDPA's backend at each, (p) and (u) kernel by kernel.
4d. Phase 4 at phase 3d's model: bf16 pages at 5e-2, e4m3 and int8 at 1e-1.
5d. Training phase 3d's model: ``train_step`` at B = 1, N = 2048, 2
   untimed and 4 timed micro-steps, phase 5's launch checks (4 flash_fwd and
   2 flash_bwd a micro-step, all on flash_wide's kernels: the backward's
   cluster kernels, dK/dV's walk split in 4 and summed) and a profiled
   micro-step; one loss and its gradients card vs fp32 CPU at N = 512 in
   bf16 (5e-2) and in fp32 (1e-4).
5. Training at GPT-3 Small widths (dropout 0.1, remat "full", bf16 compute,
   fp32 parameters), TrainConfig(batch_size=8, seq_len=512, grad_accum=2,
   warmup_steps=2) on the synthetic stream of seed 0: 2 untimed
   micro-steps, then 8 timed ones (4 optimizer updates), each timed on the
   host clock up to ``loss.item()``. Launch counts are set to 0 just before
   and read just after: exactly 24 forward launches per micro-step (12
   layers and their remat recompute) and 12 backward launches. Then one
   micro-step under torch.profiler, with the flash kernels' device time;
   its flash kernels must be those of the bf16 route at D = 64.
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
5bx. Phase 5b at head dim 512, (1, 4, 2048, 512) causal (phase 3d's
   model's attention call): e4m3 predecodes onto the flash kernels above
   256 (one flash_fwd), int8 and s8 take the 8-bit wide kernels (one
   flash_fwd_fp8 each, counted on that route), each with one flash_bwd;
   card vs CPU at (1, 4, 512, 512). fp8 cases (p) and (q) hold the 8-bit
   kernel at this call's shape.
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
7b. Phase 7 at head dim 256: Gemma 2B's attention widths (google/gemma-2b
   config.json: hidden 2048, 8 query heads, 1 KV head, head_dim 256,
   intermediate 16384; cut to 2 layers, the port's vocab 50257, its GELU
   MLP and LayerNorm; rope), B=1, N=4096, the same pattern: exactly 2
   sparse_fwd per no-grad forward, 4 sparse_fwd and 2 sparse_bwd per step,
   all on the tensor-core route (the D = 256 kernels), no flash launch;
   card vs CPU at N=512; the all-ones pattern against the flash route.
7c. Phase 7b's widths dense and in fp32 (``gemma_dense_fp32_config``), so
   every attention call runs the fp32 flash kernels at D = 256 (MQA 8/1):
   one loss and its gradients at B=1, N=512 on the card against the CPU in
   fp32 (1e-4, the fp32 rung), then ``train_step`` at B=1, N=4096: 2
   untimed and 3 timed micro-steps, exactly 4 forward and 2 backward flash
   launches each (checked), and one profiled micro-step with the flash
   kernels' share of it, whose flash kernels must be the wide 3xTF32 ones
   (with the sum of the dK/dV partials). Flash case (o) holds these
   kernels at this call's shape.
7d. Phase 7 in fp32 (dtype and parameters): GPT-3 Small at all 12 layers,
   B=2, N=4096, the same pattern, so every attention call runs the fp32
   sparse kernels on 3xTF32 at D = 64: exactly 12 sparse_fwd per no-grad
   forward, 24 sparse_fwd and 12 sparse_bwd per step, all on the
   tensor-core route, no flash launch; a profiled step whose sparse
   kernels must be the fp32 tensor-core ones (their share of the step's
   kernels reported); card vs CPU at N=512 and the all-ones pattern
   against the flash route at the fp32 rung (1e-4). Sparse case (i) holds
   these kernels at this call's shape.
7e. Phase 7b in fp32 (dtype and parameters: phase 7c's model with the
   pattern), B=1, N=4096, so every attention call runs the wide 3xTF32
   sparse kernels at D = 256 (MQA 8/1): exactly 2 sparse_fwd per no-grad
   forward, 4 sparse_fwd and 2 sparse_bwd per step, all on the
   tensor-core route, no flash launch; a profiled step whose sparse
   kernels must be the wide ones with the split of the backward's B
   operands and the sum of the dK/dV partials (their share of the step's
   kernels reported); card vs CPU at N=512 and the all-ones pattern
   against the flash route at 1e-4. Sparse case (l) holds these kernels at
   this call's shape.
7f. Phase 7 at blocks of 32 (``block_size=32``) with the local + global
   pattern at width 16 (q tile i sees tiles i - 15 .. i and tile 0: about
   the 512-key window of phase 7's 4 tiles of 128, on 128 x 128 tiles), so
   every attention call runs the mma kernels: exactly 12 sparse_fwd per
   no-grad forward, 24 sparse_fwd and 12 sparse_bwd per step, all on the
   mma route (none on the tensor-core or FMA kernels), no flash launch; a
   profiled step whose sparse kernels must be the mma ones (their share of
   the step's kernels reported); card vs CPU at N=512 (block 32) at the
   bf16 training rung and the all-ones pattern against the flash route.
   Sparse case (o) holds these kernels at this call's shape.
7g. Phase 7f in fp32 (dtype and parameters), so every attention call runs
   the fp32 mma kernels (3xTF32 on m16n8k8): exactly 12 sparse_fwd per
   no-grad forward, 24 sparse_fwd and 12 sparse_bwd per step, all on the
   mma route (none on the tensor-core kernels, the FMA kernels or the bf16
   mma ones, whose names the profile would show), no flash launch; a
   profiled step whose sparse kernels must be the fp32 mma ones with the
   sum of the dK/dV chunks (their share of the step's kernels reported);
   card vs CPU at N=512 and the all-ones pattern against the flash route
   at 1e-4. Sparse case (s) holds these kernels at this call's shape.
7x. Phase 7b at head dim 512 (``wide_config``: Gemma 2B's widths with 4
   query heads over 1 KV head, 2 layers, B = 1, N = 4096, blocks of 128):
   every attention call on the wide sparse kernels, exactly 2 sparse_fwd
   per no-grad forward and 4 sparse_fwd + 2 sparse_bwd per step, no flash
   launch; a profiled step whose sparse kernels must be the wide ones with
   the sum of the dK/dV chunks; card vs CPU at N = 512 in bf16 (5e-2) and
   in fp32 (1e-4, its card launches counted for the fp32 rows), and the
   all-ones pattern against the flash route. Sparse cases (v) and (vf)
   hold these kernels at this call's shape (fp32 at N = 2048).
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
   on the card (its flash launches on the 3xTF32 kernels, checked) against
   the CPU (1e-3, and every token's experts equal;
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
   exactly 24 flash_fwd launches a forward, all on the 3xTF32 tensor-core
   route, and nothing else, loss and perplexity, the forward's time, one forward traced by
   ``utils.profiling.trace`` (its Chrome trace must hold flash_fwd
   kernels). Phase 5's training on the packed rows through
   ``data.prefetch`` (2 + 4 micro-steps, 24 + 12 flash launches a
   micro-step on the tensor cores, the loss without dropout of a batch it
   never trains on falling). ``bench.sweep.run_config`` at phase-2 case
   (b)'s (1, 8, 8192, 128) causal: fa2 forward, fa2 forward + backward and
   fa3 int8 forward (the 8-bit kernel), and at case (k)'s (1, 8, 8192,
   256) fa2 forward, fa2 forward + backward and fa3 int8 forward (fp8 case
   (h)'s shape, the D = 256 8-bit kernel), each record "ok" with a roofline
   share of the card's peak in (0, 1.05] and a time within 1.25x of one
   traced call's kernels; ``profiling.timed`` on one flash call;
   ``bench.scaling`` at size 1 on one NCCL rank.

The last two lines are the kernels' JSON record and the device line
``{"ok": true, "device": {...}}``; the kernels' record carries the verify
chunk's two rows (``paged_attention[verify]``, ``paged_append[verify]``:
launches inside phase 8's self-arm verify passes, numbers of the phase-2
verify cases), phase 3c's rows (``paged_attention[d256]``,
``[chunk,d256]``, ``[d256,int8]``, ``[d256,fp8]``, ``paged_append[d256]``,
``[chunk,d256]``: launches of the D = 256 engine runs, numbers of the
phase-2 d256 cases) and the rows of phases 10-11's paths
(``flash_fwd[ring]`` ... ``[all_gather]`` with the schedules' summed
per-rank times, ``[sharded_zero1]``, ``[pipelined]``, ``[moe]`` with the
numbers of phase 2's matching cases) and of phase 12's
(``flash_fwd[compat]`` with the numbers of phase-2 cases (e) and (i),
``flash_fwd[fp32]`` with compat's launches and ``flash_bwd[fp32]`` with
phase 11's fp32 card check's, numbers of cases (e) and (h),
``flash_fwd[packed]`` and ``flash_bwd[packed]`` with case (j),
``flash_fwd[sweep]`` and ``flash_bwd[sweep]`` with case (b),
``flash_fwd_fp8[sweep]`` with fp8 case (b), ``flash_fwd_fp8[sweep_d256]``
with the d = 256 fa3 cell's launches and fp8 case (h), ``flash_fwd[d256]`` and
``flash_bwd[d256]``: launches of the d = 256 sweep cells, numbers of case
(k) with case (l) beside them; ``flash_fwd[fp32_d256]`` and
``flash_bwd[fp32_d256]``: launches of phase 7c's timed micro-steps,
numbers of case (o), its call, with cases (m) and (n) beside them;
``sparse_fwd[d256]`` and ``sparse_bwd[d256]``: launches of phase 7b's
steps, numbers of sparse case (g), phase 7b's call, with cases (e), (f)
and (h) beside them; ``sparse_fwd[fp32]`` and ``sparse_bwd[fp32]``:
launches of phase 7d's steps, numbers of sparse case (i), phase 7d's call,
with cases (c) and (j) beside them; ``sparse_fwd[fp32_d256]`` and
``sparse_bwd[fp32_d256]``: launches of phase 7e's steps, numbers of sparse
case (l), phase 7e's call, with cases (k) and (m) beside them;
``sparse_fwd[mma]`` and ``sparse_bwd[mma]``: launches of phase 7f's steps,
numbers of sparse case (o), phase 7f's call, with cases (p), (q) and (r)
beside them; ``sparse_fwd[f32_mma]`` and ``sparse_bwd[f32_mma]``: launches
of phase 7g's steps, numbers of sparse case (s), phase 7g's call, with
cases (n), (t) and (u) beside them).
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
import importlib.util
import json
import math
import re
import shutil
import socket
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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
from flashattention_tpu_torch.ops.quant import quantize_blocks, quantize_tokens
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
# fp32-exact products on the tensor cores: 3xTF32 is three TF32 products
# (495 TFLOP/s dense) per fp32 product, the rate of the fp32 flash route
TF32X3_FLOPS_PER_S = 495e12 / 3
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
# Above D = 128 (Gemma 2B's MQA at lengths up to 4096) an output is the mean
# of thousands of values, |o| ~ 0.03 where max|plain| is ~0.4, and 2e-2
# abs+rel would pass a split dropped or merged wrong. There bf16 is held
# to two ulps (rtol 1.6e-2) + WIDE_PAGED_ATOL x max|plain|: both versions
# round p and the output to bf16, at different maxima.
WIDE_PAGED_ATOL = 5e-3
LSE_TOL = 1e-4     # both versions take the LSE from the same fp32 scores
LOGITS_TOL = 5e-2  # bf16 rung of the ladder: bf16 card engine vs fp32 CPU
FP8_TOL = 1e-1     # FP8 rung: the fp8 card engine vs the fp32 CPU fp8 engine
TRAIN_TOL = 5e-2   # bf16 card training loss and grads vs the fp32 CPU
MOE_TOL = 1e-3     # the MoE loss and grads, fp32 card vs fp32 CPU
FP32_TOL = 1e-4    # fp32 rung: a dense or sparse fp32 model, card vs CPU

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
    # above head dim 256: the forward's chunked mma.sync kernels, bf16 and
    # fp32
    "flash_fwd_wide": dict(
        route="cuda", source="flashattention_tpu_torch/csrc/flash_wide.cu",
        replaces="flashattention_tpu/ops/pallas_attn.py:391"),
    # one call: the dK/dV cluster kernel (with its walk split, the sum of
    # the partials), then the dQ cluster kernel, on wgmma (the TPU
    # backward's four launches, :1362 :1390 :1423 :1475)
    "flash_bwd_wide": dict(
        route="cuda", source="flashattention_tpu_torch/csrc/flash_wide.cu",
        replaces="flashattention_tpu/ops/pallas_attn.py:885",
        also_replaces=["flashattention_tpu/ops/pallas_attn.py:768",
                       "flashattention_tpu/ops/pallas_attn.py:1040"]),
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
    # above head dim 256: the chunked mma.sync kernels, bf16 and fp32
    "sparse_fwd_wide": dict(
        route="cuda", source="flashattention_tpu_torch/csrc/sparse_wide.cu",
        replaces="flashattention_tpu/ops/pallas_sparse.py:96"),
    "sparse_bwd_wide": dict(
        route="cuda", source="flashattention_tpu_torch/csrc/sparse_wide.cu",
        replaces="flashattention_tpu/ops/pallas_sparse.py:259",
        also_replaces=["flashattention_tpu/ops/pallas_sparse.py:311"]),
    "flash_fwd_fp8_wide": dict(
        route="cuda", source="flashattention_tpu_torch/csrc/fp8_wide.cu",
        replaces="flashattention_tpu/ops/pallas_fp8.py:92"),
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


def sdpa_yardstick(q, kp, vp, pi, lengths, scale, window, sinks, gqa=False):
    """A closure timing one scaled_dot_product_attention call over K/V
    gathered to contiguous tensors beforehand (the gather is not timed).
    ``gqa``: SDPA reads the KV heads itself (``enable_gqa``); else K/V are
    expanded to every query head beforehand (the rows of the GPT-3 Small
    cases, which are MHA or GQA 12/4), which at MQA 8/1 would read 8x the
    bytes."""
    b = pi.shape[0]
    h_kv, _, page, d = kp.shape
    h = q.shape[1]
    qq = q[:, :, None] if q.dim() == 3 else q
    k = kp[:, pi.long()].transpose(0, 1).reshape(b, h_kv, -1, d)
    v = vp[:, pi.long()].transpose(0, 1).reshape(b, h_kv, -1, d)
    if not gqa:
        k = k.repeat_interleave(h // h_kv, dim=1)
        v = v.repeat_interleave(h // h_kv, dim=1)
    k, v = k.contiguous(), v.contiguous()
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
    kw = dict(enable_gqa=True) if gqa else {}
    return lambda: f(qq, k, v, attn_mask=mask, scale=scale, **kw)


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


def paged_tol(dtype, d, ref):
    """(rtol, atol) of a paged kernel output against its plain version
    ``ref`` at head dim ``d``."""
    if dtype == torch.bfloat16 and d > 128:
        return (KERNEL_RTOL[dtype],
                WIDE_PAGED_ATOL * float(ref.float().abs().max()))
    return PAGED_TOL[dtype], PAGED_TOL[dtype]


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
                   softcap=None, quant=None, int8_qk=None, gqa=False,
                   **shape):
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
    # the split kernel's walk: tensor cores or lane groups (a package
    # without the tensor-core walk, as scripts/paged_ab.py may time, has no
    # tc_launches)
    tc_count = lambda: getattr(pa.paged_attention, "tc_launches", 0)
    s0, t0 = pa.paged_attention.split_launches, tc_count()
    out = pa.paged_attention(q, kp, vp, pi, ln, softmax_scale=scale, **kw)
    torch.cuda.synchronize()
    route = "split" if pa.paged_attention.split_launches > s0 else "first"
    walk = ("tc" if tc_count() > t0 else "lanes") if route == "split" else None
    ref = pa.paged_attention_plain(q, kp, vp, pi, ln, softmax_scale=scale, **kw)
    rtol, atol = paged_tol(dtype, q.shape[-1], ref)
    max_err = check_close(name, out, ref, rtol, atol)
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
                f"{name} (first kernel)", call(), ref, rtol, atol)
            first["first_ms"] = timer(call)
            first["first_wall_ms"] = timer.wall(call)
    plain_ms = timer(lambda: pa.paged_attention_plain(
        q, kp, vp, pi, ln, softmax_scale=scale, **kw), reps=10)
    sdpa_ms = None
    if softcap is None:  # SDPA has no soft-capping
        lk, lv = library_pages or (kp, vp)
        sdpa_ms = timer(sdpa_yardstick(q, lk, lv, pi, ln, scale, window,
                                       sinks, gqa=gqa))
    mode = (pa.int8_mode(kp, q.dtype, 1 if q.dim() == 3 else q.shape[2],
                         int8_qk) if quant else None)
    bound_ms, bound_by = attention_bound(q, kp, pi, ln, window, sinks,
                                         quantized=quant is not None,
                                         schedule=mode)
    # over quantized pages SDPA (on the dequantized pages) computes another
    # function: a yardstick, not the library call
    library_ms, yardstick_ms = (None, sdpa_ms) if quant else (sdpa_ms, None)
    rec = dict(case=name, route=route, walk=walk, max_abs_err=max_err,
               rtol=rtol,
               atol=atol, ms=ms, wall_ms=wall_ms, **first,
               plain_ms=plain_ms, library_ms=library_ms,
               yardstick_ms=yardstick_ms, bound_ms=bound_ms,
               bound_by=bound_by, shape={k: v for k, v in shape.items()},
               window=window, sinks=sinks, softcap=softcap, quant=quant,
               schedule=mode, dtype=str(dtype).replace("torch.", ""))
    log(f"[kernel] paged_attention {name}: {route} route"
        + (f" ({walk} walk)" if walk else "") + ", max_abs_err "
        f"{max_err:.3e} (rtol {rtol:g} + atol {atol:.3e})  kernel_ms "
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
# Cases whose inputs are also run on the FMA route (the first kernels,
# which no call takes any more), held against the plain version and timed:
# each redesign's before/after on one card in one call (bf16: (a), (a0),
# (b); fp32 on 3xTF32: (e), (h), (i); bf16 at D = 256: (k), (l); fp32 at
# D = 256: (m), (n), (o)).
FMA_COMPARE = ("a", "a0", "b", "e", "h", "i", "k", "l", "m", "n", "o")
# Cases also timed kernel by kernel (torch.profiler, by
# scripts/flash_kernel_split.py's kernel_ms: only causal or not, no other
# option), which also shows the kernels of the case's route ran
FLASH_SPLIT = ("k", "m", "o", "p", "u")
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
    # head dim 256: the sweep's d = 256 cell at N = 8K (phase 12), and the
    # features on the D-split backward
    "k": ("sweep's d=256 cell B=1 H=8 N=8192 D=256 bf16 causal",
          (1, 8, 8, 8192, 8192, 256), BF16, dict(causal=True), ()),
    "l": ("GQA 8/2 window 96 sinks 4 softcap 30 dropout 0.1, B=2 N=300 "
          "D=256 bf16", (2, 8, 2, 300, 300, 256), BF16,
          dict(causal=True, window=96, sinks=4, softcap=30.0,
               dropout_rate=0.1, dropout_seed=21), ()),
    # (k) and (l) in fp32: the wide 3xTF32 kernels (phase 7c's route), and
    # (o), phase 7c's exact call: MQA, where the dK/dV kernel spreads the 8
    # query heads of the KV head over CTAs and a sum kernel adds them
    "m": ("fp32 B=1 H=8 N=8192 D=256 causal", (1, 8, 8, 8192, 8192, 256),
          FP32, dict(causal=True), ()),
    "n": ("GQA 8/2 window 96 sinks 4 softcap 30 dropout 0.1, B=2 N=300 "
          "D=256 fp32", (2, 8, 2, 300, 300, 256), FP32,
          dict(causal=True, window=96, sinks=4, softcap=30.0,
               dropout_rate=0.1, dropout_seed=21), ()),
    "o": ("phase 7c's call: MQA 8/1 B=1 N=4096 D=256 fp32 causal",
          (1, 8, 1, 4096, 4096, 256), FP32, dict(causal=True), ()),
}
# Above head dim 256, flash_wide.cu's kernels: (p) phase 5d's call
# (Gemma 2B's widths with its query heads halved: 4 over 1 KV head, D =
# 512), D = 264 (a last chunk of 8 columns) and 384 causal, D = 1024 (8
# forward chunks), and GQA 4/2 with window, sinks, soft-cap and dropout at
# D = 512; (u)-(y) the same in fp32 (3xTF32).
_WIDE_FLASH = {
    "p": ("phase 5d's call: MQA 4/1 B=1 N=2048 D=512", (1, 4, 1, 2048, 2048,
                                                         512), {}),
    "q": ("B=1 H=4 N=1024 D=264", (1, 4, 4, 1024, 1024, 264), {}),
    "r": ("B=1 H=4 N=1024 D=384", (1, 4, 4, 1024, 1024, 384), {}),
    "s": ("MQA 2/1 B=1 N=1024 D=1024", (1, 2, 1, 1024, 1024, 1024), {}),
    "t": ("GQA 4/2 window 256 sinks 4 softcap 30 dropout 0.1, B=1 N=1024 "
          "D=512", (1, 4, 2, 1024, 1024, 512),
          dict(window=256, sinks=4, softcap=30.0, dropout_rate=0.1,
               dropout_seed=21)),
}
for (_b, _f), (_label, _shape, _kw) in zip(
        zip("pqrst", "uvwxy"), _WIDE_FLASH.values()):
    for _key, _dt, _name in ((_b, BF16, "bf16"), (_f, FP32, "fp32")):
        FLASH_CASES[_key] = (f"{_label} {_name} causal", _shape, _dt,
                             dict(causal=True, **_kw), ())
# the wide cases, whose SDPA backend (PyTorch's pick) the record names
FLASH_WIDE = tuple("pqrstuvwxy")


def sdpa_backend(call, tries=3) -> str:
    """The backend PyTorch's SDPA dispatcher picks for ``call``, from the
    names of the device kernels one call launches (torch.profiler): flash,
    efficient (the cutlass memory-efficient kernels), cudnn, or math (a
    product and a softmax). CUPTI drops some profiles' records, so a
    profile that names none is taken again, up to ``tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    names = ""
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names = " ".join(e.name for e in prof.events()
                         if e.device_type == DeviceType.CUDA).lower()
        for tag, backend in (("pytorch_flash", "flash"),
                             ("flash_fwd", "flash"), ("fmha", "efficient"),
                             ("cudnn", "cudnn"), ("softmax", "math")):
            if tag in names:
                return backend
    return f"not known ({names[:60]})"


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


def flash_bound(q, k, opts, dlse, peak=None):
    """Least times (ms) of the forward and the backward for the pairs these
    inputs keep: 4·D (forward) and 10·D (backward) flops per visible
    (head, row, key), against each input read once and each output written
    once."""
    b, h, n_q, d = q.shape
    n_k = k.shape[2]
    vis = fa.visible_mask(opts, n_q, n_k, q.device)
    pairs = (b * h * n_q * n_k if vis is None
             else int(vis.expand(b, 1, n_q, n_k).sum()) * h)
    return (attention_bounds(q, k, pairs, dlse, peak),
            pairs / (b * h * n_q * n_k))


def flash_peak(dtype):
    """The operations rate of the flash route a call takes: bf16 wgmma, or
    3xTF32 wgmma for fp32 (every head dim make_opts accepts)."""
    return BF16_FLOPS_PER_S if dtype == torch.bfloat16 else TF32X3_FLOPS_PER_S


def attention_bounds(q, k, pairs, dlse, peak=None):
    """{"fwd"|"bwd": (least ms, what bounds it)} for ``pairs`` visible
    (head, row, key) triples: 4·D and 10·D flops per pair at ``peak``
    (default: the rate of the route the call takes) against q, k, v read
    and o, the LSE written once (forward), and q, k, v, o, do, the LSE (and
    its cotangent) read and dq, dk, dv written once (backward)."""
    b, h, n_q, d = q.shape
    el = q.element_size()
    qo = q.numel() * el                      # q, o, do, dq each
    kv = k.numel() * el                      # k, v, dk, dv each
    rows = b * h * n_q * 4                   # lse, dlse
    if peak is None:
        peak = flash_peak(q.dtype)
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
    (``fat_flash_fwd`` / ``fat_flash_bwd``) on inputs the wrapper would
    send to the tensor cores: the first kernels' time on the same card.
    They return their outputs, (o, lse) and [dq, dk, dv]."""
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
        return o_out, lse_out

    def run_bwd():
        _build.check(bwd.fat_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), *(g.data_ptr() for g in grads),
            *ext, *fa._scalars(q, k, opts)), "fma bwd")
        return grads
    return run_fwd, run_bwd


def kernel_split_ms(q, k, v, do, causal) -> dict[str, float]:
    """{flash kernel: device ms a call} of scripts/flash_kernel_split.py,
    loaded by its path (a package named ``scripts`` elsewhere on the path
    would shadow the directory)."""
    path = (Path(__file__).resolve().parent / "scripts"
            / "flash_kernel_split.py")
    spec = importlib.util.spec_from_file_location("flash_kernel_split", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.kernel_ms(q, k, v, do, causal)


def flash_case(timer, gen, dev, key):
    label, shape, dtype, kw, extras = FLASH_CASES[key]
    q, k, v, do, dlse, more = _flash_inputs(gen, dev, shape, dtype, extras)
    opts = fa.make_opts(q, k, **kw, **more)
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
    if (c["flash_fwd"], c["flash_bwd"]) != (1, 1):
        fail(f"flash {key}: launches {c}; want one each way")
    if q.shape[-1] > fa.SM90_MAX_HEAD_DIM:
        route = ("tensor cores (chunked mma.sync forward, wgmma + TMA "
                 "cluster backward)" if dtype == torch.bfloat16
                 else "tensor cores (chunked 3xTF32 mma.sync forward, 3xTF32 "
                 "wgmma + TMA cluster backward)")
    else:
        route = ("tensor cores (wgmma + TMA)" if dtype == torch.bfloat16
                 else "tensor cores (3xTF32 wgmma + TMA)")

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
    if key in FMA_COMPARE:
        # the FMA kernels, held against the plain version at the case's
        # limits before they are timed
        fma_fwd, fma_bwd = fma_route(q, k, v, o_ref, lse_ref, do, dlse, opts)
        fma_out = [*fma_fwd(), *fma_bwd()]
        torch.cuda.synchronize()
        fma_err = {
            "o": check_close(f"FMA flash_fwd {key} o", fma_out[0], o_ref,
                             *tols["o"]),
            "lse": check_close(f"FMA flash_fwd {key} lse", fma_out[1][seen],
                               lse_ref[seen], LSE_TOL)}
        for name, g, r in zip(("dq", "dk", "dv"), fma_out[2:], plain_bwd()):
            fma_err[name] = check_close(f"FMA flash_bwd {key} {name}", g, r,
                                        *tols[name])
        t["fma_max_abs_err"] = fma_err
        del fma_out
        t["fwd_fma_ms"] = timer(fma_fwd, reps=10 if big else 30)
        t["bwd_fma_ms"] = timer(fma_bwd, reps=10 if big else 30)
        # the first kernels' bound, at 67 TFLOP/s
        fma_bounds, _ = flash_bound(q, k, opts, dlse, FP32_FLOPS_PER_S)
        t["fwd_fma_bound_ms"] = fma_bounds["fwd"][0]
        t["bwd_fma_bound_ms"] = fma_bounds["bwd"][0]
    if key in FLASH_SPLIT:
        t["kernel_ms"] = kernel_split_ms(q, k, v, do, kw["causal"])
        ran = {n.split("<")[0] for n in t["kernel_ms"]}
        if t["kernel_ms"] and ran - {"kv_sum_kernel"} != \
                fa.route_kernels(dtype, shape[-1]):
            fail(f"flash {key}: the profiler saw {sorted(ran)}; want "
                 f"{sorted(fa.route_kernels(dtype, shape[-1]))}")
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
    if key in FLASH_WIDE:
        t["library_backend"] = sdpa_backend(lambda: sdpa(
            q, k, v, is_causal=causal, scale=opts.scale, enable_gqa=gqa))
        log(f"[kernel] flash {key}: SDPA's backend at D = {q.shape[-1]}: "
            f"{t['library_backend']}")
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
           " (max_abs_err vs plain "
           + " ".join(f"{n} {e:.2e}" for n, e in t["fma_max_abs_err"].items())
           + ")" if "fwd_fma_ms" in t else "")
    if "fwd_fma_bound_ms" in t:
        fma += (f" (its bound at {FP32_FLOPS_PER_S / 1e12:g} TFLOP/s: fwd "
                f"{t['fwd_fma_bound_ms']:.4f} bwd {t['bwd_fma_bound_ms']:.4f})")
    if "kernel_ms" in t:
        log("[kernel]   device ms a call by kernel (torch.profiler): "
            + (", ".join(f"{n} {v:.4f}" for n, v in t["kernel_ms"].items())
               or "not measured (no kernel recorded)"))
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


def emptied(pattern, row):
    """``pattern`` with q-block row ``row`` attending to nothing."""
    p = pattern.clone()
    p[row] = False
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
    # head dim 256 on the tensor cores: flash case (k)'s shape, and the
    # edges of the D-split kernels (GQA, one consumer in the forward and dQ,
    # a 128-key block over two dK/dV CTAs, a 64-column half past D = 136)
    "e": ("flash case (k)'s shape (1, 8, 8192, 256) bf16 causal, "
          "local+global on 64 x 64 tiles of 128", (1, 8, 8, 8192, 8192, 256),
          BF16, True, (128, 128), local_global(64, 64), False),
    "f": ("GQA 8/2, N_q 384 != N_k 512, D=136 bf16 causal, blocks 64 x 128, "
          "local+global with q-block row 2 emptied, LSE cotangent",
          (2, 8, 2, 384, 512, 136), BF16, True, (64, 128),
          emptied(local_global(6, 4), 2), True),
    # phase 7b's call (Gemma 2B's MQA: one dK/dV CTA walks 8 heads), and
    # the attention widths of Qwen3.8-Flash-Next's QSA block-sparse layers
    # (Qwen/Qwen3.8-Flash-Next config.json: head_dim 256, 24 query heads,
    # 2 KV heads) on the same call
    "g": ("phase 7b's call (1, 8, 1, 4096, 4096, 256) bf16 causal, "
          "local+global on 32 x 32 tiles of 128", (1, 8, 1, 4096, 4096, 256),
          BF16, True, (128, 128), local_global(32, 32), False),
    "h": ("QSA widths (1, 24, 2, 4096, 4096, 256) bf16 causal, local+global "
          "on 32 x 32 tiles of 128", (1, 24, 2, 4096, 4096, 256), BF16, True,
          (128, 128), local_global(32, 32), False),
    # fp32 on the 3xTF32 tensor-core kernels: phase 7d's call (case (a) in
    # fp32), and the edges (one consumer everywhere, a 128-key block over
    # two dK/dV CTAs, GQA, N_q != N_k, an emptied q-block row, an LSE
    # cotangent); then fp32 at D = 256 on the wide kernels (k), (l) (phase
    # 7e's call: MQA, 8 dK/dV CTAs a KV block, partials summed) and (m)
    # (case (f) in fp32: D = 136, the edges above)
    "i": ("phase 7d's call (2, 12, 4096, 64) fp32 causal, local+global on "
          "32 x 32 tiles of 128", (2, 12, 12, 4096, 4096, 64), FP32, True,
          (128, 128), local_global(32, 32), False),
    "j": ("GQA 8/2, N_q 384 != N_k 512, D=128 fp32 causal, blocks 64 x 128, "
          "local+global with q-block row 2 emptied, LSE cotangent",
          (2, 8, 2, 384, 512, 128), FP32, True, (64, 128),
          emptied(local_global(6, 4), 2), True),
    "k": ("GQA 8/2 (1, 8, 2, 1024, 1024, 256) fp32 causal, local+global on "
          "8 x 8 tiles of 128", (1, 8, 2, 1024, 1024, 256),
          FP32, True, (128, 128), local_global(8, 8), False),
    "l": ("phase 7e's call (1, 8, 1, 4096, 4096, 256) fp32 causal, "
          "local+global on 32 x 32 tiles of 128", (1, 8, 1, 4096, 4096, 256),
          FP32, True, (128, 128), local_global(32, 32), False),
    "m": ("GQA 8/2, N_q 384 != N_k 512, D=136 fp32 causal, blocks 64 x 128, "
          "local+global with q-block row 2 emptied, LSE cotangent",
          (2, 8, 2, 384, 512, 136), FP32, True, (64, 128),
          emptied(local_global(6, 4), 2), True),
    # bf16 with blocks that are not multiples of 64, on the mma kernels
    # (16-row slices anchored at each block's start): phase 7f's call (o);
    # blocks of 16 at D = 128 with GQA (p); phase 7b's MQA call at blocks
    # of 32 (q: a KV block's dK/dV walk spans the group's 8 heads and is
    # cut into chunks over CTAs, whose warps split the head dim); case
    # (f)'s edges at blocks 24 x 40 (r: slices past a block's end, partial
    # key sub-tiles, a column block past D)
    "o": ("phase 7f's call (2, 12, 4096, 64) bf16 causal, local+global width "
          "16 on 128 x 128 tiles of 32", (2, 12, 12, 4096, 4096, 64), BF16,
          True, (32, 32), local_global(128, 128, 16), False),
    "p": ("GQA 8/2 (1, 8, 2, 2048, 2048, 128) bf16 causal, blocks 16 x 16, "
          "local+global width 32", (1, 8, 2, 2048, 2048, 128), BF16, True,
          (16, 16), local_global(128, 128, 32), False),
    "q": ("phase 7b's call (1, 8, 1, 4096, 4096, 256) bf16 causal at blocks "
          "32 x 32, local+global width 16", (1, 8, 1, 4096, 4096, 256),
          BF16, True, (32, 32), local_global(128, 128, 16), False),
    "r": ("GQA 8/2, N_q 384 != N_k 512, D=136 bf16 causal, blocks 24 x 40, "
          "local+global with q-block row 2 emptied, LSE cotangent",
          (2, 8, 2, 384, 512, 136), BF16, True, (24, 40),
          emptied(local_global(16, 13), 2), True),
    # fp32 with blocks that are not multiples of 64, on the fp32 mma
    # kernels (3xTF32 on m16n8k8): blocks 96 x 80 at D = 256 with GQA (n,
    # the FMA route until the fp32 mma kernels); phase 7g's call (s: case
    # (o) in fp32); phase 7e's MQA call at blocks of 32 (t: case (q) in
    # fp32, the D split and the chunks); case (r) in fp32 (u)
    "n": ("GQA 8/2 (1, 8, 2, 1000, 1000, 256) fp32 causal, blocks 96 x 80, "
          "random density 0.4 with an empty q-block row",
          (1, 8, 2, 1000, 1000, 256), FP32, True, (96, 80),
          random_pattern(11, 13, 0.4, 3, SEED), False),
    "s": ("phase 7g's call (2, 12, 4096, 64) fp32 causal, local+global width "
          "16 on 128 x 128 tiles of 32", (2, 12, 12, 4096, 4096, 64), FP32,
          True, (32, 32), local_global(128, 128, 16), False),
    "t": ("phase 7e's call (1, 8, 1, 4096, 4096, 256) fp32 causal at blocks "
          "32 x 32, local+global width 16", (1, 8, 1, 4096, 4096, 256),
          FP32, True, (32, 32), local_global(128, 128, 16), False),
    "u": ("GQA 8/2, N_q 384 != N_k 512, D=136 fp32 causal, blocks 24 x 40, "
          "local+global with q-block row 2 emptied, LSE cotangent",
          (2, 8, 2, 384, 512, 136), FP32, True, (24, 40),
          emptied(local_global(16, 13), 2), True),
    # above head dim 256, on the wide kernels (the mma route's walks and
    # chunks, the head dim cut into segments and output chunks), each in
    # bf16 and fp32: phase 7x's call (v; fp32 at N = 2048 for the script's
    # time), GQA 8/2 at D = 264 with blocks 96 x 80, an emptied q-block row
    # and an LSE cotangent (w), MQA at D = 512 on blocks of 32 at width 16
    # (x: 32 dK/dV walk chunks), and D = 1024 (y)
    "v": ("phase 7x's call (1, 4, 1, 4096, 4096, 512) bf16 causal, "
          "local+global on 32 x 32 tiles of 128", (1, 4, 1, 4096, 4096, 512),
          BF16, True, (128, 128), local_global(32, 32), False),
    "vf": ("phase 7x's call at N = 2048 (1, 4, 1, 2048, 2048, 512) fp32 "
           "causal, local+global on 16 x 16 tiles of 128",
           (1, 4, 1, 2048, 2048, 512), FP32, True, (128, 128),
           local_global(16, 16), False),
    "w": ("GQA 8/2 (1, 8, 2, 1000, 1000, 264) bf16 causal, blocks 96 x 80, "
          "random density 0.4 with q-block row 3 emptied, LSE cotangent",
          (1, 8, 2, 1000, 1000, 264), BF16, True, (96, 80),
          random_pattern(11, 13, 0.4, 3, SEED), True),
    "wf": ("GQA 8/2 (1, 8, 2, 1000, 1000, 264) fp32 causal, blocks 96 x 80, "
           "random density 0.4 with q-block row 3 emptied, LSE cotangent",
           (1, 8, 2, 1000, 1000, 264), FP32, True, (96, 80),
           random_pattern(11, 13, 0.4, 3, SEED), True),
    "x": ("MQA (1, 4, 1, 2048, 2048, 512) bf16 causal at blocks 32 x 32, "
          "local+global width 16", (1, 4, 1, 2048, 2048, 512), BF16, True,
          (32, 32), local_global(64, 64, 16), False),
    "xf": ("MQA (1, 4, 1, 2048, 2048, 512) fp32 causal at blocks 32 x 32, "
           "local+global width 16", (1, 4, 1, 2048, 2048, 512), FP32, True,
           (32, 32), local_global(64, 64, 16), False),
    "y": ("(1, 2, 1, 1024, 1024, 1024) bf16 causal, local+global on 8 x 8 "
          "tiles of 128", (1, 2, 1, 1024, 1024, 1024), BF16, True,
          (128, 128), local_global(8, 8), False),
    "yf": ("(1, 2, 1, 1024, 1024, 1024) fp32 causal, local+global on 8 x 8 "
           "tiles of 128", (1, 2, 1, 1024, 1024, 1024), FP32, True,
           (128, 128), local_global(8, 8), False),
}
SPARSE_WIDE = ("v", "vf", "w", "wf", "x", "xf", "y", "yf")
# the cases whose kernels are named by the profiler (sa.route_kernels)
SPARSE_NAMED = ("c", "i", "j", "k", "l", "m", "n", "o", "q", "s", "t", "u",
                *SPARSE_WIDE)
# the route each case must take (sa._route): the other routes' counts stay 0
SPARSE_ROUTE_NAMES = {"tc": "tensor cores (wgmma + TMA)",
                      "mma": "mma kernels (mma.sync, 16-row slices)",
                      "wide": "wide kernels (mma.sync, head dim in segments "
                              "and column chunks)"}


# The sparse routes' kernels in a profile: the three of each route, the
# fp32 wide route's split of the backward's B operands and sum of its dK/dV
# partials, and the mma route's sum of its dK/dV chunks
# (sparse_bwd_sum_mma_kernel; sa.route_kernels).
SPARSE_KERNEL_NAME = r"sparse_\w+_kernel|tf32_split_kernel|kv_sum_kernel"


def kv_splits_of(dtype, d, spec, b, h, h_kv, n_q, n_k):
    """The dK/dV CTAs that share one KV block's walk for a call of these
    widths on this card, as the wrapper takes them: the query-head splits
    of the fp32 wide backward (``fa._kv_splits``), the chunks of the mma
    route (``sa._mma_chunks``)."""
    if sa._route(dtype, d, spec) in ("mma", "wide"):
        return sa._mma_chunks(h, h_kv, n_q, spec.block_q,
                              b * h_kv * n_k * d)[1]
    return fa._kv_splits(b * h_kv, n_k, h // h_kv,
                         torch.cuda.get_device_properties(
                             0).multi_processor_count)


def sparse_launch(q, k, v, o, lse, do, dlse, active, spec, route):
    """(forward, backward) callables that launch one route's entry points
    (``route`` as ``sa._route`` names it: the dtype's tensor-core kernels,
    ``fat_sparse_*_sm90[_f32]``, the mma kernels' ``fat_sparse_*_mma``, the
    wide kernels' ``fat_sparse_*_wide`` or the FMA kernels'
    ``fat_sparse_*``) with the lists and di built once beforehand: the
    kernels' own time, without the wrapper's list building. The forward
    returns (o, lse), the backward [dq, dk, dv]."""
    fwd_fn = sa.kernel_fn("fwd", q.dtype, route)
    bwd_fn = sa.kernel_fn("bwd", q.dtype, route)
    o_out, lse_out = torch.empty_like(o), torch.empty_like(lse)
    grads = [torch.empty_like(x) for x in (q, k, v)]
    di = (o.float() * do.float()).sum(-1)
    if dlse is not None:
        di = di - dlse
    kv_list, kv_count = sa.compact_rows(active)
    q_list, q_count = sa.compact_rows(active.t())
    code = fa._DTYPE_CODE[q.dtype]
    stream = torch.cuda.current_stream().cuda_stream
    # the fp32 tensor-core and the mma backward's scratch and query-head
    # splits, held by the closures below
    scratch, more = sa._bwd_scratch(route, q, k, spec)

    def run_fwd():
        _build.check(fwd_fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o_out.data_ptr(),
            lse_out.data_ptr(), kv_list.data_ptr(), kv_count.data_ptr(),
            *sa._shape_args(q, k, spec), kv_list.shape[1], code, stream),
            "sparse fwd")
        return o_out, lse_out

    def run_bwd():
        _build.check(bwd_fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), *(g.data_ptr() for g in grads),
            kv_list.data_ptr(), kv_count.data_ptr(), q_list.data_ptr(),
            q_count.data_ptr(), *sa._shape_args(q, k, spec),
            kv_list.shape[1], q_list.shape[1], code, stream, *more),
            "sparse bwd")
        return grads
    run_bwd.scratch = scratch
    return run_fwd, run_bwd


def sparse_kernel_ms(fwd, bwd, calls=10) -> dict[str, float]:
    """{sparse kernel: mean device ms a call} over ``calls`` forward and
    backward calls under torch.profiler (after one of each to warm up), as
    scripts/flash_kernel_split.py does for the flash kernels."""
    from torch.profiler import ProfilerActivity, profile

    fwd()
    bwd()
    torch.cuda.synchronize()
    # CUPTI hands the last records of a profile late into the next one: a
    # throwaway profile takes those of an earlier case
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fwd()
            bwd()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        name = re.search(SPARSE_KERNEL_NAME, e.key)
        if name:
            total = (e.device_time_total if hasattr(e, "device_time_total")
                     else e.cuda_time_total)  # µs over the calls
            out[name.group(0)] = total / e.count / 1e3
    return out


def sparse_case(timer, gen, dev, key):
    """The sparse forward and backward kernels against their plain versions
    (o and gradients at the flash limit; LSE at 1e-4 where a row sees a
    key, -inf exactly on empty q blocks, the mask value exactly on rows of
    visited blocks that see no key; dK = dV = 0 exactly on KV blocks no q
    block visits), each launched once on the route it must take (checked
    by the route counters), their times (also issued from the host, and of
    the kernels alone and the FMA kernels on the same inputs, each first
    held against the plain version likewise), the bound of the
    pairs the pattern keeps, and SDPA with the expanded boolean mask."""
    label, shape, dtype, causal, (bq, bk), pattern, use_dlse = SPARSE_CASES[key]
    q, k, v, do, dlse, _ = _flash_inputs(gen, dev, shape, dtype,
                                         ("dlse",) if use_dlse else ())
    spec = sa.SparseSpec(causal=causal, scale=shape[-1] ** -0.5, block_q=bq,
                         block_k=bk)
    n_q, n_k = shape[3], shape[4]
    active = sa.tile_pattern(pattern.to(dev), *pattern.shape, bq, bk, causal,
                             n_k - n_q)
    route_key = sa._route(dtype, shape[-1], spec)
    tc = route_key == "tc"
    reset_counts()
    o, lse = sa.sparse_fwd(q, k, v, active, spec)
    torch.cuda.synchronize()
    o_ref, lse_ref = sa.sparse_fwd_plain(q, k, v, active, spec)
    empty = torch.isneginf(lse_ref)
    seen = lse_ref > -1e30
    unvisited = (~active.any(0)).repeat_interleave(bk)[:n_k]

    def plain_bwd():
        di = (o_ref.float() * do.float()).sum(-1)
        if dlse is not None:
            di = di - dlse
        return sa.sparse_bwd_plain(q, k, v, do, lse_ref, di, active, spec)

    refs = dict(zip(("dq", "dk", "dv"), plain_bwd()))
    tols = {"o": kernel_tol(dtype, o_ref),
            **{n: kernel_tol(dtype, r) for n, r in refs.items()}}

    def hold(tag, o_out, lse_out, grads_out):
        """{output: max |kernel - plain|} of one forward's (o, lse) and one
        backward's gradients at the case's limits; fails on a miss."""
        err = {"o": check_close(f"{tag}sparse_fwd {key} o", o_out, o_ref,
                                *tols["o"])}
        if not torch.equal(torch.isneginf(lse_out), empty):
            fail(f"{tag}sparse_fwd {key}: -inf LSE rows differ from the plain "
                 "version's")
        if not torch.equal(lse_out[~seen & ~empty], lse_ref[~seen & ~empty]):
            fail(f"{tag}sparse_fwd {key}: rows that see no key differ in LSE")
        err["lse"] = check_close(f"{tag}sparse_fwd {key} lse", lse_out[seen],
                                 lse_ref[seen], LSE_TOL)
        for (name, r), g in zip(refs.items(), grads_out):
            err[name] = check_close(f"{tag}sparse_bwd {key} {name}", g, r,
                                    *tols[name])
        if any(bool(g[:, :, unvisited].any()) for g in grads_out[1:]):
            fail(f"{tag}sparse_bwd {key}: dK or dV is nonzero on an unvisited "
                 "KV block")
        return err

    grads = sa.sparse_bwd(q, k, v, o_ref, lse_ref, do, dlse, active, spec)
    torch.cuda.synchronize()
    c = read_counts()
    mma, wide = route_key == "mma", route_key == "wide"
    if (c["sparse_fwd"], c["sparse_bwd"], c["sparse_fwd_tc"],
            c["sparse_bwd_tc"], c["sparse_fwd_mma"], c["sparse_bwd_mma"],
            c["sparse_fwd_wide"], c["sparse_bwd_wide"]) != (
                1, 1, int(tc), int(tc), int(mma), int(mma), int(wide),
                int(wide)):
        fail(f"sparse {key}: launches {c}; want the "
             f"{SPARSE_ROUTE_NAMES[route_key]} route once each way")
    route = SPARSE_ROUTE_NAMES[route_key]
    err = hold("", o, lse, grads)
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
    # the kernels alone (lists and di built beforehand), and the FMA kernels
    # (on no route; D <= 256) on the same inputs, each held against the
    # plain version at the case's limits before it is timed
    for which in ("kernel",) if wide else ("kernel", "fma"):
        run_fwd, run_bwd = sparse_launch(
            q, k, v, o_ref, lse_ref, do, dlse, active, spec,
            route_key if which == "kernel" else "fma")
        out = [*run_fwd(), run_bwd()]
        torch.cuda.synchronize()
        t[f"{which}_max_abs_err"] = hold(
            "kernels alone: " if which == "kernel" else "FMA kernels: ", *out)
        del out
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
    t["library_backend"] = sdpa_backend(
        lambda: sdpa(q, k, v, attn_mask=vis, scale=spec.scale,
                     enable_gqa=gqa)) if wide else None
    del o_lib, leaves
    pairs = int(vis.sum()) * shape[0] * shape[1]
    # the route's rate: bf16 or 3xTF32 (wgmma or mma.sync); for fp32 the
    # FMA kernels' bound at 67 TFLOP/s beside it
    bounds = attention_bounds(q, k, pairs, dlse, flash_peak(dtype))
    if dtype == torch.float32 and not wide:
        fma_bounds = attention_bounds(q, k, pairs, dlse, FP32_FLOPS_PER_S)
        t["fwd_fma_bound_ms"] = fma_bounds["fwd"][0]
        t["bwd_fma_bound_ms"] = fma_bounds["bwd"][0]
    if key in SPARSE_NAMED:
        t["kernel_split_ms"] = split = sparse_kernel_ms(
            lambda: sa.sparse_fwd(q, k, v, active, spec),
            lambda: sa.sparse_bwd(q, k, v, o_ref, lse_ref, do, dlse, active,
                                  spec))
        want = sa.route_kernels(dtype, shape[-1], spec,
                                kv_splits_of(dtype, shape[-1], spec,
                                             *shape[:5]))
        if split and set(split) != want:
            fail(f"sparse {key}: the profiler saw {sorted(split)}; want "
                 f"{sorted(want)}")
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
    fma = "" if wide else (
        f"; FMA kernels fwd {t['fwd_fma_ms']:.4f} bwd {t['bwd_fma_ms']:.4f}"
        " (max_abs_err " + " ".join(
            f"{n} {e:.2e}" for n, e in t["fma_max_abs_err"].items()) + ")")
    if "fwd_fma_bound_ms" in t:
        fma += (f" (their bound at {FP32_FLOPS_PER_S / 1e12:g} TFLOP/s: fwd "
                f"{t['fwd_fma_bound_ms']:.4f} bwd {t['bwd_fma_bound_ms']:.4f})")
    log(f"[kernel]   kernels alone: fwd {t['fwd_kernel_ms']:.4f} bwd "
        f"{t['bwd_kernel_ms']:.4f} ms" + fma)
    if "kernel_split_ms" in t:
        log("[kernel]   device ms a call by kernel (torch.profiler): "
            + (", ".join(f"{n} {x:.4f}"
                         for n, x in t["kernel_split_ms"].items())
               or "not measured (no kernel recorded)"))
    log(f"[kernel]   wrapper (lists built on the device): fwd "
        f"{t['fwd_ms']:.4f} ms (issued from the host "
        f"{t['fwd_wall_ms']:.4f}, plain {t['fwd_plain_ms']:.4f}, SDPA "
        + (f"({t['library_backend']}) " if wide else "")
        + f"{lib['fwd']:.4f}, bound {bounds['fwd'][0]:.4f} "
        f"{bounds['fwd'][1]})  "
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
    "h": ("(1, 8, 8192, 256) int8 causal, auto (fused)",
          (1, 8, 8, 8192, 256), dict(causal=True, fmt="int8"), ()),
    "i": ("Gemma 2B's MQA (1, 8/1, 4096, 256) e4m3 causal, mode fused",
          (1, 8, 1, 4096, 256), dict(causal=True, mode="fused"), ()),
    "j": ("(1, 8, 8192, 256) e5m2 causal, mode fused", (1, 8, 8, 8192, 256),
          dict(causal=True, mode="fused", fmt="e5m2"), ()),
    # int8_pv "s8" at rows 6b's and 6w's shapes (phase 5b's s8 arm is (k)'s
    # call), and Phi-2's head dim 80 (microsoft/phi-2: hidden 2560, 32
    # heads), which is no multiple of 32
    "k": ("int8 PV s8, (1, 8, 8192, 128) causal", (1, 8, 8, 8192, 128),
          dict(causal=True, fmt="int8", int8_pv="s8"), ()),
    "l": ("int8 PV s8, (1, 8, 8192, 256) causal", (1, 8, 8, 8192, 256),
          dict(causal=True, fmt="int8", int8_pv="s8"), ()),
    "m": ("Phi-2 (1, 32, 2048, 80) int8 causal, auto (fused)",
          (1, 32, 32, 2048, 80), dict(causal=True, fmt="int8"), ()),
    "n": ("Phi-2 (1, 32, 2048, 80) e4m3 causal, mode fused",
          (1, 32, 32, 2048, 80), dict(causal=True, mode="fused"), ()),
    # (m) at D = 96, the next multiple of 32 (the same DP = 128 kernels)
    "o": ("Phi-2's call at D = 96, (1, 32, 2048, 96) int8 causal, auto",
          (1, 32, 32, 2048, 96), dict(causal=True, fmt="int8"), ()),
    # above head dim 256, on the wide kernels: phase 5bx's call in int8, s8,
    # e4m3 and e5m2 (p-s), int8 at D = 264 (padded to 272) and at D = 1024
    # (t, u), and int8 at D = 512 with GQA, window, sinks, soft-cap and
    # dropout (v)
    "p": ("phase 5bx's call (1, 4, 2048, 512) int8 causal, auto (fused)",
          (1, 4, 4, 2048, 512), dict(causal=True, fmt="int8"), ()),
    "q": ("int8 PV s8, (1, 4, 2048, 512) causal", (1, 4, 4, 2048, 512),
          dict(causal=True, fmt="int8", int8_pv="s8"), ()),
    "r": ("(1, 4, 2048, 512) e4m3 causal, mode fused", (1, 4, 4, 2048, 512),
          dict(causal=True, mode="fused"), ()),
    "s": ("(1, 4, 2048, 512) e5m2 causal, mode fused", (1, 4, 4, 2048, 512),
          dict(causal=True, mode="fused", fmt="e5m2"), ()),
    "t": ("(1, 4, 2048, 264) int8 causal, auto (fused; padded to 272)",
          (1, 4, 4, 2048, 264), dict(causal=True, fmt="int8"), ()),
    "u": ("(1, 2, 1024, 1024) int8 causal, auto (fused)",
          (1, 2, 2, 1024, 1024), dict(causal=True, fmt="int8"), ()),
    "v": ("GQA 8/2 window 256 sinks 4 softcap 30 dropout 0.1, "
          "(1, 8, 1024, 512) int8", (1, 8, 2, 1024, 512),
          dict(causal=True, fmt="int8", window=256, sinks=4, softcap=30.0,
               dropout_rate=0.1, dropout_seed=91), ()),
    # key blocks of 48 (fp8_attention_prequant's scales may have any): a
    # 32-key tile spans two blocks, int8 and e4m3
    "w": ("key blocks of 48, (1, 4, 1536, 512) int8 causal",
          (1, 4, 4, 1536, 512), dict(causal=True, fmt="int8", block_k=48),
          ()),
    "x": ("key blocks of 48, (1, 4, 1536, 512) e4m3 causal, mode fused",
          (1, 4, 4, 1536, 512), dict(causal=True, mode="fused", block_k=48),
          ()),
}
FP8_WIDE = tuple("pqrstuvwx")
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
    block_k = kw.pop("block_k", None)  # the kernel call's own key blocks
    # the public call: it must launch the 8-bit kernel once
    reset_counts()
    o_api, _ = f8.fp8_attention(q, k, v, fmt=fmt, int8_pv=int8_pv, mode=mode,
                                **kw, **more)
    torch.cuda.synchronize()
    want_tc = int(f8._tensor_core_route(d, f8.FP8_KERNEL_BLOCK_K))
    want_wide = int(f8._wide_route(d))
    c = read_counts()
    if (c["flash_fwd_fp8"], c["flash_fwd_fp8_tc"],
            c["flash_fwd_fp8_wide"]) != (1, want_tc, want_wide):
        fail(f"fp8 {key}: fp8_attention launched flash_fwd_fp8 "
             f"{c['flash_fwd_fp8']} times, {c['flash_fwd_fp8_tc']} on the "
             f"tensor cores, {c['flash_fwd_fp8_wide']} on the wide kernels; "
             f"want 1, {want_tc}, {want_wide}")
    del o_api
    opts = fa.make_opts(q, k, **kw, **more)
    if block_k is None:
        q8, k8, v8, sq, sk, sv, bq, bk = f8.quantize_inputs(
            q, k, v, f8.FP8_KERNEL_BLOCK_Q, f8.FP8_KERNEL_BLOCK_K, fmt)
    else:  # payloads quantized beforehand, as fp8_attention_prequant's
        bq, bk = f8.FP8_KERNEL_BLOCK_Q, block_k
        (q8, sq), (k8, sk), (v8, sv) = (quantize_blocks(x, blk, fmt) for x, blk
                                        in ((q, bq), (k, bk), (v, bk)))
    args = (q8, k8, v8, sq, sk, sv, bq, bk, opts)
    o, lse = f8.fp8_fwd(*args, int8_pv=int8_pv, out_dtype=BF16)
    torch.cuda.synchronize()
    o_ref, lse_ref = f8.fp8_fwd_plain(*args, int8_pv=int8_pv, out_dtype=BF16)
    tol = kernel_tol(BF16, o_ref)
    err = {"o": check_close(f"fp8 {key} o", o, o_ref, *tol)}
    err["lse"] = check_close(f"fp8 {key} lse", lse, lse_ref, LSE_TOL)
    del o, lse
    big = n > 4096
    fma_ms = fma_err = None
    if want_tc:  # the FMA kernel on the same inputs, through the wrapper:
        # held against the plain version at the case's limits, then timed
        with mock.patch.object(f8, "_tensor_core_route", lambda *a_: False):
            fma = lambda: f8.fp8_fwd(*args, int8_pv=int8_pv, out_dtype=BF16)
            fo, fl = fma()
            torch.cuda.synchronize()
            fma_err = {
                "o": check_close(f"fp8 {key} o (FMA kernel)", fo, o_ref, *tol),
                "lse": check_close(f"fp8 {key} lse (FMA kernel)", fl,
                                   lse_ref, LSE_TOL)}
            del fo, fl
            fma_ms = timer(fma, reps=3 if big else 10, warmup=1)
    del o_ref, lse_ref
    ms = timer(lambda: f8.fp8_fwd(*args, int8_pv=int8_pv, out_dtype=BF16))
    plain_ms = timer(lambda: f8.fp8_fwd_plain(*args, int8_pv=int8_pv,
                                              out_dtype=BF16),
                     reps=3 if big else 10, warmup=1)
    # yardstick: SDPA on the dequantized inputs (another function)
    qd, kd, vd = (f8.dequantize_bf16(x, sc, blk) for x, sc, blk in
                  ((q8, sq, bq), (k8, sk, bk), (v8, sv, bk)))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    yard = lambda: sdpa(qd, kd, vd, is_causal=True, scale=opts.scale,
                        enable_gqa=h != h_kv)
    yardstick_ms = timer(yard)
    bound_ms, bound_by = fp8_bound(q8, k8, opts, bq, bk, 2, int8_pv)
    route = ("wide kernels (mma.sync)" if want_wide
             else "tensor cores" if want_tc else "FMA")
    rec = dict(case=label, shape=shape, fmt=fmt, int8_pv=int8_pv,
               blocks=(bq, bk), max_abs_err=err,
               tol=dict(o=dict(rtol=tol[0], atol=tol[1]), lse=LSE_TOL),
               route=route, ms=ms,
               yardstick_backend=sdpa_backend(yard) if want_wide else None,
               fma_ms=fma_ms, fma_max_abs_err=fma_err, plain_ms=plain_ms,
               library_ms=None,
               yardstick_ms=yardstick_ms, bound_ms=bound_ms,
               bound_by=bound_by, api_launches=1)
    log(f"[kernel] flash_fwd_fp8 {key} ({label}): {rec['route']}, "
        f"max_abs_err o "
        f"{err['o']:.2e} lse {err['lse']:.2e} ({tol_text(BF16)}: p is bf16; "
        f"lse {LSE_TOL:g})  kernel {ms:.4f} ms ("
        + ("" if fma_ms is None else
           f"FMA kernel {fma_ms:.4f} (max_abs_err o {fma_err['o']:.2e} lse "
           f"{fma_err['lse']:.2e}), ")
        + f"plain {plain_ms:.4f}, SDPA on the dequantized inputs "
        + (f"({rec['yardstick_backend']}) " if want_wide else "")
        + f"{yardstick_ms:.4f}, bound {bound_ms:.4f} "
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


def paged_cases(gen):
    """Phase 2's paged-attention cases at D <= 128 (PERF.md rows 7-8):
    {key: (name, dtype, attention_case keywords)}: the GPT-3 Small
    engine's decode, chunk, page-24, GQA, fp32 and speculative verify
    calls, the quantized decode formats and int8 schedules, an e4m3 chunk
    and scripts/bench_decode.py's shape. ``gen`` draws the verify lengths.
    scripts/paged_ab.py times the same table for an A/B of two trees."""
    bf = torch.bfloat16
    gpt3 = dict(h=12, h_kv=12, d=64, max_len=512)
    cases = {
        "decode": ("decode B=32 page=16", bf, dict(b=32, page=16, q_len=0,
                                                    **gpt3)),
        "chunk": ("chunk B=1 T=64 page=16", bf, dict(
            b=1, page=16, q_len=64, lengths=[448], **gpt3)),
        "page24": ("decode B=32 page=24", bf, dict(b=32, page=24, q_len=0,
                                                    **gpt3)),
        "gqa": ("GQA 12/4 window=128 sinks=4 softcap=30 B=32", bf, dict(
            b=32, h=12, h_kv=4, d=64, page=16, max_len=512, q_len=0,
            window=128, sinks=4, softcap=30.0)),
        "fp32": ("decode fp32 B=8 page=16", torch.float32, dict(
            b=8, page=16, q_len=0, **gpt3)),
    }
    # B5/B6 at the speculative engine's verify chunk (phase 8): B=32 slots
    # of T = gamma + 1 = 5 rows, each slot at its own length
    for key, quant in (("", None), ("_fp8", "fp8")):
        cases[f"verify{key}"] = (
            f"verify B=32 T=5 page=16 lengths 33-505 + one at capacity"
            f"{' fp8' if quant else ''}", bf, dict(
                b=32, page=16, q_len=5, quant=quant,
                lengths=(verify_lengths(gen) + 5).tolist(), **gpt3))
    # Quantized pages: the engine's decode shape in every format and the
    # int8 schedules, e4m3 and int8 "full" chunks (phase 3b's calls), and
    # scripts/bench_decode.py's shape.
    for key, quant, int8_qk in (("int8_qk", "int8", None),
                                ("int8_convert", "int8", False),
                                ("int8_full", "int8", "full"),
                                ("fp8", "fp8", None), ("e5m2", "e5m2", None)):
        cases[f"decode_{key}"] = (f"decode B=32 page=16 {key}", bf, dict(
            b=32, page=16, q_len=0, quant=quant, int8_qk=int8_qk, **gpt3))
    for key, quant, int8_qk in (("fp8", "fp8", None),
                                ("int8_full", "int8", "full")):
        cases[f"chunk_{key}"] = (f"chunk B=1 T=64 page=16 {key}", bf, dict(
            b=1, page=16, q_len=64, lengths=[448], quant=quant,
            int8_qk=int8_qk, **gpt3))
    bench = dict(b=64, h=8, h_kv=8, d=128, page=64, max_len=2048, q_len=0,
                 lengths=[2048] * 64)
    for quant in (None, "int8", "fp8"):
        cases[f"bench_decode_{quant or 'bf16'}"] = (
            f"bench_decode B=64 H=8 D=128 len 2048 page 64 {quant or 'bf16'}",
            bf, dict(quant=quant, **bench))
    return cases


# The int8 "full" cases: bf16 q takes the split route's tensor-core walk
FULL_CASES = ("decode_int8_full", "chunk_int8_full", "d256_decode_int8_full")


def phase_kernels(dev):
    gen = torch.Generator().manual_seed(SEED)
    timer = Timer(dev)
    recs = {key: attention_case(timer, gen, dev, name, dtype, **kw)
            for key, (name, dtype, kw) in paged_cases(gen).items()}
    # B7 at the engine's decode step, at a prefill chunk and at the verify
    # chunk, every format (the verify chunk: bf16 and e4m3)
    for fmt in APPEND_FORMATS:
        for kind in ("decode", "chunk"):
            recs[f"append_{fmt}_{kind}"] = append_case(timer, gen, dev, fmt,
                                                       kind)
    for fmt in ("bf16", "fp8"):
        recs[f"append_{fmt}_verify"] = append_case(timer, gen, dev, fmt,
                                                   "verify")
    recs.update(paged_d256_cases(timer, gen, dev))
    recs.update(paged_wide_cases(timer, gen, dev))
    for key in FULL_CASES:
        if recs[key]["route"] != "split" or recs[key]["walk"] != "tc":
            fail(f"paged_attention {key}: took the {recs[key]['route']} "
                 f"route ({recs[key]['walk']} walk), want the split route's "
                 f"tensor-core walk")
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


def gemma_decode_lengths(gen, b=32):
    """Phase 2's decode lengths at Gemma 2B's attention widths: drawn from
    [256, 4096], the first two at the range's ends."""
    lengths = torch.randint(256, 4097, (b,), generator=gen)
    lengths[:2] = torch.tensor([256, 4096])
    return lengths.tolist()


def paged_d256_table(gen):
    """Phase 2's paged-attention cases at head dim 256 (Gemma 2B's MQA, 8
    query heads over 1 KV head; phase 3c's calls; PERF.md rows 7w-8w), as
    ``paged_cases`` gives them: the decode step (B = 32, page 16, lengths
    256-4096) over bf16, int8 ("qk"), e4m3 pages and int8 "full" (row
    8w's call), fp32 decode (B = 8), a T = 64 chunk at length 2048 and the
    verify chunk (B = 32, T = 5). SDPA reads the one KV head itself
    (``enable_gqa``)."""
    bf = torch.bfloat16
    gemma = dict(h=8, h_kv=1, d=256, page=16, max_len=4096, gqa=True)
    cases = {}
    for key, quant, int8_qk in (("d256_decode", None, None),
                                ("d256_decode_int8_qk", "int8", None),
                                ("d256_decode_fp8", "fp8", None),
                                ("d256_decode_int8_full", "int8", "full")):
        cases[key] = (f"{key} B=32 H=8/1 D=256 page=16 lengths 256-4096", bf,
                      dict(b=32, q_len=0, quant=quant, int8_qk=int8_qk,
                           lengths=gemma_decode_lengths(gen), **gemma))
    cases["d256_decode_fp32"] = (
        "d256_decode_fp32 B=8 H=8/1 D=256 page=16 lengths 256-4096",
        torch.float32, dict(b=8, q_len=0, lengths=gemma_decode_lengths(gen, 8),
                            **gemma))
    cases["d256_chunk"] = ("d256_chunk B=1 T=64 H=8/1 D=256 page=16 length "
                           "2048", bf, dict(b=1, q_len=64, lengths=[2048],
                                            **gemma))
    cases["d256_verify"] = (
        "d256_verify B=32 T=5 H=8/1 D=256 page=16 lengths 256-4096", bf,
        dict(b=32, q_len=5, lengths=[n + 5 for n in gemma_decode_lengths(gen)],
             **gemma))
    return cases


def paged_d256_cases(timer, gen, dev):
    """B5/B6 and B7 at head dim 256: ``paged_d256_table``'s cases, the
    split route's on its tensor-core walk (int8 "full" too, checked by
    phase_kernels), fp32 decode on the first kernel (its D = 256
    instantiation, each walk cut into splits), each route and walk
    checked; the append at the decode step and a T = 64 chunk. bf16 is
    held to ``paged_tol``'s limit scaled to max|plain|."""
    recs = {}
    for key, (name, dtype, kw) in paged_d256_table(gen).items():
        recs[key] = attention_case(timer, gen, dev, name, dtype, **kw)
        torch.cuda.empty_cache()
    for kind in ("decode", "chunk"):
        recs[f"append_bf16_{kind}_d256"] = append_case(
            timer, gen, dev, "bf16", kind, h=1, d=256, max_len=4096)
    torch.cuda.empty_cache()
    if recs["d256_decode_fp32"]["route"] != "first":
        fail("paged_attention d256_decode_fp32: took the split route, want "
             "the first kernel")
    for key in ("d256_decode", "d256_decode_int8_qk", "d256_decode_fp8",
                "d256_chunk", "d256_verify"):
        if recs[key]["route"] != "split" or recs[key]["walk"] != "tc":
            fail(f"paged_attention {key}: took the {recs[key]['route']} "
                 f"route ({recs[key]['walk']} walk), want the split route's "
                 f"tensor-core walk")
    return recs


def paged_wide_table(gen):
    """Phase 2's paged-attention cases above head dim 256, as
    ``paged_d256_table`` gives them: phase 3d's calls at D = 512 (4 query
    heads over 1 KV head: the decode step, B = 32, page 16, lengths
    256-4096, over bf16, int8 ("qk", "convert" and "full"), e4m3 and e5m2
    pages; fp32 decode at B = 8 on the first kernel's chunked
    instantiation; a T = 64 chunk at length 2048 and the verify chunk, B =
    32, T = 5, over bf16, int8 (a chunk's default "convert", "qk" and
    "full"), e4m3 and e5m2 pages: two row tiles a CTA), then bf16 decode at
    D = 264 (GQA 8/2: a last output chunk of 8 columns), 384 and 1024 (4
    output chunks), B = 8."""
    bf = torch.bfloat16
    wide = dict(h=4, h_kv=1, d=512, page=16, max_len=4096, gqa=True)
    formats = (("", None, None), ("_int8_convert", "int8", False),
               ("_int8_qk", "int8", "qk"), ("_int8_full", "int8", "full"),
               ("_fp8", "fp8", None), ("_e5m2", "e5m2", None))
    cases = {}
    for tag, quant, int8_qk in formats:
        key = f"d512_decode{tag}"
        cases[key] = (f"{key} B=32 H=4/1 D=512 page=16 lengths 256-4096", bf,
                      dict(b=32, q_len=0, quant=quant, int8_qk=int8_qk,
                           lengths=gemma_decode_lengths(gen), **wide))
    cases["d512_decode_fp32"] = (
        "d512_decode_fp32 B=8 H=4/1 D=512 page=16 lengths 256-4096",
        torch.float32, dict(b=8, q_len=0, lengths=gemma_decode_lengths(gen, 8),
                            **wide))
    for tag, quant, int8_qk in formats:
        cases[f"d512_chunk{tag}"] = (
            f"d512_chunk{tag} B=1 T=64 H=4/1 D=512 page=16 length 2048", bf,
            dict(b=1, q_len=64, lengths=[2048], quant=quant, int8_qk=int8_qk,
                 **wide))
    for tag, quant, int8_qk in formats:
        cases[f"d512_verify{tag}"] = (
            f"d512_verify{tag} B=32 T=5 H=4/1 D=512 page=16 lengths "
            f"256-4096", bf,
            dict(b=32, q_len=5, quant=quant, int8_qk=int8_qk,
                 lengths=[n + 5 for n in gemma_decode_lengths(gen)], **wide))
    for d, h, h_kv in ((264, 8, 2), (384, 4, 1), (1024, 2, 1)):
        cases[f"d{d}_decode"] = (
            f"d{d}_decode B=8 H={h}/{h_kv} D={d} page=16 lengths 256-4096", bf,
            dict(b=8, q_len=0, lengths=gemma_decode_lengths(gen, 8), h=h,
                 h_kv=h_kv, d=d, page=16, max_len=4096, gqa=True))
    # above 1024 the scores are summed over passes of 1024 columns: bf16
    # pages of 16 at D = 1032 and int8 ("qk") pages of 16 at D = 2048 take
    # the first kernel (PAGED_FIRST_WIDE), bf16 and e4m3 pages of 8 the
    # tensor-core walk
    for key, d, page, quant in (("d1032_decode", 1032, 16, None),
                                ("d2048_decode_int8", 2048, 16, "int8"),
                                ("d2048_decode_p8", 2048, 8, None),
                                ("d1032_decode_fp8_p8", 1032, 8, "fp8")):
        cases[key] = (
            f"{key} B=8 H=2/1 D={d} page={page} lengths 256-4096", bf,
            dict(b=8, q_len=0, lengths=gemma_decode_lengths(gen, 8), h=2,
                 h_kv=1, d=d, page=page, max_len=4096, gqa=True, quant=quant))
    return cases


# paged_wide_table's cases that take the first kernel's chunked
# instantiation: fp32 q, and rings past the split route's budget
PAGED_FIRST_WIDE = ("d512_decode_fp32", "d1032_decode", "d2048_decode_int8")


def paged_wide_cases(timer, gen, dev):
    """B5/B6 and B7 above head dim 256: ``paged_wide_table``'s cases, every
    bf16-q case on the split route's tensor-core walk (each page format
    and int8 schedule, one and two row tiles), fp32 decode on the first
    kernel (its chunked instantiation), each route and walk checked; the
    split route's cases also time the first kernel on their inputs
    (``attention_case``). The append in every page format at phase 3d's
    decode step (D = 512, one KV head) and at a T = 64 chunk, and bf16
    decode at D = 264, 384 and 1024."""
    recs = {}
    for key, (name, dtype, kw) in paged_wide_table(gen).items():
        recs[key] = attention_case(timer, gen, dev, name, dtype, **kw)
        torch.cuda.empty_cache()
    for fmt in APPEND_FORMATS:
        for kind in ("decode", "chunk"):
            recs[f"append_{fmt}_{kind}_d512"] = append_case(
                timer, gen, dev, fmt, kind, h=1, d=512, max_len=4096)
    for d in (264, 384, 1024):
        recs[f"append_bf16_decode_d{d}"] = append_case(
            timer, gen, dev, "bf16", "decode", h=1, d=d, max_len=4096)
    torch.cuda.empty_cache()
    for key, rec in recs.items():
        if not key.startswith("d") or key in PAGED_FIRST_WIDE:
            continue
        if rec["route"] != "split" or rec["walk"] != "tc":
            fail(f"paged_attention {key}: took the {rec['route']} route "
                 f"({rec['walk']} walk), want the split route's tensor-core "
                 f"walk")
    for key in PAGED_FIRST_WIDE:
        if recs[key]["route"] != "first":
            fail(f"paged_attention {key}: took the split route, want the "
                 f"first kernel")
    return recs


# ---------------------------------------------------------------------------
# Phases 3-4: the engine
# ---------------------------------------------------------------------------


def reset_counts():
    pa.paged_attention.launches = 0
    pa.paged_attention.split_launches = 0
    pa.paged_attention.tc_launches = 0
    pa.paged_attention.chunk_launches = 0
    f8.fp8_attention.tc_launches = 0
    f8.fp8_attention.wide_launches = 0
    pap.paged_append.launches = 0
    pap.paged_append.chunk_launches = 0
    fa.kernel_attention.fwd_launches = 0
    fa.kernel_attention.bwd_launches = 0
    f8.fp8_attention.launches = 0
    sa.sparse_attention.fwd_launches = 0
    sa.sparse_attention.bwd_launches = 0
    sa.sparse_attention.fwd_tc_launches = 0
    sa.sparse_attention.bwd_tc_launches = 0
    sa.sparse_attention.fwd_mma_launches = 0
    sa.sparse_attention.bwd_mma_launches = 0
    sa.sparse_attention.fwd_wide_launches = 0
    sa.sparse_attention.bwd_wide_launches = 0


def read_counts():
    return {"paged_attention": pa.paged_attention.launches,
            "paged_attention_split": pa.paged_attention.split_launches,
            "paged_attention_tc": pa.paged_attention.tc_launches,
            "paged_attention_chunk": pa.paged_attention.chunk_launches,
            "flash_fwd_fp8_tc": f8.fp8_attention.tc_launches,
            "flash_fwd_fp8_wide": f8.fp8_attention.wide_launches,
            "paged_append": pap.paged_append.launches,
            "paged_append_chunk": pap.paged_append.chunk_launches,
            "flash_fwd": fa.kernel_attention.fwd_launches,
            "flash_bwd": fa.kernel_attention.bwd_launches,
            "flash_fwd_fp8": f8.fp8_attention.launches,
            "sparse_fwd": sa.sparse_attention.fwd_launches,
            "sparse_bwd": sa.sparse_attention.bwd_launches,
            "sparse_fwd_tc": sa.sparse_attention.fwd_tc_launches,
            "sparse_bwd_tc": sa.sparse_attention.bwd_tc_launches,
            "sparse_fwd_mma": sa.sparse_attention.fwd_mma_launches,
            "sparse_bwd_mma": sa.sparse_attention.bwd_mma_launches,
            "sparse_fwd_wide": sa.sparse_attention.fwd_wide_launches,
            "sparse_bwd_wide": sa.sparse_attention.bwd_wide_launches}


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
        # the walk of each kind's calls: G rows at decode, G * T a chunk;
        # the int8 "full" schedule's on the tensor cores at every row count
        g = cfg.n_heads // cfg.kv_heads
        mode = ("full" if ecfg.quant == "int8" and ecfg.int8_qk == "full"
                else "convert")
        want_tc = n_layers * (
            st["decode_steps"] * (pa.split_walk(cfg.d_head, g, mode) == "tc")
            + st["prefill_chunks"] * (pa.split_walk(
                cfg.d_head, g * ecfg.prefill_pad, mode) == "tc"))
        if counts["paged_attention_tc"] != want_tc:
            fail(f"paged_attention took the tensor-core walk "
                 f"{counts['paged_attention_tc']} times, want {want_tc}")
        want_chunk = n_layers * st["prefill_chunks"]
        for name in ("paged_attention", "paged_append"):
            if counts[f"{name}_chunk"] != want_chunk:
                fail(f"{name} launched {counts[f'{name}_chunk']} times at "
                     f"T > 1, want {n_layers} per prefill chunk = "
                     f"{want_chunk}")
        log(f"[engine] per decode step and per prefill chunk: {n_layers} "
            f"paged_attention + {n_layers} paged_append launches, every "
            f"paged_attention launch ({n_layers * st['decode_steps']} decode,"
            f" {want_chunk} chunk, counted) on the split route (checked), "
            f"{counts['paged_attention_tc']} on its tensor-core walk "
            f"(checked)")
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


PAGED_KERNEL_NAMES = ("paged_split_kernel", "paged_split_tc_kernel",
                      "paged_merge_kernel",
                      "paged_attention_kernel",
                      "paged_attention_wide_kernel")


def _window(prof, wall, n, unit, tag):
    """Per-``unit`` wall ms, kernel ms, device ops, busy share and top
    kernels of a profiled window of ``n`` units, and the paged-attention
    kernels' ms (split walk, merge, first kernel) with their share of the
    kernel time."""
    kernels = device_kernels(prof)
    busy = sum(kernels.values()) / 1e6
    paged = sum(v for k, v in kernels.items()
                if any(x in k for x in PAGED_KERNEL_NAMES)) / 1e6
    rec = dict(count=n, wall_ms=wall / n * 1e3,
               kernel_ms=busy / n * 1e3 if kernels else None,
               device_ops=device_ops(prof) / n if kernels else None,
               device_busy_share=busy / wall if kernels else None,
               paged_ms=paged / n * 1e3 if kernels else None,
               paged_share_of_kernels=paged / busy if kernels else None,
               top=sorted(((k, v / n / 1e3) for k, v in kernels.items()),
                          key=lambda kv: -kv[1])[:10])
    if not kernels:
        log(f"[profile{tag}] the profiler recorded no device time: not "
            f"measured")
        return rec
    log(f"[profile{tag}] {n} {unit}s: {rec['wall_ms']:.3f} ms/{unit} wall, "
        f"kernels {rec['kernel_ms']:.3f} ms/{unit}, {rec['device_ops']:.1f} "
        f"device ops/{unit}, device busy {100 * rec['device_busy_share']:.1f}%"
        f"; paged attention {rec['paged_ms']:.4f} ms/{unit} "
        f"({100 * rec['paged_share_of_kernels']:.1f}% of the kernels)")
    for k, v in rec["top"]:
        log(f"[profile{tag}]   {v:.4f} ms/{unit}  {k[:90]}")
    return rec


def phase_profile(cfg, params, ecfg, dev, steps=20, plen=200,
                  profile_prefill=True):
    """Where a prefill chunk's and a decode step's time goes. 32 requests
    of ``plen``-token prompts (200: 128 chunks of 64): their admission (each
    admission's first-token logits and readback included), then ``steps``
    decode-only steps at batch 32, first timed on the host clock alone,
    then on a fresh engine under torch.profiler. Per chunk and per step:
    wall ms (both), kernel ms, device ops (kernels, copies, memsets), the
    device's busy share (kernel time over the profiled wall time) and the
    top kernels. On the card, the warm-up engine (first calls: library
    handles, kernel loads) counts the host syncs per chunk and per step.
    Admission is timed apart from decoding through the engine's
    ``_admit``. ``profile_prefill=False`` leaves the admission out of the
    profiler (long prompts on a deep model give more events than its
    summary takes in a run's time); its wall time stays."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED + 2)
    plen = min(plen, ecfg.max_seq_len // 2)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, size=plen)]
               for _ in range(ecfg.max_batch_size)]
    tag = f" {ecfg.quant}" if ecfg.quant else ""
    if cfg.d_head > 128:
        tag += f" d{cfg.d_head}"

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
    if profile_prefill:
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            eng._admit()
            sync(dev)
            wall = time.perf_counter() - t0
        rec = {"prefill": _window(prof, wall, eng.stats["prefill_chunks"],
                                  "chunk", tag)}
    else:  # the admission's wall time only
        eng._admit()
        sync(dev)
        rec = {"prefill": dict(count=eng.stats["prefill_chunks"])}
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


def _first_logits(params, cfg, dev, prompt, steps, quant=None, int8_qk=None):
    """First-token logits (float32, host) and greedy tokens of a one-slot
    engine serving ``prompt``."""
    ecfg = EngineConfig(max_batch_size=1, page_size=16, num_pages=40,
                        max_seq_len=cfg.max_seq_len, prefill_pad=64,
                        quant=quant, int8_qk=int8_qk)
    eng = ServingEngine(params, cfg, ecfg, device=dev)
    eng.submit(GenerationRequest(0, prompt, steps))
    toks = eng.run()[0]
    return eng.last_prefill_logits.float().cpu(), toks


def _agreement(tc, tr):
    agree = sum(a == b for a, b in zip(tc, tr))
    prefix = next((i for i, (a, b) in enumerate(zip(tc, tr)) if a != b),
                  len(tc))
    return agree, prefix


def phase_vs_cpu(cfg, params, dev, prompt_len, steps, quant=None,
                 int8_qk=None):
    """The card engine's first-token logits against the same engine on the
    CPU in float32 (plain versions): the bf16 rung for bf16 pages, the FP8
    rung for quantized pages (``int8_qk``: the int8 schedule of both
    engines); the latter also reports, ungated, its distance to the bf16
    unquantized card engine."""
    rng = np.random.default_rng(SEED + 1)
    prompt = [int(t) for t in rng.integers(0, cfg.vocab_size, size=prompt_len)]
    tol = LOGITS_TOL if quant is None else FP8_TOL
    paged_errs = []

    def paged_checked(q, *args, **kw):
        """The card engine's paged call, held against its plain version."""
        o = pa.paged_attention(q, *args, **kw)
        ref = pa.paged_attention_plain(q, *args, **kw)
        paged_errs.append(check_close(
            f"card engine paged call {len(paged_errs)}", o, ref,
            *paged_tol(q.dtype, q.shape[-1], ref)))
        return o

    with mock.patch.object(eng_mod, "paged_attention", paged_checked):
        lc, tc = _first_logits(params, cfg, dev, prompt, steps, quant,
                               int8_qk)
    if not paged_errs:
        fail("the card engine made no paged call: nothing was checked")
    lr, tr = _first_logits(params, dataclasses.replace(cfg, dtype=torch.float32),
                           "cpu", prompt, steps, quant, int8_qk)
    err = (lc - lr).abs()
    max_err = float(err.max())
    if not torch.isfinite(lc).all():
        fail("card engine logits are not finite")
    if bool((err > tol + tol * lr.abs()).any()):
        fail(f"first-token logits ({quant or 'bf16'} pages) differ by "
             f"{max_err:.3e}, over tolerance {tol:g} (abs + rel)")
    agree, prefix = _agreement(tc, tr)
    tag = f"{quant} pages" if quant else "bf16"
    if int8_qk is not None:
        tag += f", int8_qk {int8_qk}"
    if cfg.d_head > 128:
        tag += f", head dim {cfg.d_head}"
    log(f"[vs_cpu] {tag}: first-token logits max |card - cpu fp32| "
        f"{max_err:.3e} (tol {tol:g} abs+rel; max |logit| "
        f"{float(lr.abs().max()):.3e}); greedy tokens equal at {agree}/{steps}"
        f" steps, first {prefix} identical")
    rec = dict(quant=quant, int8_qk=int8_qk, max_abs_err=max_err, tol=tol,
               greedy_agree=agree,
               greedy_prefix=prefix, steps=steps, paged_calls=len(paged_errs),
               paged_calls_max_abs_err=max(paged_errs, default=0.0))
    limit = (f"rtol {KERNEL_RTOL[cfg.dtype]:g} + atol {WIDE_PAGED_ATOL:g} x "
             f"max|plain|" if cfg.d_head > 128 and cfg.dtype == torch.bfloat16
             else f"{PAGED_TOL[cfg.dtype]:g}")
    log(f"[vs_cpu] {tag}: every one of the card engine's {len(paged_errs)} "
        f"paged calls within {limit} of its plain version (max |diff| "
        f"{rec['paged_calls_max_abs_err']:.3e})")
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


def _fa3_fp8_run(q, k, v, do, fmt, int8_pv, saved=None):
    """fa3_attention(fp8=True) forward and backward: (o, lse, dq, dk, dv).
    With ``saved`` = (o, lse) of another run, the straight-through backward
    takes those in place of this forward's own: its di = rowsum(o * do) then
    reads the same o as that run's backward did."""
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    o, lse = fa3_attention(*leaves, causal=True, fp8=True, fp8_fmt=fmt,
                           int8_pv=int8_pv)
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
    flash_fwd) and int8 (auto mode: fused = flash_fwd_fp8), with p in bf16
    and re-quantized (``int8_pv="s8"``), both on its tensor-core route.

    At ``shape`` counts are set to 0 just before each run and read just
    after (one 8-bit or flash forward and one flash backward), outputs must
    be finite, and the distance of o to exact attention is reported (the
    quantization's error, not gated). At ``check_shape`` the card's o, LSE
    and gradients are held against the same call on the CPU (plain
    versions), all at the kernels' limits; the CPU's backward takes the
    card's o and LSE, so both backward runs read the same di."""
    gen = torch.Generator().manual_seed(SEED + 4)
    # the 8-bit kernel's route: wgmma up to D = 256, the wide kernels above
    route = "wide" if f8._wide_route(shape[-1]) else "tc"
    base = [torch.randn(shape, generator=gen) for _ in range(4)]
    q, k, v, do = (x.to(dev, torch.bfloat16) for x in base)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    exact = sdpa(q.float(), k.float(), v.float(), is_causal=True)
    small = [x[:, :, :check_shape[2]].contiguous() for x in base]
    out = {}
    for fmt, int8_pv, want in (("fp8", "bf16", "flash_fwd"),
                               ("int8", "bf16", "flash_fwd_fp8"),
                               ("int8", "s8", "flash_fwd_fp8")):
        arm = fmt if int8_pv == "bf16" else f"{fmt}_{int8_pv}"
        sync(dev)
        reset_counts()
        t0 = time.perf_counter()
        res = _fa3_fp8_run(q, k, v, do, fmt, int8_pv)
        sync(dev)
        wall = time.perf_counter() - t0
        counts = read_counts()
        o = res[0]
        if (not all(torch.isfinite(x.float()).all() for x in res)
                or o.shape != q.shape):
            fail(f"fa3_attention(fp8=True, {arm}): non-finite or misshapen "
                 f"output")
        if on_card:
            other = "flash_fwd_fp8" if want == "flash_fwd" else "flash_fwd"
            if (counts[want], counts[other], counts["flash_bwd"]) != (1, 0, 1):
                fail(f"fa3_attention(fp8=True, {arm}) launched {counts}; want "
                     f"one {want} and one flash_bwd")
            if want == "flash_fwd_fp8" and counts[
                    f"flash_fwd_fp8_{route}"] != 1:
                fail(f"fa3_attention(fp8=True, {arm}): flash_fwd_fp8 did not "
                     f"take the {route} route")
        vs_exact = float((o.float() - exact).abs().max())
        del res, o
        # the same call on the CPU at the small shape
        card = _fa3_fp8_run(*(x.to(dev, torch.bfloat16) for x in small), fmt,
                            int8_pv)
        cpu = _fa3_fp8_run(*(x.to(torch.bfloat16) for x in small), fmt,
                           int8_pv, saved=[x.cpu() for x in card[:2]])
        err = {}
        for name, a, r in zip(("o", "lse", "dq", "dk", "dv"), card, cpu):
            tol = ((LSE_TOL, LSE_TOL) if name == "lse"
                   else kernel_tol(BF16, r))
            err[name] = check_close(f"fa3 fp8 {arm} {name} card vs cpu",
                                    a.cpu(), r, *tol)
        out[arm] = dict(max_abs_vs_exact=vs_exact, fwd_bwd_wall_ms=wall * 1e3,
                        launches=counts, check_shape=check_shape,
                        card_vs_cpu_max_abs=err)
        log(f"[fa3_fp8] {shape} causal {arm}: forward+backward "
            f"{wall * 1e3:.2f}"
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
        for name, n in want.items():
            if counts[name] != n:
                fail(f"training launched {name} {counts[name]} times, want "
                     f"{n} ({n // n_timed} per micro-step)")
        log(f"[{tag}] per micro-step: {per} flash_fwd + {cfg.n_layers} "
            f"flash_bwd launches (checked); max_memory_allocated "
            f"{rec['max_memory_allocated'] / 2 ** 30:.3f} GiB")
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        micro(n_warm + n_timed).item()
        wall = time.perf_counter() - t0
    kernels = device_kernels(prof)
    busy = sum(kernels.values()) / 1e6
    # the backward's share holds the fp32 wide route's split of its B
    # operands and sum of its dK/dV partials
    flash = {part: sum(v for k, v in kernels.items() if re.search(pat, k))
             / 1e3 for part, pat in (
                 ("flash_fwd", "flash_fwd"),
                 ("flash_bwd", "flash_bwd|tf32_split_kernel|kv_sum_kernel"))}
    flash_s = sum(flash.values()) / 1e3
    # the flash kernels of the step: those of the dtype's and head dim's
    # route (the dK/dV partials' sum where a GQA/MQA group is split)
    ran = {n for k in kernels for n in re.findall(
        r"flash_\w+_kernel|tf32_split_kernel|kv_sum_kernel", k)}
    want = fa.route_kernels(cfg.dtype, cfg.d_head)
    if on_card and kernels and ran - {"kv_sum_kernel"} != want:
        fail(f"[{tag}] the profiled micro-step ran the flash kernels "
             f"{sorted(ran)}; want {sorted(want)}")
    rec["profile"] = dict(
        wall_ms=wall * 1e3, kernel_ms=busy * 1e3,
        device_busy_share=busy / wall if kernels else None,
        flash_ms=flash, flash_kernels=sorted(ran),
        flash_share_of_step=flash_s / wall if kernels else None,
        flash_share_of_kernels=flash_s / busy if kernels else None,
        top=sorted(((k, v / 1e3) for k, v in kernels.items()),
                   key=lambda kv: -kv[1])[:12])
    if kernels:
        log(f"[{tag}] profiled micro-step: {wall * 1e3:.2f} ms wall, kernels "
            f"{busy * 1e3:.2f} ms, device busy {100 * busy / wall:.1f}%; "
            f"flash kernels: forward {flash['flash_fwd']:.4f} ms, backward "
            f"{flash['flash_bwd']:.4f} ms ({100 * flash_s / wall:.2f}% of "
            f"the step, {100 * flash_s / busy:.2f}% of its kernel time); "
            f"flash kernels {', '.join(sorted(ran))}")
        for k, v in rec["profile"]["top"]:
            log(f"[{tag}]   {v:.4f} ms  {k[:90]}")
    else:
        log(f"[{tag}] the profiler recorded no device time: not measured")
    return rec


def phase_train_vs_cpu(cfg, dev, n=512, tol=TRAIN_TOL, tag="train_vs_cpu"):
    """One training loss and its gradients (B=1, dropout 0): the card in
    cfg's compute dtype against the fp32 CPU, from the same fp32
    parameters, within ``tol`` (the loss abs+rel, the gradients' global
    relative L2); on the card both flash kernels must have run."""
    cfg = dataclasses.replace(cfg, dropout_rate=0.0)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    ref_params = init_params(cfg32, seed=SEED + 3, device="cpu")
    card_params = copy.deepcopy(ref_params).to(dev)
    toks = torch.from_numpy(np.random.default_rng(SEED + 3).integers(
        0, cfg.vocab_size, size=(1, n + 1)))
    out = {}
    for side, params, c in (("card", card_params, cfg),
                            ("cpu_fp32", ref_params, cfg32)):
        device = next(params.parameters()).device
        reset_counts()
        loss = ttrain.loss_fn(params, {"tokens": toks.to(device)}, c, None)
        loss.backward()
        sync(device)
        out[side] = (loss.item(), {name: p.grad.float().cpu()
                                   for name, p in params.named_parameters()},
                     read_counts())
    (lc, gc, counts), (lr, gr, _) = out["card"], out["cpu_fp32"]
    if not np.isfinite(lc):
        fail(f"[{tag}] card training loss is not finite")
    flash = [counts["flash_fwd"], counts["flash_bwd"]]
    if torch.device(dev).type == "cuda" and not all(flash):
        fail(f"[{tag}] flash launches {flash} (fwd, bwd); want both on the "
             "card")
    loss_err = abs(lc - lr)
    num = sum(float((gc[k] - gr[k]).square().sum()) for k in gr)
    den = sum(float(gr[k].square().sum()) for k in gr)
    rel = (num / den) ** 0.5
    per = {k: float((gc[k] - gr[k]).norm() / gr[k].norm().clamp(min=1e-30))
           for k in gr}
    worst = max(per, key=per.get)
    dname = str(cfg.dtype).replace("torch.", "")
    log(f"[{tag}] N={n}: loss card {dname} {lc:.6f} vs cpu fp32 {lr:.6f} "
        f"(|diff| {loss_err:.3e}, tol {tol:g} abs+rel); gradient global "
        f"relative L2 {rel:.3e} (tol {tol:g}); worst tensor {worst} "
        f"{per[worst]:.3e}; card flash launches (fwd, bwd) {flash}")
    if loss_err > tol + tol * abs(lr):
        fail(f"[{tag}] training loss differs by {loss_err:.3e}")
    if not rel <= tol:
        fail(f"[{tag}] gradient relative L2 error {rel:.3e} over {tol:g}")
    return dict(n=n, loss_card=lc, loss_cpu=lr, loss_abs_err=loss_err,
                grad_rel_l2=rel, worst_tensor=worst, worst_rel_l2=per[worst],
                tol=tol, launches=counts)


# ---------------------------------------------------------------------------
# Phase 7: the block-sparse model
# ---------------------------------------------------------------------------


def _sparse_loss(params, toks, cfg, pattern):
    """Next-token CE of toks (B, N+1) through the model with a pattern."""
    logits = apply_transformer(params, toks[:, :-1], cfg,
                               sparse_pattern=pattern)
    return ttrain.token_nll(logits, toks[:, 1:]).mean()


def _sparse_vs_cpu(cfg, dev, n, pattern, tag, tol=TRAIN_TOL):
    """Loss and gradients through the sparse route: the card in ``cfg``'s
    dtype against the fp32 CPU (plain versions), from the same fp32
    parameters, at ``tol`` (abs+rel on the loss, global relative L2 on the
    gradients)."""
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    ref_params = init_params(cfg32, seed=SEED + 5, device="cpu")
    card_params = copy.deepcopy(ref_params).to(dev)
    toks = torch.from_numpy(np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab_size, size=(1, n + 1)))
    out = {}
    for side, params, c, d in (("card", card_params, cfg, dev),
                               ("cpu_fp32", ref_params, cfg32, "cpu")):
        sync(dev)
        reset_counts()
        loss = _sparse_loss(params, toks.to(d), c, pattern.to(d))
        loss.backward()
        out[side] = (loss.item(), {name: p.grad.float().cpu()
                                   for name, p in params.named_parameters()})
        if side == "card":
            launches = read_counts()
    (lc, gc), (lr, gr) = out["card"], out["cpu_fp32"]
    loss_err = abs(lc - lr)
    rel = (sum(float((gc[k] - gr[k]).square().sum()) for k in gr)
           / sum(float(gr[k].square().sum()) for k in gr)) ** 0.5
    card = str(cfg.dtype).replace("torch.", "")
    log(f"[{tag}] card vs cpu at N={n}, pattern {pattern.int().tolist()}: "
        f"loss card {card} {lc:.6f} vs cpu fp32 {lr:.6f} (|diff| "
        f"{loss_err:.3e}, tol {tol:g} abs+rel); gradient global relative L2 "
        f"{rel:.3e} (tol {tol:g})")
    if not np.isfinite(lc) or loss_err > tol + tol * abs(lr):
        fail(f"sparse model loss card vs cpu differs by {loss_err:.3e}")
    if not rel <= tol:
        fail(f"sparse model gradient relative L2 error {rel:.3e} over "
             f"{tol:g}")
    return dict(n=n, card_dtype=card, loss_card=lc, loss_cpu=lr,
                loss_abs_err=loss_err, grad_rel_l2=rel, tol=tol,
                launches=launches)


def gemma_sparse_config():
    """Phase 7b's model: Gemma 2B's attention widths (google/gemma-2b
    config.json: hidden 2048, 8 query heads, 1 KV head, head_dim 256,
    intermediate 16384) cut to 2 layers, with the port's vocabulary (50257),
    GELU MLP and LayerNorm at that d_ff; rope, dropout 0, remat "full",
    bf16, 128-token tiles."""
    return TransformerConfig(d_model=2048, n_heads=8, n_kv_heads=1,
                             d_ff=16384, pos_encoding="rope", n_layers=2,
                             max_seq_len=4096, dropout_rate=0.0,
                             block_size=128)


def gemma_serving_config():
    """Phase 3c's model and engine: Gemma 2B's attention widths
    (gemma_sparse_config: 8 query heads over 1 KV head, head dim 256) cut
    to 6 of its 18 layers (the script's time: the engine runs are host
    bound, so their time follows the depth), bf16, dropout 0, rope, d_ff
    16384, the port's vocab; batch 32 on 16-slot pages, 256 pages a slot,
    sequences up to 4096."""
    return (dataclasses.replace(gemma_sparse_config(), n_layers=6),
            EngineConfig(max_batch_size=32, page_size=16,
                         num_pages=32 * 256 + 1, max_seq_len=4096,
                         prefill_pad=64))


def wide_config():
    """Phases 3d-5d's model: Gemma 2B's widths (gemma_sparse_config:
    hidden 2048, d_ff 16384, one KV head) with its query heads halved, 4
    over 1 KV head, so that the head dim is 512 (no public config in the
    model's d_head = d_model / n_heads parametrisation goes above 256), 2
    layers, rope, dropout 0, bf16, the port's vocab."""
    return dataclasses.replace(gemma_sparse_config(), n_heads=4)


def wide_serving_config():
    """Phase 3d's model and engine: ``wide_config`` on phase 3c's engine
    (batch 32 on 16-slot pages, 256 pages a slot, sequences up to 4096)."""
    return (wide_config(),
            EngineConfig(max_batch_size=32, page_size=16,
                         num_pages=32 * 256 + 1, max_seq_len=4096,
                         prefill_pad=64))


def phase_wide(dev, on_card, n_req=16, prompt_range=(256, 3072), n_new=64,
               check_prompt=100, train_n=2048, check_n=512):
    """Phases 3d, 4d and 5d at head dim 512 (``wide_config``): the engine
    with bf16, e4m3 and int8 pages (phase 3's launch checks: every paged
    launch on the split route's tensor-core walk, every append on the
    kernel), the bf16, e4m3 and int8 card engines' first-token logits
    against the CPU's (phase 4b's rungs; each engine's paged calls held
    against their plain versions), then ``train_step`` at B = 1, N =
    ``train_n`` (2 warm-up and 4 timed micro-steps, phase 5's launch
    checks, one profiled) and one loss with its gradients card vs fp32 CPU
    in bf16 (5e-2) and in fp32 (1e-4). The parameters are drawn once on the
    host (2 layers: ~0.4 B fp32 values)."""
    out = {}
    cfg, ecfg = wide_serving_config()
    if not on_card:  # the rehearsal: head dim 512, narrow elsewhere
        cfg = dataclasses.replace(cfg, d_ff=256, vocab_size=97,
                                  max_seq_len=256)
        ecfg = dataclasses.replace(ecfg, max_batch_size=4, num_pages=65,
                                   max_seq_len=256)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device="cpu")
    log(f"[wide] {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads over {cfg.kv_heads}, head dim {cfg.d_head}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; random weights seed "
        f"{SEED} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for quant in (None, "fp8", "int8"):
        out["engine_d512" + (f"_{quant}" if quant else "")] = phase_engine(
            cfg, params, dataclasses.replace(ecfg, quant=quant), dev, n_req,
            prompt_range, n_new, on_card=on_card)
        if on_card:
            torch.cuda.empty_cache()
    out["phase_3d_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["vs_cpu_d512"] = phase_vs_cpu(cfg, params, dev, check_prompt, 16)
    for quant in ("fp8", "int8"):
        out[f"vs_cpu_d512_{quant}"] = phase_vs_cpu(cfg, params, dev,
                                                   check_prompt, 16,
                                                   quant=quant)
    out["phase_4d_s"] = time.perf_counter() - t0
    del params
    t0 = time.perf_counter()
    tc = ttrain.TrainConfig(batch_size=1, seq_len=train_n, grad_accum=1,
                            warmup_steps=2)
    out["train_d512"] = phase_train(cfg, tc, dev, on_card, n_warm=2,
                                    n_timed=4, tag="train_d512")
    if on_card:
        torch.cuda.empty_cache()
    out["train_d512_vs_cpu"] = phase_train_vs_cpu(
        cfg, dev, n=check_n, tag="train_d512_vs_cpu")
    out["train_d512_fp32_vs_cpu"] = phase_train_vs_cpu(
        dataclasses.replace(cfg, dtype=torch.float32), dev, n=check_n,
        tol=FP32_TOL, tag="train_d512_fp32_vs_cpu")
    if on_card:
        torch.cuda.empty_cache()
    out["phase_5d_s"] = time.perf_counter() - t0
    log(f"[wide] phase 3d {out['phase_3d_s']:.1f} s, phase 4d "
        f"{out['phase_4d_s']:.1f} s, phase 5d {out['phase_5d_s']:.1f} s")
    return out


def gemma_dense_fp32_config():
    """Phase 7c's model: phase 7b's (gemma_sparse_config: Gemma 2B's
    attention widths, 8 query heads over 1 KV head at head dim 256, cut to
    2 layers) in fp32 and dense, so that every attention call runs the
    fp32 flash kernels at D = 256 (the wide 3xTF32 pair)."""
    return dataclasses.replace(gemma_sparse_config(), dtype=torch.float32)


def phase_sparse_model(cfg, dev, on_card, b, n, check_n, n_timed=3,
                       tag="sparse", tol=TRAIN_TOL, logits_tol=LOGITS_TOL,
                       width=4, fp32_check=False):
    """The block-sparse slice's main path at ``cfg``: the local + global
    pattern (``width`` tiles ending at a q tile's own, and tile 0) on the
    n / block_size square of tiles, through
    ``apply_transformer(sparse_pattern=...)``. (1) one no-grad forward;
    (2) forward, next-token CE and backward, one untimed then ``n_timed``
    timed on the host clock up to ``loss.item()``; counts set to 0 just
    before each and read just after, every sparse launch on the route
    ``sa._route`` picks for the model's dtype, head dim and block (the
    tensor cores or the mma kernels); (3) one step under torch.profiler,
    whose sparse kernels must be those of the route (``sa.route_kernels``);
    (4) loss and gradients, card vs fp32 CPU at ``tol``, at ``check_n``
    with the 4 x 4 pattern of tests/test_sparse.py (with ``fp32_check``
    also the same in fp32 against the CPU at 1e-4, its card launches
    counted); (5) an all-ones pattern
    (the sparse route) against no pattern (the flash route), logits at
    ``logits_tol`` (the bf16 rung by default). Log lines start with
    ``[tag]``."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device=dev)
    n_tiles = -(-n // cfg.block_size)
    pattern = local_global(n_tiles, n_tiles, width).to(dev)
    route = sa._route(cfg.dtype, cfg.d_head, sa.SparseSpec(
        True, 1.0, cfg.block_size, cfg.block_size))
    route_name = {"tc": "tensor-core", "mma": "mma", "wide": "wide"}[route]
    toks = torch.from_numpy(np.random.default_rng(SEED + 6).integers(
        0, cfg.vocab_size, size=(b, n + 1))).to(dev)
    reach = sa.tile_pattern(pattern, n_tiles, n_tiles, cfg.block_size,
                            cfg.block_size, True, 0)
    log(f"[{tag}] {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, vocab {cfg.vocab_size}, remat "
        f"{cfg.remat_policy if cfg.remat else 'off'}, {cfg.dtype}; B={b} "
        f"N={n}; local+global pattern (width {width}, block "
        f"{cfg.block_size}, the {route_name} route): {int(reach.sum())} of "
        f"{n_tiles * (n_tiles + 1) // 2} causally reachable tiles (set-up "
        f"{time.perf_counter() - t0:.1f} s)")
    L = cfg.n_layers
    rec = dict(b=b, n=n, block=cfg.block_size, width=width, route=route,
               active_tiles=int(reach.sum()),
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
    log(f"[{tag}] no-grad forward launches: {counts}")
    if on_card and (counts["sparse_fwd"], counts[f"sparse_fwd_{route}"],
                    counts["flash_fwd"]) != (L, L, 0):
        fail(f"no-grad forward launched {counts}; want {L} sparse_fwd on the "
             f"{route_name} route and no flash_fwd")

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
    log(f"[{tag}] {n_timed} forward+backward steps: median "
        f"{rec['median_step_ms']:.2f} ms, {rec['tokens_per_s']:.1f} tokens/s; "
        f"losses " + " ".join(f"{x:.4f}" for x in losses))
    log(f"[{tag}] launches: {counts}")
    if on_card:
        want = dict(sparse_fwd=2 * L * n_timed, sparse_bwd=L * n_timed,
                    flash_fwd=0, flash_bwd=0)
        for r in ("tc", "mma", "wide"):
            want[f"sparse_fwd_{r}"] = want["sparse_fwd"] * (r == route)
            want[f"sparse_bwd_{r}"] = want["sparse_bwd"] * (r == route)
        got = {k: counts[k] for k in want}
        if got != want:
            fail(f"sparse steps launched {got}; want {want} ({2 * L} "
                 f"sparse_fwd and {L} sparse_bwd per step, all on the "
                 f"{route_name} route)")
        log(f"[{tag}] per step: {2 * L} sparse_fwd + {L} sparse_bwd, all on "
            f"the {route_name} route, no flash launch (checked); "
            f"max_memory_allocated "
            f"{rec['max_memory_allocated'] / 2 ** 30:.3f} GiB")

    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        wall = time.perf_counter() - t0
    kernels = device_kernels(prof)
    busy = sum(kernels.values()) / 1e6
    sparse_ms = {k: v / 1e3 for k, v in kernels.items()
                 if re.search(SPARSE_KERNEL_NAME, k)}
    rec["profile"] = dict(
        wall_ms=wall * 1e3, kernel_ms=busy * 1e3,
        device_busy_share=busy / wall if kernels else None,
        sparse_kernels_ms=sparse_ms,
        top=sorted(((k, v / 1e3) for k, v in kernels.items()),
                   key=lambda kv: -kv[1])[:12])
    rec["profile"]["sparse_share"] = (sum(sparse_ms.values()) / (busy * 1e3)
                                      if kernels else None)
    if kernels:
        log(f"[{tag}] profiled step: {wall * 1e3:.2f} ms wall, kernels "
            f"{busy * 1e3:.2f} ms, device busy {100 * busy / wall:.1f}%; "
            f"sparse kernels {sum(sparse_ms.values()):.4f} ms ("
            f"{100 * rec['profile']['sparse_share']:.2f}% of the kernels: "
            + ", ".join(f"{re.search(SPARSE_KERNEL_NAME, k).group(0)} {v:.4f}"
                        for k, v in sorted(sparse_ms.items())) + ")")
        ran = {m.group(0) for k in sparse_ms
               for m in [re.search(SPARSE_KERNEL_NAME, k)] if m}
        spec = sa.SparseSpec(True, 1.0, cfg.block_size, cfg.block_size)
        want = sa.route_kernels(cfg.dtype, cfg.d_head, spec, kv_splits_of(
            cfg.dtype, cfg.d_head, spec, b, cfg.n_heads, cfg.kv_heads, n, n))
        if on_card and sparse_ms and ran != want:
            fail(f"[{tag}] the profiled step ran {sorted(ran)}; want "
                 f"{sorted(want)}")
        for k, v in rec["profile"]["top"]:
            log(f"[{tag}]   {v:.4f} ms  {k[:90]}")
    else:
        log(f"[{tag}] the profiler recorded no device time: not measured")
    del params
    if on_card:
        torch.cuda.empty_cache()

    p4 = torch.tensor([[1, 0, 0, 0], [1, 1, 0, 0], [0, 1, 1, 0], [1, 0, 1, 1]],
                      dtype=torch.bool)
    rec["vs_cpu"] = _sparse_vs_cpu(cfg, dev, check_n, p4, tag, tol)
    if fp32_check:
        rec["vs_cpu_fp32"] = _sparse_vs_cpu(
            dataclasses.replace(cfg, dtype=torch.float32), dev, check_n, p4,
            f"{tag}_fp32", FP32_TOL)
        if on_card:
            torch.cuda.empty_cache()

    params = init_params(cfg, seed=SEED + 7, device=dev)
    with torch.no_grad():
        ones = apply_transformer(params, toks[:, :-1], cfg,
                                 sparse_pattern=torch.ones_like(pattern))
        dense = apply_transformer(params, toks[:, :-1], cfg)
    err = (ones - dense).abs()
    rec["ones_vs_dense_max_abs"] = max_err = float(err.max())
    log(f"[{tag}] all-ones pattern vs no pattern (flash route): logits max "
        f"|diff| {max_err:.3e} (tol {logits_tol:g} abs+rel; max |logit| "
        f"{float(dense.abs().max()):.3e})")
    if bool((err > logits_tol + logits_tol * dense.abs()).any()):
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
            got = [counts["flash_fwd"], counts["flash_bwd"]]
            if got != [want] * 2:
                fail(f"phase 10 {kind} ({tag}): flash launches (fwd, bwd) "
                     f"{got}, want {want} each")
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
                have = (c["flash_fwd"], c["flash_bwd"])
                if have != (per, cfg.n_layers):
                    fail(f"phase 10 {name}: flash launches {have} in a "
                         f"micro-step, want ({per}, {cfg.n_layers}) as phase "
                         f"5")
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
    layer (gated), every flash launch of the fp32 card run on the 3xTF32
    tensor-core kernels (gated on the card); the bf16 card's distance and
    its tokens routed to another expert set (reported)."""
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
        reset_counts()
        with patch:
            loss = ttrain.loss_fn(params, {"tokens": toks.to(device)}, c, None)
            loss.backward()
        sync(device)
        counts = read_counts()
        out[tag] = (loss.item(), {k: p.grad.float().cpu()
                                  for k, p in params.named_parameters()},
                    calls[:cfg.n_layers],  # the forward's; then the recompute
                    counts)
        del params
    lr, gr, er, _ = out["cpu_fp32"]
    rec = dict(loss_cpu=lr, tol=MOE_TOL)
    for tag in ("card_fp32", "card_bf16"):
        lc, gc, ec, counts = out[tag]
        sets = [(torch.sort(a, -1).values != torch.sort(b, -1).values).any(-1)
                for a, b in zip(ec, er)]
        moved = [int(x.sum()) for x in sets]
        num = sum(float((gc[k] - gr[k]).square().sum()) for k in gr)
        den = sum(float(gr[k].square().sum()) for k in gr)
        rel = (num / den) ** 0.5
        rec[tag] = dict(loss=lc, loss_abs_err=abs(lc - lr), grad_rel_l2=rel,
                        tokens_other_experts=moved, launches=counts,
                        first_choice_differs=sum(int((a[..., 0] != b[..., 0])
                                                     .sum())
                                                 for a, b in zip(ec, er)))
        log(f"[moe_vs_cpu] {tag}: loss {lc:.6f} vs cpu fp32 {lr:.6f} (|diff| "
            f"{abs(lc - lr):.3e}), gradient relative L2 {rel:.3e}; tokens with"
            f" another expert set, per layer: {moved} of {n}")
        if tag == "card_fp32":
            flash = [counts["flash_fwd"], counts["flash_bwd"]]
            if torch.device(dev).type == "cuda" and not all(flash):
                fail(f"MoE fp32 card run: flash launches {flash} (fwd, bwd); "
                     "want both on the card")
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
        others = {k: v for k, v in counts.items()
                  if v and k != "flash_fwd"}
        if counts["flash_fwd"] != want or others:
            fail(f"compat forward launched {counts}; want {want} flash_fwd "
                 "and nothing else")
        log(f"[compat] {want} flash_fwd launches a forward, nothing else "
            "(checked)")
        fwd = lambda: compat.apply_reference_transformer(params, ids)
        with torch.no_grad():
            # from an idle card, host issue included: the forward issues
            # more work than the timer's stream hold covers
            rec["forward_ms"] = timer.wall(fwd, reps=10, warmup=2)
            with profiling.trace(OUT_DIR / "traces") as prof:
                fwd()
        kernels = device_kernels(prof)
        flash = {k: v / 1e3 for k, v in kernels.items()
                 if "flash_fwd_f32_sm90_kernel" in k}
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
# fp8 case (b) hold B1-B3 and B4 against their plain versions, and the d =
# 256 cells at case (k)'s, where flash case (k) and fp8 case (h) hold the
# D = 256 kernels.
BENCH_SHAPE = (1, 8, 8192, 128)  # (B, H, N, D), causal
BENCH_SHAPE_D256 = (1, 8, 8192, 256)
BENCH_CELLS = {
    # name: sweep cell (bench.sweep.cell arguments), counter that must move,
    # shape
    "fa2_fwd": (("fa2", "forward"), {}, "flash_fwd", BENCH_SHAPE),
    "fa2_bwd": (("fa2", "backward"), {}, "flash_bwd", BENCH_SHAPE),
    "fa3_int8_fwd": (("fa3", "forward"), dict(fp8=True, fp8_fmt="int8"),
                     "flash_fwd_fp8_tc", BENCH_SHAPE),
    "fa2_fwd_d256": (("fa2", "forward"), {}, "flash_fwd", BENCH_SHAPE_D256),
    "fa2_bwd_d256": (("fa2", "backward"), {}, "flash_bwd", BENCH_SHAPE_D256),
    "fa3_int8_fwd_d256": (("fa3", "forward"), dict(fp8=True, fp8_fmt="int8"),
                          "flash_fwd_fp8_tc", BENCH_SHAPE_D256),
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
        # launches summed over the cells of each shape: "launches" at
        # BENCH_SHAPE, "launches_d256" at BENCH_SHAPE_D256
        launches = {BENCH_SHAPE: collections.Counter(),
                    BENCH_SHAPE_D256: collections.Counter()}
        for name, (args, kw, counter, shape) in BENCH_CELLS.items():
            b, h, n, d = shape
            ns = sweep.cell(*args, n, d, batch=b, heads=h, causal=True, **kw)
            reset_counts()
            r = sweep.run_config(ns)
            counts = read_counts()
            launches[shape].update(counts)
            fn, fn_args, _ = sweep.cell_call(ns)
            fn(*fn_args)
            traced = traced_kernel_ms(lambda: fn(*fn_args))
            rec[name] = dict(record=r.row(), launches=counts,
                             traced_kernel_ms=traced)
            log(f"[bench] {name} {shape} causal: {r.status} "
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
            if counter.endswith("_tc") and counts[counter] != counts[
                    counter[:-3]]:
                fail(f"bench cell {name}: {counts[counter[:-3]]} launches, "
                     f"{counts[counter]} of them on the tensor cores")
            if traced is not None and r.mean_ms > DEVICE_TIME_SLACK * traced:
                fail(f"bench cell {name}: {r.mean_ms} ms against {traced} ms "
                     "of kernels: the events held more than device work")
        rec["launches"] = dict(launches[BENCH_SHAPE])
        rec["launches_d256"] = dict(launches[BENCH_SHAPE_D256])
        b, h, n, d = BENCH_SHAPE
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


# Tensor-core kernels per library: forward, dK/dV and dQ at D 64, 128 and
# 256, each in bf16 and in fp32 (3xTF32; at 256 the wide kernels); the
# sparse ones in bf16 at D 64, 128 and 256, each with one and two consumer
# warpgroups but the D-split dK/dV at 256 (two), and in fp32 (3xTF32) at
# D 64 with one and two, at D 128 with one and at D 256 the wide kernels;
# the 8-bit forward at D 64, 128 and 256 for e4m3, e5m2, int8 and int8 with
# p re-quantized (int8_pv "s8").
SM90_KERNELS = {"flash_fwd": 6, "flash_bwd": 12, "sparse_fwd": 10,
                "sparse_bwd": 19, "flash_fwd_fp8": 12}
# The paged split kernels: bf16, int8 (convert and "qk"), e4m3 and e5m2
# pages, each on the lane-group walk at 1 and 2 rows (D <= 128) and on the
# tensor-core walk at 1, 2 and 4 row tiles a CTA; int8 "full" on the
# tensor-core walk only.
# Above D = 256 the tensor-core walk's six (format, schedule) pairs at 1 and
# 2 row tiles again, their q fragments of up to 16 k-steps a warp, and
# above D = 1024 at 1 row tile, those k-steps in passes.
SPLIT_KERNELS = 46
SPLIT_TC_KERNELS = 36


def dump_sass(names) -> dict[str, str]:
    """{library: its SASS (cuobjdump --dump-sass)}, one cuobjdump per
    library, all started together."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"

    def one(name):
        return subprocess.run([tool, "--dump-sass",
                               str(_build.kernel_path(name))],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout

    with ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(one, names)))


def split_report(sass):
    """Phase 1's report of the paged split route from the SASS of
    paged_attention: per split kernel its registers and spill bytes (this
    build's ptxas report), the 1-D bulk copies (UBLKCP) and, on the
    tensor-core walk, the mma.sync products (HMMA). Fails if one has no
    bulk copy, a tensor-core kernel no HMMA, one spills, or one is
    missing."""
    ptxas = ptxas_entries(_build.BUILD_LOG.get("paged_attention", ""))
    out = {}
    for part in sass.split("Function : ")[1:]:
        fn = part.split()[0]
        tc = "paged_split_tc_kernel" in fn
        if "paged_split_kernel" not in fn and not tc:
            continue
        regs, spill = ptxas.get(fn, (None, None))
        out[fn] = dict(ublkcp=part.count("UBLKCP"), hmma=part.count("HMMA"),
                       tensor_cores=tc, registers=regs, spill_bytes=spill)
        log(f"[sass] paged_attention: {fn}: {out[fn]['ublkcp']} UBLKCP (1-D "
            f"bulk copies), {out[fn]['hmma']} HMMA (mma.sync); ptxas: {regs} "
            f"registers, {spill} spill bytes")
        if not out[fn]["ublkcp"]:
            fail(f"{fn}: the split kernel has no bulk copy")
        if tc and not out[fn]["hmma"]:
            fail(f"{fn}: the tensor-core walk has no HMMA")
        if spill is None:
            fail(f"{fn}: no ptxas report from this run's build")
        if spill:
            fail(f"{fn}: spills {spill} bytes")
    n_tc = sum(r["tensor_cores"] for r in out.values())
    if len(out) != SPLIT_KERNELS or n_tc != SPLIT_TC_KERNELS:
        fail(f"paged_attention: expected {SPLIT_KERNELS} split kernels, "
             f"{SPLIT_TC_KERNELS} of them on the tensor cores, found "
             f"{len(out)}, {n_tc}")
    return out


# The first paged kernel at MAXD = 256 (paged_attention_wide_kernel) and,
# chunked, at MAXD = 1024 (paged_attention_chunked_kernel): bf16 and fp32
# q, six (page format, schedule) pairs, 1, 2 and 4 rows a warp; the merge
# kernels: bf16 and fp32 out, 4 and 8 columns a lane.
FIRST_WIDE_KERNELS = 36
FIRST_CHUNKED_KERNELS = 36
MERGE_KERNELS = 4


def first_report(sass):
    """Phase 1's report of the first paged kernel's MAXD = 256 and chunked
    MAXD = 1024 instantiations and of the merge kernels from the SASS of
    paged_attention: registers and spill bytes (this build's ptxas
    report). Fails if one spills or a count is off."""
    ptxas = ptxas_entries(_build.BUILD_LOG.get("paged_attention", ""))
    out = {}
    for part in sass.split("Function : ")[1:]:
        fn = part.split()[0]
        if not ("paged_attention_wide_kernel" in fn
                or "paged_attention_chunked_kernel" in fn
                or "paged_merge_kernel" in fn):
            continue
        regs, spill = ptxas.get(fn, (None, None))
        out[fn] = dict(registers=regs, spill_bytes=spill)
        log(f"[sass] paged_attention: {fn}: ptxas: {regs} registers, "
            f"{spill} spill bytes")
        if spill is None:
            fail(f"{fn}: no ptxas report from this run's build")
        if spill:
            fail(f"{fn}: spills {spill} bytes")
    merges = sum("paged_merge_kernel" in fn for fn in out)
    chunked = sum("paged_attention_chunked_kernel" in fn for fn in out)
    if (len(out) - merges - chunked, chunked, merges) != (
            FIRST_WIDE_KERNELS, FIRST_CHUNKED_KERNELS, MERGE_KERNELS):
        fail(f"paged_attention: expected {FIRST_WIDE_KERNELS} first kernels "
             f"at MAXD = 256, {FIRST_CHUNKED_KERNELS} chunked ones and "
             f"{MERGE_KERNELS} merge kernels, found "
             f"{len(out) - merges - chunked}, {chunked} and {merges}")
    return out


# The append kernels: bf16 and fp32 tokens into five page formats, each
# with 8 elements a lane (16-byte accesses) and with one, at any D.
APPEND_KERNELS = 20


def append_report(sass):
    """Phase 1's report of B7 from the SASS of paged_append: per append
    kernel its registers and spill bytes (this build's ptxas report) and
    its 16-byte global loads (LDG.E.128). Fails if one spills or is
    missing, or if an instantiation of 8 elements a lane has no 16-byte
    load."""
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


# The flash kernels above D = 256 (flash_wide.cu): the chunked forward in
# bf16 and fp32 and the chunked fp32 dK/dV and dQ (above 8 chunks of 256)
# on mma.sync (4); the backward's cluster kernels, dK/dV and dQ in bf16 and
# fp32 (3xTF32) on wgmma with TMA loads (4); the sums of split dK/dV
# partials in bf16 and fp32 and the split of fp32 operands (3, no product).
WIDE_KERNELS = 11


def wide_report(sass):
    """Phase 1's check of the flash kernels above D = 256: per kernel of
    flash_wide its products in its SASS, mma.sync (HMMA) for the chunked
    ``*_wide_kernel`` ones, wgmma (HGMMA) and TMA loads (UTMALDG) for the
    cluster ``*_sm90_kernel`` ones, and its registers and spill bytes
    (this build's ptxas report). Fails if one lacks its products, spills,
    or is missing."""
    ptxas = ptxas_entries(_build.BUILD_LOG.get("flash_wide", ""))
    out = {}
    for part in sass.split("Function : ")[1:]:
        fn = part.split()[0]
        if "_kernel" not in fn:
            continue
        regs, spill = ptxas.get(fn, (None, None))
        out[fn] = dict(hmma=part.count("HMMA"), hgmma=part.count("HGMMA"),
                       utmaldg=part.count("UTMALDG"), registers=regs,
                       spill_bytes=spill)
        log(f"[sass] flash_wide: {fn}: {out[fn]['hmma']} HMMA (mma.sync), "
            f"{out[fn]['hgmma']} HGMMA (wgmma), {out[fn]['utmaldg']} UTMALDG "
            f"(TMA); ptxas: {regs} registers, {spill} spill bytes")
        if "_sm90_kernel" in fn:
            if not out[fn]["hgmma"] or not out[fn]["utmaldg"]:
                fail(f"{fn}: the cluster kernel lacks HGMMA or UTMALDG")
        elif "_wide_kernel" in fn and not out[fn]["hmma"]:
            fail(f"{fn}: the chunked kernel has no HMMA")
        if spill is None:
            fail(f"{fn}: no ptxas report from this run's build")
        if spill:
            fail(f"{fn}: spills {spill} bytes")
    if len(out) != WIDE_KERNELS:
        fail(f"flash_wide: expected {WIDE_KERNELS} kernels, found {len(out)}")
    return out


# The kernels above head dim 256 of the sparse and 8-bit libraries, all on
# mma.sync: sparse_wide's forward and dQ in bf16 and fp32 with 16- and
# 32-key sub-tiles and its dK/dV in each dtype (10), and the sum of the
# dK/dV chunks in each dtype (2, no product); fp8_wide's forward in e4m3,
# e5m2, int8 and int8 with p re-quantized ("s8"), and the first three again
# for key blocks off the 32-key tile (7), whose int8 ones must also show
# IMMA (the s8 mma.sync).
WIDE_LIB_KERNELS = {"sparse_wide": 12, "fp8_wide": 7}


def wide_lib_report(dumps):
    """Phase 1's check of the sparse and 8-bit kernels above D = 256: per
    kernel of ``sparse_wide`` and ``fp8_wide`` its mma.sync products (HMMA,
    and IMMA for the int8 ones) in its SASS and its registers and spill
    bytes (this build's ptxas report). Fails if one but the chunks' sum has
    no HMMA, an int8 one has no IMMA, one spills, or one is missing."""
    out = {}
    for name, want in WIDE_LIB_KERNELS.items():
        ptxas = ptxas_entries(_build.BUILD_LOG.get(name, ""))
        found = 0
        for part in dumps[name].split("Function : ")[1:]:
            fn = part.split()[0]
            if "_kernel" not in fn:
                continue
            found += 1
            regs, spill = ptxas.get(fn, (None, None))
            rec = dict(hmma=part.count("HMMA"), imma=part.count("IMMA"),
                       registers=regs, spill_bytes=spill)
            out[fn] = rec
            log(f"[sass] {name}: {fn}: {rec['hmma']} HMMA, {rec['imma']} "
                f"IMMA (mma.sync); ptxas: {regs} registers, {spill} spill "
                f"bytes")
            if not rec["hmma"] and "sum_mma_kernel" not in fn:
                fail(f"{fn}: the wide kernel has no HMMA")
            if (name == "fp8_wide" and re.search(r"ILi2ELb[01]ELb[01]EE", fn)
                    and not rec["imma"]):
                fail(f"{fn}: the int8 kernel has no IMMA")
            if spill is None:
                fail(f"{fn}: no ptxas report from this run's build")
            if spill:
                fail(f"{fn}: spills {spill} bytes")
        if found != want:
            fail(f"{name}: expected {want} kernels, found {found}")
    return out


def sass_report(dumps):
    """Phase 1's check that the tensor-core routes are what they claim: per
    kernel of the flash and sparse libraries, the HGMMA (wgmma) and UTMALDG
    (TMA load) instructions in its SASS (``dumps[library]``) and, for the
    tensor-core kernels, registers and spill bytes from the build's ptxas
    report. Fails if a tensor-core kernel has no HGMMA or no UTMALDG, or
    spills, or one is missing, and if an int8 8-bit kernel
    (``flash_fwd_fp8_sm90_kernel<DP, 2, S8>``) has no IGMMA (s8 wgmma)."""
    out = {}
    for name, want in SM90_KERNELS.items():
        sass = dumps[name]
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
            if (name == "flash_fwd_fp8"
                    and re.search(r"ILi\d+ELi2ELb[01]EE", fn)
                    and not rec["igmma"]):
                fail(f"{fn}: the int8 kernel has no IGMMA")
            if spill is None:
                fail(f"{fn}: no ptxas report from this run's build")
            if spill:
                fail(f"{fn}: spills {spill} bytes")
        if found != want:
            fail(f"{name}: expected {want} tensor-core kernels, found {found}")
    return out


# The mma kernels of the sparse libraries (blocks not both multiples of
# 64): in bf16 the forward and dQ at D 64, 128 and 256, each with 16- and
# 32-key sub-tiles, dK/dV at D 64, 128 and 256 (at 256 two warps a key
# slice, each holding half of the head dim); in fp32 (3xTF32) the same but
# dQ at D = 256 with 16-key sub-tiles only; and the sum of the dK/dV chunks
# in each dtype, which only adds (no HMMA).
MMA_KERNELS = {"sparse_fwd": 12, "sparse_bwd": 19}


def mma_report(dumps):
    """Phase 1's check of the sparse mma route: per ``*_mma_kernel`` of the
    sparse libraries its mma.sync products (HMMA) in its SASS
    (``dumps[library]``) and its registers and spill bytes (this build's
    ptxas report). Fails if one but the sum of the dK/dV chunks has no
    HMMA, if one spills, or if one is missing."""
    out = {}
    for name, want in MMA_KERNELS.items():
        ptxas = ptxas_entries(_build.BUILD_LOG.get(name, ""))
        found = 0
        for part in dumps[name].split("Function : ")[1:]:
            fn = part.split()[0]
            if "_mma_kernel" not in fn:
                continue
            found += 1
            regs, spill = ptxas.get(fn, (None, None))
            out[fn] = dict(hmma=part.count("HMMA"), registers=regs,
                           spill_bytes=spill)
            log(f"[sass] {name}: {fn}: {out[fn]['hmma']} HMMA (mma.sync); "
                f"ptxas: {regs} registers, {spill} spill bytes")
            if not out[fn]["hmma"] and "sum_mma_kernel" not in fn:
                fail(f"{fn}: the mma kernel has no HMMA")
            if spill is None:
                fail(f"{fn}: no ptxas report from this run's build")
            if spill:
                fail(f"{fn}: spills {spill} bytes")
        if found != want:
            fail(f"{name}: expected {want} mma kernels, found {found}")
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
        for quant, int8_qk, n_req in (("fp8", None, 8), ("int8", None, 4),
                                      ("int8", "full", 4)):
            report["engine_" + quant + ("_full" if int8_qk else "")] = \
                phase_engine(cfg, params,
                             dataclasses.replace(ecfg, quant=quant,
                                                 int8_qk=int8_qk),
                             "cpu", n_req, (8, 60), 8, on_card=False)
        report["vs_cpu_fp8"] = phase_vs_cpu(cfg, params, "cpu", 40, 8,
                                            quant="fp8")
        report["vs_cpu_int8_full"] = phase_vs_cpu(cfg, params, "cpu", 40, 8,
                                                  quant="int8",
                                                  int8_qk="full")
        gcfg = dataclasses.replace(cfg, d_model=512, n_heads=2, n_kv_heads=1,
                                   pos_encoding="rope")
        gparams = init_params(gcfg, seed=SEED, device="cpu")
        for quant in (None, "fp8", "int8"):
            report["engine_d256" + (f"_{quant}" if quant else "")] = \
                phase_engine(gcfg, gparams,
                             dataclasses.replace(ecfg, quant=quant), "cpu", 4,
                             (8, 60), 8, on_card=False)
        report["profile_d256"] = phase_profile(gcfg, gparams, ecfg, "cpu",
                                               steps=4, plen=40,
                                               profile_prefill=False)
        report["vs_cpu_d256"] = phase_vs_cpu(gcfg, gparams, "cpu", 40, 8)
        report["vs_cpu_d256_fp8"] = phase_vs_cpu(gcfg, gparams, "cpu", 40, 8,
                                                 quant="fp8")
        report.update(phase_wide("cpu", False, n_req=4, prompt_range=(8, 60),
                                 n_new=8, check_prompt=40, train_n=64,
                                 check_n=64))
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
        report["sparse_model_d256"] = phase_sparse_model(
            dataclasses.replace(cfg, d_model=512, n_heads=2, n_kv_heads=1,
                                pos_encoding="rope", block_size=16),
            "cpu", False, b=1, n=128, check_n=64, tag="sparse_d256")
        dcfg = dataclasses.replace(cfg, d_model=512, n_heads=2, n_kv_heads=1,
                                   pos_encoding="rope", dtype=torch.float32)
        report["dense_fp32_vs_cpu"] = phase_train_vs_cpu(
            dcfg, "cpu", n=64, tol=FP32_TOL, tag="dense_fp32_vs_cpu")
        report["dense_fp32"] = phase_train(
            dcfg, ttrain.TrainConfig(batch_size=1, seq_len=64, grad_accum=1,
                                     warmup_steps=2),
            "cpu", on_card=False, n_warm=1, n_timed=2, tag="dense_fp32")
        report["sparse_model_fp32"] = phase_sparse_model(
            dataclasses.replace(cfg, block_size=16, dtype=torch.float32),
            "cpu", False, b=2, n=128, check_n=64, tag="sparse_fp32",
            tol=FP32_TOL, logits_tol=FP32_TOL)
        report["sparse_model_d256_fp32"] = phase_sparse_model(
            dataclasses.replace(dcfg, block_size=16), "cpu", False, b=1,
            n=128, check_n=64, tag="sparse_d256_fp32", tol=FP32_TOL,
            logits_tol=FP32_TOL)
        report["sparse_model_b32"] = phase_sparse_model(
            dataclasses.replace(cfg, block_size=8), "cpu", False, b=2,
            n=128, check_n=64, tag="sparse_b32", width=16)
        report["sparse_model_b32_fp32"] = phase_sparse_model(
            dataclasses.replace(cfg, block_size=8, dtype=torch.float32),
            "cpu", False, b=2, n=128, check_n=64, tag="sparse_b32_fp32",
            width=16, tol=FP32_TOL, logits_tol=FP32_TOL)
        report["sparse_model_d512"] = phase_sparse_model(
            dataclasses.replace(cfg, d_model=1024, n_heads=2, n_kv_heads=1,
                                pos_encoding="rope", block_size=16),
            "cpu", False, b=1, n=128, check_n=64, tag="sparse_d512",
            fp32_check=True)
        report["fa3_fp8_d512"] = phase_fa3_fp8("cpu", (1, 2, 256, 512),
                                               (1, 2, 128, 512), False)
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
    t0 = time.perf_counter()
    dumps = dump_sass([*SM90_KERNELS, "flash_wide", *WIDE_LIB_KERNELS,
                       "paged_attention", "paged_append"])
    log(f"[sass] {len(dumps)} libraries dumped in "
        f"{time.perf_counter() - t0:.2f} s")
    report.update(card=smi, build_s=per,
                  tensor_core_kernels=sass_report(dumps),
                  mma_kernels=mma_report(dumps),
                  wide_flash_kernels=wide_report(dumps["flash_wide"]),
                  wide_sparse_fp8_kernels=wide_lib_report(dumps),
                  paged_split_kernels=split_report(dumps["paged_attention"]),
                  paged_first_kernels=first_report(dumps["paged_attention"]),
                  append_kernels=append_report(dumps["paged_append"]))

    # Phase 2
    t0 = time.perf_counter()
    report["phase_1_s"] = t0 - t_start
    report["kernels"] = phase_kernels(dev)
    report["phase_2_s"] = time.perf_counter() - t0

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

    # Phase 3b: quantized pages, same config and traffic (int8: 16
    # requests, in the default schedules and in "full")
    for quant, int8_qk, n_req in (("fp8", None, 64), ("int8", None, 16),
                                  ("int8", "full", 16)):
        report["engine_" + quant + ("_full" if int8_qk else "")] = \
            phase_engine(cfg, params,
                         dataclasses.replace(ecfg, quant=quant,
                                             int8_qk=int8_qk),
                         dev, n_req, (32, 400), 64, on_card=True)
    report["profile_fp8"] = phase_profile(
        cfg, params, dataclasses.replace(ecfg, quant="fp8"), dev)

    # Phase 4b
    report["vs_cpu_fp8"] = phase_vs_cpu(cfg, params, dev, 100, 16, quant="fp8")
    report["vs_cpu_int8_full"] = phase_vs_cpu(cfg, params, dev, 100, 16,
                                              quant="int8", int8_qk="full")

    # Phase 3c: serving at Gemma 2B's attention widths (head dim 256, MQA
    # 8/1, 6 layers); the parameters are drawn on the card, which skips a
    # host copy of ~1.5 B fp32 parameters
    t0 = time.perf_counter()
    gcfg, gecfg = gemma_serving_config()
    gparams = init_params(gcfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    log(f"[engine d256] Gemma 2B's attention widths ({gcfg.n_layers} layers,"
        f" d_model {gcfg.d_model}, {gcfg.n_heads} heads over "
        f"{gcfg.kv_heads}, head dim {gcfg.d_head}, d_ff {gcfg.d_ff}, vocab "
        f"{gcfg.vocab_size}), random weights seed {SEED} drawn on the card "
        f"in {time.perf_counter() - t0:.1f} s")
    for quant in (None, "fp8", "int8"):
        report["engine_d256" + (f"_{quant}" if quant else "")] = phase_engine(
            gcfg, gparams, dataclasses.replace(gecfg, quant=quant), dev, 32,
            (256, 3072), 64, on_card=True)
        torch.cuda.empty_cache()
    report["profile_d256"] = phase_profile(gcfg, gparams, gecfg, dev,
                                           plen=1024, profile_prefill=False)
    del gparams
    torch.cuda.empty_cache()
    # Phase 4c: the card engine's first-token logits against the CPU's at
    # the 2-layer cut (gemma_sparse_config, dense), bf16 and e4m3 pages
    vcfg = gemma_sparse_config()
    vparams = init_params(vcfg, seed=SEED, device="cpu")
    report["vs_cpu_d256"] = phase_vs_cpu(vcfg, vparams, dev, 100, 16)
    report["vs_cpu_d256_fp8"] = phase_vs_cpu(vcfg, vparams, dev, 100, 16,
                                             quant="fp8")
    del vparams
    torch.cuda.empty_cache()
    report["phase_3c_s"] = time.perf_counter() - t0

    # Phase 3d: serving at head dim 512 (wide_config: Gemma 2B's widths with
    # 4 query heads over 1 KV head, 2 layers), 16 requests on phase 3c's
    # engine and traffic, bf16, e4m3 and int8 pages; 4d: its first-token
    # logits card vs CPU; 5d: training it (bf16 train_step at B = 1, N =
    # 2048; card vs fp32 CPU at the bf16 rung, and in fp32 at 1e-4)
    t0 = time.perf_counter()
    report.update(phase_wide(dev, True))
    report["phase_3d_5d_s"] = time.perf_counter() - t0

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

    # Phase 5bx: the FA3 8-bit path at head dim 512 (phase 3d's model's
    # attention call, 4 heads at N = 2048): e4m3 predecode onto the flash
    # kernels above 256, int8 and s8 on the 8-bit wide kernels
    t0 = time.perf_counter()
    report["fa3_fp8_d512"] = phase_fa3_fp8(dev, (1, 4, 2048, 512),
                                           (1, 4, 512, 512), True)
    report["fa3_fp8_d512"]["phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # Phase 7: the block-sparse model at GPT-3 Small widths, N = 4096 (only
    # the position table grows)
    scfg = TransformerConfig(dropout_rate=0.0, max_seq_len=4096)
    report["sparse_model"] = phase_sparse_model(scfg, dev, True, b=2, n=4096,
                                                check_n=512)
    torch.cuda.empty_cache()

    # Phase 7b: phase 7 at head dim 256, Gemma 2B's attention widths
    # (google/gemma-2b config.json) at 2 layers, B = 1, N = 4096
    t0 = time.perf_counter()
    report["phases_3_7_s"] = t0 - t_start - report["phase_1_s"] - \
        report["phase_2_s"]
    report["sparse_model_d256"] = phase_sparse_model(
        gemma_sparse_config(), dev, True, b=1, n=4096, check_n=512,
        tag="sparse_d256")
    report["sparse_model_d256"]["phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # Phase 7c: phase 7b's widths dense in fp32 (the wide 3xTF32 flash
    # kernels at D = 256): card vs CPU at N = 512, then train_step at B = 1,
    # N = 4096
    t0 = time.perf_counter()
    dcfg = gemma_dense_fp32_config()
    report["dense_fp32_vs_cpu"] = phase_train_vs_cpu(
        dcfg, dev, n=512, tol=FP32_TOL, tag="dense_fp32_vs_cpu")
    torch.cuda.empty_cache()
    report["dense_fp32"] = phase_train(
        dcfg, ttrain.TrainConfig(batch_size=1, seq_len=4096, grad_accum=1,
                                 warmup_steps=2),
        dev, on_card=True, n_warm=2, n_timed=3, tag="dense_fp32")
    report["dense_fp32"]["phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # Phase 7d: phase 7 in fp32 (dtype and parameters), every attention call
    # on the 3xTF32 sparse kernels at D = 64; card vs CPU and the all-ones
    # pattern at the fp32 rung
    t0 = time.perf_counter()
    report["sparse_model_fp32"] = phase_sparse_model(
        dataclasses.replace(scfg, dtype=torch.float32), dev, True, b=2,
        n=4096, check_n=512, tag="sparse_fp32", tol=FP32_TOL,
        logits_tol=FP32_TOL)
    report["sparse_model_fp32"]["phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # Phase 7e: phase 7b in fp32 (dtype and parameters: phase 7c's model
    # with the pattern), every attention call on the wide 3xTF32 sparse
    # kernels at D = 256 (MQA 8/1); card vs CPU and the all-ones pattern at
    # the fp32 rung
    t0 = time.perf_counter()
    report["sparse_model_d256_fp32"] = phase_sparse_model(
        gemma_dense_fp32_config(), dev, True, b=1, n=4096, check_n=512,
        tag="sparse_d256_fp32", tol=FP32_TOL, logits_tol=FP32_TOL)
    report["sparse_model_d256_fp32"]["phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # Phase 7f: phase 7 at blocks of 32 with the local + global pattern at
    # width 16 (each q tile sees the 16 tiles of 32 that end at its own and
    # tile 0: about the 512-key window of phase 7's 4 tiles of 128, on a
    # pattern 4x finer), so every attention call runs the mma kernels
    t0 = time.perf_counter()
    report["sparse_model_b32"] = phase_sparse_model(
        dataclasses.replace(scfg, block_size=32), dev, True, b=2, n=4096,
        check_n=512, tag="sparse_b32", width=16)
    report["sparse_model_b32"]["phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # Phase 7g: phase 7f in fp32 (dtype and parameters), every attention
    # call on the fp32 mma kernels (3xTF32 on m16n8k8); card vs CPU and the
    # all-ones pattern at the fp32 rung
    t0 = time.perf_counter()
    report["sparse_model_b32_fp32"] = phase_sparse_model(
        dataclasses.replace(scfg, dtype=torch.float32, block_size=32), dev,
        True, b=2, n=4096, check_n=512, tag="sparse_b32_fp32", width=16,
        tol=FP32_TOL, logits_tol=FP32_TOL)
    report["sparse_model_b32_fp32"]["phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # Phase 7x: phase 7b at head dim 512 (wide_config: Gemma 2B's widths
    # with 4 query heads over 1 KV head, 2 layers, B = 1, N = 4096), every
    # attention call on the wide sparse kernels; card vs CPU in bf16 and in
    # fp32 (1e-4), the all-ones pattern against the flash route
    t0 = time.perf_counter()
    report["sparse_model_d512"] = phase_sparse_model(
        wide_config(), dev, True, b=1, n=4096, check_n=512,
        tag="sparse_d512", fp32_check=True)
    report["sparse_model_d512"]["phase_s"] = time.perf_counter() - t0
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
    log(f"[card] phase 1 {report['phase_1_s']:.1f} s, phase 2 "
        f"{report['phase_2_s']:.1f} s, phases 3-7 "
        f"{report['phases_3_7_s']:.1f} s (phases 3c-4c "
        f"{report['phase_3c_s']:.1f} s of it), phases 3d-5d "
        f"{report['phase_3d_5d_s']:.1f} s, phase 7b "
        f"{report['sparse_model_d256']['phase_s']:.1f} s, phase 7c "
        f"{report['dense_fp32']['phase_s']:.1f} s, phase 7d "
        f"{report['sparse_model_fp32']['phase_s']:.1f} s, phase 7e "
        f"{report['sparse_model_d256_fp32']['phase_s']:.1f} s, phase 7f "
        f"{report['sparse_model_b32']['phase_s']:.1f} s, phase 7g "
        f"{report['sparse_model_b32_fp32']['phase_s']:.1f} s, phase 7x "
        f"{report['sparse_model_d512']['phase_s']:.1f} s, phase 5bx "
        f"{report['fa3_fp8_d512']['phase_s']:.1f} s, "
        f"phase 8 {report['spec']['phase_s']:.1f} s, phase 9 "
        f"{report['multihost']['phase_s']:.1f} s, phase 10 "
        f"{report['cp']['phase_s']:.1f} s, phase 11 "
        f"{report['moe_train']['phase_s']:.1f} s, phase 12 "
        f"{report['text']['phase_s']:.1f} s, whole run "
        f"{report['total_s']:.1f} s")

    counts = {**report["engine"]["launches"],
              **{k: report["train"]["launches"][k]
                 for k in ("flash_fwd", "flash_bwd")}}
    kernels = []
    layers = cfg.n_layers

    def by_kind(run, name):  # counted launches of an engine run by kind
        c = report[run]["launches"]
        more = dict(launches_decode=c[name] - c[f"{name}_chunk"],
                    launches_chunk=c[f"{name}_chunk"])
        if name == "paged_attention":
            more["launches_split"] = c["paged_attention_split"]
            more["launches_tc"] = c["paged_attention_tc"]
        return c[name], c[f"{name}_chunk"], more

    # (kernel, name in the record, phase-2 case, launches of its main path,
    # more keys), every launch count as counted in phase 3/3b: the decode
    # rows carry the whole run's launches and their split by kind (T = 1,
    # T > 1), the chunk rows the run's T > 1 launches.
    rows = []
    for name, cases in (
        ("paged_attention", (("engine", "", "decode", "chunk"),
                             ("engine_int8", "int8", "decode_int8_qk", None),
                             # phase 3b's "full" run on the tensor cores
                             ("engine_int8_full", "int8,full",
                              "decode_int8_full", "chunk_int8_full"),
                             ("engine_fp8", "fp8", "decode_fp8",
                              "chunk_fp8"),
                             # phase 3c: head dim 256, numbers of the
                             # phase-2 d256 cases
                             ("engine_d256", "d256", "d256_decode",
                              "d256_chunk"),
                             ("engine_d256_int8", "d256,int8",
                              "d256_decode_int8_qk", None),
                             ("engine_d256_fp8", "d256,fp8",
                              "d256_decode_fp8", None),
                             # phase 3d: head dim 512, numbers of the
                             # phase-2 d512 cases
                             ("engine_d512", "d512", "d512_decode",
                              "d512_chunk"),
                             ("engine_d512_int8", "d512,int8",
                              "d512_decode_int8_qk",
                              "d512_chunk_int8_convert"),
                             ("engine_d512_fp8", "d512,fp8",
                              "d512_decode_fp8", "d512_chunk_fp8"))),
        ("paged_append", tuple((f"engine{q and '_' + q}", q,
                                f"append_{q or 'bf16'}_decode",
                                f"append_{q or 'bf16'}_chunk")
                               for q in ("", "int8", "fp8"))
         + (("engine_d256", "d256", "append_bf16_decode_d256",
             "append_bf16_chunk_d256"),
            ("engine_d512", "d512", "append_bf16_decode_d512",
             "append_bf16_chunk_d512"),
            ("engine_d512_int8", "d512,int8", "append_int8_decode_d512",
             "append_int8_chunk_d512"),
            ("engine_d512_fp8", "d512,fp8", "append_fp8_decode_d512",
             "append_fp8_chunk_d512"))),
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
            **({"path": r["route"], "walk": r["walk"]} if "route" in r
               else {}),
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
        # Phi-2's head dim 80: phase-2 cases (m) int8 and (n) e4m3, and
        # (o), (m) at D = 96
        **{f"{key}_{x}": report["kernels"][f"fp8_{x}"][key]
           for x in "mno" for key in ("ms", "fma_ms", "plain_ms",
                                      "bound_ms", "yardstick_ms", "case")},
    ))
    # int8_pv "s8": launches of phase 5b's s8 arm, numbers of phase-2 case
    # (k), that call's shape, with (l) (D = 256) and (g) beside them
    r = report["kernels"]["fp8_k"]
    fa3_s8 = report["fa3_fp8"]["int8_s8"]["launches"]
    kernels.append(dict(
        name="flash_fwd_fp8[s8]", **KERNELS["flash_fwd_fp8"],
        launches=fa3_s8["flash_fwd_fp8"],
        launches_tensor_core=fa3_s8["flash_fwd_fp8_tc"],
        max_abs_err=max(r["max_abs_err"].values()), ms=r["ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=None,
        yardstick_ms=r["yardstick_ms"], case=r["case"], path=r["route"],
        fma_ms=r["fma_ms"],
        **{f"{key}_{x}": report["kernels"][f"fp8_{x}"][key]
           for x in "lg" for key in ("ms", "fma_ms", "plain_ms", "bound_ms",
                                     "yardstick_ms", "case")},
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
    # Phase 12: compat's forward (fp32, every launch on the 3xTF32
    # tensor-core route), numbers of case (e), its causal attention call,
    # with case (i), the "ffn" block's non-causal call, beside them; the
    # FMA route's time on the same inputs (fma_ms) and its bound at 67
    # TFLOP/s (fma_bound_ms) beside each
    r, ri = report["kernels"]["flash_e"], report["kernels"]["flash_i"]
    c = report["compat"]["launches"]
    kernels.append(dict(
        name="flash_fwd[compat]", **KERNELS["flash_fwd"],
        launches=c["flash_fwd"],
        max_abs_err=max(r["max_abs_err"][e] for e in ("o", "lse")),
        ms=r["fwd_ms"], plain_ms=r["fwd_plain_ms"], bound_ms=r["fwd_bound_ms"],
        bound_by=r["fwd_bound_by"], library_ms=r["library_fwd_ms"],
        case=r["case"], fma_ms=r["fwd_fma_ms"],
        fma_bound_ms=r["fwd_fma_bound_ms"], ms_noncausal=ri["fwd_ms"],
        plain_ms_noncausal=ri["fwd_plain_ms"],
        bound_ms_noncausal=ri["fwd_bound_ms"],
        library_ms_noncausal=ri["library_fwd_ms"],
        fma_ms_noncausal=ri["fwd_fma_ms"],
        fma_bound_ms_noncausal=ri["fwd_fma_bound_ms"],
        case_noncausal=ri["case"],
        compat_logits_max_abs_err=report["compat"]["logits_max_abs_err"]))
    # The fp32 route (3xTF32 wgmma) each way: the forward's launches of the
    # compat forward, the backward's of phase 11's fp32 card check (its
    # forward's launches beside them); numbers of case (e) with the library
    # call (SDPA, the same function) and case (h), the training call with
    # dropout (SDPA a yardstick), each beside the FMA route on its inputs
    rh = report["kernels"]["flash_h"]
    moe32 = report["moe_vs_cpu"]["card_fp32"]["launches"]
    for name, part, errs, c in (
            ("flash_fwd", "fwd", ("o", "lse"), report["compat"]["launches"]),
            ("flash_bwd", "bwd", ("dq", "dk", "dv"), moe32)):
        kernels.append(dict(
            name=f"{name}[fp32]", **KERNELS[name], launches=c[name],
            max_abs_err=max(max(x["max_abs_err"][e] for e in errs)
                            for x in (r, rh)),
            ms=r[f"{part}_ms"], plain_ms=r[f"{part}_plain_ms"],
            bound_ms=r[f"{part}_bound_ms"], bound_by=r[f"{part}_bound_by"],
            library_ms=r[f"library_{part}_ms"], case=r["case"],
            fma_ms=r[f"{part}_fma_ms"], fma_bound_ms=r[f"{part}_fma_bound_ms"],
            wall_ms=r[f"{part}_wall_ms"], ms_h=rh[f"{part}_ms"],
            plain_ms_h=rh[f"{part}_plain_ms"],
            bound_ms_h=rh[f"{part}_bound_ms"],
            yardstick_ms_h=rh[f"yardstick_{part}_ms"],
            fma_ms_h=rh[f"{part}_fma_ms"], case_h=rh["case"],
            **({"launches_fwd_moe_fp32": moe32["flash_fwd"]}
               if name == "flash_bwd" else {})))
    # Training on packed documents, numbers of case (j), the same call (no
    # PyTorch call computes its dropout: SDPA is a yardstick)
    r, c = report["kernels"]["flash_j"], report["packed_train"]["launches"]
    for name, part, errs in (("flash_fwd", "fwd", ("o", "lse")),
                             ("flash_bwd", "bwd", ("dq", "dk", "dv"))):
        kernels.append(dict(
            name=f"{name}[packed]", **KERNELS[name], launches=c[name],
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
    # the D = 256 8-bit kernels: launches of the d = 256 fa3 cell, numbers
    # of fp8 case (h), its shape and call, with cases (i) (Gemma 2B's MQA,
    # e4m3) and (j) (e5m2) beside them
    r = report["kernels"]["fp8_h"]
    c = bench["launches_d256"]
    kernels.append(dict(
        name="flash_fwd_fp8[sweep_d256]", **KERNELS["flash_fwd_fp8"],
        launches=c["flash_fwd_fp8"],
        launches_tensor_core=c["flash_fwd_fp8_tc"],
        max_abs_err=max(r["max_abs_err"].values()), ms=r["ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=None,
        yardstick_ms=r["yardstick_ms"], case=r["case"], fma_ms=r["fma_ms"],
        sweep_cell="fa3_int8_fwd_d256",
        sweep_ms=bench["fa3_int8_fwd_d256"]["record"]["mean_ms"],
        **{f"{key}_{x}": report["kernels"][f"fp8_{x}"][key]
           for x in "ij" for key in ("ms", "fma_ms", "plain_ms", "bound_ms",
                                     "yardstick_ms", "case")},
        **{f"max_abs_err_{x}": max(
            report["kernels"][f"fp8_{x}"]["max_abs_err"].values())
           for x in "ij"}))
    # head dim 256 (bf16 wgmma; the dK/dV kernel split over the head dim):
    # launches of the two d = 256 sweep cells, numbers of flash case (k),
    # their shape and call, with case (l) (GQA, window, sinks, soft-cap,
    # dropout) beside them; fma_ms the first kernels on the same inputs,
    # with their bound at 67 TFLOP/s
    rk, rl = report["kernels"]["flash_k"], report["kernels"]["flash_l"]
    c = bench["launches_d256"]
    for name, part, errs, cell in (
            ("flash_fwd", "fwd", ("o", "lse"), "fa2_fwd_d256"),
            ("flash_bwd", "bwd", ("dq", "dk", "dv"), "fa2_bwd_d256")):
        kernels.append(dict(
            name=f"{name}[d256]", **KERNELS[name], launches=c[name],
            max_abs_err=max(x["max_abs_err"][e] for e in errs
                            for x in (rk, rl)),
            ms=rk[f"{part}_ms"], plain_ms=rk[f"{part}_plain_ms"],
            bound_ms=rk[f"{part}_bound_ms"], bound_by=rk[f"{part}_bound_by"],
            library_ms=rk[f"library_{part}_ms"], case=rk["case"],
            fma_ms=rk[f"{part}_fma_ms"],
            fma_bound_ms=rk[f"{part}_fma_bound_ms"],
            wall_ms=rk[f"{part}_wall_ms"],
            **({"kernel_ms": rk["kernel_ms"]} if part == "bwd" else {}),
            ms_l=rl[f"{part}_ms"], plain_ms_l=rl[f"{part}_plain_ms"],
            bound_ms_l=rl[f"{part}_bound_ms"],
            yardstick_ms_l=rl[f"yardstick_{part}_ms"],
            fma_ms_l=rl[f"{part}_fma_ms"], case_l=rl["case"],
            sweep_cell=cell, sweep_ms=bench[cell]["record"]["mean_ms"]))
    # fp32 at head dim 256 (the wide 3xTF32 kernels): launches of phase
    # 7c's timed micro-steps, numbers of flash case (o), that phase's call
    # (MQA: the dK/dV kernel's query-head split and the sum of its
    # partials), with case (m) (MHA at N = 8192, the shape of rows 1fw /
    # 2fw) and case (n) (GQA, window, sinks, soft-cap, dropout) beside them,
    # each key suffixed with its case; fma_ms the first kernels on the same
    # inputs, with their bound at 67 TFLOP/s; step_flash_ms the flash
    # kernels' device time in phase 7c's profiled micro-step
    ro, rm, rn = (report["kernels"][f"flash_{x}"] for x in "omn")
    dense = report["dense_fp32"]
    c = dense["launches"]
    for name, part, errs in (("flash_fwd", "fwd", ("o", "lse")),
                             ("flash_bwd", "bwd", ("dq", "dk", "dv"))):
        beside = {}
        for x, r in (("m", rm), ("n", rn)):
            lib = "library" if f"library_{part}_ms" in r else "yardstick"
            beside.update({f"{key}_{x}": r[f"{part}_{key}"]
                           for key in ("ms", "plain_ms", "bound_ms",
                                       "fma_ms", "fma_bound_ms")})
            beside[f"{lib}_ms_{x}"] = r[f"{lib}_{part}_ms"]
            beside[f"case_{x}"] = r["case"]
        if part == "bwd":
            beside.update(kernel_ms=ro["kernel_ms"],
                          kernel_ms_m=rm["kernel_ms"])
        kernels.append(dict(
            name=f"{name}[fp32_d256]", **KERNELS[name], launches=c[name],
            max_abs_err=max(x["max_abs_err"][e] for e in errs
                            for x in (ro, rm, rn)),
            ms=ro[f"{part}_ms"], plain_ms=ro[f"{part}_plain_ms"],
            bound_ms=ro[f"{part}_bound_ms"], bound_by=ro[f"{part}_bound_by"],
            library_ms=ro[f"library_{part}_ms"], case=ro["case"],
            fma_ms=ro[f"{part}_fma_ms"],
            fma_bound_ms=ro[f"{part}_fma_bound_ms"],
            wall_ms=ro[f"{part}_wall_ms"], **beside,
            step_flash_ms=dense["profile"]["flash_ms"][name],
            step_median_ms=dense["median_step_ms"]))
    # sparse at head dim 256 (bf16 wgmma; the dK/dV kernel split over the
    # head dim): launches of phase 7b's forward+backward steps, numbers of
    # sparse case (g), phase 7b's call, with cases (e) (flash case (k)'s
    # shape), (f) (GQA, D = 136, ragged blocks) and (h) (QSA widths) beside
    # them, each key suffixed with its case; fma_ms the FMA kernels on the
    # same inputs, kernel_ms the kernels alone with the lists built
    # beforehand
    recs = {x: report["kernels"][f"sparse_{x}"] for x in "efgh"}
    rg = recs["g"]
    c = report["sparse_model_d256"]["launches"]
    for name, part, errs in (("sparse_fwd", "fwd", ("o", "lse")),
                             ("sparse_bwd", "bwd", ("dq", "dk", "dv"))):
        beside = {}
        for x in "efh":
            r = recs[x]
            beside.update({
                f"{key}_{x}": r[f"{part}_{key}"]
                for key in ("ms", "kernel_ms", "fma_ms", "plain_ms",
                            "bound_ms")})
            lib = "library" if f"library_{part}_ms" in r else "yardstick"
            beside[f"{lib}_ms_{x}"] = r[f"{lib}_{part}_ms"]
            beside[f"case_{x}"] = r["case"]
        kernels.append(dict(
            name=f"{name}[d256]", **KERNELS[name], launches=c[name],
            launches_tensor_core=c[f"{name}_tc"],
            max_abs_err=max(r["max_abs_err"][e] for e in errs
                            for r in recs.values()),
            ms=rg[f"{part}_ms"], plain_ms=rg[f"{part}_plain_ms"],
            bound_ms=rg[f"{part}_bound_ms"],
            bound_by=rg[f"{part}_bound_by"],
            library_ms=rg.get(f"library_{part}_ms"),
            yardstick_ms=rg.get(f"yardstick_{part}_ms"), case=rg["case"],
            kernel_ms=rg[f"{part}_kernel_ms"], fma_ms=rg[f"{part}_fma_ms"],
            wall_ms=rg[f"{part}_wall_ms"], **beside))
    # sparse in fp32 (3xTF32 wgmma, D <= 128): launches of phase 7d's
    # forward+backward steps, numbers of sparse case (i), phase 7d's call,
    # with cases (c) (GQA, ragged N, blocks of 64) and (j) (D = 128, blocks
    # 64 x 128, GQA, N_q != N_k) beside them, each key suffixed with its
    # case; fma_ms the FMA kernels on the same inputs with their bound at 67
    # TFLOP/s, kernel_ms the kernels alone with the lists built beforehand,
    # step_sparse_ms the sparse kernels' device time in phase 7d's profiled
    # step
    recs = {x: report["kernels"][f"sparse_{x}"] for x in "icj"}
    ri = recs["i"]
    s7d = report["sparse_model_fp32"]
    c = s7d["launches"]
    for name, part, errs in (("sparse_fwd", "fwd", ("o", "lse")),
                             ("sparse_bwd", "bwd", ("dq", "dk", "dv"))):
        beside = {}
        for x in "cj":
            r = recs[x]
            beside.update({
                f"{key}_{x}": r[f"{part}_{key}"]
                for key in ("ms", "kernel_ms", "fma_ms", "fma_bound_ms",
                            "plain_ms", "bound_ms")})
            lib = "library" if f"library_{part}_ms" in r else "yardstick"
            beside[f"{lib}_ms_{x}"] = r[f"{lib}_{part}_ms"]
            beside[f"case_{x}"] = r["case"]
        kernels.append(dict(
            name=f"{name}[fp32]", **KERNELS[name], launches=c[name],
            launches_tensor_core=c[f"{name}_tc"],
            max_abs_err=max(r["max_abs_err"][e] for e in errs
                            for r in recs.values()),
            ms=ri[f"{part}_ms"], plain_ms=ri[f"{part}_plain_ms"],
            bound_ms=ri[f"{part}_bound_ms"],
            bound_by=ri[f"{part}_bound_by"],
            library_ms=ri.get(f"library_{part}_ms"),
            yardstick_ms=ri.get(f"yardstick_{part}_ms"), case=ri["case"],
            kernel_ms=ri[f"{part}_kernel_ms"], fma_ms=ri[f"{part}_fma_ms"],
            fma_bound_ms=ri[f"{part}_fma_bound_ms"],
            wall_ms=ri[f"{part}_wall_ms"],
            kernel_split_ms=ri.get("kernel_split_ms"),
            step_sparse_ms=s7d["profile"]["sparse_kernels_ms"],
            step_median_ms=s7d["median_step_ms"], **beside))
    # sparse in fp32 at head dim 256 (the wide 3xTF32 kernels): launches of
    # phase 7e's forward+backward steps, numbers of sparse case (l), phase
    # 7e's call (MQA: the dK/dV kernel's query-head split and the sum of
    # its partials), with cases (k) (GQA 8/2, N = 1024, the shape of rows
    # 10g / 11g) and (m) (D = 136, blocks 64 x 128, GQA, N_q != N_k) beside
    # them, each key suffixed with its case; fma_ms the FMA kernels on the
    # same inputs with
    # their bound at 67 TFLOP/s, kernel_ms the kernels alone with the lists
    # built beforehand, step_sparse_ms the sparse kernels' device time in
    # phase 7e's profiled step
    recs = {x: report["kernels"][f"sparse_{x}"] for x in "lkm"}
    rl = recs["l"]
    s7e = report["sparse_model_d256_fp32"]
    c = s7e["launches"]
    for name, part, errs in (("sparse_fwd", "fwd", ("o", "lse")),
                             ("sparse_bwd", "bwd", ("dq", "dk", "dv"))):
        beside = {}
        for x in "km":
            r = recs[x]
            beside.update({
                f"{key}_{x}": r[f"{part}_{key}"]
                for key in ("ms", "kernel_ms", "fma_ms", "fma_bound_ms",
                            "plain_ms", "bound_ms") if f"{part}_{key}" in r})
            lib = "library" if f"library_{part}_ms" in r else "yardstick"
            beside[f"{lib}_ms_{x}"] = r[f"{lib}_{part}_ms"]
            beside[f"case_{x}"] = r["case"]
            beside[f"kernel_split_ms_{x}"] = r.get("kernel_split_ms")
        kernels.append(dict(
            name=f"{name}[fp32_d256]", **KERNELS[name], launches=c[name],
            launches_tensor_core=c[f"{name}_tc"],
            max_abs_err=max(r["max_abs_err"][e] for e in errs
                            for r in recs.values()),
            ms=rl[f"{part}_ms"], plain_ms=rl[f"{part}_plain_ms"],
            bound_ms=rl[f"{part}_bound_ms"],
            bound_by=rl[f"{part}_bound_by"],
            library_ms=rl.get(f"library_{part}_ms"),
            yardstick_ms=rl.get(f"yardstick_{part}_ms"), case=rl["case"],
            kernel_ms=rl[f"{part}_kernel_ms"], fma_ms=rl[f"{part}_fma_ms"],
            fma_bound_ms=rl[f"{part}_fma_bound_ms"],
            wall_ms=rl[f"{part}_wall_ms"],
            kernel_split_ms=rl.get("kernel_split_ms"),
            step_sparse_ms=s7e["profile"]["sparse_kernels_ms"],
            step_median_ms=s7e["median_step_ms"], **beside))
    # sparse in bf16 with blocks that are not multiples of 64 (the mma
    # kernels): launches of phase 7f's forward+backward steps, numbers of
    # sparse case (o), phase 7f's call, with cases (p) (blocks of 16 at D =
    # 128, GQA), (q) (phase 7b's MQA call at blocks of 32) and (r) (case
    # (f)'s edges at blocks 24 x 40) beside them, each key suffixed with its
    # case; fma_ms the FMA kernels on the same inputs, kernel_ms the kernels
    # alone with the lists built beforehand, step_sparse_ms the sparse
    # kernels' device time in phase 7f's profiled step
    recs = {x: report["kernels"][f"sparse_{x}"] for x in "opqr"}
    ro = recs["o"]
    s7f = report["sparse_model_b32"]
    c = s7f["launches"]
    for name, part, errs in (("sparse_fwd", "fwd", ("o", "lse")),
                             ("sparse_bwd", "bwd", ("dq", "dk", "dv"))):
        beside = {}
        for x in "pqr":
            r = recs[x]
            beside.update({
                f"{key}_{x}": r[f"{part}_{key}"]
                for key in ("ms", "kernel_ms", "fma_ms", "plain_ms",
                            "bound_ms")})
            lib = "library" if f"library_{part}_ms" in r else "yardstick"
            beside[f"{lib}_ms_{x}"] = r[f"{lib}_{part}_ms"]
            beside[f"case_{x}"] = r["case"]
            beside[f"kernel_split_ms_{x}"] = r.get("kernel_split_ms")
        kernels.append(dict(
            name=f"{name}[mma]", **KERNELS[name], launches=c[name],
            launches_mma=c[f"{name}_mma"],
            max_abs_err=max(r["max_abs_err"][e] for e in errs
                            for r in recs.values()),
            ms=ro[f"{part}_ms"], plain_ms=ro[f"{part}_plain_ms"],
            bound_ms=ro[f"{part}_bound_ms"],
            bound_by=ro[f"{part}_bound_by"],
            library_ms=ro.get(f"library_{part}_ms"),
            yardstick_ms=ro.get(f"yardstick_{part}_ms"), case=ro["case"],
            kernel_ms=ro[f"{part}_kernel_ms"], fma_ms=ro[f"{part}_fma_ms"],
            wall_ms=ro[f"{part}_wall_ms"],
            kernel_split_ms=ro.get("kernel_split_ms"),
            step_sparse_ms=s7f["profile"]["sparse_kernels_ms"],
            step_median_ms=s7f["median_step_ms"], **beside))
    # sparse in fp32 with blocks that are not multiples of 64 (the fp32 mma
    # kernels, 3xTF32): launches of phase 7g's forward+backward steps,
    # numbers of sparse case (s), phase 7g's call, with cases (n) (blocks
    # 96 x 80 at D = 256, GQA), (t) (phase 7e's MQA call at blocks of 32)
    # and (u) (case (r) in fp32) beside them, each key suffixed with its
    # case; fma_ms the FMA kernels on the same inputs with their bound at
    # 67 TFLOP/s, kernel_ms the kernels alone with the lists built
    # beforehand, step_sparse_ms the sparse kernels' device time in phase
    # 7g's profiled step
    recs = {x: report["kernels"][f"sparse_{x}"] for x in "sntu"}
    rs = recs["s"]
    s7g = report["sparse_model_b32_fp32"]
    c = s7g["launches"]
    for name, part, errs in (("sparse_fwd", "fwd", ("o", "lse")),
                             ("sparse_bwd", "bwd", ("dq", "dk", "dv"))):
        beside = {}
        for x in "ntu":
            r = recs[x]
            beside.update({
                f"{key}_{x}": r[f"{part}_{key}"]
                for key in ("ms", "kernel_ms", "fma_ms", "fma_bound_ms",
                            "plain_ms", "bound_ms")})
            lib = "library" if f"library_{part}_ms" in r else "yardstick"
            beside[f"{lib}_ms_{x}"] = r[f"{lib}_{part}_ms"]
            beside[f"case_{x}"] = r["case"]
            beside[f"kernel_split_ms_{x}"] = r.get("kernel_split_ms")
        kernels.append(dict(
            name=f"{name}[f32_mma]", **KERNELS[name], launches=c[name],
            launches_mma=c[f"{name}_mma"],
            max_abs_err=max(r["max_abs_err"][e] for e in errs
                            for r in recs.values()),
            ms=rs[f"{part}_ms"], plain_ms=rs[f"{part}_plain_ms"],
            bound_ms=rs[f"{part}_bound_ms"],
            bound_by=rs[f"{part}_bound_by"],
            library_ms=rs.get(f"library_{part}_ms"),
            yardstick_ms=rs.get(f"yardstick_{part}_ms"), case=rs["case"],
            kernel_ms=rs[f"{part}_kernel_ms"], fma_ms=rs[f"{part}_fma_ms"],
            fma_bound_ms=rs[f"{part}_fma_bound_ms"],
            wall_ms=rs[f"{part}_wall_ms"],
            kernel_split_ms=rs.get("kernel_split_ms"),
            step_sparse_ms=s7g["profile"]["sparse_kernels_ms"],
            step_median_ms=s7g["median_step_ms"], **beside))
    # Above head dim 256 (flash_wide.cu's chunked kernels): launches of
    # phase 5d's timed micro-steps (bf16) and of its fp32 card check;
    # numbers of flash case (p), phase 5d's call, where SDPA computes the
    # same function (its backend named), or (u) in fp32, with the D = 264,
    # 384, 1024 and GQA-with-every-feature cases beside them, each key
    # suffixed with its case
    for tag, c, main_case, beside_cases in (
            ("d512", report["train_d512"]["launches"], "p", "qrst"),
            ("fp32_d512", report["train_d512_fp32_vs_cpu"]["launches"], "u",
             "vwxy")):
        r = report["kernels"][f"flash_{main_case}"]
        for name, part, errs in (("flash_fwd", "fwd", ("o", "lse")),
                                 ("flash_bwd", "bwd", ("dq", "dk", "dv"))):
            beside = {}
            for x in beside_cases:
                rx = report["kernels"][f"flash_{x}"]
                lib = ("library" if f"library_{part}_ms" in rx
                       else "yardstick")
                beside.update({f"{key}_{x}": rx[f"{part}_{key}"]
                               for key in ("ms", "plain_ms", "bound_ms")})
                beside[f"{lib}_ms_{x}"] = rx[f"{lib}_{part}_ms"]
                beside[f"library_backend_{x}"] = rx["library_backend"]
                beside[f"max_abs_err_{x}"] = max(rx["max_abs_err"][e]
                                                 for e in errs)
                beside[f"case_{x}"] = rx["case"]
            kernels.append(dict(
                name=f"{name}[{tag}]", **KERNELS[f"{name}_wide"],
                launches=c[name],
                max_abs_err=max(r["max_abs_err"][e] for e in errs),
                ms=r[f"{part}_ms"], plain_ms=r[f"{part}_plain_ms"],
                bound_ms=r[f"{part}_bound_ms"],
                bound_by=r[f"{part}_bound_by"],
                library_ms=r[f"library_{part}_ms"],
                library_backend=r["library_backend"], case=r["case"],
                wall_ms=r[f"{part}_wall_ms"],
                kernel_split_ms=r.get("kernel_ms"), **beside))
    # Above head dim 256 on the sparse wide kernels: launches of phase 7x's
    # forward+backward steps (bf16) and of its fp32 card check; numbers of
    # sparse case (v), phase 7x's call, or (vf) in fp32 (that call at N =
    # 2048), with (w) (D = 264, GQA, blocks 96 x 80, an emptied row, an
    # LSE cotangent), (x) (MQA at blocks of 32) and (y) (D = 1024) in the
    # same dtype beside them, each key suffixed with its case; kernel_ms
    # the kernels alone with the lists built beforehand; SDPA with the
    # boolean mask (its backend named) the library call where every row
    # sees a key
    s7x = report["sparse_model_d512"]
    for tag, c, cases in (
            ("d512", s7x["launches"], ("v", "w", "x", "y")),
            ("fp32_d512", s7x["vs_cpu_fp32"]["launches"],
             ("vf", "wf", "xf", "yf"))):
        recs = {x: report["kernels"][f"sparse_{x}"] for x in cases}
        r = recs[cases[0]]
        for name, part, errs in (("sparse_fwd", "fwd", ("o", "lse")),
                                 ("sparse_bwd", "bwd", ("dq", "dk", "dv"))):
            beside = {}
            for x in cases[1:]:
                rx = recs[x]
                beside.update({f"{key}_{x}": rx[f"{part}_{key}"] for key in (
                    "ms", "kernel_ms", "plain_ms", "bound_ms")})
                lib = ("library" if f"library_{part}_ms" in rx
                       else "yardstick")
                beside[f"{lib}_ms_{x}"] = rx[f"{lib}_{part}_ms"]
                beside[f"library_backend_{x}"] = rx["library_backend"]
                beside[f"case_{x}"] = rx["case"]
                beside[f"kernel_split_ms_{x}"] = rx.get("kernel_split_ms")
            kernels.append(dict(
                name=f"{name}[{tag}]", **KERNELS[f"{name}_wide"],
                launches=c[name], launches_wide=c[f"{name}_wide"],
                max_abs_err=max(rx["max_abs_err"][e] for e in errs
                                for rx in recs.values()),
                ms=r[f"{part}_ms"], plain_ms=r[f"{part}_plain_ms"],
                bound_ms=r[f"{part}_bound_ms"],
                bound_by=r[f"{part}_bound_by"],
                library_ms=r.get(f"library_{part}_ms"),
                yardstick_ms=r.get(f"yardstick_{part}_ms"),
                library_backend=r["library_backend"], case=r["case"],
                kernel_ms=r[f"{part}_kernel_ms"],
                wall_ms=r[f"{part}_wall_ms"],
                kernel_split_ms=r.get("kernel_split_ms"),
                **({"step_sparse_ms": s7x["profile"]["sparse_kernels_ms"],
                    "step_median_ms": s7x["median_step_ms"]}
                   if tag == "d512" else {}), **beside))
    # The 8-bit forward above head dim 256 (fp8_wide.cu): launches of phase
    # 5bx's int8 and s8 arms; numbers of fp8 case (p), phase 5bx's int8
    # call, with the e4m3, e5m2, D = 264, D = 1024 and every-feature cases
    # (r)-(v) beside it, or (q), its s8 call; SDPA on the dequantized
    # inputs a yardstick (another function), its backend named
    f5bx = report["fa3_fp8_d512"]
    for tag, arm, main_case, beside_cases in (("d512", "int8", "p", "rstuv"),
                                              ("s8_d512", "int8_s8", "q", "")):
        r = report["kernels"][f"fp8_{main_case}"]
        c = f5bx[arm]["launches"]
        beside = {}
        for x in beside_cases:
            rx = report["kernels"][f"fp8_{x}"]
            beside.update({f"{key}_{x}": rx[key] for key in (
                "ms", "plain_ms", "bound_ms", "yardstick_ms",
                "yardstick_backend", "case")})
            beside[f"max_abs_err_{x}"] = max(rx["max_abs_err"].values())
        kernels.append(dict(
            name=f"flash_fwd_fp8[{tag}]", **KERNELS["flash_fwd_fp8_wide"],
            launches=c["flash_fwd_fp8"], launches_wide=c["flash_fwd_fp8_wide"],
            max_abs_err=max(r["max_abs_err"].values()), ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None,
            yardstick_ms=r["yardstick_ms"],
            yardstick_backend=r["yardstick_backend"], case=r["case"],
            path=r["route"], **beside))
    # the first paged kernel's chunked instantiation on phase 2's fp32
    # decode at D = 512 (fp32 q: no engine call takes it), beside the d512
    # decode row, whose first_ms is the same kernel on its bf16 inputs
    r32 = report["kernels"]["d512_decode_fp32"]
    for k in kernels:
        if k["name"] == "paged_attention[d512]":
            k.update({f"fp32_first_{key}": r32[key] for key in (
                "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err",
                "case")})
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
