"""Continuous-batching serving engine over the paged KV cache.

The counterpart of ``flashattention_tpu/serving/engine.py``. A host-side
scheduler (admission, page growth, completion, eviction) drives three
device programs:

- chunked prefill: a prompt in fixed-size chunks; each chunk's K/V go into
  its pages and its rows attend to the cache through the paged-attention
  kernel;
- the first-token epilogue: final layer norm and LM head on one row;
- batched decode: every decode slot advances one token; the new K/V go into
  the pages through the append kernel and attend through the paged kernel;
- speculative decoding (a draft model and ``EngineConfig(spec_gamma=g)``):
  the draft proposes g tokens for every slot over its own paged cache
  (:func:`spec_propose`), the target scores the (B, g+1) chunk in one
  batched pass through the same two kernels (:func:`verify_logits`), and
  each slot advances by its accepted prefix plus one token.

Inactive slots point at a reserved dump page with length 0, so the batched
decode keeps one shape; their outputs are discarded.

The engine runs on a CUDA device unless the caller asks for the CPU
(``device="cpu"``), where every kernel wrapper runs its plain version.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import math
import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from flashattention_tpu_torch.models.moe import moe_mlp
from flashattention_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    layer_norm,
    lm_head_logits,
    rope,
)
from flashattention_tpu_torch.ops.paged_attention import paged_attention
from flashattention_tpu_torch.ops.tiled import tiled_attention
from flashattention_tpu_torch.serving.allocator import PageAllocator
from flashattention_tpu_torch.serving.paged_kv import (
    PagedKVCache,
    append_to_pages,
    init_paged_cache,
)
from flashattention_tpu_torch.serving.sampling import (
    SamplingConfig,
    filter_logits,
    sample_logits,
    spec_accept_emit,
)
from flashattention_tpu_torch.utils.device import resolve_device


def _prefix_keys(prompt, n_pages: int, page_size: int) -> list[bytes]:
    """Chained digests of the first n_pages page-sized token chunks:
    key_i = sha1(key_{i-1} || tokens[i*psize:(i+1)*psize]), so equal keys
    mean equal prefixes (up to SHA-1 collision)."""
    arr = np.asarray(prompt, np.int32)
    keys: list[bytes] = []
    h = b""
    for i in range(n_pages):
        chunk = arr[i * page_size: (i + 1) * page_size].tobytes()
        h = hashlib.sha1(h + chunk).digest()
        keys.append(h)
    return keys


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_batch_size: int = 8        # decode slots
    page_size: int = 16
    num_pages: int = 512           # physical pages per layer
    max_seq_len: int = 512         # per-sequence cap
    prefill_pad: int = 64          # prefill chunk length
    quant: str | None = None       # None | "int8" | "fp8" | "e5m2" pages
    # int8 pages: the schedule of every paged-attention call, as the JAX
    # engine's FAT_PAGED_INT8_MXU: None the default rule ("qk" at decode,
    # convert for chunks), "qk" (or True), "full", False the convert path
    int8_qk: bool | str | None = None
    prefix_cache: bool = False     # share full prompt-prefix pages
    eos_token: int | None = None
    sampling: SamplingConfig | None = None  # None / temperature 0 = greedy
    seed: int = 0
    # Speculative decoding (needs draft_params/draft_cfg at construction):
    # every tick the draft proposes spec_gamma tokens per slot and the
    # target verifies them in one batched chunk.
    spec_gamma: int = 0

    @property
    def pages_per_seq(self) -> int:
        return -(-self.max_seq_len // self.page_size)


@dataclasses.dataclass
class GenerationRequest:
    request_id: int
    prompt: list[int]
    max_new_tokens: int = 32


@dataclasses.dataclass
class _Slot:
    request: GenerationRequest | None = None
    length: int = 0
    generated: list[int] = dataclasses.field(default_factory=list)
    freed_pages: int = 0  # logical pages reclaimed below the sliding window


# ---------------------------------------------------------------------------
# Model programs over the paged cache
# ---------------------------------------------------------------------------


def _serving_weights(params: Transformer, cfg: TransformerConfig, device):
    """The weights as the programs use them: projections and embeddings in
    the compute dtype (cast once here instead of every call), layer norms
    and the LM head in float32."""

    def cast(t):
        return t.detach().to(device=device, dtype=cfg.dtype)

    def f32(t):
        return t.detach().to(device=device, dtype=torch.float32)

    def ln(p):
        return SimpleNamespace(g=f32(p.g), b=f32(p.b))

    def attn(a):
        if cfg.fused_qkv:
            w_qkv, b_qkv = a.w_qkv, a.b_qkv
        else:  # separate projections: fused once here, same columns
            w_qkv = torch.cat([a.w_q, a.w_k, a.w_v], dim=1)
            b_qkv = torch.cat([a.b_q, a.b_k, a.b_v])
        return SimpleNamespace(w_qkv=cast(w_qkv), b_qkv=cast(b_qkv),
                               w_o=cast(a.w_o), b_o=cast(a.b_o))

    def mlp(m):  # an MoE router stays float32, as moe_mlp computes in it
        names = ("w_in", "b_in", "w_out", "b_out")
        out = SimpleNamespace(**{n: cast(getattr(m, n)) for n in names})
        if hasattr(m, "router"):
            out.router = f32(m.router)
        return out

    blocks = [
        SimpleNamespace(
            attn=attn(bp.attn),
            mlp=mlp(bp.mlp),
            ln1=ln(bp.ln1),
            ln2=ln(bp.ln2),
        )
        for bp in params.blocks
    ]
    return SimpleNamespace(
        tok_emb=cast(params.tok_emb),
        pos_emb=cast(params.pos_emb) if params.pos_emb is not None else None,
        blocks=blocks,
        final_ln=ln(params.final_ln),
        lm_head=SimpleNamespace(w=f32(params.lm_head.w), b=f32(params.lm_head.b)),
        emb_scale=torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype,
                               device=device),
    )


def _qkv(x, a, cfg):
    b, n, _ = x.shape
    h, h_kv, dh = cfg.n_heads, cfg.kv_heads, cfg.d_head
    qkv = x @ a.w_qkv + a.b_qkv
    q, k, v = torch.split(qkv, [h * dh, h_kv * dh, h_kv * dh], dim=-1)

    def to_heads(t, nh):
        return t.reshape(b, n, nh, dh).transpose(1, 2)

    return to_heads(q, h), to_heads(k, h_kv), to_heads(v, h_kv)


def _proj_out(o, a):
    b, h, n, dh = o.shape  # (B, H, N, dh) -> (B, N, D)
    return o.transpose(1, 2).reshape(b, n, h * dh) @ a.w_o + a.b_o


def _mlp(x, m, cfg):
    """The MLP of every serving pass (prefill chunks, decode, the
    speculative verify): dense, or the mixture routed dropless, so that a
    token's experts never depend on the other tokens of its pass."""
    if hasattr(m, "router"):
        return moe_mlp(x, m, cfg, dropless=True)[0]
    return F.gelu(x @ m.w_in + m.b_in, approximate="tanh") @ m.w_out + m.b_out


def _embed(w, tokens, cfg, position0: int):
    x = w.tok_emb[tokens] * w.emb_scale
    if cfg.pos_encoding == "learned":
        # Per-row clipped gather: a padded chunk may overrun the table; only
        # its padding rows read the clipped last row.
        ids = torch.clamp(
            position0 + torch.arange(tokens.shape[1], device=tokens.device),
            0, w.pos_emb.shape[0] - 1,
        )
        x = x + w.pos_emb[ids]
    return x


def _embed_positions(w, tokens, cfg, pos):
    """Embed tokens (B, T) at positions (B, T). Positions past the table
    read its last row, as JAX's gather clamps: a draft or verify row near
    max_seq_len may overrun it, and such a row is never accepted."""
    x = w.tok_emb[tokens] * w.emb_scale
    if cfg.pos_encoding == "learned":
        x = x + w.pos_emb[torch.clamp(pos.long(), max=w.pos_emb.shape[0] - 1)]
    return x


def _embed_decode(w, tokens, cfg, lengths):
    return _embed_positions(w, tokens, cfg, lengths[:, None])


def _maybe_rope(q, k, cfg, pos):
    if cfg.pos_encoding != "rope":
        return q, k
    return rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta)


def _attn_kwargs(cfg, cache: PagedKVCache):
    """Paged-attention arguments of one layer: the model's, and the scale
    planes and int8 schedule of a quantized cache (the compute type is then
    q's dtype)."""
    return dict(k_scales=cache.k_scales, v_scales=cache.v_scales,
                softmax_scale=cfg.softmax_scale, window=cfg.attention_window,
                softcap=cfg.attn_softcap, sinks=cfg.attention_sinks,
                int8_qk=cache.int8_qk)


def chunk_prefill(w, cfg, caches: list[PagedKVCache], tokens, page_row,
                  base: int, valid: int):
    """One prefill chunk: tokens (1, C) at positions base.., of which the
    first ``valid`` are real. Appends their K/V into the pages, attends each
    row causally through the paged kernel with lengths = base + C (rows past
    ``valid`` are padding, their outputs unused), returns x (1, C, D)."""
    b, c = tokens.shape
    dev = tokens.device
    x = _embed(w, tokens, cfg, base)
    base_b = torch.full((b,), base, dtype=torch.int32, device=dev)
    valid_b = torch.full((b,), valid, dtype=torch.int32, device=dev)
    lengths = base_b + c
    pos = base + torch.arange(c, device=dev)
    for bp, cache in zip(w.blocks, caches):
        q, k, v = _qkv(x, bp.attn, cfg)
        q, k = _maybe_rope(q, k, cfg, pos)
        append_to_pages(cache, k, v, page_row, base_b, valid_len=valid_b)
        o = paged_attention(q.contiguous(), cache.k_pages, cache.v_pages,
                            page_row, lengths, **_attn_kwargs(cfg, cache))
        x = layer_norm(x + _proj_out(o, bp.attn), bp.ln1)
        x = layer_norm(x + _mlp(x, bp.mlp, cfg), bp.ln2)
    return x


def last_logits(w, x, idx: int):
    """float32 logits (1, V) of row ``idx`` after the final layer norm."""
    x = layer_norm(x[:, idx: idx + 1], w.final_ln)
    return lm_head_logits(w.lm_head, x)[:, 0]


def _decode_hidden(w, cfg, caches: list[PagedKVCache], tokens, page_indices,
                   lengths):
    """The layers of one batched decode step: x (B, 1, D) before the final
    layer norm."""
    x = _embed_decode(w, tokens, cfg, lengths)
    pos = lengths[:, None]
    attended = lengths + 1
    for bp, cache in zip(w.blocks, caches):
        q, k, v = _qkv(x, bp.attn, cfg)  # (B, H, 1, dh)
        q, k = _maybe_rope(q, k, cfg, pos)
        append_to_pages(cache, k, v, page_indices, lengths)
        o = paged_attention(q[:, :, 0].contiguous(), cache.k_pages,
                            cache.v_pages, page_indices, attended,
                            **_attn_kwargs(cfg, cache))
        x = layer_norm(x + _proj_out(o[:, :, None], bp.attn), bp.ln1)
        x = layer_norm(x + _mlp(x, bp.mlp, cfg), bp.ln2)
    return x


def decode_logits(w, cfg, caches: list[PagedKVCache], tokens, page_indices,
                  lengths):
    """One batched decode step: tokens (B, 1) at positions ``lengths``
    (B,) -> float32 logits (B, V). The new K/V land at ``lengths`` and each
    slot attends to lengths + 1 entries."""
    x = _decode_hidden(w, cfg, caches, tokens, page_indices, lengths)
    x = layer_norm(x, w.final_ln)
    return lm_head_logits(w.lm_head, x)[:, 0]


def spec_propose(w, cfg, caches: list[PagedKVCache], tokens, page_indices,
                 lengths, gamma: int, *,
                 sampling: SamplingConfig | None = None,
                 generator: torch.Generator | None = None):
    """The draft's proposal over its paged cache: gamma + 1 one-token
    decode steps at ``lengths + i`` from tokens (B, 1), each step's token
    feeding the next on the device (no host read). The last step only
    writes d_gamma's K/V, so the draft cache covers the longest prefix the
    target can accept.

    Returns (proposals (B, gamma), q_dist). Greedy (``sampling`` None or
    temperature 0): each step takes the argmax and q_dist is None.
    Stochastic: each step draws from its filtered distribution with
    ``generator``, and q_dist (B, gamma, V) holds those distributions, the
    q of the acceptance test."""
    stochastic = sampling is not None and not sampling.greedy
    toks, dists = [], []
    tok = tokens
    for i in range(gamma):
        logits = decode_logits(w, cfg, caches, tok, page_indices, lengths + i)
        if stochastic:
            probs = torch.softmax(filter_logits(logits, sampling), dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)
            dists.append(probs)
        else:
            tok = torch.argmax(logits, dim=-1, keepdim=True)
        toks.append(tok)
    _decode_hidden(w, cfg, caches, tok, page_indices, lengths + gamma)
    q_dist = torch.stack(dists, dim=1) if stochastic else None
    return torch.cat(toks, dim=1), q_dist


def verify_logits(w, cfg, caches: list[PagedKVCache], tokens, page_indices,
                  lengths):
    """The target's verify pass: tokens (B, T) [last token, d_1..d_{T-1}]
    at positions ``lengths + t`` -> float32 logits (B, T, V); row t scores
    position lengths + t + 1. The chunk's K/V land at ``lengths`` (tokens
    past a sequence's page capacity are dropped) and the paged kernel
    attends with lengths + T, which puts row t at lengths + t."""
    b, t = tokens.shape
    pos = lengths.long()[:, None] + torch.arange(t, device=tokens.device)
    x = _embed_positions(w, tokens, cfg, pos)
    attended = lengths + t
    for bp, cache in zip(w.blocks, caches):
        q, k, v = _qkv(x, bp.attn, cfg)  # (B, H, T, dh)
        q, k = _maybe_rope(q, k, cfg, pos)
        append_to_pages(cache, k, v, page_indices, lengths)
        o = paged_attention(q.contiguous(), cache.k_pages, cache.v_pages,
                            page_indices, attended, **_attn_kwargs(cfg, cache))
        x = layer_norm(x + _proj_out(o, bp.attn), bp.ln1)
        x = layer_norm(x + _mlp(x, bp.mlp, cfg), bp.ln2)
    x = layer_norm(x, w.final_ln)
    return lm_head_logits(w.lm_head, x)


def prefill(w, cfg, caches: list[PagedKVCache], tokens, page_indices,
            prompt_len: int):
    """Whole-prompt prefill through the tiled executor (not the engine's
    path, which prefills in chunks through the paged kernel): tokens
    (1, Tp) of which the first ``prompt_len`` are real; their K/V go into
    the pages from position 0 and the prompt attends causally to itself.
    Returns the greedy next token (1,)."""
    b, tp = tokens.shape
    dev = tokens.device
    x = _embed(w, tokens, cfg, 0)
    rows = torch.arange(tp, device=dev)[:, None]
    cols = torch.arange(tp, device=dev)[None, :]
    mask = (cols <= rows) & (cols < prompt_len)
    if cfg.attention_window is not None:
        band = cols > rows - cfg.attention_window
        if cfg.attention_sinks:
            band = band | (cols < cfg.attention_sinks)
        mask = mask & band
    zero = torch.zeros((b,), dtype=torch.int32, device=dev)
    valid = torch.full((b,), prompt_len, dtype=torch.int32, device=dev)
    pos = torch.arange(tp, device=dev)
    groups = cfg.n_heads // cfg.kv_heads
    for bp, cache in zip(w.blocks, caches):
        q, k, v = _qkv(x, bp.attn, cfg)
        q, k = _maybe_rope(q, k, cfg, pos)
        append_to_pages(cache, k, v, page_indices, zero, valid_len=valid)
        if groups > 1:  # GQA: expand for the executor
            k = k.repeat_interleave(groups, dim=1)
            v = v.repeat_interleave(groups, dim=1)
        o, _ = tiled_attention(q, k, v, softmax_scale=cfg.softmax_scale,
                               block_k=min(cfg.block_size, tp), mask=mask,
                               softcap=cfg.attn_softcap)
        x = layer_norm(x + _proj_out(o, bp.attn), bp.ln1)
        x = layer_norm(x + _mlp(x, bp.mlp, cfg), bp.ln2)
    logits = last_logits(w, x, prompt_len - 1)
    return torch.argmax(logits, dim=-1)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class ServingEngine:
    def __init__(
        self,
        params: Transformer,
        cfg: TransformerConfig,
        ecfg: EngineConfig,
        *,
        device=None,
        native_allocator: bool | None = None,
        draft_params=None,
        draft_cfg: TransformerConfig | None = None,
    ):
        # Speculative decoding: the draft keeps its own page pools (one per
        # draft layer) but shares the target's page tables, so one
        # allocator chain addresses both models' caches.
        self.spec = draft_params is not None
        if self.spec:
            if draft_cfg is None:
                raise ValueError("draft_params requires draft_cfg")
            if ecfg.spec_gamma < 1:
                raise ValueError(f"speculative engine needs spec_gamma >= 1, "
                                 f"got {ecfg.spec_gamma}")
            if cfg.vocab_size != draft_cfg.vocab_size:
                raise ValueError("target and draft must share a vocabulary")
        elif ecfg.spec_gamma:
            raise ValueError("spec_gamma > 0 requires draft_params/draft_cfg")
        if ecfg.int8_qk not in (None, True, False, "qk", "full"):
            raise ValueError(f"int8_qk must be None, a bool, 'qk' or 'full', "
                             f"got {ecfg.int8_qk!r}")
        if ecfg.prefix_cache and cfg.attention_window is not None:
            raise ValueError(
                "prefix_cache cannot combine with attention_window: window "
                "reclamation frees prefix pages other requests may share"
            )
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ecfg = ecfg
        self.weights = _serving_weights(params, cfg, self.device)
        self.caches = [
            init_paged_cache(cfg.kv_heads, ecfg.num_pages, ecfg.page_size,
                             cfg.d_head, quant=ecfg.quant, dtype=cfg.dtype,
                             device=self.device, int8_qk=ecfg.int8_qk)
            for _ in range(cfg.n_layers)
        ]
        if self.spec:
            # A prefix-cache page is pinned and both models write their
            # pools during the prefill that filled it, so an adopted page
            # holds the draft's K/V too.
            self.draft_cfg = draft_cfg
            self.draft_weights = _serving_weights(draft_params, draft_cfg,
                                                  self.device)
            self.draft_caches = [
                init_paged_cache(draft_cfg.kv_heads, ecfg.num_pages,
                                 ecfg.page_size, draft_cfg.d_head,
                                 quant=ecfg.quant, dtype=draft_cfg.dtype,
                                 device=self.device, int8_qk=ecfg.int8_qk)
                for _ in range(draft_cfg.n_layers)
            ]
            self.spec_proposed = 0
            self.spec_accepted = 0
            self.spec_rounds = 0
        self.allocator = PageAllocator(ecfg.num_pages, native=native_allocator)
        # Prefix cache: prompt-prefix digest -> physical page, LRU order.
        # Every cached page holds one allocator pin.
        self._prefix_lru: collections.OrderedDict[bytes, int] = (
            collections.OrderedDict()
        )
        # The dump page: inactive decode slots and dead window positions.
        # It holds one page for good, so admission (below) rejects a request
        # that needs more than num_pages - 1 pages (the JAX engine checks
        # against the whole pool and livelocks on one that needs exactly
        # num_pages).
        if not self.allocator.grow(-1, 1):
            raise RuntimeError("page pool too small for the dump page")
        self.dump_page = self.allocator.pages(-1)[0]
        self.slots = [_Slot() for _ in range(ecfg.max_batch_size)]
        self.waiting: list[GenerationRequest] = []
        self.finished: dict[int, list[int]] = {}
        # Tokens already emitted by requests evicted mid-flight and requeued.
        self._evicted_prefix: dict[int, list[int]] = {}
        self._stochastic = (
            ecfg.sampling is not None and not ecfg.sampling.greedy
        )
        self._gen = torch.Generator(device=self.device).manual_seed(ecfg.seed)
        # Work done, for throughput: prefill chunks and prompt tokens run,
        # decode steps (or speculative ticks, and the busy slots summed over
        # them) and the tokens they produced, and the host seconds each
        # phase took (prefill_s, decode_s, spec_s; each ends by reading its
        # tokens back, so the device work is inside).
        self.stats = collections.Counter()
        # float32 logits (1, V) of the last admitted request's first token.
        self.last_prefill_logits: torch.Tensor | None = None

    # -- public API --------------------------------------------------------

    def submit(self, request: GenerationRequest) -> None:
        self.waiting.append(request)

    def run(self, max_steps: int = 10_000) -> dict[int, list[int]]:
        """Drive until all submitted work completes; returns
        {request_id: generated tokens}."""
        while (self.waiting or self._num_active()) and max_steps > 0:
            self.step()
            max_steps -= 1
        return dict(self.finished)

    def step(self) -> None:
        """One scheduler tick: admit -> batched decode -> retire."""
        self._admit()
        if self._num_active():
            if self.spec:
                self._spec_decode_once()
            else:
                self._decode_once()

    # -- internals ----------------------------------------------------------

    def _num_active(self) -> int:
        return sum(s.request is not None for s in self.slots)

    def _pages_needed(self, length: int) -> int:
        return -(-length // self.ecfg.page_size)

    def _select(self, logits: torch.Tensor) -> torch.Tensor:
        if self._stochastic:
            return sample_logits(logits, self._gen, self.ecfg.sampling)
        return torch.argmax(logits, dim=-1)

    def _admit(self) -> None:
        for slot in self.slots:
            if slot.request is not None or not self.waiting:
                continue
            req = self.waiting[0]
            prompt_len = len(req.prompt)
            if (
                prompt_len == 0
                or prompt_len + req.max_new_tokens > self.ecfg.max_seq_len
            ):
                self.waiting.pop(0)
                self.finished[req.request_id] = []  # rejected: empty/too long
                continue
            # Prefix-cache reuse: adopt the longest cached run of full prompt
            # pages (at least one token still prefills, for the sampler).
            psize = self.ecfg.page_size
            shared = 0
            if self.ecfg.prefix_cache:
                max_shared = (prompt_len - 1) // psize
                keys = _prefix_keys(req.prompt, max_shared, psize)
                pages_shared: list[int] = []
                while shared < max_shared:
                    page = self._prefix_lru.get(keys[shared])
                    if page is None:
                        break
                    self._prefix_lru.move_to_end(keys[shared])
                    pages_shared.append(page)
                    shared += 1
                if pages_shared and not self.allocator.adopt(
                    req.request_id, pages_shared
                ):
                    shared = 0  # unreachable while entries hold pins
            # all-or-nothing page reservation for prompt + one decode token
            need_total = self._pages_needed(prompt_len + 1)
            if need_total > self.allocator.num_pages - 1:
                # Larger than the pool less the dump page: no eviction can
                # ever make room, and waiting[0] would block everything
                # behind it.
                self.waiting.pop(0)
                self.allocator.release(req.request_id)  # undo adoption
                self.finished[req.request_id] = []  # rejected: can't fit
                continue
            if not self.allocator.grow(req.request_id, need_total):
                # Pool pressure: drop LRU prefix-cache pins, then retry.
                self._shrink_prefix_cache(need_total - shared)
                if not self.allocator.grow(req.request_id, need_total):
                    self.allocator.release(req.request_id)  # undo adoption
                    return  # out of pages: retry next tick (backpressure)
            self.waiting.pop(0)
            slot.request = req
            slot.length = prompt_len
            slot.generated = []

            # Chunked prefill; a shared prefix is skipped.
            t0 = time.perf_counter()
            chunk = self.ecfg.prefill_pad
            page_row = self._page_row(req.request_id)[None]
            x = None
            start = shared * psize
            last_base = start
            for base in range(start, prompt_len, chunk):
                valid = min(chunk, prompt_len - base)
                toks = np.zeros((1, chunk), np.int64)
                toks[0, :valid] = req.prompt[base: base + valid]
                toks_d = torch.from_numpy(toks).to(self.device)
                x = chunk_prefill(self.weights, self.cfg, self.caches, toks_d,
                                  page_row, base, valid)
                if self.spec:
                    # the draft prefills the same chunks into its own pools
                    chunk_prefill(self.draft_weights, self.draft_cfg,
                                  self.draft_caches, toks_d, page_row, base,
                                  valid)
                last_base = base
                self.stats["prefill_chunks"] += 1
                self.stats["prefill_tokens"] += valid
            if self.ecfg.prefix_cache:
                self._register_prefix(req)
            logits = last_logits(self.weights, x, prompt_len - 1 - last_base)
            self.last_prefill_logits = logits
            slot.generated.append(int(self._select(logits)[0]))
            self.stats["prefill_s"] += time.perf_counter() - t0
            slot.length = prompt_len  # cache holds the prompt only
            self._reclaim_window(slot)
            self._maybe_finish(slot)

    def _page_row(self, seq_id: int | None, freed: int = 0) -> torch.Tensor:
        """Logical page p lives at row position p: a reclaimed range
        (sliding window) shifts the physical chain up by ``freed`` after
        the sink pages; the dead positions keep the dump page and are
        never visited (the kernel's page walk covers sinks + band)."""
        return torch.from_numpy(self._page_row_np(seq_id, freed)).to(self.device)

    def _page_row_np(self, seq_id: int | None, freed: int = 0) -> np.ndarray:
        row = np.full((self.ecfg.pages_per_seq,), self.dump_page, np.int32)
        if seq_id is not None:
            pages = self.allocator.pages(seq_id)
            keep = 0
            if freed and self.cfg.attention_sinks:
                keep = -(-self.cfg.attention_sinks // self.ecfg.page_size)
                row[:keep] = pages[:keep]
            row[keep + freed: keep + freed + len(pages) - keep] = pages[keep:]
        return row

    def _batch(self, ahead: int):
        """The batch of one tick: every busy slot's chain grown to hold
        positions ``length`` .. ``length + ahead`` (0 for a decode step,
        spec_gamma for a speculative tick; at most the sequence's page
        capacity: writes past it are dropped and never accepted). Returns
        tokens (B, 1), page rows (B, pps) and lengths (B,) on the device;
        idle slots, and a slot evicted here, attend nothing on the dump
        page."""
        B = self.ecfg.max_batch_size
        tokens = np.zeros((B, 1), np.int64)
        lengths = np.zeros((B,), np.int32)
        page_rows = []
        for i, slot in enumerate(self.slots):
            if slot.request is None:
                page_rows.append(self._page_row_np(None))
                continue
            # the physical chain is shorter by the reclaimed window prefix
            rid = slot.request.request_id
            need = min(self._pages_needed(slot.length + ahead + 1),
                       self.ecfg.pages_per_seq) - slot.freed_pages
            if not self.allocator.grow(rid, need):
                # Drop LRU prefix-cache pins before evicting a sequence: as
                # many as the pages missing (a speculative grow can miss
                # several), then evict (release + requeue).
                deficit = need - len(self.allocator.pages(rid))
                self._shrink_prefix_cache(max(1, deficit))
                if not self.allocator.grow(rid, need):
                    self._evict(slot)
                    page_rows.append(self._page_row_np(None))
                    continue
            tokens[i, 0] = slot.generated[-1]
            lengths[i] = slot.length
            page_rows.append(self._page_row_np(rid, slot.freed_pages))
        return (torch.from_numpy(tokens).to(self.device),
                torch.from_numpy(np.stack(page_rows)).to(self.device),
                torch.from_numpy(lengths).to(self.device))

    def _decode_once(self) -> None:
        t0 = time.perf_counter()
        logits = decode_logits(self.weights, self.cfg, self.caches,
                               *self._batch(0))
        next_np = self._select(logits).cpu().numpy()
        self.stats["decode_steps"] += 1
        self.stats["decode_s"] += time.perf_counter() - t0
        for i, slot in enumerate(self.slots):
            if slot.request is None:
                continue
            self.stats["decode_tokens"] += 1
            slot.length += 1  # the fed token is now in cache
            slot.generated.append(int(next_np[i]))
            self._reclaim_window(slot)
            self._maybe_finish(slot)

    def _spec_decode_once(self) -> None:
        """One speculative tick: the draft proposes ``spec_gamma`` tokens
        per slot over its paged cache, the target scores the whole
        [last, d_1..d_g] chunk in one batched pass, and each slot advances
        by its accepted prefix plus one token. Greedy emission is the
        target's own greedy continuation.

        Rollback is free: cache entries past the accepted prefix are not
        counted in ``slot.length`` and the next tick overwrites them."""
        t0 = time.perf_counter()
        g = self.ecfg.spec_gamma
        tok, pi, ln = self._batch(g)
        drafts, q_dist = spec_propose(
            self.draft_weights, self.draft_cfg, self.draft_caches, tok, pi,
            ln, g, sampling=self.ecfg.sampling, generator=self._gen)
        logits = verify_logits(self.weights, self.cfg, self.caches,
                               torch.cat([tok, drafts], dim=1), pi, ln)
        if q_dist is not None:  # stochastic: the acceptance test on device
            p_dist = torch.softmax(filter_logits(logits, self.ecfg.sampling),
                                   dim=-1)
            a_dev, emit = spec_accept_emit(p_dist, q_dist, drafts, self._gen)
            host = torch.cat([a_dev[:, None].to(emit.dtype), emit],
                             dim=1).cpu().numpy()  # one read back
            a_np, t_np, d_np = host[:, 0], host[:, 1:], None
        else:
            # row j: the target's greedy token for position lengths + j + 1
            host = torch.cat([drafts, torch.argmax(logits, dim=-1)],
                             dim=1).cpu().numpy()  # one read back
            a_np, d_np, t_np = None, host[:, :g], host[:, g:]
        self.spec_rounds += 1
        self.stats["spec_ticks"] += 1
        self.stats["spec_slot_ticks"] += self._num_active()
        self.stats["spec_s"] += time.perf_counter() - t0
        for i, slot in enumerate(self.slots):
            if slot.request is None:
                continue
            if a_np is not None:
                a = int(a_np[i])
                emitted = [int(t) for t in t_np[i, : a + 1]]
            else:
                a = 0
                while a < g and t_np[i, a] == d_np[i, a]:
                    a += 1
                emitted = [int(t) for t in d_np[i, :a]]
                emitted.append(int(t_np[i, a]))  # correction or bonus
            remaining = slot.request.max_new_tokens - len(slot.generated)
            emitted = emitted[:remaining]
            eos = self.ecfg.eos_token
            if eos is not None and eos in emitted:
                emitted = emitted[: emitted.index(eos) + 1]
            # Counted as the JAX engine counts them: proposals that could
            # have landed (at most ``remaining``), and accepted draft tokens
            # that were emitted.
            self.spec_proposed += min(g, remaining)
            self.spec_accepted += min(a, len(emitted))
            self.stats["decode_tokens"] += len(emitted)
            slot.length += len(emitted)
            slot.generated.extend(emitted)
            self._reclaim_window(slot)
            self._maybe_finish(slot)

    def _register_prefix(self, req: GenerationRequest) -> None:
        """Pin this prompt's full pages into the prefix cache (LRU); each
        new entry takes one allocator pin so the page outlives the
        sequence that computed it."""
        psize = self.ecfg.page_size
        n_full = len(req.prompt) // psize
        chain = self.allocator.pages(req.request_id)
        n = min(n_full, len(chain))
        keys = _prefix_keys(req.prompt, n, psize)
        for i in range(n):
            key = keys[i]
            if key in self._prefix_lru:
                self._prefix_lru.move_to_end(key)
                continue
            if self.allocator.pin(chain[i]) > 0:
                self._prefix_lru[key] = chain[i]

    def _shrink_prefix_cache(self, pages_needed: int) -> None:
        """Drop LRU cache pins until the free pool can satisfy the request
        (or the cache is empty)."""
        while (
            self._prefix_lru
            and self.allocator.free_pages() < pages_needed
        ):
            _, page = self._prefix_lru.popitem(last=False)
            self.allocator.unpin(page)

    def _reclaim_window(self, slot: _Slot) -> None:
        """Free pages wholly below the sliding-window band (every later read
        starts at slot ``length - window + 1`` or higher)."""
        w = self.cfg.attention_window
        if w is None or slot.request is None:
            return
        psize = self.ecfg.page_size
        sink_pages = (
            -(-self.cfg.attention_sinks // psize)
            if self.cfg.attention_sinks else 0
        )
        first_needed = max(0, (slot.length - w + 1)) // psize
        freeable = first_needed - sink_pages - slot.freed_pages
        if freeable > 0:
            if sink_pages:
                # Keep the sink pages at the chain head.
                freed = self.allocator.release_range(
                    slot.request.request_id, sink_pages, freeable
                )
            else:
                freed = self.allocator.release_prefix(
                    slot.request.request_id, freeable
                )
            slot.freed_pages += freed

    def _maybe_finish(self, slot: _Slot) -> None:
        req = slot.request
        done_len = len(slot.generated) >= req.max_new_tokens
        done_eos = (
            self.ecfg.eos_token is not None
            and slot.generated
            and slot.generated[-1] == self.ecfg.eos_token
        )
        if done_len or done_eos:
            prefix = self._evicted_prefix.pop(req.request_id, [])
            self.finished[req.request_id] = prefix + list(slot.generated)
            self.allocator.release(req.request_id)
            slot.request = None
            slot.generated = []
            slot.length = 0
            slot.freed_pages = 0

    def _evict(self, slot: _Slot) -> None:
        """Release the slot's pages and requeue its request from scratch;
        the new prompt carries every emitted token but the last, whose
        successor the requeued run derives again, and the emitted tokens
        are banked for the final result."""
        req = slot.request
        self.allocator.release(req.request_id)
        done = list(slot.generated[:-1])
        self._evicted_prefix[req.request_id] = (
            self._evicted_prefix.get(req.request_id, []) + done
        )
        self.waiting.append(
            GenerationRequest(
                request_id=req.request_id,
                prompt=list(req.prompt) + done,
                max_new_tokens=req.max_new_tokens - len(done),
            )
        )
        slot.request = None
        slot.generated = []
        slot.length = 0
        slot.freed_pages = 0
