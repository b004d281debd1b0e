"""Pipeline parallelism: GPipe over the mesh's ``pipe`` axis.

The counterpart of ``flashattention_tpu/parallel/pipeline.py``. The L
blocks split into S = ``pipe`` contiguous stages of L / S blocks; pipe rank
s holds stage s. A batch is cut into M microbatches (and each microbatch's
rows over ``data``, as the JAX package cuts them). The forward runs the
GPipe schedule: stage 0 embeds a microbatch, every stage runs its blocks
and sends the activation to the next with ``dist.send``; the last stage's
outputs go to every pipe rank (``dist.broadcast``), where the final layer
norm and the LM head run, so embedding and head parameters are replicated
over ``pipe`` as in the JAX package. The backward is written by hand (the
JAX package lets AD transpose its ``ppermute``): after the head's backward,
each stage, microbatch by microbatch in reverse, calls
``torch.autograd.backward`` on the outputs it kept with the gradient from
the next stage and sends its input's gradient back. The embedding's
gradient, which only stage 0 computes, is summed over ``pipe``; every
gradient is averaged over ``data``.

The MoE load-balance loss is the JAX package's per-microbatch estimator:
each stage's layers' aux on each microbatch, summed over microbatches / M,
summed over ``pipe``, averaged over ``data``.

Dropout draws per-(microbatch, layer) seeds from the step's seed, another
stream than the dense forward's, as in the JAX package: parity with the
dense model holds with dropout 0.
"""

from __future__ import annotations

import copy
import functools

import numpy as np
import torch
import torch.distributed as dist

from flashattention_tpu_torch.models.train import token_nll
from flashattention_tpu_torch.models.transformer import (
    Block,
    Transformer,
    _block,
    _dropout,
    _embed,
    _Params,
    _remat,
    layer_norm,
    lm_head_logits,
)
from flashattention_tpu_torch.parallel.mesh import axis_size
from flashattention_tpu_torch.parallel.sharded import (
    ShardedOptimizer,
    all_reduce_grads,
)

_BLOCK_PARTS = ("attn", "ln1", "mlp", "ln2")


# ---------------------------------------------------------------------------
# Parameter stacking: blocks <-> (S, L / S, ...) stage leaves
# ---------------------------------------------------------------------------


def stack_pipeline_params(params: Transformer, n_stages: int) -> dict:
    """``{"embed": {...}, "stages": {...}, "head": {...}}``: every stage leaf
    is the blocks' leaf stacked to (S, L / S, *shape), named as in the JAX
    package (``stages["attn"]["w_qkv"]``, ...)."""
    blocks = list(params.blocks)
    if len(blocks) % n_stages:
        raise ValueError(f"n_layers={len(blocks)} not divisible by "
                         f"n_stages={n_stages}")
    lps = len(blocks) // n_stages
    stages = {
        part: {name: torch.stack([getattr(getattr(b, part), name).detach()
                                  for b in blocks]).reshape(
                   (n_stages, lps) + tuple(getattr(getattr(blocks[0], part),
                                                   name).shape))
               for name, _ in getattr(blocks[0], part).named_parameters()}
        for part in _BLOCK_PARTS
    }
    embed = {"tok_emb": params.tok_emb.detach()}
    if params.pos_emb is not None:
        embed["pos_emb"] = params.pos_emb.detach()
    head = {"final_ln": {n: p.detach() for n, p in
                         params.final_ln.named_parameters()},
            "lm_head": {n: p.detach() for n, p in
                        params.lm_head.named_parameters()}}
    return {"embed": embed, "stages": stages, "head": head}


def unstack_pipeline_params(pp: dict, cfg) -> Transformer:
    """Inverse of :func:`stack_pipeline_params` (checkpoints, eval)."""
    lead = next(iter(pp["stages"]["attn"].values())).shape
    n_stages, lps = lead[0], lead[1]
    blocks = [
        Block(*(_Params(**{n: t[s, j].clone() for n, t in
                           pp["stages"][part].items()})
                for part in _BLOCK_PARTS))
        for s in range(n_stages) for j in range(lps)
    ]
    embed, head = pp["embed"], pp["head"]
    pos = embed.get("pos_emb")
    return Transformer(
        cfg, embed["tok_emb"].clone(), None if pos is None else pos.clone(),
        blocks, _Params(**{n: t.clone() for n, t in head["final_ln"].items()}),
        _Params(**{n: t.clone() for n, t in head["lm_head"].items()}))


def pipeline_partition_specs(pp: dict) -> dict:
    """The dim each leaf is split on over ``pipe``: 0 for stage leaves,
    None (replicated) for the embedding and the head."""
    def tree(t, spec):
        return ({k: tree(v, spec) for k, v in t.items()} if isinstance(t, dict)
                else spec)

    return {"embed": tree(pp["embed"], None), "stages": tree(pp["stages"], 0),
            "head": tree(pp["head"], None)}


# ---------------------------------------------------------------------------
# The schedule
# ---------------------------------------------------------------------------


class _Pipe:
    """This rank's place on ``pipe`` and ``data``."""

    def __init__(self, mesh):
        self.n_stages = axis_size(mesh, "pipe")
        self.stage = mesh.get_local_rank("pipe")
        self.group = mesh.get_group("pipe")
        self.n_data = axis_size(mesh, "data")
        self.data_rank = mesh.get_local_rank("data")
        self.data_group = mesh.get_group("data")

    def peer(self, stage):
        return dist.get_global_rank(self.group, stage)

    def rows(self, tokens, n_micro):
        """(M, rows, ...) microbatches of this data rank: micro m takes rows
        m * bm + [d * bm / n_data, (d + 1) * bm / n_data)."""
        b = tokens.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
        bm = b // n_micro
        if bm % self.n_data:
            raise ValueError(f"microbatch rows {bm} not divisible by data "
                             f"axis {self.n_data}")
        per = bm // self.n_data
        lo = self.data_rank * per
        return tokens.reshape((n_micro, bm) + tokens.shape[1:])[:, lo:lo + per]


def _seeds(seed, micro, layer=None):
    key = [seed, micro] if layer is None else [seed, micro, layer]
    return [int(s) for s in np.random.default_rng(key).integers(0, 2 ** 31, 3)]


def _run_stages(stage: Transformer, cfg, pipe: _Pipe, tokens, seed, train,
                grad):
    """The forward of this rank's stage over microbatches ``tokens``
    (M, rows, N). Returns (kept, h, aux): per microbatch (input, output,
    aux) for the backward, the last stage's outputs (M, rows, N, D) on
    every pipe rank (detached), and this stage's aux summed over
    microbatches / M (a tensor, detached)."""
    n_micro, rows, n = tokens.shape
    s, last = pipe.stage, pipe.stage == pipe.n_stages - 1
    lps = len(stage.blocks)
    drop = train and cfg.dropout_rate > 0
    dev = tokens.device
    kept = []
    aux_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for m in range(n_micro):
        with torch.set_grad_enabled(grad):
            if s == 0:
                x = _embed(stage, tokens[m], cfg)
                if drop:
                    x = _dropout(x, _seeds(seed, m)[0], cfg.dropout_rate)
            else:
                x = torch.empty((rows, n, cfg.d_model), dtype=cfg.dtype,
                                device=dev)
                dist.recv(x, pipe.peer(s - 1), group=pipe.group)
                x.requires_grad_(grad)
            inp, aux = x, torch.zeros((), dtype=torch.float32, device=dev)
            for j, bp in enumerate(stage.blocks):
                one = functools.partial(
                    _block, bp=bp, cfg=cfg, train=train,
                    seeds=_seeds(seed, m, s * lps + j) if drop else [None] * 3)
                x, a = _remat(one, cfg)(x)
                if a is not None:
                    aux = aux + a
        if not last:
            dist.send(x.detach().contiguous(), pipe.peer(s + 1),
                      group=pipe.group)
        kept.append((inp, x, aux))
        aux_sum = aux_sum + aux.detach()
    if last:
        h = torch.stack([x.detach() for _, x, _ in kept])
    else:
        h = torch.empty((n_micro, rows, n, cfg.d_model), dtype=cfg.dtype,
                        device=dev)
    if pipe.n_stages > 1:
        dist.broadcast(h, pipe.peer(pipe.n_stages - 1), group=pipe.group)
    return kept, h, aux_sum / n_micro


def _total_aux(aux, pipe: _Pipe):
    """Sum over ``pipe``, mean over ``data`` (a value, no gradient)."""
    aux = aux.clone()
    if pipe.n_stages > 1:
        dist.all_reduce(aux, group=pipe.group)
    if pipe.n_data > 1:
        dist.all_reduce(aux, group=pipe.data_group)
        aux = aux / pipe.n_data
    return aux


def _head(stage, h):
    return lm_head_logits(stage.lm_head, layer_norm(h, stage.final_ln))


def make_pipeline_forward(mesh, cfg, n_micro: int, *, train: bool = False):
    """``fn(stage, tokens, dropout_seed=None, *, return_hidden=False,
    return_aux=False)``: the GPipe forward (no gradient) of the whole batch
    ``tokens`` (B, N), the same on every rank, with B % n_micro == 0 and
    (B / n_micro) % data == 0. ``stage`` is this rank's stage (from
    :func:`make_pipelined_train_state` or :func:`pipeline_stage`). Returns
    this data rank's logits (rows as :func:`pipeline_rows` orders them), on
    every pipe rank; ``train`` routes MoE blocks with capacity."""
    pipe = _Pipe(mesh)

    @torch.no_grad()
    def forward(stage, tokens, dropout_seed=None, *, return_hidden=False,
                return_aux=False):
        mine = pipe.rows(tokens, n_micro)
        _, h, aux = _run_stages(stage, cfg, pipe, mine, dropout_seed, train,
                                grad=False)
        h = h.reshape((-1,) + h.shape[2:])
        out = layer_norm(h, stage.final_ln) if return_hidden else _head(stage, h)
        return (out, _total_aux(aux, pipe)) if return_aux else out

    return forward


def pipeline_rows(batch: int, n_micro: int, n_data: int, data_rank: int):
    """Indices into a batch of the rows a data rank's pipeline results
    hold, in their order."""
    bm = batch // n_micro
    per = bm // n_data
    return np.concatenate([np.arange(m * bm + data_rank * per,
                                     m * bm + (data_rank + 1) * per)
                           for m in range(n_micro)])


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def pipeline_stage(mesh, params: Transformer) -> Transformer:
    """This pipe rank's stage of a whole parameter set: a copy holding the
    embedding, the head and its L / S blocks."""
    n_stages, s = axis_size(mesh, "pipe"), mesh.get_local_rank("pipe")
    n_layers = len(params.blocks)
    if n_layers % n_stages:
        raise ValueError(f"n_layers={n_layers} not divisible by "
                         f"n_stages={n_stages}")
    lps = n_layers // n_stages
    stage = copy.deepcopy(params)
    stage.blocks = torch.nn.ModuleList(list(stage.blocks)[s * lps:(s + 1) * lps])
    return stage


def make_pipelined_train_state(mesh, params: Transformer, tc):
    """(stage, optimizer, specs): this rank's stage of ``params`` (left
    untouched) and its optimizer. The clip's global norm sums the stages'
    block gradients over ``pipe``."""
    stage = pipeline_stage(mesh, params)
    group = mesh.get_group("pipe")
    split = {n: group for n, _ in stage.named_parameters()
             if n.startswith("blocks.")}
    opt = ShardedOptimizer(stage, tc, split=split,
                           data_group=mesh.get_group("data"))
    specs = pipeline_partition_specs(
        stack_pipeline_params(params, axis_size(mesh, "pipe")))
    return stage, opt, specs


def make_pipelined_train_step(mesh, cfg, n_micro: int):
    """A dp x pp micro-step: step(stage, opt, batch, dropout_seed) -> the
    whole batch's loss (next-token CE, plus ``moe_aux_coef`` times the
    estimator of the module docstring for an MoE model), on every rank.
    ``batch["tokens"]`` (B, N + 1) is the whole batch; packed-varlen batches
    are a dense-path feature, as in the JAX package."""
    pipe = _Pipe(mesh)
    moe = cfg.moe_experts > 0

    def step(stage, opt, batch, dropout_seed=None):
        dev = stage.tok_emb.device
        tokens = pipe.rows(batch["tokens"].to(dev), n_micro)
        inputs, targets = tokens[..., :-1], tokens[..., 1:]
        kept, h, aux = _run_stages(stage, cfg, pipe, inputs, dropout_seed,
                                   train=True, grad=True)
        h = h.reshape((-1,) + h.shape[2:]).requires_grad_()
        ce = token_nll(_head(stage, h), targets.reshape(h.shape[:2])).mean()
        ce.backward()
        gh = h.grad.reshape((n_micro, -1) + h.shape[1:])
        s, last = pipe.stage, pipe.stage == pipe.n_stages - 1
        coef = torch.tensor(cfg.moe_aux_coef / n_micro, device=dev)
        for m in reversed(range(n_micro)):
            inp, out, a = kept[m]
            if last:
                g = gh[m].to(out.dtype)
            else:
                g = torch.empty_like(out)
                dist.recv(g, pipe.peer(s + 1), group=pipe.group)
            outs, grads = [out], [g]
            if moe:
                outs.append(a)
                grads.append(coef)
            torch.autograd.backward(outs, grads)
            if s > 0:
                dist.send(inp.grad.contiguous(), pipe.peer(s - 1),
                          group=pipe.group)
        if pipe.n_stages > 1:  # the embedding: only stage 0 has a gradient
            for p in (stage.tok_emb, stage.pos_emb):
                if p is None:
                    continue
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                dist.all_reduce(p.grad, group=pipe.group)
        all_reduce_grads(stage, pipe.data_group, pipe.n_data)
        opt.step()
        loss = ce.detach()
        if pipe.n_data > 1:
            dist.all_reduce(loss, group=pipe.data_group)
            loss = loss / pipe.n_data
        return loss + cfg.moe_aux_coef * _total_aux(aux, pipe) if moe else loss

    return step
