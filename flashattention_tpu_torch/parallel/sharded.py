"""Data- and tensor-parallel training over ``torch.distributed``, and
head-parallel attention.

The counterpart of ``flashattention_tpu/parallel/sharded.py``. The JAX
package annotates shardings and lets GSPMD insert the collectives; here
they are explicit (Megatron-LM's recipe):

- ``data``: every batch leaf (tokens and the packed-varlen segment ids) is
  cut on its batch dim; gradients are all-reduced (averaged) over ``data``
  after the backward. The packed loss and the MoE load-balance statistics
  are normalised over the whole batch, so the step equals the one-device
  step;
- ``model``: attention heads, the MLP's hidden columns, the LM head's vocab
  and the MoE experts are split (:func:`param_partition_specs`). A
  column-parallel product takes its input through ``enter`` (identity
  forward, all-reduce of the gradient), a row-parallel product gives its
  output to ``exit`` (all-reduce forward, identity gradient), the vocab
  shards of the logits are gathered. The MoE router is replicated and every
  rank routes the whole token set, so expert parallelism needs no
  all-to-all: each rank runs its experts, and the combine's all-reduce
  over ``model`` sums them;
- ZeRO-1 (``zero1=True``): each ``data`` rank keeps AdamW moments only for
  its slice of every parameter (the first free axis that ``n_data``
  divides, as the JAX ``_zero1_spec``), updates that slice and all-gathers
  the parameter.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from flashattention_tpu_torch.models import train as ttrain
from flashattention_tpu_torch.ops.flash_attn import kernel_attention
from flashattention_tpu_torch.parallel.mesh import axis_size

# ---------------------------------------------------------------------------
# Collectives with gradients
# ---------------------------------------------------------------------------


class _Enter(torch.autograd.Function):
    """Identity; the gradient is summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Exit(torch.autograd.Function):
    """Sum over the group; the gradient passes unchanged (scale 1 / n for
    a mean)."""

    @staticmethod
    def forward(ctx, x, group, scale):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y * scale if scale != 1.0 else y

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherLast(torch.autograd.Function):
    """All-gather of unequal shards on the last dim (each padded to the
    widest); the gradient keeps this rank's columns, since every rank
    computes the same loss from the gathered tensor."""

    @staticmethod
    def forward(ctx, x, group, sizes, rank):
        ctx.cols = (sum(sizes[:rank]), sizes[rank])
        pad = max(sizes) - x.shape[-1]
        x = torch.nn.functional.pad(x, (0, pad)).contiguous()
        parts = [torch.empty_like(x) for _ in sizes]
        dist.all_gather(parts, x, group=group)
        return torch.cat([p[..., :n] for p, n in zip(parts, sizes)], dim=-1)

    @staticmethod
    def backward(ctx, g):
        lo, n = ctx.cols
        return g[..., lo:lo + n], None, None, None


class ShardContext:
    """This rank's place on a mesh's ``data`` and ``model`` axes, and the
    collectives the model calls under ``shard=`` (``models/transformer.py``,
    ``models/moe.py``, ``models/train.py``). Axes of size 1 cost
    nothing: every operation is then the identity."""

    def __init__(self, mesh):
        self.n_model = axis_size(mesh, "model")
        self.n_data = axis_size(mesh, "data")
        self.model_rank = mesh.get_local_rank("model")
        self.data_rank = mesh.get_local_rank("data")
        self.model_group = mesh.get_group("model")
        self.data_group = mesh.get_group("data")
        self._vocab_sizes = {}  # local vocab width -> every rank's

    def enter(self, x):
        """Input of a column-parallel product."""
        return _Enter.apply(x, self.model_group) if self.n_model > 1 else x

    def exit(self, y):
        """Output of a row-parallel product: summed over ``model``."""
        return _Exit.apply(y, self.model_group, 1.0) if self.n_model > 1 else y

    def gather_vocab(self, logits):
        """Vocab-sharded logits, gathered (identical on every model rank)."""
        if self.n_model == 1:
            return logits
        width = logits.shape[-1]
        if width not in self._vocab_sizes:
            sizes = [None] * self.n_model
            dist.all_gather_object(sizes, width, group=self.model_group)
            self._vocab_sizes[width] = sizes
        return _GatherLast.apply(logits, self.model_group,
                                 self._vocab_sizes[width], self.model_rank)

    def data_mean(self, t):
        """Mean over ``data`` of a statistic that enters every rank's
        loss (the MoE f and P): the gradient passes unchanged, since the
        ranks' losses are averaged."""
        if self.n_data == 1:
            return t
        return _Exit.apply(t, self.data_group, 1.0 / self.n_data)

    def data_sum(self, t):
        """Sum over ``data``, no gradient (the packed loss's count)."""
        if self.n_data == 1:
            return t
        t = t.detach().clone()
        dist.all_reduce(t, group=self.data_group)
        return t

    def model_range(self, n: int) -> tuple[int, int]:
        """This rank's [lo, hi) of ``n`` items split evenly over ``model``."""
        if n % self.n_model:
            raise ValueError(f"{n} does not split over {self.n_model} model "
                             "ranks")
        per = n // self.n_model
        return self.model_rank * per, (self.model_rank + 1) * per


# ---------------------------------------------------------------------------
# Head-parallel attention
# ---------------------------------------------------------------------------


def head_sharded_attention(mesh, *, causal: bool = False, softmax_scale=None):
    """Attention with heads split over ``model`` and the batch over
    ``data``: fn(q, k, v) on this rank's (B / data, H / model, N, D) shards
    -> (o, lse). Heads are independent, so there is no communication; the
    caller's output projection does the sum over ``model``."""
    def attn(q, k, v):
        return kernel_attention(q, k, v, causal=causal,
                                softmax_scale=softmax_scale)

    return attn


# ---------------------------------------------------------------------------
# Parameter partition over 'model'
# ---------------------------------------------------------------------------


def param_partition_specs(params: nn.Module) -> dict[str, int | None]:
    """The dim each parameter is split on over ``model`` (None:
    replicated), by the JAX package's leaf rules (Megatron TP):
    ``w_qkv`` and the MLP's ``w_in`` by columns, ``w_o`` and ``w_out`` by
    rows, ``b_qkv`` / ``b_in`` with their columns, ``lm_head`` over the
    vocab, MoE expert leaves on the expert dim, the router, embeddings, layer
    norms, ``b_o`` and the dense ``b_out`` replicated."""
    specs = {}
    for name, p in params.named_parameters():
        parts = name.split(".")
        last = parts[-1]
        if last == "router":
            dim = None
        elif last in ("w_in", "w_out") and p.dim() == 3:
            dim = 0
        elif last in ("b_in", "b_out") and p.dim() == 2:
            dim = 0
        elif last in ("w_qkv", "w_in"):
            dim = 1
        elif last in ("b_qkv", "b_in", "w_o", "w_out"):
            dim = 0
        elif "lm_head" in parts:
            dim = 1 if last == "w" else 0
        else:
            dim = None
        specs[name] = dim
    return specs


def _check_tp(cfg, n: int) -> None:
    if n == 1:
        return
    if not cfg.fused_qkv:
        raise ValueError("tensor parallelism needs fused_qkv (w_qkv): "
                         "separate q/k/v projections are replicated by the "
                         "partition rules")
    for what, size in (("n_heads", cfg.n_heads), ("kv heads", cfg.kv_heads),
                       ("d_ff", cfg.d_ff), ("moe_experts", cfg.moe_experts)):
        if size % n:
            raise ValueError(f"{what} = {size} does not split over {n} "
                             "model ranks")


def _qkv_sections(cfg):
    dh = cfg.d_head
    return [cfg.n_heads * dh, cfg.kv_heads * dh, cfg.kv_heads * dh]


def _shard(name, t, dim, cfg, rank, n):
    if dim is None or n == 1:
        return t
    if name.endswith(("w_qkv", "b_qkv")):  # whole heads of q, k and v
        secs = t.split(_qkv_sections(cfg), dim=-1)
        return torch.cat([s.chunk(n, -1)[rank] for s in secs], dim=-1)
    if name.startswith("lm_head"):  # the vocab need not divide
        return t.tensor_split(n, dim)[rank]
    return t.chunk(n, dim)[rank]


def shard_params(params: nn.Module, ctx: ShardContext, specs=None):
    """This model rank's shards of a whole parameter set: a copy of
    ``params`` whose leaves are cut by ``specs``
    (:func:`param_partition_specs`)."""
    cfg = params.cfg
    _check_tp(cfg, ctx.n_model)
    specs = specs or param_partition_specs(params)
    local = copy.deepcopy(params)
    with torch.no_grad():
        for name, p in local.named_parameters():
            p.data = _shard(name, p.data, specs[name], cfg, ctx.model_rank,
                            ctx.n_model).contiguous()
    return local


def _gather(t, group, n, dim):
    sizes = [None] * n
    dist.all_gather_object(sizes, t.shape[dim], group=group)
    width = max(sizes)
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, width - t.shape[dim]]
    t = torch.nn.functional.pad(t, pad).contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return [p.narrow(dim, 0, s) for p, s in zip(parts, sizes)]


def unshard_params(params: nn.Module, ctx: ShardContext, specs=None):
    """The whole parameter set from every model rank's shards (the inverse
    of :func:`shard_params`), on every rank."""
    cfg = params.cfg
    specs = specs or param_partition_specs(params)
    full = copy.deepcopy(params)
    with torch.no_grad():
        for name, p in full.named_parameters():
            dim = specs[name]
            if dim is None or ctx.n_model == 1:
                continue
            parts = _gather(p.data, ctx.model_group, ctx.n_model, dim)
            if name.endswith(("w_qkv", "b_qkv")):
                secs = [s // ctx.n_model for s in _qkv_sections(cfg)]
                split = [q.split(secs, dim=-1) for q in parts]
                p.data = torch.cat([torch.cat([s[i] for s in split], dim=-1)
                                    for i in range(3)], dim=-1)
            else:
                p.data = torch.cat(parts, dim=dim)
    return full


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


def zero1_axis(tp_dim, shape, n_data: int):
    """The axis ZeRO-1 slices an optimizer moment on over ``data``: the
    first axis not split over ``model`` that ``n_data`` divides (the JAX
    ``_zero1_spec``); None where there is none (the moment is then kept
    whole on every data rank)."""
    for i, size in enumerate(shape):
        if i != tp_dim and size % n_data == 0 and size >= n_data:
            return i
    return None


class ShardedOptimizer(ttrain.Optimizer):
    """:class:`models.train.Optimizer` over a rank's shards: the clip's
    global norm sums the squares of split parameters over the group they
    are split over (``split``: parameter name -> group, None for
    replicated); with ``zero1`` and more than one ``data`` rank, AdamW
    holds moments for this rank's slice of each parameter only."""

    def __init__(self, params: nn.Module, tc, *, split: dict, data_group=None,
                 zero1: bool = False, tp_dims: dict | None = None):
        names = [n for n, p in params.named_parameters() if p.requires_grad]
        plist = [p for p in params.parameters() if p.requires_grad]
        self.split = [split.get(n) for n in names]
        self.data_group = data_group
        n_data = dist.get_world_size(data_group) if data_group is not None else 1
        self.slices = []
        adam_params = None
        if zero1 and n_data > 1:
            rank = dist.get_rank(data_group)
            for name, p in zip(names, plist):
                axis = zero1_axis((tp_dims or {}).get(name), p.shape, n_data)
                if axis is None:
                    self.slices.append((p, p, None))
                else:
                    piece = p.detach().chunk(n_data, axis)[rank].clone()
                    self.slices.append((p, nn.Parameter(piece), axis))
            adam_params = [a for _, a, _ in self.slices]
        super().__init__(params, tc, adam_params)

    def _norms(self, params):
        norms = super()._norms(params)
        groups = {id(p): g for p, g in zip(self.params, self.split)
                  if g is not None and dist.get_world_size(g) > 1}
        if not groups:
            return norms
        sq = norms ** 2
        for g in {id(g): g for g in groups.values()}.values():
            mask = torch.tensor([groups.get(id(p)) is g for p in params],
                                device=sq.device)
            part = torch.where(mask, sq, torch.zeros_like(sq))
            dist.all_reduce(part, group=g)
            sq = torch.where(mask, part, sq)
        return torch.sqrt(sq)

    def _adamw_step(self) -> None:
        if not self.slices:
            return super()._adamw_step()
        n = dist.get_world_size(self.data_group)
        rank = dist.get_rank(self.data_group)
        for p, a, axis in self.slices:
            if axis is not None and p.grad is not None:
                a.grad = p.grad.chunk(n, axis)[rank].contiguous()
        self.adamw.step()
        with torch.no_grad():
            for p, a, axis in self.slices:
                if axis is None:
                    continue
                parts = [torch.empty_like(a) for _ in range(n)]
                dist.all_gather(parts, a.data.contiguous(), group=self.data_group)
                p.copy_(torch.cat(parts, dim=axis))
                a.grad = None


# ---------------------------------------------------------------------------
# State and step
# ---------------------------------------------------------------------------


def make_sharded_train_state(mesh, params: nn.Module, tc, *,
                             zero1: bool = False):
    """This rank's shards of ``params`` (the whole set, the same on every
    rank, left untouched) and their optimizer: (local params, optimizer,
    specs). ``tc``: the ``TrainConfig`` of the optimizer. ``zero1=True``
    slices the AdamW moments over ``data`` (module docstring)."""
    ctx = ShardContext(mesh)
    specs = param_partition_specs(params)
    local = shard_params(params, ctx, specs)
    split = {n: ctx.model_group for n, d in specs.items() if d is not None}
    opt = ShardedOptimizer(local, tc, split=split, data_group=ctx.data_group,
                           zero1=zero1, tp_dims=specs)
    return local, opt, specs


def data_seed(seed, ctx: ShardContext):
    """A data rank's dropout seed: other rows, other masks."""
    if seed is None or ctx.n_data == 1:
        return seed
    return int(np.random.default_rng([seed, ctx.data_rank]).integers(0, 2 ** 31))


def all_reduce_grads(params: nn.Module, group, n: int) -> None:
    """Average the gradients over ``group`` (n ranks)."""
    if n == 1:
        return
    for p in params.parameters():
        if p.grad is not None:
            dist.all_reduce(p.grad, group=group)
            p.grad.div_(n)


def make_sharded_train_step(mesh, cfg, loss_fn=None):
    """A dp x tp micro-step: step(params, opt, batch, dropout_seed) ->
    the whole batch's loss. ``batch`` is the whole batch (the same on every
    rank); each leaf is cut on its batch dim over ``data``. ``params`` and
    ``opt`` come from :func:`make_sharded_train_state`. ``loss_fn``
    defaults to ``models.train.loss_fn`` (it takes ``shard=``)."""
    ctx = ShardContext(mesh)
    loss_fn = loss_fn or ttrain.loss_fn

    def step(params, opt, batch, dropout_seed=None):
        dev = next(params.parameters()).device
        local = {}
        for name, t in batch.items():
            if t.shape[0] % ctx.n_data:
                raise ValueError(f"batch leaf {name} {tuple(t.shape)} does not "
                                 f"split over {ctx.n_data} data ranks")
            local[name] = t.chunk(ctx.n_data, 0)[ctx.data_rank].to(dev)
        loss = loss_fn(params, local, cfg, data_seed(dropout_seed, ctx),
                       shard=ctx)
        loss.backward()
        all_reduce_grads(params, ctx.data_group, ctx.n_data)
        opt.step()
        return ctx.data_mean(loss.detach())

    return step
