"""Training loop for the decoder LM.

The counterpart of ``flashattention_tpu/models/train.py``:

- AdamW (eps 1e-8, weight decay on every parameter, as optax applies it
  with no mask), betas (0.9, 0.95), global-norm clip 1.0 with optax's rule
  (scale by ``clip / ‖g‖`` when ``‖g‖ >= clip``, no epsilon), learning rate
  0 at update 0, linear warmup to the peak, cosine to 0.1 · peak;
- gradient accumulation: ``grad_accum`` micro-steps are averaged into one
  optimizer update (optax's ``MultiSteps``); the schedule counts updates:
  ``warmup_updates = max(1, warmup_steps // accum)``,
  ``decay_updates = max(warmup_updates + 1, total_steps // accum)``. With
  ``warmup_steps < grad_accum`` warmup collapses to one update, as in the
  JAX package;
- bf16 activations, fp32 parameters and optimizer state;
- checkpoints with ``torch.save``, resumed by the JAX rule: the stream skips
  the batches the saved run consumed, steps 0..saved step.

Run ``python -m flashattention_tpu_torch.models.train --smoke`` for a tiny
run on the card (``--cpu`` for the CPU). Dropout masks come from per-step
integer seeds (``models/transformer.py``), not from ``jax.random``.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from flashattention_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    apply_transformer,
    head_logits,
    init_params,
)
from flashattention_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Same fields and defaults as the JAX package's ``TrainConfig``."""

    learning_rate: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.95
    weight_decay: float = 0.1
    warmup_steps: int = 1000
    total_steps: int = 10000
    grad_clip: float = 1.0
    grad_accum: int = 16
    batch_size: int = 8
    seq_len: int = 512
    seed: int = 0
    log_every: int = 10
    checkpoint_every: int = 1000
    checkpoint_dir: str | None = None


def lr_schedule(tc: TrainConfig):
    """Learning rate of optimizer update ``u`` (0-based): optax's
    ``warmup_cosine_decay_schedule`` in update units."""
    accum = max(1, tc.grad_accum)
    warmup = max(1, tc.warmup_steps // accum)
    decay = max(warmup + 1, tc.total_steps // accum)
    peak, end = tc.learning_rate, tc.learning_rate * 0.1
    alpha = end / peak if peak else 0.0

    def lr(u: int) -> float:
        if u < warmup:
            return peak * u / warmup
        t = min(u - warmup, decay - warmup) / (decay - warmup)
        return peak * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t))
                       + alpha)

    return lr


class Optimizer:
    """clip -> AdamW(schedule), applied once every ``grad_accum`` calls of
    :meth:`step` to the mean of the micro-steps' gradients (which
    ``backward`` sums into ``.grad``).

    ``adam_params`` (optional) are the tensors AdamW updates in place of
    the parameters themselves (the sharded optimizer's ZeRO-1 slices)."""

    def __init__(self, params: Transformer, tc: TrainConfig,
                 adam_params=None):
        self.tc = tc
        self.params = [p for p in params.parameters() if p.requires_grad]
        self.accum = max(1, tc.grad_accum)
        self.schedule = lr_schedule(tc)
        self.adamw = torch.optim.AdamW(
            self.params if adam_params is None else adam_params, lr=0.0,
            betas=(tc.beta1, tc.beta2), eps=1e-8,
            weight_decay=tc.weight_decay)
        self.micro = 0    # micro-steps since the last update
        self.updates = 0  # optimizer updates applied

    def _norms(self, params) -> torch.Tensor:
        """L2 norms of the parameters' gradients, stacked."""
        return torch.stack([torch.linalg.vector_norm(p.grad.float())
                            for p in params])

    def _adamw_step(self) -> None:
        self.adamw.step()

    def step(self) -> bool:
        """Count one micro-step; apply an update when ``grad_accum`` have
        accumulated. Returns whether it did."""
        self.micro += 1
        if self.micro < self.accum:
            return False
        with_grad = [p for p in self.params if p.grad is not None]
        grads = [p.grad for p in with_grad]
        if self.accum > 1:
            torch._foreach_div_(grads, float(self.accum))
        norm = torch.linalg.vector_norm(self._norms(with_grad))
        clip = float(self.tc.grad_clip)
        scale = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
        torch._foreach_mul_(grads, scale)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.updates)
        self._adamw_step()
        for p in self.params:
            p.grad = None
        self.updates += 1
        self.micro = 0
        return True

    def state_dict(self) -> dict:
        return {
            "adamw": self.adamw.state_dict(), "micro": self.micro,
            "updates": self.updates,
            "grads": [None if p.grad is None else p.grad.detach().clone()
                      for p in self.params],
        }

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.micro, self.updates = state["micro"], state["updates"]
        for p, g in zip(self.params, state["grads"]):
            p.grad = None if g is None else g.to(p.device)


def make_optimizer(params: Transformer, tc: TrainConfig) -> Optimizer:
    return Optimizer(params, tc)


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """(B, N) negative log-likelihoods of ``targets`` under fp32 logits
    (B, N, V), computed over rows of V (the fast softmax layout)."""
    b, n, v = logits.shape
    return F.cross_entropy(logits.reshape(b * n, v), targets.reshape(b * n),
                           reduction="none").view(b, n)


def chunked_cross_entropy(x, lm_head, targets, chunk: int, valid=None,
                          shard=None):
    """Mean next-token CE with per-chunk fp32 logits (B, chunk, V): each
    chunk is checkpointed, so the backward recomputes its logits instead of
    keeping (B, N, V). ``valid`` (B, N) bool masks targets."""
    b, n, _ = x.shape
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=x.device)

    def one(xc, tc, vc):
        nll = token_nll(head_logits(lm_head, xc, shard), tc)
        return torch.where(vc, nll, torch.zeros_like(nll)).sum()

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, n, chunk):
        args = (x[:, c0:c0 + chunk], targets[:, c0:c0 + chunk],
                valid[:, c0:c0 + chunk])
        if torch.is_grad_enabled():
            total = total + checkpoint(one, *args, use_reentrant=False)
        else:
            total = total + one(*args)
    return total / _count(valid, shard)


def _count(valid, shard):
    """The mean's denominator: the valid targets of the whole batch. Under
    ``shard`` with data ranks, the count of every rank, scaled so that the
    mean of the ranks' losses is the whole batch's loss."""
    n = valid.sum()
    if shard is not None and shard.n_data > 1:
        n = shard.data_sum(n) / shard.n_data
    return n.clamp(min=1)


def loss_fn(params: Transformer, batch: dict, cfg: TransformerConfig,
            dropout_seed: int | None, shard=None):
    """Next-token cross entropy of ``batch["tokens"]`` (B, N+1), plus
    ``cfg.moe_aux_coef`` times the load-balance loss of an MoE model.

    ``batch["segment_ids"]`` (B, N+1), optional: packed rows; attention and
    positions stay within a segment, and targets that cross a segment
    boundary or sit in a padding segment (id < 0) leave the mean.
    ``shard``: this rank's share of a sharded step
    (``parallel.sharded``)."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    seg = batch.get("segment_ids")
    valid = None
    if seg is not None:
        valid = (seg[:, :-1] == seg[:, 1:]) & (seg[:, :-1] >= 0)
    kw = dict(train=True, dropout_seed=dropout_seed, return_aux=True,
              segment_ids=None if seg is None else seg[:, :-1], shard=shard)
    if cfg.loss_chunk:
        x, aux = apply_transformer(params, inputs, cfg, return_hidden=True,
                                   **kw)
        ce = chunked_cross_entropy(x, params.lm_head, targets,
                                   cfg.loss_chunk, valid=valid, shard=shard)
    else:
        logits, aux = apply_transformer(params, inputs, cfg, **kw)
        nll = token_nll(logits, targets)
        if valid is None:
            ce = nll.mean()
        else:
            ce = torch.where(valid, nll, torch.zeros_like(nll)).sum() / \
                _count(valid, shard)
    return ce + cfg.moe_aux_coef * aux if cfg.moe_experts else ce


def step_seed(tc: TrainConfig, step: int) -> int:
    """The dropout seed of micro-step ``step`` (a function of the run's seed
    and the step, so a resumed run draws the same masks)."""
    return int(np.random.default_rng([tc.seed, step]).integers(0, 2 ** 31))


def train_step(params: Transformer, opt: Optimizer, batch: dict,
               dropout_seed: int, cfg: TransformerConfig) -> torch.Tensor:
    """One micro-step: forward, backward, and the optimizer's turn. Returns
    the loss (not synchronised)."""
    loss = loss_fn(params, batch, cfg, dropout_seed)
    loss.backward()
    opt.step()
    return loss.detach()


def save_checkpoint(path: str, step: int, params: Transformer,
                    opt: Optimizer) -> None:
    d = Path(path)
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / f".step_{step:08d}.tmp"
    torch.save({"step": step, "params": params.state_dict(),
                "opt": opt.state_dict()}, tmp)
    tmp.replace(d / f"step_{step:08d}.pt")


def restore_checkpoint(path: str, params: Transformer, opt: Optimizer):
    """Load the latest checkpoint under ``path`` into ``params`` and
    ``opt``; returns its step, or None when there is none."""
    files = sorted(Path(path).glob("step_*.pt"))
    if not files:
        return None
    dev = next(params.parameters()).device
    state = torch.load(files[-1], map_location=dev, weights_only=False)
    params.load_state_dict(state["params"])
    opt.load_state_dict(state["opt"])
    return int(state["step"])


def synthetic_batches(tc: TrainConfig, vocab: int, n_batches: int,
                      device=None):
    """Deterministic token batches: the JAX package's numpy stream
    (``default_rng(tc.seed)``), so both packages see the same tokens."""
    rng = np.random.default_rng(tc.seed)
    stream = rng.integers(0, vocab, size=(n_batches, tc.batch_size,
                                          tc.seq_len + 1))
    for i in range(n_batches):
        t = torch.from_numpy(stream[i])
        yield {"tokens": t if device is None else t.to(device)}


def train(cfg: TransformerConfig, tc: TrainConfig, batches=None, *,
          params: Transformer | None = None, device=None,
          verbose: bool = True):
    """Train for ``tc.total_steps`` micro-steps on ``device`` (None: the
    card). ``params`` (optional) starts from given weights instead of
    ``init_params(cfg, tc.seed)``. Returns (params, optimizer, losses of
    the logged steps)."""
    device = resolve_device(device)
    if params is None:
        params = init_params(cfg, seed=tc.seed, device=device)
    else:
        params = params.to(device)
    opt = make_optimizer(params, tc)

    start_step = 0
    if tc.checkpoint_dir:
        restored = restore_checkpoint(tc.checkpoint_dir, params, opt)
        if restored is not None:
            start_step = restored
            if verbose:
                print(f"resumed from step {start_step}")

    if batches is None:
        batches = synthetic_batches(tc, cfg.vocab_size, tc.total_steps)
    batches = iter(batches)
    if start_step:
        # Skip the batches the checkpointed run consumed (steps
        # 0..start_step: the checkpoint is written after its step).
        for _ in range(start_step + 1):
            next(batches, None)
        start_step += 1

    losses = []
    t0 = time.perf_counter()
    for step, batch in enumerate(batches, start=start_step):
        if step >= tc.total_steps:
            break
        batch = {k: v.to(device) for k, v in batch.items()}
        loss = train_step(params, opt, batch, step_seed(tc, step), cfg)
        if step % tc.log_every == 0:
            loss_val = float(loss)
            losses.append(loss_val)
            if verbose:
                dt = time.perf_counter() - t0
                tok_s = (tc.batch_size * tc.seq_len * tc.log_every / dt
                         if step else 0.0)
                print(f"step {step:6d} loss {loss_val:8.4f} "
                      f"tokens/s {tok_s:10.0f}")
                t0 = time.perf_counter()
        if tc.checkpoint_dir and step and step % tc.checkpoint_every == 0:
            save_checkpoint(tc.checkpoint_dir, step, params, opt)
    return params, opt, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny model, 8 steps, synthetic data")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--checkpoint-dir", type=str, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain versions of the kernels)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    if args.smoke:
        cfg = TransformerConfig(
            vocab_size=512, d_model=128, n_layers=2, n_heads=4, d_ff=256,
            max_seq_len=128, block_size=128,
        )
        tc = TrainConfig(
            batch_size=2, seq_len=64, total_steps=8, grad_accum=2,
            warmup_steps=2, log_every=1, checkpoint_dir=args.checkpoint_dir,
        )
    else:
        cfg = TransformerConfig()
        tc = TrainConfig(total_steps=args.steps,
                         checkpoint_dir=args.checkpoint_dir)
    _, _, losses = train(cfg, tc, device=device)
    print(f"final loss {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
