"""Reference-checkpoint migration: run a trained reference ``Transformer``
checkpoint, unchanged, on the port's kernels.

The counterpart of ``flashattention_tpu/models/compat.py``. The reference
saves ``torch.save(model.state_dict())`` each epoch and ships no loader;
this module takes that mapping and reproduces the reference model's
eval-mode forward, oddities included, which ``models.transformer`` does not
copy:

- the token embedding times sqrt(d_model), plus learned positions;
- post-LN residual order in each decoder layer;
- causal multi-head attention scored ``tau * QK^T / sqrt(d_k)``, i.e.
  ``flash_attention(softmax_scale=tau / sqrt(d_k))``;
- the block named ``FeedForward``, which is a second, NON-causal
  self-attention, always at tau = 1 (the reference model has no MLP);
- a bias-free LM head.

Both attentions go through ``ops.api.flash_attention``: on the card the
flash forward kernel (``csrc/flash_fwd.cu``; with D <= 128 fp32 checkpoints
take its 3xTF32 tensor-core route, bf16 inputs its bf16 one), on CPU
tensors its plain version. Eval only: the reference's dropout is identity in eval.
"""

from __future__ import annotations

import dataclasses
import math
import re
from types import SimpleNamespace
from typing import Mapping

import torch
import torch.nn.functional as F

from flashattention_tpu_torch.models.transformer import layer_norm
from flashattention_tpu_torch.ops.api import flash_attention
from flashattention_tpu_torch.utils.device import resolve_device

__all__ = [
    "RefConfig",
    "convert_reference_state_dict",
    "apply_reference_transformer",
    "reference_lm_loss",
]


@dataclasses.dataclass(frozen=True)
class RefConfig:
    """Hyper-parameters of a migrated checkpoint."""

    num_heads: int
    d_model: int
    vocab_size: int
    max_len: int
    n_layers: int


def convert_reference_state_dict(
    state_dict: Mapping[str, torch.Tensor], num_heads: int, device=None
) -> dict:
    """Reference ``Transformer.state_dict()`` -> the port's parameters, as
    float32 tensors on ``device`` (None: the card).

    ``num_heads`` must be given: a state dict holds no hyper-parameters and
    the head count does not follow from the weight shapes. Layers, d_model,
    vocab and max_len are inferred. Fused vs separate QKV is detected per
    layer from the keys present (the reference registers ``w_qkv`` only when
    fused); the spare projections it registers either way are ignored, as
    its forward ignores them. Every bias is optional (``nn.Linear(bias=
    False)`` checkpoints). ``nn.Linear`` stores (out, in); the weights are
    transposed once here so the forward computes ``x @ w + b``.
    """
    device = resolve_device(device)
    sd = dict(state_dict)

    def t(x):
        return x.detach().to(device=device, dtype=torch.float32)

    def linear(prefix):
        out = {"w": t(sd[f"{prefix}.weight"]).T.contiguous()}
        bias = sd.get(f"{prefix}.bias")
        if bias is not None:
            out["b"] = t(bias)
        return out

    def ln(prefix):
        return SimpleNamespace(g=t(sd[f"{prefix}.weight"]),
                               b=t(sd[f"{prefix}.bias"]))

    tok = t(sd["token_embedding.emb.weight"])       # (V, d)
    pos = t(sd["pos_encoding.pos_emb.weight"])      # (max_len, d)
    vocab, d_model = tok.shape
    if d_model % num_heads:
        raise ValueError(f"d_model={d_model} not divisible by num_heads={num_heads}")
    n_layers = 1 + max(int(m.group(1)) for key in sd
                       if (m := re.match(r"decoder\.(\d+)\.", key)))
    layers = []
    for i in range(n_layers):
        pre = f"decoder.{i}"
        attn = {"o": linear(f"{pre}.attn.w_o")}
        if f"{pre}.attn.w_qkv.weight" in sd:
            attn["qkv"] = linear(f"{pre}.attn.w_qkv")
        else:
            for name in ("q", "k", "v"):
                attn[name] = linear(f"{pre}.attn.w_{name}")
        layers.append({
            "attn": attn,
            "ffn": {name: linear(f"{pre}.ffn.w_{name}")
                    for name in ("q", "k", "v", "o")},
            "ln1": ln(f"{pre}.layer_norm1"),
            "ln2": ln(f"{pre}.layer_norm2"),
        })
    return {
        "tok_emb": tok,
        "pos_emb": pos,
        "layers": layers,
        "lm_head": t(sd["fc_out.weight"]).T.contiguous(),  # (d, V), no bias
        "config": RefConfig(num_heads=num_heads, d_model=d_model,
                            vocab_size=vocab, max_len=int(pos.shape[0]),
                            n_layers=n_layers),
    }


def _lin(x, p):
    out = x @ p["w"]
    return out + p["b"] if "b" in p else out


def _self_attention(x, p, *, num_heads, tau, causal, backend):
    """One reference attention block (the causal MHA and the "ffn" share
    it): project, split heads, attend, merge, project out."""
    b, n, d = x.shape
    dh = d // num_heads
    if "qkv" in p:
        q, k, v = _lin(x, p["qkv"]).chunk(3, dim=-1)
    else:
        q, k, v = (_lin(x, p[name]) for name in ("q", "k", "v"))

    def heads(t):  # (B, N, d) -> (B, H, N, dh)
        return t.reshape(b, n, num_heads, dh).transpose(1, 2).contiguous()

    o, _ = flash_attention(heads(q), heads(k), heads(v), causal=causal,
                           softmax_scale=tau / math.sqrt(dh), backend=backend)
    return _lin(o.transpose(1, 2).reshape(b, n, d), p["o"])


def apply_reference_transformer(params: dict, input_ids: torch.Tensor, *,
                                tau: float = 1.0,
                                backend: str = "auto") -> torch.Tensor:
    """Eval-mode forward of the reference ``Transformer``:
    ``input_ids (B, N) -> logits (B, N, V)``, on the parameters' device.

    The second block of each layer ("ffn") is non-causal self-attention at
    tau = 1, as the reference computes it. Positions come from a table of
    ``max_len`` rows: longer inputs raise."""
    cfg = params["config"]
    b, n = input_ids.shape
    if n > cfg.max_len:
        raise ValueError(
            f"sequence length {n} exceeds checkpoint max_len {cfg.max_len}"
        )
    ids = input_ids.to(params["tok_emb"].device).long()
    x = params["tok_emb"][ids] * math.sqrt(cfg.d_model)
    x = x + params["pos_emb"][:n]
    for layer in params["layers"]:
        a = _self_attention(x, layer["attn"], num_heads=cfg.num_heads,
                            tau=tau, causal=True, backend=backend)
        x = layer_norm(x + a, layer["ln1"])
        f = _self_attention(x, layer["ffn"], num_heads=cfg.num_heads,
                            tau=1.0, causal=False, backend=backend)
        x = layer_norm(x + f, layer["ln2"])
    return x @ params["lm_head"]


def reference_lm_loss(params: dict, input_ids: torch.Tensor,
                      targets: torch.Tensor, *, tau: float = 1.0,
                      backend: str = "auto") -> torch.Tensor:
    """Mean next-token cross-entropy of a migrated checkpoint (the
    reference's training criterion); ``exp()`` of it is the perplexity.
    Excluding padding is the caller's slice."""
    logits = apply_reference_transformer(params, input_ids, tau=tau,
                                         backend=backend)
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           targets.to(logits.device).long().reshape(-1))
