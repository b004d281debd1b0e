"""Tolerance ladder shared by the port's tests and ``chip_smoke.py``.

The same ladder as the JAX package (``flashattention_tpu/utils/testing.py``):
bf16/fp16 outputs at rtol = atol = 5e-2, fp32 at 1e-4.
"""

from __future__ import annotations

import numpy as np
import torch


def dtype_tolerances(dtype) -> tuple[float, float]:
    """(rtol, atol) for outputs of ``dtype``."""
    if dtype in (torch.float16, torch.bfloat16):
        return 5e-2, 5e-2
    return 1e-4, 1e-4


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def assert_allclose(actual, expected, rtol=None, atol=None, err_msg=""):
    """np.testing.assert_allclose in float32, defaulting to the ladder of
    ``expected``'s dtype."""
    if rtol is None or atol is None:
        dt = expected.dtype if isinstance(expected, torch.Tensor) else torch.float32
        r, a = dtype_tolerances(dt)
        rtol = r if rtol is None else rtol
        atol = a if atol is None else atol
    np.testing.assert_allclose(
        to_numpy(actual), to_numpy(expected), rtol=rtol, atol=atol,
        err_msg=err_msg,
    )


def reference_state_dict(*, vocab: int, d_model: int, n_layers: int,
                         max_len: int, fused: bool = True, bias: bool = True,
                         spare: bool = True, seed: int = 0) -> dict:
    """A seeded ``state_dict`` in the reference ``Transformer``'s layout and
    key names (float32 CPU tensors, numpy's ``default_rng(seed)``):
    N(0, 1) embeddings, ``nn.Linear``'s uniform(+-1/sqrt(in)) weights and
    biases (none with ``bias=False``), LayerNorm gains 1 + 0.1 N(0, 1) and
    shifts 0.1 N(0, 1), a bias-free ``fc_out``. ``fused`` gives each
    attention ``w_qkv``; ``spare`` adds the separate projections the
    reference registers beside it (which its forward ignores)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def put(name, a):
        sd[name] = torch.from_numpy(np.asarray(a, np.float32))

    def linear(prefix, n_in, n_out, with_bias=bias):
        lim = 1.0 / np.sqrt(n_in)
        put(f"{prefix}.weight", rng.uniform(-lim, lim, (n_out, n_in)))
        if with_bias:
            put(f"{prefix}.bias", rng.uniform(-lim, lim, n_out))

    d = d_model
    put("token_embedding.emb.weight", rng.standard_normal((vocab, d)))
    put("pos_encoding.pos_emb.weight", rng.standard_normal((max_len, d)))
    for i in range(n_layers):
        pre = f"decoder.{i}"
        if fused:
            linear(f"{pre}.attn.w_qkv", d, 3 * d)
        if spare or not fused:
            for name in ("q", "k", "v"):
                linear(f"{pre}.attn.w_{name}", d, d)
        linear(f"{pre}.attn.w_o", d, d)
        for name in ("q", "k", "v", "o"):
            linear(f"{pre}.ffn.w_{name}", d, d)
        for j in (1, 2):
            put(f"{pre}.layer_norm{j}.weight", 1 + 0.1 * rng.standard_normal(d))
            put(f"{pre}.layer_norm{j}.bias", 0.1 * rng.standard_normal(d))
    linear("fc_out", d, vocab, with_bias=False)
    return sd
