"""Dense float32 attention oracle.

The counterpart of ``flashattention_tpu/ops/reference.py``. Every mask is
built from absolute row and column indices; all arithmetic is float32
whatever the input dtype. Masked scores take the finite
:data:`DEFAULT_MASK_VALUE`, so a row with no visible key softmaxes over
equal scores (the oracle's convention; the kernels return zeros there).
"""

from __future__ import annotations

import torch

# -0.7 * float32 max: the finite value masked scores take.
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def causal_mask(q_len: int, k_len: int, *, q_offset: int = 0,
                device=None) -> torch.Tensor:
    """Boolean (q_len, k_len) mask, True = attend. Query row ``i`` sits at
    absolute position ``i + k_len - q_len + q_offset``."""
    rows = torch.arange(q_len, device=device)[:, None]
    cols = torch.arange(k_len, device=device)[None, :]
    return cols <= rows + (k_len - q_len + q_offset)


def band_mask(n_q: int, n_k: int, offset, *, window: int | None = None,
              sinks: int = 0, device=None) -> torch.Tensor:
    """(n_q, n_k) causal band: row r attends cols <= r + offset and, with a
    ``window`` W, only cols > r + offset - W plus the first ``sinks``."""
    rows = torch.arange(n_q, device=device)[:, None] + offset
    cols = torch.arange(n_k, device=device)[None, :]
    m = cols <= rows
    if window is not None:
        band = cols > rows - window
        if sinks:
            band = band | (cols < sinks)
        m = m & band
    return m


def alibi_bias(slopes: torch.Tensor, rows: torch.Tensor,
               cols: torch.Tensor) -> torch.Tensor:
    """(H, len(rows), len(cols)) ALiBi bias ``-slope_h * |col - row|`` at
    absolute key positions ``rows`` (of the queries) and ``cols``."""
    dist = (cols[None, :] - rows[:, None]).abs().to(torch.float32)
    return (-slopes.float())[:, None, None] * dist


def score_pipeline(s: torch.Tensor, *, bias: torch.Tensor | None = None,
                   softcap: float | None = None,
                   visible: torch.Tensor | None = None):
    """Steps 2-4 of the score pipeline on scaled fp32 scores, in the order
    every version keeps: add ``bias`` (ALiBi), soft-cap ``c·tanh(s/c)``,
    then give scores outside ``visible`` the finite
    :data:`DEFAULT_MASK_VALUE`. Returns (s, d(capped)/d(raw) or None)."""
    if bias is not None:
        s = s + bias.float()
    dcap = None
    if softcap is not None:
        t = torch.tanh(s * (1.0 / softcap))
        s = softcap * t
        dcap = 1.0 - t * t
    if visible is not None:
        s = torch.where(visible.to(s.device), s,
                        torch.full_like(s, DEFAULT_MASK_VALUE))
    return s, dcap


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    softmax_scale: float | None = None,
    bias: torch.Tensor | None = None,
    mask: torch.Tensor | None = None,
    q_offset: int | None = None,
    window: int | None = None,
    softcap: float | None = None,
    sinks: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense fp32 attention: (..., N_q, D) q and (..., N_k, D) k/v ->
    (o in q's dtype, fp32 lse (..., N_q)).

    Scores are ``q·k * scale``, plus ``bias``, soft-capped
    (``softcap * tanh(s / softcap)``), then masked: causal (row r attends
    cols <= r + q_offset, default ``n_k - n_q``) with an optional window
    band and sinks, and the boolean ``mask`` (True = attend)."""
    n_q, d = q.shape[-2], q.shape[-1]
    n_k = k.shape[-2]
    if softmax_scale is None:
        softmax_scale = d ** -0.5
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * softmax_scale
    visible = None if mask is None else mask.to(s.device)
    if causal:
        offset = (n_k - n_q) if q_offset is None else q_offset
        cm = band_mask(n_q, n_k, offset, window=window, sinks=sinks,
                       device=q.device)
        visible = cm if visible is None else (cm & visible)
    s, _ = score_pipeline(s, bias=bias, softcap=softcap, visible=visible)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("...qk,...kd->...qd", p, v.float())
    return o.to(q.dtype), lse


def reference_attention_grads(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = False,
    softmax_scale: float | None = None,
    window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv of ``sum(o * do)`` through :func:`reference_attention`,
    by autograd."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    with torch.enable_grad():
        o, _ = reference_attention(*leaves, causal=causal,
                                   softmax_scale=softmax_scale, window=window)
        (o.float() * do.float()).sum().backward()
    return tuple(t.grad for t in leaves)
