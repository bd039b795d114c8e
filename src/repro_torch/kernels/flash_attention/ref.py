"""Plain PyTorch version of causal / sliding-window GQA attention.

A line-for-line counterpart of ``repro/kernels/flash_attention/ref.py``:
it materializes the logits, repeats K/V by group, scales after the dot and
masks with ``-inf``.
"""

from __future__ import annotations

from typing import Optional

import torch


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Reference attention.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) with Hq % Hkv == 0 (GQA).
    causal masks j > i (aligned at the sequence end: query i attends to
    keys j <= i + (Skv - Sq)); window additionally masks j < i+off - window + 1.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)

    kr = torch.repeat_interleave(k, g, dim=1)
    vr = torch.repeat_interleave(v, g, dim=1)
    logits = torch.einsum(
        "bhqd,bhkd->bhqk", q.to(torch.float32), kr.to(torch.float32)
    ) * sm_scale

    i = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    j = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i
    if window is not None:
        mask &= j > i - window
    logits = torch.where(mask[None, None], logits, -torch.inf)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vr.to(torch.float32))
    return out.to(q.dtype)
