"""Dense attention, the reference of the attention family.

Counterpart of ``full_attention`` in
``deepfake_detection_tpu/parallel/ring_attention.py``: plain torch ops with
scores and softmax in f32, as the JAX function computes them.  It serves
``attn_impl="full"`` and the TimeSformer's temporal attention.  The
sequence-parallel functions of that module (``ring_attention``,
``ulysses_attention``, ``ring_flash_attention`` and ``_merge_blocks``) are
multi-GPU and not ported yet (ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["full_attention"]


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Dense softmax attention, ``(B, L, H, D) → (B, L, H, D)``; scale
    defaults to ``D**-0.5``."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        lq, lk = q.shape[1], k.shape[1]
        mask = torch.arange(lk, device=q.device)[None, :] > \
            torch.arange(lq, device=q.device)[:, None]
        s = s.masked_fill(mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
