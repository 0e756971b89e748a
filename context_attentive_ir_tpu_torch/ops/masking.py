"""Masking primitives (port of ``context_attentive_ir_tpu/ops/masking.py``).

``NEG_INF`` is finite so bf16 softmaxes stay NaN-free even for fully-masked
rows.
"""

from __future__ import annotations

import torch

NEG_INF = -1e9


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor,
                   dim: int = -1) -> torch.Tensor:
    """Softmax over valid positions; fully-masked rows return zeros."""
    logits = logits.masked_fill(~mask, NEG_INF)
    logits = logits - logits.amax(dim=dim, keepdim=True)
    unnorm = torch.exp(logits) * mask.to(logits.dtype)
    denom = unnorm.sum(dim=dim, keepdim=True)
    return unnorm / denom.clamp_min(1e-13)


def masked_log_softmax(logits: torch.Tensor, mask: torch.Tensor,
                       dim: int = -1) -> torch.Tensor:
    """``log(masked_softmax)``, floored at 1e-13 (masked entries read
    log(1e-13))."""
    return torch.log(masked_softmax(logits, mask, dim).clamp_min(1e-13))
