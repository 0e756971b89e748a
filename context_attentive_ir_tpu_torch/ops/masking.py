"""Masking primitives (port of ``context_attentive_ir_tpu/ops/masking.py``).

``NEG_INF`` is finite so bf16 softmaxes stay NaN-free even for fully-masked
rows.
"""

from __future__ import annotations

import torch

NEG_INF = -1e9


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """bool [..., max_len] with True for positions < length."""
    pos = torch.arange(max_len, device=lengths.device)
    return pos < lengths[..., None]


def mask_logits(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Set masked-out logits to ``NEG_INF``."""
    return logits.masked_fill(~mask, NEG_INF)


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor,
                   dim: int = -1) -> torch.Tensor:
    """Softmax over valid positions; fully-masked rows return zeros."""
    logits = mask_logits(logits, mask)
    logits = logits - logits.amax(dim=dim, keepdim=True)
    unnorm = torch.exp(logits) * mask.to(logits.dtype)
    denom = unnorm.sum(dim=dim, keepdim=True)
    return unnorm / denom.clamp_min(1e-13)


def masked_log_softmax(logits: torch.Tensor, mask: torch.Tensor,
                       dim: int = -1) -> torch.Tensor:
    """``log(masked_softmax)``, floored at 1e-13 (masked entries read
    log(1e-13))."""
    return torch.log(masked_softmax(logits, mask, dim).clamp_min(1e-13))


def masked_max(x: torch.Tensor, mask: torch.Tensor,
               dim: int = -2) -> torch.Tensor:
    """Max of ``x`` over ``dim`` counting only positions where ``mask`` is
    True (x [..., T, D], mask [..., T] -> [..., D] at ``dim=-2``); a fully
    masked row reads ``NEG_INF`` in every feature, as in JAX.  ``amax``
    splits the gradient evenly over tied maxima, as ``jax.grad`` of
    ``jnp.max`` does (``max(dim).values`` would give it all to one)."""
    return torch.where(mask[..., None], x, NEG_INF).amax(dim=dim)


def masked_mean(x: torch.Tensor, mask: torch.Tensor,
                dim: int = -2) -> torch.Tensor:
    """Mean of ``x`` over ``dim`` counting only positions where ``mask`` is
    True (x [..., T, D], mask [..., T] -> [..., D] at ``dim=-2``); a fully
    masked row reads 0."""
    m = mask[..., None].to(x.dtype)
    return (x * m).sum(dim) / m.sum(dim).clamp_min(1.0)
