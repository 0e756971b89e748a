"""Training objectives (port of ``context_attentive_ir_tpu/models/losses.py``).

Listwise softmax cross-entropy against click labels (the CARS ranking
loss), pairwise hinge and pointwise BCE for the classic rankers, and
token-level NLL for the suggestion decoders.  Every loss is fully masked
(padded candidates, padded target tokens, padded rows), so a short final
batch needs no special case.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.masking import masked_log_softmax


def listwise_rank_loss(scores: torch.Tensor, labels: torch.Tensor,
                       cand_mask: torch.Tensor,
                       row_mask: torch.Tensor) -> torch.Tensor:
    """-sum_d y_d log softmax(scores)_d with multi-click label
    normalisation.  scores/labels/cand_mask [..., N], row_mask [...].  Rows
    without a click contribute zero; the mean is over valid rows."""
    logp = masked_log_softmax(scores, cand_mask)
    y = labels * cand_mask.to(labels.dtype)
    y_sum = y.sum(-1, keepdim=True)
    y_norm = y / y_sum.clamp_min(1.0)
    per_row = -(y_norm * logp).sum(-1)
    valid = row_mask.to(scores.dtype) * (y_sum[..., 0] > 0)
    return (per_row * valid).sum() / valid.sum().clamp_min(1.0)


def pairwise_hinge_loss(scores: torch.Tensor, labels: torch.Tensor,
                        cand_mask: torch.Tensor, row_mask: torch.Tensor,
                        margin: float = 1.0) -> torch.Tensor:
    """max(0, margin - s_pos + s_neg) over all (pos, neg) pairs per row."""
    pos = (labels > 0) & cand_mask
    neg = (labels <= 0) & cand_mask
    diff = margin - scores[..., :, None] + scores[..., None, :]
    pair_mask = (pos[..., :, None] & neg[..., None, :]).to(scores.dtype)
    pair_mask = pair_mask * row_mask[..., None, None].to(scores.dtype)
    loss = diff.clamp_min(0.0) * pair_mask
    return loss.sum() / pair_mask.sum().clamp_min(1.0)


def pointwise_bce_loss(scores: torch.Tensor, labels: torch.Tensor,
                       cand_mask: torch.Tensor,
                       row_mask: torch.Tensor) -> torch.Tensor:
    per = -(labels * F.logsigmoid(scores)
            + (1.0 - labels) * F.logsigmoid(-scores))
    m = cand_mask.to(scores.dtype) * row_mask[..., None].to(scores.dtype)
    return (per * m).sum() / m.sum().clamp_min(1.0)


def rank_loss(loss_type: str, scores, labels, cand_mask, row_mask,
              margin: float = 1.0) -> torch.Tensor:
    if loss_type == "listwise":
        return listwise_rank_loss(scores, labels, cand_mask, row_mask)
    if loss_type == "pairwise":
        return pairwise_hinge_loss(scores, labels, cand_mask, row_mask,
                                   margin)
    if loss_type == "pointwise":
        return pointwise_bce_loss(scores, labels, cand_mask, row_mask)
    raise ValueError(f"unknown loss_type {loss_type!r}")


def sequence_nll_loss(logits: torch.Tensor, targets: torch.Tensor,
                      target_mask: torch.Tensor,
                      label_smoothing: float = 0.0) -> torch.Tensor:
    """Token-level NLL of teacher-forced logits [..., T, V] against targets
    [..., T] (int), mean over the tokens where ``target_mask`` is True."""
    logp = torch.log_softmax(logits, dim=-1)
    tgt_logp = logp.gather(-1, targets[..., None].long())[..., 0]
    if label_smoothing > 0:
        tgt_logp = ((1 - label_smoothing) * tgt_logp
                    + label_smoothing * logp.mean(-1))
    m = target_mask.to(logits.dtype)
    return -(tgt_logp * m).sum() / m.sum().clamp_min(1.0)


def copy_generator_nll_loss(gen_probs: torch.Tensor, targets: torch.Tensor,
                            target_mask: torch.Tensor) -> torch.Tensor:
    """NLL over already-normalised generate + copy probabilities
    [..., T, V]."""
    p = gen_probs.gather(-1, targets[..., None].long())[..., 0]
    logp = torch.log(p.clamp_min(1e-10))
    m = target_mask.to(gen_probs.dtype)
    return -(logp * m).sum() / m.sum().clamp_min(1.0)


__all__ = [
    "listwise_rank_loss", "pairwise_hinge_loss", "pointwise_bce_loss",
    "rank_loss", "sequence_nll_loss", "copy_generator_nll_loss",
]
