"""Beam-search penalties.

Wu et al. (GNMT) and average length penalties, Wu and summary coverage
penalties (the reference's OpenNMT-style ``translator/penalties.py``).
``beam_search`` applies a coverage penalty when the step function exposes
its attention weights.

Port of ``context_attentive_ir_tpu/decode/penalties.py``.
"""

from __future__ import annotations

import torch


def length_wu(lengths: torch.Tensor, alpha: float = 0.6) -> torch.Tensor:
    """GNMT length normalizer ((5 + len) / 6)^alpha (Wu et al. 2016)."""
    return torch.pow((5.0 + lengths.float()) / 6.0, alpha)


def length_average(lengths: torch.Tensor, alpha: float = 0.0) -> torch.Tensor:
    """Plain per-token average."""
    del alpha
    return lengths.float().clamp_min(1.0)


def length_none(lengths: torch.Tensor, alpha: float = 0.0) -> torch.Tensor:
    """Raw cumulative log-prob (no normalization)."""
    del alpha
    return torch.ones_like(lengths, dtype=torch.float32)


LENGTH_PENALTIES = {
    "wu": length_wu,
    "avg": length_average,
    "none": length_none,
}


def coverage_wu(coverage: torch.Tensor, mask: torch.Tensor,
                beta: float = 0.0) -> torch.Tensor:
    """GNMT coverage penalty: beta * sum_j log(min(cov_j, 1)).

    coverage [..., L] is the attention mass accumulated per source
    position; mask [..., L] marks real source tokens.  Returns a value to
    add to the hypothesis score (it is <= 0: hypotheses that ignore source
    tokens are penalized).
    """
    logs = torch.log(coverage.clamp(1e-6, 1.0)) * mask.to(coverage.dtype)
    return beta * logs.sum(dim=-1)


def coverage_summary(coverage: torch.Tensor, mask: torch.Tensor,
                     beta: float = 0.0) -> torch.Tensor:
    """OpenNMT 'summary' coverage: -beta * (sum_j max(cov_j, 1) - L)."""
    m = mask.to(coverage.dtype)
    over = (coverage.clamp_min(1.0) * m).sum(dim=-1) - m.sum(dim=-1)
    return -beta * over


COVERAGE_PENALTIES = {
    "wu": coverage_wu,
    "summary": coverage_summary,
}
