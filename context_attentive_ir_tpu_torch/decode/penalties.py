"""Beam-search penalties.

Wu et al. (GNMT) and average length penalties (the reference's
OpenNMT-style ``translator/penalties.py``).

Port of ``context_attentive_ir_tpu/decode/penalties.py`` (length
penalties; the coverage penalties wait for a step mode that exposes
attention).
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
