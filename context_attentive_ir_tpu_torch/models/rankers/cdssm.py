"""CDSSM: convolutional DSSM (port of
``context_attentive_ir_tpu/models/rankers/cdssm.py``).

One ``_ConvTower`` serves both sides: the pad positions zeroed, per filter
width a ``SAME`` 1-D convolution, tanh and a masked max over the tokens,
the widths concatenated, dropout, a 128-wide tanh projection.  The doc
tower convolves the flattened ``[B*N, Ld, E]`` slate in one call.  The
score is ``gamma`` times the cosine, in float32 as JAX promotes it.  An
empty candidate slot pools to ``NEG_INF`` in every feature, as in JAX; its
projection saturates the tanh.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...config import ModelConfig
from ...ops.layers import Conv, Dense, cosine_similarity, dropout
from ...ops.masking import masked_max
from ..base import Ranker, make_embeddings


class _ConvTower(nn.Module):
    """x [R, T, E], mask [R, T] -> [R, out_dim]."""

    def __init__(self, in_features: int, nfilters: int,
                 widths: Sequence[int], out_dim: int, rate: float,
                 dtype: torch.dtype, device):
        super().__init__()
        self.widths = tuple(widths)
        self.rate = rate
        for w in self.widths:
            self.add_module(f"conv{w}", Conv(in_features, nfilters, (w,),
                                             dtype=dtype, device=device))
        self.proj = Dense(nfilters * len(self.widths), out_dim, dtype=dtype,
                          device=device)

    def forward(self, x, mask, deterministic: bool = True,
                generator: torch.Generator | None = None):
        x = x * mask[..., None].to(x.dtype)
        h = torch.cat([masked_max(torch.tanh(getattr(self, f"conv{w}")(x)),
                                  mask) for w in self.widths], dim=-1)
        h = dropout(h, self.rate, deterministic, generator)
        return torch.tanh(self.proj(h))


class CDSSM(Ranker):
    model_type = "cdssm"

    def build(self, cfg: ModelConfig, dt, dev) -> None:
        self.embeddings = make_embeddings(cfg, dev)
        self.tower = _ConvTower(cfg.emsize, cfg.nfilters, cfg.filter_widths,
                                128, cfg.dropout, dt, dev)
        self.gamma = self.new_param("gamma", (), "constant:10.0")

    def forward(self, batch, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        q = self.embeddings(batch.query, deterministic, generator)
        d = self.embeddings(batch.docs, deterministic, generator)
        B, N, Ld, E = d.shape
        qv = self.tower(q, batch.query_mask, deterministic, generator)
        dv = self.tower(d.reshape(B * N, Ld, E),
                        batch.doc_mask.reshape(B * N, Ld), deterministic,
                        generator).reshape(B, N, -1)
        return self.gamma * cosine_similarity(qv[:, None, :], dv).float()
