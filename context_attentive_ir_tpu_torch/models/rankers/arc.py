"""ARC-I and ARC-II (Hu et al. 2014; port of
``context_attentive_ir_tpu/models/rankers/arc.py``).

- ARC-I: a 1-D CNN per side (``SAME`` convolutions with ReLU, one per
  filter width, then a masked max over the tokens), an MLP on the
  concatenated sentence vectors.
- ARC-II: interaction first -- ``z[i, j] = relu(W_q q_i + W_d d_j + b)``
  over the valid word pairs (two matmuls and a broadcast add), two blocks
  of a 3x3 ``SAME`` convolution, ReLU and a 2x2 max pool over the
  flattened ``[B*N, Lq, Ld, C]`` slate, then an MLP on the flattened map.
"""

from __future__ import annotations

import torch

from ...config import ModelConfig
from ...ops.layers import MLP, Conv, Dense, dropout, max_pool
from ...ops.masking import masked_max
from ..base import Ranker, make_embeddings


def _scorer(in_features: int, cfg: ModelConfig, dt, dev) -> MLP:
    return MLP(in_features, (cfg.nhid_ffnn, 1), activation=torch.relu,
               final_activation=False, dtype=dt, device=dev,
               dropout=cfg.dropout)


class ARCI(Ranker):
    model_type = "arci"

    def build(self, cfg: ModelConfig, dt, dev) -> None:
        self.embeddings = make_embeddings(cfg, dev)
        for side in ("q", "d"):
            width = cfg.emsize
            for i, w in enumerate(cfg.filter_widths):
                self.add_module(f"{side}_conv{i}", Conv(
                    width, cfg.nfilters, (w,), dtype=dt, device=dev))
                width = cfg.nfilters
        self.scorer = _scorer(2 * cfg.nfilters, cfg, dt, dev)

    def encode(self, x, mask, side: str) -> torch.Tensor:
        """x [R, T, E], mask [R, T] -> [R, C].  Pad positions are zeroed
        first: the convolutions' receptive fields would read them."""
        h = x * mask[..., None].to(x.dtype)
        for i in range(len(self.config.filter_widths)):
            h = torch.relu(getattr(self, f"{side}_conv{i}")(h))
        return masked_max(h, mask)

    def forward(self, batch, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        q = self.embeddings(batch.query, deterministic, generator)
        d = self.embeddings(batch.docs, deterministic, generator)
        B, N, Ld, E = d.shape
        qv = self.encode(q, batch.query_mask, "q")                  # [B, C]
        dv = self.encode(d.reshape(B * N, Ld, E),
                         batch.doc_mask.reshape(B * N, Ld),
                         "d").reshape(B, N, -1)                     # [B, N, C]
        pair = torch.cat([qv[:, None, :].expand_as(dv), dv], dim=-1)
        return self.scorer(pair, deterministic, generator)[..., 0]


class ARCII(Ranker):
    model_type = "arcii"

    def build(self, cfg: ModelConfig, dt, dev) -> None:
        C = cfg.nfilters
        self.embeddings = make_embeddings(cfg, dev)
        self.w_q = Dense(cfg.emsize, C, dtype=dt, device=dev)
        self.w_d = Dense(cfg.emsize, C, use_bias=False, dtype=dt, device=dev)
        for i in range(2):
            self.add_module(f"conv{i}", Conv(C, C, (3, 3), dtype=dt,
                                             device=dev))
        # two 2x2 pools, each flooring
        pooled = (cfg.max_query_len // 2 // 2) * (cfg.max_doc_len // 2 // 2)
        flat = C * pooled
        self.scorer = _scorer(flat, cfg, dt, dev)

    def forward(self, batch, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        q = self.embeddings(batch.query, deterministic, generator)
        d = self.embeddings(batch.docs, deterministic, generator)
        B, N, Ld, _ = d.shape
        Lq = q.shape[1]
        qf = self.w_q(q)                                    # [B, Lq, C]
        df = self.w_d(d)                                    # [B, N, Ld, C]
        z = torch.relu(qf[:, None, :, None, :] + df[:, :, None, :, :])
        pair_mask = (batch.query_mask[:, None, :, None]
                     & batch.doc_mask[:, :, None, :])
        z = z * pair_mask[..., None].to(z.dtype)
        z = z.reshape(B * N, Lq, Ld, -1)
        for i in range(2):
            z = max_pool(torch.relu(getattr(self, f"conv{i}")(z)), (2, 2),
                         (2, 2))
        z = dropout(z.reshape(B, N, -1), self.config.dropout, deterministic,
                    generator)
        return self.scorer(z, deterministic, generator)[..., 0]
