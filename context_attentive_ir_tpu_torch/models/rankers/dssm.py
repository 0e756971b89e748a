"""DSSM: Deep Structured Semantic Model, a two-tower MLP (port of
``context_attentive_ir_tpu/models/rankers/dssm.py``).

Each side's masked-mean word embedding (with ``use_charngram``, its
char-CNN word vectors pooled the same way and concatenated) goes through
the shared tanh ``tower`` (nhid_ffnn, nhid_ffnn, 128); the score is
``gamma`` (a learned temperature, 10 at init) times the cosine of the two
towers' outputs, in float32 as JAX promotes it.
"""

from __future__ import annotations

import torch

from ...config import ModelConfig
from ...constants import CHAR_VOCAB_SIZE
from ...ops.layers import MLP, CharCNN, cosine_similarity
from ...ops.masking import masked_mean
from ..base import Ranker, make_embeddings


class DSSM(Ranker):
    model_type = "dssm"

    def build(self, cfg: ModelConfig, dt, dev) -> None:
        self.embeddings = make_embeddings(cfg, dev)
        width = cfg.emsize
        if cfg.use_charngram:
            self.char_cnn = CharCNN(CHAR_VOCAB_SIZE, dtype=dt, device=dev)
            width += self.char_cnn.features
        self.tower = MLP(width, (cfg.nhid_ffnn, cfg.nhid_ffnn, 128),
                         activation=torch.tanh, dtype=dt, device=dev,
                         dropout=cfg.dropout)
        self.gamma = self.new_param("gamma", (), "constant:10.0")

    def forward(self, batch, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        q = masked_mean(self.embeddings(batch.query, deterministic,
                                        generator), batch.query_mask)
        d = masked_mean(self.embeddings(batch.docs, deterministic,
                                        generator), batch.doc_mask)
        if self.config.use_charngram:
            if batch.query_chars is None or batch.doc_chars is None:
                raise ValueError("dssm with use_charngram needs a RankBatch "
                                 "with query_chars and doc_chars (shapes "
                                 "with max_word_len > 0)")
            qc = masked_mean(self.char_cnn(batch.query_chars),
                             batch.query_mask)
            dc = masked_mean(self.char_cnn(batch.doc_chars), batch.doc_mask)
            q = torch.cat([q, qc], dim=-1)
            d = torch.cat([d, dc], dim=-1)
        qv = self.tower(q, deterministic, generator)         # [B, 128]
        dv = self.tower(d, deterministic, generator)         # [B, N, 128]
        return self.gamma * cosine_similarity(qv[:, None, :], dv).float()
