"""ESM: Embedding Space Model (port of
``context_attentive_ir_tpu/models/rankers/esm.py``).

The masked mean of the word embeddings of the query and of each document,
then their cosine: the whole slate in one masked mean and one cosine.
Under its published flags (``fix_embeddings=True``) the table is its only
parameter and is frozen, so a train step takes a step (the count advances,
the metrics are reported) and moves nothing, as in JAX.
"""

from __future__ import annotations

import torch

from ...config import ModelConfig
from ...ops.layers import cosine_similarity
from ...ops.masking import masked_mean
from ..base import Ranker, make_embeddings


class ESM(Ranker):
    model_type = "esm"

    def build(self, cfg: ModelConfig, dt, dev) -> None:
        self.embeddings = make_embeddings(cfg, dev)

    def forward(self, batch, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        q = self.embeddings(batch.query, deterministic, generator)
        d = self.embeddings(batch.docs, deterministic, generator)
        qv = masked_mean(q, batch.query_mask)               # [B, E]
        dv = masked_mean(d, batch.doc_mask)                 # [B, N, E]
        return cosine_similarity(qv[:, None, :], dv)        # [B, N]
