"""DRMM (Guo et al. 2016): matching histograms and term gating (port of
``context_attentive_ir_tpu/models/rankers/drmm.py``).

Per query term, the cosines to every document term, bucketed into
``NUM_BINS`` bins over [-1, 1] (a cosine goes to the bin of the interior
edges it strictly exceeds: ``bucketize``, no ``[..., Ld, K]`` one-hot),
counted over the valid (query, document) pairs, log1p (the LCH variant),
scored by a tanh MLP; a softmax over a linear gate of the valid query terms
mixes the per-term scores.  The histogram is piecewise constant in the
weights, so only the gate and the MLP take gradients from it, as in JAX.

The edges are the float32 values nearest ``linspace(-1, 1, 31)``; the JAX
package's ``jnp.linspace`` rounds some of them one ulp away, so a cosine
within an ulp of an edge may land in the neighbouring bin of the other
package.
"""

from __future__ import annotations

import numpy as np
import torch

from ...config import ModelConfig
from ...ops.layers import MLP, Dense
from ...ops.masking import masked_softmax
from ..base import Ranker, make_embeddings

NUM_BINS = 30
# the NUM_BINS - 1 interior edges
EDGES = np.linspace(-1.0, 1.0, NUM_BINS + 1)[1:-1].astype(np.float32)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1,
                                        keepdim=True).clamp_min(1e-8)


class DRMM(Ranker):
    model_type = "drmm"

    def build(self, cfg: ModelConfig, dt, dev) -> None:
        self.embeddings = make_embeddings(cfg, dev)
        self.hist_mlp = MLP(NUM_BINS, (cfg.nhid_ffnn, cfg.nhid_ffnn, 1),
                            activation=torch.tanh, final_activation=False,
                            dtype=dt, device=dev)
        self.gate = Dense(cfg.emsize, 1, use_bias=False, dtype=dt,
                          device=dev)

    def histogram(self, batch, q, d) -> torch.Tensor:
        """log1p of the bin counts [B, N, Lq, NUM_BINS] over the valid
        (query term, document term) pairs."""
        cos = torch.einsum("bqe,bnde->bnqd", _unit(q), _unit(d))
        edges = torch.from_numpy(EDGES).to(cos.device)
        # the count of interior edges strictly below each cosine (compared
        # in float32, as JAX promotes the bf16 cosines against its edges)
        bins = torch.bucketize(cos.float().contiguous(), edges)
        pm = (batch.doc_mask[:, :, None, :]
              & batch.query_mask[:, None, :, None]).float()
        counts = torch.zeros((*bins.shape[:-1], NUM_BINS),
                             device=cos.device).scatter_add_(-1, bins, pm)
        return torch.log1p(counts.to(self.dtype))

    def forward(self, batch, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        q = self.embeddings(batch.query, deterministic, generator)
        d = self.embeddings(batch.docs, deterministic, generator)
        hist = self.histogram(batch, q, d)
        term_score = self.hist_mlp(hist)[..., 0]                # [B, N, Lq]
        gate = masked_softmax(self.gate(q)[..., 0], batch.query_mask)
        return torch.einsum("bnq,bq->bn", term_score, gate)     # [B, N]
