"""DUET: a local exact-match branch plus a distributed branch (port of
``context_attentive_ir_tpu/models/rankers/duet.py``).

Local: the binary matrix ``X[i, j] = 1`` iff query token i equals document
token j (both valid), a ``SAME`` 1-D convolution over the document axis
with the query positions as channels, tanh, a max over the valid document
positions (0 for an empty document), a tanh MLP.  Distributed: the
convolved query max-pooled to one vector, times each convolved document
position, summed over the document, a tanh MLP.  The score is the sum.
"""

from __future__ import annotations

import torch

from ...config import ModelConfig
from ...ops.layers import MLP, Conv
from ...ops.masking import masked_max
from ..base import Ranker, make_embeddings


class DUET(Ranker):
    model_type = "duet"

    def build(self, cfg: ModelConfig, dt, dev) -> None:
        C = cfg.nfilters

        def mlp():
            return MLP(C, (cfg.nhid_ffnn, 1), activation=torch.tanh,
                       final_activation=False, dtype=dt, device=dev,
                       dropout=cfg.dropout)

        # the local convolution's channels are the query positions
        self.local_conv = Conv(cfg.max_query_len, C, (3,), dtype=dt,
                               device=dev)
        self.local_mlp = mlp()
        self.embeddings = make_embeddings(cfg, dev)
        self.dist_q_conv = Conv(cfg.emsize, C, (3,), dtype=dt, device=dev)
        self.dist_d_conv = Conv(cfg.emsize, C, (3,), dtype=dt, device=dev)
        self.dist_mlp = mlp()

    def forward(self, batch, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        B, N, Ld = batch.docs.shape
        Lq = batch.query.shape[1]
        dt = self.dtype

        # local branch: exact matches, masked by the masks (a masked slot
        # may hold any id)
        match = ((batch.query[:, None, :, None] == batch.docs[:, :, None, :])
                 & batch.query_mask[:, None, :, None]
                 & batch.doc_mask[:, :, None, :])
        x = match.to(dt).reshape(B * N, Lq, Ld).transpose(1, 2)
        dm = batch.doc_mask.reshape(B * N, Ld)
        h = masked_max(torch.tanh(self.local_conv(x)), dm)   # [B*N, C]
        h = torch.where(dm.any(-1, keepdim=True), h, 0.0)
        local = self.local_mlp(h, deterministic, generator)[..., 0]
        local = local.reshape(B, N)

        # distributed branch
        q = self.embeddings(batch.query, deterministic, generator)
        d = self.embeddings(batch.docs, deterministic, generator)
        q = q * batch.query_mask[..., None].to(q.dtype)
        d = d * batch.doc_mask[..., None].to(d.dtype)
        qv = masked_max(torch.tanh(self.dist_q_conv(q)),
                        batch.query_mask)                     # [B, C]
        dh = torch.tanh(self.dist_d_conv(d.reshape(B * N, Ld, -1)))
        dh = dh * dm[..., None].to(dt)
        pooled = (qv[:, None, None, :] * dh.reshape(B, N, Ld, -1)).sum(-2)
        dist = self.dist_mlp(pooled, deterministic, generator)[..., 0]
        return local + dist                                   # [B, N]
