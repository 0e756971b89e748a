"""Match-Tensor (Jaech et al. 2017): a 3-D similarity tensor ranker (port
of ``context_attentive_ir_tpu/models/rankers/match_tensor.py``).

A BiLSTM (or GRU) over each side's tokens (``ops/rnn.RNNEncoder``: kernel
1 when serving, the pair 4 + 5 when training; 7 or 8 + 9 with
``rnn_type="gru"``), the states projected to C channels (``q_proj``,
``d_proj``); each candidate's match tensor ``[Lq, Ld, C + 1]`` holds their
channel products and an exact-match channel (``query == doc``, not PAD),
both zero outside ``query_mask x doc_mask``; two 3x3 ``SAME`` convolutions
with a 2x2 max pool between them and a max over both spatial axes give C
features, which a ReLU MLP scores.  ``match_tensor`` and ``match_features``
are shared with M-MatchTensor, which builds one tensor per turn.  The JAX
``lookup_padded`` is a TPU lane pad and is exact to drop.
"""

from __future__ import annotations

import torch

from ...config import ModelConfig
from ...constants import PAD
from ...ops.layers import MLP, Conv, Dense, dropout, max_pool
from ...ops.rnn import RNNEncoder
from ..base import Ranker, make_embeddings


def match_tensor(qp: torch.Tensor, dp: torch.Tensor, query: torch.Tensor,
                 docs: torch.Tensor, query_mask: torch.Tensor,
                 doc_mask: torch.Tensor) -> torch.Tensor:
    """Projected states ``qp [..., Lq, C]``, ``dp [..., N, Ld, C]`` and
    their ids and masks -> ``[..., N, Lq, Ld, C + 1]``: the channel
    products and the exact-match channel, zero where either token is
    padding (the masks folded into the two factors: the same numbers as
    masking the product)."""
    qm = query_mask[..., None].to(qp.dtype)
    dm = doc_mask[..., None].to(dp.dtype)
    prod = (qp * qm)[..., None, :, None, :] * (dp * dm)[..., :, None, :, :]
    q = query[..., None, :, None]
    exact = ((q == docs[..., :, None, :]) & (q != PAD)
             & query_mask[..., None, :, None] & doc_mask[..., :, None, :])
    return torch.cat([prod, exact[..., None].to(prod.dtype)], dim=-1)


def match_features(conv0: Conv, conv1: Conv, z: torch.Tensor) -> torch.Tensor:
    """``[R, Lq, Ld, C + 1]`` -> ``[R, C]``: conv0, ReLU, 2x2 max pool
    (floor), conv1, ReLU, max over both spatial axes."""
    z = max_pool(torch.relu(conv0(z)), (2, 2), (2, 2))
    return torch.relu(conv1(z)).amax(dim=(1, 2))


class MatchTensor(Ranker):
    model_type = "match_tensor"

    def build(self, cfg: ModelConfig, dt, dev) -> None:
        C = cfg.nfilters
        h2 = cfg.nhid * (2 if cfg.bidirection else 1)
        self.embeddings = make_embeddings(cfg, dev)
        for name in ("query_encoder", "doc_encoder"):
            self.add_module(name, RNNEncoder(
                cfg.emsize, cfg.nhid, cfg.nlayers, cfg.bidirection,
                use_kernel=cfg.use_pallas_rnn, dtype=dt, device=dev,
                dropout=cfg.dropout_rnn, rnn_type=cfg.rnn_type))
        self.q_proj = Dense(h2, C, dtype=dt, device=dev)
        self.d_proj = Dense(h2, C, dtype=dt, device=dev)
        self.conv0 = Conv(C + 1, C, (3, 3), dtype=dt, device=dev)
        self.conv1 = Conv(C, C, (3, 3), dtype=dt, device=dev)
        self.scorer = MLP(C, (cfg.nhid_ffnn, 1), activation=torch.relu,
                          final_activation=False, dtype=dt, device=dev,
                          dropout=cfg.dropout)

    def forward(self, batch, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        q = self.embeddings(batch.query, deterministic, generator)
        d = self.embeddings(batch.docs, deterministic, generator)
        B, N, Ld, E = d.shape
        Lq = q.shape[1]
        qs, _ = self.query_encoder(q, batch.query_mask, deterministic,
                                   generator)                  # [B, Lq, H2]
        ds, _ = self.doc_encoder(d.reshape(B * N, Ld, E),
                                 batch.doc_mask.reshape(B * N, Ld),
                                 deterministic, generator)
        tensor = match_tensor(self.q_proj(qs),
                              self.d_proj(ds.reshape(B, N, Ld, -1)),
                              batch.query, batch.docs, batch.query_mask,
                              batch.doc_mask)           # [B, N, Lq, Ld, C+1]
        z = match_features(self.conv0, self.conv1,
                           tensor.reshape(B * N, Lq, Ld, -1))
        z = dropout(z.reshape(B, N, -1), self.config.dropout, deterministic,
                    generator)
        return self.scorer(z, deterministic, generator)[..., 0]   # [B, N]
