"""M-MatchTensor: multitask MatchTensor, interaction ranking plus query
suggestion (port of
``context_attentive_ir_tpu/models/multitask/m_match_tensor.py``).

Each candidate of each turn gets a match tensor ``[Lq, Ld, C + 1]``: the
product of the query and document token states projected to C channels
(``q_proj``, ``d_proj``) plus an exact-match channel (``query == doc``,
not PAD), both zero outside ``query_mask x doc_mask``.  Two 3x3 ``SAME``
convolutions with a 2x2 max pool between them (floor: Lq = 15 -> 7) and a
max over both spatial axes give C features, which a ReLU MLP scores
beside the session state.  The suggestion head is M-NSRF's (the session
recurrence over max-pooled query vectors, the attention decoder over the
session states).  Parameter names mirror the JAX tree (``conv0.kernel
[3, 3, C + 1, C]``, the flax layout), so ``convert.params_from_jax`` is a
rename.

At the serving widths (B = 64, S = 5, N = 50, Lq = 15, Ld = 30, C = 32)
the match tensor is ``[16000, 15, 30, 33]``, 475 MB in bf16; it is built
once a call in the compute dtype, the masks folded into the two factors
(the same numbers as masking the product), by the Match-Tensor ranker's
``match_tensor`` and ``match_features``.  The convolutions run on a
channels-last view (``ops/layers.Conv``).  As in the JAX model there is no
``decode_step_fused``, ``encode_docs`` or ``decode_init_full``.
"""

from __future__ import annotations

import torch

from ...config import ModelConfig
from ...data.vectorize import SessionBatch
from ...ops.layers import MLP, Conv, Dense
from ..rankers.match_tensor import match_features, match_tensor
from .mnsrf import SessionSuggester


class MMatchTensor(SessionSuggester):
    """``seed`` fills the weights from a seeded CPU generator; ``seed=None``
    leaves them uninitialised, for loading a state dict (and on the
    ``meta`` device, for reading the parameter names and shapes)."""

    model_type = "m_match_tensor"

    def build_rank_head(self, cfg: ModelConfig, dt, dev) -> None:
        C = cfg.nfilters
        self.q_proj = Dense(self.h2, C, dtype=dt, device=dev)
        self.d_proj = Dense(self.h2, C, dtype=dt, device=dev)
        self.conv0 = Conv(C + 1, C, (3, 3), "SAME", dtype=dt, device=dev)
        self.conv1 = Conv(C, C, (3, 3), "SAME", dtype=dt, device=dev)
        self.rank_mlp = MLP(C + self.h2, (cfg.nhid_ffnn, 1),
                            activation=torch.relu, final_activation=False,
                            dtype=dt, device=dev, dropout=cfg.dropout)

    def match_tensor(self, batch: SessionBatch, q_states: torch.Tensor,
                     d_states: torch.Tensor) -> torch.Tensor:
        """``[B*S*N, Lq, Ld, C + 1]``: the channel products of the projected
        query and document states and the exact-match channel, zero where
        either token is padding (``rankers.match_tensor.match_tensor`` per
        turn)."""
        B, S, N, Ld = batch.docs.shape
        Lq = batch.query.shape[-1]
        tensor = match_tensor(self.q_proj(q_states), self.d_proj(d_states),
                              batch.query, batch.docs, batch.query_mask,
                              batch.doc_mask)
        return tensor.reshape(B * S * N, Lq, Ld, -1)

    def encode_session(self, batch: SessionBatch, deterministic: bool = True,
                       generator: torch.Generator | None = None):
        """-> ((match features [B, S, N, C],), session states [B, S, H2])."""
        B, S, N, _ = batch.docs.shape
        q_states, qv = self.query_states(batch, deterministic, generator)
        d_states = self.doc_states(batch, deterministic, generator)
        z = match_features(self.conv0, self.conv1,
                           self.match_tensor(batch, q_states, d_states))
        sess, _ = self.session_rnn(qv, batch.turn_mask)
        return (z.reshape(B, S, N, -1),), sess

    def rank_scores(self, z, sess, deterministic: bool = True,
                    generator: torch.Generator | None = None):
        """The ReLU MLP over ``[z, s]`` -> [B, S, N]."""
        sb = sess[:, :, None, :].expand(*z.shape[:3], sess.shape[-1])
        return self.rank_mlp(torch.cat([z, sb], dim=-1), deterministic,
                             generator)[..., 0]
