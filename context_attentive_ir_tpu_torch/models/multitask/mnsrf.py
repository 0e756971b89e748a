"""M-NSRF: Multi-task Neural Session Relevance Framework (Ahmad et al.
2018; port of ``context_attentive_ir_tpu/models/multitask/mnsrf.py``).

A BiLSTM (or GRU) query encoder and document encoder, each max-pooled over
its tokens; a session recurrence over the S query vectors; ranking scores
from an MLP over ``[q~, d, q~ * d]`` with the session-aware query ``q~ =
tanh(W[q; s])``; an attention decoder generates each turn's next query
from the session states it may see (turns <= t).  All S turns x N
candidates encode in one flattened pass (``[B*S*N, Ld]``), and all S
decoders run as one teacher-forced unroll over ``[B*S]`` rows.  Parameter
names mirror the JAX tree, so ``convert.params_from_jax`` is a rename.

A padded turn or candidate pools to ``NEG_INF`` in every feature, as in
JAX; those rows flow on into ``sess_mix``, the session recurrence and the
rank MLP and are masked in the loss.  As in the JAX model there is no
``decode_step_fused``, ``encode_docs`` or ``decode_init_full``: the engine
decodes through ``decode_step``'s logits, and the cached-document calls
raise ``ServeError``.
"""

from __future__ import annotations

import torch
from torch import nn

from ...config import ModelConfig
from ...data.vectorize import SessionBatch
from ...device import resolve_device
from ...ops.decoder import AttnLSTMDecoder
from ...ops.layers import MLP, Dense, reset_parameters
from ...ops.masking import masked_max
from ...ops.rnn import RNNEncoder, RNNLayer
from ..base import check_rnn_types, compute_dtype, make_embeddings
from ..generator import Generator
from ..losses import sequence_nll_loss


def inclusive_causal_mask(turn_mask: torch.Tensor) -> torch.Tensor:
    """[B, S] -> [B, S, S]: turn t sees turns <= t (valid ones only)."""
    S = turn_mask.shape[-1]
    tri = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                device=turn_mask.device))
    return tri[None] & turn_mask[:, None, :]


class SessionSuggester(nn.Module):
    """What M-NSRF and M-MatchTensor share: the embeddings, the two
    encoders, the session recurrence (no kernel, as in JAX: it starts from
    a state), the decoder and the generator; the max-pooled query flow;
    the decoder over the session states; the inference methods.  A
    subclass builds its ranking layers in ``build_rank_head`` and defines
    ``encode_session``, ``rank_scores`` and ``score``."""

    model_type = ""
    # the suggestion loss of ``forward``'s ``gen_logits``
    target_nll = staticmethod(sequence_nll_loss)

    def __init__(self, config: ModelConfig, device="cuda",
                 seed: int | None = 0):
        super().__init__()
        cfg = config
        if cfg.model_type != self.model_type:
            raise ValueError(f"{type(self).__name__} needs model_type "
                             f"{self.model_type!r}, got {cfg.model_type!r}")
        check_rnn_types(cfg)
        dev = resolve_device(device)
        dt = compute_dtype(cfg)
        self.config = cfg
        self.h2 = cfg.nhid * (2 if cfg.bidirection else 1)
        self.embeddings = make_embeddings(cfg, dev)
        for name in ("query_encoder", "doc_encoder"):
            self.add_module(name, RNNEncoder(
                cfg.emsize, cfg.nhid, cfg.nlayers, cfg.bidirection,
                use_kernel=cfg.use_pallas_rnn, dtype=dt, device=dev,
                dropout=cfg.dropout_rnn, rnn_type=cfg.rnn_type))
        self.session_rnn = RNNLayer(self.h2, self.h2, bidirectional=False,
                                    dtype=dt, device=dev,
                                    rnn_type=cfg.session_rnn_type)
        self.build_rank_head(cfg, dt, dev)
        self.decoder = AttnLSTMDecoder(self.h2, cfg.emsize, cfg.nlayers,
                                       cfg.attn_type, dtype=dt, device=dev,
                                       dropout=cfg.dropout_rnn)
        self.generator = Generator(self.h2, self.embeddings,
                                   tie=cfg.tie_embeddings,
                                   vocab_size=cfg.vocab_size, dtype=dt,
                                   device=dev)
        if seed is not None and dev.type != "meta":
            reset_parameters(self, seed)

    def build_rank_head(self, cfg: ModelConfig, dt, dev) -> None:
        raise NotImplementedError

    # -- encoding ------------------------------------------------------------

    def query_states(self, batch: SessionBatch, deterministic: bool = True,
                     generator: torch.Generator | None = None):
        """-> (query token states [B, S, Lq, H2], max-pooled query vectors
        [B, S, H2])."""
        B, S, Lq = batch.query.shape
        q = self.embeddings(batch.query, deterministic, generator)
        q_states, _ = self.query_encoder(q.reshape(B * S, Lq, -1),
                                         batch.query_mask.reshape(B * S, Lq),
                                         deterministic, generator)
        q_states = q_states.reshape(B, S, Lq, -1)
        return q_states, masked_max(q_states, batch.query_mask, dim=-2)

    def doc_states(self, batch: SessionBatch, deterministic: bool = True,
                   generator: torch.Generator | None = None) -> torch.Tensor:
        """Document token states [B, S, N, Ld, H2]."""
        B, S, N, Ld = batch.docs.shape
        d = self.embeddings(batch.docs, deterministic, generator)
        d_states, _ = self.doc_encoder(d.reshape(B * S * N, Ld, -1),
                                       batch.doc_mask.reshape(B * S * N, Ld),
                                       deterministic, generator)
        return d_states.reshape(B, S, N, Ld, -1)

    def encode_queries(self, batch: SessionBatch, deterministic: bool = True,
                       generator: torch.Generator | None = None):
        """Query-only session states [B, S, H2]: the suggestion head
        depends on the query flow alone, so decoding never encodes the
        document slate."""
        _, qv = self.query_states(batch, deterministic, generator)
        sess, _ = self.session_rnn(qv, batch.turn_mask)
        return sess

    @staticmethod
    def _decoder_inputs(sess: torch.Tensor, turn_mask: torch.Tensor):
        """Every turn's decoder memory (all S session states, ``[B*S, S,
        H2]``), its inclusive causal mask and its init state (the turn's
        own session state)."""
        B, S, H = sess.shape
        memory = sess[:, None].expand(B, S, S, H).reshape(B * S, S, H)
        mem_mask = inclusive_causal_mask(turn_mask).reshape(B * S, S)
        return memory, mem_mask, sess.reshape(B * S, H)

    # -- training forward ----------------------------------------------------

    def forward(self, batch: SessionBatch, deterministic: bool = True,
                generator: torch.Generator | None = None) -> dict:
        """``{"scores" [B, S, N], "gen_logits" [B, S, Lt, V]}`` (JAX
        ``__call__``); ``deterministic=False`` turns dropout on, its noise
        drawn from ``generator``."""
        B, S, _ = batch.query.shape
        Lt = batch.target_in.shape[-1]
        feats, sess = self.encode_session(batch, deterministic, generator)
        scores = self.rank_scores(*feats, sess, deterministic, generator)
        memory, mem_mask, init = self._decoder_inputs(sess, batch.turn_mask)
        tgt = self.embeddings(batch.target_in, deterministic, generator)
        attn_hs, _ = self.decoder(tgt.reshape(B * S, Lt, -1), memory,
                                  mem_mask, init, deterministic, generator)
        logits = self.generator(attn_hs, self.embeddings)
        return {"scores": scores, "gen_logits": logits.reshape(B, S, Lt, -1)}

    # -- inference -----------------------------------------------------------

    @torch.inference_mode()
    def score(self, batch: SessionBatch) -> torch.Tensor:
        """Slate scores [B, S, N]."""
        feats, sess = self.encode_session(batch)
        return self.rank_scores(*feats, sess)

    @torch.inference_mode()
    def decode_init(self, batch: SessionBatch):
        """-> (decoder state over ``[B*S]`` rows, memory ``[B*S, S, H2]``,
        its mask): every turn decodes its next query."""
        memory, mem_mask, init = self._decoder_inputs(
            self.encode_queries(batch), batch.turn_mask)
        return self.decoder.init_state(memory.shape[0], init), memory, mem_mask

    def decode_kwargs(self, batch: SessionBatch) -> dict:
        """Extra per-row tensors ``decode_step`` takes (none here)."""
        return {}

    @torch.inference_mode()
    def decode_step(self, state, tokens, memory, memory_mask):
        """-> (state, raw logits [R, V], align); greedy and beam search
        normalise the logits themselves."""
        state, attn_h, align = self.decoder.step(
            state, self.embeddings(tokens), memory, memory_mask)
        return state, self.generator(attn_h, self.embeddings), align


class MNSRF(SessionSuggester):
    """``seed`` fills the weights from a seeded CPU generator; ``seed=None``
    leaves them uninitialised, for loading a state dict (and on the
    ``meta`` device, for reading the parameter names and shapes)."""

    model_type = "mnsrf"

    def build_rank_head(self, cfg: ModelConfig, dt, dev) -> None:
        h2 = self.h2
        self.sess_mix = Dense(2 * h2, h2, dtype=dt, device=dev)
        self.rank_mlp = MLP(3 * h2, (cfg.nhid_ffnn, 1), activation=torch.tanh,
                            final_activation=False, dtype=dt, device=dev,
                            dropout=cfg.dropout)

    def encode_session(self, batch: SessionBatch, deterministic: bool = True,
                       generator: torch.Generator | None = None):
        """-> ((query vectors [B, S, H2], max-pooled document vectors
        [B, S, N, H2]), session states [B, S, H2])."""
        _, qv = self.query_states(batch, deterministic, generator)
        d_states = self.doc_states(batch, deterministic, generator)
        dv = masked_max(d_states, batch.doc_mask, dim=-2)
        sess, _ = self.session_rnn(qv, batch.turn_mask)
        return (qv, dv), sess

    def rank_scores(self, qv, dv, sess, deterministic: bool = True,
                    generator: torch.Generator | None = None):
        """The session-aware query ``q~ = tanh(W[q; s])`` interacted with
        each document: the MLP over ``[q~, d, q~ * d]`` -> [B, S, N]."""
        qs = torch.tanh(self.sess_mix(torch.cat([qv, sess], dim=-1)))
        qb = qs[:, :, None, :].expand_as(dv)
        feats = torch.cat([qb, dv, qb * dv], dim=-1)
        return self.rank_mlp(feats, deterministic, generator)[..., 0]
