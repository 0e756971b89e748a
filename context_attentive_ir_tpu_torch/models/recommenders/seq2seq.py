"""Seq2seq(+attention) next-query recommender (port of
``context_attentive_ir_tpu/models/recommenders/seq2seq.py``).

The encoder (LSTM or GRU, ``rnn_type``) runs over the session context as
one flat source -- the previous queries concatenated, ``batch.source``
``[B, S*Lq]`` -- and an attention LSTM decoder generates the next query
from its states.  With ``ablate_history`` the encoder sees only the last
valid context turn (the current query): the history-blind floor of the
JAX model.  Parameter names mirror the JAX tree, so
``convert.params_from_jax`` is a rename; the tree is the same with
``ablate_history`` on and off.

As in the JAX model there is no ``decode_step_fused``: the engine decodes
through ``decode_step``'s logits, so the fused generator kernel does not
run here.
"""

from __future__ import annotations

import torch
from torch import nn

from ...config import ModelConfig
from ...data.vectorize import SuggestBatch
from ...device import resolve_device
from ...ops.decoder import AttnLSTMDecoder
from ...ops.layers import reset_parameters
from ...ops.rnn import RNNEncoder
from ..base import check_rnn_types, compute_dtype, make_embeddings
from ..generator import Generator
from ..losses import sequence_nll_loss
from .hredqs import last_valid


class Seq2seq(nn.Module):
    """``seed`` fills the weights from a seeded CPU generator; ``seed=None``
    leaves them uninitialised, for loading a state dict (and on the
    ``meta`` device, for reading the parameter names and shapes)."""

    model_type = "seq2seq"
    # the training loss of ``forward``'s output (logits)
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
        self.encoder = RNNEncoder(
            cfg.emsize, cfg.nhid, cfg.nlayers, cfg.bidirection,
            use_kernel=cfg.use_pallas_rnn, dtype=dt, device=dev,
            dropout=cfg.dropout_rnn, rnn_type=cfg.rnn_type)
        self.decoder = AttnLSTMDecoder(self.h2, cfg.emsize, cfg.nlayers,
                                       cfg.attn_type, dtype=dt, device=dev,
                                       dropout=cfg.dropout_rnn)
        self.generator = Generator(self.h2, self.embeddings,
                                   tie=cfg.tie_embeddings,
                                   vocab_size=cfg.vocab_size, dtype=dt,
                                   device=dev)
        if seed is not None and dev.type != "meta":
            reset_parameters(self, seed)

    def _encode(self, ids, mask, deterministic, generator):
        src = self.embeddings(ids, deterministic, generator)
        memory, final = self.encoder(src, mask, deterministic, generator)
        return memory, mask, final

    def encode(self, batch: SuggestBatch, deterministic: bool = True,
               generator: torch.Generator | None = None):
        """-> (encoder states as the decoder memory, its mask, the final
        state): over the flat source, or with ``ablate_history`` over the
        last valid context turn alone ``[B, Lq]``."""
        if self.config.ablate_history:
            return self._encode(last_valid(batch.context, batch.turn_mask),
                                last_valid(batch.context_mask,
                                           batch.turn_mask),
                                deterministic, generator)
        return self._encode(batch.source, batch.source_mask, deterministic,
                            generator)

    def _unroll(self, batch, deterministic, generator):
        memory, memory_mask, final = self.encode(batch, deterministic,
                                                 generator)
        tgt = self.embeddings(batch.target_in, deterministic, generator)
        return self.decoder(tgt, memory, memory_mask, final, deterministic,
                            generator)

    def forward(self, batch: SuggestBatch, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Teacher-forced logits ``[B, Lt, V]`` (JAX ``Seq2seq.__call__``);
        ``deterministic=False`` turns dropout on, its noise drawn from
        ``generator``."""
        attn_hs, _ = self._unroll(batch, deterministic, generator)
        return self.generator(attn_hs, self.embeddings)

    @torch.inference_mode()
    def decode_init(self, batch: SuggestBatch):
        memory, memory_mask, final = self.encode(batch)
        return (self.decoder.init_state(memory.shape[0], final), memory,
                memory_mask)

    def decode_kwargs(self, batch: SuggestBatch) -> dict:
        """Extra per-row tensors ``decode_step`` takes (none here)."""
        return {}

    @torch.inference_mode()
    def decode_step(self, state, tokens, memory, memory_mask):
        """-> (state, raw logits [R, V], align); greedy and beam search
        normalise the logits themselves."""
        state, attn_h, align = self.decoder.step(state, self.embeddings(tokens),
                                                 memory, memory_mask)
        return state, self.generator(attn_h, self.embeddings), align
