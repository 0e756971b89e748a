"""HRED-QS: hierarchical recurrent encoder-decoder for query suggestion
(Sordoni et al., CIKM 2015; port of
``context_attentive_ir_tpu/models/recommenders/hredqs.py``).

Query-level RNN -> session-level RNN -> attention decoder conditioned on
the session state.  All S context queries encode in one flattened
``[B*S, Lq]`` pass of the query encoder (whose final state is the query
vector); the session RNN runs over the S query vectors; the decoder
attends over the per-turn session states (padded turns masked) and starts
from the state at the last valid turn.  The published model builds both
encoders from GRUs (``rnn_type = session_rnn_type = "gru"``); LSTMs work
too.  Parameter names mirror the JAX tree, so ``convert.params_from_jax``
is a rename.

As in the JAX model there is no ``decode_step_fused``: the engine decodes
through ``decode_step``'s logits, so the generator product is a plain
``torch.matmul`` and the fused generator kernel does not run here.
"""

from __future__ import annotations

import torch
from torch import nn

from ...config import ModelConfig
from ...data.vectorize import SuggestBatch
from ...device import resolve_device
from ...ops.decoder import AttnLSTMDecoder
from ...ops.layers import reset_parameters
from ...ops.rnn import RNNEncoder, RNNLayer
from ..base import check_rnn_types, compute_dtype, make_embeddings
from ..generator import Generator
from ..losses import sequence_nll_loss


def last_valid(states: torch.Tensor, turn_mask: torch.Tensor) -> torch.Tensor:
    """states [B, S, H], mask [B, S] -> the state at the last True turn
    [B, H] (turn 0 for a row without one)."""
    idx = (turn_mask.long().sum(-1) - 1).clamp_min(0)
    return states[torch.arange(states.shape[0], device=states.device), idx]


class HredQS(nn.Module):
    """``seed`` fills the weights from a seeded CPU generator; ``seed=None``
    leaves them uninitialised, for loading a state dict (and on the
    ``meta`` device, for reading the parameter names and shapes)."""

    # the training loss of ``forward``'s output (logits)
    target_nll = staticmethod(sequence_nll_loss)

    def __init__(self, config: ModelConfig, device="cuda",
                 seed: int | None = 0):
        super().__init__()
        cfg = config
        if cfg.model_type != "hredqs":
            raise ValueError(f"HredQS needs model_type 'hredqs', got "
                             f"{cfg.model_type!r}")
        check_rnn_types(cfg)
        dev = resolve_device(device)
        dt = compute_dtype(cfg)
        self.config = cfg
        h2 = cfg.nhid * (2 if cfg.bidirection else 1)
        self.embeddings = make_embeddings(cfg, dev)
        self.query_encoder = RNNEncoder(
            cfg.emsize, cfg.nhid, cfg.nlayers, cfg.bidirection,
            use_kernel=cfg.use_pallas_rnn, dtype=dt, device=dev,
            dropout=cfg.dropout_rnn, rnn_type=cfg.rnn_type)
        self.session_rnn = RNNLayer(h2, h2, bidirectional=False, dtype=dt,
                                    device=dev, rnn_type=cfg.session_rnn_type)
        self.decoder = AttnLSTMDecoder(h2, cfg.emsize, cfg.nlayers,
                                       cfg.attn_type, dtype=dt, device=dev,
                                       dropout=cfg.dropout_rnn)
        self.generator = Generator(h2, self.embeddings,
                                   tie=cfg.tie_embeddings,
                                   vocab_size=cfg.vocab_size, dtype=dt,
                                   device=dev)
        if seed is not None and dev.type != "meta":
            reset_parameters(self, seed)

    def encode(self, batch: SuggestBatch, deterministic: bool = True,
               generator: torch.Generator | None = None):
        """-> (session states [B, S, H2] as the decoder memory, its mask
        ``turn_mask``, the state at the last valid turn [B, H2])."""
        B, S, Lq = batch.context.shape
        ctx = self.embeddings(batch.context, deterministic, generator)
        _, qvec = self.query_encoder(ctx.reshape(B * S, Lq, -1),
                                     batch.context_mask.reshape(B * S, Lq),
                                     deterministic, generator)
        sess, _ = self.session_rnn(qvec.reshape(B, S, -1), batch.turn_mask)
        return sess, batch.turn_mask, last_valid(sess, batch.turn_mask)

    def forward(self, batch: SuggestBatch, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Teacher-forced logits ``[B, Lt, V]`` (JAX ``HredQS.__call__``);
        ``deterministic=False`` turns dropout on, its noise drawn from
        ``generator``."""
        memory, memory_mask, init = self.encode(batch, deterministic,
                                                generator)
        tgt = self.embeddings(batch.target_in, deterministic, generator)
        attn_hs, _ = self.decoder(tgt, memory, memory_mask, init,
                                  deterministic, generator)
        return self.generator(attn_hs, self.embeddings)

    @torch.inference_mode()
    def decode_init(self, batch: SuggestBatch):
        memory, memory_mask, init = self.encode(batch)
        return (self.decoder.init_state(memory.shape[0], init), memory,
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
