"""Shared model plumbing (port of ``context_attentive_ir_tpu/models/base.py``):
the compute dtype, the embedding table, and ``Ranker``, the base of the
eight rankers."""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..device import resolve_device
from ..ops.layers import Embeddings, ParamModule, reset_parameters
from ..ops.rnn import RNN_TYPES


def compute_dtype(config: ModelConfig) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        config.compute_dtype]


def make_embeddings(config: ModelConfig, device) -> Embeddings:
    if config.vocab_size <= 0:
        raise ValueError("config.vocab_size must be set")
    return Embeddings(config.vocab_size, config.emsize,
                      dtype=compute_dtype(config), device=device,
                      dropout=config.dropout_emb,
                      fixed=config.fix_embeddings,
                      quantized=config.quantize_embeddings)


def check_rnn_types(config: ModelConfig) -> None:
    """Raise unless ``rnn_type`` and ``session_rnn_type`` name a ported
    recurrence (LSTM or GRU)."""
    for field in ("rnn_type", "session_rnn_type"):
        if getattr(config, field) not in RNN_TYPES:
            raise ValueError(f"unknown {field} {getattr(config, field)!r}; "
                             f"choose from {RNN_TYPES}")


class Ranker(ParamModule):
    """A session-blind ranker: ``forward(batch, deterministic, generator)``
    scores each row's slate of a ``RankBatch`` -> ``[B, N]`` (the JAX
    ``__call__``; ``deterministic=False`` turns dropout on, its noise drawn
    from ``generator``).  A subclass names its ``model_type`` and builds its
    layers in ``build``.  ``seed`` fills the weights from a seeded CPU
    generator; ``seed=None`` leaves them uninitialised, for loading a state
    dict (and on the ``meta`` device, for reading the parameter names and
    shapes)."""

    model_type = ""

    def __init__(self, config: ModelConfig, device="cuda",
                 seed: int | None = 0):
        dev = resolve_device(device)
        super().__init__(dev)
        if config.model_type != self.model_type:
            raise ValueError(f"{type(self).__name__} needs model_type "
                             f"{self.model_type!r}, got "
                             f"{config.model_type!r}")
        self.config = config
        self.dtype = compute_dtype(config)
        self.build(config, self.dtype, dev)
        if seed is not None and dev.type != "meta":
            reset_parameters(self, seed)

    def build(self, cfg: ModelConfig, dt: torch.dtype,
              dev: torch.device) -> None:
        raise NotImplementedError

    @torch.inference_mode()
    def score(self, batch) -> torch.Tensor:
        """Slate scores [B, N] in eval mode."""
        return self(batch)
