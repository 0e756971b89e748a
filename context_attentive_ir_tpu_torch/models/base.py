"""Shared model plumbing (port of ``context_attentive_ir_tpu/models/base.py``)."""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..ops.layers import Embeddings


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
