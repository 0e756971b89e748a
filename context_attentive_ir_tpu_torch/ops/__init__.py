"""Layers, recurrences, attention and the hand-written CUDA kernels (the
port of ``context_attentive_ir_tpu/ops``)."""

from .attention import AttentionPool, GlobalAttention
from .decoder import AttnLSTMDecoder
from .layers import (
    MLP,
    CharCNN,
    Embeddings,
    Highway,
    Maxout,
    cosine_similarity,
)
from .masking import (
    NEG_INF,
    mask_logits,
    masked_log_softmax,
    masked_max,
    masked_mean,
    masked_softmax,
    sequence_mask,
)
from .rnn import RNNEncoder, RNNLayer, bilstm_scan, gru_scan, lstm_scan

__all__ = [
    "AttentionPool", "GlobalAttention", "AttnLSTMDecoder", "CharCNN",
    "Embeddings", "Highway", "Maxout", "MLP", "cosine_similarity",
    "NEG_INF", "mask_logits", "masked_log_softmax", "masked_max",
    "masked_mean", "masked_softmax", "sequence_mask",
    "RNNEncoder", "RNNLayer", "bilstm_scan", "gru_scan", "lstm_scan",
]
