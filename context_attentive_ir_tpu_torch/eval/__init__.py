"""Evaluation: rank metrics, BLEU, ROUGE-L, token F1/EM.

TPU-native replacement for ``neuroir/eval`` (SURVEY.md SS2.8).

A copy of ``context_attentive_ir_tpu/eval/__init__.py`` (no JAX in it), kept so
that the port imports nothing of the JAX package.
"""

from .bleu import bleu_metrics, corpus_bleu
from .rank_metrics import (
    average_precision,
    ndcg_at_k,
    precision_at_k,
    ranking_metrics,
    reciprocal_rank,
)
from .rouge import corpus_rouge_l, rouge_metrics
from .text_metrics import exact_match, token_f1

__all__ = [
    "bleu_metrics", "corpus_bleu", "average_precision", "ndcg_at_k",
    "precision_at_k", "ranking_metrics", "reciprocal_rank",
    "corpus_rouge_l", "rouge_metrics", "exact_match", "token_f1",
]
