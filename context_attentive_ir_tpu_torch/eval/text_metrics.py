"""Token-level exact match and F1 for next-query prediction.

Parity target: the reference's eval utils (SURVEY.md SS2.8 'Exact-match /
F1', marker ``exp:`` -- flagged unverified there; included for capability
completeness).

A copy of ``context_attentive_ir_tpu/eval/text_metrics.py`` (no JAX in it), kept so
that the port imports nothing of the JAX package.
"""

from __future__ import annotations

from collections import Counter
from typing import Sequence

Tokens = Sequence[str]


def exact_match(hypotheses: Sequence[Tokens],
                references: Sequence[Tokens]) -> float:
    assert len(hypotheses) == len(references)
    if not hypotheses:
        return 0.0
    hits = sum(list(h) == list(r) for h, r in zip(hypotheses, references))
    return hits / len(hypotheses)


def token_f1(hypotheses: Sequence[Tokens],
             references: Sequence[Tokens]) -> float:
    assert len(hypotheses) == len(references)
    if not hypotheses:
        return 0.0
    total = 0.0
    for h, r in zip(hypotheses, references):
        common = Counter(h) & Counter(r)
        overlap = sum(common.values())
        if overlap == 0 or not h or not r:
            continue
        prec = overlap / len(h)
        rec = overlap / len(r)
        total += 2 * prec * rec / (prec + rec)
    return total / len(hypotheses)
