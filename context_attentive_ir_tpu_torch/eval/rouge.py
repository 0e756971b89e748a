"""ROUGE-L scorer for query suggestion evaluation.

Parity target: the reference's vendored ROUGE-L (``neuroir/eval/rouge/``,
SURVEY.md SS2.8, marker ``exp:``): LCS-based F-measure with beta=1.2,
averaged over the corpus, max over multiple references per segment.

A copy of ``context_attentive_ir_tpu/eval/rouge.py`` (no JAX in it), kept so
that the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Sequence

Tokens = Sequence[str]


def _lcs_len(a: Tokens, b: Tokens) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, start=1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l_sentence(hyp: Tokens, refs: Sequence[Tokens],
                     beta: float = 1.2) -> float:
    best = 0.0
    for ref in refs:
        lcs = _lcs_len(list(hyp), list(ref))
        if lcs == 0 or not hyp or not ref:
            continue
        prec = lcs / len(hyp)
        rec = lcs / len(ref)
        if prec + rec > 0:
            f = ((1 + beta ** 2) * prec * rec) / (rec + beta ** 2 * prec)
            best = max(best, f)
    return best


def corpus_rouge_l(hypotheses: Sequence[Tokens],
                   references: Sequence[Sequence[Tokens]],
                   beta: float = 1.2) -> float:
    assert len(hypotheses) == len(references)
    if not hypotheses:
        return 0.0
    total = sum(rouge_l_sentence(h, r, beta)
                for h, r in zip(hypotheses, references))
    return total / len(hypotheses)


def rouge_metrics(hypotheses, references) -> dict:
    return {"rouge-l": float(corpus_rouge_l(hypotheses, references))}
