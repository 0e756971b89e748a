"""Corpus BLEU-1..4 for query suggestion evaluation.

Parity target: the reference's vendored pycocoevalcap-style BLEU scorer
(``neuroir/eval/bleu/``, SURVEY.md SS2.8, marker ``exp:``).  This is a
self-contained reimplementation of the same algorithm family:

- modified n-gram precision with clipping against reference counts,
- corpus-level aggregation (sum of clipped matches / sum of candidates),
- brevity penalty exp(1 - r/c) with per-segment *closest* reference length,
- geometric mean over orders 1..n for BLEU-n.

``smooth=True`` adds the pycocoevalcap "tiny" smoothing on zero counts so
early-training hypotheses don't collapse to exactly 0.

A copy of ``context_attentive_ir_tpu/eval/bleu.py`` (no JAX in it), kept so
that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Sequence

Tokens = Sequence[str]


def _ngrams(tokens: Tokens, n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(
    hypotheses: Sequence[Tokens],
    references: Sequence[Sequence[Tokens]],
    max_n: int = 4,
    smooth: bool = False,
) -> list[float]:
    """Returns [BLEU-1, ..., BLEU-max_n] in [0, 1].

    ``references[i]`` is the list of reference token sequences for
    hypothesis ``i`` (the suggestion task has a single gold next query, but
    multi-reference is supported for parity).
    """
    assert len(hypotheses) == len(references)
    clipped = [0.0] * max_n
    totals = [0.0] * max_n
    hyp_len = 0
    ref_len = 0
    for hyp, refs in zip(hypotheses, references):
        hyp = list(hyp)
        hyp_len += len(hyp)
        if refs:
            ref_len += min((abs(len(r) - len(hyp)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            h_counts = _ngrams(hyp, n)
            if not h_counts:
                continue
            max_ref = Counter()
            for r in refs:
                for gram, c in _ngrams(list(r), n).items():
                    max_ref[gram] = max(max_ref[gram], c)
            totals[n - 1] += sum(h_counts.values())
            clipped[n - 1] += sum(min(c, max_ref[g])
                                  for g, c in h_counts.items())
    if hyp_len == 0:
        return [0.0] * max_n
    bp = 1.0 if hyp_len > ref_len else math.exp(1.0 - ref_len / max(hyp_len, 1))
    bleus = []
    tiny, small = 1e-15, 1e-9
    log_prec_sum = 0.0
    for n in range(1, max_n + 1):
        num, den = clipped[n - 1], totals[n - 1]
        if smooth:
            num += tiny
            den += small
        if num <= 0 or den <= 0:
            bleus.append(0.0)
            # once an order has zero matches, higher orders are zero too
            log_prec_sum = -math.inf
            continue
        log_prec_sum += math.log(num / den)
        if log_prec_sum == -math.inf:
            bleus.append(0.0)
        else:
            bleus.append(bp * math.exp(log_prec_sum / n))
    return bleus


def bleu_metrics(hypotheses, references, smooth: bool = False) -> dict:
    b = corpus_bleu(hypotheses, references, 4, smooth)
    return {f"bleu-{i+1}": float(v) for i, v in enumerate(b)}
