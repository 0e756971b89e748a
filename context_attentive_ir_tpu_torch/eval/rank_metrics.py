"""Ranking metrics: MAP, MRR, NDCG@k, Precision@k.

Parity target: ``neuroir/eval`` rank metrics (SURVEY.md SS2.8, marker
``exp:``), computed from per-slate score + binary-label arrays exactly as
the reference's official validation does (SURVEY.md SS3.3).

Implemented with numpy on host (metric aggregation is not a hot path) plus a
vectorized formulation -- no per-example Python loops over candidates.
``ranking_metrics`` sorts the score matrix ONCE and feeds every metric from
the sorted labels (seven argsort+gather passes per validation call before).

A copy of ``context_attentive_ir_tpu/eval/rank_metrics.py`` (no JAX in it), kept so
that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def _rank_order(scores: np.ndarray, cand_mask: np.ndarray) -> np.ndarray:
    """Descending-score order per row; masked candidates pushed to the end."""
    neg = np.where(cand_mask, scores, -np.inf)
    # stable sort for deterministic tie handling (first-listed wins)
    return np.argsort(-neg, axis=-1, kind="stable")


def sort_labels(scores: np.ndarray, labels: np.ndarray,
                cand_mask: np.ndarray) -> np.ndarray:
    """Labels re-ordered by descending score, invalid slots zeroed."""
    order = _rank_order(scores, cand_mask)
    sorted_labels = np.take_along_axis(labels * cand_mask, order, axis=-1)
    return sorted_labels


# -- kernels on score-sorted labels (one sort feeds every metric) -----------

def _ap_sorted(sl: np.ndarray) -> np.ndarray:
    cum_rel = np.cumsum(sl, axis=-1)
    ranks = np.arange(1, sl.shape[-1] + 1)
    prec_at_hit = (cum_rel / ranks) * sl
    n_rel = np.maximum(sl.sum(-1), 1.0)
    return prec_at_hit.sum(-1) / n_rel


def _rr_sorted(sl: np.ndarray) -> np.ndarray:
    first = np.argmax(sl > 0, axis=-1)
    has_rel = sl.sum(-1) > 0
    return np.where(has_rel, 1.0 / (first + 1.0), 0.0)


def _ndcg_sorted(sl: np.ndarray, ideal: np.ndarray, k: int) -> np.ndarray:
    """``ideal``: labels sorted descending (the per-row ideal ranking)."""
    discounts = 1.0 / np.log2(np.arange(2, k + 2))
    slk, idk = sl[..., :k], ideal[..., :k]
    dcg = (slk * discounts[: slk.shape[-1]]).sum(-1)
    idcg = (idk * discounts[: idk.shape[-1]]).sum(-1)
    return np.where(idcg > 0, dcg / np.maximum(idcg, 1e-12), 0.0)


def _p_sorted(sl: np.ndarray, k: int) -> np.ndarray:
    return sl[..., :k].sum(-1) / float(k)


# -- public per-metric functions (hand-computed-value tested) ---------------

def average_precision(scores: np.ndarray, labels: np.ndarray,
                      cand_mask: np.ndarray) -> np.ndarray:
    """AP per row. Rows with no positive get AP=0."""
    return _ap_sorted(sort_labels(scores, labels, cand_mask))


def reciprocal_rank(scores: np.ndarray, labels: np.ndarray,
                    cand_mask: np.ndarray) -> np.ndarray:
    return _rr_sorted(sort_labels(scores, labels, cand_mask))


def ndcg_at_k(scores: np.ndarray, labels: np.ndarray,
              cand_mask: np.ndarray, k: int) -> np.ndarray:
    ideal = np.sort(labels * cand_mask, axis=-1)[..., ::-1]
    return _ndcg_sorted(sort_labels(scores, labels, cand_mask), ideal, k)


def precision_at_k(scores: np.ndarray, labels: np.ndarray,
                   cand_mask: np.ndarray, k: int) -> np.ndarray:
    return _p_sorted(sort_labels(scores, labels, cand_mask), k)


def ranking_metrics(
    scores: np.ndarray, labels: np.ndarray, cand_mask: np.ndarray,
    row_mask: np.ndarray | None = None,
    ndcg_ks: tuple[int, ...] = (1, 3, 10),
    prec_ks: tuple[int, ...] = (1, 3),
) -> dict[str, float]:
    """Aggregate metrics over valid rows (rows need >=1 valid candidate).

    scores/labels/cand_mask: [..., N]; row_mask: [...] selecting real rows.
    """
    scores = scores.reshape(-1, scores.shape[-1])
    labels = labels.reshape(-1, labels.shape[-1])
    cand_mask = cand_mask.reshape(-1, cand_mask.shape[-1]).astype(bool)
    if row_mask is None:
        valid = cand_mask.any(-1)
    else:
        valid = row_mask.reshape(-1).astype(bool) & cand_mask.any(-1)
    # restrict to rows that actually have a relevant item (reference slates
    # always contain the clicked doc)
    valid = valid & ((labels * cand_mask).sum(-1) > 0)
    if not valid.any():
        return {"map": 0.0, "mrr": 0.0}
    s, l, m = scores[valid], labels[valid], cand_mask[valid]
    sl = sort_labels(s, l, m)                     # the ONE score sort
    ideal = np.sort(l * m, axis=-1)[..., ::-1]    # the ONE label sort
    out = {
        "map": float(_ap_sorted(sl).mean()),
        "mrr": float(_rr_sorted(sl).mean()),
    }
    for k in ndcg_ks:
        out[f"ndcg@{k}"] = float(_ndcg_sorted(sl, ideal, k).mean())
    for k in prec_ks:
        out[f"p@{k}"] = float(_p_sorted(sl, k).mean())
    out["n_queries"] = float(valid.sum())
    return out
