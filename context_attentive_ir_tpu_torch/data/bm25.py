"""BM25 candidate slates over a title corpus (port of
``context_attentive_ir_tpu/data/bm25.py``): the AOL preparation's step
that gives each query its top-50 titles, run by ``cli/prepare_data.py
bm25`` on a raw click log.

Okapi BM25 with Lucene's non-negative idf:

    idf(t)      = ln(1 + (N - df + 0.5) / (df + 0.5))
    score(q, d) = sum_t  idf(t) * tf * (k1 + 1) / (tf + k1 * (1 - b + b * dl/avgdl))

summed over the query's token occurrences (a repeated term counts twice),
k1 = 1.2, b = 0.75.  Tokens as ``load_data`` makes them: whitespace split
and ``dictionary.normalize``.  Host code: numpy over CSR postings, with
the native scorer (``fast_bm25.NativeBM25``) where it builds, which gives
the same indices and float32 scores.
"""

from __future__ import annotations

import logging
from typing import Iterable, Sequence

import numpy as np

from .dictionary import normalize

__all__ = ["BM25Index"]

logger = logging.getLogger(__name__)


def _tokenize(text_or_tokens, uncase: bool) -> list[str]:
    toks = (text_or_tokens.split() if isinstance(text_or_tokens, str)
            else list(text_or_tokens))
    return [normalize(t, uncase) for t in toks]


class BM25Index:
    """Inverted-index BM25 over a fixed corpus of titles (strings or token
    lists).  ``search(query, k)`` returns the top-k ``(indices, scores)``,
    ties broken toward the lower document index."""

    def __init__(self, docs: Iterable, k1: float = 1.2, b: float = 0.75,
                 uncase: bool = True, use_native: bool = True):
        self.k1, self.b, self.uncase = float(k1), float(b), uncase
        term_ids: dict[str, int] = {}
        post_docs: list[list[int]] = []
        post_tfs: list[list[int]] = []
        doc_lens: list[int] = []
        for di, doc in enumerate(docs):
            counts: dict[int, int] = {}
            toks = _tokenize(doc, uncase)
            for tok in toks:
                tid = term_ids.setdefault(tok, len(term_ids))
                if tid == len(post_docs):
                    post_docs.append([])
                    post_tfs.append([])
                counts[tid] = counts.get(tid, 0) + 1
            doc_lens.append(len(toks))
            for tid, tf in counts.items():
                post_docs[tid].append(di)
                post_tfs[tid].append(tf)
        self.n_docs = len(doc_lens)
        if self.n_docs == 0:
            raise ValueError("BM25Index needs a non-empty corpus")
        self.term_ids = term_ids
        self._doc_len = np.asarray(doc_lens, np.float32)
        avgdl = max(float(self._doc_len.mean()), 1e-9)
        # k1 * (1 - b + b * dl / avgdl) a document
        self._norm = (self.k1 * (1.0 - self.b + self.b * self._doc_len
                                 / avgdl)).astype(np.float32)
        sizes = np.asarray([len(p) for p in post_docs], np.int64)
        self._offsets = np.zeros(len(post_docs) + 1, np.int64)
        np.cumsum(sizes, out=self._offsets[1:])
        self._post_doc = np.asarray(
            [d for p in post_docs for d in p], np.int32)
        self._post_tf = np.asarray(
            [t for p in post_tfs for t in p], np.float32)
        df = sizes.astype(np.float64)
        self._idf = np.log1p((self.n_docs - df + 0.5) / (df + 0.5)).astype(
            np.float32)
        self._native = _native_handle(self) if use_native else None

    @property
    def native(self) -> bool:
        """True where searches run in the native scorer."""
        return self._native is not None

    def _query_tids(self, query) -> list[int]:
        return [self.term_ids[t] for t in _tokenize(query, self.uncase)
                if t in self.term_ids]

    def scores(self, query) -> np.ndarray:
        """Dense BM25 scores over the whole corpus."""
        out = np.zeros(self.n_docs, np.float32)
        for tid in self._query_tids(query):
            lo, hi = self._offsets[tid], self._offsets[tid + 1]
            d = self._post_doc[lo:hi]
            tf = self._post_tf[lo:hi]
            out[d] += (self._idf[tid] * tf * (self.k1 + 1.0)
                       / (tf + self._norm[d]))
        return out

    def search(self, query, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Top-k ``(doc indices, scores)``, score-descending, index-tied."""
        if self._native is not None:
            return self._native.search(self._query_tids(query), k)
        return self._topk(self.scores(query), k)

    def search_batch(self, queries: Sequence, k: int
                     ) -> list[tuple[np.ndarray, np.ndarray]]:
        if self._native is not None:
            return self._native.search_batch(
                [self._query_tids(q) for q in queries], k)
        return [self.search(q, k) for q in queries]

    def _topk(self, scores: np.ndarray, k: int
              ) -> tuple[np.ndarray, np.ndarray]:
        # a full lexsort: ties at the k-th place break on the document
        # index, as the native scorer breaks them
        k = min(k, self.n_docs)
        idx = np.lexsort((np.arange(self.n_docs), -scores))[:k]
        return idx.astype(np.int32), scores[idx]


def _native_handle(index: BM25Index):
    """The native scorer over ``index``, or None where it cannot be
    built."""
    from .fast_bm25 import NativeBM25, available

    if not available():
        return None
    return NativeBM25(index)
