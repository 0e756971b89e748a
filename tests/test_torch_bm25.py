"""The port's BM25 slates (``data/bm25.py``, the native scorer
``data/fast_bm25.py`` over ``native/bm25.cpp``): the Okapi / Lucene
formula against a hand-computed value, ranking, ties to the lower document
index, repeated query terms, the native scorer bit-equal to numpy, and
both equal to the JAX package's ``BM25Index`` on the same corpus and
queries.  Whether ``g++`` builds the scorer is decided inside each test."""

import math

import numpy as np
import pytest

from context_attentive_ir_tpu.data.bm25 import BM25Index as JaxBM25Index
from context_attentive_ir_tpu_torch.data import fast_bm25
from context_attentive_ir_tpu_torch.data.bm25 import BM25Index

CORPUS = [
    "cheap flights to boston",          # 0
    "boston weather forecast",          # 1
    "cheap hotels boston downtown",     # 2
    "python programming tutorial",      # 3
    "learn python fast",                # 4
]


@pytest.fixture
def native():
    if not fast_bm25.available():
        pytest.skip("g++ cannot build native/bm25.cpp here")


def test_hand_computed_score():
    docs = ["a b", "a a c", "c c"]
    ix = BM25Index(docs, use_native=False)
    n, k1, b = 3, 1.2, 0.75
    avgdl = (2 + 3 + 2) / 3
    idf = math.log(1 + (n - 2 + 0.5) / (2 + 0.5))   # 'a' in docs 0, 1

    def s(tf, dl):
        return idf * tf * (k1 + 1) / (tf + k1 * (1 - b + b * dl / avgdl))

    scores = ix.scores("a")
    np.testing.assert_allclose(scores[0], s(1, 2), rtol=1e-6)
    np.testing.assert_allclose(scores[1], s(2, 3), rtol=1e-6)
    assert scores[2] == 0.0


def test_ranking_ties_and_unknown_terms():
    ix = BM25Index(CORPUS, use_native=False)
    assert not ix.native
    idx, scores = ix.search("cheap flights boston", k=3)
    assert idx[0] == 0 and scores[0] > scores[1] >= scores[2]
    np.testing.assert_array_equal(ix.search("python tutorial", k=2)[0],
                                  [3, 4])
    np.testing.assert_array_equal(ix.scores("BOSTON Weather"),
                                  ix.scores("boston weather"))
    idx, scores = ix.search("zzz qqq", k=3)
    np.testing.assert_array_equal(idx, [0, 1, 2])
    assert (scores == 0).all()
    idx, scores = BM25Index(["x y", "x y", "x y", "z"],
                            use_native=False).search("x", k=4)
    np.testing.assert_array_equal(idx, [0, 1, 2, 3])
    assert ix.scores("boston boston")[1] == 2 * ix.scores("boston")[1]
    with pytest.raises(ValueError, match="non-empty"):
        BM25Index([])


def _random_corpus(seed, n_docs=300, n_queries=40):
    rng = np.random.RandomState(seed)
    vocab = [f"w{i}" for i in range(200)] + ["Ünïcode", "UPPER"]
    docs = [" ".join(rng.choice(vocab, size=rng.randint(2, 12)))
            for _ in range(n_docs)]
    queries = [" ".join(rng.choice(vocab + ["zzz"],
                                   size=rng.randint(1, 6)))
               for _ in range(n_queries)] + [""]
    return docs, queries


@pytest.mark.parametrize("k", [1, 5, 50, 400])
def test_native_equals_numpy(native, k):
    docs, queries = _random_corpus(7)
    nat, plain = BM25Index(docs), BM25Index(docs, use_native=False)
    assert nat.native
    for (gi, gs), (wi, ws) in zip(nat.search_batch(queries, k),
                                  plain.search_batch(queries, k)):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gs, ws)      # float32 bits
    np.testing.assert_array_equal(nat.search(queries[0], k)[0],
                                  plain.search(queries[0], k)[0])


@pytest.mark.parametrize("use_native", [False, True])
def test_equals_the_jax_package(use_native):
    if use_native and not fast_bm25.available():
        pytest.skip("g++ cannot build native/bm25.cpp here")
    docs, queries = _random_corpus(3)
    port = BM25Index(docs, use_native=use_native)
    ref = JaxBM25Index(docs, use_native=use_native)
    assert port.term_ids == ref.term_ids
    for name in ("_offsets", "_post_doc", "_post_tf", "_idf", "_norm"):
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(ref, name), name)
    for (gi, gs), (wi, ws) in zip(port.search_batch(queries, 20),
                                  ref.search_batch(queries, 20)):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gs, ws)
