"""ctypes bindings for the native BM25 scorer (``native/bm25.cpp``): the
API of ``context_attentive_ir_tpu/data/fast_bm25.py`` (``NativeBM25``,
``available``, ``get_lib``).

``data/bm25.py`` owns tokenization and the index and is the semantics
reference; this wrapper hands the index's CSR postings to the C++ scorer
once, which then accumulates each query's scores and takes its top-k.  The
library is built as ``data/fast.py`` builds fastvec's, into
``build/torch_native/``.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional, Sequence

import numpy as np

from .fast import load_native


@lru_cache(maxsize=None)
def get_lib() -> Optional[ctypes.CDLL]:
    """The bm25 library with its signatures declared, or None."""
    lib = load_native("bm25")
    if lib is None:
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.bm25_new.restype = ctypes.c_void_p
    lib.bm25_new.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p, i32p,
                             f32p, f32p, f32p, ctypes.c_float]
    lib.bm25_free.restype = None
    lib.bm25_free.argtypes = [ctypes.c_void_p]
    lib.bm25_search.restype = None
    lib.bm25_search.argtypes = [ctypes.c_void_p, i32p, i64p,
                                ctypes.c_int64, ctypes.c_int32, i32p, f32p]
    return lib


def available() -> bool:
    return get_lib() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeBM25:
    """The native scorer over a built ``BM25Index``'s postings (copied by
    ``bm25_new``)."""

    def __init__(self, index):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native bm25 unavailable")
        self._lib = lib
        self.n_docs = index.n_docs
        offsets = np.ascontiguousarray(index._offsets, np.int64)
        post_doc = np.ascontiguousarray(index._post_doc, np.int32)
        post_tf = np.ascontiguousarray(index._post_tf, np.float32)
        idf = np.ascontiguousarray(index._idf, np.float32)
        norm = np.ascontiguousarray(index._norm, np.float32)
        self._handle = lib.bm25_new(
            index.n_docs, len(index._idf), _ptr(offsets, ctypes.c_int64),
            _ptr(post_doc, ctypes.c_int32), _ptr(post_tf, ctypes.c_float),
            _ptr(idf, ctypes.c_float), _ptr(norm, ctypes.c_float),
            ctypes.c_float(index.k1))

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.bm25_free(self._handle)
            self._handle = None

    def search_batch(self, tid_lists: Sequence[Sequence[int]], k: int
                     ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Top-k ``(doc indices, scores)`` of each query's term ids."""
        k = min(k, self.n_docs)
        n = len(tid_lists)
        q_offsets = np.zeros(n + 1, np.int64)
        np.cumsum([len(t) for t in tid_lists], out=q_offsets[1:])
        q_tids = np.asarray([t for ts in tid_lists for t in ts] or [0],
                            np.int32)
        out_idx = np.empty((n, k), np.int32)
        out_score = np.empty((n, k), np.float32)
        self._lib.bm25_search(
            self._handle, _ptr(q_tids, ctypes.c_int32),
            _ptr(q_offsets, ctypes.c_int64), n, k,
            _ptr(out_idx, ctypes.c_int32), _ptr(out_score, ctypes.c_float))
        return [(out_idx[i], out_score[i]) for i in range(n)]

    def search(self, tids: Sequence[int], k: int
               ) -> tuple[np.ndarray, np.ndarray]:
        return self.search_batch([tids], k)[0]
