"""Session-file loading and pretrained-embedding loading.

Parity target: ``load_data`` / ``load_words`` / ``index_embedding_words`` in
``neuroir/inputters/utils.py`` (SURVEY.md SS2.1, marker ``exp:``):

- parse JSON-lines session files into the object graph,
- truncate tokens to ``max_query_len`` / ``max_doc_len``,
- keep at most ``num_candidates`` docs per query,
- load pretrained GloVe rows for in-vocab words.

File format (documented here because it is the framework's public data
contract): one JSON object per line, either

    {"session_id": "...", "query": [
        {"id": "...", "text": "free text"  (or "tokens": [...]),
         "candidates": [{"id": "...", "title": "...", "label": 0/1}, ...]},
        ...]}

which is the session-per-line shape the reference's AOL preprocessing
produces (Sordoni et al. 2015 splits, BM25 top-50 title slates --
SURVEY.md SS2.11).

A copy of ``context_attentive_ir_tpu/data/loader.py`` (no JAX in it), kept so
that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import gzip
import json
import logging
from pathlib import Path

import numpy as np

from .dictionary import Dictionary, normalize
from .objects import Session

logger = logging.getLogger(__name__)


def _open(path: str | Path):
    path = Path(path)
    if path.suffix == ".gz":
        return gzip.open(path, "rt")
    return open(path)


def load_data(
    filename: str | Path,
    max_query_len: int,
    max_doc_len: int,
    num_candidates: int,
    max_session_len: int | None = None,
    max_examples: int = -1,
) -> list[Session]:
    """Parse a JSON-lines session file into truncated ``Session`` objects."""
    sessions: list[Session] = []
    with _open(filename) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if 0 <= max_examples <= len(sessions):
                break
            sess = Session.from_dict(json.loads(line))
            if max_session_len is not None:
                sess.queries = sess.queries[:max_session_len]
            for q in sess.queries:
                q.tokens = q.tokens[:max_query_len]
                q.documents = q.documents[:num_candidates]
                for d in q.documents:
                    d.tokens = d.tokens[:max_doc_len]
            if len(sess.queries) == 0:
                continue
            sessions.append(sess)
    logger.info("Loaded %d sessions from %s", len(sessions), filename)
    return sessions


def load_embedding_words(embedding_file: str | Path,
                         uncase: bool = True) -> set[str]:
    """The vocabulary of a GloVe-format text embedding file.

    Used for ``--restrict_vocab``-style dictionary restriction
    (SURVEY.md SS2.1 'Embedding loader').  ``uncase`` must match the
    Dictionary's case convention or cased vocab entries never intersect.
    """
    words: set[str] = set()
    with _open(embedding_file) as f:
        for line in f:
            parts = line.rstrip().split(" ")
            if len(parts) < 2:
                continue
            words.add(normalize(parts[0], uncase))
    return words


def load_embeddings(
    embedding_file: str | Path,
    word_dict: Dictionary,
    dim: int,
) -> tuple[np.ndarray, int]:
    """Load pretrained rows into a ``[vocab, dim]`` float32 matrix.

    Out-of-file words keep a small random init; PAD row stays zero.  Returns
    the matrix and the number of words actually loaded (the reference logs
    loaded/missed counts).
    """
    rng = np.random.RandomState(1234)
    table = rng.normal(scale=0.1, size=(len(word_dict), dim)).astype(np.float32)
    table[0] = 0.0  # PAD
    loaded = 0
    # Average duplicate rows like common GloVe loaders do.
    counts = np.zeros((len(word_dict),), dtype=np.int32)
    with _open(embedding_file) as f:
        for line in f:
            parts = line.rstrip().split(" ")
            if len(parts) != dim + 1:
                continue
            # match the Dictionary's case convention (a case-sensitive
            # vocabulary would otherwise miss every cased pretrained row)
            w = normalize(parts[0], word_dict.uncase)
            if w in word_dict.tok2ind:
                idx = word_dict.tok2ind[w]
                vec = np.asarray(parts[1:], dtype=np.float32)
                if counts[idx] == 0:
                    table[idx] = vec
                    loaded += 1
                else:
                    table[idx] = (table[idx] * counts[idx] + vec) / (counts[idx] + 1)
                counts[idx] += 1
    logger.info(
        "Loaded %d/%d pretrained embeddings", loaded, len(word_dict)
    )
    return table, loaded
