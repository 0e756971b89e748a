"""Vectorization: object graph -> static-shape numpy batches.

The port of the Python path of ``context_attentive_ir_tpu/data/vectorize.py``
for the three families: every batch is padded to a fixed ``ShapeConfig``
and bool masks carry the true lengths, so the port sees exactly the id
tensors the JAX package builds.  ``RankBatch`` (one query and its slate per
row, for the rankers), ``SuggestBatch`` (one session prefix and its next
query per row) and ``SessionBatch`` (one whole session per row) are plain
dataclasses of numpy arrays; their ``to`` moves them onto a torch device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import (
    BOS,
    EOS,
    MAX_DOC_LEN,
    MAX_QUERY_LEN,
    MAX_SESSION_LEN,
    MAX_WORD_LEN,
    NUM_CANDIDATES,
    PAD,
)
from .dictionary import CharDictionary, Dictionary
from .objects import Document, Query, Session

_CHAR_DICT = CharDictionary()


@dataclass(frozen=True)
class ShapeConfig:
    """Static padding targets for every tensor in a batch."""

    max_query_len: int = MAX_QUERY_LEN
    max_doc_len: int = MAX_DOC_LEN
    max_session_len: int = MAX_SESSION_LEN
    num_candidates: int = NUM_CANDIDATES
    # > 0: per-word byte ids for the char-CNN path (``use_charngram``)
    max_word_len: int = 0

    @property
    def max_target_len(self) -> int:
        """Target length = query length + 1 (room for the BOS/EOS shift)."""
        return self.max_query_len + 1

    @property
    def max_source_len(self) -> int:
        """Source length of flat-context recommenders (the session's
        queries concatenated)."""
        return self.max_session_len * self.max_query_len


def shapes_from_config(config) -> ShapeConfig:
    return ShapeConfig(max_query_len=config.max_query_len,
                       max_doc_len=config.max_doc_len,
                       max_session_len=config.max_session_len,
                       num_candidates=config.num_candidates,
                       max_word_len=(MAX_WORD_LEN if config.use_charngram
                                     else 0))


def _batch_to(batch, device):
    """The same batch as torch tensors on ``device`` (ids as int64); a
    ``None`` field stays ``None``."""
    def conv(a):
        if a is None:
            return None
        t = torch.from_numpy(np.ascontiguousarray(a))
        if t.dtype == torch.int32:
            t = t.long()
        return t.to(device)

    return type(batch)(**{f.name: conv(getattr(batch, f.name))
                          for f in dataclasses.fields(batch)})


@dataclass
class RankBatch:
    """One (query, candidate slate) per row (rankers).  Leaves are numpy
    arrays as built, torch tensors after ``to``; the character ids are
    ``None`` unless the shapes set ``max_word_len``."""

    query: np.ndarray        # int32 [B, Lq]
    query_mask: np.ndarray   # bool  [B, Lq]
    docs: np.ndarray         # int32 [B, N, Ld]
    doc_mask: np.ndarray     # bool  [B, N, Ld]
    labels: np.ndarray       # f32   [B, N]   (binary clicks)
    cand_mask: np.ndarray    # bool  [B, N]   (valid candidates)
    row_mask: np.ndarray     # bool  [B]      (valid rows)
    query_chars: np.ndarray | None = None  # int32 [B, Lq, Lw]
    doc_chars: np.ndarray | None = None    # int32 [B, N, Ld, Lw]

    @property
    def batch_size(self) -> int:
        return self.query.shape[0]

    def to(self, device) -> "RankBatch":
        """The same batch as torch tensors on ``device`` (ids as int64)."""
        return _batch_to(self, device)


@dataclass
class SuggestBatch:
    """One (session context, next query) per row (recommenders).

    ``source`` is the flat concatenation of the context queries (seq2seq /
    ACG-style models); ``context`` keeps them separated per turn
    (hierarchical models like HRED-QS).  Leaves are numpy arrays as built,
    torch tensors after ``to``.
    """

    source: np.ndarray        # int32 [B, Lsrc]
    source_mask: np.ndarray   # bool  [B, Lsrc]
    context: np.ndarray       # int32 [B, S, Lq]
    context_mask: np.ndarray  # bool  [B, S, Lq]
    turn_mask: np.ndarray     # bool  [B, S]
    target_in: np.ndarray     # int32 [B, Lt]  (BOS + tokens)
    target_out: np.ndarray    # int32 [B, Lt]  (tokens + EOS)
    target_mask: np.ndarray   # bool  [B, Lt]
    row_mask: np.ndarray      # bool  [B]

    @property
    def batch_size(self) -> int:
        return self.source.shape[0]

    def to(self, device) -> "SuggestBatch":
        """The same batch as torch tensors on ``device`` (ids as int64)."""
        return _batch_to(self, device)


@dataclass
class SessionBatch:
    """One whole session per row (multitask models).

    Positions t = 0..S-1; the suggestion target at position t is query t+1
    (the last valid turn has no target -- ``target_mask`` is all-False there).
    Leaves are numpy arrays as built, torch tensors after ``to``.
    """

    query: np.ndarray        # int32 [B, S, Lq]
    query_mask: np.ndarray   # bool  [B, S, Lq]
    docs: np.ndarray         # int32 [B, S, N, Ld]
    doc_mask: np.ndarray     # bool  [B, S, N, Ld]
    clicks: np.ndarray       # f32   [B, S, N]
    cand_mask: np.ndarray    # bool  [B, S, N]
    turn_mask: np.ndarray    # bool  [B, S]
    target_in: np.ndarray    # int32 [B, S, Lt]
    target_out: np.ndarray   # int32 [B, S, Lt]
    target_mask: np.ndarray  # bool  [B, S, Lt]
    row_mask: np.ndarray     # bool  [B]

    @property
    def batch_size(self) -> int:
        return self.query.shape[0]

    def to(self, device) -> "SessionBatch":
        """The same batch as torch tensors on ``device`` (ids as int64)."""
        return _batch_to(self, device)


def _pad_ids(ids: list[int], length: int) -> tuple[np.ndarray, np.ndarray]:
    arr = np.full((length,), PAD, dtype=np.int32)
    n = min(len(ids), length)
    arr[:n] = ids[:n]
    mask = np.zeros((length,), dtype=bool)
    mask[:n] = True
    return arr, mask


def _encode_query(q: Query, word_dict: Dictionary, length: int):
    return _pad_ids(word_dict.encode(q.tokens), length)


def _encode_doc(d: Document, word_dict: Dictionary, length: int):
    return _pad_ids(word_dict.encode(d.tokens), length)


def _encode_chars(tokens: list[str], length: int,
                  word_len: int) -> np.ndarray:
    """[length, word_len] byte ids of the first ``length`` tokens."""
    out = np.zeros((length, word_len), np.int32)
    for i, tok in enumerate(tokens[:length]):
        out[i] = _CHAR_DICT.encode_word(tok, word_len)
    return out


def _encode_target(q: Query, word_dict: Dictionary, length: int):
    """Teacher-forcing pair: (BOS + toks)[:L], (toks + EOS)[:L]."""
    ids = word_dict.encode(q.tokens)[: length - 1]
    tin, _ = _pad_ids([BOS] + ids, length)
    tout, tmask = _pad_ids(ids + [EOS], length)
    return tin, tout, tmask


def rank_examples(sessions: list[Session]) -> list[Query]:
    """Flatten sessions into (query, slate) examples with >=1 candidate."""
    return [q for s in sessions for q in s.queries if q.documents]


def suggest_examples(sessions: list[Session]
                     ) -> list[tuple[list[Query], Query, Query]]:
    """(context queries incl. current, current query, next query) triples."""
    out = []
    for s in sessions:
        for t in range(len(s.queries) - 1):
            out.append((s.queries[: t + 1], s.queries[t], s.queries[t + 1]))
    return out


def build_rank_batch(examples: list[Query], word_dict: Dictionary,
                     shapes: ShapeConfig, batch_size: int | None = None,
                     fast=None) -> RankBatch:
    """One row per query: its ids and its first ``num_candidates``
    documents with their click labels; character ids too where
    ``shapes.max_word_len > 0``.  ``fast``: a ``data.fast.FastVocab`` that
    encodes the words natively (not the character ids), to the same
    batch."""
    B = batch_size or len(examples)
    Lq, N, Ld = shapes.max_query_len, shapes.num_candidates, shapes.max_doc_len
    if fast is not None and shapes.max_word_len == 0:
        return _build_rank_batch_fast(examples, shapes, B, fast)
    query = np.full((B, Lq), PAD, np.int32)
    query_mask = np.zeros((B, Lq), bool)
    docs = np.full((B, N, Ld), PAD, np.int32)
    doc_mask = np.zeros((B, N, Ld), bool)
    labels = np.zeros((B, N), np.float32)
    cand_mask = np.zeros((B, N), bool)
    row_mask = np.zeros((B,), bool)
    Lw = shapes.max_word_len
    q_chars = np.zeros((B, Lq, Lw), np.int32) if Lw else None
    d_chars = np.zeros((B, N, Ld, Lw), np.int32) if Lw else None
    for i, q in enumerate(examples[:B]):
        query[i], query_mask[i] = _encode_query(q, word_dict, Lq)
        if Lw:
            q_chars[i] = _encode_chars(q.tokens, Lq, Lw)
        for j, d in enumerate(q.documents[:N]):
            docs[i, j], doc_mask[i, j] = _encode_doc(d, word_dict, Ld)
            labels[i, j] = float(d.label)
            cand_mask[i, j] = True
            if Lw:
                d_chars[i, j] = _encode_chars(d.tokens, Ld, Lw)
        row_mask[i] = True
    return RankBatch(query, query_mask, docs, doc_mask, labels, cand_mask,
                     row_mask, q_chars, d_chars)


def _build_rank_batch_fast(examples, shapes: ShapeConfig, B: int,
                           fast) -> RankBatch:
    """``build_rank_batch`` through the native vectorizer."""
    Lq, N, Ld = (shapes.max_query_len, shapes.num_candidates,
                 shapes.max_doc_len)
    n = min(len(examples), B)
    q_texts = [" ".join(q.tokens) for q in examples[:n]]
    d_texts, labels_l, cand_l = [], [], []
    for q in examples[:n]:
        docs = q.documents[:N]
        d_texts.extend(" ".join(d.tokens) for d in docs)
        d_texts.extend([""] * (N - len(docs)))
        labels_l.append([float(d.label) for d in docs]
                        + [0.0] * (N - len(docs)))
        cand_l.append([True] * len(docs) + [False] * (N - len(docs)))
    q_ids, q_mask = fast.encode_batch(q_texts, Lq)
    d_ids, d_mask = fast.encode_batch(d_texts, Ld)

    query = np.full((B, Lq), PAD, np.int32)
    query_mask = np.zeros((B, Lq), bool)
    docs = np.full((B, N, Ld), PAD, np.int32)
    doc_mask = np.zeros((B, N, Ld), bool)
    labels = np.zeros((B, N), np.float32)
    cand_mask = np.zeros((B, N), bool)
    row_mask = np.zeros((B,), bool)
    query[:n], query_mask[:n] = q_ids, q_mask
    docs[:n] = d_ids.reshape(n, N, Ld)
    doc_mask[:n] = d_mask.reshape(n, N, Ld)
    labels[:n] = np.asarray(labels_l, np.float32).reshape(n, N)
    cand_mask[:n] = np.asarray(cand_l, bool).reshape(n, N)
    row_mask[:n] = True
    return RankBatch(query, query_mask, docs, doc_mask, labels, cand_mask,
                     row_mask)


def build_suggest_batch(examples: list[tuple[list[Query], Query, Query]],
                        word_dict: Dictionary, shapes: ShapeConfig,
                        batch_size: int | None = None,
                        fast=None) -> SuggestBatch:
    """``examples``: ``(context queries, current query, next query)`` per
    row; the last ``max_session_len`` context queries are kept and the next
    query is the teacher-forced target.  ``fast`` is taken and unused, as
    in JAX: suggestion batches have no native path."""
    del fast
    B = batch_size or len(examples)
    S, Lq = shapes.max_session_len, shapes.max_query_len
    Lt, Lsrc = shapes.max_target_len, shapes.max_source_len
    source = np.full((B, Lsrc), PAD, np.int32)
    source_mask = np.zeros((B, Lsrc), bool)
    context = np.full((B, S, Lq), PAD, np.int32)
    context_mask = np.zeros((B, S, Lq), bool)
    turn_mask = np.zeros((B, S), bool)
    target_in = np.full((B, Lt), PAD, np.int32)
    target_out = np.full((B, Lt), PAD, np.int32)
    target_mask = np.zeros((B, Lt), bool)
    row_mask = np.zeros((B,), bool)
    for i, (ctx, _cur, nxt) in enumerate(examples[:B]):
        flat: list[int] = []
        for t, q in enumerate(ctx[-S:]):
            context[i, t], context_mask[i, t] = _encode_query(q, word_dict, Lq)
            turn_mask[i, t] = True
            # truncated per turn as `context` is, so `flat` never exceeds
            # S * Lq = Lsrc and the newest turns are never cut
            flat.extend(word_dict.encode(q.tokens[:Lq]))
        source[i], source_mask[i] = _pad_ids(flat, Lsrc)
        target_in[i], target_out[i], target_mask[i] = _encode_target(
            nxt, word_dict, Lt)
        row_mask[i] = True
    return SuggestBatch(source, source_mask, context, context_mask, turn_mask,
                        target_in, target_out, target_mask, row_mask)


def build_session_batch(sessions: list[Session], word_dict: Dictionary,
                        shapes: ShapeConfig, batch_size: int | None = None,
                        fast=None) -> SessionBatch:
    """One whole session a row; ``fast`` (a ``data.fast.FastVocab``)
    encodes natively, to the same batch."""
    B = batch_size or len(sessions)
    S, Lq = shapes.max_session_len, shapes.max_query_len
    N, Ld, Lt = shapes.num_candidates, shapes.max_doc_len, shapes.max_target_len
    if fast is not None:
        return _build_session_batch_fast(sessions, shapes, B, fast)
    query = np.full((B, S, Lq), PAD, np.int32)
    query_mask = np.zeros((B, S, Lq), bool)
    docs = np.full((B, S, N, Ld), PAD, np.int32)
    doc_mask = np.zeros((B, S, N, Ld), bool)
    clicks = np.zeros((B, S, N), np.float32)
    cand_mask = np.zeros((B, S, N), bool)
    turn_mask = np.zeros((B, S), bool)
    target_in = np.full((B, S, Lt), PAD, np.int32)
    target_out = np.full((B, S, Lt), PAD, np.int32)
    target_mask = np.zeros((B, S, Lt), bool)
    row_mask = np.zeros((B,), bool)
    for i, sess in enumerate(sessions[:B]):
        qs = sess.queries[:S]
        for t, q in enumerate(qs):
            query[i, t], query_mask[i, t] = _encode_query(q, word_dict, Lq)
            turn_mask[i, t] = True
            for j, d in enumerate(q.documents[:N]):
                docs[i, t, j], doc_mask[i, t, j] = _encode_doc(d, word_dict, Ld)
                clicks[i, t, j] = float(d.label)
                cand_mask[i, t, j] = True
            if t + 1 < len(qs):
                (target_in[i, t], target_out[i, t],
                 target_mask[i, t]) = _encode_target(qs[t + 1], word_dict, Lt)
        row_mask[i] = True
    return SessionBatch(query, query_mask, docs, doc_mask, clicks, cand_mask,
                        turn_mask, target_in, target_out, target_mask, row_mask)


def _build_session_batch_fast(sessions, shapes: ShapeConfig, B: int,
                              fast) -> SessionBatch:
    """``build_session_batch`` through the native vectorizer: every text of
    the batch (padded turns and slots as empty strings) in three native
    calls, then the masks of the padding wiped."""
    S, Lq = shapes.max_session_len, shapes.max_query_len
    N, Ld, Lt = (shapes.num_candidates, shapes.max_doc_len,
                 shapes.max_target_len)
    n = min(len(sessions), B)
    q_texts, d_texts, t_texts = [], [], []
    clicks = np.zeros((B, S, N), np.float32)
    cand_mask = np.zeros((B, S, N), bool)
    turn_mask = np.zeros((B, S), bool)
    has_target = np.zeros((B, S), bool)
    row_mask = np.zeros((B,), bool)
    for i, sess in enumerate(sessions[:n]):
        qs = sess.queries[:S]
        for t in range(S):
            if t < len(qs):
                q = qs[t]
                q_texts.append(" ".join(q.tokens))
                turn_mask[i, t] = True
                docs_t = q.documents[:N]
                d_texts.extend(" ".join(d.tokens) for d in docs_t)
                d_texts.extend([""] * (N - len(docs_t)))
                for j, d in enumerate(docs_t):
                    clicks[i, t, j] = float(d.label)
                    cand_mask[i, t, j] = True
                if t + 1 < len(qs):
                    t_texts.append(" ".join(qs[t + 1].tokens))
                    has_target[i, t] = True
                else:
                    t_texts.append("")
            else:
                q_texts.append("")
                t_texts.append("")
                d_texts.extend([""] * N)
        row_mask[i] = True

    q_ids, q_mask = fast.encode_batch(q_texts, Lq)
    d_ids, d_mask = fast.encode_batch(d_texts, Ld)
    tin, tout, tmask = fast.encode_targets(t_texts, Lt)

    query = np.full((B, S, Lq), PAD, np.int32)
    query_mask = np.zeros((B, S, Lq), bool)
    docs = np.full((B, S, N, Ld), PAD, np.int32)
    doc_mask = np.zeros((B, S, N, Ld), bool)
    target_in = np.full((B, S, Lt), PAD, np.int32)
    target_out = np.full((B, S, Lt), PAD, np.int32)
    target_mask = np.zeros((B, S, Lt), bool)
    query[:n] = q_ids.reshape(n, S, Lq)
    query_mask[:n] = q_mask.reshape(n, S, Lq)
    docs[:n] = d_ids.reshape(n, S, N, Ld)
    doc_mask[:n] = d_mask.reshape(n, S, N, Ld)
    ht = has_target[:n].reshape(-1)
    target_in[:n] = np.where(ht[:, None], tin, PAD).reshape(n, S, Lt)
    target_out[:n] = np.where(ht[:, None], tout, PAD).reshape(n, S, Lt)
    target_mask[:n] = (tmask & ht[:, None]).reshape(n, S, Lt)
    # padded turns and slots: wipe the masks their empty strings left
    query_mask[:n] &= turn_mask[:n, :, None]
    doc_mask[:n] &= cand_mask[:n, :, :, None]
    return SessionBatch(query, query_mask, docs, doc_mask, clicks, cand_mask,
                        turn_mask, target_in, target_out, target_mask,
                        row_mask)
