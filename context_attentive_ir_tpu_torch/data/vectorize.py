"""Vectorization: object graph -> static-shape numpy batches.

The port of the Python path of ``context_attentive_ir_tpu/data/vectorize.py``
for the multitask and recommender families: every batch is padded to a
fixed ``ShapeConfig`` and bool masks carry the true lengths, so the port
sees exactly the id tensors the JAX package builds.  ``SessionBatch`` (one
whole session per row) and ``SuggestBatch`` (one session prefix and its
next query per row) are plain dataclasses of numpy arrays; their ``to``
moves them onto a torch device.
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
    NUM_CANDIDATES,
    PAD,
)
from .dictionary import Dictionary
from .objects import Document, Query, Session


@dataclass(frozen=True)
class ShapeConfig:
    """Static padding targets for every tensor in a batch."""

    max_query_len: int = MAX_QUERY_LEN
    max_doc_len: int = MAX_DOC_LEN
    max_session_len: int = MAX_SESSION_LEN
    num_candidates: int = NUM_CANDIDATES

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
                       num_candidates=config.num_candidates)


def _batch_to(batch, device):
    """The same batch as torch tensors on ``device`` (ids as int64)."""
    def conv(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if t.dtype == torch.int32:
            t = t.long()
        return t.to(device)

    return type(batch)(**{f.name: conv(getattr(batch, f.name))
                          for f in dataclasses.fields(batch)})


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


def _encode_target(q: Query, word_dict: Dictionary, length: int):
    """Teacher-forcing pair: (BOS + toks)[:L], (toks + EOS)[:L]."""
    ids = word_dict.encode(q.tokens)[: length - 1]
    tin, _ = _pad_ids([BOS] + ids, length)
    tout, tmask = _pad_ids(ids + [EOS], length)
    return tin, tout, tmask


def build_suggest_batch(examples: list[tuple[list[Query], Query, Query]],
                        word_dict: Dictionary, shapes: ShapeConfig,
                        batch_size: int | None = None) -> SuggestBatch:
    """``examples``: ``(context queries, current query, next query)`` per
    row; the last ``max_session_len`` context queries are kept and the next
    query is the teacher-forced target."""
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
                        shapes: ShapeConfig,
                        batch_size: int | None = None) -> SessionBatch:
    B = batch_size or len(sessions)
    S, Lq = shapes.max_session_len, shapes.max_query_len
    N, Ld, Lt = shapes.num_candidates, shapes.max_doc_len, shapes.max_target_len
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
