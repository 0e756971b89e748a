"""Inference engine: rank and suggest from raw text (port of ``Engine`` in
``context_attentive_ir_tpu/serve.py`` for CARS and HRED-QS).

Requests are padded to the model's static shapes and batched into buckets
of ``batch_bucket`` rows, as in the JAX engine.  Ranking (CARS only) runs
the encoders through the fused LSTM or GRU kernel (and the query-aware doc
pooling through the slate-pool kernel when the config sets
``use_pallas_slate``); suggestion runs beam search (or greedy at
``beam_size=1``).  CARS decodes through the fused generator step --
top-``beam_size + 1`` for beam, top-2 for greedy -- so the ``[rows, V]``
logits never exist; HRED-QS, which has no fused step in the JAX package
either, decodes through its logits step.  On the CPU (``device="cpu"``)
the same step structure runs on the kernels' plain versions.

``index_documents`` encodes a corpus once; ``rank_indexed`` /
``rank_indexed_batch`` then rank its documents by id, paying only for the
queries, the pooling and the scoring.  ``suggest_shortlist=C`` restricts
the generator to C vocab ids per request batch (``decode/shortlist.py``).
``Engine.from_checkpoint`` loads a checkpoint written by the port's
``train.Checkpointer``, optionally with the int8 embedding table
(``quantize_embeddings=True``), whose suggestions run through the
generator kernel's int8 mode.  Not ported: the device mesh.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from .config import ModelConfig
from .data import (
    Dictionary,
    build_session_batch,
    build_suggest_batch,
    shapes_from_config,
)
from .data.objects import Document, Query, Session
from .decode import (
    beam_search,
    build_shortlist,
    greedy_decode,
    make_fused_beam_step,
)
from .device import resolve_device
from .models import MODEL_CLASSES, build_model, task_family
from .models.base import compute_dtype
from .models.multitask.cars import clicks_exceed_suggest_cap
from .ops.layers import quantize_embedding_table
from .train.checkpoint import Checkpointer


def quantize_embedding_params(params: Mapping) -> dict:
    """A state dict with every 2-D ``<prefix>.embedding`` table replaced by
    its int8 values ``<prefix>.embedding_q`` and per-row scales
    ``<prefix>.embedding_scale`` (``quantize_embedding_table``), for a
    model whose config sets ``quantize_embeddings`` (the JAX
    ``quantize_embedding_params`` on a flat state dict)."""
    out = {}
    for name, value in params.items():
        prefix, _, leaf = name.rpartition(".")
        if prefix and leaf == "embedding" and value.dim() == 2:
            q, scale = quantize_embedding_table(
                value.detach().float().cpu().numpy())
            out[f"{prefix}.embedding_q"] = torch.from_numpy(q)
            out[f"{prefix}.embedding_scale"] = torch.from_numpy(scale)
        else:
            out[name] = value
    return out


class ServeError(ValueError):
    """A serving request the loaded model cannot fulfil (wrong family,
    missing capability, malformed input)."""


class Engine:
    """One loaded model behind ``rank``/``suggest``: CARS ranks and
    suggests, HRED-QS (a recommender) only suggests.

    ``params``: a state dict of the port's model for ``config.model_type``
    (``convert.params_from_jax`` of a JAX param tree, or
    ``models.build_model(...).state_dict()``; for a config with
    ``quantize_embeddings``, ``quantize_embedding_params`` of one).

    ``suggest_shortlist``: > 0 restricts the suggestion generator to that
    many vocab ids per request batch -- the specials, the batch's query
    and clicked-document tokens, the most frequent ids as fill
    (approximate: the softmax support is the shortlist); 0 decodes over
    the whole vocabulary.
    """

    def __init__(self, config: ModelConfig, word_dict: Dictionary, params,
                 beam_size: int = 5, batch_bucket: int = 8,
                 suggest_shortlist: int = 0,
                 suggest_early_exit: bool = True, device="cuda"):
        if config.model_type not in MODEL_CLASSES:
            raise ServeError(f"{config.model_type} is not ported; the "
                             f"port serves {sorted(MODEL_CLASSES)}")
        self.device = resolve_device(device)
        self.config = config
        self.family = task_family(config.model_type)
        self.word_dict = word_dict
        self.model = build_model(config, device=self.device, seed=None)
        self.model.load_state_dict(params)
        self.model.eval()
        self.shapes = shapes_from_config(config)
        self.beam_size = beam_size
        self.batch_bucket = batch_bucket
        self.suggest_shortlist = min(suggest_shortlist, config.vocab_size)
        # all-finished early exit: on at this serving surface, where trained
        # models emit EOS well inside the max_len budget
        self.suggest_early_exit = suggest_early_exit

    @classmethod
    def from_checkpoint(cls, path: str | Path, beam_size: int = 5,
                        quantize_embeddings: bool = False, device="cuda",
                        **kw) -> "Engine":
        """An Engine over the parameters of a checkpoint directory written
        by ``train.Checkpointer`` (config and vocabulary from its
        sidecars); ``quantize_embeddings`` serves from the int8 table."""
        config, word_dict, _ = Checkpointer.peek(path)
        params = Checkpointer.read_state(path)["params"]
        if quantize_embeddings:
            config = config.replace(quantize_embeddings=True)
            params = quantize_embedding_params(params)
        return cls(config, word_dict, params, beam_size, device=device, **kw)

    # -- request -> batch -----------------------------------------------------

    def _history_queries(self, history: Sequence) -> list[Query]:
        """History turns from request entries: a query string, optionally
        paired with that turn's clicked document texts ``(query, [docs])``;
        clicked docs become label-1 candidates and feed the click flow."""
        qs = []
        for i, h in enumerate(history):
            if isinstance(h, (tuple, list)):
                q_text, clicked = h[0], list(h[1])
            else:
                q_text, clicked = h, []
            cands = [Document(f"c{i}_{j}",
                              d.split()[: self.shapes.max_doc_len], 1)
                     for j, d in enumerate(
                         clicked[: self.shapes.num_candidates])]
            qs.append(Query(f"h{i}",
                            q_text.split()[: self.shapes.max_query_len],
                            cands))
        return qs

    def _to_sessions(self, history: Sequence, query: str,
                     docs: Sequence[str]) -> Session:
        qs = self._history_queries(history)
        cands = [Document(f"d{i}", d.split()[: self.shapes.max_doc_len], 0)
                 for i, d in enumerate(docs[: self.shapes.num_candidates])]
        qs.append(Query("current",
                        query.split()[: self.shapes.max_query_len], cands))
        return Session("req", qs[-self.shapes.max_session_len:])

    def _bucket(self, n: int) -> int:
        b = self.batch_bucket
        return ((n + b - 1) // b) * b

    # -- ranking --------------------------------------------------------------

    def rank(self, query: str, docs: Sequence[str],
             history: Sequence = ()) -> list[float]:
        """Scores for ``docs`` given ``query`` (+ session history, entries
        ``query`` or ``(query, [clicked docs])``)."""
        return self.rank_batch([(query, docs, history)])[0]

    def rank_batch(self, requests: Sequence[tuple]) -> list[list[float]]:
        """requests: [(query, docs, history)] -> per-request doc scores."""
        if self.family != "multitask":
            raise ServeError(f"{self.config.model_type} cannot rank")
        for r in requests:
            if len(r[1]) > self.shapes.num_candidates:
                raise ServeError(
                    f"{len(r[1])} documents exceed the slate size "
                    f"({self.shapes.num_candidates}); raise num_candidates "
                    "or split the request")
        sessions = [self._to_sessions(h, q, d) for q, d, h in
                    ((r[0], r[1], r[2] if len(r) > 2 else ())
                     for r in requests)]
        batch = build_session_batch(sessions, self.word_dict, self.shapes,
                                    batch_size=self._bucket(len(sessions)))
        with torch.inference_mode():
            scores = self.model.score(batch.to(self.device))
            scores = scores.float().cpu().numpy()
        out = []
        for i, (req, sess) in enumerate(zip(requests, sessions)):
            out.append(scores[i, len(sess.queries) - 1][: len(req[1])]
                       .tolist())
        return out

    # -- cached-document ranking ----------------------------------------------

    def index_documents(self, texts: Sequence[str],
                        cache_pool_proj: bool = False) -> dict:
        """Precompute query-independent document encodings: ``{"states"
        [n, Ld, H2], "mask" [n, Ld], "proj" [n, Ld, H2] | None}`` on the
        engine's device.  ``cache_pool_proj`` also caches the pooling
        projection ``tanh(states @ W_p + b_p)`` (query-independent too) at
        twice the index memory; ranking then skips it, and the slate-pool
        kernel with it."""
        self._check_doc_cache()
        Ld = self.shapes.max_doc_len
        ids = np.zeros((len(texts), Ld), np.int64)
        mask = np.zeros((len(texts), Ld), bool)
        for i, t in enumerate(texts):
            toks = self.word_dict.encode(t.split()[:Ld])
            ids[i, :len(toks)] = toks
            mask[i, :len(toks)] = True
        ids = torch.from_numpy(ids).to(self.device)
        mask = torch.from_numpy(mask).to(self.device)
        with torch.inference_mode():
            states = self.model.encode_docs(ids, mask)
            proj = (self.model.encode_docs_proj(states) if cache_pool_proj
                    else None)
        return {"states": states, "mask": mask, "proj": proj}

    def _check_doc_cache(self) -> None:
        if not hasattr(self.model, "encode_docs"):
            raise ServeError(
                f"{self.config.model_type} has no cached-doc path")

    def _rank_indexed_impl(self, batch, states, smask, idx, proj=None):
        """Score a session batch against per-row cached doc states.
        ``idx`` indexes the corpus rows; two layouts, told apart by rank:

        - ``[B, N]`` -- one slate serves every turn of the request session
          (broadcast over the session axis: gathers B*N state rows);
        - ``[B, S, N]`` -- per-turn slates, used when history turns carry
          clicked doc ids (their slots marked clicked by the batch), the
          final turn holding the request slate."""
        B, S = batch.query.shape[:2]

        def expand(arr):
            g = arr.index_select(0, idx.reshape(-1))
            g = g.reshape(*idx.shape, *arr.shape[1:])
            return g if idx.dim() == 3 else g[:, None].expand(
                B, S, *g.shape[1:])

        batch = dataclasses.replace(batch, doc_mask=expand(smask))
        return self.model.score(batch, expand(states),
                                None if proj is None else expand(proj))

    def rank_indexed(self, query: str, doc_ids: Sequence[int], index: dict,
                     history: Sequence = ()) -> list[float]:
        """Score indexed documents for one query without re-encoding them.
        History entries are ``query`` or ``(query, [clicked doc ids])``;
        clicked ids resolve against the same ``index`` and feed the click
        flow."""
        return self.rank_indexed_batch([(query, doc_ids, history)],
                                       index)[0]

    def rank_indexed_batch(self, requests: Sequence[tuple],
                           index: dict) -> list[list[float]]:
        """requests: [(query, doc_ids, history)] -> per-request scores over
        a prebuilt ``index_documents`` index.  Requests without click
        history take the broadcast slate layout, the others per-turn slates
        (``_rank_indexed_impl``)."""
        self._check_doc_cache()
        N = self.shapes.num_candidates
        n_corpus = getattr(index["states"], "shape", (0,))[0]
        reqs = [(r[0], r[1], r[2] if len(r) > 2 else ()) for r in requests]

        def check_ids(ids, what):
            if len(ids) > N:
                raise ServeError(
                    f"{len(ids)} {what} exceed the slate size {N}")
            bad = [i for i in ids if not 0 <= int(i) < n_corpus]
            if bad:
                raise ServeError(
                    f"{what} {bad} out of range for a {n_corpus}-doc index")

        has_clicks = False
        hist_ids: list[list[list[int]]] = []   # per request, per turn
        hist_texts: list[list] = []            # history for _to_sessions
        for _, doc_ids, history in reqs:
            check_ids(doc_ids, "doc_ids")
            ids_t, texts = [], []
            for h in history:
                if isinstance(h, (tuple, list)):
                    clicked = [int(c) for c in h[1]]
                    check_ids(clicked, "clicked doc ids")
                    has_clicks = has_clicks or bool(clicked)
                    # placeholder texts: the gathered cached states replace
                    # the token content; label-1 docs mark the clicks
                    ids_t.append(clicked)
                    texts.append((h[0], ["x"] * len(clicked)))
                else:
                    ids_t.append([])
                    texts.append(h)
            hist_ids.append(ids_t)
            hist_texts.append(texts)

        sessions = [self._to_sessions(texts, q, ["x"] * len(ids))
                    for (q, ids, _), texts in zip(reqs, hist_texts)]
        B = self._bucket(len(sessions))
        batch = build_session_batch(sessions, self.word_dict, self.shapes,
                                    batch_size=B)
        S = self.shapes.max_session_len
        if has_clicks:
            idx = np.zeros((B, S, N), np.int64)
            for i, ((_, ids, _), turns) in enumerate(zip(reqs, hist_ids)):
                kept = turns[-(S - 1):] if S > 1 else []
                for t, clicked in enumerate(kept):
                    idx[i, t, : len(clicked)] = clicked
                idx[i, len(kept), : len(ids)] = ids
        else:
            idx = np.zeros((B, N), np.int64)
            for i, (_, ids, _) in enumerate(reqs):
                idx[i, : len(ids)] = ids
        with torch.inference_mode():
            scores = self._rank_indexed_impl(
                batch.to(self.device), index["states"], index["mask"],
                torch.from_numpy(idx).to(self.device), index.get("proj"))
            scores = scores.float().cpu().numpy()
        out = []
        for i, ((_, ids, _), sess) in enumerate(zip(reqs, sessions)):
            out.append(scores[i, len(sess.queries) - 1][: len(ids)]
                       .tolist())
        return out

    # -- suggestion -----------------------------------------------------------

    def _decode_step(self, memory, memory_mask, kc: int, shortlist):
        """The fused generator step with its pruned selection (exact, and
        on the H100 at the serving shapes faster than the unpruned one,
        PERF.md, where the JAX engine reads the choice from its TPU
        dispatch table); for a model without ``decode_step_fused``, as
        the JAX engine does, its logits step."""
        step = make_fused_beam_step(self.model, memory, memory_mask, kc,
                                    compute_dtype(self.config), prune=True,
                                    shortlist=shortlist)
        if step is None:
            def step(state, tokens):
                return self.model.decode_step(state, tokens, memory,
                                              memory_mask)
        return step

    def _suggest_impl(self, batch, init_method: str, shortlist=None):
        state, memory, memory_mask = getattr(self.model, init_method)(batch)
        rows = memory.shape[0]
        max_len = self.shapes.max_target_len
        K = self.beam_size
        if K > 1:
            step = self._decode_step(memory.repeat_interleave(K, dim=0),
                                     memory_mask.repeat_interleave(K, dim=0),
                                     K + 1, shortlist)
            return beam_search(step, state, rows, max_len, K,
                               return_nbest=True,
                               early_exit=self.suggest_early_exit)
        # greedy takes the same fused step at kc=2 (one spare slot covers a
        # min_length-blocked EOS -- exact)
        step = self._decode_step(memory, memory_mask, 2, shortlist)
        seqs, scores = greedy_decode(step, state, rows, max_len,
                                     early_exit=self.suggest_early_exit)
        return seqs[:, None], scores[:, None]

    def suggest(self, history: Sequence,
                n_best: Optional[int] = None) -> list[tuple[str, float]]:
        """Next-query suggestions for one session (most recent query last);
        entries are ``query`` or ``(query, [clicked docs])``."""
        return self.suggest_batch([history], n_best=n_best)[0]

    def suggest_batch(self, histories: Sequence[Sequence],
                      n_best: Optional[int] = None
                      ) -> list[list[tuple[str, float]]]:
        """Batched ``suggest``: per-request n-best (text, score) lists."""
        histories = [list(h) for h in histories]
        if not histories or any(not h for h in histories):
            raise ServeError(
                "every history must contain at least the current query")
        n_best = n_best or self.beam_size
        B = self._bucket(len(histories))
        S = self.shapes.max_session_len
        if self.family == "multitask":
            sessions = [Session("req", self._history_queries(h)[-S:])
                        for h in histories]
            batch = build_session_batch(sessions, self.word_dict,
                                        self.shapes, batch_size=B)
            # exact at any click count: past the cap, decode from the full
            # slate
            init = ("decode_init_full" if clicks_exceed_suggest_cap(
                batch, self.config.suggest_max_clicks) else "decode_init")
            source = [batch.query, batch.docs[batch.clicks > 0]]
            rows = [i * S + len(sess.queries) - 1
                    for i, sess in enumerate(sessions)]
        else:
            # a recommender has no click flow: each history is its query
            # texts, the last one standing as the current and the next query
            ex = []
            for h in histories:
                texts = [e[0] if isinstance(e, (tuple, list)) else e
                         for e in h]
                qs = [Query(f"h{i}", t.split()[: self.shapes.max_query_len],
                            []) for i, t in enumerate(texts)][-S:]
                ex.append((qs, qs[-1], qs[-1]))
            batch = build_suggest_batch(ex, self.word_dict, self.shapes,
                                        batch_size=B)
            init = "decode_init"
            source = [batch.source]
            rows = list(range(len(histories)))
        shortlist = None
        if 0 < self.suggest_shortlist < self.config.vocab_size:
            shortlist = build_shortlist(
                self.suggest_shortlist, self.config.vocab_size,
                np.concatenate([a.reshape(-1) for a in source]))
        with torch.inference_mode():
            seqs, scores = self._suggest_impl(batch.to(self.device), init,
                                              shortlist)
            seqs, scores = seqs.cpu().numpy(), scores.float().cpu().numpy()
        return [[(" ".join(self.word_dict.decode(seqs[r, k])),
                  float(scores[r, k]))
                 for k in range(min(n_best, seqs.shape[1]))] for r in rows]
