"""Inference engine: rank and suggest from raw text (port of ``Engine`` in
``context_attentive_ir_tpu/serve.py`` for every model of the zoo: the
rankers, the multitask models CARS, M-NSRF and M-MatchTensor, and the
recommenders HRED-QS, seq2seq and ACG).

Requests are padded to the model's static shapes and batched into buckets
of ``batch_bucket`` rows, as in the JAX engine.  A ranker is session-blind:
it scores one flat ``RankBatch`` row per request, the request's current
query and its slate (Match-Tensor's encoders through the fused LSTM or GRU
kernel; the other rankers launch no kernel of the port), and cannot
suggest.  The multitask models rank with their encoders through the fused
LSTM or GRU kernel (and CARS's query-aware doc pooling through the
slate-pool kernel when the config sets ``use_pallas_slate``); suggestion
runs beam search (or greedy at
``beam_size=1``).  CARS with a tied generator decodes through the fused
generator step -- top-``beam_size + 1`` for beam, top-2 for greedy -- so
the ``[rows, V]`` logits never exist, wherever the kernels hold the shape
(``make_fused_beam_step``: top-kc up to 128, so beam up to 127, the JAX
kernel's limit, at any emsize); past that, untied, and for every
other model, none of which has a fused step in the JAX package either, it
decodes through the model's logits step, which is exact.  M-NSRF and
M-MatchTensor decode every turn of the session (``B*S`` rows) from the
query flow alone.  ACG decodes through its copy-mixture step over the
request's source tokens and takes no shortlist, as in JAX.  On the CPU
(``device="cpu"``) the same step structure runs on the kernels' plain
versions.

``index_documents`` (CARS, the one model with ``encode_docs``) encodes a
corpus once; ``rank_indexed`` / ``rank_indexed_batch`` then rank its
documents by id, paying only for the queries, the pooling and the
scoring.  ``suggest_shortlist=C`` restricts the generator to C vocab ids
per request batch (``decode/shortlist.py``).  ``Engine.from_checkpoint``
loads a checkpoint written by the port's ``train.Checkpointer``,
optionally with the int8 embedding table (``quantize_embeddings=True``),
whose suggestions run through the generator kernel's int8 mode.

``mesh`` (``parallel.make_mesh``) serves data-parallel, as the JAX engine
does under its mesh: the parameters replicate, ``batch_bucket`` rounds up
to a multiple of ``mesh.size``, every request batch shards on its leading
axis (each replica runs its shard through the same kernels) and the
results are gathered in order; ``index_documents`` pads the corpus to a
mesh multiple, encodes it sharded and replicates the finished index, and a
suggestion shortlist replicates.  A one-replica mesh serves as no mesh.
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
    build_rank_batch,
    build_session_batch,
    build_suggest_batch,
    shapes_from_config,
)
from .data.objects import Document, Query, Session
from .decode import (
    beam_search,
    build_shortlist,
    can_fuse_generator,
    greedy_decode,
    make_fused_beam_step,
    make_shortlist_xla_step,
)
from .device import resolve_device
from .models import build_model, task_family
from .models.base import compute_dtype
from .models.multitask.cars import clicks_exceed_suggest_cap
from .ops.kernels.beamgen import MAX_KC
from .ops.dispatch import prefer_fused_generator
from .ops.layers import quantize_embedding_table
from .parallel.mesh import (
    Mesh,
    gather,
    model_replicas,
    pad_to_multiple,
    replicated,
    shard_batch,
    to_device,
)
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
    """One loaded model behind ``rank``/``suggest``: a multitask model
    (CARS, M-NSRF, M-MatchTensor) ranks and suggests, a ranker only ranks,
    a recommender (HRED-QS, seq2seq, ACG) only suggests.

    ``params``: a state dict of the port's model for ``config.model_type``
    (``convert.params_from_jax`` of a JAX param tree, or
    ``models.build_model(...).state_dict()``; for a config with
    ``quantize_embeddings``, ``quantize_embedding_params`` of one).

    ``suggest_shortlist``: > 0 restricts the suggestion generator to that
    many vocab ids per request batch -- the specials, the batch's query
    and clicked-document tokens, the most frequent ids as fill
    (approximate: the softmax support is the shortlist); 0 decodes over
    the whole vocabulary.

    ``mesh``: a ``parallel.Mesh`` to serve on (module docstring); the
    model then lives on the mesh's primary device and ``device`` must be
    left unset or name that device.
    """

    def __init__(self, config: ModelConfig, word_dict: Dictionary, params,
                 beam_size: int = 5, batch_bucket: int = 8,
                 mesh: Optional[Mesh] = None, suggest_shortlist: int = 0,
                 suggest_early_exit: bool = True, device=None):
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.primary:
                raise ValueError(f"device={device} but the mesh's primary "
                                 f"is {mesh.primary}")
            self.device = mesh.primary
            batch_bucket = pad_to_multiple(batch_bucket, mesh.size)
        else:
            self.device = resolve_device("cuda" if device is None
                                         else device)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.config = config
        self.family = task_family(config.model_type)
        self.word_dict = word_dict
        self.model = build_model(config, device=self.device, seed=None)
        self.model.load_state_dict(params)
        self.model.eval()
        self.models = ([self.model] if self.mesh is None
                       else model_replicas(self.model, self.mesh))
        self.shapes = shapes_from_config(config)
        self.beam_size = beam_size
        self.batch_bucket = batch_bucket
        self.suggest_shortlist = min(suggest_shortlist, config.vocab_size)
        # all-finished early exit: on at this serving surface, where trained
        # models emit EOS well inside the max_len budget
        self.suggest_early_exit = suggest_early_exit

    @classmethod
    def from_checkpoint(cls, path: str | Path, beam_size: int = 5,
                        quantize_embeddings: bool = False, device=None,
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

    def _map(self, fn, *args):
        """``fn(model, *args)`` on every replica and the outputs gathered
        in replica order (``fn(self.model, *args)`` without a mesh).  Each
        argument is a host batch or numpy array (split into contiguous
        shards on axis 0, each moved to its replica's device) or a list of
        per-replica values (``parallel.replicated``)."""
        if self.mesh is None:
            return fn(self.model, *(a[0] if isinstance(a, list)
                                    else to_device(a, self.device)
                                    for a in args))
        per = [a if isinstance(a, list) else shard_batch(a, self.mesh)
               for a in args]
        return gather([fn(m, *(p[r] for p in per))
                       for r, m in enumerate(self.models)], self.mesh)

    # -- ranking --------------------------------------------------------------

    def rank(self, query: str, docs: Sequence[str],
             history: Sequence = ()) -> list[float]:
        """Scores for ``docs`` given ``query`` (+ session history, entries
        ``query`` or ``(query, [clicked docs])``)."""
        return self.rank_batch([(query, docs, history)])[0]

    def rank_batch(self, requests: Sequence[tuple]) -> list[list[float]]:
        """requests: [(query, docs, history)] -> per-request doc scores (a
        ranker ignores the history)."""
        if self.family == "recommender":
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
        B = self._bucket(len(sessions))
        if self.family == "ranker":
            # one flat row per request: its current (last) query and slate
            batch = build_rank_batch([s.queries[-1] for s in sessions],
                                     self.word_dict, self.shapes,
                                     batch_size=B)
        else:
            batch = build_session_batch(sessions, self.word_dict,
                                        self.shapes, batch_size=B)
        with torch.inference_mode():
            scores = self._map(lambda m, b: m.score(b), batch)
            scores = scores.float().cpu().numpy()
        out = []
        for i, (req, sess) in enumerate(zip(requests, sessions)):
            row = (scores[i] if scores.ndim == 2
                   else scores[i, len(sess.queries) - 1])
            out.append(row[: len(req[1])].tolist())
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
        n = len(texts)
        # under a mesh the corpus pads to a mesh multiple and encodes
        # sharded; the finished index replicates
        n_pad = n if self.mesh is None else pad_to_multiple(
            max(n, 1), self.mesh.size)
        ids = np.zeros((n_pad, Ld), np.int64)
        mask = np.zeros((n_pad, Ld), bool)
        for i, t in enumerate(texts):
            toks = self.word_dict.encode(t.split()[:Ld])
            ids[i, :len(toks)] = toks
            mask[i, :len(toks)] = True

        def encode(model, ids, mask):
            states = model.encode_docs(ids, mask)
            if not cache_pool_proj:
                return (states,)
            return states, model.encode_docs_proj(states)

        with torch.inference_mode():
            out = self._map(encode, ids, mask)
        states, proj = out[0], (out[1] if cache_pool_proj else None)
        index = {"states": states[:n],
                 "mask": torch.from_numpy(mask[:n]).to(self.device),
                 "proj": None if proj is None else proj[:n]}
        if self.mesh is not None:
            index["replicas"] = replicated(
                {k: index[k] for k in ("states", "mask", "proj")},
                self.mesh)
        return index

    def _check_doc_cache(self) -> None:
        if not hasattr(self.model, "encode_docs"):
            raise ServeError(
                f"{self.config.model_type} has no cached-doc path")

    @staticmethod
    def _rank_indexed_impl(model, batch, states, smask, idx, proj=None):
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
        return model.score(batch, expand(states),
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
        if self.mesh is None:
            reps = [(index["states"], index["mask"], index.get("proj"))]
        elif "replicas" in index:
            reps = [(r["states"], r["mask"], r["proj"])
                    for r in index["replicas"]]
        else:
            raise ServeError("the index was not built by an Engine on this "
                             "mesh; build it with this Engine's "
                             "index_documents")
        with torch.inference_mode():
            scores = self._map(
                lambda m, b, i, rep: self._rank_indexed_impl(
                    m, b, rep[0], rep[1], i, rep[2]),
                batch, idx, reps)
            scores = scores.float().cpu().numpy()
        out = []
        for i, ((_, ids, _), sess) in enumerate(zip(reqs, sessions)):
            out.append(scores[i, len(sess.queries) - 1][: len(ids)]
                       .tolist())
        return out

    # -- suggestion -----------------------------------------------------------

    def _decode_step(self, model, memory, memory_mask, kc: int, shortlist,
                     kwargs: dict):
        """The fused generator step, with its serial, pruned or pipelined
        selection from the dispatch table, as the JAX engine reads its
        choices from its TPU table; where it is None (no
        ``decode_step_fused``, an untied generator, or a kc or E the
        kernels do not hold), as the JAX engine does, the model's logits
        step.  A table row that prefers the logits step to a fused step
        the kernels hold (``ops.dispatch.prefer_fused_generator``) takes it
        on CPU tensors and raises on CUDA tensors, as does a shortlist past
        the kernels' kc or E: there the plain step would do the generator
        kernel's work in plain PyTorch.  ``kwargs`` (the model's
        ``decode_kwargs``, ACG's source tokens) go to the logits step and
        rule out the other two."""
        dtype = compute_dtype(self.config)
        step = None
        if not kwargs:
            step = make_fused_beam_step(model, memory, memory_mask, kc,
                                        dtype, shortlist=shortlist)
            v_eff = (self.config.vocab_size if shortlist is None
                     else len(shortlist))
            if step is not None and not prefer_fused_generator(
                    memory.shape[0], v_eff, self.config.emsize, kc,
                    t=self.shapes.max_target_len):
                if memory.is_cuda:
                    raise ServeError(
                        "a row of ops/dispatch_table.json prefers the "
                        f"logits step to the fused generator kernel at "
                        f"{memory.shape[0]} rows, top-{kc}; the port runs "
                        "no plain step on the card in the kernel's place")
                step = None
            if step is None and shortlist is not None:
                if memory.is_cuda and can_fuse_generator(model):
                    raise ServeError(
                        f"suggest_shortlist on the card runs the fused "
                        f"generator kernel, which holds top-{MAX_KC} "
                        f"(beam_size <= {MAX_KC - 1}); got top-{kc}")
                step = make_shortlist_xla_step(model, memory, memory_mask,
                                               kc, dtype, shortlist)
        if step is None:
            def step(state, tokens):
                return model.decode_step(state, tokens, memory, memory_mask,
                                         **kwargs)
        return step

    def _suggest_impl(self, model, batch, init_method: str, shortlist=None):
        """``(seqs [rows, K, T], scores [rows, K])`` of one replica's
        batch."""
        state, memory, memory_mask = getattr(model, init_method)(batch)
        rows = memory.shape[0]
        max_len = self.shapes.max_target_len
        K = self.beam_size
        kwargs = model.decode_kwargs(batch)
        if K > 1:
            rep = lambda t: t.repeat_interleave(K, dim=0)
            step = self._decode_step(model, rep(memory), rep(memory_mask),
                                     K + 1, shortlist,
                                     {k: rep(v) for k, v in kwargs.items()})
            return beam_search(step, state, rows, max_len, K,
                               return_nbest=True,
                               early_exit=self.suggest_early_exit)
        # greedy takes the same fused step at kc=2 (one spare slot covers a
        # min_length-blocked EOS -- exact)
        step = self._decode_step(model, memory, memory_mask, 2, shortlist,
                                 kwargs)
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
        if self.family == "ranker":
            raise ServeError(f"{self.config.model_type} cannot suggest")
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
            # exact at any click count: past the cap, a model with a
            # full-slate init (CARS) decodes from the full slate; the others
            # decode from the query flow, which no click changes
            init = ("decode_init_full"
                    if hasattr(self.model, "decode_init_full")
                    and clicks_exceed_suggest_cap(
                        batch, self.config.suggest_max_clicks)
                    else "decode_init")
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
            seqs, scores = self._map(
                lambda m, b: self._suggest_impl(m, b, init, shortlist), batch)
            seqs, scores = seqs.cpu().numpy(), scores.float().cpu().numpy()
        return [[(" ".join(self.word_dict.decode(seqs[r, k])),
                  float(scores[r, k]))
                 for k in range(min(n_best, seqs.shape[1]))] for r in rows]
