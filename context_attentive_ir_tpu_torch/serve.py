"""Inference engine: rank and suggest from raw text (port of ``Engine`` in
``context_attentive_ir_tpu/serve.py`` for CARS).

Requests are padded to the model's static shapes and batched into buckets
of ``batch_bucket`` rows, as in the JAX engine.  Ranking runs the encoders
through the fused LSTM kernel; suggestion runs beam search (or greedy at
``beam_size=1``) through the fused generator step -- top-``beam_size + 1``
for beam, top-2 for greedy -- so the ``[rows, V]`` logits never exist.  On
the CPU (``device="cpu"``) the same step structure runs on the kernels'
plain versions.

``Engine.from_checkpoint`` loads a checkpoint written by the port's
``train.Checkpointer``.  Not ported yet: the cached-document index
(``index_documents`` / ``rank_indexed*``), int8 embeddings, the suggestion
shortlist and the device mesh.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import torch

from .config import ModelConfig
from .data import Dictionary, build_session_batch, shapes_from_config
from .data.objects import Document, Query, Session
from .decode import beam_search, greedy_decode, make_fused_beam_step
from .device import resolve_device
from .models.base import compute_dtype
from .models.multitask.cars import CARS, clicks_exceed_suggest_cap
from .train.checkpoint import Checkpointer


class ServeError(ValueError):
    """A serving request the loaded model cannot fulfil (wrong family,
    missing capability, malformed input)."""


class Engine:
    """One loaded CARS model behind ``rank``/``suggest``.

    ``params``: a state dict of the port's CARS (``convert.params_from_jax``
    of a JAX param tree, or ``CARS(...).state_dict()``).
    """

    def __init__(self, config: ModelConfig, word_dict: Dictionary, params,
                 beam_size: int = 5, batch_bucket: int = 8,
                 suggest_early_exit: bool = True, device="cuda"):
        if config.model_type != "cars":
            raise ServeError(f"{config.model_type} is not ported; the "
                             "port serves CARS")
        self.device = resolve_device(device)
        self.config = config
        self.word_dict = word_dict
        self.model = CARS(config, device=self.device, seed=None)
        self.model.load_state_dict(params)
        self.model.eval()
        self.shapes = shapes_from_config(config)
        self.beam_size = beam_size
        self.batch_bucket = batch_bucket
        # all-finished early exit: on at this serving surface, where trained
        # models emit EOS well inside the max_len budget
        self.suggest_early_exit = suggest_early_exit

    @classmethod
    def from_checkpoint(cls, path: str | Path, beam_size: int = 5,
                        quantize_embeddings: bool = False, device="cuda",
                        **kw) -> "Engine":
        """An Engine over the parameters of a checkpoint directory written
        by ``train.Checkpointer`` (config and vocabulary from its
        sidecars)."""
        if quantize_embeddings:
            raise NotImplementedError(
                "quantize_embeddings needs the int8 embedding table and "
                "kernel 2's int8 mode, which are not ported yet")
        config, word_dict, _ = Checkpointer.peek(path)
        params = Checkpointer.read_state(path)["params"]
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

    # -- suggestion -----------------------------------------------------------

    def _suggest_impl(self, batch, init_method: str):
        state, memory, memory_mask = getattr(self.model, init_method)(batch)
        rows = memory.shape[0]
        max_len = self.shapes.max_target_len
        dtype = compute_dtype(self.config)
        K = self.beam_size
        if K > 1:
            mem_k = memory.repeat_interleave(K, dim=0)
            mask_k = memory_mask.repeat_interleave(K, dim=0)
            step = make_fused_beam_step(self.model, mem_k, mask_k, K + 1,
                                        dtype)
            return beam_search(step, state, rows, max_len, K,
                               return_nbest=True,
                               early_exit=self.suggest_early_exit)
        # greedy takes the same fused step at kc=2 (one spare slot covers a
        # min_length-blocked EOS -- exact)
        step = make_fused_beam_step(self.model, memory, memory_mask, 2, dtype)
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
        sessions = [Session("req", self._history_queries(h)[
            -self.shapes.max_session_len:]) for h in histories]
        batch = build_session_batch(sessions, self.word_dict, self.shapes,
                                    batch_size=self._bucket(len(histories)))
        # exact at any click count: past the cap, decode from the full slate
        init = ("decode_init_full" if clicks_exceed_suggest_cap(
            batch, self.config.suggest_max_clicks) else "decode_init")
        with torch.inference_mode():
            seqs, scores = self._suggest_impl(batch.to(self.device), init)
            seqs, scores = seqs.cpu().numpy(), scores.float().cpu().numpy()
        S = self.shapes.max_session_len
        out = []
        for i, sess in enumerate(sessions):
            r = i * S + len(sess.queries) - 1
            out.append([(" ".join(self.word_dict.decode(seqs[r, k])),
                         float(scores[r, k]))
                        for k in range(min(n_best, seqs.shape[1]))])
        return out
