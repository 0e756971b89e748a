"""Official evaluation (validation + test), port of
``context_attentive_ir_tpu/train/evaluate.py`` for the multitask and
recommender families.

Accumulate per-query (scores, labels) -> MAP / MRR / NDCG@k; beam or greedy
decode next-query suggestions -> corpus BLEU / ROUGE-L / EM / F1; dump the
predictions to files.  Scoring and decoding run on the model's device;
batches arrive as host numpy batches and the metrics are aggregated on the
host.  The model's own parameters take the place of the JAX functions'
``params`` argument.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..data.dictionary import Dictionary
from ..data.vectorize import SessionBatch
from ..decode import beam_search, greedy_decode
from ..eval import bleu_metrics, corpus_bleu, ranking_metrics, rouge_metrics
from ..eval.rouge import rouge_l_sentence
from ..eval.text_metrics import exact_match, token_f1
from ..models import task_family
from ..models.multitask.cars import clicks_exceed_suggest_cap
from ..parallel.mesh import model_replicas, split_batch, sync_replicas


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def build_decode_fn(model, config: ModelConfig, beam_size: int = 1,
                    max_len: Optional[int] = None,
                    run: Optional["object"] = None, mesh=None):
    """Returns ``decode(batch) -> token ids [rows, T]`` (numpy) over a host
    batch, through the model's logits step as in the JAX package, given
    the model's ``decode_kwargs`` (ACG's source tokens), repeated per
    beam.

    rows = B for recommenders, B*S for multitask models (their
    ``decode_init`` flattens the session axis).  ``run`` (a RunConfig)
    supplies the beam penalty knobs; the defaults match the reference beam.
    CARS's fast ``decode_init`` is exact only up to ``suggest_max_clicks``
    clicked documents per turn; a batch beyond that goes to
    ``decode_init_full`` and ``decode.fallbacks`` counts it.
    ``decode.calls`` and ``decode.steps`` count the decodes and the decoder
    steps they ran (early exit makes the latter data-dependent).

    Under a ``mesh`` of more than one replica each replica decodes its
    contiguous shard of the batch and the rows are concatenated in order;
    the fast-or-full init is decided on the whole batch, as the JAX
    decoder decides it, and ``decode.steps`` sums the replicas' steps."""
    if mesh is not None and mesh.size > 1:
        return _sharded_decode_fn(model, config, beam_size, max_len, run,
                                  mesh)
    max_len = max_len or (config.max_query_len + 1)
    beam_kw = {}
    if run is not None:
        beam_kw = dict(alpha=run.beam_alpha,
                       length_penalty=run.beam_length_penalty,
                       coverage_beta=run.beam_coverage_beta,
                       coverage_penalty=run.beam_coverage_penalty,
                       min_length=run.min_decode_len)
    has_full = hasattr(model, "decode_init_full")
    cap = config.suggest_max_clicks

    @torch.inference_mode()
    def decode(batch, full: Optional[bool] = None):
        """``full``: the caller's choice of ``decode_init_full`` (not
        counted here); None decides and counts it on ``batch``."""
        init = model.decode_init
        if full is None:
            full = has_full and clicks_exceed_suggest_cap(batch, cap)
            decode.fallbacks += int(full)
        if full:
            init = model.decode_init_full
        batch = batch.to(_device_of(model))
        state, memory, memory_mask = init(batch)
        rows = memory.shape[0]
        decode.calls += 1
        kwargs = model.decode_kwargs(batch)

        def make_step(mem, mask, kw):
            def step(st, toks):
                decode.steps += 1
                return model.decode_step(st, toks, mem, mask, **kw)
            return step

        if beam_size > 1:
            rep = lambda t: t.repeat_interleave(beam_size, dim=0)
            step = make_step(rep(memory), rep(memory_mask),
                             {k: rep(v) for k, v in kwargs.items()})
            # early_exit: validation decodes run trained(-ish) models that
            # finish in a few steps of the budget
            seqs, _ = beam_search(step, state, rows, max_len, beam_size,
                                  cov_mask=memory_mask, early_exit=True,
                                  **beam_kw)
        else:
            seqs, _ = greedy_decode(make_step(memory, memory_mask, kwargs),
                                    state, rows, max_len,
                                    min_length=beam_kw.get("min_length", 0),
                                    early_exit=True)
        return seqs.cpu().numpy()

    decode.fallbacks = 0   # observable in tests / logs
    decode.calls = 0
    decode.steps = 0
    return decode


def _sharded_decode_fn(model, config: ModelConfig, beam_size: int,
                       max_len: Optional[int], run, mesh):
    models = model_replicas(model, mesh)
    fns = [build_decode_fn(m, config, beam_size, max_len, run)
           for m in models]
    has_full = hasattr(model, "decode_init_full")

    def decode(batch):
        full = has_full and clicks_exceed_suggest_cap(
            batch, config.suggest_max_clicks)
        decode.fallbacks += int(full)
        sync_replicas(models)
        out = np.concatenate([fn(shard, full) for fn, shard in zip(
            fns, split_batch(batch, mesh.size))])
        decode.calls += 1
        decode.steps = sum(fn.steps for fn in fns)
        return out

    decode.fallbacks = 0
    decode.calls = 0
    decode.steps = 0
    return decode


def evaluate_ranker(score_fn: Callable, batches: Iterable,
                    dump_path: str | Path | None = None) -> dict:
    """Accumulate slate scores and compute MAP/MRR/NDCG@k/P@k.
    ``score_fn(batch) -> scores`` takes a host batch."""
    all_scores, all_labels, all_cand, all_rows = [], [], [], []
    dump = open(dump_path, "w") if dump_path else None
    for batch in batches:
        scores = np.asarray(score_fn(batch), np.float32)
        if scores.ndim == 3:   # session models: [B, S, N]
            labels, cand = batch.clicks, batch.cand_mask
            rows = batch.turn_mask & batch.row_mask[:, None]
        else:                  # rankers: [B, N]
            labels, cand = batch.labels, batch.cand_mask
            rows = batch.row_mask
        all_scores.append(scores.reshape(-1, scores.shape[-1]))
        all_labels.append(labels.reshape(-1, labels.shape[-1]))
        all_cand.append(cand.reshape(-1, cand.shape[-1]))
        all_rows.append(rows.reshape(-1))
        if dump is not None:
            flat_s = all_scores[-1]
            flat_l = all_labels[-1]
            for i in np.nonzero(all_rows[-1])[0]:
                dump.write(json.dumps(
                    {"scores": flat_s[i].tolist(),
                     "labels": flat_l[i].tolist()}) + "\n")
    if dump is not None:
        dump.close()
    return ranking_metrics(np.concatenate(all_scores),
                           np.concatenate(all_labels),
                           np.concatenate(all_cand),
                           np.concatenate(all_rows))


def evaluate_suggestions(decode_fn: Callable, batches: Iterable,
                         word_dict: Dictionary,
                         dump_path: str | Path | None = None) -> dict:
    """Decode next queries and compute BLEU-1..4 / ROUGE-L / EM / F1."""
    hyps, refs = [], []
    dump = open(dump_path, "w") if dump_path else None
    for batch in batches:
        seqs = np.asarray(decode_fn(batch))
        if isinstance(batch, SessionBatch):
            B, S, Lt = batch.target_out.shape
            targets = batch.target_out.reshape(B * S, Lt)
            valid = (batch.target_mask.any(-1)
                     & batch.row_mask[:, None]).reshape(B * S)
        else:
            targets = batch.target_out
            valid = batch.row_mask
        for i in np.nonzero(valid)[0]:
            hyp = word_dict.decode(seqs[i])
            ref = word_dict.decode(targets[i])
            hyps.append(hyp)
            refs.append([ref])
            if dump is not None:
                # per-sentence scores ride along (the reference dumps
                # per-example predictions)
                sent = corpus_bleu([hyp], [[ref]], max_n=4, smooth=True)
                dump.write(json.dumps(
                    {"hypothesis": " ".join(hyp),
                     "reference": " ".join(ref),
                     "bleu-4": round(sent[3], 4),
                     "rouge-l": round(rouge_l_sentence(hyp, [ref]), 4),
                     "f1": round(token_f1([hyp], [ref]), 4)}) + "\n")
    if dump is not None:
        dump.close()
    out = bleu_metrics(hyps, refs)
    out.update(rouge_metrics(hyps, refs))
    out["em"] = exact_match(hyps, [r[0] for r in refs])
    out["f1"] = token_f1(hyps, [r[0] for r in refs])
    out["n_queries"] = float(len(hyps))
    return out


def official_eval(config: ModelConfig, batches: list,
                  word_dict: Dictionary, score_fn=None, decode_fn=None,
                  dump_prefix: str | Path | None = None) -> dict:
    """Task-appropriate metric bundle (the reference's official eval) over
    host batches; ``score_fn`` and ``decode_fn`` take a host batch and
    close over the model."""
    family = task_family(config.model_type)
    out: dict = {}
    if family in ("ranker", "multitask") and score_fn is not None:
        dump = f"{dump_prefix}.ranks.jsonl" if dump_prefix else None
        out.update(evaluate_ranker(score_fn, batches, dump))
    if family in ("recommender", "multitask") and decode_fn is not None:
        dump = f"{dump_prefix}.hyps.jsonl" if dump_prefix else None
        out.update(evaluate_suggestions(decode_fn, batches, word_dict, dump))
    return out
