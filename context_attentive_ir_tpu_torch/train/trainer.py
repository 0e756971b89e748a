"""The training engine: epoch loop, validation, early stopping, resume.

Port of ``context_attentive_ir_tpu/train/trainer.py`` for the three
families (rankers, recommenders, multitask models): seed, init-or-resume
the model, epoch loop with
``AverageMeter`` / ``Timer`` and ``display_iter`` logging, per-epoch
official validation, early stopping on ``valid_metric``, best / latest
checkpoints, final test evaluation with prediction dumps.

The hot loop is host collate (on the prefetch thread) -> ``batch.to(device)``
(or ``shard_batch`` under a mesh) -> one eager ``train_step``; metrics and
checkpoint IO stay off the device path.  Data order is deterministic and
resumable (epoch-boundary checkpoints and seeded per-epoch shuffles).

``use_mesh=True`` (the JAX default) trains data-parallel over a
``('data',)`` mesh (``parallel.mesh``): on ``device="cuda"`` every visible
card, on the CPU or a named device (``"cuda:1"``) one replica, which runs
exactly the unsharded step.  ``mesh=`` takes a mesh of the caller's
(``make_mesh(["cpu"] * 8)``).  The batch shards on its leading axis,
validation and test shard the dev batches, and the checkpoints hold the
primary replica's state, so run directories, ``--resume`` and
``--pretrained_path`` do not depend on the mesh.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..config import ModelConfig, RunConfig
from ..data import (
    BatchIterator,
    BucketedIterator,
    Dictionary,
    PackedBucketedIterator,
    PackedIterator,
    Session,
    build_rank_batch,
    build_session_batch,
    build_suggest_batch,
    prefetch,
    rank_examples,
    shapes_from_config,
    suggest_examples,
)
from ..device import resolve_device
from ..models import build_model, task_family
from ..parallel.mesh import Mesh, make_mesh, shard_batch
from ..utils import AverageMeter, MetricsWriter, Timer, format_table
from .checkpoint import Checkpointer
from .evaluate import build_decode_fn, official_eval
from .state import TrainState, create_train_state, param_count
from .steps import make_score_step, make_train_step

logger = logging.getLogger(__name__)


def make_iterator(sessions: list[Session], config: ModelConfig,
                  word_dict: Dictionary, batch_size: int,
                  shuffle: bool, seed: int, fast=None,
                  session_buckets: tuple[int, ...] = (),
                  pack: bool = False):
    """The batch stream of ``config``'s family: (query, slate) rows for a
    ranker, whole sessions for the multitask family, (context, next query)
    pairs for a recommender.

    ``fast``: a ``data.fast.FastVocab`` through which the ranker and
    session vectorizers encode natively (the same batches).

    ``pack=True`` vectorizes the whole example list once and serves batches
    as row gathers (``data.pipeline.PackedIterator``, a bit-identical batch
    stream); bucketed multitask iteration packs one superbatch per bucket
    (``PackedBucketedIterator``).
    """
    family = task_family(config.model_type)
    shapes = shapes_from_config(config)
    if family == "ranker":
        ex = rank_examples(sessions)
        collate = lambda e, batch_size=batch_size: build_rank_batch(
            e, word_dict, shapes, batch_size=batch_size, fast=fast)
    elif family == "recommender":
        ex = suggest_examples(sessions)
        collate = lambda e, batch_size=batch_size: build_suggest_batch(
            e, word_dict, shapes, batch_size=batch_size)
    else:
        ex = sessions
        if session_buckets:
            buckets = tuple(min(b, shapes.max_session_len)
                            for b in session_buckets)

            def collate_b(e, bucket, batch_size=batch_size):
                sh = dataclasses.replace(shapes, max_session_len=bucket)
                return build_session_batch(e, word_dict, sh,
                                           batch_size=batch_size, fast=fast)

            if pack and ex:
                it = PackedBucketedIterator(
                    ex, lambda s: len(s.queries), collate_b, batch_size,
                    buckets, shuffle=shuffle, seed=seed)
                logger.info("packed %d sessions into %.1f MB across %d "
                            "buckets", len(ex), it.nbytes / 2**20,
                            len(it._packs))
                return it
            return BucketedIterator(ex, lambda s: len(s.queries),
                                    collate_b, batch_size, buckets,
                                    shuffle=shuffle, seed=seed)
        collate = lambda e, batch_size=batch_size: build_session_batch(
            e, word_dict, shapes, batch_size=batch_size, fast=fast)
    if pack and ex:
        it = PackedIterator(ex, collate, batch_size, shuffle=shuffle,
                            seed=seed)
        logger.info("packed %d examples into %.1f MB (one-time collate)",
                    len(ex), it.nbytes / 2**20)
        return it
    return BatchIterator(ex, collate, batch_size, shuffle=shuffle, seed=seed)


def _check_run(run: RunConfig) -> None:
    """Raise for a runtime flag the port cannot honour yet."""
    if run.checkpoint_backend != "msgpack":
        raise NotImplementedError(
            f"checkpoint_backend={run.checkpoint_backend!r}: the port "
            "reads and writes the JAX package's single-file state "
            "(state.msgpack); orbax's per-array directories are a ROADMAP "
            "item")


class Trainer:
    """Owns model + state + steps + checkpointing for one run.
    ``device`` defaults to the card; pass ``device="cpu"`` to train on the
    CPU.  ``use_mesh`` / ``mesh``: the module docstring."""

    def __init__(self, config: ModelConfig, run: RunConfig,
                 word_dict: Dictionary,
                 pretrained: Optional[np.ndarray] = None, device="cuda",
                 use_mesh: bool = True, mesh: Optional[Mesh] = None):
        _check_run(run)
        if mesh is None and use_mesh:
            dev = resolve_device(device)
            mesh = make_mesh(None if dev == torch.device("cuda")
                             else [dev])
        self.mesh = mesh
        if mesh is not None and run.batch_size % mesh.size != 0:
            raise ValueError(
                f"batch_size {run.batch_size} not divisible by mesh size "
                f"{mesh.size}")
        self.device = (mesh.primary if mesh is not None
                       else resolve_device(device))
        if config.vocab_size == 0:
            config = config.replace(vocab_size=len(word_dict))
        self.config = config
        self.run = run
        self.word_dict = word_dict
        self.pretrained = pretrained
        self.model = build_model(config, device=self.device, seed=run.seed)
        self.train_step = make_train_step(self.model, config, mesh)
        family = task_family(config.model_type)
        self.score_fn = self.decode_fn = None
        if family in ("ranker", "multitask"):
            score = make_score_step(self.model, config, mesh)
            self.score_fn = lambda batch: score(
                self._put(batch)).float().cpu().numpy()
        if family in ("recommender", "multitask"):
            self.decode_fn = build_decode_fn(
                self.model, config, run.beam_size,
                run.max_decode_len or None, run=run, mesh=mesh)
        self.ckpt = Checkpointer(run.model_dir, run.model_name,
                                 run.async_checkpoint)
        self.metrics = MetricsWriter(
            Path(run.model_dir) / f"{run.model_name}.metrics.jsonl",
            tensorboard=run.tensorboard)
        self.state: Optional[TrainState] = None
        self.start_epoch = 0
        self.best_valid = -np.inf
        self.fast = None
        if run.native_vectorizer:
            # when buildable: without g++ the Python vectorizer builds the
            # same batches
            from ..data.fast import FastVocab, available

            if available():
                self.fast = FastVocab(word_dict)
                logger.info("native fastvec vectorizer enabled")
            else:
                logger.info("native fastvec unavailable: the Python "
                            "vectorizer runs")

    def _put(self, batch):
        """A host batch on the device, or sharded over a mesh of more than
        one replica."""
        if self.mesh is not None and self.mesh.size > 1:
            return shard_batch(batch, self.mesh)
        return batch.to(self.device)

    # -- state setup ---------------------------------------------------------

    def init_state(self, example_batch=None):
        """A fresh train state over the model's seeded weights, then the
        optional warm start and resume.  ``example_batch`` is unused (the
        JAX package traces its model on it)."""
        del example_batch
        if self.pretrained is not None:
            with torch.no_grad():
                self.model.embeddings.embedding.copy_(
                    torch.from_numpy(np.asarray(self.pretrained,
                                                np.float32)))
        self.state = create_train_state(self.model, self.config)
        logger.info("Initialized %s with %.2fM parameters",
                    self.config.model_type, param_count(self.state) / 1e6)
        if self.run.pretrained_path:
            # warm start: weights only (reference --pretrained)
            blob = Checkpointer.read_state(self.run.pretrained_path)
            self.model.load_state_dict(blob["params"])
            logger.info("Warm-started from %s", self.run.pretrained_path)
        if (self.run.resume and
                Checkpointer.resolve(self.ckpt.latest_path).exists()):
            _, _, extra = Checkpointer.peek(self.ckpt.latest_path)
            self.state = Checkpointer.load(self.ckpt.latest_path, self.state)
            self.start_epoch = int(extra.get("epoch", -1)) + 1
            self.best_valid = float(extra.get("best_valid", -np.inf))
            logger.info("Resumed from %s at epoch %d",
                        self.ckpt.latest_path, self.start_epoch)

    # -- training ------------------------------------------------------------

    def fit(self, train_sessions: list[Session],
            dev_sessions: list[Session]) -> dict:
        run, config = self.run, self.config
        train_it = make_iterator(train_sessions, config, self.word_dict,
                                 run.batch_size, shuffle=True, seed=run.seed,
                                 fast=self.fast,
                                 session_buckets=run.session_buckets,
                                 pack=run.pack_cache)
        dev_batches = list(make_iterator(
            dev_sessions, config, self.word_dict, run.test_batch_size,
            shuffle=False, seed=0, fast=self.fast))
        if self.state is None:
            self.init_state()

        no_improve = 0
        history = []
        for epoch in range(self.start_epoch, run.num_epochs):
            loss_meter, timer = AverageMeter(), Timer()
            m = None
            # prefetch: host-collate batch t+1..t+depth while the device
            # runs batch t
            for i, batch in enumerate(prefetch(train_it.epoch(epoch),
                                               run.prefetch_batches)):
                self.state, m = self.train_step(
                    self.state, self._put(batch), run.seed)
                # reading the loss forces a device sync; sample it at
                # display intervals so the host runs ahead of the device
                sampled = (i + 1) % run.display_iter == 0
                if sampled:
                    loss_meter.update(float(m["loss"]))
                    logger.info(
                        "epoch %d iter %d/%d loss %.4f (avg %.4f) %.1fs",
                        epoch, i + 1, len(train_it), loss_meter.val,
                        loss_meter.avg, timer.time())
            # fold in the final batch unless the display interval just did
            if m is not None and not sampled:
                loss_meter.update(float(m["loss"]))
            valid = self.validate(dev_batches)
            self.metrics.write("epoch", step=epoch, epoch=epoch,
                               train_loss=loss_meter.avg,
                               time=timer.time(), **valid)
            metric_val = valid.get(run.valid_metric, 0.0)
            history.append({"epoch": epoch, "train_loss": loss_meter.avg,
                            **valid})
            logger.info("epoch %d done: train_loss=%.4f %s=%.4f (best %.4f)",
                        epoch, loss_meter.avg, run.valid_metric, metric_val,
                        max(self.best_valid, metric_val))
            extra = {"epoch": epoch, "best_valid": float(
                max(self.best_valid, metric_val))}
            self.ckpt.save_latest(self.state, config, self.word_dict, extra)
            if metric_val > self.best_valid:
                self.best_valid = metric_val
                no_improve = 0
                self.ckpt.save_best(self.state, config, self.word_dict,
                                    extra)
            else:
                no_improve += 1
                if no_improve >= run.early_stop:
                    logger.info("Early stopping at epoch %d", epoch)
                    break
        self.ckpt.wait()
        logger.info("\n%s", format_table(history, "training history"))
        return {"best_valid": self.best_valid, "history": history}

    # -- evaluation ----------------------------------------------------------

    def validate(self, dev_batches: list, dump_prefix=None) -> dict:
        return official_eval(self.config, dev_batches, self.word_dict,
                             score_fn=self.score_fn,
                             decode_fn=self.decode_fn,
                             dump_prefix=dump_prefix)

    def test(self, test_sessions: list[Session],
             from_best: bool = True, dump_prefix=None) -> dict:
        """Final official test eval, from the best checkpoint when there
        is one."""
        if from_best and Checkpointer.resolve(self.ckpt.best_path).exists():
            self.ckpt.wait()
            if self.state is None:
                self.init_state()
            self.state = Checkpointer.load(self.ckpt.best_path, self.state)
        batches = list(make_iterator(
            test_sessions, self.config, self.word_dict,
            self.run.test_batch_size, shuffle=False, seed=0, fast=self.fast))
        out = self.validate(batches, dump_prefix=dump_prefix)
        logger.info("\n%s", format_table([out], "test results"))
        self.metrics.write("test", **out)
        return out
