"""Train and eval steps (port of ``context_attentive_ir_tpu/train/steps.py``
for all three families: the rankers, the recommenders and the multitask
models).

The JAX package jit-compiles one function per step; the port runs the same
forward, loss, backward and optimizer update eagerly.  A step's dropout
noise comes from a ``torch.Generator`` seeded from ``(seed, state.step)``
(``dropout_generator``), the counterpart of ``fold_in(rng, step)``: a
resumed run draws the same masks as an uninterrupted one.

``mesh`` (``parallel.make_mesh``) makes a step data-parallel, as the JAX
step is under its ``('data',)`` mesh.  Each replica holds a copy of the
model; a step copies the primary's parameters into the others, runs each
shard's forward (and backward) on its replica, sums the gradients onto the
primary in replica order and applies the optimizer once there, so
``grad_norm`` and clipping see the whole batch's gradient.  Every loss is a
ratio of sums, so averaging per-shard losses would weigh a shard by its
share of rows, not of valid rows or tokens: each shard's loss is scaled by
its share of the batch's denominator (``rank_loss_count`` / ``token_count``,
read from masks and labels before any forward), which gives the whole
batch's loss and gradient, as the JAX SPMD step computes them.  The
``regularize_coeff`` term is added once, on the primary.  Replica 0 draws
today's dropout stream, replica ``r`` one seeded from ``(seed, step, r)``.
A one-replica mesh runs the unsharded step itself.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..models import task_family
from ..models.losses import (
    rank_loss,
    rank_loss_count,
    sequence_nll_loss,
    token_count,
)
from ..parallel.mesh import (
    Mesh,
    gather,
    model_replicas,
    reduce_grads,
    shard_batch,
    sync_replicas,
)
from .state import TrainState

_MASK64 = (1 << 64) - 1


def _splitmix64(v: int) -> int:
    v = (v + 0x9E3779B97F4A7C15) & _MASK64
    v = ((v ^ (v >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    v = ((v ^ (v >> 27)) * 0x94D049BB133111EB) & _MASK64
    return v ^ (v >> 31)


def dropout_generator(seed: int, step: int, device,
                      replica: int = 0) -> torch.Generator:
    """A generator on ``device`` whose stream depends only on
    ``(seed, step)``, and on ``replica`` for a replica other than the
    primary."""
    v = _splitmix64(_splitmix64(seed) ^ step)
    if replica:
        v = _splitmix64(v ^ replica)
    gen = torch.Generator(device=device)
    gen.manual_seed(v >> 1)
    return gen


def _loss_parts(model, config: ModelConfig):
    """``parts(batch, deterministic, generator) -> {"rank_loss" |
    "gen_loss": loss}``: each loss term of ``config``'s family, before
    they are combined."""
    family = task_family(config.model_type)

    def parts(batch, deterministic: bool = False,
              generator: torch.Generator | None = None):
        out = model(batch, deterministic, generator)
        if family == "ranker":
            return {"rank_loss": rank_loss(
                config.loss_type, out, batch.labels, batch.cand_mask,
                batch.row_mask, config.margin)}
        if family == "recommender":
            tmask = batch.target_mask & batch.row_mask[:, None]
            return {"gen_loss": model.target_nll(out, batch.target_out,
                                                 tmask)}
        rmask = batch.turn_mask & batch.row_mask[:, None]
        tmask = batch.target_mask & batch.row_mask[:, None, None]
        return {"rank_loss": rank_loss(config.loss_type, out["scores"],
                                       batch.clicks, batch.cand_mask, rmask,
                                       config.margin),
                "gen_loss": sequence_nll_loss(out["gen_logits"],
                                              batch.target_out, tmask)}

    return parts


def _part_counts(config: ModelConfig, batch) -> dict:
    """The denominator of each of ``_loss_parts``' terms on ``batch``."""
    family = task_family(config.model_type)
    if family == "ranker":
        return {"rank_loss": rank_loss_count(
            config.loss_type, batch.labels, batch.cand_mask, batch.row_mask)}
    if family == "recommender":
        return {"gen_loss": token_count(batch.target_mask
                                        & batch.row_mask[:, None])}
    return {"rank_loss": rank_loss_count(
                config.loss_type, batch.clicks, batch.cand_mask,
                batch.turn_mask & batch.row_mask[:, None]),
            "gen_loss": token_count(batch.target_mask
                                    & batch.row_mask[:, None, None])}


def _l2(model) -> torch.Tensor:
    return 0.5 * sum(p.pow(2).sum() for p in model.parameters())


def _objective(config: ModelConfig, parts: dict, l2=None):
    """(loss, metrics) from ``_loss_parts``' terms: ``rank_loss + alpha *
    gen_loss`` for the multitask family, the one term otherwise (with
    ``ppl = exp(min(gen_loss, 20))`` for a recommender), plus
    ``regularize_coeff * l2`` when ``l2`` is given."""
    if "rank_loss" in parts and "gen_loss" in parts:
        loss = parts["rank_loss"] + config.alpha * parts["gen_loss"]
        metrics = {"rank_loss": parts["rank_loss"],
                   "gen_loss": parts["gen_loss"]}
    elif "rank_loss" in parts:
        loss = parts["rank_loss"]
        metrics = {"rank_loss": loss}
    else:
        loss = parts["gen_loss"]
        metrics = {"gen_loss": loss,
                   "ppl": torch.exp(torch.clamp(loss, max=20.0))}
    if l2 is not None:
        loss = loss + config.regularize_coeff * l2
    metrics["loss"] = loss
    return loss, metrics


def make_loss_fn(model, config: ModelConfig):
    """``loss_fn(batch, deterministic=False, generator=None) -> (loss,
    metrics)`` with the model's current parameters: for the multitask
    family ``rank_loss + alpha * gen_loss`` (metrics ``rank_loss``,
    ``gen_loss``), for a ranker ``rank_loss`` over its ``[B, N]`` scores
    and ``labels`` (metric ``rank_loss``), for a recommender the target NLL
    (``gen_loss`` and
    ``ppl = exp(min(loss, 20))``, through the model's ``target_nll``:
    ``copy_generator_nll_loss`` for ACG, whose forward returns the copy
    mixture's probabilities); plus the
    ``regularize_coeff`` L2 term."""
    parts = _loss_parts(model, config)

    def loss_fn(batch, deterministic: bool = False,
                generator: torch.Generator | None = None):
        terms = parts(batch, deterministic, generator)
        l2 = _l2(model) if config.regularize_coeff > 0 else None
        return _objective(config, terms, l2)

    return loss_fn


def _sharded_loss(models, config: ModelConfig, mesh: Mesh):
    """``run(shards, deterministic, generators, backward) -> metrics`` of
    the whole batch over per-replica shards: each replica's terms scaled
    by its share of the batch's denominators (and, with ``backward``,
    back-propagated on that replica before the next one runs), the scaled
    terms summed on the primary in replica order."""
    parts_fns = [_loss_parts(m, config) for m in models]
    coef = {"rank_loss": 1.0,
            "gen_loss": (config.alpha
                         if task_family(config.model_type) == "multitask"
                         else 1.0)}

    def run(shards, deterministic: bool, generators, backward: bool):
        counts = [_part_counts(config, s) for s in shards]
        totals = {k: sum(c[k].to(mesh.primary) for c in counts)
                  .clamp_min(1.0) for k in counts[0]}
        summed = {}
        l2 = None
        for r, (fn, shard) in enumerate(zip(parts_fns, shards)):
            terms = fn(shard, deterministic, generators[r])
            scaled = {}
            for k, v in terms.items():
                w = counts[r][k].clamp_min(1.0) / totals[k].to(v.device)
                scaled[k] = v * w.to(v.dtype)
            if backward:
                loss = sum(coef[k] * v for k, v in scaled.items())
                if r == 0 and config.regularize_coeff > 0:
                    l2 = _l2(models[0])
                    loss = loss + config.regularize_coeff * l2
                if loss.requires_grad:
                    loss.backward()
            for k, v in scaled.items():
                v = v.detach().to(mesh.primary)
                summed[k] = v if k not in summed else summed[k] + v
        if config.regularize_coeff > 0 and l2 is None:
            l2 = _l2(models[0])
        _, metrics = _objective(config, summed,
                                None if l2 is None else l2.detach())
        return metrics

    return run


def _unsharded(mesh: Mesh | None) -> bool:
    return mesh is None or mesh.size == 1


def _single(batch):
    """A one-replica mesh's batch: the one shard of ``shard_batch``'s list,
    or the batch itself."""
    if isinstance(batch, (list, tuple)):
        (batch,) = batch
    return batch


def _shards(batch, mesh: Mesh) -> list:
    return (list(batch) if isinstance(batch, (list, tuple))
            else shard_batch(batch, mesh))


def make_train_step(model, config: ModelConfig, mesh: Mesh | None = None):
    """``step(state, batch, seed) -> (state, metrics)``: forward with
    dropout, loss, backward, then the optimizer updates ``state``'s
    parameters and optimizer state in place and ``state.step`` advances.
    ``seed`` takes the place of the JAX step's ``rng``.  Metrics (detached
    0-d tensors): ``make_loss_fn``'s and ``grad_norm`` (before
    clipping).  A loss that reaches no trainable parameter (ESM under its
    published ``fix_embeddings``: the table is its only leaf, and frozen)
    has no gradient; the step still counts, reports its metrics and a
    ``grad_norm`` of 0, and moves nothing, as the JAX step does.

    Under a ``mesh`` of more than one replica, ``batch`` is a host batch
    (sharded here) or ``shard_batch``'s list, and the step is
    data-parallel (module docstring); ``model`` is the primary replica and
    must lie on the mesh's primary device."""
    if _unsharded(mesh):
        return _single_train_step(model, config)
    models = model_replicas(model, mesh)
    run = _sharded_loss(models, config, mesh)

    def train_step(state: TrainState, batch, seed: int):
        if state.model is not model:
            raise ValueError("the train state wraps another model")
        shards = _shards(batch, mesh)
        sync_replicas(models)
        named = [dict(m.named_parameters()) for m in models]
        for params in named:
            for p in params.values():
                p.grad = None
        gens = [dropout_generator(seed, state.step, d, r)
                for r, d in enumerate(mesh.devices)]
        metrics = run(shards, False, gens, backward=True)
        grads = reduce_grads([{n: p.grad for n, p in params.items()}
                              for params in named], mesh)
        metrics["grad_norm"] = state.tx.apply(named[0], grads,
                                              state.opt_state)
        for params in named:
            for p in params.values():
                p.grad = None
        state.step += 1
        return state, metrics

    return train_step


def _single_train_step(model, config: ModelConfig):
    loss_fn = make_loss_fn(model, config)

    def train_step(state: TrainState, batch, seed: int):
        if state.model is not model:
            raise ValueError("the train state wraps another model")
        batch = _single(batch)
        gen = dropout_generator(seed, state.step,
                                next(model.parameters()).device)
        params = state.params
        for p in params.values():
            p.grad = None
        _, metrics = loss_fn(batch, False, gen)
        if metrics["loss"].requires_grad:
            metrics["loss"].backward()
        grads = {n: p.grad for n, p in params.items()}
        metrics["grad_norm"] = state.tx.apply(params, grads, state.opt_state)
        for p in params.values():
            p.grad = None
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_score_step(model, config: ModelConfig, mesh: Mesh | None = None):
    """``score_step(batch) -> scores`` (eval mode, ``model.score``): ``[B,
    N]`` of a ranker, ``[B, S, N]`` of a multitask model.  The model's own
    parameters take the place of the JAX step's ``params``.  Under a mesh
    each replica scores its shard and the scores are gathered in order on
    the primary."""
    if task_family(config.model_type) == "recommender":
        raise NotImplementedError(
            f"{config.model_type} is a recommender: only the rankers and the "
            "multitask models (CARS, M-NSRF, M-MatchTensor) score slates")
    if _unsharded(mesh):
        def score_step(batch):
            return model.score(_single(batch))

        return score_step
    models = model_replicas(model, mesh)

    def sharded_score_step(batch):
        shards = _shards(batch, mesh)
        sync_replicas(models)
        return gather([m.score(s) for m, s in zip(models, shards)], mesh)

    return sharded_score_step


def make_eval_loss_step(model, config: ModelConfig,
                        mesh: Mesh | None = None):
    """``eval_step(batch) -> metrics`` with dropout off and no gradient
    (validation loss), with the model's own parameters; under a mesh the
    whole batch's metrics, on the primary."""
    if _unsharded(mesh):
        loss_fn = make_loss_fn(model, config)

        @torch.no_grad()
        def eval_step(batch):
            _, metrics = loss_fn(_single(batch), deterministic=True)
            return metrics

        return eval_step
    models = model_replicas(model, mesh)
    run = _sharded_loss(models, config, mesh)

    @torch.no_grad()
    def sharded_eval_step(batch):
        shards = _shards(batch, mesh)
        sync_replicas(models)
        return run(shards, True, [None] * mesh.size, backward=False)

    return sharded_eval_step
