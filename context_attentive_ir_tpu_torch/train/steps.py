"""Train and eval steps (port of ``context_attentive_ir_tpu/train/steps.py``
for all three families: the rankers, the recommenders and the multitask
models).

The JAX package jit-compiles one function per step; the port runs the same
forward, loss, backward and optimizer update eagerly.  A step's dropout
noise comes from a ``torch.Generator`` seeded from ``(seed, state.step)``
(``dropout_generator``), the counterpart of ``fold_in(rng, step)``: a
resumed run draws the same masks as an uninterrupted one.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..models import task_family
from ..models.losses import rank_loss, sequence_nll_loss
from .state import TrainState

_MASK64 = (1 << 64) - 1


def _splitmix64(v: int) -> int:
    v = (v + 0x9E3779B97F4A7C15) & _MASK64
    v = ((v ^ (v >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    v = ((v ^ (v >> 27)) * 0x94D049BB133111EB) & _MASK64
    return v ^ (v >> 31)


def dropout_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on ``device`` whose stream depends only on
    ``(seed, step)``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_splitmix64(_splitmix64(seed) ^ step) >> 1)
    return gen


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
    family = task_family(config.model_type)

    def loss_fn(batch, deterministic: bool = False,
                generator: torch.Generator | None = None):
        out = model(batch, deterministic, generator)
        if family == "ranker":
            loss = rank_loss(config.loss_type, out, batch.labels,
                             batch.cand_mask, batch.row_mask, config.margin)
            metrics = {"rank_loss": loss}
        elif family == "recommender":
            tmask = batch.target_mask & batch.row_mask[:, None]
            loss = model.target_nll(out, batch.target_out, tmask)
            metrics = {"gen_loss": loss,
                       "ppl": torch.exp(torch.clamp(loss, max=20.0))}
        else:
            rmask = batch.turn_mask & batch.row_mask[:, None]
            l_rank = rank_loss(config.loss_type, out["scores"], batch.clicks,
                               batch.cand_mask, rmask, config.margin)
            tmask = batch.target_mask & batch.row_mask[:, None, None]
            l_gen = sequence_nll_loss(out["gen_logits"], batch.target_out,
                                      tmask)
            loss = l_rank + config.alpha * l_gen
            metrics = {"rank_loss": l_rank, "gen_loss": l_gen}
        if config.regularize_coeff > 0:
            l2 = 0.5 * sum(p.pow(2).sum() for p in model.parameters())
            loss = loss + config.regularize_coeff * l2
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def make_train_step(model, config: ModelConfig):
    """``step(state, batch, seed) -> (state, metrics)``: forward with
    dropout, loss, backward, then the optimizer updates ``state``'s
    parameters and optimizer state in place and ``state.step`` advances.
    ``seed`` takes the place of the JAX step's ``rng``.  Metrics (detached
    0-d tensors): ``make_loss_fn``'s and ``grad_norm`` (before
    clipping).  A loss that reaches no trainable parameter (ESM under its
    published ``fix_embeddings``: the table is its only leaf, and frozen)
    has no gradient; the step still counts, reports its metrics and a
    ``grad_norm`` of 0, and moves nothing, as the JAX step does."""
    loss_fn = make_loss_fn(model, config)

    def train_step(state: TrainState, batch, seed: int):
        if state.model is not model:
            raise ValueError("the train state wraps another model")
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


def make_score_step(model, config: ModelConfig):
    """``score_step(batch) -> scores`` (eval mode, ``model.score``): ``[B,
    N]`` of a ranker, ``[B, S, N]`` of a multitask model.  The model's own
    parameters take the place of the JAX step's ``params``."""
    if task_family(config.model_type) == "recommender":
        raise NotImplementedError(
            f"{config.model_type} is a recommender: only the rankers and the "
            "multitask models (CARS, M-NSRF, M-MatchTensor) score slates")

    def score_step(batch):
        return model.score(batch)

    return score_step


def make_eval_loss_step(model, config: ModelConfig):
    """``eval_step(batch) -> metrics`` with dropout off and no gradient
    (validation loss), with the model's own parameters."""
    loss_fn = make_loss_fn(model, config)

    @torch.no_grad()
    def eval_step(batch):
        _, metrics = loss_fn(batch, deterministic=True)
        return metrics

    return eval_step
