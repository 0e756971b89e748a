"""Train state and optimizer (port of
``context_attentive_ir_tpu/train/state.py``).

The JAX package builds one optax chain: ``clip_by_global_norm`` -> (the
optimizer over trainable leaves: ``add_decayed_weights`` -> sgd / adam /
adamax, with a learning-rate schedule) and, under ``fix_embeddings``,
``set_to_zero`` for the embedding tables.  ``Optimizer`` is that chain in
PyTorch, following optax's formulas wherever they differ from
``torch.optim``'s:

- the schedule is read at the 0-based update count *before* the update, so
  with ``warmup_steps > 0`` the first update has learning rate 0; after
  warmup the decay schedule sees ``count - warmup_steps``; the exponential
  decay is staircase;
- clipping scales by ``max / |g|`` only when ``|g| >= max``, with no
  epsilon (``clip_grad_norm_`` adds 1e-6);
- weight decay is L2 added to the clipped gradient before the optimizer
  (not AdamW's decoupled decay);
- adamax keeps ``u = max(|g| + eps, b2 * u)`` and divides by it
  (``torch.optim.Adamax`` folds eps in differently);
- frozen embedding tables get no moments, no decay and no update.

Parameters live in the model and are updated in place (under
``torch.no_grad``), where the JAX step returns new arrays.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import torch
from torch import nn

from ..config import ModelConfig

# Embedding-table parameter names (ops.layers.Embeddings): frozen under
# ``fix_embeddings``.
EMBEDDING_PARAM_NAMES = ("embedding",)

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam / adamax defaults


def is_embedding_table(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in EMBEDDING_PARAM_NAMES


def make_schedule(config: ModelConfig) -> Callable[[int], float]:
    """The learning rate as a function of the 0-based update count (optax's
    ``exponential_decay(staircase=True)``, ``linear_schedule`` and
    ``join_schedules``)."""
    lr = config.learning_rate

    def base(count: int) -> float:
        if config.lr_decay_steps > 0 and config.lr_decay < 1.0 and count > 0:
            return lr * config.lr_decay ** math.floor(
                count / config.lr_decay_steps)
        return lr

    warmup = config.warmup_steps
    if warmup <= 0:
        return base

    def schedule(count: int) -> float:
        if count < warmup:
            return lr * min(max(count, 0), warmup) / warmup
        return base(count - warmup)

    return schedule


def global_norm(grads: dict[str, torch.Tensor | None],
                device=None) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (None counts as 0); 0
    on ``device`` when no parameter has a gradient."""
    sq = [g.float().pow(2).sum() for g in grads.values() if g is not None]
    if not sq:
        return torch.zeros((), device=device)
    return torch.sqrt(torch.stack(sq).sum())


class Optimizer:
    """``make_optimizer``'s chain.  ``init`` builds the optimizer state for
    a parameter dict; ``apply`` clips the gradients, updates the parameters
    and the state in place, and returns the gradients' global norm before
    clipping."""

    def __init__(self, config: ModelConfig):
        if config.optimizer not in ("sgd", "adam", "adamax"):
            raise ValueError(f"unknown optimizer {config.optimizer!r}")
        self.kind = config.optimizer
        self.clip = config.grad_clipping
        self.weight_decay = config.weight_decay
        self.momentum = config.momentum
        self.fix_embeddings = config.fix_embeddings
        self.schedule = make_schedule(config)

    def trainable(self, name: str) -> bool:
        return not (self.fix_embeddings and is_embedding_table(name))

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        """``{"count": 0, <moment>: {name: zeros}}`` over trainable
        parameters: ``trace`` for sgd, ``mu`` and ``nu`` for adam/adamax."""
        names = ("trace",) if self.kind == "sgd" else ("mu", "nu")
        return {"count": 0, **{
            k: {n: torch.zeros_like(p, memory_format=torch.preserve_format)
                for n, p in params.items() if self.trainable(n)}
            for k in names}}

    @torch.no_grad()
    def apply(self, params: dict[str, torch.Tensor],
              grads: dict[str, torch.Tensor | None],
              opt_state: dict) -> torch.Tensor:
        g_norm = global_norm(grads, next(iter(params.values())).device)
        count = opt_state["count"]
        lr = self.schedule(count)
        count_inc = count + 1
        # bias corrections in float32, as optax computes them
        bc1, bc2 = (1.0 - torch.tensor([ADAM_B1, ADAM_B2],
                                       dtype=torch.float32,
                                       device=g_norm.device) ** count_inc)
        for name, p in params.items():
            if not self.trainable(name):
                continue
            g = grads[name]
            g = torch.zeros_like(p) if g is None else g.float()
            if self.clip > 0:
                g = torch.where(g_norm < self.clip, g,
                                g / g_norm * self.clip)
            if self.weight_decay > 0:
                g = g + self.weight_decay * p
            if self.kind == "sgd":
                trace = opt_state["trace"][name]
                trace.mul_(self.momentum).add_(g)
                update = trace
            else:
                mu, nu = opt_state["mu"][name], opt_state["nu"][name]
                mu.copy_((1 - ADAM_B1) * g + ADAM_B1 * mu)
                if self.kind == "adam":
                    nu.copy_((1 - ADAM_B2) * g * g + ADAM_B2 * nu)
                    update = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
                else:
                    nu.copy_(torch.maximum(g.abs() + ADAM_EPS,
                                           ADAM_B2 * nu))
                    update = (mu / bc1) / nu
            p.add_(-lr * update)
        opt_state["count"] = count_inc
        return g_norm


def make_optimizer(config: ModelConfig) -> Optimizer:
    return Optimizer(config)


@dataclass
class TrainState:
    """The model (whose parameters are the trained weights), its optimizer
    and optimizer state, and the number of steps taken."""

    model: nn.Module
    tx: Optimizer
    opt_state: dict = field(default_factory=dict)
    step: int = 0

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def _tree(self, leaf: Callable) -> dict:
        opt = {k: ({n: leaf(t) for n, t in v.items()} if isinstance(v, dict)
                   else v) for k, v in self.opt_state.items()}
        return {"params": {n: leaf(p) for n, p in self.params.items()},
                "opt_state": opt, "step": self.step}

    def state_dict(self) -> dict:
        """Plain CPU tensors and ints (``torch.load(weights_only=True)``
        reads them back): ``{"params", "opt_state", "step"}``."""
        return self._tree(lambda t: t.detach().to("cpu", copy=True))

    def load_state_dict(self, blob: dict) -> None:
        """Copy a ``state_dict`` in; raises ValueError unless its structure
        (keys, names, shapes, dtypes) matches this state's."""
        _match("", blob, self._tree(lambda t: t))
        with torch.no_grad():
            for n, p in self.params.items():
                p.copy_(blob["params"][n])
            for k, v in self.opt_state.items():
                if isinstance(v, dict):
                    for n, t in v.items():
                        t.copy_(blob["opt_state"][k][n])
                else:
                    self.opt_state[k] = blob["opt_state"][k]
        self.step = int(blob["step"])


def _match(path: str, got, want) -> None:
    """Raise ValueError naming the first place ``got`` differs in
    structure from ``want``."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            have = sorted(got) if isinstance(got, dict) else type(got).__name__
            raise ValueError(f"{path or 'state'}: keys {have} != "
                             f"{sorted(want)}")
        for k in want:
            _match(f"{path}.{k}" if path else str(k), got[k], want[k])
    elif isinstance(want, torch.Tensor):
        if (not isinstance(got, torch.Tensor) or got.shape != want.shape
                or got.dtype != want.dtype):
            desc = ((tuple(got.shape), got.dtype)
                    if isinstance(got, torch.Tensor) else type(got).__name__)
            raise ValueError(f"{path}: {desc} != "
                             f"{(tuple(want.shape), want.dtype)}")
    elif not isinstance(got, type(want)):
        raise ValueError(f"{path}: {type(got).__name__} != "
                         f"{type(want).__name__}")


def create_train_state(model: nn.Module, config: ModelConfig) -> TrainState:
    """A fresh state over ``model``'s current weights (the JAX
    ``create_train_state`` also initialises the weights; the port's models
    are built with theirs, ``models.build_model(config, device, seed)``)."""
    tx = make_optimizer(config)
    return TrainState(model, tx, tx.init(dict(model.named_parameters())))


def param_count(state: TrainState) -> int:
    return sum(p.numel() for p in state.params.values())
