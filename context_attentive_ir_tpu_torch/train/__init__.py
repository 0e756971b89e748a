"""Training: train state and optimizer, train/eval steps, checkpoints."""

from .checkpoint import Checkpointer
from .state import (
    TrainState,
    create_train_state,
    make_optimizer,
    param_count,
)
from .steps import (
    make_eval_loss_step,
    make_loss_fn,
    make_score_step,
    make_train_step,
)

__all__ = [
    "Checkpointer", "TrainState", "create_train_state", "make_optimizer",
    "param_count", "make_eval_loss_step", "make_loss_fn", "make_score_step",
    "make_train_step",
]
