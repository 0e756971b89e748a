"""Training: train state and optimizer, train/eval steps, checkpoints, the
official evaluation and the ``Trainer``."""

from .checkpoint import Checkpointer
from .evaluate import (
    build_decode_fn,
    evaluate_ranker,
    evaluate_suggestions,
    official_eval,
)
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
from .trainer import Trainer, make_iterator, shapes_from_config

__all__ = [
    "Checkpointer", "TrainState", "create_train_state", "make_optimizer",
    "param_count", "make_eval_loss_step", "make_loss_fn", "make_score_step",
    "make_train_step", "Trainer", "make_iterator", "shapes_from_config",
    "build_decode_fn",
    "evaluate_ranker", "evaluate_suggestions", "official_eval",
]
