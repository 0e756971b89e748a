"""Model zoo of the port: CARS (multitask) and HRED-QS (recommender).

``task_family`` names a model type's family as the JAX package does;
``get_model_class`` / ``build_model`` return the port's class for a ported
model type and raise ``NotImplementedError`` for a model of the JAX zoo
that is not ported yet.
"""

from __future__ import annotations

from ..config import MULTITASK, RANKERS, RECOMMENDERS, ModelConfig
from .multitask.cars import CARS
from .recommenders.hredqs import HredQS

MODEL_CLASSES = {"cars": CARS, "hredqs": HredQS}


def task_family(model_type: str) -> str:
    """'ranker' | 'recommender' | 'multitask' -- selects the batch family
    and the loss."""
    if model_type in RANKERS:
        return "ranker"
    if model_type in RECOMMENDERS:
        return "recommender"
    if model_type in MULTITASK:
        return "multitask"
    raise ValueError(f"unknown model_type {model_type!r}")


def get_model_class(model_type: str):
    task_family(model_type)   # raises on an unknown model type
    if model_type not in MODEL_CLASSES:
        raise NotImplementedError(
            f"{model_type} is not ported; the port has "
            f"{sorted(MODEL_CLASSES)}")
    return MODEL_CLASSES[model_type]


def build_model(config: ModelConfig, device="cuda", seed: int | None = 0):
    """The port's model for ``config.model_type`` (seeded weights, or
    uninitialised with ``seed=None``)."""
    return get_model_class(config.model_type)(config, device=device,
                                              seed=seed)
