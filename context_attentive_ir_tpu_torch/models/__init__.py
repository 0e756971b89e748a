"""Model zoo of the port: all 14 models of the JAX package -- the rankers
ESM, DSSM, CDSSM, DUET, ARC-I, ARC-II, DRMM and Match-Tensor, the
recommenders HRED-QS, seq2seq and ACG, and the multitask models CARS,
M-NSRF and M-MatchTensor.

``task_family`` names a model type's family as the JAX package does;
``get_model_class`` / ``build_model`` return the port's class and raise
``ValueError`` for a model type the JAX zoo does not have.
"""

from __future__ import annotations

from ..config import MULTITASK, RANKERS, RECOMMENDERS, ModelConfig
from .multitask import MULTITASK_CLASSES
from .rankers import RANKER_CLASSES
from .recommenders.acg import ACG
from .recommenders.hredqs import HredQS
from .recommenders.seq2seq import Seq2seq

MODEL_CLASSES = {**RANKER_CLASSES, **MULTITASK_CLASSES, "hredqs": HredQS,
                 "seq2seq": Seq2seq, "acg": ACG}


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
    return MODEL_CLASSES[model_type]


def build_model(config: ModelConfig, device="cuda", seed: int | None = 0):
    """The port's model for ``config.model_type`` (seeded weights, or
    uninitialised with ``seed=None``)."""
    return get_model_class(config.model_type)(config, device=device,
                                              seed=seed)
