"""The ranker zoo of the port (``context_attentive_ir_tpu/models/rankers``):
session-blind models that score a ``RankBatch``'s slates, ``[B, N]``."""

from .arc import ARCI, ARCII
from .cdssm import CDSSM
from .drmm import DRMM
from .dssm import DSSM
from .duet import DUET
from .esm import ESM
from .match_tensor import MatchTensor

RANKER_CLASSES = {
    "esm": ESM,
    "dssm": DSSM,
    "cdssm": CDSSM,
    "duet": DUET,
    "arci": ARCI,
    "arcii": ARCII,
    "drmm": DRMM,
    "match_tensor": MatchTensor,
}

__all__ = ["ESM", "DSSM", "CDSSM", "DUET", "ARCI", "ARCII", "DRMM",
           "MatchTensor", "RANKER_CLASSES"]
