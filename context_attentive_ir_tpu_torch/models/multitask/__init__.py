"""Multitask models of the port: CARS, M-NSRF and M-MatchTensor."""

from .cars import CARS
from .m_match_tensor import MMatchTensor
from .mnsrf import MNSRF

MULTITASK_CLASSES = {
    "mnsrf": MNSRF,
    "m_match_tensor": MMatchTensor,
    "cars": CARS,
}

__all__ = ["CARS", "MMatchTensor", "MNSRF", "MULTITASK_CLASSES"]
