"""Recommender family of the port: seq2seq, HRED-QS and ACG."""

from .acg import ACG
from .hredqs import HredQS
from .seq2seq import Seq2seq

RECOMMENDER_CLASSES = {
    "seq2seq": Seq2seq,
    "hredqs": HredQS,
    "acg": ACG,
}

__all__ = ["ACG", "HredQS", "Seq2seq", "RECOMMENDER_CLASSES"]
