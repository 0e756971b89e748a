"""Decoding: beam search, greedy, and the fused-generator step."""

from .beam import beam_search
from .fusedgen import fused_generator_table, make_fused_beam_step
from .greedy import greedy_decode

__all__ = ["beam_search", "greedy_decode", "fused_generator_table",
           "make_fused_beam_step"]
