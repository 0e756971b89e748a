"""Decoding: beam search, greedy, the fused-generator step and the
suggestion shortlist."""

from .beam import beam_search
from .fusedgen import (
    can_fuse_generator,
    fused_generator_table,
    make_fused_beam_step,
    make_shortlist_xla_step,
)
from .greedy import greedy_decode
from .penalties import length_wu as length_penalty  # the JAX alias
from .shortlist import build_shortlist

__all__ = ["beam_search", "greedy_decode", "length_penalty",
           "build_shortlist",
           "can_fuse_generator", "fused_generator_table",
           "make_fused_beam_step", "make_shortlist_xla_step"]
