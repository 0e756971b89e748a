"""Fused-generator step construction (port of the float-table path of
``context_attentive_ir_tpu/decode/fusedgen.py``).

Bridges a model's ``decode_step_fused`` (tie projection, no logits matmul)
and the fused generator kernel (``ops/kernels/beamgen.py``) into the
``(state, (vals, idx, lse))`` step contract of ``beam_search`` and
``greedy_decode``.  The shortlist, pipelined, pruned and int8-table modes
are not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.kernels.beamgen import generator_topk_lse


def fused_generator_table(model, dtype: torch.dtype) -> torch.Tensor:
    """The tied table transposed, ``[E, V]`` contiguous in ``dtype``."""
    return model.embeddings.embedding.detach().to(dtype).t().contiguous()


def make_fused_beam_step(model, memory: torch.Tensor,
                         memory_mask: torch.Tensor, kc: int,
                         dtype: torch.dtype) -> Callable:
    """``(state, tokens) -> (state, (vals, idx, lse))``.  ``memory`` and
    ``memory_mask`` must already be beam-tiled.  The transposed table is
    built once here and reused by every step."""
    table_t = fused_generator_table(model, dtype)

    def step(state, tokens):
        state, proj, _ = model.decode_step_fused(state, tokens, memory,
                                                 memory_mask)
        out = generator_topk_lse(proj.to(dtype).contiguous(), table_t, kc,
                                 device=proj.device)
        return state, out

    return step
