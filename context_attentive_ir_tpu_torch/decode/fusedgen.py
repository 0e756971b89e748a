"""Fused-generator step construction (port of
``context_attentive_ir_tpu/decode/fusedgen.py``).

Bridges a model's ``decode_step_fused`` (tie projection, no logits matmul)
and the fused generator kernel (``ops/kernels/beamgen.py``) into the
``(state, (vals, idx, lse))`` step contract of ``beam_search`` and
``greedy_decode``, for a float or an int8 table, the serial, pruned or
pipelined kernel, and an optional vocabulary shortlist.

``pipeline=None`` and ``prune=None`` resolve from the port's dispatch
table of H100 rows (``ops.dispatch.prefer_pipelined_generator`` /
``prefer_pruned_generator`` at the step's rows and kc), as the JAX package
resolves them from its TPU table; every choice gives the same outputs.
An unmeasured kc above 32 prunes (``dispatch.PRUNE_ABOVE_KC``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.dispatch import prefer_pipelined_generator, prefer_pruned_generator
from ..ops.kernels.beamgen import (
    MAX_KC,
    aligned_table,
    generator_topk_lse,
    generator_topk_lse_reference,
)


def fused_generator_table(model, dtype: torch.dtype = torch.bfloat16):
    """``(table_t [E, V], scale [V] | None)`` of the model's tied table,
    or None when the model has none (no embeddings, or an untied generator,
    whose logits come from its own ``proj`` and not from the table).  ``table_t`` is a view of a table
    whose rows are padded to a multiple of 16 bytes (``aligned_table``), so
    the kernels read it as it lies on every step of the decode.

    A float table returns ``(table.T`` in ``dtype``, ``None)``; the int8
    serving table (``embedding_q`` + ``embedding_scale``) returns ``(q.T``
    int8, ``scale`` float32 ``[V])``, the int8 mode of the kernel."""
    emb = getattr(model, "embeddings", None)
    generator = getattr(model, "generator", None)
    if emb is None or not getattr(generator, "tie", True):
        return None
    if getattr(emb, "quantized", False):
        return (aligned_table(emb.embedding_q.detach().t()),
                emb.embedding_scale.detach().reshape(-1).float()
                .contiguous())
    return aligned_table(emb.embedding.detach().to(dtype).t()), None


def can_fuse_generator(model) -> bool:
    return (hasattr(model, "decode_step_fused")
            and fused_generator_table(model) is not None)


def _shortlisted(table_t, scale, shortlist):
    """The table's shortlist columns (and their scales), gathered once per
    decode into an aligned table, and the shortlist as an int32 map from
    column to vocab id."""
    sl = torch.as_tensor(shortlist, dtype=torch.long,
                         device=table_t.device)
    table_t = aligned_table(table_t.index_select(1, sl))
    if scale is not None:
        scale = scale.index_select(0, sl).contiguous()
    return table_t, scale, sl.to(torch.int32)


def make_fused_beam_step(model, memory: torch.Tensor,
                         memory_mask: torch.Tensor, kc: int,
                         dtype: torch.dtype = torch.bfloat16,
                         pipeline: bool | None = None,
                         prune: bool | None = None,
                         shortlist=None) -> Optional[Callable]:
    """``(state, tokens) -> (state, (vals, idx, lse))`` or None when the
    model cannot take the fused path, or ``kc`` is above ``MAX_KC`` = 128
    (the JAX kernel's own top-kc); the kernels hold every E.  The caller
    then decodes through the model's logits step, which is exact.
    ``memory`` and ``memory_mask`` must already be beam-tiled.  The
    transposed table is built once here and reused by every step.

    ``pipeline=None`` / ``prune=None`` take the dispatch table's choice at
    ``memory``'s row count and ``kc``.  An int8 table forces
    ``pipeline=False`` and ``pipeline`` forces ``prune=False`` (both are
    serial-kernel modes); every choice gives the same outputs.
    ``shortlist``: int32 ``[C]`` sorted vocab ids (``decode/shortlist.py``)
    -- the generator scores only these columns and the returned indices
    are mapped back to vocab ids."""
    if not can_fuse_generator(model) or kc > MAX_KC:
        return None
    table_t, scale = fused_generator_table(model, dtype)
    rows = memory.shape[0]
    if pipeline is None:
        pipeline = prefer_pipelined_generator(rows, kc)
    if prune is None:
        prune = prefer_pruned_generator(rows, kc)
    pipeline = bool(pipeline) and scale is None
    prune = bool(prune) and not pipeline
    sl = None
    if shortlist is not None:
        table_t, scale, sl = _shortlisted(table_t, scale, shortlist)

    def step(state, tokens):
        state, proj, _ = model.decode_step_fused(state, tokens, memory,
                                                 memory_mask)
        vals, idx, lse = generator_topk_lse(
            proj.to(dtype).contiguous(), table_t, kc, scale=scale,
            prune=prune, pipeline=pipeline, device=proj.device)
        if sl is not None:
            idx = sl[idx.long()]
        return state, (vals, idx, lse)

    return step


def make_shortlist_xla_step(model, memory: torch.Tensor,
                            memory_mask: torch.Tensor, kc: int,
                            dtype: torch.dtype = torch.bfloat16,
                            shortlist=None) -> Optional[Callable]:
    """The plain-version shortlist step: the same ``(vals, idx, lse)``
    contract and restricted-softmax math as the fused step's shortlist
    mode, through ``generator_topk_lse_reference`` on the gathered columns
    on any device.  None without a shortlist or a tied table."""
    if shortlist is None or not can_fuse_generator(model):
        return None
    table_t, scale, sl = _shortlisted(*fused_generator_table(model, dtype),
                                      shortlist)

    def step(state, tokens):
        state, proj, _ = model.decode_step_fused(state, tokens, memory,
                                                 memory_mask)
        vals, idx, lse = generator_topk_lse_reference(proj.to(dtype),
                                                      table_t, kc, scale)
        return state, (vals, sl[idx.long()], lse)

    return step
