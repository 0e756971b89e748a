"""Vocabulary generator head, tied or untied (port of
``context_attentive_ir_tpu/models/generator.py``).

Tied (``tie=True``): the head projects H -> E (``tie_proj``) and multiplies
by the transposed embedding table.  ``project_only`` returns the E-dim
projection: the input of the fused generator kernel
(``ops/kernels/beamgen.py``), which computes top-k and logsumexp without
materialising the logits.  Untied (``tie=False``): one ``Dense(H, V)``
named ``proj``, as in the JAX tree; it has no projection for the fused
kernel, so ``project_only`` raises.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.layers import Dense, Embeddings


class Generator(nn.Module):
    def __init__(self, in_features: int, embeddings: Embeddings,
                 tie: bool = True, vocab_size: int | None = None,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.tie = tie
        if tie:
            self.tie_proj = Dense(in_features, embeddings.features,
                                  dtype=dtype, device=device)
        else:
            if vocab_size is None:
                raise ValueError("an untied generator needs vocab_size")
            self.proj = Dense(in_features, vocab_size, dtype=dtype,
                              device=device)

    def forward(self, h: torch.Tensor, embeddings: Embeddings,
                project_only: bool = False) -> torch.Tensor:
        """h [..., H] -> logits [..., V] (or the tied [..., E] projection)."""
        if not self.tie:
            if project_only:
                raise ValueError("project_only requires a tied generator")
            return self.proj(h)
        proj = self.tie_proj(h)
        return proj if project_only else embeddings.attend(proj)
