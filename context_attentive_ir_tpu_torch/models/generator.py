"""Tied vocabulary generator (port of
``context_attentive_ir_tpu/models/generator.py``, tied form).

The head projects H -> E (``tie_proj``) and multiplies by the transposed
embedding table.  ``project_only`` returns the E-dim projection: the input
of the fused generator kernel (``ops/kernels/beamgen.py``), which computes
top-k and logsumexp without materialising the logits.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.layers import Dense, Embeddings


class Generator(nn.Module):
    def __init__(self, in_features: int, embeddings: Embeddings,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.tie_proj = Dense(in_features, embeddings.features, dtype=dtype,
                              device=device)

    def forward(self, h: torch.Tensor, embeddings: Embeddings,
                project_only: bool = False) -> torch.Tensor:
        """h [..., H] -> logits [..., V] (or the [..., E] projection)."""
        proj = self.tie_proj(h)
        return proj if project_only else embeddings.attend(proj)
