"""Attention pooling (port of ``AttentionPool`` in
``context_attentive_ir_tpu/ops/attention.py``).

Pools token states into one vector, optionally conditioned on an external
query vector (CARS's query-aware document pooling).  The query-independent
half ``tanh(states @ W_p + b_p)`` is exposed (``proj_only``) and reusable
(``proj_states``) for cached-document ranking.
"""

from __future__ import annotations

import torch

from .layers import ParamModule
from .masking import masked_softmax


class AttentionPool(ParamModule):
    """``states [..., T, D]`` -> ``[..., dim]``.  ``use_query=False`` gives
    the pool its own learned scoring vector ``v`` (the JAX module creates
    ``v`` exactly when it is called without a query)."""

    def __init__(self, in_features: int, dim: int, use_query: bool,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__(device)
        self.dtype = dtype
        self.use_query = use_query
        self.proj_kernel = self.new_param("proj_kernel", (in_features, dim),
                                          "glorot")
        self.proj_bias = self.new_param("proj_bias", (dim,), "zeros")
        self.v = None if use_query else self.new_param("v", (dim, 1),
                                                       "glorot")

    def forward(self, states: torch.Tensor, mask: torch.Tensor | None = None,
                query: torch.Tensor | None = None,
                proj_states: torch.Tensor | None = None,
                proj_only: bool = False) -> torch.Tensor:
        s = states.to(self.dtype)
        if proj_only:
            return torch.tanh(s @ self.proj_kernel.to(self.dtype)
                              + self.proj_bias.to(self.dtype))
        if (query is not None) != self.use_query:
            raise ValueError("query must be given exactly when the pool was "
                             "built with use_query=True")
        if proj_states is None:
            h = torch.tanh(s @ self.proj_kernel.to(self.dtype)
                           + self.proj_bias.to(self.dtype))
        else:
            h = proj_states.to(self.dtype)
        if query is not None:
            scores = torch.einsum("...th,...h->...t", h,
                                  query.to(self.dtype))
        else:
            scores = (h @ self.v.to(self.dtype))[..., 0]
        align = masked_softmax(scores, mask, dim=-1)
        return torch.einsum("...t,...th->...h", align, s)
