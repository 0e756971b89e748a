"""Luong-style global attention and attention pooling (port of
``GlobalAttention`` and ``AttentionPool`` in
``context_attentive_ir_tpu/ops/attention.py``).

``GlobalAttention`` scores a query against a masked memory with the
``dot``, ``general`` or ``mlp`` function and returns the attentional state
and the alignment, with the JAX module's conventions: the output
projection ``linear_out`` has a bias and no tanh for ``mlp``, and a tanh
and no bias for ``dot`` / ``general``.  No model of the zoo calls it; it is
kept for the JAX package's ``ops`` surface.

Pools token states into one vector, optionally conditioned on an external
query vector (CARS's query-aware document pooling).  The query-independent
half ``tanh(states @ W_p + b_p)`` is exposed (``proj_only``) and reusable
(``proj_states``) for cached-document ranking.

``use_kernel=True`` sends the query-conditioned pool to the fused
slate-pool kernel (kernel 10, ``ops/kernels/slate.py``) when the JAX
``_pallas_ok`` conditions hold -- a query is given, no cached projection,
``states`` has the pool's width, ``pool_supported`` (the JAX gate, which
the launcher holds whole) -- and the states lie on a CUDA device.  A shape
the JAX gate refuses takes the formulation below, as in JAX.

Speed: the kernel runs on tensor cores at every width (``pool_route``: the
resident kernel for bf16 at 128 / 256, the wide route elsewhere).  On the
H100 (PERF.md) it is faster than this module with ``use_kernel=False`` in
float32 at every width, and in bf16 at suggest init's 1,280 documents at
every width and at the rank slate's 16,000 documents to H = 768; at H =
896-1,024 (CARS's doc pool at ``nhid`` 448-512) it is 1.02-1.16x slower
there in bf16, and above 1,024 1.8-2.2x slower in bf16, so leave
``use_pallas_slate`` off at those widths in bf16 for ranking.
"""

from __future__ import annotations

import math

import torch

from .kernels.slate import attn_pool, attn_pool_train, pool_supported
from .layers import Dense, ParamModule
from .masking import masked_softmax

ATTN_TYPES = ("dot", "general", "mlp")


class GlobalAttention(ParamModule):
    """``forward(query [B, Tq, H] or [B, H], memory [B, S, H], mask bool
    [B, S]) -> (attn_h [B, Tq, H], align [B, Tq, S])``, squeezing Tq for a
    rank-2 query.  Parameters (flax names): ``linear_in`` (general, no
    bias), ``query_proj`` (mlp, bias), ``memory_proj`` (mlp, no bias),
    ``v [dim, 1]`` (mlp) and ``linear_out [2 * dim, dim]``."""

    def __init__(self, dim: int, attn_type: str = "general",
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__(device)
        if attn_type not in ATTN_TYPES:
            raise ValueError(f"unknown attn_type {attn_type}")
        self.dim = dim
        self.attn_type = attn_type
        self.dtype = dtype
        dev = self.device
        if attn_type == "general":
            self.linear_in = Dense(dim, dim, use_bias=False, dtype=dtype,
                                   device=dev)
        elif attn_type == "mlp":
            self.query_proj = Dense(dim, dim, dtype=dtype, device=dev)
            self.memory_proj = Dense(dim, dim, use_bias=False, dtype=dtype,
                                     device=dev)
            self.v = self.new_param("v", (dim, 1), "glorot")
        self.linear_out = Dense(2 * dim, dim, use_bias=attn_type == "mlp",
                                dtype=dtype, device=dev)

    def forward(self, query: torch.Tensor, memory: torch.Tensor,
                memory_mask: torch.Tensor):
        squeeze = query.dim() == 2
        q = (query[:, None] if squeeze else query).to(self.dtype)
        m = memory.to(self.dtype)
        if self.attn_type == "general":
            scores = torch.einsum("bth,bsh->bts", self.linear_in(q), m)
        elif self.attn_type == "dot":
            scores = torch.einsum("bth,bsh->bts", q, m)
        else:
            hidden = torch.tanh(self.query_proj(q)[:, :, None]
                                + self.memory_proj(m)[:, None])
            scores = torch.einsum("btsh,ho->bts", hidden,
                                  self.v.to(self.dtype))
        align = masked_softmax(scores, memory_mask[:, None, :], dim=-1)
        context = torch.einsum("bts,bsh->bth", align, m)
        attn_h = self.linear_out(torch.cat([context, q], dim=-1))
        if self.attn_type != "mlp":
            attn_h = torch.tanh(attn_h)
        if squeeze:
            return attn_h[:, 0], align[:, 0]
        return attn_h, align


class AttentionPool(ParamModule):
    """``states [..., T, D]`` -> ``[..., dim]``.  ``use_query=False`` gives
    the pool its own learned scoring vector ``v`` (the JAX module creates
    ``v`` exactly when it is called without a query)."""

    def __init__(self, in_features: int, dim: int, use_query: bool,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 use_kernel: bool = False):
        super().__init__(device)
        self.dtype = dtype
        self.dim = dim
        self.use_query = use_query
        self.use_kernel = use_kernel
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
        w_p = self.proj_kernel.to(self.dtype)
        b_p = self.proj_bias.to(self.dtype)
        if proj_only:
            return torch.tanh(s @ w_p + b_p)
        if (query is not None) != self.use_query:
            raise ValueError("query must be given exactly when the pool was "
                             "built with use_query=True")
        lead, T, D = states.shape[:-2], states.shape[-2], states.shape[-1]
        rows = math.prod(lead)
        if (self.use_kernel and query is not None and proj_states is None
                and D == self.dim and pool_supported(D, rows)
                and states.device.type == "cuda"):
            train = torch.is_grad_enabled() and any(
                t.requires_grad for t in (s, query, w_p, b_p))
            out = (attn_pool_train if train else attn_pool)(
                s.reshape(-1, T, D).contiguous(),
                mask.reshape(-1, T).contiguous(),
                query.to(self.dtype).reshape(-1, D).contiguous(),
                w_p.contiguous(), b_p.contiguous(), device=states.device)
            return out.reshape(*lead, D)
        if proj_states is None:
            h = torch.tanh(s @ w_p + b_p)
        else:
            h = proj_states.to(self.dtype)
        if query is not None:
            scores = torch.einsum("...th,...h->...t", h,
                                  query.to(self.dtype))
        else:
            scores = (h @ self.v.to(self.dtype))[..., 0]
        align = masked_softmax(scores, mask, dim=-1)
        return torch.einsum("...t,...th->...h", align, s)
