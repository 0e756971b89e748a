"""Attention LSTM decoder with input feeding (port of
``context_attentive_ir_tpu/ops/decoder.py``): ``init_state``, one decode
``step``, and the teacher-forced unroll (``forward``).

State is a plain dict of batch-leading tensors (``h``/``c`` tuples over
layers and ``input_feed``), so beam search reorders the whole state with one
gather.  As in the JAX module, dropout applies to the attentional outputs of
the unroll only, not between stacked layers inside a step.
"""

from __future__ import annotations

import torch

from .layers import ParamModule, dropout
from .masking import masked_softmax


class AttnLSTMDecoder(ParamModule):
    """LSTM decoder + Luong attention (``dot`` or ``general``); emits the
    attentional hidden state and the alignment."""

    def __init__(self, features: int, embed_dim: int, num_layers: int = 1,
                 attn_type: str = "general", input_feed: bool = True,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 dropout: float = 0.0):
        super().__init__(device)
        self.dropout = dropout
        if attn_type not in ("dot", "general"):
            raise ValueError(f"unknown attn_type {attn_type!r}")
        H, E = features, embed_dim
        self.features, self.num_layers = H, num_layers
        self.attn_type, self.input_feed, self.dtype = attn_type, input_feed, dtype
        in0 = E + (H if input_feed else 0)
        for layer in range(num_layers):
            self.new_param(f"w_ih{layer}", (in0 if layer == 0 else H, 4 * H),
                           "glorot")
            self.new_param(f"w_hh{layer}", (H, 4 * H), "orthogonal")
            self.new_param(f"b{layer}", (4 * H,), "zeros")
        if attn_type == "general":
            self.new_param("linear_in", (H, H), "glorot")
        self.new_param("linear_out", (2 * H, H), "glorot")

    def init_state(self, batch_size: int,
                   init_hidden: torch.Tensor | None = None) -> dict:
        """``init_hidden [B, H]`` seeds every layer's h (through tanh)."""
        zeros = torch.zeros((batch_size, self.features), dtype=self.dtype,
                            device=self.device if init_hidden is None
                            else init_hidden.device)
        h0 = zeros if init_hidden is None else torch.tanh(
            init_hidden.to(self.dtype))
        L = self.num_layers
        return {"h": tuple(h0 for _ in range(L)),
                "c": tuple(zeros for _ in range(L)),
                "input_feed": zeros}

    def step(self, state: dict, emb_t: torch.Tensor, memory: torch.Tensor,
             memory_mask: torch.Tensor):
        """One timestep.  emb_t [B, E], memory [B, S, H], mask [B, S].
        Returns (new_state, attn_h [B, H], align [B, S])."""
        dt = self.dtype
        x = emb_t.to(dt)
        if self.input_feed:
            x = torch.cat([x, state["input_feed"]], dim=-1)
        hs, cs = [], []
        for layer in range(self.num_layers):
            gates = (x @ getattr(self, f"w_ih{layer}").to(dt)
                     + state["h"][layer] @ getattr(self, f"w_hh{layer}").to(dt)
                     + getattr(self, f"b{layer}").to(dt))
            i, f, g, o = gates.chunk(4, dim=-1)
            c = (torch.sigmoid(f) * state["c"][layer]
                 + torch.sigmoid(i) * torch.tanh(g))
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
            cs.append(c)
            x = h
        h_top = hs[-1]
        mem = memory.to(dt)
        q = h_top @ self.linear_in.to(dt) if self.attn_type == "general" \
            else h_top
        scores = torch.einsum("bh,bsh->bs", q, mem)
        align = masked_softmax(scores, memory_mask, dim=-1)
        context = torch.einsum("bs,bsh->bh", align, mem)
        attn_h = torch.tanh(torch.cat([context, h_top], dim=-1)
                            @ self.linear_out.to(dt))
        return ({"h": tuple(hs), "c": tuple(cs), "input_feed": attn_h},
                attn_h, align)

    def forward(self, emb_targets: torch.Tensor, memory: torch.Tensor,
                memory_mask: torch.Tensor,
                init_hidden: torch.Tensor | None = None,
                deterministic: bool = True,
                generator: torch.Generator | None = None):
        """Teacher-forced unroll: emb_targets [B, T, E] (BOS-shifted) ->
        (attn_hs [B, T, H], aligns [B, T, S])."""
        state = self.init_state(emb_targets.shape[0], init_hidden)
        attn_hs, aligns = [], []
        for t in range(emb_targets.shape[1]):
            state, attn_h, align = self.step(state, emb_targets[:, t], memory,
                                             memory_mask)
            attn_hs.append(attn_h)
            aligns.append(align)
        attn_hs = dropout(torch.stack(attn_hs, dim=1), self.dropout,
                          deterministic, generator)
        return attn_hs, torch.stack(aligns, dim=1)
