"""Masked LSTM encoders (port of ``context_attentive_ir_tpu/ops/rnn.py``,
LSTM only).

Padding is handled by carrying state through masked steps, so shapes stay
static and no packing is needed; outputs are zero at masked positions.
Gate order is i, f, g, o and weights keep the JAX layout (``w_ih [D, 4H]``,
``w_hh [H, 4H]``, ``b_ih [4H]``).

``RNNLayer(use_kernel=True)`` runs each direction through the fused LSTM
kernel (``ops/kernels/lstm.py``) whenever no initial state is given -- the
JAX ``_pallas_ok`` condition without the TPU dispatch table.  On CPU
tensors that wrapper runs its plain version.
"""

from __future__ import annotations

import torch
from torch import nn

from .kernels.lstm import lstm_fused
from .layers import ParamModule


def lstm_scan(x_proj: torch.Tensor, mask: torch.Tensor, w_hh: torch.Tensor,
              h0: torch.Tensor, c0: torch.Tensor, reverse: bool = False):
    """Masked LSTM over time on precomputed ``x_proj = x @ W_ih + b``
    ``[B, T, 4H]``.  Returns (outputs [B, T, H], (hT, cT))."""
    T = x_proj.shape[1]
    h, c = h0, c0
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = x_proj[:, t] + h @ w_hh
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        m = mask[:, t, None]
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
        outs[t] = h
    out = torch.stack(outs, dim=1) * mask[..., None].to(h.dtype)
    return out, (h, c)


class RNNLayer(ParamModule):
    """One (optionally bidirectional) LSTM layer with parameters
    ``w_ih_{fwd,bwd}``, ``w_hh_{fwd,bwd}``, ``b_ih_{fwd,bwd}``."""

    def __init__(self, in_features: int, features: int,
                 bidirectional: bool = True, use_kernel: bool = False,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__(device)
        self.features = features
        self.use_kernel = use_kernel
        self.dtype = dtype
        self.dirs = ["fwd", "bwd"] if bidirectional else ["fwd"]
        for d in self.dirs:
            self.new_param(f"w_ih_{d}", (in_features, 4 * features),
                           "glorot")
            self.new_param(f"w_hh_{d}", (features, 4 * features),
                           "orthogonal")
            self.new_param(f"b_ih_{d}", (4 * features,), "zeros")

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                h0: torch.Tensor | None = None):
        """x [B, T, D], mask bool [B, T] -> (out [B, T, H*dirs],
        final [B, H*dirs])."""
        B, T, _ = x.shape
        H = self.features
        x = x.to(self.dtype).contiguous()
        outs, finals = [], []
        for d in self.dirs:
            w_ih = getattr(self, f"w_ih_{d}").to(self.dtype)
            w_hh = getattr(self, f"w_hh_{d}").to(self.dtype)
            b_ih = getattr(self, f"b_ih_{d}").to(self.dtype)
            if self.use_kernel and h0 is None:
                # the fused kernel computes the input projection itself:
                # no [B, T, 4H] gate tensor reaches device memory
                o = lstm_fused(x, mask.contiguous(), w_ih.contiguous(),
                               b_ih.contiguous(), w_hh.contiguous(),
                               reverse=d == "bwd", device=x.device)
                # final state from the outputs: masks are contiguous from
                # the front (length-based), so the last valid output is
                # the carried state
                if d == "bwd":
                    hT = o[:, 0]
                else:
                    last = (mask.long().sum(-1) - 1).clamp_min(0)
                    hT = o[torch.arange(B, device=x.device), last]
            else:
                h_init = (torch.zeros((B, H), dtype=self.dtype,
                                      device=x.device) if h0 is None else h0)
                o, (hT, _) = lstm_scan(
                    x @ w_ih + b_ih, mask, w_hh, h_init,
                    torch.zeros((B, H), dtype=self.dtype, device=x.device),
                    reverse=d == "bwd")
            outs.append(o)
            finals.append(hT)
        return torch.cat(outs, dim=-1), torch.cat(finals, dim=-1)


class RNNEncoder(nn.Module):
    """Stacked LSTM encoder (``layer0``, ``layer1``, ...): per-token states
    ``[B, T, H*dirs]`` and the final state ``[B, H*dirs]``."""

    def __init__(self, in_features: int, features: int, num_layers: int = 1,
                 bidirectional: bool = True, use_kernel: bool = False,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.num_layers = num_layers
        width = features * (2 if bidirectional else 1)
        for layer in range(num_layers):
            self.add_module(f"layer{layer}", RNNLayer(
                in_features if layer == 0 else width, features,
                bidirectional, use_kernel, dtype, device))

    def forward(self, x: torch.Tensor, mask: torch.Tensor):
        out, final = x, None
        for layer in range(self.num_layers):
            out, final = getattr(self, f"layer{layer}")(out, mask)
        return out, final
