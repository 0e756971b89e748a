"""Masked LSTM and GRU encoders (port of
``context_attentive_ir_tpu/ops/rnn.py``).

Padding is handled by carrying state through masked steps, so shapes stay
static and no packing is needed; outputs are zero at masked positions.
Gate orders are torch's -- i, f, g, o for the LSTM, r, z, n for the GRU --
and weights keep the JAX layout (``w_ih [D, G]``, ``w_hh [H, G]``, ``b_ih
[G]`` with G = 4H or 3H; a GRU also has its own ``b_hh [3H]``).

``RNNLayer(use_kernel=True)`` runs each direction through the fused
kernels whenever no initial state is given, the kernels hold the shape
(``fused_supported`` / ``gru_fused_supported``) and the port's dispatch
table does not send it to the scan (``ops.dispatch.prefer_kernel``: the
kernels unless an H100 row measured the scan faster) -- the JAX
``_pallas_ok`` condition over the H100 table.  A shape they do not hold goes
through ``lstm_scan`` / ``gru_scan`` on CPU tensors, as in JAX; on CUDA
tensors it raises with the limit, and the caller chooses the scan with
``use_kernel=False`` (``use_pallas_rnn=False`` in the model config): the
layer never leaves the kernels by itself on the card.  For an LSTM that is
kernel 1
(``lstm_fused``) when no gradient is needed, the training pair (kernels 4
and 5, ``lstm_fused_train``) when one is (``ops/kernels/lstm.py``); for a
GRU kernel 7 (``gru_fused``) or the pair 8 and 9 (``gru_fused_train``,
``ops/kernels/gru.py``).  On CPU tensors those wrappers run their plain
versions.  The final state is then read from the outputs, as the JAX
kernel branch reads it: masks are contiguous from the front (length-based),
so the last valid output is the carried state.
"""

from __future__ import annotations

import torch
from torch import nn

from .dispatch import prefer_kernel
from .kernels.gru import gru_fused, gru_fused_supported, gru_fused_train
from .kernels.lstm import fused_supported, lstm_fused, lstm_fused_train
from .layers import ParamModule, dropout

RNN_TYPES = ("lstm", "gru")


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


def bilstm_scan(x_proj_f: torch.Tensor, x_proj_b: torch.Tensor,
                mask: torch.Tensor, w_hh_f: torch.Tensor,
                w_hh_b: torch.Tensor):
    """Both directions of a BiLSTM in one loop over time (the JAX
    ``bilstm_scan``): the forward direction reads step t while the backward
    one reads step T - 1 - t, through one batched ``[2, B, H] @ [2, H,
    4H]`` product a step, from a zero state.  Returns (out_f [B, T, H],
    out_b [B, T, H], hT_f [B, H], hT_b [B, H]), as two ``lstm_scan`` calls
    do.  No layer calls it (``RNNLayer`` runs the kernels or two scans)."""
    B, T, G = x_proj_f.shape
    H = G // 4
    w = torch.stack([w_hh_f, w_hh_b])                       # [2, H, 4H]
    h = x_proj_f.new_zeros((2, B, H))
    c = h
    outs_f, outs_b = [None] * T, [None] * T
    for t in range(T):
        xp = torch.stack([x_proj_f[:, t], x_proj_b[:, T - 1 - t]])
        m = torch.stack([mask[:, t], mask[:, T - 1 - t]])[..., None]
        gates = xp + torch.bmm(h, w)
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
        outs_f[t], outs_b[T - 1 - t] = h[0], h[1]
    mexp = mask[..., None].to(h.dtype)
    return (torch.stack(outs_f, 1) * mexp, torch.stack(outs_b, 1) * mexp,
            h[0], h[1])


def gru_scan(x_proj: torch.Tensor, mask: torch.Tensor, w_hh: torch.Tensor,
             b_hh: torch.Tensor, h0: torch.Tensor, reverse: bool = False):
    """Masked GRU over time (torch gate semantics) on precomputed ``x_proj =
    x @ W_ih + b_ih`` ``[B, T, 3H]``; ``b_hh`` stays separate because r
    multiplies it in the n slot.  Returns (outputs [B, T, H], hT)."""
    T = x_proj.shape[1]
    h = h0
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        xr, xz, xn = x_proj[:, t].chunk(3, dim=-1)
        hr, hz, hn = (h @ w_hh + b_hh).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = torch.where(mask[:, t, None], (1.0 - z) * n + z * h, h)
        outs[t] = h
    out = torch.stack(outs, dim=1) * mask[..., None].to(h.dtype)
    return out, h


class RNNLayer(ParamModule):
    """One (optionally bidirectional) LSTM or GRU layer with parameters
    ``w_ih_{fwd,bwd}``, ``w_hh_{fwd,bwd}``, ``b_ih_{fwd,bwd}`` and, for a
    GRU, ``b_hh_{fwd,bwd}``."""

    def __init__(self, in_features: int, features: int,
                 bidirectional: bool = True, use_kernel: bool = False,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 rnn_type: str = "lstm"):
        super().__init__(device)
        if rnn_type not in RNN_TYPES:
            raise ValueError(f"unknown rnn_type {rnn_type!r}; choose from "
                             f"{RNN_TYPES}")
        self.features = features
        self.use_kernel = use_kernel
        self.dtype = dtype
        self.rnn_type = rnn_type
        self.dirs = ["fwd", "bwd"] if bidirectional else ["fwd"]
        G = (4 if rnn_type == "lstm" else 3) * features
        for d in self.dirs:
            self.new_param(f"w_ih_{d}", (in_features, G), "glorot")
            self.new_param(f"w_hh_{d}", (features, G), "orthogonal")
            self.new_param(f"b_ih_{d}", (G,), "zeros")
            if rnn_type == "gru":
                self.new_param(f"b_hh_{d}", (G,), "zeros")

    def kernel_ok(self, x: torch.Tensor, h0, training: bool = False) -> bool:
        """Whether this call takes the fused kernels: asked for, no initial
        state, a shape the kernels hold, and the dispatch table's choice
        (``prefer_kernel``, ``training`` for a call that needs gradients).
        A shape they do not hold, or a table row that prefers the scan,
        takes the scan on CPU tensors (as the JAX ``_pallas_ok`` decides)
        and raises on CUDA tensors: on the card the table never trades a
        kernel for the plain scan."""
        if not (self.use_kernel and h0 is None):
            return False
        supported = (gru_fused_supported if self.rnn_type == "gru"
                     else fused_supported)
        if supported(x.shape[-1], self.features, x.shape[0], self.dtype):
            if prefer_kernel(self.rnn_type, x.shape[0], x.shape[1],
                             x.shape[-1], self.features,
                             str(self.dtype).rpartition(".")[2], training):
                return True
            if x.is_cuda:
                raise ValueError(
                    f"RNNLayer: a row of ops/dispatch_table.json prefers "
                    f"the plain {self.rnn_type} scan to the fused kernels "
                    f"at [{x.shape[0]}, {x.shape[1]}, {x.shape[-1]}] -> "
                    f"{self.features}; the port runs no plain scan on the "
                    "card in a kernel's place unasked: construct the layer "
                    "with use_kernel=False (use_pallas_rnn=False in the "
                    "model config) to run it")
            return False
        if x.is_cuda:
            raise ValueError(
                f"RNNLayer: the fused {self.rnn_type} kernels do not hold "
                f"[{x.shape[0]}, T, {x.shape[-1]}] -> {self.features} in "
                f"{self.dtype} ({supported.__name__} states any E and H of "
                "at least one row in float32 and bfloat16); construct the "
                "layer with use_kernel=False (use_pallas_rnn=False in the "
                "model config) to run the plain scan on the card")
        return False

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                h0: torch.Tensor | None = None):
        """x [B, T, D], mask bool [B, T] -> (out [B, T, H*dirs],
        final [B, H*dirs])."""
        B, T, _ = x.shape
        H = self.features
        x = x.to(self.dtype).contiguous()
        outs, finals = [], []
        gru = self.rnn_type == "gru"
        train = torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for p in self.parameters()))
        use_kernel = self.kernel_ok(x, h0, train)
        for d in self.dirs:
            w_ih = getattr(self, f"w_ih_{d}").to(self.dtype)
            w_hh = getattr(self, f"w_hh_{d}").to(self.dtype)
            b_ih = getattr(self, f"b_ih_{d}").to(self.dtype)
            # the GRU's recurrent bias: (b_hh,) for a GRU, () for an LSTM
            b_hh = ((getattr(self, f"b_hh_{d}").to(self.dtype),) if gru
                    else ())
            if use_kernel:
                # the fused kernels compute the input projection themselves:
                # no [B, T, G] gate tensor reaches device memory
                if gru:
                    fn = gru_fused_train if train else gru_fused
                else:
                    fn = lstm_fused_train if train else lstm_fused
                o = fn(x, mask.contiguous(), w_ih.contiguous(),
                       b_ih.contiguous(), w_hh.contiguous(),
                       *(b.contiguous() for b in b_hh),
                       reverse=d == "bwd", device=x.device)
                if d == "bwd":
                    hT = o[:, 0]
                else:
                    last = (mask.long().sum(-1) - 1).clamp_min(0)
                    hT = o[torch.arange(B, device=x.device), last]
            else:
                h_init = (torch.zeros((B, H), dtype=self.dtype,
                                      device=x.device) if h0 is None else h0)
                if gru:
                    o, hT = gru_scan(x @ w_ih + b_ih, mask, w_hh, b_hh[0],
                                     h_init, reverse=d == "bwd")
                else:
                    o, (hT, _) = lstm_scan(
                        x @ w_ih + b_ih, mask, w_hh, h_init,
                        torch.zeros((B, H), dtype=self.dtype,
                                    device=x.device), reverse=d == "bwd")
            outs.append(o)
            finals.append(hT)
        return torch.cat(outs, dim=-1), torch.cat(finals, dim=-1)


class RNNEncoder(nn.Module):
    """Stacked LSTM or GRU encoder (``layer0``, ``layer1``, ...): per-token
    states ``[B, T, H*dirs]`` and the final state ``[B, H*dirs]``, with
    ``dropout`` between layers."""

    def __init__(self, in_features: int, features: int, num_layers: int = 1,
                 bidirectional: bool = True, use_kernel: bool = False,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 dropout: float = 0.0, rnn_type: str = "lstm"):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        width = features * (2 if bidirectional else 1)
        for layer in range(num_layers):
            self.add_module(f"layer{layer}", RNNLayer(
                in_features if layer == 0 else width, features,
                bidirectional, use_kernel, dtype, device, rnn_type))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                deterministic: bool = True,
                generator: torch.Generator | None = None):
        out, final = x, None
        for layer in range(self.num_layers):
            if layer > 0:
                out = dropout(out, self.dropout, deterministic, generator)
            out, final = getattr(self, f"layer{layer}")(out, mask)
        return out, final
