"""Fused masked LSTM forward: CUDA kernel, plain version, launch count.

Replaces the TPU kernel ``_lstm_fused_kernel`` reached through
``_lstm_fused_impl`` / ``lstm_pallas_fused`` in
``context_attentive_ir_tpu/ops/pallas/lstm.py`` (forward only).  The kernel
is ``csrc/lstm_fwd.cu``: one thread block owns 32 rows and runs every time
step itself with h and c in registers (f32), computing the input projection
``x_t @ W_ih`` inside the kernel so the ``[B, T, 4H]`` gates never reach
device memory.

Bound on the H100 (doc encoder, one direction, [16000, 30, 256] -> 128):
2*B*T*(E+H)*4H = 1.9e11 flops, 0.19 ms at the bf16 tensor-core peak,
against 0.37 GB of x + h traffic (0.11 ms): compute-bound.  This first
version uses CUDA-core FMAs and streams the weights from L2, so it runs far
above that bound; ``PERF.md`` records the gap.
"""

from __future__ import annotations

import torch

from ...device import check_on, resolve_device

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def lstm_fused_reference(x: torch.Tensor, mask: torch.Tensor,
                         w_ih: torch.Tensor, b: torch.Tensor,
                         w_hh: torch.Tensor,
                         reverse: bool = False) -> torch.Tensor:
    """Plain PyTorch version: a masked time loop on ``x @ W_ih + b`` in
    f32, with h rounded to x's dtype before ``h @ W_hh`` as in the kernel.
    Returns ``[B, T, H]`` in x's dtype, zero where ``mask`` is False."""
    B, T, _ = x.shape
    H = w_hh.shape[0]
    xp = x.float() @ w_ih.float() + b.float()
    whh = w_hh.float()
    h = torch.zeros((B, H), dtype=torch.float32, device=x.device)
    c = torch.zeros_like(h)
    out = torch.zeros((B, T, H), dtype=torch.float32, device=x.device)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = xp[:, t] + h.to(x.dtype).float() @ whh
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        m = mask[:, t, None]
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
        out[:, t] = h * m
    return out.to(x.dtype)


def lstm_fused(x: torch.Tensor, mask: torch.Tensor, w_ih: torch.Tensor,
               b: torch.Tensor, w_hh: torch.Tensor, reverse: bool = False,
               device="cuda") -> torch.Tensor:
    """x [B, T, E], mask bool [B, T], w_ih [E, 4H], b [4H], w_hh [H, 4H]
    (one dtype, float32 or bfloat16) -> h [B, T, H] in x's dtype.

    On CUDA tensors this launches ``cair_lstm_fwd``; on CPU tensors
    (``device="cpu"``) it runs ``lstm_fused_reference``."""
    dev = resolve_device(device)
    check_on(dev, x, mask, w_ih, b, w_hh)
    if dev.type == "cpu":
        return lstm_fused_reference(x, mask, w_ih, b, w_hh, reverse)
    if dev.type != "cuda":
        raise ValueError(f"lstm_fused runs on cuda or cpu, not {dev}")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype
                                     for t in (w_ih, b, w_hh)):
        raise TypeError("x, w_ih, b, w_hh must share one dtype, float32 or "
                        f"bfloat16; got {x.dtype}, {w_ih.dtype}, {b.dtype}, "
                        f"{w_hh.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, E], got {tuple(x.shape)}")
    B, T, E = x.shape
    H = w_hh.shape[0]
    if (tuple(mask.shape) != (B, T) or tuple(w_ih.shape) != (E, 4 * H)
            or tuple(b.shape) != (4 * H,) or tuple(w_hh.shape) != (H, 4 * H)):
        raise ValueError(
            f"shapes x {tuple(x.shape)}, mask {tuple(mask.shape)}, w_ih "
            f"{tuple(w_ih.shape)}, b {tuple(b.shape)}, w_hh "
            f"{tuple(w_hh.shape)} do not form one LSTM")
    if not all(t.is_contiguous() for t in (x, mask, w_ih, b, w_hh)):
        raise ValueError("lstm_fused needs contiguous tensors")
    out = torch.empty((B, T, H), dtype=x.dtype, device=x.device)
    from .build import check, load_library

    # the launcher reports a hidden size or E + H its block cannot hold
    check(load_library().cair_lstm_fwd(
        x.data_ptr(), mask.data_ptr(), w_ih.data_ptr(), b.data_ptr(),
        w_hh.data_ptr(), out.data_ptr(), B, T, E, H, int(reverse),
        _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream),
        "cair_lstm_fwd")
    lstm_fused.launches += 1
    return out


lstm_fused.launches = 0
