"""Fused masked LSTM kernels: forward (kernel 1), training forward with
chunk-boundary residuals (kernel 4), chunked-remat backward (kernel 5).
Each has its CUDA launcher, its plain PyTorch version and a launch count.

Kernel 1, ``lstm_fused``, replaces the TPU kernel ``_lstm_fused_kernel``
(``_lstm_fused_impl``) in ``context_attentive_ir_tpu/ops/pallas/lstm.py``:
``csrc/lstm_fwd.cu``, one thread block per 32 rows running every time step
with h and c in registers (f32), the input projection ``x_t @ W_ih``
computed inside the kernel so the ``[B, T, 4H]`` gates never reach device
memory.  It computes no gradient and refuses inputs that need one.

Kernels 4 and 5 are the training pair behind ``lstm_fused_train``, the
counterpart of the ``lstm_pallas_fused`` custom_vjp:

- ``lstm_fused_res`` (kernel 4, ``csrc/lstm_fwd.cu``) replaces
  ``_lstm_fused_res_kernel``: kernel 1 plus the carried ``(h, c)`` before
  every chunk of ``time_chunk`` steps in processing order, float32
  ``[n_chunks, B, H]``.
- ``lstm_fused_bwd`` (kernel 5, ``csrc/lstm_bwd.cu``) replaces
  ``_lstm_fused_bwd_kernel``: per chunk in reverse, recompute the forward
  from its boundary and run the cell backward (dx, dh, dc), then reduce
  ``dW_ih``, ``dW_hh`` and ``db`` over all rows and steps in a second,
  fixed-order pass (no atomics: the same bits every run).

Bounds on the H100 (doc encoder, one direction, [16000, 30, 256] -> 128,
bf16): kernel 1 and 4 do 2*B*T*(E+H)*4H = 1.9e11 flops, 0.19 ms at the
bf16 tensor-core peak; kernel 5 5.7e11 flops, 0.57 ms: all compute-bound.
These first versions use CUDA-core FMAs and stream the weights from L2, so
they run far above their bounds; ``PERF.md`` records the gap.
"""

from __future__ import annotations

import torch

from ...device import check_on, resolve_device

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def chunk_len(n_steps: int, time_chunk: int) -> int:
    """The time-chunk length of the residual layout: ``time_chunk``, capped
    at the sequence length (``TC = min(time_chunk, T)`` as on the TPU)."""
    return max(1, min(time_chunk, n_steps))


def _first_in_chunk(t: int, n_steps: int, tc: int, reverse: bool) -> bool:
    """True when step t opens its chunk in processing order."""
    if reverse:
        return t == n_steps - 1 or (t + 1) % tc == 0
    return t % tc == 0


def lstm_fused_res_reference(x: torch.Tensor, mask: torch.Tensor,
                             w_ih: torch.Tensor, b: torch.Tensor,
                             w_hh: torch.Tensor, reverse: bool = False,
                             time_chunk: int = 6):
    """Plain PyTorch version of kernels 1 and 4: a masked time loop on
    ``x @ W_ih + b`` in f32, with h rounded to x's dtype before
    ``h @ W_hh`` as in the kernels.  Returns ``(out [B, T, H]`` in x's
    dtype, zero where ``mask`` is False, ``hb, cb)``: float32
    ``[ceil(T / tc), B, H]``, the state before each chunk of ``tc`` steps in
    processing order (zeros for the first chunk processed)."""
    B, T, _ = x.shape
    H = w_hh.shape[0]
    tc = chunk_len(T, time_chunk)
    xp = x.float() @ w_ih.float() + b.float()
    whh = w_hh.float()
    h = torch.zeros((B, H), dtype=torch.float32, device=x.device)
    c = torch.zeros_like(h)
    out = torch.zeros((B, T, H), dtype=torch.float32, device=x.device)
    n_chunks = -(-T // tc)
    hb = torch.zeros((n_chunks, B, H), dtype=torch.float32, device=x.device)
    cb = torch.zeros_like(hb)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        if _first_in_chunk(t, T, tc, reverse):
            hb[t // tc] = h
            cb[t // tc] = c
        gates = xp[:, t] + h.to(x.dtype).float() @ whh
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        m = mask[:, t, None]
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
        out[:, t] = h * m
    return out.to(x.dtype), hb, cb


def lstm_fused_reference(x: torch.Tensor, mask: torch.Tensor,
                         w_ih: torch.Tensor, b: torch.Tensor,
                         w_hh: torch.Tensor,
                         reverse: bool = False) -> torch.Tensor:
    """Plain PyTorch version of kernel 1 (the output of
    ``lstm_fused_res_reference``)."""
    return lstm_fused_res_reference(x, mask, w_ih, b, w_hh, reverse)[0]


def lstm_fused_bwd_reference(x, mask, w_ih, b, w_hh, hb, cb, dout,
                             reverse: bool = False, time_chunk: int = 6):
    """Plain PyTorch version of kernel 5: chunk by chunk in reverse
    processing order, recompute the forward from ``(hb, cb)`` and run the
    cell backward, in f32 with the kernel's rounding (h to the compute
    dtype before ``h @ W_hh`` and the dW_hh product; dgates before the dx,
    dh and dW products; db from the f32 dgates).  Returns ``(dx`` in x's
    dtype, ``dw_ih, db, dw_hh`` in the weights' dtype)."""
    cdt = w_hh.dtype
    B, T, E = x.shape
    H = w_hh.shape[0]
    tc = chunk_len(T, time_chunk)
    n_chunks = -(-T // tc)

    def rnd(v):
        return v.to(cdt).float()

    xf, wih, whh, bias = x.float(), w_ih.float(), w_hh.float(), b.float()
    dx = torch.zeros((B, T, E), dtype=torch.float32, device=x.device)
    dwih = torch.zeros_like(wih)
    dwhh = torch.zeros_like(whh)
    db = torch.zeros_like(bias)
    dh = torch.zeros((B, H), dtype=torch.float32, device=x.device)
    dc = torch.zeros_like(dh)
    for q in range(n_chunks):
        chunk = q if reverse else n_chunks - 1 - q
        steps = range(chunk * tc, min((chunk + 1) * tc, T))
        if reverse:
            steps = reversed(steps)
        h, c = hb[chunk].float(), cb[chunk].float()
        saved = []
        for t in steps:
            gates = xf[:, t] @ wih + rnd(h) @ whh + bias
            i, f, g, o = gates.chunk(4, dim=-1)
            i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                          torch.sigmoid(o))
            c_new = f * c + i * g
            h_new = o * torch.tanh(c_new)
            m = mask[:, t, None]
            saved.append((t, h, c, i, f, g, o, c_new, m.float()))
            h = torch.where(m, h_new, h)
            c = torch.where(m, c_new, c)
        for t, h_prev, c_prev, i, f, g, o, c_new, m in reversed(saved):
            dh_new = m * (dout[:, t].float() + dh)
            tanh_c = torch.tanh(c_new)
            do_ = dh_new * tanh_c
            dcn = m * dc + dh_new * o * (1.0 - tanh_c * tanh_c)
            dgates = torch.cat([dcn * g * i * (1.0 - i),
                                dcn * c_prev * f * (1.0 - f),
                                dcn * i * (1.0 - g * g),
                                do_ * o * (1.0 - o)], dim=-1)
            dgc = rnd(dgates)
            dx[:, t] = dgc @ wih.T
            dh = (1.0 - m) * dh + dgc @ whh.T
            dc = (1.0 - m) * dc + dcn * f
            dwih += xf[:, t].T @ dgc
            dwhh += rnd(h_prev).T @ dgc
            db += dgates.sum(0)
    return (dx.to(x.dtype), dwih.to(w_ih.dtype), db.to(b.dtype),
            dwhh.to(w_hh.dtype))


def _check_cuda_args(name: str, x, mask, w_ih, b, w_hh, *extra):
    """Dtype, shape and contiguity checks of the CUDA launchers; returns
    (B, T, E, H)."""
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype
                                     for t in (w_ih, b, w_hh)):
        raise TypeError(f"{name}: x, w_ih, b, w_hh must share one dtype, "
                        f"float32 or bfloat16; got {x.dtype}, {w_ih.dtype}, "
                        f"{b.dtype}, {w_hh.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"{name}: mask must be bool, got {mask.dtype}")
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be [B, T, E], got "
                         f"{tuple(x.shape)}")
    B, T, E = x.shape
    H = w_hh.shape[0]
    if (tuple(mask.shape) != (B, T) or tuple(w_ih.shape) != (E, 4 * H)
            or tuple(b.shape) != (4 * H,) or tuple(w_hh.shape) != (H, 4 * H)):
        raise ValueError(
            f"{name}: shapes x {tuple(x.shape)}, mask {tuple(mask.shape)}, "
            f"w_ih {tuple(w_ih.shape)}, b {tuple(b.shape)}, w_hh "
            f"{tuple(w_hh.shape)} do not form one LSTM")
    if not all(t.is_contiguous() for t in (x, mask, w_ih, b, w_hh, *extra)):
        raise ValueError(f"{name} needs contiguous tensors")
    return B, T, E, H


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def lstm_fused(x: torch.Tensor, mask: torch.Tensor, w_ih: torch.Tensor,
               b: torch.Tensor, w_hh: torch.Tensor, reverse: bool = False,
               device="cuda") -> torch.Tensor:
    """x [B, T, E], mask bool [B, T], w_ih [E, 4H], b [4H], w_hh [H, 4H]
    (one dtype, float32 or bfloat16) -> h [B, T, H] in x's dtype.

    On CUDA tensors this launches ``cair_lstm_fwd``; on CPU tensors
    (``device="cpu"``) it runs ``lstm_fused_reference``.  It computes no
    gradient: with grad mode on and an input that requires one it raises
    (``lstm_fused_train`` is the differentiable form)."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, w_ih, b, w_hh)):
        raise RuntimeError(
            "lstm_fused computes no gradient, but an input requires one; "
            "call lstm_fused_train, or run under torch.no_grad()")
    dev = resolve_device(device)
    check_on(dev, x, mask, w_ih, b, w_hh)
    if dev.type == "cpu":
        return lstm_fused_reference(x, mask, w_ih, b, w_hh, reverse)
    if dev.type != "cuda":
        raise ValueError(f"lstm_fused runs on cuda or cpu, not {dev}")
    B, T, E, H = _check_cuda_args("lstm_fused", x, mask, w_ih, b, w_hh)
    out = torch.empty((B, T, H), dtype=x.dtype, device=x.device)
    from .build import check, load_library

    # the launcher reports a hidden size or E + H its block cannot hold
    check(load_library().cair_lstm_fwd(
        x.data_ptr(), mask.data_ptr(), w_ih.data_ptr(), b.data_ptr(),
        w_hh.data_ptr(), out.data_ptr(), B, T, E, H, int(reverse),
        _DTYPES[x.dtype], _stream(x)), "cair_lstm_fwd")
    lstm_fused.launches += 1
    return out


lstm_fused.launches = 0


def lstm_fused_res(x: torch.Tensor, mask: torch.Tensor, w_ih: torch.Tensor,
                   b: torch.Tensor, w_hh: torch.Tensor, reverse: bool = False,
                   time_chunk: int = 6, device="cuda"):
    """Kernel 4: ``lstm_fused``'s output plus the chunk-boundary state,
    ``(out [B, T, H], hb, cb)`` with hb, cb float32 ``[ceil(T / tc), B,
    H]`` (``tc = chunk_len(T, time_chunk)``).  Launches
    ``cair_lstm_fwd_res`` on CUDA tensors, runs
    ``lstm_fused_res_reference`` on CPU tensors."""
    dev = resolve_device(device)
    check_on(dev, x, mask, w_ih, b, w_hh)
    if dev.type == "cpu":
        return lstm_fused_res_reference(x, mask, w_ih, b, w_hh, reverse,
                                        time_chunk)
    if dev.type != "cuda":
        raise ValueError(f"lstm_fused_res runs on cuda or cpu, not {dev}")
    B, T, E, H = _check_cuda_args("lstm_fused_res", x, mask, w_ih, b, w_hh)
    tc = chunk_len(T, time_chunk)
    out = torch.empty((B, T, H), dtype=x.dtype, device=x.device)
    hb = torch.empty((-(-T // tc), B, H), dtype=torch.float32,
                     device=x.device)
    cb = torch.empty_like(hb)
    from .build import check, load_library

    check(load_library().cair_lstm_fwd_res(
        x.data_ptr(), mask.data_ptr(), w_ih.data_ptr(), b.data_ptr(),
        w_hh.data_ptr(), out.data_ptr(), hb.data_ptr(), cb.data_ptr(), B, T,
        E, H, int(reverse), tc, _DTYPES[x.dtype], _stream(x)),
        "cair_lstm_fwd_res")
    lstm_fused_res.launches += 1
    return out, hb, cb


lstm_fused_res.launches = 0


def lstm_fused_bwd(x: torch.Tensor, mask: torch.Tensor, w_ih: torch.Tensor,
                   b: torch.Tensor, w_hh: torch.Tensor, hb: torch.Tensor,
                   cb: torch.Tensor, dout: torch.Tensor,
                   reverse: bool = False, time_chunk: int = 6,
                   device="cuda"):
    """Kernel 5: the gradients ``(dx, dw_ih, db, dw_hh)`` of
    ``lstm_fused_res`` with respect to x and the weights, given its
    ``(hb, cb)`` and ``dout = dL/d out`` (x's dtype).  Launches
    ``cair_lstm_bwd`` on CUDA tensors, runs ``lstm_fused_bwd_reference`` on
    CPU tensors."""
    dev = resolve_device(device)
    check_on(dev, x, mask, w_ih, b, w_hh, hb, cb, dout)
    if dev.type == "cpu":
        return lstm_fused_bwd_reference(x, mask, w_ih, b, w_hh, hb, cb, dout,
                                        reverse, time_chunk)
    if dev.type != "cuda":
        raise ValueError(f"lstm_fused_bwd runs on cuda or cpu, not {dev}")
    B, T, E, H = _check_cuda_args("lstm_fused_bwd", x, mask, w_ih, b, w_hh,
                                  hb, cb, dout)
    tc = chunk_len(T, time_chunk)
    n_chunks = -(-T // tc)
    if (hb.dtype != torch.float32 or cb.dtype != torch.float32
            or tuple(hb.shape) != (n_chunks, B, H)
            or tuple(cb.shape) != (n_chunks, B, H)):
        raise ValueError(f"lstm_fused_bwd: hb, cb must be float32 "
                         f"{(n_chunks, B, H)}; got {hb.dtype} "
                         f"{tuple(hb.shape)}, {cb.dtype} {tuple(cb.shape)}")
    if dout.dtype != x.dtype or tuple(dout.shape) != (B, T, H):
        raise ValueError(f"lstm_fused_bwd: dout must be {x.dtype} "
                         f"{(B, T, H)}; got {dout.dtype} {tuple(dout.shape)}")
    from .build import check, load_library

    lib = load_library()
    dtype = _DTYPES[x.dtype]
    n_bytes = lib.cair_lstm_bwd_workspace(B, T, E, H, tc, dtype)
    if n_bytes < 0:
        raise ValueError(f"lstm_fused_bwd: invalid shape B={B} T={T} E={E} "
                         f"H={H}")
    workspace = torch.empty((n_bytes,), dtype=torch.uint8, device=x.device)
    # transposed weights for the dx and dh products (coalesced reads)
    w_ih_t, w_hh_t = w_ih.t().contiguous(), w_hh.t().contiguous()
    dx = torch.empty_like(x)
    dw_ih, db, dw_hh = (torch.empty_like(w_ih), torch.empty_like(b),
                        torch.empty_like(w_hh))
    check(lib.cair_lstm_bwd(
        x.data_ptr(), mask.data_ptr(), w_ih.data_ptr(), b.data_ptr(),
        w_hh.data_ptr(), w_ih_t.data_ptr(), w_hh_t.data_ptr(), hb.data_ptr(),
        cb.data_ptr(), dout.data_ptr(), dx.data_ptr(), dw_ih.data_ptr(),
        db.data_ptr(), dw_hh.data_ptr(), workspace.data_ptr(), B, T, E, H,
        int(reverse), tc, dtype, _stream(x)), "cair_lstm_bwd")
    lstm_fused_bwd.launches += 1
    return dx, dw_ih, db, dw_hh


lstm_fused_bwd.launches = 0


class LSTMFusedTrain(torch.autograd.Function):
    """Differentiable fused LSTM: kernel 4 forward saving ``(x, mask, w_ih,
    b, w_hh, hb, cb)``, kernel 5 backward returning ``(dx, None, dw_ih, db,
    dw_hh)`` (the ``_fused_fwd`` / ``_fused_bwd`` pair of the JAX
    ``lstm_pallas_fused``)."""

    @staticmethod
    def forward(ctx, x, mask, w_ih, b, w_hh, reverse, time_chunk, device):
        out, hb, cb = lstm_fused_res(x, mask, w_ih, b, w_hh, reverse,
                                     time_chunk, device)
        ctx.save_for_backward(x, mask, w_ih, b, w_hh, hb, cb)
        ctx.args = (reverse, time_chunk, device)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, mask, w_ih, b, w_hh, hb, cb = ctx.saved_tensors
        reverse, time_chunk, device = ctx.args
        dx, dw_ih, db, dw_hh = lstm_fused_bwd(
            x, mask, w_ih, b, w_hh, hb, cb, dout.to(x.dtype).contiguous(),
            reverse, time_chunk, device)
        return dx, None, dw_ih, db, dw_hh, None, None, None


def lstm_fused_train(x: torch.Tensor, mask: torch.Tensor, w_ih: torch.Tensor,
                     b: torch.Tensor, w_hh: torch.Tensor,
                     reverse: bool = False, time_chunk: int = 6,
                     device="cuda") -> torch.Tensor:
    """``lstm_fused``'s output with gradients for x, w_ih, b and w_hh,
    through kernels 4 and 5 (their plain versions on CPU tensors)."""
    return LSTMFusedTrain.apply(x, mask, w_ih, b, w_hh, reverse, time_chunk,
                                device)
