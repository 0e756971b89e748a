"""Fused masked LSTM kernels: forward (kernel 1), training forward with
chunk-boundary residuals (kernel 4), chunked-remat backward (kernel 5), and
the recurrence on precomputed gates (kernel 6, at the end of the file).
Each has its CUDA launcher, its plain PyTorch version and a launch count.

Kernel 1, ``lstm_fused``, replaces the TPU kernel ``_lstm_fused_kernel``
(``_lstm_fused_impl``) in ``context_attentive_ir_tpu/ops/pallas/lstm.py``
(``csrc/lstm_fwd.cu``): the input projection ``x_t @ W_ih`` is computed
inside the kernel, so the ``[B, T, 4H]`` gates never reach device memory.
It computes no gradient and refuses inputs that need one.

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
bf16 tensor-core peak; kernel 5 5.7e11 flops, 0.57 ms: all bound by
operations, through T steps that depend on each other.

What the design does about it, in bfloat16 (the type every full-width path
runs): every product -- ``[x_t | h] @ [W_ih; W_hh]``, ``dgates @ W^T`` and
the two ``dW`` reductions -- is ``mma.sync.m16n8k16`` tiles (bf16 in, f32
accumulate) on operands staged in shared memory in bf16
(``csrc/lstm_mma.cuh``): a block of 8 warps owns 64 rows for all T steps,
the weights (``stage_lstm_weights``: one padded matrix a call) stream from
L2 through a ring of bulk copies, and a thread's
accumulator fragments are the four gates of its own (row, unit) cells, so
c, dh and dc stay in registers.  Those kernels take E and H that are
multiples of 32 and 16-byte aligned tensors; ``pad_lstm_operands`` zero-pads
other sizes here (zero weights and biases keep a padded unit at exactly 0),
and the results are cut back.  float32 keeps exact f32 FMAs (no TF32) on
the first version's one-thread-per-unit layout.  ``fused_supported`` states
the shapes each dtype's kernels hold; ``PERF.md`` records times and bounds.
"""

from __future__ import annotations

import torch

from ...device import check_on, resolve_device

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# -- the shapes the CUDA kernels hold (csrc/lstm_mma.cuh, lstm_common.cuh) ----
SMEM_LIMIT = 232448   # dynamic shared memory a block may use on sm_90
TILE_ALIGN = 32       # the bf16 kernels' E and H are multiples of this
MAX_HIDDEN_BF16 = 512
F32_STRIDE = 36       # floats per staged k-row of the float32 kernels


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def tile_config(hidden: int) -> tuple[int, int]:
    """(unit groups per warp, 16-row tiles per block) of the bf16 kernels
    for a padded hidden size (``pick_config`` in ``csrc/lstm_mma.cuh``)."""
    if hidden <= 64:
        return 1, 4
    if hidden <= 128:
        return 2, 4
    if hidden <= 256:
        return 4, 2
    return 8, 1


def tile_smem_bytes(e: int, h: int, backward: bool = False,
                    gates: int = 4, rows: int | None = None) -> int:
    """Dynamic shared memory of the bf16 forward or backward phase A kernel
    at padded widths ``e``, ``h`` with ``gates`` gate blocks (4: the LSTM,
    3: the GRU) and ``rows`` rows a block (default: ``tile_config``'s): the
    ring's mbarriers (64 bytes), its three slabs of 32 (else 16) k-rows, the
    staged tiles, the bias (four f32 slots of H); 0 if neither depth fits
    (``mma_smem`` in ``csrc/lstm_mma.cuh``).  A backward's gradient tile has
    four slots of H whatever the gate count (the GRU's da_r, da_z, da_n,
    da_n * r) and takes the place of the forward's tiles, beside the f32
    tile dh returns through: after that union in the LSTM's kernel 5,
    inside it in the GRU's kernel 9."""
    m = rows or 16 * tile_config(h)[1]
    x_row, h_row, w_row = 2 * e + 16, 2 * h + 16, 2 * gates * h + 16
    tiles = 2 * m * x_row + m * h_row
    if backward:
        slots, exch = m * (8 * h + 16), m * (h + 8) * 4
        tiles = (max(tiles, slots) + exch if gates == 4
                 else max(tiles, slots + exch))
    for depth in (32, 16):
        n_bytes = 64 + 3 * depth * w_row + tiles + 16 * h
        if n_bytes <= SMEM_LIMIT:
            return n_bytes
    return 0


def fused_supported(embed: int, hidden: int, rows: int,
                    dtype: torch.dtype = torch.float32) -> bool:
    """Whether kernels 1, 4 and 5 hold an ``[rows, T, embed] -> hidden``
    LSTM in ``dtype`` (the counterpart of the JAX ``fused_supported``, with
    this card's limits).  bfloat16: after padding to multiples of 32,
    ``hidden <= 512`` and the backward's tiles fit a block's shared memory.
    float32: a block has ``2 * hidden <= 1024`` threads and stages
    ``max(embed + hidden, 4 * hidden)`` k-rows of 36 floats."""
    if embed < 1 or hidden < 1 or rows < 1:
        return False
    if dtype == torch.bfloat16:
        e, h = _round_up(embed, TILE_ALIGN), _round_up(hidden, TILE_ALIGN)
        return (h <= MAX_HIDDEN_BF16
                and tile_smem_bytes(e, h, backward=True) > 0)
    if dtype == torch.float32:
        return (2 * hidden <= 1024
                and max(embed + hidden, 4 * hidden) * F32_STRIDE * 4
                <= SMEM_LIMIT)
    return False


def _pad_last(t: torch.Tensor, size: int) -> torch.Tensor:
    if t.shape[-1] == size:
        return t
    return torch.nn.functional.pad(t, (0, size - t.shape[-1]))


def _pad_gates(w: torch.Tensor, h: int, hp: int,
               gates: int = 4) -> torch.Tensor:
    """``[..., gates * h]`` (gate blocks: i, f, g, o for the LSTM, r, z, n
    for the GRU) -> ``[..., gates * hp]``, each block zero-padded."""
    if h == hp:
        return w
    lead = w.shape[:-1]
    return _pad_last(w.reshape(*lead, gates, h), hp).reshape(*lead,
                                                             gates * hp)


def _cut_gates(w: torch.Tensor, h: int, hp: int,
               gates: int = 4) -> torch.Tensor:
    """The inverse of ``_pad_gates``."""
    if h == hp:
        return w
    lead = w.shape[:-1]
    return w.reshape(*lead, gates, hp)[..., :h].reshape(*lead, gates * h)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (a copy if it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def pad_operands(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                 biases, gates: int):
    """``(x, w_ih, w_hh, *biases)`` of a recurrence with ``gates`` gate
    blocks, E and H zero-padded up to multiples of ``TILE_ALIGN`` (``x [B,
    T, Ep]``, ``w_ih [Ep, gates * Hp]``, ``w_hh [Hp, gates * Hp]``, each
    bias ``[gates * Hp]``), every tensor 16-byte aligned; aligned operands
    come back as they are (no copy).  ``pad_lstm_operands`` and
    ``pad_gru_operands`` state why the padding is exact."""
    e, h = x.shape[-1], w_hh.shape[0]
    ep, hp = _round_up(e, TILE_ALIGN), _round_up(h, TILE_ALIGN)
    x = _pad_last(x, ep)
    w_ih = _pad_gates(w_ih, h, hp, gates)
    if ep != e:
        w_ih = torch.nn.functional.pad(w_ih, (0, 0, 0, ep - e))
    w_hh = _pad_gates(w_hh, h, hp, gates)
    if hp != h:
        w_hh = torch.nn.functional.pad(w_hh, (0, 0, 0, hp - h))
    biases = [_pad_gates(b, h, hp, gates) for b in biases]
    return tuple(_aligned(t) for t in (x, w_ih, w_hh, *biases))


def pad_lstm_operands(x: torch.Tensor, w_ih: torch.Tensor, b: torch.Tensor,
                      w_hh: torch.Tensor):
    """The operands of an LSTM with E and H zero-padded up to multiples of
    ``TILE_ALIGN``:
    ``x [B, T, Ep]``, ``w_ih [Ep, 4Hp]``, ``b [4Hp]``, ``w_hh [Hp, 4Hp]``,
    every tensor 16-byte aligned.  The padded LSTM's first H units equal the
    original's: a padded unit has zero weights and bias, so its gates are 0,
    its c and h stay exactly 0 and it feeds nothing back; its gradients are
    0.  Aligned operands come back as they are (no copy)."""
    x, w_ih, w_hh, b = pad_operands(x, w_ih, w_hh, (b,), 4)
    return x, w_ih, b, w_hh


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


def stage_lstm_weights(w_ih: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """``[W_ih; W_hh]`` as the bf16 kernels' weight ring copies it: one
    contiguous ``[E + H, G + 8]`` matrix (G = 4H for the LSTM, 3H for the
    GRU), each row followed by 8 zero columns (the 16 bytes of padding a
    staged row has in shared memory), so a slab of k-rows is one contiguous
    range (~400 KB a call at the main path's LSTM widths)."""
    return _aligned(torch.nn.functional.pad(torch.cat([w_ih, w_hh], 0),
                                            (0, 8)))


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
    if x.dtype == torch.bfloat16:
        x, w_ih, b, w_hh = pad_lstm_operands(x, w_ih, b, w_hh)
    Ep, Hp = x.shape[-1], w_hh.shape[0]
    if x.dtype == torch.bfloat16:
        w_ih = stage_lstm_weights(w_ih, w_hh)
    out = torch.empty((B, T, Hp), dtype=x.dtype, device=x.device)
    from .build import check, load_library

    # the launcher reports a hidden size or E + H its block cannot hold
    check(load_library().cair_lstm_fwd(
        x.data_ptr(), mask.data_ptr(), w_ih.data_ptr(), b.data_ptr(),
        w_hh.data_ptr(), out.data_ptr(), B, T, Ep, Hp, int(reverse),
        _DTYPES[x.dtype], _stream(x)), "cair_lstm_fwd")
    lstm_fused.launches += 1
    return out if Hp == H else out[..., :H].contiguous()


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
    if x.dtype == torch.bfloat16:
        x, w_ih, b, w_hh = pad_lstm_operands(x, w_ih, b, w_hh)
    Ep, Hp = x.shape[-1], w_hh.shape[0]
    if x.dtype == torch.bfloat16:
        w_ih = stage_lstm_weights(w_ih, w_hh)
    out = torch.empty((B, T, Hp), dtype=x.dtype, device=x.device)
    hb = torch.empty((-(-T // tc), B, Hp), dtype=torch.float32,
                     device=x.device)
    cb = torch.empty_like(hb)
    from .build import check, load_library

    check(load_library().cair_lstm_fwd_res(
        x.data_ptr(), mask.data_ptr(), w_ih.data_ptr(), b.data_ptr(),
        w_hh.data_ptr(), out.data_ptr(), hb.data_ptr(), cb.data_ptr(), B, T,
        Ep, Hp, int(reverse), tc, _DTYPES[x.dtype], _stream(x)),
        "cair_lstm_fwd_res")
    lstm_fused_res.launches += 1
    if Hp != H:
        out, hb, cb = (t[..., :H].contiguous() for t in (out, hb, cb))
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
    if x.dtype == torch.bfloat16:
        # the tensor-core kernels read W^T out of the staged W's own slabs
        x, w_ih, b, w_hh = pad_lstm_operands(x, w_ih, b, w_hh)
        Hp = w_hh.shape[0]
        hb, cb, dout = (_aligned(_pad_last(t, Hp)) for t in (hb, cb, dout))
        staged = stage_lstm_weights(w_ih, w_hh)
        transposes = (0, 0)
    else:
        # float32: transposed weights for the dx and dh products
        w_ih_t, w_hh_t = w_ih.t().contiguous(), w_hh.t().contiguous()
        transposes = (w_ih_t.data_ptr(), w_hh_t.data_ptr())
    Ep, Hp = x.shape[-1], w_hh.shape[0]
    n_bytes = lib.cair_lstm_bwd_workspace(B, T, Ep, Hp, tc, dtype)
    if n_bytes < 0:
        raise ValueError(f"lstm_fused_bwd: invalid shape B={B} T={T} E={E} "
                         f"H={H}")
    workspace = torch.empty((n_bytes,), dtype=torch.uint8, device=x.device)
    dx = torch.empty_like(x)
    dw_ih, db, dw_hh = (torch.empty_like(w_ih), torch.empty_like(b),
                        torch.empty_like(w_hh))
    check(lib.cair_lstm_bwd(
        x.data_ptr(), mask.data_ptr(),
        (staged if x.dtype == torch.bfloat16 else w_ih).data_ptr(),
        b.data_ptr(), w_hh.data_ptr(), *transposes, hb.data_ptr(),
        cb.data_ptr(), dout.data_ptr(), dx.data_ptr(), dw_ih.data_ptr(),
        db.data_ptr(), dw_hh.data_ptr(), workspace.data_ptr(), B, T, Ep, Hp,
        int(reverse), tc, dtype, _stream(x)), "cair_lstm_bwd")
    lstm_fused_bwd.launches += 1
    if (Ep, Hp) != (E, H):
        dx = dx[..., :E].contiguous()
        dw_ih = _cut_gates(dw_ih[:E], H, Hp).contiguous()
        db = _cut_gates(db, H, Hp).contiguous()
        dw_hh = _cut_gates(dw_hh[:H], H, Hp).contiguous()
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


# -- kernel 6: the recurrence on precomputed gates ---------------------------
#
# ``lstm_recurrence`` replaces the TPU kernel ``_lstm_kernel``
# (``_lstm_pallas_fwd_impl``, the ``lstm_pallas`` forward): the input
# projection ``x @ W_ih + b`` is one matmul outside, the kernel
# (``csrc/lstm_rec.cu``) reads it as ``x_proj [B, T, 4H]`` and runs the serial
# part.  Bound on the H100 at the doc-encoder shape (B = 16000, T = 30,
# H = 128, bf16): 614 MB read and written, 0.18 ms at 3.35 TB/s, against
# 6.3e10 flops (0.064 ms): bound by bytes.

def lstm_recurrence_reference(x_proj: torch.Tensor, mask: torch.Tensor,
                              w_hh: torch.Tensor,
                              reverse: bool = False) -> torch.Tensor:
    """Plain PyTorch version of kernel 6: a masked time loop from a zero
    state on gates ``f32(x_proj[:, t]) + h @ W_hh``, h rounded to
    ``w_hh``'s dtype before the product, f32 gates and state.  Returns
    ``out [B, T, H]`` in ``x_proj``'s dtype, zero where ``mask`` is False."""
    B, T, G = x_proj.shape
    H = G // 4
    whh = w_hh.float()
    h = torch.zeros((B, H), dtype=torch.float32, device=x_proj.device)
    c = torch.zeros_like(h)
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = x_proj[:, t].float() + h.to(w_hh.dtype).float() @ whh
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        m = mask[:, t, None]
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
        outs[t] = h * m
    return torch.stack(outs, dim=1).to(x_proj.dtype)


def _check_rec_args(x_proj, mask, w_hh):
    """Dtype, shape and contiguity checks of kernel 6's launcher; returns
    (B, T, H)."""
    if x_proj.dtype not in _DTYPES or w_hh.dtype != x_proj.dtype:
        raise TypeError("lstm_recurrence: x_proj and w_hh must share one "
                        f"dtype, float32 or bfloat16; got {x_proj.dtype}, "
                        f"{w_hh.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"lstm_recurrence: mask must be bool, got "
                        f"{mask.dtype}")
    if x_proj.dim() != 3:
        raise ValueError("lstm_recurrence: x_proj must be [B, T, 4H], got "
                         f"{tuple(x_proj.shape)}")
    B, T, G = x_proj.shape
    H = G // 4
    if (G != 4 * H or tuple(mask.shape) != (B, T)
            or tuple(w_hh.shape) != (H, G)):
        raise ValueError(
            f"lstm_recurrence: shapes x_proj {tuple(x_proj.shape)}, mask "
            f"{tuple(mask.shape)}, w_hh {tuple(w_hh.shape)} do not form one "
            "LSTM")
    if H % 128 != 0:
        raise ValueError("lstm_recurrence: the kernel needs a hidden size "
                         f"that is a multiple of 128, got H={H}")
    if not all(t.is_contiguous() for t in (x_proj, mask, w_hh)):
        raise ValueError("lstm_recurrence needs contiguous tensors")
    return B, T, H


def lstm_recurrence_fwd(x_proj: torch.Tensor, mask: torch.Tensor,
                        w_hh: torch.Tensor, reverse: bool = False,
                        device="cuda") -> torch.Tensor:
    """Kernel 6 without a gradient: launches ``cair_lstm_rec`` on CUDA
    tensors, runs ``lstm_recurrence_reference`` on CPU tensors
    (``device="cpu"``)."""
    dev = resolve_device(device)
    check_on(dev, x_proj, mask, w_hh)
    if dev.type == "cpu":
        return lstm_recurrence_reference(x_proj, mask, w_hh, reverse)
    if dev.type != "cuda":
        raise ValueError(f"lstm_recurrence runs on cuda or cpu, not {dev}")
    B, T, H = _check_rec_args(x_proj, mask, w_hh)
    out = torch.empty((B, T, H), dtype=x_proj.dtype, device=x_proj.device)
    from .build import check, load_library

    # the launcher reports a hidden size its block cannot hold
    check(load_library().cair_lstm_rec(
        x_proj.data_ptr(), mask.data_ptr(), w_hh.data_ptr(), out.data_ptr(),
        B, T, H, int(reverse), _DTYPES[x_proj.dtype], _stream(x_proj)),
        "cair_lstm_rec")
    lstm_recurrence.launches += 1
    return out


class LSTMRecurrenceFn(torch.autograd.Function):
    """Differentiable kernel 6: ``lstm_recurrence_fwd`` forward; the backward
    replays autograd of ``lstm_recurrence_reference`` on the saved inputs
    (the JAX ``lstm_pallas`` custom_vjp, whose ``_bwd`` takes ``jax.vjp`` of
    the reference) and returns ``(dx_proj, None, dw_hh)``."""

    @staticmethod
    def forward(ctx, x_proj, mask, w_hh, reverse, device):
        ctx.save_for_backward(x_proj, mask, w_hh)
        ctx.reverse = reverse
        return lstm_recurrence_fwd(x_proj, mask, w_hh, reverse, device)

    @staticmethod
    def backward(ctx, g):
        x_proj, mask, w_hh = ctx.saved_tensors
        inputs = [t.detach().requires_grad_() for t in (x_proj, w_hh)]
        with torch.enable_grad():
            out = lstm_recurrence_reference(inputs[0], mask, inputs[1],
                                            ctx.reverse)
        dxp, dwhh = torch.autograd.grad(out, inputs, g.to(out.dtype))
        return dxp, None, dwhh, None, None


def lstm_recurrence(x_proj: torch.Tensor, mask: torch.Tensor,
                    w_hh: torch.Tensor, reverse: bool = False,
                    device="cuda") -> torch.Tensor:
    """x_proj [B, T, 4H] (``x @ W_ih + b``, gate order i, f, g, o), mask bool
    [B, T], w_hh [H, 4H] (one dtype, float32 or bfloat16; H a multiple of
    128) -> h [B, T, H] in that dtype, from a zero state.

    The counterpart of the JAX ``lstm_pallas``: kernel 6 on CUDA tensors,
    its plain version on CPU tensors (``device="cpu"``), differentiable in
    ``x_proj`` and ``w_hh`` (``LSTMRecurrenceFn``).  ``launches`` counts the
    kernel's launches."""
    return LSTMRecurrenceFn.apply(x_proj, mask, w_hh, reverse, device)


lstm_recurrence.launches = 0
