"""Fused masked GRU kernels: forward (kernel 7), training forward with
chunk-boundary residuals (kernel 8), chunked-remat backward (kernel 9).
Each has its CUDA launcher, its plain PyTorch version and a launch count.

Gate order and semantics are torch's, as in the JAX kernels: r, z, n with
``n = tanh(x_n + r * (h @ W_hn + b_hn))`` -- the recurrent bias ``b_hh``
stays separate because ``r`` multiplies it in the n slot.

Kernel 7, ``gru_fused``, replaces the TPU kernel ``_gru_fused_kernel``
(``_gru_fused_impl``) in ``context_attentive_ir_tpu/ops/pallas/gru.py``
(``csrc/gru_fwd.cu``): the input projection ``x_t @ W_ih`` is computed
inside the kernel, so the ``[B, T, 3H]`` gates never reach device memory.
It computes no gradient and refuses inputs that need one.

Kernels 8 and 9 are the training pair behind ``gru_fused_train``, the
counterpart of the ``gru_pallas_fused`` custom_vjp:

- ``gru_fused_res`` (kernel 8, ``csrc/gru_fwd.cu``) replaces
  ``_gru_fused_res_kernel``: kernel 7 plus the carried h before every
  chunk of ``time_chunk`` steps in processing order, float32
  ``[n_chunks, B, H]``.
- ``gru_fused_bwd`` (kernel 9, ``csrc/gru_bwd.cu``) replaces
  ``_gru_fused_bwd_kernel``: per chunk in reverse, recompute the forward
  from its boundary and run the cell backward, then reduce ``dW_ih``,
  ``db_ih``, ``dW_hh`` and ``db_hh`` over all rows and steps in a second,
  fixed-order pass (no atomics: the same bits every run).  The ih and hh
  gate gradients differ in the n slot: ``[da_r, da_z, da_n]`` against
  ``[da_r, da_z, da_n * r]``.

Bounds on the H100 (doc encoder, one direction, [16000, 30, 256] -> 128,
bf16): kernels 7 and 8 do 2*B*T*(E+H)*3H = 1.42e11 flops, 0.143 ms at the
bf16 tensor-core peak; kernel 9 4.25e11 flops, 0.429 ms: all bound by
operations, through T steps that depend on each other.

What the design does about it, in bfloat16 (the type every full-width path
runs): kernels 7 and 8 run ``[x_t | h] @ [W_ih; W_hh]`` as
``mma.sync.m16n8k16`` tiles (bf16 in, f32 accumulate) on the LSTM's tiles
(``csrc/lstm_mma.cuh`` with three gate blocks): a block of 8 warps owns 64
rows for all T steps, the weights (``stage_lstm_weights``, ``[E + H, 3H +
8]``) stream from L2 through a ring of bulk copies, and a thread keeps four
f32 slots per (row, unit) -- r and z from every slab, the n gate's
``x @ W_in`` and ``h @ W_hn`` apart, since r multiplies only the second --
with h carried in f32 registers.  Kernel 9's phase A runs on the same
tiles as the LSTM's kernel 5: the recompute is kernel 8's step, and the
four gradient slots ``[da_r, da_z, da_n, da_n * r]``, rounded to bf16 in
one staged ``[M, 4H]`` tile, multiply the same weight slabs read
untransposed (``dx_t`` = slots 0..2 @ ``W_ih^T``, the product in ``dh`` =
slots 0, 1, 3 @ ``W_hh^T``); its blocks take 16 rows where the tiles' own
64 would leave most of the card idle (``bwd_row_tiles``); phase B is
tensor-core tiles too.  Those kernels take E and H that are multiples of
32 and 16-byte aligned tensors; ``pad_gru_operands`` zero-pads other sizes
here (a padded unit has r = z = 1/2 and n = 0, so its h stays exactly 0
and its gradients are 0) and the results are cut back.  float32 keeps the
first version's layout: one thread block per 32 rows, a thread per hidden
unit of 16 rows, ``[x_t | h]`` staged in f32, exact f32 FMAs, the weights
read through L2.  ``gru_fused_supported`` states the shapes each dtype's
kernels hold; ``PERF.md`` records times and bounds.
"""

from __future__ import annotations

import torch

from ...device import check_on, resolve_device
from .lstm import (
    _DTYPES,
    F32_STRIDE,
    MAX_HIDDEN_BF16,
    SMEM_LIMIT,
    TILE_ALIGN,
    _aligned,
    _cut_gates,
    _first_in_chunk,
    _pad_last,
    _round_up,
    _stream,
    chunk_len,
    pad_operands,
    stage_lstm_weights,
    tile_config,
    tile_smem_bytes,
)

GATES = 3  # r, z, n


def gru_fused_supported(embed: int, hidden: int, rows: int,
                        dtype: torch.dtype = torch.float32) -> bool:
    """Whether kernels 7, 8 and 9 hold an ``[rows, T, embed] -> hidden`` GRU
    in ``dtype`` (the counterpart of the JAX ``gru_fused_supported``, with
    this card's limits).  float32: a block has ``2 * hidden <= 1024``
    threads and stages ``max(embed + hidden, 4 * hidden)`` k-rows of 36
    floats in shared memory (kernel 9's four gradient slots are the wider
    tile).  bfloat16: after padding to multiples of 32, ``hidden <= 512``
    and kernel 9's tensor-core tiles fit a block's shared memory -- its
    four-slot gradient tile and dh exchange beside the forward's tiles, so
    the forward's fit too (E <= 672 at H = 128, as the forward; H <= 448 at
    E = 256)."""
    if embed < 1 or hidden < 1 or rows < 1 or dtype not in _DTYPES:
        return False
    if dtype == torch.float32:
        return (2 * hidden <= 1024
                and max(embed + hidden, 4 * hidden) * F32_STRIDE * 4
                <= SMEM_LIMIT)
    e, h = _round_up(embed, TILE_ALIGN), _round_up(hidden, TILE_ALIGN)
    return (h <= MAX_HIDDEN_BF16
            and tile_smem_bytes(e, h, backward=True, gates=GATES) > 0)


# kernel 9's bf16 blocks take 16 rows when the tiles' own rows a block
# would give fewer blocks than one H100 has SMs (``bwd_row_tiles`` in
# ``csrc/gru_bwd.cu``)
SMALL_GRID = 132


def bwd_row_tiles(hidden: int, rows: int) -> int:
    """16-row tiles a block of kernel 9's bf16 phase A takes for ``rows``
    rows at a padded ``hidden`` size: ``tile_config``'s, unless that gives
    fewer than ``SMALL_GRID`` blocks; then 1."""
    own = tile_config(hidden)[1]
    return 1 if -(-rows // (16 * own)) < SMALL_GRID else own


def pad_gru_operands(x: torch.Tensor, w_ih: torch.Tensor, b_ih: torch.Tensor,
                     w_hh: torch.Tensor, b_hh: torch.Tensor):
    """The operands of a GRU with E and H zero-padded up to multiples of
    ``TILE_ALIGN``: ``x [B, T, Ep]``, ``w_ih [Ep, 3Hp]``, ``b_ih [3Hp]``,
    ``w_hh [Hp, 3Hp]``, ``b_hh [3Hp]``, every tensor 16-byte aligned.  The
    padded GRU's first H units equal the original's: a padded unit has zero
    weights and biases, so r = z = 1/2 and n = 0, its h stays exactly 0 from
    the zero start and it feeds nothing back.  Aligned operands come back as
    they are (no copy)."""
    x, w_ih, w_hh, b_ih, b_hh = pad_operands(x, w_ih, w_hh, (b_ih, b_hh),
                                             GATES)
    return x, w_ih, b_ih, w_hh, b_hh


def _cell(xp: torch.Tensor, hp: torch.Tensor, h: torch.Tensor):
    """One GRU step in f32 from ``xp = x @ W_ih + b_ih`` and ``hp = h_c @
    W_hh + b_hh``: returns (h_new, r, z, n, hn)."""
    xr, xz, xn = xp.chunk(3, dim=-1)
    hr, hz, hn = hp.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h, r, z, n, hn


def gru_fused_res_reference(x: torch.Tensor, mask: torch.Tensor,
                            w_ih: torch.Tensor, b_ih: torch.Tensor,
                            w_hh: torch.Tensor, b_hh: torch.Tensor,
                            reverse: bool = False, time_chunk: int = 6):
    """Plain PyTorch version of kernels 7 and 8: a masked time loop on
    ``x @ W_ih + b_ih`` in f32, with h rounded to x's dtype before
    ``h @ W_hh`` (plus ``b_hh`` in f32) as in the kernels.  Returns ``(out
    [B, T, H]`` in x's dtype, zero where ``mask`` is False, ``hb)``: float32
    ``[ceil(T / tc), B, H]``, h before each chunk of ``tc`` steps in
    processing order (zeros for the first chunk processed)."""
    B, T, _ = x.shape
    H = w_hh.shape[0]
    tc = chunk_len(T, time_chunk)
    xp = x.float() @ w_ih.float() + b_ih.float()
    whh, bhh = w_hh.float(), b_hh.float()
    h = torch.zeros((B, H), dtype=torch.float32, device=x.device)
    out = torch.zeros((B, T, H), dtype=torch.float32, device=x.device)
    hb = torch.zeros((-(-T // tc), B, H), dtype=torch.float32,
                     device=x.device)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        if _first_in_chunk(t, T, tc, reverse):
            hb[t // tc] = h
        h_new = _cell(xp[:, t], h.to(x.dtype).float() @ whh + bhh, h)[0]
        m = mask[:, t, None]
        h = torch.where(m, h_new, h)
        out[:, t] = h * m
    return out.to(x.dtype), hb


def gru_fused_reference(x: torch.Tensor, mask: torch.Tensor,
                        w_ih: torch.Tensor, b_ih: torch.Tensor,
                        w_hh: torch.Tensor, b_hh: torch.Tensor,
                        reverse: bool = False) -> torch.Tensor:
    """Plain PyTorch version of kernel 7 (the output of
    ``gru_fused_res_reference``)."""
    return gru_fused_res_reference(x, mask, w_ih, b_ih, w_hh, b_hh,
                                   reverse)[0]


def gru_fused_bwd_reference(x, mask, w_ih, b_ih, w_hh, b_hh, hb, dout,
                            reverse: bool = False, time_chunk: int = 6):
    """Plain PyTorch version of kernel 9: chunk by chunk in reverse
    processing order, recompute the forward from ``hb`` and run the cell
    backward, in f32 with the kernel's rounding (h to the compute dtype
    before ``h @ W_hh`` and the dW_hh product; the gate gradients before
    the dx, dh and dW products; db from the f32 gate gradients).  Returns
    ``(dx`` in x's dtype, ``dw_ih, db_ih, dw_hh, db_hh`` in the weights'
    dtype) -- the JAX kernel's order."""
    cdt = w_hh.dtype
    B, T, E = x.shape
    H = w_hh.shape[0]
    tc = chunk_len(T, time_chunk)
    n_chunks = -(-T // tc)

    def rnd(v):
        return v.to(cdt).float()

    xf, wih, whh = x.float(), w_ih.float(), w_hh.float()
    bih, bhh = b_ih.float(), b_hh.float()
    dx = torch.zeros((B, T, E), dtype=torch.float32, device=x.device)
    dwih, dwhh = torch.zeros_like(wih), torch.zeros_like(whh)
    dbih, dbhh = torch.zeros_like(bih), torch.zeros_like(bhh)
    dh = torch.zeros((B, H), dtype=torch.float32, device=x.device)
    for q in range(n_chunks):
        chunk = q if reverse else n_chunks - 1 - q
        steps = range(chunk * tc, min((chunk + 1) * tc, T))
        if reverse:
            steps = reversed(steps)
        h = hb[chunk].float()
        saved = []
        for t in steps:
            h_new, r, z, n, hn = _cell(xf[:, t] @ wih + bih,
                                       rnd(h) @ whh + bhh, h)
            m = mask[:, t, None]
            saved.append((t, h, r, z, n, hn, m.float()))
            h = torch.where(m, h_new, h)
        for t, h_prev, r, z, n, hn, m in reversed(saved):
            dh_new = m * (dout[:, t].float() + dh)
            dh = (1.0 - m) * dh + dh_new * z
            dz = dh_new * (h_prev - n)
            da_n = dh_new * (1.0 - z) * (1.0 - n * n)
            da_r = da_n * hn * r * (1.0 - r)
            da_z = dz * z * (1.0 - z)
            dg_ih = torch.cat([da_r, da_z, da_n], dim=-1)
            dg_hh = torch.cat([da_r, da_z, da_n * r], dim=-1)
            dg_ih_c, dg_hh_c = rnd(dg_ih), rnd(dg_hh)
            dx[:, t] = dg_ih_c @ wih.T
            dh = dh + dg_hh_c @ whh.T
            dwih += xf[:, t].T @ dg_ih_c
            dwhh += rnd(h_prev).T @ dg_hh_c
            dbih += dg_ih.sum(0)
            dbhh += dg_hh.sum(0)
    return (dx.to(x.dtype), dwih.to(w_ih.dtype), dbih.to(b_ih.dtype),
            dwhh.to(w_hh.dtype), dbhh.to(b_hh.dtype))


def _check_cuda_args(name: str, x, mask, w_ih, b_ih, w_hh, b_hh, *extra):
    """Dtype, shape and contiguity checks of the CUDA launchers; returns
    (B, T, E, H)."""
    weights = (w_ih, b_ih, w_hh, b_hh)
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in weights):
        raise TypeError(f"{name}: x, w_ih, b_ih, w_hh, b_hh must share one "
                        f"dtype, float32 or bfloat16; got {x.dtype}, "
                        + ", ".join(str(t.dtype) for t in weights))
    if mask.dtype != torch.bool:
        raise TypeError(f"{name}: mask must be bool, got {mask.dtype}")
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be [B, T, E], got "
                         f"{tuple(x.shape)}")
    B, T, E = x.shape
    H = w_hh.shape[0]
    if (tuple(mask.shape) != (B, T) or tuple(w_ih.shape) != (E, 3 * H)
            or tuple(b_ih.shape) != (3 * H,)
            or tuple(w_hh.shape) != (H, 3 * H)
            or tuple(b_hh.shape) != (3 * H,)):
        raise ValueError(
            f"{name}: shapes x {tuple(x.shape)}, mask {tuple(mask.shape)}, "
            f"w_ih {tuple(w_ih.shape)}, b_ih {tuple(b_ih.shape)}, w_hh "
            f"{tuple(w_hh.shape)}, b_hh {tuple(b_hh.shape)} do not form one "
            "GRU")
    if not all(t.is_contiguous() for t in (x, mask, *weights, *extra)):
        raise ValueError(f"{name} needs contiguous tensors")
    return B, T, E, H


def _pointers(*tensors):
    return [t.data_ptr() for t in tensors]


def _tile_operands(x, w_ih, b_ih, w_hh, b_hh):
    """bfloat16: the operands as kernels 7 and 8's tiles take them --
    padded (``pad_gru_operands``), with the staged ``[W_ih; W_hh]`` in
    ``w_ih``'s place; float32: as they are.  Returns them and (Ep, Hp)."""
    if x.dtype == torch.bfloat16:
        x, w_ih, b_ih, w_hh, b_hh = pad_gru_operands(x, w_ih, b_ih, w_hh,
                                                     b_hh)
        w_ih = stage_lstm_weights(w_ih, w_hh)
    return (x, w_ih, b_ih, w_hh, b_hh), (x.shape[-1], w_hh.shape[0])


def gru_fused(x: torch.Tensor, mask: torch.Tensor, w_ih: torch.Tensor,
              b_ih: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
              reverse: bool = False, device="cuda") -> torch.Tensor:
    """x [B, T, E], mask bool [B, T], w_ih [E, 3H], b_ih [3H], w_hh
    [H, 3H], b_hh [3H] (one dtype, float32 or bfloat16) -> h [B, T, H] in
    x's dtype.

    On CUDA tensors this launches ``cair_gru_fwd`` (bfloat16: on operands
    padded to the tiles' multiple of 32 and the staged weights, the output
    cut back to H); on CPU tensors
    (``device="cpu"``) it runs ``gru_fused_reference``.  It computes no
    gradient: with grad mode on and an input that requires one it raises
    (``gru_fused_train`` is the differentiable form)."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, w_ih, b_ih, w_hh, b_hh)):
        raise RuntimeError(
            "gru_fused computes no gradient, but an input requires one; "
            "call gru_fused_train, or run under torch.no_grad()")
    dev = resolve_device(device)
    check_on(dev, x, mask, w_ih, b_ih, w_hh, b_hh)
    if dev.type == "cpu":
        return gru_fused_reference(x, mask, w_ih, b_ih, w_hh, b_hh, reverse)
    if dev.type != "cuda":
        raise ValueError(f"gru_fused runs on cuda or cpu, not {dev}")
    B, T, E, H = _check_cuda_args("gru_fused", x, mask, w_ih, b_ih, w_hh,
                                  b_hh)
    ops, (Ep, Hp) = _tile_operands(x, w_ih, b_ih, w_hh, b_hh)
    out = torch.empty((B, T, Hp), dtype=x.dtype, device=x.device)
    from .build import check, load_library

    # the launcher reports a hidden size or E + H its block cannot hold
    check(load_library().cair_gru_fwd(
        *_pointers(ops[0], mask, *ops[1:], out), B, T, Ep, Hp, int(reverse),
        _DTYPES[x.dtype], _stream(x)), "cair_gru_fwd")
    gru_fused.launches += 1
    return out if Hp == H else out[..., :H].contiguous()


gru_fused.launches = 0


def gru_fused_res(x: torch.Tensor, mask: torch.Tensor, w_ih: torch.Tensor,
                  b_ih: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                  reverse: bool = False, time_chunk: int = 6, device="cuda"):
    """Kernel 8: ``gru_fused``'s output plus the chunk-boundary state,
    ``(out [B, T, H], hb)`` with hb float32 ``[ceil(T / tc), B, H]``
    (``tc = chunk_len(T, time_chunk)``).  Launches ``cair_gru_fwd_res`` on
    CUDA tensors, runs ``gru_fused_res_reference`` on CPU tensors."""
    dev = resolve_device(device)
    check_on(dev, x, mask, w_ih, b_ih, w_hh, b_hh)
    if dev.type == "cpu":
        return gru_fused_res_reference(x, mask, w_ih, b_ih, w_hh, b_hh,
                                       reverse, time_chunk)
    if dev.type != "cuda":
        raise ValueError(f"gru_fused_res runs on cuda or cpu, not {dev}")
    B, T, E, H = _check_cuda_args("gru_fused_res", x, mask, w_ih, b_ih, w_hh,
                                  b_hh)
    tc = chunk_len(T, time_chunk)
    ops, (Ep, Hp) = _tile_operands(x, w_ih, b_ih, w_hh, b_hh)
    out = torch.empty((B, T, Hp), dtype=x.dtype, device=x.device)
    hb = torch.empty((-(-T // tc), B, Hp), dtype=torch.float32,
                     device=x.device)
    from .build import check, load_library

    check(load_library().cair_gru_fwd_res(
        *_pointers(ops[0], mask, *ops[1:], out, hb), B, T, Ep, Hp,
        int(reverse), tc, _DTYPES[x.dtype], _stream(x)), "cair_gru_fwd_res")
    gru_fused_res.launches += 1
    if Hp != H:
        # kernel 9 takes the unpadded operands and boundaries
        out, hb = (t[..., :H].contiguous() for t in (out, hb))
    return out, hb


gru_fused_res.launches = 0


def gru_fused_bwd(x: torch.Tensor, mask: torch.Tensor, w_ih: torch.Tensor,
                  b_ih: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                  hb: torch.Tensor, dout: torch.Tensor, reverse: bool = False,
                  time_chunk: int = 6, device="cuda",
                  row_tiles: int | None = None):
    """Kernel 9: the gradients ``(dx, dw_ih, db_ih, dw_hh, db_hh)`` of
    ``gru_fused_res`` with respect to x and the weights, given its ``hb``
    and ``dout = dL/d out`` (x's dtype).  Launches ``cair_gru_bwd`` on CUDA
    tensors (bfloat16: on operands padded to the tiles' multiple of 32 and
    the staged weights, the gradients cut back), runs
    ``gru_fused_bwd_reference`` on CPU tensors.  ``row_tiles`` (bfloat16
    only; 1 or ``tile_config``'s) overrides ``bwd_row_tiles``, to time the
    two."""
    dev = resolve_device(device)
    check_on(dev, x, mask, w_ih, b_ih, w_hh, b_hh, hb, dout)
    if dev.type == "cpu":
        return gru_fused_bwd_reference(x, mask, w_ih, b_ih, w_hh, b_hh, hb,
                                       dout, reverse, time_chunk)
    if dev.type != "cuda":
        raise ValueError(f"gru_fused_bwd runs on cuda or cpu, not {dev}")
    B, T, E, H = _check_cuda_args("gru_fused_bwd", x, mask, w_ih, b_ih, w_hh,
                                  b_hh, hb, dout)
    tc = chunk_len(T, time_chunk)
    n_chunks = -(-T // tc)
    if hb.dtype != torch.float32 or tuple(hb.shape) != (n_chunks, B, H):
        raise ValueError(f"gru_fused_bwd: hb must be float32 "
                         f"{(n_chunks, B, H)}; got {hb.dtype} "
                         f"{tuple(hb.shape)}")
    if dout.dtype != x.dtype or tuple(dout.shape) != (B, T, H):
        raise ValueError(f"gru_fused_bwd: dout must be {x.dtype} "
                         f"{(B, T, H)}; got {dout.dtype} {tuple(dout.shape)}")
    from .build import check, load_library

    lib = load_library()
    dtype = _DTYPES[x.dtype]
    if x.dtype == torch.bfloat16:
        # the tensor-core kernel reads W^T out of the staged W's own slabs
        x, w_ih, b_ih, w_hh, b_hh = pad_gru_operands(x, w_ih, b_ih, w_hh,
                                                     b_hh)
        Hp = w_hh.shape[0]
        hb, dout = (_aligned(_pad_last(t, Hp)) for t in (hb, dout))
        staged = stage_lstm_weights(w_ih, w_hh)  # alive until the launch
        weights = (staged.data_ptr(), b_ih.data_ptr(), 0, b_hh.data_ptr(),
                   0, 0)
    else:
        # float32: transposed weights for the dx and dh products
        w_ih_t, w_hh_t = w_ih.t().contiguous(), w_hh.t().contiguous()
        weights = _pointers(w_ih, b_ih, w_hh, b_hh, w_ih_t, w_hh_t)
    Ep, Hp = x.shape[-1], w_hh.shape[0]
    n_bytes = lib.cair_gru_bwd_workspace(B, T, Ep, Hp, tc, dtype,
                                         row_tiles or 0)
    if n_bytes < 0:
        raise ValueError(f"gru_fused_bwd: invalid shape B={B} T={T} E={E} "
                         f"H={H} {x.dtype} row_tiles={row_tiles}")
    workspace = torch.empty((n_bytes,), dtype=torch.uint8, device=x.device)
    dx = torch.empty_like(x)
    grads = [torch.empty_like(t) for t in (w_ih, b_ih, w_hh, b_hh)]
    check(lib.cair_gru_bwd(
        x.data_ptr(), mask.data_ptr(), *weights,
        *_pointers(hb, dout, dx, *grads, workspace), B, T, Ep, Hp,
        int(reverse), tc, dtype, row_tiles or 0, _stream(x)), "cair_gru_bwd")
    gru_fused_bwd.launches += 1
    if (Ep, Hp) != (E, H):
        dx = dx[..., :E].contiguous()
        dw_ih, db_ih, dw_hh, db_hh = grads
        grads = [_cut_gates(dw_ih[:E], H, Hp, GATES).contiguous(),
                 _cut_gates(db_ih, H, Hp, GATES).contiguous(),
                 _cut_gates(dw_hh[:H], H, Hp, GATES).contiguous(),
                 _cut_gates(db_hh, H, Hp, GATES).contiguous()]
    return (dx, *grads)


gru_fused_bwd.launches = 0


class GRUFusedTrain(torch.autograd.Function):
    """Differentiable fused GRU: kernel 8 forward saving ``(x, mask, w_ih,
    b_ih, w_hh, b_hh, hb)``, kernel 9 backward returning ``(dx, None,
    dw_ih, db_ih, dw_hh, db_hh)`` (the ``_gru_fwd`` / ``_gru_bwd`` pair of
    the JAX ``gru_pallas_fused``)."""

    @staticmethod
    def forward(ctx, x, mask, w_ih, b_ih, w_hh, b_hh, reverse, time_chunk,
                device):
        out, hb = gru_fused_res(x, mask, w_ih, b_ih, w_hh, b_hh, reverse,
                                time_chunk, device)
        ctx.save_for_backward(x, mask, w_ih, b_ih, w_hh, b_hh, hb)
        ctx.args = (reverse, time_chunk, device)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, mask, w_ih, b_ih, w_hh, b_hh, hb = ctx.saved_tensors
        reverse, time_chunk, device = ctx.args
        grads = gru_fused_bwd(x, mask, w_ih, b_ih, w_hh, b_hh, hb,
                              dout.to(x.dtype).contiguous(), reverse,
                              time_chunk, device)
        dx, dw_ih, db_ih, dw_hh, db_hh = grads
        return dx, None, dw_ih, db_ih, dw_hh, db_hh, None, None, None


def gru_fused_train(x: torch.Tensor, mask: torch.Tensor, w_ih: torch.Tensor,
                    b_ih: torch.Tensor, w_hh: torch.Tensor,
                    b_hh: torch.Tensor, reverse: bool = False,
                    time_chunk: int = 6, device="cuda") -> torch.Tensor:
    """``gru_fused``'s output with gradients for x, w_ih, b_ih, w_hh and
    b_hh, through kernels 8 and 9 (their plain versions on CPU
    tensors)."""
    return GRUFusedTrain.apply(x, mask, w_ih, b_ih, w_hh, b_hh, reverse,
                               time_chunk, device)
