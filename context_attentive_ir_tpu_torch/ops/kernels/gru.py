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
tensor-core tiles too.  Above H = 448 the gate columns split over a
thread-block cluster of 2 or 4 blocks (``gru_cluster``; one staged matrix
a rank, ``stage_lstm_weights(..., ranks, gates=3)``) that exchange h, and
kernel 9's dh partials (added in rank order), through distributed shared
memory; a cluster's dx is one tensor-core product after kernel 9's
recurrence.  Those kernels take E and H that are multiples of 32 (H of 64
in a cluster of 4) and 16-byte aligned tensors; ``pad_gru_operands``
zero-pads other sizes here (a padded unit has r = z = 1/2 and n = 0, so
its h stays exactly 0 and its gradients are 0) and the results are cut
back.  In float32 (the configuration's default dtype) kernels 7, 8 and 9
run the same tiles, kernel 9's phases B and C too, on split TF32 as the
LSTM's kernels 1, 4 and 5 do (``csrc/tf32_mma.cuh``; bound at the doc
encoder's shape 0.86 ms for 7 or 8 at 165 TFLOP/s, and the weight slabs'
stream from L2 as H grows): one block up to H = 128 (64 rows the
forwards), clusters of 2, 4 or 8 ranks of at most 128 units up to 1,024
(``f32_cluster``; 32 rows a forward's rank, one h tile or two by
``f32_forward_tiles``), H padded to ``f32_tile_hidden``.

Above H = 1,024, in both dtypes, kernels 7, 8 and 9 take the step route
(``csrc/lstm_step.cu`` with three gate blocks, ``gru_route``) as the LSTM's
do: the cluster's ranks made independent blocks of a row tile and a unit
tile of 256 (bf16, H padded to a multiple of it, ``gru_step_hidden``) or
128 (float32) units, h through device memory, a launch a time step; kernel
9's dh partials of the unit tiles are added in tile order.  No shared
memory grows with H.  ``gru_fused_supported`` states the shapes each
dtype's kernels hold (any E, any H); ``PERF.md`` records times and bounds.
"""

from __future__ import annotations

import torch

from ...device import check_on, resolve_device
from .lstm import (
    _DTYPES,
    MAX_CLUSTER_HIDDEN,
    MAX_PAIR_BF16,
    STEP_UNITS,
    TILE_ALIGN,
    _aligned,
    _cut_gates,
    _first_in_chunk,
    _pad_last,
    _round_up,
    _step_workspace,
    _stream,
    chunk_len,
    f32_cluster,
    f32_smem_bytes,
    pad_operands,
    stage_lstm_weights,
    step_hidden,
    step_smem_bytes,
    tile_config,
    tile_smem_bytes,
)

GATES = 3  # r, z, n
# one block up to here: kernel 9's single-block tiles stop fitting at 480
# (kGruMaxSingle in csrc/lstm_mma.cuh)
MAX_SINGLE_GRU = 448


def gru_cluster(hidden: int) -> int:
    """Blocks of the cluster the bf16 kernels 7, 8, 9 split a padded
    ``hidden`` size over (``gru_cluster`` in ``csrc/lstm_mma.cuh``): 1 up
    to 448, 2 up to 512, 4 up to 1,024; 0 above.  A rank's 16-row tile
    spreads at most 256 units over its 8 warps (``CLUSTER_TILE``), as the
    LSTM's."""
    if hidden <= MAX_SINGLE_GRU:
        return 1
    if hidden <= MAX_PAIR_BF16:
        return 2
    return 4 if hidden <= MAX_CLUSTER_HIDDEN else 0


def _h_align(hidden: int) -> int:
    """32, or 64 in a cluster of 4: a rank's units are a multiple of 16,
    since kernel 9's products step over its 3 Hc gate columns by 16
    (``gru_tiles_ok`` in ``csrc/lstm_mma.cuh``)."""
    return max(TILE_ALIGN, 16 * gru_cluster(_round_up(hidden, TILE_ALIGN)))


def gru_tile_hidden(hidden: int) -> int:
    """The hidden size the bf16 kernels run ``hidden`` at: the next
    multiple of 32, or of 64 in a cluster of 4."""
    return _round_up(hidden, _h_align(hidden))


def gru_route(hidden: int, dtype: torch.dtype = torch.float32) -> str:
    """The route of kernels 7, 8 and 9 alike at ``hidden`` units in
    ``dtype`` (``gru_route`` in ``csrc/lstm_mma.cuh``, which the launchers
    apply): ``"single"`` (one block), ``"cluster"`` (a cluster of blocks
    that exchange h through distributed shared memory: bf16
    ``gru_cluster``, float32 ``f32_cluster``) or ``"step"``
    (``csrc/lstm_step.cu``: a launch a time step, h through device memory)
    above 1,024 units, in both dtypes."""
    if hidden > MAX_CLUSTER_HIDDEN:
        return "step"
    c = (gru_cluster(gru_tile_hidden(hidden)) if dtype == torch.bfloat16
         else f32_cluster(hidden))
    return "cluster" if c > 1 else "single"


def gru_step_hidden(hidden: int, dtype: torch.dtype) -> int:
    """The hidden size the step route runs ``hidden`` at: the LSTM's rule
    (``step_hidden``), bf16 the next multiple of its 256-unit tile
    (zero-padded by the wrappers), float32 ``hidden`` itself (its last tile
    partial)."""
    return step_hidden(hidden, dtype)


def gru_fused_supported(embed: int, hidden: int, rows: int,
                        dtype: torch.dtype = torch.float32) -> bool:
    """Whether kernels 7, 8 and 9 hold an ``[rows, T, embed] -> hidden`` GRU
    in ``dtype`` (the counterpart of the JAX ``gru_fused_supported``, with
    this card's limits): every ``embed``, ``hidden`` and ``rows`` of at
    least 1 in both dtypes.  Up to 1,024 units, bfloat16: ``hidden`` padded
    (``gru_tile_hidden``), split over a cluster of 2 or 4 blocks above 448
    (``gru_cluster``), whose tiles -- kernel 9's four-slot gradient tile
    beside the forward's -- fit a block's shared memory
    (``tile_smem_bytes``); float32: the split-TF32 tiles of kernels 7, 8
    and 9 with three gate blocks at ``f32_tile_hidden``, whose
    ``f32_smem_bytes(..., gates=3)`` fit, forward and backward, as the
    LSTM's.  Above it the step route (``gru_route``), whose blocks' shared
    memory (``step_smem_bytes`` with three gate blocks) no width
    changes."""
    if embed < 1 or hidden < 1 or rows < 1 or dtype not in _DTYPES:
        return False
    if gru_route(hidden, dtype) == "step":
        return (step_smem_bytes(dtype, gates=GATES) > 0
                and step_smem_bytes(dtype, backward=True, gates=GATES) > 0)
    if dtype == torch.float32:
        return all(f32_smem_bytes(embed, hidden, bw, GATES) > 0
                   for bw in (False, True))
    e, h = _round_up(embed, TILE_ALIGN), gru_tile_hidden(hidden)
    c = gru_cluster(h)
    return c > 0 and tile_smem_bytes(e, h, backward=True, gates=GATES,
                                     ranks=c) > 0


# kernel 9's bf16 blocks take 16 rows when the tiles' own rows a block
# would give fewer blocks than one H100 has SMs (``bwd_row_tiles`` in
# ``csrc/gru_bwd.cu``)
SMALL_GRID = 132


def bwd_row_tiles(hidden: int, rows: int) -> int:
    """16-row tiles a block of kernel 9's bf16 phase A takes for ``rows``
    rows at a padded ``hidden`` size: ``tile_config``'s, unless that gives
    fewer than ``SMALL_GRID`` blocks; then 1 (a cluster's ranks, above 448,
    take 1 either way)."""
    own = tile_config(hidden)[1]
    return 1 if -(-rows // (16 * own)) < SMALL_GRID else own


def pad_gru_operands(x: torch.Tensor, w_ih: torch.Tensor, b_ih: torch.Tensor,
                     w_hh: torch.Tensor, b_hh: torch.Tensor,
                     h_align: int | None = None):
    """The operands of a GRU with E zero-padded up to a multiple of
    ``TILE_ALIGN`` and H up to the bf16 kernels' hidden size
    (``gru_tile_hidden(H)``; on the step route, above 1,024,
    ``gru_step_hidden``), or up to a multiple of ``h_align`` (float32
    kernel 9's, ``f32_tile_hidden``): ``x [B, T, Ep]``, ``w_ih [Ep, 3Hp]``, ``b_ih
    [3Hp]``, ``w_hh [Hp, 3Hp]``, ``b_hh [3Hp]``, every tensor 16-byte
    aligned.  The padded GRU's first H units equal the original's: a padded
    unit has zero weights and biases, so r = z = 1/2 and n = 0, its h stays
    exactly 0 from the zero start and it feeds nothing back.  Aligned
    operands come back as they are (no copy)."""
    h = w_hh.shape[0]
    align = h_align or (STEP_UNITS[torch.bfloat16]
                        if gru_route(h, torch.bfloat16) == "step"
                        else _h_align(h))
    x, w_ih, w_hh, b_ih, b_hh = pad_operands(
        x, w_ih, w_hh, (b_ih, b_hh), GATES, align)
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


def _forward(name: str, x, mask, w_ih, b_ih, w_hh, b_hh, reverse: bool,
             tc: int, res: bool):
    """Kernel 7 (``res`` False) or 8 on CUDA tensors, by the route of H:
    ``cair_gru_fwd`` / ``cair_gru_fwd_res`` up to 1,024 units,
    ``cair_gru_step`` above.  The tiles (both dtypes up to 1,024 units, bf16
    above) run on operands padded to their widths (``pad_gru_operands``:
    bf16 ``gru_tile_hidden`` or the step route's unit tile, float32
    ``f32_tile_hidden``) with the staged ``[W_ih; W_hh]`` -- one matrix a
    rank of a cluster (bf16 ``gru_cluster``, float32 ``f32_cluster``) or a
    unit tile of the step route -- in ``w_ih``'s place; the float32 step
    route on the operands as they are.  Returns ``(out, hb)`` at the
    padded H (hb None without ``res``) and H."""
    B, T, E, H = _check_cuda_args(name, x, mask, w_ih, b_ih, w_hh, b_hh)
    step = gru_route(H, x.dtype) == "step"
    bf16 = x.dtype == torch.bfloat16
    if bf16 or not step:
        x, w_ih, b_ih, w_hh, b_hh = pad_gru_operands(
            x, w_ih, b_ih, w_hh, b_hh,
            None if bf16 else max(TILE_ALIGN, 16 * f32_cluster(H)))
        Hp = w_hh.shape[0]
        w_ih = stage_lstm_weights(
            w_ih, w_hh, Hp // STEP_UNITS[x.dtype] if step else
            gru_cluster(Hp) if bf16 else f32_cluster(Hp), GATES)
    Ep, Hp = x.shape[-1], w_hh.shape[0]
    out = torch.empty((B, T, Hp), dtype=x.dtype, device=x.device)
    hb = (torch.empty((-(-T // tc), B, Hp), dtype=torch.float32,
                      device=x.device) if res else None)
    from .build import launch

    # the launchers report a hidden size their blocks cannot hold
    if step:
        workspace = _step_workspace(B, Hp, x, "gru")
        launch("cair_gru_step", x.device,
               *_pointers(x, mask, w_ih, b_ih, w_hh, b_hh, out),
               hb.data_ptr() if res else 0, workspace.data_ptr(), B, T, Ep,
               Hp, int(reverse), tc, int(res), _DTYPES[x.dtype], _stream(x))
        return out, hb, H
    ptrs = _pointers(x, mask, w_ih, b_ih, b_hh, out)
    if res:
        launch("cair_gru_fwd_res", x.device, *ptrs, hb.data_ptr(), B, T, Ep,
               Hp, int(reverse), tc, _DTYPES[x.dtype], _stream(x))
    else:
        launch("cair_gru_fwd", x.device, *ptrs, B, T, Ep, Hp, int(reverse),
               _DTYPES[x.dtype], _stream(x))
    return out, hb, H


def gru_fused(x: torch.Tensor, mask: torch.Tensor, w_ih: torch.Tensor,
              b_ih: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
              reverse: bool = False, device="cuda") -> torch.Tensor:
    """x [B, T, E], mask bool [B, T], w_ih [E, 3H], b_ih [3H], w_hh
    [H, 3H], b_hh [3H] (one dtype, float32 or bfloat16) -> h [B, T, H] in
    x's dtype.

    On CUDA tensors this launches ``cair_gru_fwd`` (above 1,024 units
    ``cair_gru_step``; bfloat16: on operands padded to the tiles' widths and
    the staged weights, the output cut back to H); on CPU tensors
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
    out, _, H = _forward("gru_fused", x, mask, w_ih, b_ih, w_hh, b_hh,
                         reverse, x.shape[1], False)
    gru_fused.launches += 1
    return out if out.shape[-1] == H else out[..., :H].contiguous()


gru_fused.launches = 0


def gru_fused_res(x: torch.Tensor, mask: torch.Tensor, w_ih: torch.Tensor,
                  b_ih: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                  reverse: bool = False, time_chunk: int = 6, device="cuda"):
    """Kernel 8: ``gru_fused``'s output plus the chunk-boundary state,
    ``(out [B, T, H], hb)`` with hb float32 ``[ceil(T / tc), B, H]``
    (``tc = chunk_len(T, time_chunk)``).  Launches ``cair_gru_fwd_res``
    (above 1,024 units ``cair_gru_step``) on CUDA tensors, runs
    ``gru_fused_res_reference`` on CPU tensors."""
    dev = resolve_device(device)
    check_on(dev, x, mask, w_ih, b_ih, w_hh, b_hh)
    if dev.type == "cpu":
        return gru_fused_res_reference(x, mask, w_ih, b_ih, w_hh, b_hh,
                                       reverse, time_chunk)
    if dev.type != "cuda":
        raise ValueError(f"gru_fused_res runs on cuda or cpu, not {dev}")
    out, hb, H = _forward("gru_fused_res", x, mask, w_ih, b_ih, w_hh, b_hh,
                          reverse, chunk_len(x.shape[1], time_chunk), True)
    gru_fused_res.launches += 1
    if out.shape[-1] != H:
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
    tensors (bfloat16: on operands padded to the tiles' widths and the
    staged weights, the gradients cut back), runs
    ``gru_fused_bwd_reference`` on CPU tensors.  ``row_tiles`` (bfloat16
    up to 1,024 units only; 1 or ``tile_config``'s) overrides
    ``bwd_row_tiles``, to time the two."""
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
    from .build import launch, load_library

    lib = load_library()
    dtype = _DTYPES[x.dtype]
    step = gru_route(H, x.dtype) == "step"
    # the tensor-core kernels (float32: split TF32) read W^T out of the
    # staged W's own slabs (one matrix a rank of a cluster or, bf16, a unit
    # tile of the step route); a cluster's, or the step route's, dx is one
    # product after them with W_ih^T (bf16) or W_ih read as it lies
    # (float32).  The float32 step route reads W_ih, W_hh as given and
    # W_hh^T.
    if x.dtype == torch.bfloat16 or not step:
        bf16 = x.dtype == torch.bfloat16
        x, w_ih, b_ih, w_hh, b_hh = pad_gru_operands(
            x, w_ih, b_ih, w_hh, b_hh,
            None if bf16 else max(TILE_ALIGN, 16 * f32_cluster(H)))
        Hp = w_hh.shape[0]
        hb, dout = (_aligned(_pad_last(t, Hp)) for t in (hb, dout))
        ranks = (Hp // STEP_UNITS[x.dtype] if step else gru_cluster(Hp)
                 if bf16 else f32_cluster(Hp))
        # alive until the launch
        staged = stage_lstm_weights(w_ih, w_hh, ranks, GATES)
        w_dx = ((w_ih.t().contiguous() if bf16 else w_ih) if ranks > 1
                else None)
        weights = (staged.data_ptr(), b_ih.data_ptr(), 0, b_hh.data_ptr(),
                   0 if w_dx is None else w_dx.data_ptr(), 0)
    else:
        w_hh_t = w_hh.t().contiguous()
        weights = _pointers(w_ih, b_ih, w_hh, b_hh, w_ih, w_hh_t)
    Ep, Hp = x.shape[-1], w_hh.shape[0]
    n_bytes = lib.cair_gru_bwd_workspace(B, T, Ep, Hp, tc, dtype,
                                         row_tiles or 0)
    if n_bytes < 0:
        raise ValueError(f"gru_fused_bwd: invalid shape B={B} T={T} E={E} "
                         f"H={H} {x.dtype} row_tiles={row_tiles}")
    workspace = torch.empty((n_bytes,), dtype=torch.uint8, device=x.device)
    dx = torch.empty_like(x)
    grads = [torch.empty_like(t) for t in (w_ih, b_ih, w_hh, b_hh)]
    launch(
        "cair_gru_bwd", x.device,
        x.data_ptr(), mask.data_ptr(), *weights,
        *_pointers(hb, dout, dx, *grads, workspace), B, T, Ep, Hp,
        int(reverse), tc, dtype, row_tiles or 0, _stream(x))
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
