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
L2 through a ring of bulk copies with x_t's columns beside each slab (so
any E fits), and a thread's accumulator fragments are the four gates of its
own (row, unit) cells, so c, dh and dc stay in registers.  Above H = 384
the gate columns split over a thread-block cluster of 2 or 4 blocks
(``lstm_cluster``; one staged matrix a rank) that exchange h, and kernel
5's dh partials, through distributed shared memory.  Those kernels take E
and H that are multiples of 32 and 16-byte aligned tensors;
``pad_lstm_operands`` zero-pads other sizes here (zero weights and biases
keep a padded unit at exactly 0), and the results are cut back.

In float32 (the configuration's default dtype) kernels 1, 4 and 5 run the
same tiles on split TF32 (``csrc/tf32_mma.cuh``): each operand splits into
hi = tf32(v) and lo = tf32(v - hi) as its fragment is loaded, and a product
is lo*hi + hi*lo + hi*hi in ``mma.sync.m16n8k8`` tiles, about 22 of
float32's 24 bits at a third of TF32's 495 TFLOP/s -- 2.5 times the f32
FMA peak -- in a fixed order (the same bits every run); kernel 5's phases
B and C too.  The bound of kernels 1 and 4 at the doc encoder's shape is
then 1.16 ms (165 TFLOP/s); as H grows the weight slabs' stream from L2
joins it, since each row block re-reads them every step, so a block holds
as many rows as its shared memory allows.  One block takes H up to 128
(64 rows the forwards, ``f32_forward_tiles``; 64 or 32 kernel 5,
``tile_config_f32``), clusters of 2, 4 or 8 ranks of at most 128 units the
rest up to 1,024 (``f32_cluster``; 32 rows a forward's rank, with one h
tile where two would not fit or would make its slabs shallower; kernel
5's 32 rows up to 4 ranks, 16 in 8, ``cluster_tile_f32``;
``f32_tile_hidden``: H padded to 16 C).  Kernel 5's recompute is kernel
4's step on the same staged weights, in the same k order.

Above H = 1,024, in both dtypes, kernels 1, 4 and 5 take the step route
(``csrc/lstm_step.cu``, ``lstm_route``): the cluster's ranks made
independent blocks of a row tile and a unit tile of 256 (bf16, H padded to
a multiple of it) or 128 (float32) units, h through device memory, a launch
a time step, so no shared memory grows with H.  ``fused_supported`` states
the shapes each dtype's kernels hold (any E, any H); ``PERF.md`` records
times and bounds.
"""

from __future__ import annotations

import torch

from ...device import check_on, resolve_device

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# -- the shapes the CUDA kernels hold (csrc/lstm_mma.cuh, lstm_common.cuh) ----
SMEM_LIMIT = 232448   # dynamic shared memory a block may use on sm_90
TILE_ALIGN = 32       # the bf16 kernels' E and H are multiples of this
MAX_CLUSTER_HIDDEN = 1024  # clusters hold kernels 1, 4, 5 and 7, 8, 9 to here
MAX_SINGLE_BF16 = 384  # one block; above it a cluster (kMaxSingle)
MAX_PAIR_BF16 = 512    # a cluster of 2 up to here, of 4 above (kMaxPair)
CLUSTER_TILE = (4, 1)  # a rank's unit groups per warp, 16-row tiles
F32_STRIDE = 36       # floats per staged k-row of the float32 step route
F32_CHUNK = 256       # x k-rows the float32 step route stages at a time
F32_UNITS = 128       # units of a float32 step-route unit tile
F32_MAX_RANKS = 8
# float32 kernels 1, 4, 5 and 7, 8, 9 (split TF32): one block up to 128
# units, then ranks of at most 128 (kF32Rank in csrc/lstm_common.cuh): 2,
# 4 or 8 of them
F32_RANK = 128
F32_FWD_ROWS = (64, 32, 16)  # rows a float32 forward block may take
FILL_BLOCKS = 132     # blocks that fill one H100 (kFillBlocks)
# units of a unit tile of the step route (kStepUnits: a bf16 cluster rank's;
# kF32Units), and a bf16 step block's rows (kClusterConfig's tile)
STEP_UNITS = {torch.bfloat16: 256, torch.float32: F32_UNITS}
STEP_ROWS = 16


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def lstm_cluster(hidden: int) -> int:
    """Blocks of the cluster the bf16 kernels 1, 4, 5 split a padded
    ``hidden`` size over (``lstm_cluster`` in ``csrc/lstm_mma.cuh``): 1 up
    to 384, 2 up to 512, 4 up to 1,024; 0 above, where the step route
    takes them (``lstm_route``)."""
    if hidden <= MAX_SINGLE_BF16:
        return 1
    if hidden <= MAX_PAIR_BF16:
        return 2
    return 4 if hidden <= MAX_CLUSTER_HIDDEN else 0


def lstm_route(hidden: int, dtype: torch.dtype = torch.float32,
               recurrence: bool = False) -> str:
    """The route of the LSTM kernels at ``hidden`` units in ``dtype``
    (``lstm_route`` in ``csrc/lstm_mma.cuh``, which the launchers apply):
    ``"single"`` (one block), ``"cluster"`` (a cluster of blocks that
    exchange h through distributed shared memory: bf16 ``lstm_cluster``,
    float32 ``f32_cluster``; kernels 1, 4 and 5 alike) or ``"step"``
    (``csrc/lstm_step.cu``: a launch a time step, h through device
    memory) -- kernels 1, 4, 5 above 1,024 units and kernel 6
    (``recurrence``) above 512, in both dtypes."""
    if recurrence:
        return "single" if hidden <= MAX_HIDDEN_REC else "step"
    if hidden > MAX_CLUSTER_HIDDEN:
        return "step"
    c = (lstm_cluster(_round_up(hidden, TILE_ALIGN))
         if dtype == torch.bfloat16 else f32_cluster(hidden))
    return "cluster" if c > 1 else "single"


def step_hidden(hidden: int, dtype: torch.dtype) -> int:
    """The hidden size the step route runs ``hidden`` at: bf16 the next
    multiple of its 256-unit tile (zero-padded by the wrappers), float32
    ``hidden`` itself (its last tile partial)."""
    return (_round_up(hidden, STEP_UNITS[dtype]) if dtype == torch.bfloat16
            else hidden)


def step_smem_bytes(dtype: torch.dtype = torch.bfloat16,
                    backward: bool = False, gates: int = 4) -> int:
    """Dynamic shared memory of a step-route block with ``gates`` gate
    blocks (4: the LSTM, 3: the GRU), which no E or H changes.  bf16
    (``step_smem`` in ``csrc/lstm_mma.cuh``): the ring's mbarriers (64
    bytes), three slabs of 32 (else 16) k-rows of the 256-unit tile's
    ``gates`` * 256 gate columns (+ 16 bytes a row), three x slots of 16
    rows of a slab's depth (x_t and h_{t-1} both stream through them), then
    the forward's bias (four f32 slots of the tile) or the dh product's
    tile of four gradient slots (16 rows of 8 * 256 + 16 bytes).  float32
    (``csrc/lstm_step.cu``): the forward stages one chunk of 256 k-rows,
    the dh product the tile's ``gates`` * 128 slot columns, k-major rows of
    36 floats."""
    if dtype == torch.float32:
        return (gates * F32_UNITS if backward else F32_CHUNK) * F32_STRIDE * 4
    units, m = STEP_UNITS[torch.bfloat16], STEP_ROWS
    for depth in (32, 16):
        n_bytes = (64 + 3 * depth * (2 * gates * units + 16)
                   + 3 * m * (2 * depth + 16)
                   + (m * (8 * units + 16) if backward else 16 * units))
        if n_bytes <= SMEM_LIMIT:
            return n_bytes
    return 0


def f32_cluster(hidden: int) -> int:
    """Blocks of the cluster the float32 tile kernels split ``hidden`` units
    over (``f32_cluster`` in ``csrc/lstm_common.cuh``; the forwards 1, 4,
    7, 8 and the backwards 5, 9 alike), 0 where none holds them: one block
    up to 128, then 2, 4 or 8 ranks of at most 128 units."""
    c = 1
    while c < F32_MAX_RANKS and hidden > c * F32_RANK:
        c *= 2
    return c if hidden <= c * F32_RANK else 0


def f32_tile_hidden(hidden: int) -> int:
    """The hidden size the float32 tile kernels (1, 4, 5, 7, 8, 9) run
    ``hidden`` at: the next multiple of 32, and of 16 C in a cluster of C
    ranks (a rank's units a multiple of 16); zero-padded by the
    wrappers."""
    return _round_up(hidden, max(TILE_ALIGN, 16 * f32_cluster(hidden)))


def tile_config_f32(hidden: int) -> tuple[int, int]:
    """(unit groups per warp, 16-row tiles per block) of float32 kernels 5
    and 9 in one block, H up to 128 (``pick_config_f32`` in
    ``csrc/lstm_mma.cuh``): the bf16 tiles' unit groups, 64 rows up to
    H = 64, 32 up to 128; a cluster's ranks take ``cluster_tile_f32``."""
    return (1, 4) if hidden <= 64 else (2, 2)


def cluster_tile_f32(ranks: int) -> tuple[int, int]:
    """(unit groups per warp, 16-row tiles) of a rank of float32 kernels
    5 and 9 in a cluster of ``ranks`` (``cluster_config_f32`` in
    ``csrc/lstm_mma.cuh``): at most 128 units in 2 groups a warp, 32 rows
    up to 4 ranks, 16 in a cluster of 8."""
    return 2, 2 if ranks <= 4 else 1


def f32_forward_tiles(hidden: int, gates: int = 4,
                      rows: int | None = None) -> tuple[int, int]:
    """(rows a block, h tiles) of float32 kernels 1, 4 (``gates`` 4) and 7,
    8 (3) at a padded ``hidden`` size up to 1,024 for ``rows`` rows (None:
    enough to fill the card; ``f32_fwd_smem`` in ``csrc/lstm_mma.cuh``): a
    block (one up to 128 units, else a rank of ``f32_cluster``'s clusters)
    takes the most of 64, 32 and 16 rows whose h tile fits beside a slab
    and whose row blocks, times the ranks, fill ``FILL_BLOCKS``, else 16;
    one block keeps one h tile, a rank two, read and written in turn,
    unless one tile lets its slabs be deeper or two do not fit -- then one,
    rewritten after a second cluster barrier a step.  (0, 0) where no
    cluster holds ``hidden``."""
    c = f32_cluster(hidden)
    for m in F32_FWD_ROWS if c else ():
        depth = [_tile_smem(TILE_ALIGN, hidden, False, gates, m, c,
                            torch.float32, n)[1] for n in (1, 2)]
        if depth[0] and (m == F32_FWD_ROWS[-1] or rows is None
                         or -(-rows // m) * c >= FILL_BLOCKS):
            return m, 2 if c > 1 and depth[1] >= depth[0] else 1
    return 0, 0


def f32_smem_bytes(e: int, h: int, backward: bool = False,
                   gates: int = 4) -> int:
    """Dynamic shared memory of a block (a rank) of the float32 split-TF32
    tiles at the padded widths (E to 32, H to ``f32_tile_hidden``) with
    ``gates`` gate blocks: the forwards (kernels 1, 4, 7, 8;
    ``f32_forward_tiles``' rows and h tiles for rows that fill the card,
    the most a block takes) or the backward's phase A
    (kernels 5, 9, ``backward``; ``tile_config_f32`` / ``cluster_tile_f32``
    rows); 0 where no cluster holds ``h``."""
    if f32_cluster(h) == 0:
        return 0
    ep, hp = _round_up(e, TILE_ALIGN), f32_tile_hidden(h)
    if backward:
        return tile_smem_bytes(ep, hp, True, gates, dtype=torch.float32)
    rows, tiles = f32_forward_tiles(hp, gates)
    return tile_smem_bytes(ep, hp, False, gates, rows, dtype=torch.float32,
                           h_tiles=tiles)


def tile_config(hidden: int) -> tuple[int, int]:
    """(unit groups per warp, 16-row tiles per block) of the bf16 kernels
    for a padded hidden size (``pick_config`` in ``csrc/lstm_mma.cuh``; a
    rank of an LSTM cluster, above 384, takes ``CLUSTER_TILE`` instead)."""
    if hidden <= 64:
        return 1, 4
    if hidden <= 128:
        return 2, 4
    if hidden <= 256:
        return 4, 2
    return 8, 1


def tile_smem_bytes(e: int, h: int, backward: bool = False,
                    gates: int = 4, rows: int | None = None,
                    ranks: int | None = None,
                    dtype: torch.dtype = torch.bfloat16,
                    h_tiles: int | None = None) -> int:
    """Dynamic shared memory of the tensor-core forward or backward phase A
    kernel in ``dtype`` (bf16; float32: the split-TF32 tiles) at padded
    widths ``e``, ``h`` with ``gates`` gate blocks (4: the LSTM, 3: the
    GRU), ``rows`` rows a block (default: ``tile_config``'s, float32
    ``tile_config_f32``'s) and ``ranks`` blocks a cluster (default: bf16
    ``lstm_cluster`` for the LSTM, 1 -- a single block -- for the GRU,
    whose split ``gru_cluster`` in ``ops/kernels/gru.py`` states; float32
    ``f32_cluster``): the ring's mbarriers (64 bytes), its three slabs of
    32 (else 16, float32 else 8) k-rows of a rank's ``gates`` * Hc gate
    columns (Hc = H / ranks; 8 zero columns a row) and three x slots of
    ``rows`` rows of a slab's depth of x_t columns (+ 16 bytes a row), the
    h tile (two in a cluster, or ``h_tiles``), the bias (four f32 slots of
    Hc), float32's backward the partials of its reverse products from seven
    warps (7 KB); 0 if no depth fits (``mma_smem`` in
    ``csrc/lstm_mma.cuh``).  E takes no shared memory: x is streamed beside
    the weights.  A backward's gradient tile
    has four slots of Hc whatever the gate count (the GRU's da_r, da_z,
    da_n, da_n * r) and takes the place of the forward's tiles, beside the
    f32 tile dh returns through: after that union in the LSTM's
    single-block kernel 5, inside it in the GRU's single-block kernel 9; a
    cluster's rank (either recurrence) keeps inside it one tile of Hc
    columns a source rank instead."""
    return _tile_smem(e, h, backward, gates, rows, ranks, dtype, h_tiles)[0]


def _tile_smem(e, h, backward, gates, rows, ranks, dtype, h_tiles=None):
    """``tile_smem_bytes`` and the slab depth it fits at, ``(0, 0)`` where
    none fits."""
    f32 = dtype == torch.float32
    elt = 4 if f32 else 2
    c = ranks or (f32_cluster(h) if f32
                  else lstm_cluster(h) if gates == 4 else 1)
    if c == 0:
        return 0, 0
    hc = h // c
    own = tile_config_f32(h) if f32 else tile_config(h)
    rank = cluster_tile_f32(c) if f32 else CLUSTER_TILE
    m = rows or (16 * (rank[1] if c > 1 else own[1]))
    h_row, w_row = elt * h + 16, elt * (gates * hc + 8)
    tiles = (h_tiles or (2 if c > 1 else 1)) * m * h_row
    exch_after = 0
    if backward:
        rev = m * (4 * elt * hc + 16)
        if c > 1:
            rev += c * m * (hc + 8) * 4
        elif gates == 3:
            rev += m * (h + 8) * 4
        tiles = max(tiles, rev)
        if gates == 4 and c == 1:
            exch_after = m * (h + 8) * 4
    if backward and f32:
        exch_after += 7 * 32 * 8 * 4   # the warps' partials (kRedBytes)
    for depth in ((32, 16, 8) if f32 else (32, 16)):
        n_bytes = (64 + 3 * depth * w_row + 3 * m * (elt * depth + 16)
                   + tiles + exch_after + 16 * hc)
        if n_bytes <= SMEM_LIMIT:
            return n_bytes, depth
    return 0, 0


def fused_supported(embed: int, hidden: int, rows: int,
                    dtype: torch.dtype = torch.float32) -> bool:
    """Whether kernels 1, 4 and 5 hold an ``[rows, T, embed] -> hidden``
    LSTM in ``dtype`` (the counterpart of the JAX ``fused_supported``, with
    this card's limits): every ``embed``, ``hidden`` and ``rows`` of at
    least 1 in both dtypes.  Up to 1,024 units, bfloat16: ``hidden`` padded
    to a multiple of 32, split over a cluster of 2 or 4 blocks above 384
    (``lstm_cluster``), whose tiles fit a block's shared memory
    (``tile_smem_bytes``); float32: the split-TF32 tiles of kernels 1, 4
    and 5 at ``f32_tile_hidden``, one block or a cluster of 2, 4 or 8
    (``f32_cluster``), whose ``f32_smem_bytes`` fit, forward and backward.
    Above it the step route (``lstm_route``), whose blocks' shared memory
    (``step_smem_bytes``) no width changes."""
    if embed < 1 or hidden < 1 or rows < 1 or dtype not in _DTYPES:
        return False
    if lstm_route(hidden, dtype) == "step":
        return (step_smem_bytes(dtype) > 0
                and step_smem_bytes(dtype, backward=True) > 0)
    if dtype == torch.bfloat16:
        e, h = _round_up(embed, TILE_ALIGN), _round_up(hidden, TILE_ALIGN)
        return tile_smem_bytes(e, h, backward=True) > 0
    return all(f32_smem_bytes(embed, hidden, bw) > 0 for bw in (False, True))


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
                 biases, gates: int, h_align: int = TILE_ALIGN):
    """``(x, w_ih, w_hh, *biases)`` of a recurrence with ``gates`` gate
    blocks, E zero-padded up to a multiple of ``TILE_ALIGN`` and H up to one
    of ``h_align`` (``x [B, T, Ep]``, ``w_ih [Ep, gates * Hp]``, ``w_hh
    [Hp, gates * Hp]``, each bias ``[gates * Hp]``), every tensor 16-byte
    aligned; aligned operands come back as they are (no copy).
    ``pad_lstm_operands`` and ``pad_gru_operands`` state why the padding is
    exact."""
    e, h = x.shape[-1], w_hh.shape[0]
    ep, hp = _round_up(e, TILE_ALIGN), _round_up(h, h_align)
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
                      w_hh: torch.Tensor, h_align: int = TILE_ALIGN):
    """The operands of an LSTM with E zero-padded up to a multiple of
    ``TILE_ALIGN`` and H up to one of ``h_align`` (the step route's unit
    tile, or ``TILE_ALIGN``):
    ``x [B, T, Ep]``, ``w_ih [Ep, 4Hp]``, ``b [4Hp]``, ``w_hh [Hp, 4Hp]``,
    every tensor 16-byte aligned.  The padded LSTM's first H units equal the
    original's: a padded unit has zero weights and bias, so its gates are 0,
    its c and h stay exactly 0 and it feeds nothing back; its gradients are
    0.  Aligned operands come back as they are (no copy)."""
    x, w_ih, w_hh, b = pad_operands(x, w_ih, w_hh, (b,), 4, h_align)
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


def stage_lstm_weights(w_ih: torch.Tensor, w_hh: torch.Tensor,
                       ranks: int = 1, gates: int = 4) -> torch.Tensor:
    """``[W_ih; W_hh]`` as the bf16 kernels' weight ring copies it: one
    contiguous ``[E + H, G + 8]`` matrix (G = 4H for the LSTM, ``gates`` =
    3: 3H for the GRU), each row followed by 8 zero columns (the 16 bytes of
    padding a staged row has in shared memory), so a slab of k-rows is one
    contiguous range (~400 KB a call at the main path's LSTM widths).
    ``ranks`` > 1 (a recurrence split over a cluster, ``lstm_cluster`` /
    ``gru_cluster``): ``[ranks, E + H, gates * Hc + 8]``, rank r's matrix
    the gate columns of its units r*Hc .. (r+1)*Hc - 1 (Hc = H / ranks) in
    gate order (i, f, g, o; r, z, n)."""
    w = torch.cat([w_ih, w_hh], 0)
    if ranks > 1:
        k, g = w.shape
        hc = g // (gates * ranks)
        w = w.reshape(k, gates, ranks, hc).permute(2, 0, 1, 3).reshape(
            ranks, k, gates * hc)
    return _aligned(torch.nn.functional.pad(w, (0, 8)))


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


def _step_workspace(n_rows: int, h: int, x: torch.Tensor,
                    rnn: str = "lstm") -> torch.Tensor:
    """The step route's forward state (h in turn, the LSTM's c, bf16's f32
    h) of ``rnn`` on x's card: ``cair_lstm_step_workspace`` (or
    ``cair_gru_step_workspace``) bytes."""
    from .build import load_library

    n_bytes = getattr(load_library(), f"cair_{rnn}_step_workspace")(
        n_rows, h, _DTYPES[x.dtype])
    if n_bytes < 0:
        raise ValueError(f"{rnn} step route: invalid shape B={n_rows} H={h}")
    return torch.empty((n_bytes,), dtype=torch.uint8, device=x.device)


def _forward(name: str, x, mask, w_ih, b, w_hh, reverse: bool, tc: int,
             res: bool):
    """Kernel 1 (``res`` False) or 4 on CUDA tensors, by the route of H:
    ``cair_lstm_fwd`` / ``cair_lstm_fwd_res`` up to 1,024 units,
    ``cair_lstm_step`` above.  Returns ``(out, hb, cb)`` at the padded H
    (hb, cb None without ``res``) and H."""
    B, T, E, H = _check_cuda_args(name, x, mask, w_ih, b, w_hh)
    step = lstm_route(H, x.dtype) == "step"
    if x.dtype == torch.bfloat16 or not step:
        # zero-padded to the tiles' widths (bf16 H to 32 or the step route's
        # unit tile, float32 to f32_tile_hidden), the weights staged: one
        # matrix a rank of a cluster or a unit tile of the step route; the
        # float32 step route reads the weights as they are
        bf16 = x.dtype == torch.bfloat16
        x, w_ih, b, w_hh = pad_lstm_operands(
            x, w_ih, b, w_hh, STEP_UNITS[x.dtype] if step else
            TILE_ALIGN if bf16 else max(TILE_ALIGN, 16 * f32_cluster(H)))
        Hp = w_hh.shape[0]
        w_ih = stage_lstm_weights(
            w_ih, w_hh, Hp // STEP_UNITS[x.dtype] if step else
            lstm_cluster(Hp) if bf16 else f32_cluster(Hp))
    Ep, Hp = x.shape[-1], w_hh.shape[0]
    out = torch.empty((B, T, Hp), dtype=x.dtype, device=x.device)
    hb = cb = None
    if res:
        hb = torch.empty((-(-T // tc), B, Hp), dtype=torch.float32,
                         device=x.device)
        cb = torch.empty_like(hb)
    from .build import launch

    # the launchers report a hidden size their blocks cannot hold
    if step:
        workspace = _step_workspace(B, Hp, x)
        launch(
            "cair_lstm_step", x.device,
            x.data_ptr(), mask.data_ptr(), w_ih.data_ptr(), b.data_ptr(),
            w_hh.data_ptr(), out.data_ptr(), hb.data_ptr() if res else 0,
            cb.data_ptr() if res else 0, workspace.data_ptr(), B, T, Ep, Hp,
            int(reverse), tc, int(res), 0, _DTYPES[x.dtype], _stream(x))
    elif res:
        launch(
            "cair_lstm_fwd_res", x.device,
            x.data_ptr(), mask.data_ptr(), w_ih.data_ptr(), b.data_ptr(),
            out.data_ptr(), hb.data_ptr(), cb.data_ptr(), B, T, Ep, Hp,
            int(reverse), tc, _DTYPES[x.dtype], _stream(x))
    else:
        launch(
            "cair_lstm_fwd", x.device,
            x.data_ptr(), mask.data_ptr(), w_ih.data_ptr(), b.data_ptr(),
            out.data_ptr(), B, T, Ep, Hp, int(reverse), _DTYPES[x.dtype],
            _stream(x))
    return out, hb, cb, H


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
    out, _, _, H = _forward("lstm_fused", x, mask, w_ih, b, w_hh, reverse,
                            x.shape[1], False)
    lstm_fused.launches += 1
    return out if out.shape[-1] == H else out[..., :H].contiguous()


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
    out, hb, cb, H = _forward("lstm_fused_res", x, mask, w_ih, b, w_hh,
                              reverse, chunk_len(x.shape[1], time_chunk),
                              True)
    lstm_fused_res.launches += 1
    if out.shape[-1] != H:
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
    from .build import launch, load_library

    lib = load_library()
    dtype = _DTYPES[x.dtype]
    step = lstm_route(H, x.dtype) == "step"
    # the tensor-core kernels (float32: split TF32) read W^T out of the
    # staged W's own slabs (one matrix a rank of a cluster or, bf16, a unit
    # tile of the step route); a cluster's, or the step route's, dx is one
    # product after them with W_ih^T (bf16) or W_ih read as it lies
    # (float32).  The float32 step route reads W_ih, W_hh as given and
    # W_hh^T.
    w_dx = w_hh_t = None
    if x.dtype == torch.bfloat16 or not step:
        bf16 = x.dtype == torch.bfloat16
        x, w_ih, b, w_hh = pad_lstm_operands(
            x, w_ih, b, w_hh,
            (STEP_UNITS[x.dtype] if step else TILE_ALIGN) if bf16
            else max(TILE_ALIGN, 16 * f32_cluster(H)))
        Hp = w_hh.shape[0]
        hb, cb, dout = (_aligned(_pad_last(t, Hp)) for t in (hb, cb, dout))
        ranks = (Hp // STEP_UNITS[x.dtype] if step else lstm_cluster(Hp)
                 if bf16 else f32_cluster(Hp))
        staged = stage_lstm_weights(w_ih, w_hh, ranks)
        if ranks > 1:
            w_dx = w_ih.t().contiguous() if bf16 else w_ih
    else:
        staged, w_dx, w_hh_t = w_ih, w_ih, w_hh.t().contiguous()
    Ep, Hp = x.shape[-1], w_hh.shape[0]
    n_bytes = lib.cair_lstm_bwd_workspace(B, T, Ep, Hp, tc, dtype)
    if n_bytes < 0:
        raise ValueError(f"lstm_fused_bwd: invalid shape B={B} T={T} E={E} "
                         f"H={H}")
    workspace = torch.empty((n_bytes,), dtype=torch.uint8, device=x.device)
    dx = torch.empty_like(x)
    dw_ih, db, dw_hh = (torch.empty_like(w_ih), torch.empty_like(b),
                        torch.empty_like(w_hh))
    launch(
        "cair_lstm_bwd", x.device,
        x.data_ptr(), mask.data_ptr(), staged.data_ptr(), b.data_ptr(),
        w_hh.data_ptr(), *(0 if t is None else t.data_ptr()
                           for t in (w_dx, w_hh_t)),
        hb.data_ptr(), cb.data_ptr(), dout.data_ptr(), dx.data_ptr(),
        dw_ih.data_ptr(), db.data_ptr(), dw_hh.data_ptr(),
        workspace.data_ptr(), B, T, Ep, Hp, int(reverse), tc, dtype,
        _stream(x))
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
# 6.3e10 flops (0.064 ms): bound by bytes.  In bfloat16 at H = 128 it runs on
# ``csrc/lstm_mma.cuh``'s tensor-core tiles with W_hh resident in shared
# memory (``rec_tensor_cores``); float32 and bf16 H = 256 .. 512 keep the
# CUDA-core kernel; above 512, in both dtypes, the step route of kernels 1,
# 4, 5 with E = 0 (``csrc/lstm_step.cu``: its accumulators start from
# x_proj, a launch a time step), so any multiple of 128 runs.

MAX_HIDDEN_REC = 512  # the CUDA-core kernel's block (2H <= 1024 threads)
REC_HIDDEN = 128      # the tensor-core route's H (its tiles' constant)
REC_ROWS = 64         # rows a block of the tensor-core route


def rec_smem_bytes(h: int) -> int:
    """Dynamic shared memory of a block of ``REC_ROWS`` rows of kernel 6's
    tensor-core tiles at hidden size ``h``: 64 bytes of mbarriers, the
    resident W_hh (``h`` rows of 8h + 16 bytes), the x_proj tile (64 rows of
    8h + 16) and the bf16 h tile (64 rows of 2h + 16); 0 if it does not fit
    (``kRecSmem`` in ``csrc/lstm_rec.cu``).  217,152 bytes at h = 128; from
    h = 160 on W_hh and the tiles exceed a block's shared memory."""
    if h <= 0 or h % TILE_ALIGN:
        return 0
    w_row = 8 * h + 16
    n_bytes = 64 + (h + REC_ROWS) * w_row + REC_ROWS * (2 * h + 16)
    return n_bytes if n_bytes <= SMEM_LIMIT else 0


def rec_tensor_cores(h: int, dtype: torch.dtype) -> bool:
    """Whether kernel 6 takes its tensor-core route -- bfloat16 at H = 128,
    the one hidden size it holds (a multiple of 128) whose tiles fit -- and
    so reads the staged W_hh; the CUDA-core kernel runs otherwise.  The
    launcher ``cair_lstm_rec`` applies the same rule."""
    return dtype == torch.bfloat16 and h == REC_HIDDEN


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
    from .build import launch

    if lstm_route(H, x_proj.dtype, recurrence=True) == "step":
        dtype = x_proj.dtype
        Hp = step_hidden(H, dtype)
        if Hp != H:
            # zero gate blocks and W_hh rows: a padded unit's gates are 0,
            # its c and h stay exactly 0
            x_proj = _pad_gates(x_proj, H, Hp)
            w_hh = torch.nn.functional.pad(_pad_gates(w_hh, H, Hp),
                                           (0, 0, 0, Hp - H))
        x_proj = _aligned(x_proj)
        # bf16: the staged W_hh of each unit tile (an empty W_ih over it);
        # float32 reads W_hh as it is
        staged = (stage_lstm_weights(w_hh[:0], w_hh, Hp // STEP_UNITS[dtype])
                  if dtype == torch.bfloat16 else None)
        out = torch.empty((B, T, Hp), dtype=dtype, device=x_proj.device)
        workspace = _step_workspace(B, Hp, x_proj)
        launch(
            "cair_lstm_step", x_proj.device,
            x_proj.data_ptr(), mask.data_ptr(),
            0 if staged is None else staged.data_ptr(), 0,
            w_hh.data_ptr() if staged is None else 0, out.data_ptr(), 0, 0,
            workspace.data_ptr(), B, T, 0, Hp, int(reverse), 1, 0, 1,
            _DTYPES[dtype], _stream(x_proj))
        lstm_recurrence.launches += 1
        return out if Hp == H else out[..., :H].contiguous()
    if rec_tensor_cores(H, x_proj.dtype):
        # the tensor-core kernel bulk-copies the x_proj rows and the staged
        # W_hh (an empty W_ih over it: [H, 4H + 8]) into shared memory
        x_proj = _aligned(x_proj)
        w_hh = stage_lstm_weights(w_hh[:0], w_hh)
    out = torch.empty((B, T, H), dtype=x_proj.dtype, device=x_proj.device)
    launch(
        "cair_lstm_rec", x_proj.device,
        x_proj.data_ptr(), mask.data_ptr(), w_hh.data_ptr(), out.data_ptr(),
        B, T, H, int(reverse), _DTYPES[x_proj.dtype], _stream(x_proj))
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
    [B, T], w_hh [H, 4H] (one dtype, float32 or bfloat16; on the card H any
    multiple of 128, as the JAX kernel takes: one block up to 512, the step
    route above) -> h [B, T, H] in that dtype, from a zero state.

    The counterpart of the JAX ``lstm_pallas``: kernel 6 on CUDA tensors,
    its plain version on CPU tensors (``device="cpu"``), differentiable in
    ``x_proj`` and ``w_hh`` (``LSTMRecurrenceFn``).  ``launches`` counts the
    kernel's launches."""
    return LSTMRecurrenceFn.apply(x_proj, mask, w_hh, reverse, device)


lstm_recurrence.launches = 0
