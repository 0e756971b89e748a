"""Fused tied-generator step: top-kc + logsumexp of ``x @ table_t``.

Replaces the TPU kernels reached through ``generator_topk_lse`` in
``context_attentive_ir_tpu/ops/pallas/beamgen.py``, with their three
modes:

- the serial kernel ``_beamgen_kernel`` on a float table (kernel 2):
  ``csrc/beamgen.cu``.  Blocks own 64 rows and a contiguous run of
  128-column vocab tiles, keep a running top-kc and an online (max, sumexp)
  per row, and a second tiny kernel merges the vocab splits per row; the
  ``[R, V]`` logits never reach device memory.  A row's running top-kc
  takes only the tile's columns that beat its kc-th entry, inserted one by
  one, so the selection costs what enters the top-kc (the TPU's unpruned
  kernel merges every tile whole, a design for its vector unit);
  ``prune=True`` first votes four rows in lockstep and skips the rows
  whose tile holds no such column, as the TPU kernel skips the tile.  Both
  keep the exact top-kc with ties to the lower index, so they give the
  same bits.
- the same serial kernel on an int8 table with a per-column ``scale``
  (kernel 2's int8 mode, the quantized tied generator): logits are
  ``scale_v * (x @ q_v)``, the scale applied after the dot.
- the pipelined kernel ``_beamgen_pipelined_kernel`` (kernel 3,
  ``pipeline=True``, float table only): the product of the next vocab
  tile overlaps the selection of the current one.  It shares the tile
  product and the selection with kernel 2 (``csrc/beamgen_common.cuh``),
  so its outputs are kernel 2's bit for bit.

The score tiles are tensor-core products of the staged x rows and table
slabs streamed by ``cp.async``: ``mma.sync`` bf16 tiles on bf16 ``x`` (the
serving path; an int8 table widened to bf16 in shared memory), split-TF32
tiles on float32 ``x`` (each operand split into a TF32 hi and lo part, the
product lo*hi + hi*lo + hi*hi, about 21 of float32's 24 bits; an int8
table is exact in TF32, two products).  Kernel 3 runs the product and the
selection on two warp groups with two score buffers.  Every kernel takes
any E: past the E whose whole x tile a block's shared memory holds
(``beamgen_streams_x``), x is streamed in k-slabs beside the table's, the
products in the same k order.  The running top-kc takes any kc up to
``MAX_KC`` = 128, as the TPU kernel: a row's entries lie across its warp's
lanes, ``slots(kc)`` registers a lane.

Ties go to the lower vocab index, as ``lax.top_k``.  Each mode keeps its
own launch count: ``launches`` (float table, serial), ``launches_pruned``
(float table, ``prune=True``), ``launches_int8`` and
``launches_pipelined``.

The table is ``[E, V]`` with unit column stride; its rows may lie further
apart than V (a view of a padded table, as ``aligned_table`` and the
decoders' ``fused_generator_table`` build once per decode).  The kernels
copy 16-byte pieces, so a table whose rows are not a multiple of 16 bytes
apart is padded by the wrapper on every call; padded columns never reach
the logsumexp or the top-k.

Bound on the H100 (beam-5 step, R = 1600, E = 256, V = 50,000):
2*R*E*V = 4.1e10 flops, 41 us at the bf16 tensor-core peak against a
25.6 MB bf16 table (8 us; the int8 table 12.8 MB), 249 us at split TF32's
165 TFLOP/s against a 51.2 MB float32 table: compute-bound in every mode
and dtype.  ``PERF.md`` records each mode's time against that bound.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...device import check_on, resolve_device

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
MAX_KC = 128       # the running top-kc (kMaxK; the TPU kernel's _KPAD)
ROW_BLOCK = 64     # rows of a block (csrc/beamgen_common.cuh: kRowBlock)
TILE = 128         # vocab columns of a tile (kTile)
SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on the H100
# the tensor-core tiles (namespace tc): score buffer, ring of four slots of
# 32 k-rows, mbarrier header
_SCORE_BYTES = ROW_BLOCK * (TILE + 8) * 4
_STAGES, _KS = 4, 32
_HEADER = 64


def slots(kc: int) -> int:
    """Registers a lane gives each row's running top-kc (``slots_for``):
    entry p lies on lane p % 32 in slot p // 32."""
    return 1 if kc <= 32 else 2 if kc <= 64 else 4


def _smem_bytes(e: int, dtype: torch.dtype, pipeline: bool,
                stream: bool) -> int:
    size = 4 if dtype == torch.float32 else 2
    step = 8 if size == 4 else 16        # k of one mma (Tile<TX>::kStep)
    ep = -(-e // step) * step
    slab_row = TILE * size + (32 if size == 4 else 16)   # kWideRow
    x_slab = ROW_BLOCK * (_KS * size + 16)               # x_slab_bytes
    return ((_HEADER if pipeline else 0)
            + (0 if stream else ROW_BLOCK * (size * ep + 16))
            + (2 if pipeline else 1) * _SCORE_BYTES
            + _STAGES * (_KS * slab_row + (x_slab if stream else 0)))


def beamgen_streams_x(e: int, dtype: torch.dtype,
                      pipeline: bool = False) -> bool:
    """Whether a block streams x past E = ``e`` (``tc::stream_x``):
    exactly when the whole x tile does not fit -- bfloat16 E > 1,264
    (kernel 3: > 976), float32 E > 496 (> 352)."""
    return _smem_bytes(e, dtype, pipeline, False) > SMEM_LIMIT


def beamgen_smem_bytes(e: int, dtype: torch.dtype, pipeline: bool = False,
                       kc: int = 1) -> int:
    """Dynamic shared memory of a partial-kernel block at E = ``e`` and
    top-``kc`` for x of ``dtype`` (``plan`` in ``csrc/beamgen.cu``, which
    ``cair_beamgen_smem`` returns): (kernel 3's mbarriers,) the x tile of
    64 rows of ``ep(e)`` elements (E rounded up to one mma's k, 16 bf16 or
    8 float32, the last k step zero-filled) plus 16 bytes each unless x is
    streamed, one f32 score buffer (two for kernel 3) and the ring of four
    slots, each a [32, 128] table slab (rows of 272 bytes bf16, 544
    float32) and, streamed, its [64, 32] x slab.  The running top-kc lies
    in registers, so ``kc`` does not change the sum."""
    if not 1 <= kc <= MAX_KC:
        raise ValueError(f"kc={kc}: the kernels keep a running top-kc of "
                         f"1 to {MAX_KC} entries")
    return _smem_bytes(e, dtype, pipeline,
                       beamgen_streams_x(e, dtype, pipeline))


def beamgen_supported(e: int, dtype: torch.dtype,
                      pipeline: bool = False) -> bool:
    """Whether the kernels hold E = ``e`` for x of ``dtype``: every E >= 1
    (x streamed past the whole tile), as the JAX kernel, which pads any E.
    The launcher refuses exactly the E this rejects."""
    return e >= 1 and beamgen_smem_bytes(e, dtype, pipeline) <= SMEM_LIMIT


def table_aligned(table_t: torch.Tensor) -> bool:
    """Whether the kernels read ``table_t`` [E, V] as it lies: unit column
    stride, rows at least V and a multiple of 16 bytes apart, 16-byte
    aligned start."""
    row = table_t.stride(0)
    return (table_t.dim() == 2 and table_t.stride(1) == 1
            and row >= table_t.shape[1]
            and row * table_t.element_size() % 16 == 0
            and table_t.data_ptr() % 16 == 0)


def aligned_table(table_t: torch.Tensor) -> torch.Tensor:
    """``table_t`` [E, V] itself if the kernels read it as it lies, else
    the view ``[:, :V]`` of a zero-padded copy whose rows are a multiple
    of 16 bytes long."""
    if table_aligned(table_t):
        return table_t
    e, v = table_t.shape
    per = 16 // table_t.element_size()
    out = table_t.new_zeros((e, -(-v // per) * per))
    out[:, :v] = table_t
    return out[:, :v]


def vocab_splits(rows: int, v: int, slots: int) -> tuple[int, int]:
    """``(n_split, tiles_per_split)``: the vocab split of R rows into runs
    of 128-column tiles, every split owning at least one tile, the grid
    within one wave of the ``slots`` blocks resident on the card at once.
    The split decides the order of the lse merge, so the modes of one
    table must share it to share their bits."""
    row_blocks = max(1, -(-rows // ROW_BLOCK))
    tiles = -(-v // TILE)
    want = slots // row_blocks
    per = -(-tiles // max(1, min(tiles, want)))
    return -(-tiles // per), per


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(index: int, e: int, x_code: int, t_code: int,
                   n_slots: int = 1) -> int:
    """Blocks of the serial partial kernel one SM of card ``index`` holds
    at E = ``e`` with ``n_slots`` top-kc slots a lane (their registers set
    the bf16 kernel's residency; a float32 block's shared memory holds it
    to one)."""
    from .build import check, load_library

    blocks = ctypes.c_int()
    with torch.cuda.device(index):
        check(load_library().cair_beamgen_occupancy(
            e, 32 * n_slots, x_code, t_code, 0, 0, ctypes.byref(blocks)),
            "cair_beamgen_occupancy")
    return blocks.value


def generator_topk_lse_reference(x: torch.Tensor, table_t: torch.Tensor,
                                 kc: int, scale: torch.Tensor | None = None):
    """Plain PyTorch version: f32 logits, ``logsumexp``, and top-kc by a
    stable descending sort (ties to the lower index).  ``scale`` [V]
    selects the int8-table math of the JAX reference: ``x @
    table_t.to(bfloat16)`` with an f32 result, times ``scale``."""
    if scale is not None:
        logits = (x.float() @ table_t.to(torch.bfloat16).float()
                  * scale.float()[None, :])
    else:
        logits = x.float() @ table_t.float()
    lse = torch.logsumexp(logits, dim=-1)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[:, :kc], idx[:, :kc].to(torch.int32), lse


def _check_args(x, table_t, kc, scale, prune, pipeline):
    """The JAX wrapper's asserts as ValueErrors; returns (R, E, V)."""
    if prune and pipeline:
        raise ValueError("prune is a mode of the serial kernel only; it "
                         "cannot be combined with pipeline=True")
    if scale is not None and pipeline:
        raise ValueError("the int8-table mode (scale=) is serial-kernel "
                         "only; it cannot be combined with pipeline=True")
    if x.dim() != 2 or table_t.dim() != 2 or x.shape[1] != table_t.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and table_t "
                         f"{tuple(table_t.shape)} do not multiply")
    R, E = x.shape
    V = table_t.shape[1]
    if not 0 < kc <= V:
        raise ValueError(f"kc={kc} outside 1..V={V}")
    if scale is not None and tuple(scale.shape) != (V,):
        raise ValueError(f"scale must be [V] = [{V}], got "
                         f"{tuple(scale.shape)}")
    return R, E, V


def generator_topk_lse(x: torch.Tensor, table_t: torch.Tensor, kc: int,
                       scale: torch.Tensor | None = None,
                       prune: bool = False, pipeline: bool = False,
                       device="cuda"):
    """x [R, E], table_t [E, V] -> (vals [R, kc] f32, idx [R, kc] int32,
    lse [R] f32).

    Float mode: x and table_t share one dtype, float32 or bfloat16.  Int8
    mode (``scale`` [V] float32 given): table_t is int8 and x float32 or
    bfloat16.  ``prune`` and ``pipeline`` choose the kernel variant; every
    variant gives the same outputs.  ``prune`` with ``pipeline``, and
    ``scale`` with ``pipeline``, raise.  ``table_t`` may be a view with
    unit column stride whose rows lie further apart (``aligned_table``).

    On CUDA tensors this launches ``cair_beamgen`` (``kc <= MAX_KC`` = 128,
    any E); on CPU tensors (``device="cpu"``) it runs
    ``generator_topk_lse_reference`` at any ``1 <= kc <= V``."""
    dev = resolve_device(device)
    tensors = (x, table_t) if scale is None else (x, table_t, scale)
    check_on(dev, *tensors)
    R, E, V = _check_args(x, table_t, kc, scale, prune, pipeline)
    if dev.type == "cpu":
        return generator_topk_lse_reference(x, table_t, kc, scale)
    if dev.type != "cuda":
        raise ValueError(f"generator_topk_lse runs on cuda or cpu, not {dev}")
    if kc > MAX_KC:
        raise ValueError(f"kc={kc}: the kernels keep a running top-kc of at "
                         f"most {MAX_KC} entries")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if scale is None and table_t.dtype != x.dtype:
        raise TypeError("x and a float table_t must share one dtype; got "
                        f"{x.dtype}, {table_t.dtype}")
    if scale is not None and (table_t.dtype != torch.int8
                              or scale.dtype != torch.float32):
        raise TypeError("the int8 mode takes an int8 table_t and a float32 "
                        f"scale; got {table_t.dtype}, {scale.dtype}")
    if not x.is_contiguous() or (scale is not None
                                 and not scale.is_contiguous()):
        raise ValueError("generator_topk_lse needs a contiguous x and scale")
    from .build import launch

    table_t = aligned_table(table_t)  # a copy only for an unaligned table
    ldx = E
    per = 16 // x.element_size()
    if (beamgen_streams_x(E, x.dtype, pipeline)
            and (E % per or x.data_ptr() % 16)):
        # streamed x is copied in 16-byte pieces: rows whole pieces
        # apart, the padding zero
        ldx = -(-E // per) * per
        padded = x.new_zeros((R, ldx))
        padded[:, :E] = x
        x = padded
    index = (x.device.index if x.device.index is not None
             else torch.cuda.current_device())
    x_code, t_code = _DTYPES[x.dtype], _DTYPES[table_t.dtype]
    # sized by the serial kernel's residency at this kc whatever the mode:
    # every mode of one table merges the same partials in the same order,
    # so every mode gives the same bits (bf16 kernel 3, one block an SM,
    # runs the grid in two waves)
    n_split, per_split = vocab_splits(
        R, V, _sm_count(index) * _blocks_per_sm(index, E, x_code, t_code,
                                                slots(kc)))
    f32 = dict(dtype=torch.float32, device=x.device)
    i32 = dict(dtype=torch.int32, device=x.device)
    part_v = torch.empty((n_split, R, kc), **f32)
    part_i = torch.empty((n_split, R, kc), **i32)
    part_m = torch.empty((n_split, R), **f32)
    part_s = torch.empty((n_split, R), **f32)
    vals = torch.empty((R, kc), **f32)
    idx = torch.empty((R, kc), **i32)
    lse = torch.empty((R,), **f32)
    launch(
        "cair_beamgen", x.device,
        x.data_ptr(), table_t.data_ptr(),
        None if scale is None else scale.data_ptr(), R, E, ldx, V,
        table_t.stride(0), kc, n_split, per_split, part_v.data_ptr(),
        part_i.data_ptr(), part_m.data_ptr(), part_s.data_ptr(),
        vals.data_ptr(), idx.data_ptr(), lse.data_ptr(), x_code, t_code,
        int(prune), int(pipeline),
        torch.cuda.current_stream(x.device).cuda_stream)
    if pipeline:
        generator_topk_lse.launches_pipelined += 1
    elif scale is not None:
        generator_topk_lse.launches_int8 += 1
    elif prune:
        generator_topk_lse.launches_pruned += 1
    else:
        generator_topk_lse.launches += 1
    return vals, idx, lse


generator_topk_lse.launches = 0
generator_topk_lse.launches_pruned = 0
generator_topk_lse.launches_int8 = 0
generator_topk_lse.launches_pipelined = 0
