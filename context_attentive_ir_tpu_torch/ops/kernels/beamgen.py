"""Fused tied-generator step: top-kc + logsumexp of ``x @ table_t``.

Replaces the TPU kernels reached through ``generator_topk_lse`` in
``context_attentive_ir_tpu/ops/pallas/beamgen.py``, with their three
modes:

- the serial kernel ``_beamgen_kernel`` on a float table (kernel 2):
  ``csrc/beamgen.cu``.  Blocks own 64 rows and a contiguous run of
  128-column vocab tiles, keep a running top-kc and an online (max, sumexp)
  per row, and a second tiny kernel merges the vocab splits per row; the
  ``[R, V]`` logits never reach device memory.  ``prune=True`` skips a
  tile's selection passes for a row when no column of the tile beats the
  row's running kc-th entry; ``prune=False`` runs them on every tile, as
  the TPU's unpruned kernel.  Both give the same bits: tiles are swept in
  ascending order and ties go to the lower index, so a skipped tile could
  only have reproduced the buffer.
- the same serial kernel on an int8 table with a per-column ``scale``
  (kernel 2's int8 mode, the quantized tied generator): logits are
  ``scale_v * (x @ q_v)``, the scale applied after the dot.
- the pipelined kernel ``_beamgen_pipelined_kernel`` (kernel 3,
  ``pipeline=True``, float table only): the copy of the next table tile
  into shared memory (a two-stage ``cp.async`` ring) overlaps the FMAs and
  selection of the current one.  It shares the tile product and the
  selection with kernel 2 (``csrc/beamgen_common.cuh``), so its outputs
  are kernel 2's bit for bit.

Ties go to the lower vocab index, as ``lax.top_k``.  Each mode keeps its
own launch count: ``launches`` (float table, serial), ``launches_pruned``
(float table, ``prune=True``), ``launches_int8`` and
``launches_pipelined``.

Bound on the H100 (beam-5 step, R = 1600, E = 256, V = 50,000):
2*R*E*V = 4.1e10 flops, 41 us at the bf16 tensor-core peak, against a
25.6 MB bf16 table (8 us; the int8 table 12.8 MB): compute-bound in every
mode (``x`` stays bf16, so no int8 product applies).  These first versions
compute the scores with CUDA-core FMAs and run far above that bound;
``PERF.md`` records the gap.
"""

from __future__ import annotations

import ctypes

import torch

from ...device import check_on, resolve_device

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
MAX_KC = 32


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
    if not 0 < kc <= min(MAX_KC, V):
        raise ValueError(f"kc={kc} outside 1..min({MAX_KC}, V={V})")
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
    ``scale`` with ``pipeline``, raise.

    On CUDA tensors this launches ``cair_beamgen``; on CPU tensors
    (``device="cpu"``) it runs ``generator_topk_lse_reference``."""
    dev = resolve_device(device)
    tensors = (x, table_t) if scale is None else (x, table_t, scale)
    check_on(dev, *tensors)
    R, E, V = _check_args(x, table_t, kc, scale, prune, pipeline)
    if dev.type == "cpu":
        return generator_topk_lse_reference(x, table_t, kc, scale)
    if dev.type != "cuda":
        raise ValueError(f"generator_topk_lse runs on cuda or cpu, not {dev}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if scale is None and table_t.dtype != x.dtype:
        raise TypeError("x and a float table_t must share one dtype; got "
                        f"{x.dtype}, {table_t.dtype}")
    if scale is not None and (table_t.dtype != torch.int8
                              or scale.dtype != torch.float32):
        raise TypeError("the int8 mode takes an int8 table_t and a float32 "
                        f"scale; got {table_t.dtype}, {scale.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("generator_topk_lse needs contiguous tensors")
    from .build import check, load_library

    lib = load_library()
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits, tiles = ctypes.c_int(), ctypes.c_int()
    check(lib.cair_beamgen_splits(R, V, n_sm, ctypes.byref(splits),
                                  ctypes.byref(tiles)), "cair_beamgen_splits")
    n_split, per_split = splits.value, tiles.value
    f32 = dict(dtype=torch.float32, device=x.device)
    i32 = dict(dtype=torch.int32, device=x.device)
    part_v = torch.empty((n_split, R, kc), **f32)
    part_i = torch.empty((n_split, R, kc), **i32)
    part_m = torch.empty((n_split, R), **f32)
    part_s = torch.empty((n_split, R), **f32)
    vals = torch.empty((R, kc), **f32)
    idx = torch.empty((R, kc), **i32)
    lse = torch.empty((R,), **f32)
    # the launcher reports an E too large for its shared tile and a table
    # the pipelined kernel's 16-byte copies cannot stage
    check(lib.cair_beamgen(
        x.data_ptr(), table_t.data_ptr(),
        None if scale is None else scale.data_ptr(), R, E, V, kc, n_split,
        per_split, part_v.data_ptr(), part_i.data_ptr(), part_m.data_ptr(),
        part_s.data_ptr(), vals.data_ptr(), idx.data_ptr(), lse.data_ptr(),
        _DTYPES[x.dtype], _DTYPES[table_t.dtype], int(prune), int(pipeline),
        torch.cuda.current_stream(x.device).cuda_stream), "cair_beamgen")
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
