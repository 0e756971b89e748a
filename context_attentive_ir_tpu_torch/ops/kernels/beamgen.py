"""Fused tied-generator step: top-kc + logsumexp of ``x @ table_t``.

Replaces the TPU kernel ``_beamgen_kernel`` reached through
``generator_topk_lse`` in ``context_attentive_ir_tpu/ops/pallas/beamgen.py``
(serial kernel, float table).  The kernel is ``csrc/beamgen.cu``: blocks own
64 rows and a contiguous run of 128-column vocab tiles, keep a running
top-kc and an online (max, sumexp) per row, and a second tiny kernel merges
the vocab splits per row; the ``[R, V]`` logits never reach device memory.
Ties go to the lower vocab index, as ``lax.top_k``.

Bound on the H100 (beam-5 step, R = 1600, E = 256, V = 50,000):
2*R*E*V = 4.1e10 flops, 41 us at the bf16 tensor-core peak, against a
25.6 MB bf16 table (8 us): compute-bound.  This first version computes the
scores with CUDA-core FMAs and runs far above that bound; ``PERF.md``
records the gap.
"""

from __future__ import annotations

import ctypes

import torch

from ...device import check_on, resolve_device

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_KC = 32


def generator_topk_lse_reference(x: torch.Tensor, table_t: torch.Tensor,
                                 kc: int):
    """Plain PyTorch version: f32 logits, ``logsumexp``, and top-kc by a
    stable descending sort (ties to the lower index)."""
    logits = x.float() @ table_t.float()
    lse = torch.logsumexp(logits, dim=-1)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[:, :kc], idx[:, :kc].to(torch.int32), lse


def generator_topk_lse(x: torch.Tensor, table_t: torch.Tensor, kc: int,
                       device="cuda"):
    """x [R, E], table_t [E, V] (one dtype, float32 or bfloat16) ->
    (vals [R, kc] f32, idx [R, kc] int32, lse [R] f32).

    On CUDA tensors this launches ``cair_beamgen``; on CPU tensors
    (``device="cpu"``) it runs ``generator_topk_lse_reference``."""
    dev = resolve_device(device)
    check_on(dev, x, table_t)
    if x.dim() != 2 or table_t.dim() != 2 or x.shape[1] != table_t.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and table_t "
                         f"{tuple(table_t.shape)} do not multiply")
    R, E = x.shape
    V = table_t.shape[1]
    if not 0 < kc <= min(MAX_KC, V):
        raise ValueError(f"kc={kc} outside 1..min({MAX_KC}, V={V})")
    if dev.type == "cpu":
        return generator_topk_lse_reference(x, table_t, kc)
    if dev.type != "cuda":
        raise ValueError(f"generator_topk_lse runs on cuda or cpu, not {dev}")
    if x.dtype not in _DTYPES or table_t.dtype != x.dtype:
        raise TypeError("x and table_t must share one dtype, float32 or "
                        f"bfloat16; got {x.dtype}, {table_t.dtype}")
    if not (x.is_contiguous() and table_t.is_contiguous()):
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
    # the launcher reports an E too large for its shared tile
    check(lib.cair_beamgen(
        x.data_ptr(), table_t.data_ptr(), R, E, V, kc, n_split, per_split,
        part_v.data_ptr(), part_i.data_ptr(), part_m.data_ptr(),
        part_s.data_ptr(), vals.data_ptr(), idx.data_ptr(), lse.data_ptr(),
        _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream),
        "cair_beamgen")
    generator_topk_lse.launches += 1
    return vals, idx, lse


generator_topk_lse.launches = 0
