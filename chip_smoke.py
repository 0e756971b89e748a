#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``context_attentive_ir_tpu_torch``)
on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions;
2. the build of the kernel library from ``context_attentive_ir_tpu_torch/
   csrc`` (``nvcc`` for sm_90a, one process per source, timed);
3. every kernel against its plain PyTorch version on the card at every
   shape the main paths give it and at row counts off its row block, in
   float32 (TF32 off for matmuls and cuDNN) and bfloat16: the LSTM and GRU
   forwards (kernels 1 and 7) and training pairs (4 and 5, 8 and 9) output
   by output, also at a T the time chunk does not divide (kernels 5 and 9
   must give the same bits twice; kernel 4's output must be kernel 1's
   bits, kernel 8's kernel 7's), both pairs in bfloat16 also at the shapes
   that stress the tensor-core tiles (rows 1, 33 and 16,001, E = 300 with
   H = 100, H = 8, T = 1, T = 17, H = 64, 256 and 384), the LSTM
   recurrence on precomputed gates (kernel 6, with its autograd Function's
   gradients), kernel 9 in bf16 also with 16-row blocks off their block and
   at its limits (E = 672 at H = 128, H = 448 at E = 256), kernel 2,
   kernel 10 (slate pool) at the rank slate and suggest init's row counts
   and a row count off its tile at every width it holds (H = 128, 256, 384,
   512), at the tensor-core tiles' edges (T = 1, 7, 15, 17, 33, 64 and 65,
   the first T beyond a tile) with fully masked rows pooling to exactly 0,
   fewer than 8 rows refused, and its autograd Function's gradients,
   kernel 2's int8
   mode on a quantized table, and ``prune`` on and off and kernel 3
   (pipelined) against kernel 2, which must give the same bits, also on
   tables laid out as the decoders lay them (V = 50,004 with padded rows,
   the 4,096-word shortlist; kernel 3 at the greedy shape) and on a
   contiguous table with unaligned rows; then shapes a kernel cannot hold
   must be refused, and ``fused_supported`` / ``gru_fused_supported`` /
   ``beamgen_supported`` must say what the launchers take (each limit run,
   one past it refused);
4. the main paths at full width: CARS at the serving widths (vocab
   50,000, emsize 256, nhid 128, nhid_ffnn 256, S=5, N=50, Lq=15, Ld=30,
   bf16, seeded random weights) behind ``serve.Engine``: ``rank_batch``
   for 64 requests, beam-5 and greedy ``suggest_batch`` for 64 histories;
   the training path at the same widths with the default dropouts (8 Adam
   steps, an eval-loss step, a checkpoint -> ``Engine.from_checkpoint``
   round trip with equal scores); then the rest of serving: a
   20,000-document ``index_documents`` (also with the pooling projection
   cached), ``rank_indexed_batch`` for 64 requests x 50 ids in the
   broadcast and per-turn (click history) layouts and over the projection
   cache, ``rank_batch`` through the slate-pool kernel (equal to the
   indexed scores over the same documents), a beam-5
   ``Engine.from_checkpoint(quantize_embeddings=True)`` over the trained
   checkpoint, a beam-5 ``Engine(suggest_shortlist=4096)``, and beam-5
   decodes through the unpruned and the pipelined generator (tokens and
   scores equal to the Engine's pruned decode), with small float32
   indexed, int8 and shortlist Engines card vs CPU; then the GRU slice:
   CARS with GRU encoders and session recurrences (``rank_batch``, beam-5
   ``suggest_batch``, 8 Adam steps and an eval-loss step) and HRED-QS with
   GRUs (beam-5 and greedy ``suggest_batch``, 8 Adam steps, a checkpoint
   -> ``Engine.from_checkpoint`` round trip with equal suggestions); and
   small float32 CARS (LSTM), CARS (GRU) and HRED-QS Engines and train
   steps card vs CPU; then the doc encoder's two directions as one
   ``torch.matmul`` projection + kernel 6 (``lstm_precomputed``, held to
   kernel 1 on the same weights); then the training entry point
   (``trainer_fit``): ``cli.main.main`` trains CARS on a
   seeded AOL-scale fixture of 5,120 sessions with a 50,000-word
   vocabulary (B = 64, the ModelConfig training defaults, beam-5
   validation on 256 sessions) for 2 epochs, tests, reproduces the test
   metrics with ``--only_test`` and resumes for one more epoch, then the
   input pipeline, the training loop, validation and the early exit of
   the trained decoder are timed; the same once for HRED-QS with GRUs on
   the first 1,280 sessions (``trainer_fit_hredqs``, 2 epochs).  Every
   call runs with every launch count set to 0
   just before it and read just after it and must launch exactly the
   kernels ``PATH_KERNELS`` names (``EXACT_LAUNCHES`` times, where fixed);
   each is timed (three steady walls) and profiled once;
5. kernel, plain-version and library times (CUDA events after warm-up)
   with each kernel's bound, printed as one ``{"kernels": [...]}`` line,
   the redesigned kernels' earlier times beside them in the log, kernel 9
   with 16-row and 64-row blocks at the query and doc encoders' shapes,
   and the train steps' times.

The last line is ``{"ok": true, "device": {...}}``.  The script needs a
card: without one it exits non-zero and prints no result.

``python3 chip_smoke.py --only PHASE[,PHASE...]`` runs the build and those
phases alone, for work on them: ``kernels`` (every kernel against its plain
version, the refusals, the timing rows), ``lstm`` (kernels 1, 4, 5 and 6
alone: checks and timing rows), ``grukernels`` (kernels 7, 8 and 9 alone:
checks and timing rows), ``beamkernels`` (kernels 2 and 3 alone: checks,
limits and timing rows), ``slatekernels`` (kernel 10 alone: checks,
refusals and timing rows), ``serving`` (``rank_batch``, beam-5 and
greedy ``suggest_batch``), ``train`` (the CARS train steps and the
checkpoint round trip), ``indexed`` (the rest of serving; runs ``train``
first for its checkpoint), ``gru`` (CARS-GRU and HRED-QS), ``small`` (the
small float32 models card vs CPU), ``kernel6`` (``lstm_precomputed``),
``trainer`` (``cli.main`` for CARS and HRED-QS).  Every phase prints its
seconds.  Such a run prints its kernel rows as a "partial run" line and no
ok line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import logging
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# published H100 SXM peaks (dense), see PERF.md
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12

# main-path widths (the serving configuration of bench.py)
VOCAB, EMSIZE, NHID, NHID_FFNN = 50_000, 256, 128, 256
B, S, N, LQ, LD = 64, 5, 50, 15, 30
BEAM = 5
MAX_CLICKS = 4  # ModelConfig.suggest_max_clicks: clicked docs per turn
N_CORPUS = 20_000  # documents in the cached-document index
SHORTLIST = 4096   # suggestion shortlist of the shortlist Engine
TRAIN_STEPS = 8
TIME_CHUNK = 6  # the training pair's time chunk (lstm_fused_train default)


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, n_bytes: float, dtype) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# -- phase 3: kernels against their plain versions ---------------------------


def lstm_inputs(gen, dtype, rows=B * S * N, steps=LD, e=EMSIZE, h=NHID):
    dev = "cuda"
    x = torch.randn((rows, steps, e), generator=gen, device=dev) * 0.5
    w_ih = torch.randn((e, 4 * h), generator=gen, device=dev) * 0.08
    b = torch.randn((4 * h,), generator=gen, device=dev) * 0.1
    w_hh = torch.randn((h, 4 * h), generator=gen, device=dev) * 0.08
    lens = torch.randint(0, steps + 1, (rows,), generator=gen, device=dev)
    lens[0] = steps
    if rows > 1:
        lens[1] = 0
    mask = torch.arange(steps, device=dev)[None, :] < lens[:, None]
    return [t.to(dtype) for t in (x, w_ih, b, w_hh)], mask


def gru_inputs(gen, dtype, rows=B * S * N, steps=LD, e=EMSIZE, h=NHID):
    """GRU operands ``[x, w_ih, b_ih, w_hh, b_hh]`` in ``dtype`` and a
    length mask with row 0 full and row 1 fully masked."""
    dev = "cuda"
    x = torch.randn((rows, steps, e), generator=gen, device=dev) * 0.5
    w_ih = torch.randn((e, 3 * h), generator=gen, device=dev) * 0.08
    b_ih = torch.randn((3 * h,), generator=gen, device=dev) * 0.1
    w_hh = torch.randn((h, 3 * h), generator=gen, device=dev) * 0.08
    b_hh = torch.randn((3 * h,), generator=gen, device=dev) * 0.1
    lens = torch.randint(0, steps + 1, (rows,), generator=gen, device=dev)
    lens[0] = steps
    if rows > 1:
        lens[1] = 0
    mask = torch.arange(steps, device=dev)[None, :] < lens[:, None]
    return [t.to(dtype) for t in (x, w_ih, b_ih, w_hh, b_hh)], mask


# the fused recurrent kernels, by recurrence: (module under
# ops/kernels, operand maker, names of the training pair's outputs)
RNNS = {
    "lstm": (lstm_inputs,
             ("out", "hb", "cb", "dx", "dw_ih", "db", "dw_hh")),
    "gru": (gru_inputs,
            ("out", "hb", "dx", "dw_ih", "db_ih", "dw_hh", "db_hh")),
}


def rnn_kernels(rnn: str):
    """The kernel module of ``rnn`` (``ops/kernels/{lstm,gru}.py``)."""
    import importlib

    return importlib.import_module(
        f"context_attentive_ir_tpu_torch.ops.kernels.{rnn}")


# (rows, steps) the forward kernels (1, 7) see on the main paths -- doc
# encoder, query encoder (also HRED-QS's), suggest's clicked-doc encoder --
# plus row counts off the 32-row block, so the last block's row guard is
# checked at serving widths
LSTM_SHAPES = ((B * S * N, LD), (B * S, LQ), (B * S * MAX_CLICKS, LD),
               (B * S * N + 7, LD), (B * S * MAX_CLICKS + 5, LD),
               (B * S + 13, LQ))


def forward_errors(name: str, kernel, plain, make_inputs) -> dict:
    """Worst abs error per dtype of a forward kernel against its plain
    version over LSTM_SHAPES, both directions: f32 abs (tol 1e-4), bf16
    relative to max |plain| (tol 2e-2); masked outputs, fully masked rows
    and the padded steps a reversed walk starts with included, must be
    exactly 0.  ``make_inputs(dtype, rows, steps) -> (x, mask, weights)``;
    the kernel is called as ``kernel(x, mask, *weights, reverse)``."""
    out = {}
    for dtype, tol, kind in ((torch.float32, 1e-4, "abs"),
                             (torch.bfloat16, 2e-2, "rel")):
        out[dtype] = 0.0
        for rows, steps in LSTM_SHAPES:
            x, mask, w = make_inputs(dtype, rows, steps)
            worst_abs = worst_rel = 0.0
            for reverse in (False, True):
                got = kernel(x, mask, *w, reverse).float()
                ref = plain(x, mask, *w, reverse).float()
                torch.cuda.synchronize()
                if not bool((got[~mask] == 0).all()):
                    raise AssertionError(f"{name}: masked outputs not zero")
                err = float((got - ref).abs().max())
                worst_abs = max(worst_abs, err)
                worst_rel = max(worst_rel, err / float(ref.abs().max()))
            worst = worst_abs if kind == "abs" else worst_rel
            log(f"{name} {dtype} [{rows},{steps},{x.shape[2]}]->"
                f"{ref.shape[-1]} both directions: max abs err "
                f"{worst_abs:.3e}, max rel err {worst_rel:.3e} (tol {kind} "
                f"{tol:g}; masked outputs 0)")
            if not worst <= tol:
                raise AssertionError(f"{name} {dtype} [{rows},{steps}]: "
                                     f"{kind} error {worst} > {tol}")
            out[dtype] = max(out[dtype], worst_abs)
    return out


def check_forward(gen, rnn: str) -> dict:
    """The forward kernel of ``rnn`` (kernel 1 or 7) through
    ``forward_errors``."""
    mod = rnn_kernels(rnn)
    name = f"{rnn}_fused"

    def make_inputs(dtype, rows, steps):
        (x, *w), mask = RNNS[rnn][0](gen, dtype, rows, steps)
        return x, mask, w

    return forward_errors(name, getattr(mod, name),
                          getattr(mod, name + "_reference"), make_inputs)


# (rows, steps) the training pairs (kernels 4/5, 8/9) see on the main paths
# -- doc encoder, query encoder (also HRED-QS's) -- plus row counts off the
# 32-row block and a T that the time chunk (6) does not divide (Lq = 15 is
# one already)
TRAIN_SHAPES = ((B * S * N, LD), (B * S, LQ), (B * S * N + 7, LD),
                (B * S + 13, LQ), (333, 17))


def pair_errors(gen, rnn: str, dtype, rows, steps, reverse, **widths) -> dict:
    """The training pair of ``rnn`` against its plain versions on the same
    inputs (the backward kernel and its plain version both read the
    residual kernel's boundary state): per output, (max abs error, max abs
    error / max |plain|).  The backward kernel must give the same bits
    twice (no atomics), and the residual kernel's output must be the
    forward kernel's bits (kernel 4 = kernel 1, kernel 8 = kernel 7).
    ``widths``: ``e`` and ``h`` other than the main path's."""
    mod = rnn_kernels(rnn)
    inputs, names = RNNS[rnn]
    res, bwd = f"{rnn}_fused_res", f"{rnn}_fused_bwd"
    (x, *w), mask = inputs(gen, dtype, rows, steps, **widths)
    fwd = getattr(mod, res)(x, mask, *w, reverse, TIME_CHUNK)
    ref = getattr(mod, res + "_reference")(x, mask, *w, reverse, TIME_CHUNK)
    out, state = fwd[0], fwd[1:]
    dout = (torch.randn(out.shape, generator=gen, device="cuda")
            * 0.5).to(dtype)
    got_b = getattr(mod, bwd)(x, mask, *w, *state, dout, reverse, TIME_CHUNK)
    again = getattr(mod, bwd)(x, mask, *w, *state, dout, reverse, TIME_CHUNK)
    ref_b = getattr(mod, bwd + "_reference")(x, mask, *w, *state, dout,
                                            reverse, TIME_CHUNK)
    torch.cuda.synchronize()
    if not bool((out[~mask] == 0).all()):
        raise AssertionError(f"{res}: masked outputs not zero")
    if not same_bits(got_b, again):
        raise AssertionError(f"{bwd}: two runs differ")
    # the residual kernel is the forward plus the boundaries: the same
    # output bits
    with torch.no_grad():
        alone = getattr(mod, f"{rnn}_fused")(x, mask, *w, reverse)
    if not same_bits((alone,), (out,)):
        raise AssertionError(f"{res}: output bits differ from "
                             f"{rnn}_fused's")
    errs = {}
    for name, g, r in zip(names, (*fwd, *got_b), (*ref, *ref_b)):
        err = float((g.float() - r.float()).abs().max())
        errs[name] = (err, err / max(float(r.float().abs().max()), 1e-30))
    return errs


# per output, max abs error / max |plain| (the forward kernels' tolerances:
# float32 sums in another order; bf16 h and gate gradients rounded from f32
# values that differ in their last bits)
PAIR_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def check_train_pair(gen, rnn: str) -> dict:
    """The training pair of ``rnn`` (kernels 4 and 5, or 8 and 9) over
    TRAIN_SHAPES, both directions, f32 and bf16; returns each kernel's
    worst max abs error per dtype."""
    res, bwd = f"{rnn}_fused_res", f"{rnn}_fused_bwd"
    n_res = RNNS[rnn][1].index("dx")   # outputs of the residual kernel
    worst = {res: {}, bwd: {}}
    for dtype in (torch.float32, torch.bfloat16):
        tol = PAIR_TOL[dtype]
        for kernel in worst:
            worst[kernel][dtype] = 0.0
        for rows, steps in TRAIN_SHAPES:
            for reverse in (False, True):
                errs = pair_errors(gen, rnn, dtype, rows, steps, reverse)
                log(f"{rnn} train pair {dtype} [{rows},{steps},{EMSIZE}]->"
                    f"{NHID} TC={TIME_CHUNK} "
                    f"{'reverse' if reverse else 'forward'}: " +
                    ", ".join(f"{k} {a:.2e} ({r:.2e})"
                              for k, (a, r) in errs.items()) +
                    f" (abs (rel); tol rel {tol:g}; {bwd} same bits twice)")
                bad = {k: r for k, (_, r) in errs.items() if not r <= tol}
                if bad:
                    raise AssertionError(f"{rnn} train pair {dtype} [{rows},"
                                         f"{steps}] reverse={reverse}: "
                                         f"{bad} > {tol}")
                for i, (a, _) in enumerate(errs.values()):
                    kernel = res if i < n_res else bwd
                    worst[kernel][dtype] = max(worst[kernel][dtype], a)
    return worst


# (rows, steps, E, H) that stress the bf16 tensor-core tiles of kernels 1, 4
# and 5 and of kernels 7 and 8 (with kernel 9 fed their boundaries): rows
# off the 64-row block (1, 33, 16,001), E and H that are not multiples of 32
# (zero-padded by the wrapper), T = 1, a T the time chunk does not divide,
# and the hidden sizes of each block layout (H <= 64, 128, 256, above)
TILE_SHAPES = ((1, LD, EMSIZE, NHID), (33, LD, EMSIZE, NHID),
               (B * S * N + 1, LD, EMSIZE, NHID), (70, 7, 300, 100),
               (70, 7, 64, 8), (40, 1, EMSIZE, NHID), (130, 17, EMSIZE, NHID),
               (200, 9, 64, 64), (100, 8, EMSIZE, 256), (50, 7, 128, 384))


def check_tiles(gen, rnn: str, shapes=TILE_SHAPES) -> dict:
    """The training pair of ``rnn`` and its forward in bf16 over
    ``shapes``, both directions, each output against its plain version
    (rel 2e-2); masked outputs (rows whose mask is all False included)
    exactly 0, the backward the same bits twice, the residual kernel's
    output the forward's bits.  Returns the worst max abs error of the
    residual kernel and of the backward."""
    dtype = torch.bfloat16
    tol = PAIR_TOL[dtype]
    res, bwd = f"{rnn}_fused_res", f"{rnn}_fused_bwd"
    n_res = RNNS[rnn][1].index("dx")
    worst = {res: 0.0, bwd: 0.0}
    for rows, steps, e, h in shapes:
        for reverse in (False, True):
            errs = pair_errors(gen, rnn, dtype, rows, steps, reverse,
                               e=e, h=h)
            log(f"{rnn} tiles bf16 [{rows},{steps},{e}]->{h} "
                f"{'reverse' if reverse else 'forward'}: " +
                ", ".join(f"{k} {a:.2e} ({r:.2e})"
                          for k, (a, r) in errs.items()) +
                f" (abs (rel); tol rel {tol:g}; {bwd} same bits twice, "
                f"{res} = {rnn}_fused bits)")
            bad = {k: r for k, (_, r) in errs.items() if not r <= tol}
            if bad:
                raise AssertionError(f"{rnn} tiles [{rows},{steps},{e}]->{h} "
                                     f"reverse={reverse}: {bad} > {tol}")
            for i, (a, _) in enumerate(errs.values()):
                k = res if i < n_res else bwd
                worst[k] = max(worst[k], a)
    return worst


# kernel 9 in bf16 beyond TILE_SHAPES: 16-row blocks at rows off their
# block (the query encoder's B*S + 13; the doc encoder's row counts take
# 64-row blocks, TILE_SHAPES' 16,001 rows off theirs), and its new limits
# (E = 672 at H = 128, H = 448 at E = 256; gru_fused_supported)
GRU_TILE_SHAPES = ((B * S + 13, LQ, EMSIZE, NHID), (70, 7, 672, NHID),
                   (40, 5, EMSIZE, 448))


def tile_note() -> str:
    """The mma flavour and shared-memory bytes of the redesigned kernels at
    the main path's widths."""
    from context_attentive_ir_tpu_torch.ops.kernels.beamgen import (
        beamgen_smem_bytes,
    )
    from context_attentive_ir_tpu_torch.ops.kernels.lstm import (
        tile_smem_bytes,
    )
    from context_attentive_ir_tpu_torch.ops.kernels.slate import (
        pool_smem_bytes,
    )

    return (f"tiles at E={EMSIZE} H={NHID} bf16: lstm_fused / lstm_fused_res "
            "mma.sync.m16n8k16 (bf16 in, f32 accumulate) + ldmatrix + a "
            "cp.async.bulk / mbarrier weight ring, "
            f"{tile_smem_bytes(EMSIZE, NHID)} bytes of "
            "dynamic shared memory a block of 64 rows; lstm_fused_bwd phase "
            f"A the same, {tile_smem_bytes(EMSIZE, NHID, backward=True)} "
            "bytes; gru_fused / gru_fused_res the same tiles with three "
            f"gate blocks, {tile_smem_bytes(EMSIZE, NHID, gates=3)} bytes a "
            "block of 64 rows; phase B (dW, shared with gru_fused_bwd) "
            "mma.sync.m16n8k16 + ldmatrix.trans, 69632 bytes a 128 x 128 "
            "tile; generator_topk_lse bf16 mma.sync.m16n8k16 + ldmatrix "
            "over a cp.async slab ring, "
            f"{beamgen_smem_bytes(EMSIZE, torch.bfloat16)} bytes a block of "
            "64 rows (kernel 3: "
            f"{beamgen_smem_bytes(EMSIZE, torch.bfloat16, True)}, two score "
            "buffers); gru_fused_bwd phase A the GRU tiles with a four-slot "
            "gradient tile, "
            f"{tile_smem_bytes(EMSIZE, NHID, backward=True, gates=3)} bytes "
            "a block of 64 rows, "
            f"{tile_smem_bytes(EMSIZE, NHID, True, 3, rows=16)} of 16; "
            "attn_pool bf16 mma.sync.m16n8k16 + ldmatrix on 64-token "
            "document tiles from a two-buffer cp.async.bulk ring, "
            f"{pool_smem_bytes(H2)} bytes a persistent block (H = {H2}), "
            f"{pool_smem_bytes(128)} at H = 128")


GRU_KERNELS = ("gru_fused", "gru_fused_res", "gru_fused_bwd")


def recurrence_inputs(gen, dtype, rows=B * S * N, steps=LD, h=NHID):
    """Kernel 6's operands from ``lstm_inputs``: ``x_proj = x @ W_ih + b``
    by ``torch.matmul`` (in ``dtype``), the mask, ``w_hh``."""
    (x, w_ih, b, w_hh), mask = lstm_inputs(gen, dtype, rows, steps, h=h)
    return (torch.matmul(x, w_ih) + b).contiguous(), mask, w_hh


def check_recurrence(gen) -> dict:
    """Kernel 6 against its plain version through ``forward_errors``, then
    ``lstm_recurrence``'s gradients (its autograd Function) against
    autograd of the plain version."""
    from context_attentive_ir_tpu_torch.ops.kernels.lstm import (
        lstm_recurrence,
        lstm_recurrence_fwd,
        lstm_recurrence_reference,
    )

    def make_inputs(dtype, rows, steps):
        xp, mask, w_hh = recurrence_inputs(gen, dtype, rows, steps)
        return xp, mask, [w_hh]

    out = forward_errors("lstm_recurrence", lstm_recurrence_fwd,
                         lstm_recurrence_reference, make_inputs)

    xp, mask, w_hh = recurrence_inputs(gen, torch.float32, 40, 9)
    g = torch.randn((40, 9, NHID), generator=gen, device="cuda")
    for reverse in (False, True):
        grads = []
        for fn in (lstm_recurrence, lstm_recurrence_reference):
            inputs = [t.clone().requires_grad_() for t in (xp, w_hh)]
            fn(inputs[0], mask, inputs[1], reverse).backward(g)
            grads.append([t.grad for t in inputs])
        gerr = max(float((a - r).abs().max()) for a, r in zip(*grads))
        log(f"lstm_recurrence [40,9,{4 * NHID}] f32 reverse={reverse}: "
            f"dx_proj, dw_hh vs autograd of the plain version max abs err "
            f"{gerr:.3e} (tol 1e-5)")
        if not gerr <= 1e-5:
            raise AssertionError("lstm_recurrence gradients disagree")
    return out


def beamgen_inputs(gen, rows, dtype, integer):
    dev = "cuda"
    if integer:
        x = torch.randint(-3, 4, (rows, EMSIZE), generator=gen, device=dev)
        t = torch.randint(-3, 4, (EMSIZE, VOCAB), generator=gen, device=dev)
    else:
        x = torch.randn((rows, EMSIZE), generator=gen, device=dev) * 0.5
        t = torch.randn((EMSIZE, VOCAB), generator=gen, device=dev) * 0.5
    return x.to(dtype), t.to(dtype)


def near_tie_positions(rv: torch.Tensor, kc: int) -> torch.Tensor:
    """[R, kc] bool: top-kc position p of the reference's top-(kc+1)
    values ``rv`` lies within 1e-5 (relative to the row's largest value)
    of its neighbour p-1 or p+1, so a kernel whose f32 sums run in another
    order may rank the tied entries either way there and only there."""
    scale = rv.abs().amax(-1, keepdim=True)
    tie = (rv[:, :-1] - rv[:, 1:]).abs() <= 1e-5 * scale  # p ~ p+1
    covered = tie.clone()
    covered[:, 1:] |= tie[:, :kc - 1]  # p ~ p-1
    return covered


def hold(name: str, out, x, tt, kc: int, integer: bool,
         scale=None) -> float:
    """``out`` = (vals, idx, lse) of a generator kernel against
    ``generator_topk_lse_reference`` on the same inputs.  Integer-valued
    data: vals and idx exact, lse within 1e-6 relative.  Random data: an
    index may differ from the plain version's only at a near-tie position,
    and must score (in the plain f32 logits) what the plain version has
    there; no repeated index; vals and lse within 1e-5 relative.  Returns
    the max abs error of vals."""
    from context_attentive_ir_tpu_torch.ops.kernels.beamgen import (
        generator_topk_lse_reference,
    )

    v, i, lse = out
    rows = x.shape[0]
    rv, ri, rlse = generator_topk_lse_reference(x, tt, kc + 1, scale)
    torch.cuda.synchronize()
    lse_rel = float(((lse - rlse).abs() / rlse.abs()).max())
    v_err = float((v - rv[:, :kc]).abs().max())
    if integer:
        exact = torch.equal(v, rv[:, :kc]) and torch.equal(i, ri[:, :kc])
        log(f"{name}: vals/idx exact={exact}, lse max rel err "
            f"{lse_rel:.3e}")
        if not exact or lse_rel > 1e-6:
            raise AssertionError(f"{name} disagrees")
        return v_err
    top = rv.abs().amax(-1, keepdim=True)
    logits = x.float() @ tt.float()
    if scale is not None:
        logits = logits * scale[None, :]
    got = logits.gather(1, i.long())
    del logits
    miss = i != ri[:, :kc]
    unexplained = miss & ~near_tie_positions(rv, kc)
    off = ((got - rv[:, :kc]).abs() > 1e-5 * top).any(-1)
    dup = (i.sort(-1).values.diff(dim=-1) == 0).any(-1)
    n_miss = int(miss.any(-1).sum())
    n_unexplained = int(unexplained.any(-1).sum())
    n_off, n_dup = int(off.sum()), int(dup.sum())
    v_rel = v_err / float(rv.abs().max())
    log(f"{name}: idx mismatch rows {n_miss}/{rows} (outside a near tie "
        f"{n_unexplained}, index scoring off its value {n_off}, repeated "
        f"index {n_dup}), vals max abs err {v_err:.3e} (rel {v_rel:.3e}), "
        f"lse max rel err {lse_rel:.3e}")
    if n_unexplained or n_off or n_dup or v_rel > 1e-5 or lse_rel > 1e-5:
        raise AssertionError(f"{name} disagrees")
    return v_err


def check_beamgen(gen) -> dict:
    """Kernel 2 against its plain version at the decode steps' shapes
    (beam-5 and greedy rows) and at row counts off the 64-row block."""
    from context_attentive_ir_tpu_torch.ops.kernels.beamgen import (
        generator_topk_lse,
    )

    out = {}
    for rows, kc in ((B * S * BEAM, BEAM + 1), (B * S, 2),
                     (B * S * BEAM + 5, BEAM + 1), (B * S + 3, 2)):
        for dtype in (torch.float32, torch.bfloat16):
            for integer in (True, False):
                x, tt = beamgen_inputs(gen, rows, dtype, integer)
                name = (f"generator_topk_lse R={rows} kc={kc} {dtype} "
                        f"{'integer' if integer else 'random'}")
                v_err = hold(name, generator_topk_lse(x, tt, kc), x, tt, kc,
                             integer)
                if rows == B * S * BEAM and not integer:
                    out[dtype] = v_err
    return out


# (rows, steps, H) kernel 10 sees on the main path -- the rank slate B*S*N and
# suggest init's clicked docs B*S*C -- plus a row count off its 2-document
# tile, at the documents' Ld and every width it holds (H % 128 == 0 up to
# 512: tensor cores in bf16 at 128 and 256, the CUDA-core kernel otherwise)
H2 = 2 * NHID
SLATE_ROWS = (B * S * N, B * S * N + 7, B * S * MAX_CLICKS)
SLATE_SHAPES = tuple((r, LD, h) for h in (128, 256, 384, 512)
                     for r in SLATE_ROWS)
# the tensor-core tiles' edges at 333 rows: T = 1 (four documents of 16
# rows a tile), 7, 15, 17 (two of 32), 33 (one of 48), 64 (one of 64, the
# limit), 65 (beyond it: the CUDA-core kernel)
SLATE_SHAPES += tuple((333, t, h) for h in (128, 256)
                      for t in (1, 7, 15, 17, 33, 64, 65))


def slate_inputs(gen, dtype, rows, steps, h=H2):
    """Encoder-like inputs: states in (-1, 1), zero where masked; rows 0
    and 5 fully masked, row 1 fully valid."""
    dev = "cuda"

    def uniform(*shape, scale=1.0):
        return (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * scale

    lens = torch.randint(0, steps + 1, (rows,), generator=gen, device=dev)
    lens[0], lens[1], lens[5] = 0, steps, 0
    mask = torch.arange(steps, device=dev)[None, :] < lens[:, None]
    states = uniform(rows, steps, h) * mask[..., None]
    query = uniform(rows, h)
    w_p = uniform(h, h, scale=math.sqrt(6.0 / (2 * h)))   # glorot
    b_p = uniform(h, scale=0.1)
    return [t.to(dtype) for t in (states, query, w_p, b_p)], mask


def check_slate(gen) -> dict:
    """Kernel 10 against its plain version over SLATE_SHAPES: f32 with TF32
    off, max abs error (tol 1e-4); bf16 against the plain version run in
    f32 on the same bf16 inputs (the kernel keeps f32 inside and rounds
    only its output), max abs error / max |plain| (tol 2e-2), with the
    error against the plain version run in bf16 beside it.  Fully masked
    rows must pool to exactly 0, and fewer than 8 rows are refused.  Then
    AttnPoolFn's input gradients at a small shape against autograd of the
    plain version.  Returns each dtype's worst max abs error at the rank
    slate's shape."""
    from context_attentive_ir_tpu_torch.ops.kernels.slate import (
        AttnPoolFn,
        attn_pool,
        attn_pool_reference,
    )

    out = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        out[dtype] = 0.0
        for rows, steps, h in SLATE_SHAPES:
            (s, q, w, b), mask = slate_inputs(gen, dtype, rows, steps, h)
            got = attn_pool(s, mask, q, w, b).float()
            ref = attn_pool_reference(s.float(), mask, q.float(), w.float(),
                                      b.float())
            same_dtype = attn_pool_reference(s, mask, q, w, b).float()
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            rel = err / float(ref.abs().max())
            err_plain = float((got - same_dtype).abs().max())
            empty = ~mask.any(-1)
            zeros = bool((got[empty] == 0).all())
            worst = err if dtype == torch.float32 else rel
            log(f"attn_pool {dtype} [{rows},{steps},{h}]: max abs err "
                f"{err:.3e} (rel {rel:.3e}; vs the plain version in "
                f"{dtype} {err_plain:.3e}), {int(empty.sum())} fully "
                f"masked rows exactly 0: {zeros} (tol "
                f"{'abs' if dtype == torch.float32 else 'rel'} {tol:g})")
            if not (worst <= tol and zeros):
                raise AssertionError(f"attn_pool {dtype} [{rows},{steps}] "
                                     "disagrees")
            if (rows, steps, h) == (B * S * N, LD, H2):
                out[dtype] = err

    # fewer than 8 rows: refused at every width and dtype (pool_supported)
    for h in (128, 256, 384, 512):
        for dtype in (torch.float32, torch.bfloat16):
            (s, q, w, b), mask = slate_inputs(gen, dtype, 7, LD, h)
            try:
                attn_pool(s, mask, q, w, b)
            except ValueError as err:
                refused = str(err)
            else:
                raise AssertionError(f"attn_pool {dtype} R=7 H={h} was not "
                                     "refused")
    log(f"attn_pool R=7 refused at H = 128, 256, 384, 512 in both dtypes "
        f"({refused})")

    (s, q, w, b), mask = slate_inputs(gen, torch.float32, 40, 9)
    g = torch.randn((40, H2), generator=gen, device="cuda")
    grads = []
    for fn in (lambda *a: AttnPoolFn.apply(*a[:1], mask, *a[1:], "cuda"),
               lambda *a: attn_pool_reference(a[0], mask, *a[1:])):
        inputs = [t.clone().requires_grad_() for t in (s, q, w, b)]
        fn(*inputs).backward(g)
        grads.append([t.grad for t in inputs])
    gerr = max(float((a - r).abs().max()) for a, r in zip(*grads))
    log(f"AttnPoolFn [40,9,{H2}] f32: input gradients vs autograd of the "
        f"plain version max abs err {gerr:.3e} (tol 1e-5)")
    if not gerr <= 1e-5:
        raise AssertionError("AttnPoolFn gradients disagree")
    return out


def int8_inputs(gen, rows, dtype, integer):
    """x [rows, E] and the int8 table of a random [V, E] embedding through
    quantize_embedding_table, transposed: (x, q_t [E, V], scale [V])."""
    from context_attentive_ir_tpu_torch.ops.layers import (
        quantize_embedding_table,
    )

    table = torch.randn((VOCAB, EMSIZE), generator=gen, device="cuda") * 0.1
    q, scale = quantize_embedding_table(table.cpu().numpy())
    q_t = torch.from_numpy(q).cuda().t().contiguous()
    if integer:
        x = torch.randint(-3, 4, (rows, EMSIZE), generator=gen, device="cuda")
    else:
        x = torch.randn((rows, EMSIZE), generator=gen, device="cuda") * 0.5
    return x.to(dtype), q_t, torch.from_numpy(scale).cuda().reshape(-1)


def front_loaded(gen, rows, dtype):
    """Every row's top scores in the first 2,048 vocab columns (positive x,
    large positive columns there, negative ones after), so a pruned kernel
    skips nearly every later tile."""
    x = torch.rand((rows, EMSIZE), generator=gen, device="cuda") + 0.1
    t = -torch.rand((EMSIZE, VOCAB), generator=gen, device="cuda")
    t[:, :2048] = torch.rand((EMSIZE, 2048), generator=gen,
                             device="cuda") + 1.0
    return x.to(dtype), t.to(dtype)


def same_bits(a, b) -> bool:
    return all(torch.equal(p, q) for p, q in zip(a, b))


def check_beamgen_modes(gen) -> float:
    """Kernel 2's int8 mode against its plain version (the f32
    reference, not a bf16-rounded logits path), at the beam-5 and greedy
    shapes: integer-valued x exact, random x 0 index mismatches away from
    near ties.  ``prune`` on and off, and kernel 3 against kernel 2, must
    give the same bits.  Returns the int8 mode's max abs error on random
    data at the beam-5 shape (bf16 x)."""
    from context_attentive_ir_tpu_torch.ops.kernels.beamgen import (
        generator_topk_lse,
    )

    worst = 0.0
    for rows, kc in ((B * S * BEAM, BEAM + 1), (B * S, 2)):
        for dtype in (torch.float32, torch.bfloat16):
            for integer in (True, False):
                x, q_t, scale = int8_inputs(gen, rows, dtype, integer)
                base = generator_topk_lse(x, q_t, kc, scale=scale)
                pruned = generator_topk_lse(x, q_t, kc, scale=scale,
                                            prune=True)
                name = (f"generator_topk_lse int8 R={rows} kc={kc} {dtype} "
                        f"{'integer' if integer else 'random'}")
                v_err = hold(name, base, x, q_t, kc, integer, scale)
                if (rows == B * S * BEAM and dtype == torch.bfloat16
                        and not integer):
                    worst = v_err
                if not same_bits(base, pruned):
                    raise AssertionError(f"{name}: prune changes the bits")

            for data in ("random", "front-loaded"):
                if data == "random":
                    x, tt = beamgen_inputs(gen, rows, dtype, integer=False)
                else:
                    x, tt = front_loaded(gen, rows, dtype)
                base = generator_topk_lse(x, tt, kc)
                pruned = generator_topk_lse(x, tt, kc, prune=True)
                piped = generator_topk_lse(x, tt, kc, pipeline=True)
                torch.cuda.synchronize()
                ok = same_bits(base, pruned) and same_bits(base, piped)
                log(f"generator_topk_lse R={rows} kc={kc} {dtype} {data}: "
                    f"prune on = off = kernel 3, same bits: {ok}")
                if not ok:
                    raise AssertionError("prune / pipeline change the bits")
    return worst


# vocabularies of the layout checks: the AOL-scale fixture's 50,004 words
# (bf16 table rows of 100,008 bytes, which no 16-byte copy can address
# unpadded) and the suggestion shortlist
LAYOUT_VOCABS = (VOCAB + 4, SHORTLIST)


def layout_inputs(gen, rows, v, dtype, integer, int8):
    """x [rows, E] and the tied table of a [v, E] embedding laid out as the
    decoders lay it (``fused_generator_table``: ``aligned_table`` of the
    transpose, a view of a table padded to 16-byte rows), with its scale in
    the int8 mode (integer data: small integers and power-of-two scales, so
    every product and sum is exact)."""
    from context_attentive_ir_tpu_torch.ops.kernels.beamgen import (
        aligned_table,
    )

    dev = "cuda"
    if integer:
        x = torch.randint(-3, 4, (rows, EMSIZE), generator=gen, device=dev)
        emb = torch.randint(-3, 4, (v, EMSIZE), generator=gen, device=dev)
    else:
        x = torch.randn((rows, EMSIZE), generator=gen, device=dev) * 0.5
        emb = torch.randn((v, EMSIZE), generator=gen, device=dev) * 0.5
    scale = None
    if int8:
        if integer:
            scale = 2.0 ** torch.randint(-3, 3, (v,), generator=gen,
                                         device=dev).float()
        else:
            scale = emb.abs().amax(-1) / 127.0
            emb = torch.round(emb / scale[:, None])
        emb = emb.to(torch.int8)
    else:
        emb = emb.to(dtype)
    return x.to(dtype), aligned_table(emb.t()), scale


def check_beamgen_layouts(gen) -> None:
    """Every mode of kernels 2 and 3 on tables laid out as the decoders lay
    them, at V = 50,004 (padded rows) and at the shortlist's 4,096, at the
    beam-5 and greedy shapes (kernel 3 at R = 320, kc = 2 among them), in
    float32 and bfloat16: each table is one the kernels read as it lies (no
    per-step copy), the serial kernel is held to its plain version, and
    ``prune`` on / off and kernel 3 give its bits.  Then a contiguous table
    with unaligned rows (V = 301), padded by the wrapper per call."""
    from context_attentive_ir_tpu_torch.ops.kernels.beamgen import (
        aligned_table,
        generator_topk_lse,
        table_aligned,
    )

    for v in LAYOUT_VOCABS:
        for dtype in (torch.float32, torch.bfloat16):
            for rows, kc in ((B * S * BEAM, BEAM + 1), (B * S, 2)):
                for integer in (True, False):
                    for int8 in (False, True):
                        x, tt, scale = layout_inputs(gen, rows, v, dtype,
                                                     integer, int8)
                        name = (f"generator_topk_lse{' int8' if int8 else ''}"
                                f" V={v} (row stride {tt.stride(0)}) R={rows} "
                                f"kc={kc} {dtype} "
                                f"{'integer' if integer else 'random'}")
                        if not table_aligned(tt) or aligned_table(tt) is not tt:
                            raise AssertionError(f"{name}: the decoders' "
                                                 "table would be copied")
                        modes = [{}, {"prune": True}]
                        if not int8:
                            modes.append({"pipeline": True})
                        outs = [generator_topk_lse(x, tt, kc, scale=scale,
                                                   **kw) for kw in modes]
                        hold(name, outs[0], x, tt, kc, integer, scale)
                        if not int8 and rows == B * S:
                            hold(f"{name} kernel 3", outs[2], x, tt, kc,
                                 integer)
                        same = all(same_bits(outs[0], o) for o in outs[1:])
                        log(f"{name}: prune on = off"
                            f"{'' if int8 else ' = kernel 3'}, same bits: "
                            f"{same}")
                        if not same:
                            raise AssertionError(f"{name}: the modes differ")
    for dtype in (torch.float32, torch.bfloat16):
        x, tt = beamgen_inputs(gen, 70, dtype, integer=True)
        tt = tt[:, :301].contiguous()
        outs = [generator_topk_lse(x, tt, 2, **kw)
                for kw in ({}, {"prune": True}, {"pipeline": True})]
        name = f"generator_topk_lse V=301 contiguous (padded per call) {dtype}"
        hold(name, outs[0], x, tt, 2, True)
        if not all(same_bits(outs[0], o) for o in outs[1:]):
            raise AssertionError(f"{name}: the modes differ")


def check_beamgen_limits(gen) -> None:
    """``beamgen_supported`` states the launchers' limits: in each dtype and
    kernel, the largest E it accepts runs (and is exact on integer data),
    the next E is refused by the launcher and the next launch runs clean;
    E = 300 and E = 100 (not multiples of 16: the zero-filled last k-slab)
    run too."""
    from context_attentive_ir_tpu_torch.ops.kernels.beamgen import (
        beamgen_smem_bytes,
        beamgen_supported,
        generator_topk_lse,
    )

    def at(e, dtype, pipeline):
        x = torch.randint(-3, 4, (70, e), generator=gen, device="cuda")
        t = torch.randint(-3, 4, (e, 304), generator=gen, device="cuda")
        x, t = x.to(dtype), t.to(dtype)
        return x, t, generator_topk_lse(x, t, 2, pipeline=pipeline)

    for dtype in (torch.float32, torch.bfloat16):
        for pipeline in (False, True):
            top = max(e for e in range(1, 4096)
                      if beamgen_supported(e, dtype, pipeline))
            for e in (100, 300, top, top + 1):
                ok = beamgen_supported(e, dtype, pipeline)
                what = (f"generator_topk_lse{' pipeline' if pipeline else ''}"
                        f" E={e} {dtype}")
                try:
                    x, t, out = at(e, dtype, pipeline)
                    torch.cuda.synchronize()
                    ran = True
                except RuntimeError as err:
                    ran, why = False, err
                log(f"beamgen_supported(E={e}, {dtype}, pipeline={pipeline})"
                    f" = {ok} ({beamgen_smem_bytes(e, dtype, pipeline)} "
                    "bytes of shared memory); the kernel "
                    + ("ran" if ran else f"refused: {why}"))
                if ran != ok:
                    raise AssertionError(f"beamgen_supported disagrees with "
                                         f"the launcher at {what}")
                if ran:
                    hold(what, out, x, t, 2, True)
    at(EMSIZE, torch.bfloat16, True)
    torch.cuda.synchronize()
    log("generator_topk_lse launches clean after the refusals")


def check_refusals(gen) -> None:
    """Shapes a kernel's block cannot hold raise -- with the launcher's
    CUDA error, or the wrapper's check of the kernel's contract -- and the
    next launch still runs clean."""
    from context_attentive_ir_tpu_torch.ops.kernels.beamgen import (
        generator_topk_lse,
    )
    from context_attentive_ir_tpu_torch.ops.kernels.gru import (
        gru_fused,
        gru_fused_bwd,
        gru_fused_res,
        gru_fused_supported,
    )
    from context_attentive_ir_tpu_torch.ops.kernels.lstm import (
        fused_supported,
        lstm_fused,
        lstm_fused_bwd,
        lstm_fused_res,
        lstm_recurrence,
    )
    from context_attentive_ir_tpu_torch.ops.kernels.slate import attn_pool

    def rec_at(h, strided=False):
        xp, mask, w_hh = recurrence_inputs(gen, torch.float32, 40, 3, h=h)
        if strided:
            xp = xp.transpose(0, 1).contiguous().transpose(0, 1)
        return lstm_recurrence(xp, mask, w_hh)

    def lstm_at(e, h, dtype=torch.float32):
        (x, w_ih, b, w_hh), mask = lstm_inputs(gen, dtype, 40, 3, e=e, h=h)
        return lstm_fused(x, mask, w_ih, b, w_hh)

    def res_at(e, h, dtype=torch.float32):
        (x, w_ih, b, w_hh), mask = lstm_inputs(gen, dtype, 40, 3, e=e, h=h)
        return lstm_fused_res(x, mask, w_ih, b, w_hh)

    def bwd_at(e, h, dtype=torch.float32):
        (x, w_ih, b, w_hh), mask = lstm_inputs(gen, dtype, 40, 3, e=e, h=h)
        hb = torch.zeros((1, 40, h), device="cuda")
        return lstm_fused_bwd(x, mask, w_ih, b, w_hh, hb, hb,
                              torch.zeros((40, 3, h), device="cuda",
                                          dtype=dtype))

    # fused_supported states the launchers' limits: a shape it accepts runs
    # through all three kernels, one it rejects is refused by the backward
    # (whose tiles are the largest); float32 above H = 128 runs the
    # row-tile kernels under their wider launch bounds
    bf16 = torch.bfloat16
    for e, h, dtype in ((448, NHID, bf16), (512, NHID, bf16),
                        (512, 256, bf16), (EMSIZE, 512, bf16),
                        (64, 512, bf16), (300, 100, bf16),
                        (1400, NHID, torch.float32),
                        (1500, NHID, torch.float32),
                        (EMSIZE, 256, torch.float32),
                        (EMSIZE, 403, torch.float32),
                        (EMSIZE, 404, torch.float32),
                        (EMSIZE, 512, torch.float32)):
        ok = fused_supported(e, h, 40, dtype)
        try:
            lstm_at(e, h, dtype) if ok else None
            res_at(e, h, dtype) if ok else None
            bwd_at(e, h, dtype)
            torch.cuda.synchronize()
            ran = True
        except RuntimeError as err:
            ran, why = False, err
        log(f"fused_supported(E={e}, H={h}, {dtype}) = {ok}; the kernels "
            + ("ran" if ran else f"refused: {why}"))
        if ran != ok:
            raise AssertionError(f"fused_supported(E={e}, H={h}, {dtype}) "
                                 f"= {ok} but the kernels "
                                 f"{'ran' if ran else 'refused'}")

    def gru_at(kernel, e, h, dtype=torch.float32):
        (x, *w), mask = gru_inputs(gen, dtype, 40, 3, e=e, h=h)
        if kernel == "gru_fused":
            return gru_fused(x, mask, *w)
        if kernel == "gru_fused_res":
            return gru_fused_res(x, mask, *w)
        hb = torch.zeros((1, 40, h), device="cuda")
        return gru_fused_bwd(x, mask, *w, hb,
                             torch.zeros((40, 3, h), device="cuda",
                                         dtype=dtype))

    # gru_fused_supported states the launchers' limits: a shape it accepts
    # runs through all three kernels, one it rejects is refused by at least
    # one (bf16: kernel 9's tensor-core tiles, whose limits hold the
    # forward's; float32: kernel 9's f32 tile)
    for e, h, dtype in ((672, NHID, bf16), (704, NHID, bf16),
                        (EMSIZE, 448, bf16), (EMSIZE, 449, bf16),
                        (300, 100, bf16), (1400, NHID, torch.float32),
                        (1500, NHID, torch.float32),
                        (EMSIZE, 256, torch.float32),
                        (EMSIZE, 403, torch.float32),
                        (EMSIZE, 404, torch.float32)):
        ok = gru_fused_supported(e, h, 40, dtype)
        refused = []
        for k in GRU_KERNELS:
            try:
                gru_at(k, e, h, dtype)
                torch.cuda.synchronize()
            except RuntimeError as err:
                refused.append(f"{k}: {err}")
        log(f"gru_fused_supported(E={e}, H={h}, {dtype}) = {ok}; the "
            "kernels " + ("refused: " + "; ".join(refused) if refused
                          else "ran"))
        if ok == bool(refused):
            raise AssertionError(f"gru_fused_supported(E={e}, H={h}, "
                                 f"{dtype}) = {ok} but the kernels "
                                 f"{'refused' if refused else 'ran'}")

    def beamgen_at(e, v=300, **kw):
        x = torch.randn((70, e), generator=gen, device="cuda")
        t = torch.randn((e, v), generator=gen, device="cuda")
        if "scale" in kw:
            t = t.to(torch.int8)
            kw["scale"] = torch.ones((v,), device="cuda")
        return generator_topk_lse(x, t, 2, **kw)

    def pool_at(h, rows=40):
        (s, q, w, b), mask = slate_inputs(gen, torch.float32, rows, 3, h=h)
        return attn_pool(s, mask, q, w, b)

    def layer_at(rnn_type, e, h, dtype):
        # the encoder layer on card tensors never gives way to the scan by
        # itself: a shape its kernels do not hold raises
        from context_attentive_ir_tpu_torch.ops.rnn import RNNLayer

        layer = RNNLayer(e, h, use_kernel=True, dtype=dtype,
                         rnn_type=rnn_type)
        x = torch.randn((40, 3, e), generator=gen, device="cuda")
        with torch.no_grad():
            return layer(x, torch.ones((40, 3), dtype=torch.bool,
                                       device="cuda"))

    lstm_fns = (("lstm_fused", lstm_at), ("lstm_fused_res", res_at),
                ("lstm_fused_bwd", bwd_at))
    for name, fn in (*((f"{k} {what}", lambda at=at, e=e, h=h, dt=dt:
                        at(e, h, dt))
                       for k, at in lstm_fns
                       for what, e, h, dt in (
                           ("f32 E=4096 (shared tile)", 4096, NHID,
                            torch.float32),
                           ("f32 H=1024 (threads per block)", EMSIZE, 1024,
                            torch.float32),
                           ("bf16 E=4096 (staged tiles beyond shared "
                            "memory)", 4096, NHID, bf16),
                           ("bf16 H=1024 (hidden above 512)", EMSIZE, 1024,
                            bf16))),
                     ("RNNLayer lstm bf16 H=520 (hidden above 512)",
                      lambda: layer_at("lstm", EMSIZE, 520, bf16)),
                     ("RNNLayer lstm f32 H=520 (threads per block)",
                      lambda: layer_at("lstm", EMSIZE, 520, torch.float32)),
                     ("RNNLayer gru f32 E=4096 (shared tile)",
                      lambda: layer_at("gru", 4096, NHID, torch.float32)),
                     ("RNNLayer gru bf16 E=704 (staged tiles beyond shared "
                      "memory)", lambda: layer_at("gru", 704, NHID, bf16)),
                     ("lstm_recurrence H=192 (H % 128)", lambda: rec_at(192)),
                     ("lstm_recurrence H=640 (threads per block)",
                      lambda: rec_at(640)),
                     ("lstm_recurrence strided x_proj (contiguity)",
                      lambda: rec_at(NHID, strided=True)),
                     *((f"{k} {what}", lambda k=k, e=e, h=h, dt=dt:
                        gru_at(k, e, h, dt))
                       for k in GRU_KERNELS
                       for what, e, h, dt in (
                           ("f32 E=4096 (shared tile)", 4096, NHID,
                            torch.float32),
                           ("f32 H=1024 (threads per block)", EMSIZE, 1024,
                            torch.float32),
                           ("bf16 E=4096 (tiles beyond shared memory)",
                            4096, NHID, bf16),
                           ("bf16 H=1024 (hidden above 512)", EMSIZE, 1024,
                            bf16))),
                     ("generator_topk_lse E=1024 (shared tile)",
                      lambda: beamgen_at(1024)),
                     ("generator_topk_lse pipeline E=1024 (shared tile)",
                      lambda: beamgen_at(1024, pipeline=True)),
                     ("generator_topk_lse pipeline with scale (int8)",
                      lambda: beamgen_at(EMSIZE, pipeline=True, scale=1)),
                     ("attn_pool H=192 (H % 128)", lambda: pool_at(192)),
                     ("attn_pool H=640 (the block's columns)",
                      lambda: pool_at(640)),
                     ("attn_pool R=7 (rows)", lambda: pool_at(H2, 7))):
        try:
            fn()
        except (RuntimeError, ValueError) as err:
            log(f"{name} refused: {type(err).__name__}: {err}")
        else:
            raise AssertionError(f"{name} was not refused")
    for dtype in (torch.float32, bf16):
        lstm_at(EMSIZE, NHID, dtype)
        res_at(EMSIZE, NHID, dtype)
        bwd_at(EMSIZE, NHID, dtype)
    rec_at(NHID)
    layer_at("lstm", 300, 100, bf16)
    layer_at("gru", 300, 100, bf16)
    for k in GRU_KERNELS:
        for dtype in (torch.float32, bf16):
            gru_at(k, EMSIZE, NHID, dtype)
    beamgen_at(EMSIZE)
    beamgen_at(EMSIZE, 304, pipeline=True)
    pool_at(H2)
    torch.cuda.synchronize()
    log("kernels launch clean after the refusals")


def synthetic_dictionary(vocab: int):
    from context_attentive_ir_tpu_torch.data import Dictionary

    d = Dictionary()
    for k in range(vocab - len(d)):
        d.add(f"w{k}")
    assert len(d) == vocab
    return d


def requests(rng, word_dict, n: int):
    words = word_dict.tokens()

    def text(lo, hi):
        return " ".join(rng.choice(words, size=rng.randint(lo, hi + 1)))

    reqs, hists = [], []
    for _ in range(n):
        history = [(text(2, LQ), [text(5, LD) for _ in range(rng.randint(
            1, 3))]) for _ in range(S - 1)]
        query = text(2, LQ)
        reqs.append((query, [text(5, LD) for _ in range(N)], history))
        hists.append(history + [query])
    return reqs, hists


def counters() -> dict:
    """{kernel: (wrapper, attribute of its launch count)}; kernel 2 keeps
    one count per mode."""
    from context_attentive_ir_tpu_torch.ops.kernels import (
        beamgen,
        gru,
        lstm,
        slate,
    )

    gen = beamgen.generator_topk_lse
    return {"lstm_fused": (lstm.lstm_fused, "launches"),
            "generator_topk_lse": (gen, "launches"),
            "generator_topk_lse_pruned": (gen, "launches_pruned"),
            "generator_topk_lse_int8": (gen, "launches_int8"),
            "generator_topk_lse_pipelined": (gen, "launches_pipelined"),
            "lstm_fused_res": (lstm.lstm_fused_res, "launches"),
            "lstm_fused_bwd": (lstm.lstm_fused_bwd, "launches"),
            "lstm_recurrence": (lstm.lstm_recurrence, "launches"),
            "attn_pool": (slate.attn_pool, "launches"),
            "gru_fused": (gru.gru_fused, "launches"),
            "gru_fused_res": (gru.gru_fused_res, "launches"),
            "gru_fused_bwd": (gru.gru_fused_bwd, "launches")}


# the kernels each main-path call launches; every other count stays 0
PATH_KERNELS = {
    "rank_batch": ("lstm_fused",),
    "suggest_beam5": ("lstm_fused", "generator_topk_lse_pruned"),
    "suggest_greedy": ("lstm_fused", "generator_topk_lse_pruned"),
    "train_step": ("lstm_fused_res", "lstm_fused_bwd"),
    "eval_loss": ("lstm_fused",),
    "index_documents": ("lstm_fused",),
    "index_documents_proj": ("lstm_fused",),
    "rank_indexed": ("lstm_fused", "attn_pool"),
    "rank_indexed_clicks": ("lstm_fused", "attn_pool"),
    "rank_indexed_proj": ("lstm_fused",),
    "rank_batch_slate": ("lstm_fused", "attn_pool"),
    "suggest_beam5_int8": ("lstm_fused", "generator_topk_lse_int8"),
    "suggest_shortlist": ("lstm_fused", "generator_topk_lse_pruned"),
    # suggest init of the slate Engine pools the B*S*C clicked docs
    "decode_unpruned": ("lstm_fused", "generator_topk_lse", "attn_pool"),
    "decode_pipelined": ("lstm_fused", "generator_topk_lse_pipelined",
                         "attn_pool"),
    # CARS with GRU encoders and session recurrences, and HRED-QS (GRU)
    "rank_batch_gru": ("gru_fused",),
    "suggest_beam5_gru": ("gru_fused", "generator_topk_lse_pruned"),
    "train_step_gru": ("gru_fused_res", "gru_fused_bwd"),
    "eval_loss_gru": ("gru_fused",),
    "suggest_beam5_hredqs": ("gru_fused",),
    "suggest_greedy_hredqs": ("gru_fused",),
    "train_step_hredqs": ("gru_fused_res", "gru_fused_bwd"),
    # the doc encoder as one matmul projection + the recurrence kernel
    "lstm_precomputed": ("lstm_recurrence",),
    # cli.main: training through kernels 4/5 (8/9), validation and test
    # through kernel 1 (7) and the logits decode step
    "trainer_fit": ("lstm_fused", "lstm_fused_res", "lstm_fused_bwd"),
    "trainer_fit_hredqs": ("gru_fused", "gru_fused_res", "gru_fused_bwd"),
}
# exact encoder launches where they are fixed: CARS runs its query and doc
# encoders (suggest: the clicked docs), two directions each; HRED-QS its
# query encoder only (its session RNN and generator take no kernel)
EXACT_LAUNCHES = {
    "train_step": {"lstm_fused_res": 4, "lstm_fused_bwd": 4},
    "eval_loss": {"lstm_fused": 4},
    "rank_batch_gru": {"gru_fused": 4},
    "suggest_beam5_gru": {"gru_fused": 4},
    "train_step_gru": {"gru_fused_res": 4, "gru_fused_bwd": 4},
    "eval_loss_gru": {"gru_fused": 4},
    "suggest_beam5_hredqs": {"gru_fused": 2},
    "suggest_greedy_hredqs": {"gru_fused": 2},
    "train_step_hredqs": {"gru_fused_res": 2, "gru_fused_bwd": 2},
    "lstm_precomputed": {"lstm_recurrence": 2},
}


def counted(path: str, fn):
    """Run ``fn`` with every launch count set to 0 just before it and read
    just after it; raise unless exactly PATH_KERNELS[path] launched.
    Returns (fn's result, {kernel: launches})."""
    fns = counters()
    for f, attr in fns.values():
        setattr(f, attr, 0)
    out = fn()
    torch.cuda.synchronize()
    counts = {k: getattr(f, attr) for k, (f, attr) in fns.items()}
    for k, n in counts.items():
        if (n > 0) != (k in PATH_KERNELS[path]):
            raise AssertionError(f"{path} launched kernel {k} {n} times; it "
                                 f"must launch {PATH_KERNELS[path]}")
    for k, n in EXACT_LAUNCHES.get(path, {}).items():
        if counts[k] != n:
            raise AssertionError(f"{path} launched kernel {k} {counts[k]} "
                                 f"times, not {n}")
    return out, counts


def by_path(launches: dict, kernel: str) -> dict:
    """``{"launches": total, "launches_by_path": {path: n}}`` of one kernel
    from main_path's per-path counts."""
    per = {path: counts[kernel] for path, counts in launches.items()}
    return {"launches": sum(per.values()), "launches_by_path": per}


def main_path() -> dict:
    from context_attentive_ir_tpu_torch.models.multitask.cars import CARS
    from context_attentive_ir_tpu_torch.serve import Engine

    cfg = full_width_config("cars")
    word_dict = synthetic_dictionary(VOCAB)
    params = CARS(cfg, device="cuda", seed=0).state_dict()
    beam = Engine(cfg, word_dict, params, beam_size=BEAM, batch_bucket=B)
    greedy = Engine(cfg, word_dict, params, beam_size=1, batch_bucket=B)
    reqs, hists = requests(np.random.RandomState(0), word_dict, B)

    # each path runs with every count set to 0 just before it and read
    # just after it; PATH_KERNELS says which kernels it must launch
    calls = (("rank_batch", lambda: beam.rank_batch(reqs)),
             ("suggest_beam5", lambda: beam.suggest_batch(hists)),
             ("suggest_greedy", lambda: greedy.suggest_batch(hists)))
    outs, launches, first_ms = {}, {}, {}
    for path, fn in calls:
        t = time.perf_counter()
        outs[path], launches[path] = counted(path, fn)
        first_ms[path] = (time.perf_counter() - t) * 1e3
    log(f"main path launches per path: {json.dumps(launches)}")
    log(f"first-call wall ms: {json.dumps(first_ms)}")
    scores = outs["rank_batch"]
    sugg, sugg_g = outs["suggest_beam5"], outs["suggest_greedy"]

    if len(scores) != B or any(len(s) != N for s in scores):
        raise AssertionError("rank_batch returned the wrong shape")
    if not np.isfinite(np.asarray(scores)).all():
        raise AssertionError("rank_batch returned non-finite scores")
    check_suggestions("suggest_beam5", sugg, BEAM)
    check_suggestions("suggest_greedy", sugg_g, 1)
    log(f"sample suggestion: {sugg[0][0]}; greedy: {sugg_g[0][0]}")

    walls = steady_walls(calls)
    log(f"steady wall ms (3 runs each, B={B}): {json.dumps(walls)}")
    for name, fn in calls:
        where_time_goes(name, fn)
    return launches


def where_time_goes(name: str, fn) -> None:
    """One profiled call: device-busy time (sum of kernel times), the
    call's wall time under the profiler, the idle share, and the kernels
    that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0), reverse=True)
    busy = sum(ms for ms, _, _ in kernels)
    top = [{"kernel": k[:60], "ms": round(ms, 3), "calls": n}
           for ms, n, k in kernels[:6]]
    log(f"profile {name}: wall {wall:.1f} ms (profiled), device busy "
        f"{busy:.1f} ms, idle share {1 - busy / wall:.3f}; top kernels "
        f"{json.dumps(top)}")


def corpus_texts(rng, word_dict, n: int) -> list[str]:
    words = word_dict.tokens()
    return [" ".join(rng.choice(words, size=rng.randint(5, LD + 1)))
            for _ in range(n)]


def steady_walls(calls) -> dict:
    """Three host-clock walls of each synchronised call."""
    walls = {}
    for name, fn in calls:
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t) * 1e3)
        walls[name] = runs
    return walls


def serving_paths(ckpt_path: str) -> dict:
    """The rest of serving at the serving widths (bf16, seeded weights):
    a 20,000-document index (plain and with the cached pooling projection),
    ``rank_indexed_batch`` in the broadcast and per-turn layouts and over
    the projection cache, ``rank_batch`` through the slate-pool kernel, a
    beam-5 ``Engine.from_checkpoint(quantize_embeddings=True)`` over the
    trained checkpoint, a beam-5 ``Engine(suggest_shortlist=4096)``, and
    beam-5 decodes through the unpruned serial and the pipelined generator
    (the Engine's take the pruned one), each counted.  Returns {path:
    launches}."""
    from context_attentive_ir_tpu_torch.decode import (
        beam_search,
        make_fused_beam_step,
    )
    from context_attentive_ir_tpu_torch.models.multitask.cars import CARS
    from context_attentive_ir_tpu_torch.serve import Engine

    cfg = full_width_config("cars", use_pallas_slate=True)
    word_dict = synthetic_dictionary(VOCAB)
    params = CARS(cfg, device="cuda", seed=0).state_dict()
    eng = Engine(cfg, word_dict, params, beam_size=BEAM, batch_bucket=B)
    rng = np.random.RandomState(4)
    corpus = corpus_texts(rng, word_dict, N_CORPUS)
    _, hists = requests(rng, word_dict, B)
    ids = [[int(i) for i in rng.choice(N_CORPUS, N, replace=False)]
           for _ in range(B)]
    plain = [(h[-1], d, [q for q, _ in h[:-1]]) for h, d in zip(hists, ids)]
    clicks = [(h[-1], d, [(q, [int(c) for c in rng.choice(N_CORPUS, 2)])
                          for q, _ in h[:-1]]) for h, d in zip(hists, ids)]
    texts = [(q, [corpus[i] for i in d], h) for q, d, h in plain]

    launches, outs = {}, {}
    t = time.perf_counter()
    index, launches["index_documents"] = counted(
        "index_documents", lambda: eng.index_documents(corpus))
    index_ms = (time.perf_counter() - t) * 1e3
    index_proj, launches["index_documents_proj"] = counted(
        "index_documents_proj",
        lambda: eng.index_documents(corpus, cache_pool_proj=True))
    mb = index["states"].numel() * index["states"].element_size() / 2 ** 20
    log(f"index of {N_CORPUS} documents: states "
        f"{tuple(index['states'].shape)} {index['states'].dtype} "
        f"({mb:.0f} MiB, {2 * mb:.0f} MiB with the projection cache), "
        f"first-call wall {index_ms:.1f} ms")
    if not bool(torch.isfinite(index["states"].float()).all()):
        raise AssertionError("index_documents returned non-finite states")

    ckpt_int8 = Engine.from_checkpoint(ckpt_path, beam_size=BEAM,
                                       quantize_embeddings=True,
                                       batch_bucket=B)
    shortlist = Engine(cfg.replace(use_pallas_slate=False), word_dict,
                       params, beam_size=BEAM, batch_bucket=B,
                       suggest_shortlist=SHORTLIST)
    model = eng.model
    batch = decode_batch(eng, hists)

    def decode(**kw):
        state, memory, mask = model.decode_init(batch)
        step = make_fused_beam_step(
            model, memory.repeat_interleave(BEAM, 0),
            mask.repeat_interleave(BEAM, 0), BEAM + 1, torch.bfloat16, **kw)
        return beam_search(step, state, memory.shape[0],
                           eng.shapes.max_target_len, BEAM,
                           return_nbest=True)

    calls = (("rank_indexed", lambda: eng.rank_indexed_batch(plain, index)),
             ("rank_indexed_clicks",
              lambda: eng.rank_indexed_batch(clicks, index)),
             ("rank_indexed_proj",
              lambda: eng.rank_indexed_batch(plain, index_proj)),
             ("rank_batch_slate", lambda: eng.rank_batch(texts)),
             ("suggest_beam5_int8", lambda: ckpt_int8.suggest_batch(hists)),
             ("suggest_shortlist", lambda: shortlist.suggest_batch(hists)),
             ("decode_unpruned", lambda: decode(prune=False)),
             ("decode_pipelined", lambda: decode(pipeline=True)))
    first_ms = {}
    for path, fn in calls:
        t = time.perf_counter()
        outs[path], launches[path] = counted(path, fn)
        first_ms[path] = (time.perf_counter() - t) * 1e3
    log(f"serving paths, launches per path: {json.dumps(launches)}")
    log(f"first-call wall ms: {json.dumps(first_ms)}")

    for path in ("rank_indexed", "rank_indexed_clicks", "rank_indexed_proj",
                 "rank_batch_slate"):
        sc = np.asarray(outs[path])
        if sc.shape != (B, N) or not np.isfinite(sc).all():
            raise AssertionError(f"{path} returned bad scores")
    diff = float(np.abs(np.asarray(outs["rank_indexed"])
                        - np.asarray(outs["rank_batch_slate"])).max())
    proj_diff = float(np.abs(np.asarray(outs["rank_indexed"])
                             - np.asarray(outs["rank_indexed_proj"])).max())
    log(f"rank_indexed vs rank_batch over the same documents: max abs "
        f"diff {diff:.3e} (tol 2e-2, bf16); vs the projection cache "
        f"{proj_diff:.3e} (tol 2e-2)")
    if not (diff <= 2e-2 and proj_diff <= 2e-2):
        raise AssertionError("indexed ranking disagrees with rank_batch")
    for path in ("suggest_beam5_int8", "suggest_shortlist"):
        check_suggestions(path, outs[path], BEAM)
    log(f"sample int8 suggestion: {outs['suggest_beam5_int8'][0][0]}; "
        f"shortlist: {outs['suggest_shortlist'][0][0]}")
    serial = decode(prune=True)   # the Engine's step
    for path in ("decode_unpruned", "decode_pipelined"):
        same = all(torch.equal(a, b) for a, b in zip(outs[path], serial))
        log(f"{path}: tokens and scores equal to the pruned serial "
            f"kernel's: {same}")
        if not same:
            raise AssertionError(f"{path} differs from the serial decode")

    timed = (("index_documents", lambda: eng.index_documents(corpus)),
             *calls)
    walls = steady_walls(timed)
    log(f"steady wall ms (3 runs each, B={B}): {json.dumps(walls)}")
    for name, fn in timed:
        where_time_goes(name, fn)
    return launches


def decode_batch(eng, hists):
    """The suggest batch of ``hists`` on the card, as ``suggest_batch``
    builds it."""
    from context_attentive_ir_tpu_torch.data import build_session_batch
    from context_attentive_ir_tpu_torch.data.objects import Session

    sessions = [Session("req", eng._history_queries(h)[-S:]) for h in hists]
    return build_session_batch(sessions, eng.word_dict, eng.shapes,
                               batch_size=len(hists)).to("cuda")


def small_serving_check() -> None:
    """A small float32 CARS (H2 = 128, the slate kernel's width): the
    indexed, quantized and shortlist Engines on the card (kernels) must
    agree with the same Engines on the CPU (plain versions): scores within
    1e-4, suggestion tokens exact."""
    from context_attentive_ir_tpu_torch.config import default_config
    from context_attentive_ir_tpu_torch.models.multitask.cars import CARS
    from context_attentive_ir_tpu_torch.serve import (
        Engine,
        quantize_embedding_params,
    )

    cfg = default_config("cars").replace(
        vocab_size=300, emsize=32, nhid=64, nhid_ffnn=32, max_query_len=8,
        max_doc_len=12, max_session_len=3, num_candidates=8, dropout=0.0,
        dropout_emb=0.0, dropout_rnn=0.0, use_pallas_slate=True)
    word_dict = synthetic_dictionary(cfg.vocab_size)
    params = CARS(cfg, device="cpu", seed=2).state_dict()
    rng = np.random.RandomState(5)
    words = word_dict.tokens()

    def text(n):
        return " ".join(rng.choice(words, size=n))

    corpus = [text(rng.randint(3, 13)) for _ in range(40)]
    # per-turn layout (click history), then the broadcast layout
    reqs = [(text(4), [int(i) for i in rng.choice(40, 8, replace=False)],
             [(text(3), [int(rng.randint(40))]), text(2)]) for _ in range(3)]
    broadcast = [(text(3), [1, 2, 3], [text(2)]), (text(5), [7, 9], ())]
    text_reqs = [(text(4), corpus[:6], [(text(3), corpus[6:8]), text(2)])
                 for _ in range(5)]
    hists = [[(text(3), [text(6), text(4)]), text(5)] for _ in range(5)]
    qcfg = cfg.replace(quantize_embeddings=True)
    qparams = quantize_embedding_params(params)
    for name, c, p, kw in (("indexed", cfg, params, {}),
                           ("int8", qcfg, qparams, {}),
                           ("shortlist 40", cfg, params,
                            {"suggest_shortlist": 40})):
        for beam in (3, 1):
            engines = [Engine(c, word_dict, p, beam_size=beam, batch_bucket=4,
                              device=dev, **kw) for dev in ("cuda", "cpu")]
            scores = [[e.rank_batch(text_reqs)] for e in engines]
            if name == "indexed":
                for dev_scores, e in zip(scores, engines):
                    for proj in (False, True):
                        index = e.index_documents(corpus, proj)
                        dev_scores += [e.rank_indexed_batch(reqs, index),
                                       e.rank_indexed_batch(broadcast,
                                                            index)]
            err = max(abs(a - b) for g, c_ in zip(*scores)
                      for x, y in zip(g, c_) for a, b in zip(x, y))
            sg, sc = (e.suggest_batch(hists) for e in engines)
            same = ([[t for t, _ in nb] for nb in sg]
                    == [[t for t, _ in nb] for nb in sc])
            s_err = max(abs(a[1] - b[1]) for x, y in zip(sg, sc)
                        for a, b in zip(x, y))
            log(f"small f32 CARS {name} Engine, beam {beam}: card vs CPU "
                f"rank max abs err {err:.3e} (tol 1e-4), suggestions "
                f"identical={same}, score max abs err {s_err:.3e} (tol "
                "1e-4)")
            if not (err <= 1e-4 and same and s_err <= 1e-4):
                raise AssertionError(f"card {name} Engine disagrees with CPU")


def random_session_batch(rng, b=B, s=S, n=N, lq=LQ, ld=LD, vocab=VOCAB,
                         ragged=False):
    """A numpy SessionBatch of random ids.  Full (as bench.py's train
    batch: every turn, candidate and token valid, one click per turn on
    candidate 0), or ``ragged``: random query, document and target
    lengths (empty documents included), padded candidates and turns, and
    turns without a click."""
    from context_attentive_ir_tpu_torch.data.vectorize import SessionBatch

    def ids(shape):
        return rng.randint(4, vocab, size=shape).astype(np.int32)

    def lengths(shape, lo, hi):
        return np.arange(hi)[None] < rng.randint(lo, hi + 1, size=shape)[
            ..., None]

    tin = ids((b, s, lq + 1))
    clicks = np.zeros((b, s, n), np.float32)
    if not ragged:
        clicks[:, :, 0] = 1.0
        full = np.ones
        return SessionBatch(
            query=ids((b, s, lq)), query_mask=full((b, s, lq), bool),
            docs=ids((b, s, n, ld)), doc_mask=full((b, s, n, ld), bool),
            clicks=clicks, cand_mask=full((b, s, n), bool),
            turn_mask=full((b, s), bool), target_in=tin, target_out=tin,
            target_mask=full((b, s, lq + 1), bool),
            row_mask=full((b,), bool))
    cand_mask = lengths((b, s), 1, n)
    clicked = rng.randint(0, n, size=(b, s))
    has = (rng.rand(b, s) < 0.8) & np.take_along_axis(
        cand_mask, clicked[..., None], -1)[..., 0]
    clicks[np.arange(b)[:, None], np.arange(s)[None], clicked] = has
    return SessionBatch(
        query=ids((b, s, lq)), query_mask=lengths((b, s), 1, lq),
        docs=ids((b, s, n, ld)), doc_mask=lengths((b, s, n), 0, ld),
        clicks=clicks, cand_mask=cand_mask,
        turn_mask=lengths((b,), 1, s), target_in=tin,
        target_out=ids((b, s, lq + 1)),
        target_mask=lengths((b, s), 0, lq + 1),
        row_mask=np.arange(b) < b - 1)


def train_path(ckpt_dir: str) -> tuple[dict, dict, str]:
    """The training path at full width (see the module docstring); the
    checkpoint goes under ``ckpt_dir``.  Returns ({path: launches},
    {"train_step": ms}, the checkpoint's path)."""
    from context_attentive_ir_tpu_torch.models.multitask.cars import CARS
    from context_attentive_ir_tpu_torch.serve import Engine
    from context_attentive_ir_tpu_torch.train import Checkpointer

    cfg = full_width_config("cars", train=True)
    word_dict = synthetic_dictionary(VOCAB)
    model = CARS(cfg, device="cuda", seed=0)
    batch = random_session_batch(np.random.RandomState(0)).to("cuda")
    launches = {}
    state, step, launches["train_step"] = train_steps("train_step", cfg,
                                                      model, batch)
    launches["eval_loss"] = eval_loss("eval_loss", cfg, model, batch)

    reqs, _ = requests(np.random.RandomState(2), word_dict, 8)
    ckpt = Checkpointer(ckpt_dir, "cars")
    ckpt.save_latest(state, cfg, word_dict, {"step": state.step})
    ckpt.wait()
    loaded = Engine.from_checkpoint(ckpt.latest_path, batch_bucket=8)
    got = loaded.rank_batch(reqs)
    want = Engine(cfg, word_dict, model.state_dict(),
                  batch_bucket=8).rank_batch(reqs)
    log(f"checkpoint -> Engine.from_checkpoint: rank_batch over "
        f"{len(reqs)} requests equal to the in-memory Engine's: "
        f"{got == want}")
    if got != want:
        raise AssertionError("Engine.from_checkpoint scores differ")

    where_time_goes("train_step", lambda: step(state, batch, 1))
    train_ms = timed_ms(lambda: step(state, batch, 1), iters=5, warmup=1)
    log(f"train step (CUDA events, mean of 5 after warm-up, B={B}): "
        f"{train_ms:.2f} ms -> {B * S * N / train_ms * 1e3:.0f} trained "
        "docs/s")
    return launches, {"train_step": train_ms}, ckpt.latest_path


def full_width_config(model_type: str, train: bool = False, **kw):
    """The main paths' widths (bf16) for ``model_type``: dropout 0 for
    serving, the ModelConfig default dropouts with ``train``; ``kw``
    replaces fields."""
    from context_attentive_ir_tpu_torch.config import default_config

    cfg = default_config(model_type).replace(
        vocab_size=VOCAB, emsize=EMSIZE, nhid=NHID, nhid_ffnn=NHID_FFNN,
        max_query_len=LQ, max_doc_len=LD, max_session_len=S,
        num_candidates=N, compute_dtype="bfloat16", **kw)
    if not train:
        cfg = cfg.replace(dropout=0.0, dropout_emb=0.0, dropout_rnn=0.0)
    return cfg


GRU = {"rnn_type": "gru", "session_rnn_type": "gru"}


def random_suggest_batch(rng, b=B, s=S, lq=LQ, vocab=VOCAB):
    """A numpy SuggestBatch of random ids: 1..S context turns of 1..Lq
    tokens, a target of 1..Lq tokens, the last row padded."""
    from context_attentive_ir_tpu_torch.data.vectorize import SuggestBatch

    def ids(shape):
        return rng.randint(4, vocab, size=shape).astype(np.int32)

    def lengths(shape, lo, hi):
        return np.arange(hi)[None] < rng.randint(lo, hi + 1, size=shape)[
            ..., None]

    turn_mask = lengths((b,), 1, s)
    context_mask = lengths((b, s), 1, lq) & turn_mask[..., None]
    tin = ids((b, lq + 1))
    source_mask = lengths((b,), 1, s * lq)
    return SuggestBatch(
        source=ids((b, s * lq)), source_mask=source_mask,
        context=ids((b, s, lq)), context_mask=context_mask,
        turn_mask=turn_mask, target_in=tin, target_out=ids((b, lq + 1)),
        target_mask=lengths((b,), 1, lq + 1), row_mask=np.arange(b) < b - 1)


def nll_f32(model, batch) -> float:
    """A recommender's teacher-forced NLL on ``batch`` with dropout off,
    its logits taken to float32 first: a reading of the training loss that
    resolves changes below bf16's spacing (0.0625 at ln 50,000)."""
    from context_attentive_ir_tpu_torch.models.losses import (
        sequence_nll_loss,
    )

    with torch.no_grad():
        logits = model(batch).float()
        tmask = batch.target_mask & batch.row_mask[:, None]
        return float(sequence_nll_loss(logits, batch.target_out, tmask))


def train_steps(path: str, cfg, model, batch, steps: int = TRAIN_STEPS,
                reading=None):
    """``steps`` Adam steps of ``model`` on one batch, the second one
    counted against PATH_KERNELS[path] / EXACT_LAUNCHES.  The loss must
    fall: the step losses, or ``reading(model, batch)`` before and after
    the steps where one is given.  Returns (state, step function, launches
    of the counted step)."""
    from context_attentive_ir_tpu_torch.train import (
        create_train_state,
        make_train_step,
        param_count,
    )

    before = reading(model, batch) if reading else None
    state = create_train_state(model, cfg)
    step = make_train_step(model, cfg)
    log(f"{path}: {type(model).__name__} ({cfg.rnn_type} encoders, "
        f"{cfg.session_rnn_type} session RNN) with {param_count(state)} "
        f"parameters, dropout {cfg.dropout}/{cfg.dropout_emb}/"
        f"{cfg.dropout_rnn}, {cfg.optimizer} lr {cfg.learning_rate}, "
        f"{cfg.compute_dtype}, B={B}")
    metrics, launches = [], None
    for i in range(steps):
        if i == 1:   # one step counted, past the first call's set-up
            (state, m), launches = counted(path, lambda: step(state, batch,
                                                             1))
        else:
            state, m = step(state, batch, 1)
        metrics.append({k: float(v) for k, v in m.items()})
    losses = [m["loss"] for m in metrics]
    log(f"{path}: launches of one step {json.dumps(launches)}; {steps} "
        f"steps: loss {[round(x, 4) for x in losses]}, grad_norm "
        f"{[round(m['grad_norm'], 4) for m in metrics]}")
    if not all(math.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError(f"{path}: non-finite loss or grad norm")
    first, last = losses[0], losses[-1]
    if reading:
        first, last = before, reading(model, batch)
        log(f"{path}: float32 NLL reading {first:.5f} -> {last:.5f}")
    if not last < first:
        raise AssertionError(f"{path}: loss did not fall: {first} -> {last}")
    return state, step, launches


def eval_loss(path: str, cfg, model, batch) -> dict:
    """One counted eval-loss step (dropout off, no gradient); the losses
    must be finite.  Returns its launches."""
    from context_attentive_ir_tpu_torch.train import make_eval_loss_step

    ev, launches = counted(path, lambda: make_eval_loss_step(model, cfg)(
        batch))
    ev = {k: float(v) for k, v in ev.items()}
    log(f"{path}: {json.dumps(ev)}, launches {json.dumps(launches)}")
    if not all(math.isfinite(v) for v in ev.values()):
        raise AssertionError(f"{path}: non-finite eval loss")
    return launches


def check_suggestions(path: str, out, k: int) -> None:
    if len(out) != B or any(len(nb) != k for nb in out):
        raise AssertionError(f"{path} returned the wrong shape")
    if not all(isinstance(t, str) and np.isfinite(sc)
               for nb in out for t, sc in nb):
        raise AssertionError(f"{path} returned bad suggestions")
    if sum(len(t) > 0 for nb in out for t, _ in nb) == 0:
        raise AssertionError(f"{path}: the suggestions are all empty")


def gru_paths(ckpt_dir: str) -> tuple[dict, dict]:
    """The GRU slice at the serving widths: CARS with GRU encoders and GRU
    session recurrences behind ``Engine`` (``rank_batch`` for 64 requests x
    50 docs, beam-5 ``suggest_batch`` for 64 histories), 8 Adam steps of it
    at the ModelConfig dropouts and an eval-loss step; HRED-QS (GRU) beam-5
    and greedy ``suggest_batch`` for 64 histories, 8 Adam steps of it and a
    checkpoint -> ``Engine.from_checkpoint`` round trip with equal
    suggestions.  Each call counted, walled and profiled.  Returns ({path:
    launches}, {path: train step ms})."""
    from context_attentive_ir_tpu_torch.models import build_model
    from context_attentive_ir_tpu_torch.serve import Engine
    from context_attentive_ir_tpu_torch.train import Checkpointer

    word_dict = synthetic_dictionary(VOCAB)
    reqs, hists = requests(np.random.RandomState(6), word_dict, B)
    cars_cfg = full_width_config("cars", **GRU)
    hred_cfg = full_width_config("hredqs", **GRU)
    engines = {}
    with torch.inference_mode():
        for name, cfg in (("cars", cars_cfg), ("hredqs", hred_cfg)):
            params = build_model(cfg, device="cuda", seed=0).state_dict()
            engines[name] = (Engine(cfg, word_dict, params, beam_size=BEAM,
                                    batch_bucket=B),
                             Engine(cfg, word_dict, params, beam_size=1,
                                    batch_bucket=B))
    cars, _ = engines["cars"]
    hred, hred_greedy = engines["hredqs"]
    calls = (("rank_batch_gru", lambda: cars.rank_batch(reqs)),
             ("suggest_beam5_gru", lambda: cars.suggest_batch(hists)),
             ("suggest_beam5_hredqs", lambda: hred.suggest_batch(hists)),
             ("suggest_greedy_hredqs",
              lambda: hred_greedy.suggest_batch(hists)))
    launches, outs, first_ms = {}, {}, {}
    with torch.inference_mode():
        for path, fn in calls:
            t = time.perf_counter()
            outs[path], launches[path] = counted(path, fn)
            first_ms[path] = (time.perf_counter() - t) * 1e3
    log(f"GRU paths, launches per path: {json.dumps(launches)}")
    log(f"first-call wall ms: {json.dumps(first_ms)}")
    scores = np.asarray(outs["rank_batch_gru"])
    if scores.shape != (B, N) or not np.isfinite(scores).all():
        raise AssertionError("rank_batch_gru returned bad scores")
    for path, k in (("suggest_beam5_gru", BEAM), ("suggest_beam5_hredqs", BEAM),
                    ("suggest_greedy_hredqs", 1)):
        check_suggestions(path, outs[path], k)
    log(f"sample CARS-GRU suggestion: {outs['suggest_beam5_gru'][0][0]}; "
        f"HRED-QS beam-5: {outs['suggest_beam5_hredqs'][0][0]}, greedy: "
        f"{outs['suggest_greedy_hredqs'][0][0]}")
    with torch.inference_mode():
        walls = steady_walls(calls)
        log(f"steady wall ms (3 runs each, B={B}): {json.dumps(walls)}")
        for name, fn in calls:
            where_time_goes(name, fn)
    del engines, cars, hred, hred_greedy

    # training at the ModelConfig dropouts (0.2) and optimizer (Adam)
    train_ms = {}
    cfg = full_width_config("cars", train=True, **GRU)
    model = build_model(cfg, device="cuda", seed=0)
    batch = random_session_batch(np.random.RandomState(7)).to("cuda")
    state, step, launches["train_step_gru"] = train_steps("train_step_gru",
                                                          cfg, model, batch)
    launches["eval_loss_gru"] = eval_loss("eval_loss_gru", cfg, model, batch)
    where_time_goes("train_step_gru", lambda: step(state, batch, 1))
    train_ms["train_step_gru"] = timed_ms(lambda: step(state, batch, 1),
                                          iters=5, warmup=1)
    del model, state, step, batch

    cfg = full_width_config("hredqs", train=True, **GRU)
    model = build_model(cfg, device="cuda", seed=0)
    batch = random_suggest_batch(np.random.RandomState(8)).to("cuda")
    state, step, launches["train_step_hredqs"] = train_steps(
        "train_step_hredqs", cfg, model, batch, reading=nll_f32)
    where_time_goes("train_step_hredqs", lambda: step(state, batch, 1))
    train_ms["train_step_hredqs"] = timed_ms(lambda: step(state, batch, 1),
                                             iters=5, warmup=1)
    ckpt = Checkpointer(ckpt_dir, "hredqs")
    ckpt.save_latest(state, cfg, word_dict, {"step": state.step})
    ckpt.wait()
    with torch.inference_mode():
        loaded = Engine.from_checkpoint(ckpt.latest_path, beam_size=BEAM,
                                        batch_bucket=8)
        got = loaded.suggest_batch(hists[:8])
        want = Engine(cfg, word_dict, model.state_dict(), beam_size=BEAM,
                      batch_bucket=8).suggest_batch(hists[:8])
    log(f"HRED-QS checkpoint -> Engine.from_checkpoint: beam-5 suggestions "
        f"for 8 histories equal to the in-memory Engine's: {got == want}")
    if got != want:
        raise AssertionError("HRED-QS Engine.from_checkpoint suggestions "
                             "differ")
    log(f"train steps (CUDA events, mean of 5 after warm-up, B={B}): "
        f"{json.dumps(train_ms)}")
    return launches, train_ms


# (model type, encoders) of the small card-vs-CPU checks
SMALL_MODELS = (("cars", "lstm"), ("cars", "gru"), ("hredqs", "gru"))


def small_model_check() -> None:
    """Small float32 models -- CARS with LSTMs, CARS with GRUs, HRED-QS
    with GRUs: each ``Engine`` on the card (kernel 1 or 7, kernel 2 for
    CARS) must agree with the same ``Engine`` on the CPU (plain versions),
    and one SGD train step of each on the card (kernels 4/5 or 8/9) with
    the same step on the CPU, on ragged batches.  SGD keeps the update
    linear in the gradient, so a float32 rounding difference in a
    near-zero gradient element cannot flip an Adam step's sign and the
    parameters compare as tightly as the gradients."""
    from context_attentive_ir_tpu_torch.config import default_config
    from context_attentive_ir_tpu_torch.models import build_model
    from context_attentive_ir_tpu_torch.serve import Engine
    from context_attentive_ir_tpu_torch.train import (
        create_train_state,
        make_train_step,
    )

    dims = dict(vocab_size=300, emsize=32, nhid=16, nhid_ffnn=32,
                max_query_len=8, max_doc_len=12, max_session_len=3,
                num_candidates=8, dropout=0.0, dropout_emb=0.0,
                dropout_rnn=0.0)
    word_dict = synthetic_dictionary(dims["vocab_size"])
    rng = np.random.RandomState(9)
    words = word_dict.tokens()

    def text(n):
        return " ".join(rng.choice(words, size=n))

    reqs = [(text(4), [text(7) for _ in range(6)],
             [(text(3), [text(5)]), text(2)]) for _ in range(5)]
    hists = [[(text(3), [text(6), text(4)]), text(5)] for _ in range(5)]
    hists.append([text(6)])
    for model_type, rnn in SMALL_MODELS:
        cfg = default_config(model_type).replace(
            rnn_type=rnn, session_rnn_type=rnn, **dims)
        params = build_model(cfg, device="cpu", seed=1).state_dict()
        for beam in (3, 1):
            gpu = Engine(cfg, word_dict, params, beam_size=beam,
                         batch_bucket=4)
            cpu = Engine(cfg, word_dict, params, beam_size=beam,
                         batch_bucket=4, device="cpu")
            err = 0.0
            if model_type == "cars":
                rg, rc = gpu.rank_batch(reqs), cpu.rank_batch(reqs)
                err = max(abs(a - b) for x, y in zip(rg, rc)
                          for a, b in zip(x, y))
            sg, sc = gpu.suggest_batch(hists), cpu.suggest_batch(hists)
            same = ([[t for t, _ in nb] for nb in sg]
                    == [[t for t, _ in nb] for nb in sc])
            s_err = max(abs(a[1] - b[1]) for x, y in zip(sg, sc)
                        for a, b in zip(x, y))
            log(f"small f32 {model_type} ({rnn}) Engine, beam {beam}: card vs "
                f"CPU rank max abs err {err:.3e} (tol 1e-4), suggestions "
                f"identical={same}, score max abs err {s_err:.3e} (tol "
                "1e-4)")
            if not (err <= 1e-4 and same and s_err <= 1e-4):
                raise AssertionError(f"card {model_type} ({rnn}) Engine "
                                     "disagrees with the CPU Engine")

        tcfg = cfg.replace(optimizer="sgd", learning_rate=0.1)
        if model_type == "cars":
            batch = random_session_batch(np.random.RandomState(3), 6, 3, 8,
                                         8, 12, 300, ragged=True)
        else:
            batch = random_suggest_batch(np.random.RandomState(3), 6, 3, 8,
                                         300)
        res = {}
        for dev in ("cpu", "cuda"):
            model = build_model(tcfg, device=dev, seed=None)
            model.load_state_dict(params)
            _, m = make_train_step(model, tcfg)(
                create_train_state(model, tcfg), batch.to(dev), 0)
            res[dev] = ({k: float(v) for k, v in m.items()},
                        {n: p.detach().cpu() for n, p in
                         model.named_parameters()})
        (mc, pc), (mg, pg) = res["cpu"], res["cuda"]
        loss_rel = abs(mg["loss"] - mc["loss"]) / abs(mc["loss"])
        norm_rel = abs(mg["grad_norm"] - mc["grad_norm"]) / mc["grad_norm"]
        p_err = max(float((pg[n] - pc[n]).abs().max()) for n in pc)
        log(f"small f32 {model_type} ({rnn}) train step, card vs CPU: loss rel "
            f"err {loss_rel:.2e} (tol 1e-5), grad_norm rel err "
            f"{norm_rel:.2e} (tol 1e-5), updated parameters max abs err "
            f"{p_err:.2e} (tol 1e-6)")
        if not (loss_rel <= 1e-5 and norm_rel <= 1e-5 and p_err <= 1e-6):
            raise AssertionError(f"card {model_type} ({rnn}) train step "
                                 "disagrees with the CPU step")


def precomputed_path() -> dict:
    """The CARS doc encoder's two directions at full width (16,000 document
    rows of a random batch, T = 30, bf16) as one ``torch.matmul`` projection
    each + ``lstm_recurrence`` (kernel 6), counted; the output is held to
    kernel 1's on the same weights.  Both compute the same LSTM, but kernel
    1 rounds ``[x | h]`` to bf16 together and accumulates the gates in f32,
    while kernel 6 reads a bf16 ``x_proj``: max abs difference <= 2e-2 (the
    bf16 tolerance; outputs in (-1, 1)), mean <= 5e-4."""
    from context_attentive_ir_tpu_torch.models.multitask.cars import CARS
    from context_attentive_ir_tpu_torch.ops.kernels.lstm import (
        lstm_fused,
        lstm_recurrence,
    )

    model = CARS(full_width_config("cars"), device="cuda", seed=0)
    batch = random_session_batch(np.random.RandomState(11),
                                 ragged=True).to("cuda")
    x = model.embeddings(batch.docs.reshape(-1, LD)).contiguous()
    mask = batch.doc_mask.reshape(-1, LD).contiguous()
    layer = model.doc_encoder.layer0
    weights = {d: [getattr(layer, f"{n}_{d}").to(x.dtype).contiguous()
                   for n in ("w_ih", "b_ih", "w_hh")]
               for d in ("fwd", "bwd")}

    def encode():
        outs = []
        for d, (w_ih, b, w_hh) in weights.items():
            x_proj = torch.matmul(x, w_ih) + b
            outs.append(lstm_recurrence(x_proj, mask, w_hh, d == "bwd"))
        return torch.cat(outs, dim=-1)

    out, launches = counted("lstm_precomputed", encode)
    ref = torch.cat([lstm_fused(x, mask, *w, d == "bwd")
                     for d, w in weights.items()], dim=-1)
    diff = (out.float() - ref.float()).abs()
    worst, mean = float(diff.max()), float(diff.mean())
    finite = bool(torch.isfinite(out.float()).all())
    zeros = bool((out[~mask] == 0).all())
    log(f"lstm_precomputed: matmul + kernel 6, doc encoder "
        f"{tuple(x.shape)} -> {tuple(out.shape)} {out.dtype}, launches "
        f"{json.dumps(launches)}; vs kernel 1 on the same weights: max abs "
        f"diff {worst:.3e} (tol 2e-2), mean abs diff {mean:.3e} (tol 5e-4); "
        f"finite={finite}, masked outputs 0: {zeros}")
    if not (finite and zeros and worst <= 2e-2 and mean <= 5e-4):
        raise AssertionError("lstm_precomputed disagrees with kernel 1")
    walls = steady_walls((("lstm_precomputed", encode),))
    log(f"steady wall ms (3 runs): {json.dumps(walls)}")
    return {"lstm_precomputed": launches}


# -- the training entry point -------------------------------------------------

FIT_TOPICS, FIT_WORDS = 1250, 40   # a 50,000-word vocabulary
FIT_SESSIONS = {"train": 5120, "dev": 256, "test": 64}
FIT_EPOCHS = {"cars": 2, "hredqs": 2}
HRED_SESSIONS = 1280   # HRED-QS trains on the first sessions of the file
TIMED_STEPS, PROFILED_STEPS = 20, 10


def fit_args(model_type: str, files: dict, run_dir: str, *extra) -> list:
    """The command line of one ``cli.main`` run at the serving widths."""
    args = ["--model_type", model_type, "--model_dir", run_dir,
            "--model_name", f"{model_type}_fit", "--batch_size", str(B),
            "--test_batch_size", str(B), "--emsize", str(EMSIZE), "--nhid",
            str(NHID), "--nhid_ffnn", str(NHID_FFNN), "--max_query_len",
            str(LQ), "--max_doc_len", str(LD), "--max_session_len", str(S),
            "--num_candidates", str(N), "--compute_dtype", "bfloat16",
            "--beam_size", str(BEAM), "--display_iter", "5",
            "--test_file", str(files["test"])]
    if model_type == "hredqs":
        args += ["--rnn_type", "gru", "--session_rnn_type", "gru",
                 "--valid_metric", "bleu-1", "--max_examples",
                 str(HRED_SESSIONS)]
    return args + list(extra)


def trainer_path(model_type: str, files: dict, run_dir: str) -> dict:
    """``cli.main.main`` at full width for ``model_type``: train with
    per-epoch official validation, test, ``--only_test``, ``--resume`` for
    one more epoch; then the Trainer's parts timed on the resumed state.
    Returns the counted launches of the training run."""
    from context_attentive_ir_tpu_torch.cli.main import (
        build_parser,
        main as cli_main,
        prepare,
    )
    from context_attentive_ir_tpu_torch.constants import EOS
    from context_attentive_ir_tpu_torch.data import prefetch
    from context_attentive_ir_tpu_torch.train.trainer import make_iterator

    path = "trainer_fit" if model_type == "cars" else "trainer_fit_hredqs"
    cars = model_type == "cars"
    epochs = FIT_EPOCHS[model_type]
    train = ["--train_file", str(files["train"]), "--dev_file",
             str(files["dev"])]
    argv = fit_args(model_type, files, run_dir, *train, "--num_epochs",
                    str(epochs))
    runs = Path(run_dir)
    name = f"{model_type}_fit"

    def dev_of(trainer, sessions):
        return list(make_iterator(sessions, trainer.config,
                                  trainer.word_dict, B, shuffle=False,
                                  seed=0))

    # the untrained model (the run's seed, so its initial weights)
    _, _, trainer, _, dev_s, _ = prepare(build_parser().parse_args(argv))
    trainer.init_state()
    untrained = trainer.validate(dev_of(trainer, dev_s))
    vocab = len(trainer.word_dict)
    del trainer
    torch.cuda.empty_cache()

    t = time.perf_counter()
    res, launches = counted(path, lambda: cli_main(argv))
    fit_wall = time.perf_counter() - t
    hist, test = res["fit"]["history"], res["test"]
    records = [json.loads(line) for line in
               (runs / f"{name}.metrics.jsonl").read_text().splitlines()]
    epoch_s = [r["time"] for r in records if r["event"] == "epoch"]
    log(f"{path}: cli.main trained {model_type} for {len(hist)} epochs + "
        f"test in {fit_wall:.1f} s; vocabulary {vocab}; launches "
        f"{json.dumps(launches)}; epoch walls s (train + validation + "
        f"metrics) {[round(x, 2) for x in epoch_s]}")
    log(f"{path}: history " + json.dumps(
        [{k: round(v, 4) for k, v in h.items()} for h in hist]))
    log(f"{path}: untrained dev " + json.dumps(
        {k: round(v, 4) for k, v in untrained.items()}))
    log(f"{path}: test " + json.dumps({k: round(v, 4)
                                       for k, v in test.items()}))

    if abs(vocab - VOCAB) > VOCAB // 100:
        raise AssertionError(f"{path}: vocabulary {vocab} is not within 1 % "
                             f"of {VOCAB}")
    n_train = FIT_SESSIONS["train"]
    if cars:
        steps = epochs * -(-n_train // B)
    else:
        from context_attentive_ir_tpu_torch.data import (
            load_data,
            suggest_examples,
        )

        n_ex = len(suggest_examples(load_data(files["train"], LQ, LD, N, S,
                                              HRED_SESSIONS)))
        steps = epochs * -(-n_ex // B)
    fwd, res_k, bwd = PATH_KERNELS[path]
    per_step = 4 if cars else 2   # encoders x directions
    if (launches[res_k], launches[bwd]) != (per_step * steps,) * 2:
        raise AssertionError(f"{path}: {launches[res_k]} / {launches[bwd]} "
                             f"training-pair launches, not {per_step} a step "
                             f"for {steps} steps")
    if len(hist) != epochs or not hist[-1]["train_loss"] < hist[0][
            "train_loss"]:
        raise AssertionError(f"{path}: the epoch train loss did not fall")
    if not all(math.isfinite(v) for h in hist + [test] for v in h.values()):
        raise AssertionError(f"{path}: non-finite metrics")
    want = {"bleu-1", "bleu-4", "rouge-l"} | ({"map", "mrr", "ndcg@10"}
                                              if cars else set())
    if not want <= set(hist[-1]) or not want <= set(test):
        raise AssertionError(f"{path}: metric columns missing: "
                             f"{sorted(hist[-1])}")
    if cars and not hist[-1]["map"] > untrained["map"]:
        raise AssertionError(f"{path}: dev MAP {hist[-1]['map']} not above "
                             f"the untrained model's {untrained['map']}")
    dumps = [f"{name}.test.hyps.jsonl"] + ([f"{name}.test.ranks.jsonl"]
                                           if cars else [])
    for f in (f"{name}.mdl", f"{name}.mdl.checkpoint", *dumps):
        if not (runs / f).exists():
            raise AssertionError(f"{path}: {f} was not written")
    if not all((runs / f).read_text().strip() for f in dumps):
        raise AssertionError(f"{path}: an empty prediction dump")

    key = "map" if cars else "bleu-1"
    retest = cli_main(fit_args(model_type, files, run_dir, "--only_test"))
    log(f"{path}: --only_test {key} {retest['test'][key]} == the run's "
        f"{test[key]}: {retest['test'][key] == test[key]}")
    if retest["test"] != test:
        raise AssertionError(f"{path}: --only_test does not reproduce the "
                             "test metrics")

    # a resumed run of one more epoch (cli.main's own steps, keeping its
    # Trainer for the timings below)
    resume = fit_args(model_type, files, run_dir, *train, "--resume",
                      "--num_epochs", str(epochs + 1))
    _, run, trainer, train_s, dev_s, _ = prepare(
        build_parser().parse_args(resume))
    more = trainer.fit(train_s, dev_s)["history"]
    log(f"{path}: --resume for one more epoch continued at epoch "
        f"{[h['epoch'] for h in more]} (train_loss "
        f"{[round(h['train_loss'], 4) for h in more]})")
    if [h["epoch"] for h in more] != [epochs]:
        raise AssertionError(f"{path}: the resumed run did not continue at "
                             f"epoch {epochs}")

    # the Trainer's parts on the resumed state
    dev_batches = dev_of(trainer, dev_s)
    torch.cuda.synchronize()
    t = time.perf_counter()
    trainer.validate(dev_batches)
    valid_s = time.perf_counter() - t
    dec = trainer.decode_fn
    dec.calls = dec.steps = 0
    done = rows = 0
    for b in dev_batches:
        seqs = dec(b)
        if cars:
            valid = (b.target_mask.any(-1) & b.row_mask[:, None]).reshape(-1)
        else:
            valid = b.row_mask
        rows += int(valid.sum())
        done += int((seqs[valid] == EOS).any(-1).sum())
    log(f"{path}: validation of {len(dev_s)} dev sessions "
        f"({len(dev_batches)} batches) {valid_s:.3f} s; beam-{BEAM} decode "
        f"with early exit: {done}/{rows} hypotheses ended in EOS before "
        f"max_len ({done / max(rows, 1):.3f}), mean decode steps "
        f"{dec.steps / max(dec.calls, 1):.2f} of {LQ + 1}, "
        f"decode_init_full fallbacks {dec.fallbacks}")

    collate = {}
    for pack in (True, False):
        t = time.perf_counter()
        it = make_iterator(train_s, trainer.config, trainer.word_dict, B,
                           shuffle=True, seed=run.seed, pack=pack)
        build_s = time.perf_counter() - t
        t = time.perf_counter()
        n = sum(1 for _ in zip(range(TIMED_STEPS), it.epoch(0)))
        collate[pack] = (build_s, (time.perf_counter() - t) / n * 1e3)
        if pack:
            train_it = it
    n_epoch = len(train_it)
    log(f"{path}: host collate per batch of {B} (mean of {n}): pack_cache on "
        f"{collate[True][1]:.2f} ms (one-time pack of {n_epoch} batches "
        f"{collate[True][0]:.2f} s), off {collate[False][1]:.2f} ms")

    def loop(n_steps):   # the train part of Trainer.fit's epoch
        batches = prefetch(train_it.epoch(epochs + 1), run.prefetch_batches)
        for _, batch in zip(range(n_steps), batches):
            trainer.state, _ = trainer.train_step(
                trainer.state, batch.to(trainer.device), run.seed)
        batches.close()

    n = min(TIMED_STEPS, n_epoch)
    torch.cuda.synchronize()
    t = time.perf_counter()
    loop(n)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t
    slots = B * S * N if cars else B
    log(f"{path}: {n} steps of the Trainer's loop (prefetch "
        f"{run.prefetch_batches}, pack_cache {run.pack_cache}; an epoch has "
        f"{n_epoch}): {loop_s:.3f} s = {loop_s / n * 1e3:.1f} ms a step -> "
        f"{n * slots / loop_s:.0f} trained "
        f"{'docs' if cars else 'examples'}/s")
    n = min(PROFILED_STEPS, n_epoch)
    where_time_goes(f"{path} training loop ({n} steps)", lambda: loop(n))
    where_time_goes(f"{path} validation", lambda: trainer.validate(
        dev_batches))
    del trainer
    torch.cuda.empty_cache()
    return {path: launches}


def trainer_paths(tmp: str) -> dict:
    """Seeded AOL-scale fixtures (50,000 words, sessions of 2..S turns, N
    candidates) under ``tmp``, then ``trainer_path`` for CARS and for
    HRED-QS."""
    from context_attentive_ir_tpu_torch.data.synthetic import (
        write_aol_scale_fixture,
    )

    t = time.perf_counter()
    files = {name: write_aol_scale_fixture(
        Path(tmp) / f"{name}.jsonl", n_sessions=n, n_topics=FIT_TOPICS,
        words_per_topic=FIT_WORDS, min_turns=2, max_turns=S, n_candidates=N,
        seed=20 + i) for i, (name, n) in enumerate(FIT_SESSIONS.items())}
    log(f"trainer fixtures {FIT_SESSIONS} written in "
        f"{time.perf_counter() - t:.1f} s")
    launches = {}
    for model_type in ("cars", "hredqs"):
        launches.update(trainer_path(model_type, files,
                                     str(Path(tmp) / "runs")))
    # cli.main's log handlers (stdout, a file under tmp) end with the phase
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
        h.close()
    return launches


# -- phase 5: times ----------------------------------------------------------


def time_beamgen(gen, launches: dict, max_err: float) -> dict:
    from context_attentive_ir_tpu_torch.ops.kernels.beamgen import (
        generator_topk_lse,
        generator_topk_lse_reference,
    )

    dtype = torch.bfloat16
    res = {}
    for rows, kc in ((B * S * BEAM, BEAM + 1), (B * S, 2)):
        x, tt = beamgen_inputs(gen, rows, dtype, integer=False)
        ms = timed_ms(lambda: generator_topk_lse(x, tt, kc), 10)
        plain = timed_ms(lambda: generator_topk_lse_reference(x, tt, kc), 5)

        def library():
            logits = torch.matmul(x, tt)
            return torch.logsumexp(logits.float(), -1), torch.topk(logits,
                                                                   kc)

        lib = timed_ms(library, 10)
        flops = 2.0 * rows * EMSIZE * VOCAB
        n_bytes = (x.numel() + tt.numel()) * 2 + rows * (kc * 8 + 4)
        bnd, by = bound_ms(flops, n_bytes, dtype)
        log(f"generator_topk_lse bf16 R={rows} E={EMSIZE} V={VOCAB} "
            f"kc={kc}: kernel {ms:.3f} ms, plain {plain:.3f} ms, library "
            f"(matmul+logsumexp+topk) {lib:.3f} ms, bound {bnd:.4f} ms "
            f"({by})")
        res[rows] = (ms, plain, lib, bnd, by)
    ms, plain, lib, bnd, by = res[B * S * BEAM]
    log_earlier("generator_topk_lse", ms, plain, lib, bnd)
    return kernel_row("generator_topk_lse", "beamgen.cu", "beamgen.py:286",
                      launches, max_err, ms, plain, lib, bnd, by)


# what the timing rows name for each recurrence: cuDNN's module, the source
# files, and the lines of the TPU kernels' pallas_call (forward, residual,
# backward)
RNN_TIMING = {
    "lstm": (torch.nn.LSTM, ("lstm_fwd.cu", "lstm_fwd.cu", "lstm_bwd.cu"),
             ("lstm.py:314", "lstm.py:494", "lstm.py:563")),
    "gru": (torch.nn.GRU, ("gru_fwd.cu", "gru_fwd.cu", "gru_bwd.cu"),
            ("gru.py:116", "gru.py:289", "gru.py:348")),
}


def time_rnn(gen, rnn: str, launches: dict, fwd_err: float,
             pair_err: dict) -> list[dict]:
    """The forward kernel and the training pair of ``rnn`` (kernels 1, 4,
    5 or 7, 8, 9) at the doc encoder's shape, one direction, bf16, against
    their plain versions and cuDNN's module of the same recurrence as the
    yardstick (inference forward; training forward with autograd on;
    backward alone, from a retained graph)."""
    mod = rnn_kernels(rnn)
    cudnn_cls, sources, replaces = RNN_TIMING[rnn]
    fwd, res, bwd = f"{rnn}_fused", f"{rnn}_fused_res", f"{rnn}_fused_bwd"
    plain = {k: getattr(mod, k + "_reference") for k in (fwd, res, bwd)}
    dtype = torch.bfloat16
    (x, *w), mask = RNNS[rnn][0](gen, dtype)
    rows, steps, e = x.shape
    h = w[2].shape[0]
    out, *state = getattr(mod, res)(x, mask, *w)
    dout = (torch.randn(out.shape, generator=gen, device="cuda")
            * 0.5).to(dtype)
    cudnn = cudnn_cls(e, h, batch_first=True, device="cuda", dtype=dtype)
    ms, plain_ms, lib = {}, {}, {}
    with torch.inference_mode():
        ms[fwd] = timed_ms(lambda: getattr(mod, fwd)(x, mask, *w), 5)
        plain_ms[fwd] = timed_ms(lambda: plain[fwd](x, mask, *w), 3)
        lib[fwd] = timed_ms(lambda: cudnn(x), 5)
    ms[res] = timed_ms(lambda: getattr(mod, res)(x, mask, *w), 5)
    plain_ms[res] = timed_ms(lambda: plain[res](x, mask, *w), 3)
    ms[bwd] = timed_ms(lambda: getattr(mod, bwd)(x, mask, *w, *state, dout),
                       5)
    plain_ms[bwd] = timed_ms(lambda: plain[bwd](x, mask, *w, *state, dout),
                             3)
    xg = x.detach().requires_grad_()
    lib[res] = timed_ms(lambda: cudnn(xg), 5)
    o, _ = cudnn(xg)
    wrt = [xg, *cudnn.parameters()]
    lib[bwd] = timed_ms(lambda: torch.autograd.grad(o, wrt, dout,
                                                    retain_graph=True), 5)
    del o

    gates = w[0].shape[1] // h
    weights = sum(t.numel() for t in w) * 2
    boundaries = len(state) * state[0].numel() * 4
    flops_f = 2.0 * rows * steps * (e + h) * gates * h
    bytes_f = (x.numel() + out.numel()) * 2 + weights + mask.numel()
    # recompute + dx + dh + dW_ih + dW_hh: three times the forward's flops
    bytes_b = ((2 * x.numel() + dout.numel()) * 2 + 2 * weights
               + mask.numel() + boundaries)
    rows_out = []
    for name, src, line, flops, n_bytes, err, what in (
            (fwd, sources[0], replaces[0], flops_f, bytes_f, fwd_err,
             "inference forward"),
            (res, sources[1], replaces[1], flops_f, bytes_f + boundaries,
             pair_err[res][dtype], "training forward"),
            (bwd, sources[2], replaces[2], 3 * flops_f, bytes_b,
             pair_err[bwd][dtype], "backward alone")):
        bnd, by = bound_ms(flops, n_bytes, dtype)
        log(f"{name} bf16 [{rows},{steps},{e}]->{h} one direction, TC="
            f"{TIME_CHUNK}: kernel {ms[name]:.3f} ms, plain "
            f"{plain_ms[name]:.3f} ms, cuDNN {cudnn_cls.__name__} {what} "
            f"{lib[name]:.3f} ms, bound {bnd:.4f} ms ({by})")
        log_earlier(name, ms[name], plain_ms[name], lib[name], bnd)
        rows_out.append(kernel_row(name, src, line, launches, err, ms[name],
                                   plain_ms[name], lib[name], bnd, by))
    return rows_out


def time_row_tiles(gen) -> None:
    """Kernel 9 in bf16, one direction, at the query encoder's shape (R =
    B*S, T = Lq; also HRED-QS's) and the doc encoder's (R = B*S*N, T = Ld)
    with 16-row blocks (``row_tiles=1``) and the tiles' own 64-row blocks
    (``row_tiles=4``): the two times ``bwd_row_tiles`` chooses between."""
    mod = rnn_kernels("gru")
    for rows, steps in ((B * S, LQ), (B * S * N, LD)):
        (x, *w), mask = gru_inputs(gen, torch.bfloat16, rows, steps)
        out, hb = mod.gru_fused_res(x, mask, *w)
        dout = (torch.randn(out.shape, generator=gen, device="cuda")
                * 0.5).to(torch.bfloat16)
        ms = {mt: timed_ms(lambda: mod.gru_fused_bwd(
            x, mask, *w, hb, dout, row_tiles=mt), 5) for mt in (1, 4)}
        log(f"gru_fused_bwd bf16 [{rows},{steps},{EMSIZE}]->{NHID}: "
            f"16-row blocks {ms[1]:.3f} ms ({-(-rows // 16)} blocks), "
            f"64-row blocks {ms[4]:.3f} ms ({-(-rows // 64)} blocks); "
            f"bwd_row_tiles takes {mod.bwd_row_tiles(NHID, rows)}")


def time_recurrence(gen, launches: dict, max_err: float) -> dict:
    """Kernel 6 at the doc encoder's shape, one direction, bf16: the kernel,
    the ``torch.matmul`` projection that feeds it, its plain version.  Its
    bound: x_proj read once and the output written once (bytes), against
    2*B*T*H*4H flops.  No single PyTorch call runs an LSTM from precomputed
    gates, so library_ms is null; cuDNN's and kernel 1's times for the
    whole LSTM stand in the fused kernels' rows."""
    from context_attentive_ir_tpu_torch.ops.kernels.lstm import (
        lstm_recurrence_fwd,
        lstm_recurrence_reference,
    )

    dtype = torch.bfloat16
    (x, w_ih, b, w_hh), mask = lstm_inputs(gen, dtype)
    xp = (torch.matmul(x, w_ih) + b).contiguous()
    rows, steps, g4 = xp.shape
    h = g4 // 4
    with torch.inference_mode():
        ms = timed_ms(lambda: lstm_recurrence_fwd(xp, mask, w_hh), 5)
        plain = timed_ms(lambda: lstm_recurrence_reference(xp, mask, w_hh), 3)
        proj = timed_ms(lambda: torch.matmul(x, w_ih) + b, 5)
    flops = 2.0 * rows * steps * h * g4
    n_bytes = ((xp.numel() + rows * steps * h + w_hh.numel()) * 2
               + mask.numel())
    bnd, by = bound_ms(flops, n_bytes, dtype)
    log(f"lstm_recurrence bf16 [{rows},{steps},{g4}]->{h} one direction: "
        f"kernel {ms:.3f} ms, the matmul projection before it {proj:.3f} ms "
        f"(together {ms + proj:.3f} ms), plain {plain:.3f} ms, library none "
        f"(no single PyTorch call), bound {bnd:.4f} ms ({by})")
    return kernel_row("lstm_recurrence", "lstm_rec.cu", "lstm.py:129",
                      launches, max_err, ms, plain, None, bnd, by,
                      matmul_ms=proj)


def kernel_row(name: str, src: str, replaces: str, launches: dict,
               max_err: float, ms: float, plain: float, lib, bnd: float,
               by: str, **extra) -> dict:
    """One entry of the kernels line (launches from the count ``name``)."""
    return {"name": name, "route": "cuda",
            "source": f"context_attentive_ir_tpu_torch/csrc/{src}",
            "replaces": f"context_attentive_ir_tpu/ops/pallas/{replaces}",
            **by_path(launches, name), "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib, **extra}


def time_slate(gen, launches: dict, max_err: float) -> list[dict]:
    """Kernel 10 at the rank slate (R = B*S*N) and suggest init's clicked
    docs (R = B*S*C), T = Ld, bf16.  No single PyTorch call computes this
    function, so library_ms is null."""
    from context_attentive_ir_tpu_torch.ops.kernels.slate import (
        attn_pool,
        attn_pool_reference,
    )

    dtype = torch.bfloat16
    rows_out = []
    for rows in (B * S * N, B * S * MAX_CLICKS):
        (s, q, w, b), mask = slate_inputs(gen, dtype, rows, LD)
        ms = timed_ms(lambda: attn_pool(s, mask, q, w, b), 10)
        plain = timed_ms(lambda: attn_pool_reference(s, mask, q, w, b), 5)
        h = H2
        flops = 2.0 * rows * LD * h * h + 4.0 * rows * LD * h
        n_bytes = ((s.numel() + q.numel() + w.numel() + b.numel()
                    + rows * h) * 2 + mask.numel())
        bnd, by = bound_ms(flops, n_bytes, dtype)
        log(f"attn_pool bf16 [{rows},{LD},{h}]: kernel {ms:.3f} ms, plain "
            f"{plain:.3f} ms, library none (no single PyTorch call), bound "
            f"{bnd:.4f} ms ({by})")
        log_earlier("attn_pool", ms, plain, None, bnd, rows)
        f32 = [t.float() for t in (s, q, w, b)]
        ms32 = timed_ms(lambda: attn_pool(f32[0], mask, *f32[1:]), 5)
        log(f"attn_pool f32 [{rows},{LD},{h}] (the CUDA-core kernel): "
            f"{ms32:.3f} ms")
        rows_out.append(kernel_row(
            "attn_pool", "slate_pool.cu", "slate.py:158", launches, max_err,
            ms, plain, None, bnd, by, rows=rows, steps=LD))
    return rows_out


def time_beamgen_modes(gen, launches: dict, max_err: float,
                       int8_err: float) -> list[dict]:
    """Kernel 2 with ``prune``, its int8 mode (pruned, as the int8 Engine
    runs it), and kernel 3, at the beam-5 shape (R = 1600, kc = 6, bf16):
    kernel, plain version, library (matmul + logsumexp + topk; for int8
    the matmul on the bf16-cast int8 table, times the scale).
    ``time_beamgen`` times the serial kernel with ``prune=False``."""
    from context_attentive_ir_tpu_torch.ops.kernels.beamgen import (
        generator_topk_lse,
        generator_topk_lse_reference,
    )

    dtype = torch.bfloat16
    rows, kc = B * S * BEAM, BEAM + 1
    x, tt = beamgen_inputs(gen, rows, dtype, integer=False)
    _, q_t, scale = int8_inputs(gen, rows, dtype, integer=False)
    flops = 2.0 * rows * EMSIZE * VOCAB
    out_bytes = rows * (kc * 8 + 4)

    def library(table, scl=None):
        logits = torch.matmul(x, table)
        if scl is not None:
            logits = logits * scl
        return torch.logsumexp(logits.float(), -1), torch.topk(logits, kc)

    rows_out = []
    for name, kw, plain_args, err in (
            ("generator_topk_lse_pruned", {"prune": True}, (tt,), max_err),
            ("generator_topk_lse_pipelined", {"pipeline": True}, (tt,),
             max_err),
            ("generator_topk_lse_int8", {"scale": scale, "prune": True},
             (q_t, scale), int8_err)):
        mode = name.rpartition("_")[2]
        table = plain_args[0]
        ms = timed_ms(lambda: generator_topk_lse(x, table, kc, **kw), 10)
        plain = timed_ms(lambda: generator_topk_lse_reference(
            x, plain_args[0], kc, *plain_args[1:]), 5)
        if mode == "int8":
            q_bf16 = q_t.to(dtype)
            lib = timed_ms(lambda: library(q_bf16, scale.to(dtype)), 10)
            n_bytes = x.numel() * 2 + q_t.numel() + scale.numel() * 4
        else:
            lib = timed_ms(lambda: library(tt), 10)
            n_bytes = (x.numel() + tt.numel()) * 2
        bnd, by = bound_ms(flops, n_bytes + out_bytes, dtype)
        log(f"generator_topk_lse {mode} bf16 R={rows} E={EMSIZE} V={VOCAB} "
            f"kc={kc}: kernel {ms:.3f} ms, plain {plain:.3f} ms, library "
            f"{lib:.3f} ms, bound {bnd:.4f} ms ({by})")
        log_earlier(name, ms, plain, lib, bnd)
        rows_out.append(kernel_row(name, "beamgen.cu", "beamgen.py:286",
                                   launches, err, ms, plain, lib, bnd, by))

    # the selection nearly skipped: what the product and the logsumexp cost
    fx, ft = front_loaded(gen, rows, dtype)
    front = timed_ms(lambda: generator_topk_lse(fx, ft, kc, prune=True), 10)
    log(f"generator_topk_lse pruned bf16 R={rows} kc={kc} on front-loaded "
        f"data (every row's top scores in the first 2,048 columns: few "
        f"insertions, the product and the logsumexp whole): {front:.3f} ms")

    # the greedy step's shape, and each mode's blocks and vocab split
    from context_attentive_ir_tpu_torch.ops.kernels.beamgen import (
        _blocks_per_sm,
        _sm_count,
        vocab_splits,
    )
    from context_attentive_ir_tpu_torch.ops.kernels.build import load_library

    g_rows, g_kc = B * S, 2
    gx = x[:g_rows].contiguous()
    for name, kw in (("serial", {}), ("pruned", {"prune": True}),
                     ("pipelined", {"pipeline": True}),
                     ("int8", {"scale": scale, "prune": True})):
        table = q_t if "scale" in kw else tt
        ms = timed_ms(lambda: generator_topk_lse(gx, table, g_kc, **kw), 10)
        t_code = 2 if "scale" in kw else 1
        resident = ctypes.c_int()
        load_library().cair_beamgen_occupancy(
            EMSIZE, 1, t_code, int("prune" in kw), int("pipeline" in kw),
            ctypes.byref(resident))
        blocks = resident.value
        # every mode is split as the serial kernel's residency gives
        slots = _sm_count(0) * _blocks_per_sm(0, EMSIZE, 1, t_code)
        log(f"generator_topk_lse {name} bf16: greedy R={g_rows} kc={g_kc} "
            f"{ms:.3f} ms; {blocks} block(s) an SM, splits (n, tiles) at "
            f"R={rows}: {vocab_splits(rows, VOCAB, slots)}, at R={g_rows}: "
            f"{vocab_splits(g_rows, VOCAB, slots)}")
    return rows_out


def log_earlier(name: str, ms: float, plain: float, lib, bnd: float,
                rows: int | None = None) -> None:
    """Log a redesigned kernel's time beside its last CUDA-core version's
    (for the log only: EARLIER_MS was not measured in this run); ``rows``
    picks the reading of a kernel timed at several row counts."""
    earlier = EARLIER_MS.get(name)
    if isinstance(earlier, dict):
        earlier = earlier.get(rows)
    if earlier is not None:
        log(f"{name}{'' if rows is None else f' R={rows}'}: {ms:.3f} ms "
            f"now, {earlier:.3f} ms in its last CUDA-core version on an "
            "H100 80GB HBM3 at 700 W; "
            f"{ms / plain:.2f} x its plain version, "
            + (f"{ms / lib:.2f} x the library call, " if lib else "")
            + f"{ms / bnd:.1f} x its bound")


def ptxas_summary(text: str) -> str:
    """One line per compiled kernel from ``nvcc -Xptxas -v``'s output:
    registers, spill bytes and static shared memory."""
    import re

    lines, name, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}\d+", "",
                          m.group(1))[:60]
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and name:
            lines.append(f"  {name}: {line.split(':', 1)[1].strip()}; "
                         f"{spill}")
            name = None
    return "ptxas per kernel:\n" + "\n".join(lines)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


# the timing rows' earlier readings (ms, bf16, one H100 80GB HBM3 at
# 700 W; the recurrent kernels at the doc-encoder shape, the generator's
# modes at the beam-5 step's, kernel 10 by row count at T = Ld, as the last
# chip_smoke run before their redesign read them): the last CUDA-core
# versions of the kernels that have since been redesigned.  Logged beside
# the new times, never put into the kernels line, which holds only what
# this run measured.
EARLIER_MS = {"lstm_fused": 11.269, "lstm_fused_res": 11.256,
              "lstm_fused_bwd": 44.075, "gru_fused": 10.068,
              "gru_fused_res": 9.722, "gru_fused_bwd": 28.380,
              "generator_topk_lse": 5.233,
              "generator_topk_lse_pruned": 3.036,
              "generator_topk_lse_int8": 3.041,
              "generator_topk_lse_pipelined": 3.761,
              "attn_pool": {B * S * N: 2.067, B * S * MAX_CLICKS: 0.958}}

# --only selectors, in running order.  "lstm", "grukernels",
# "beamkernels" and "slatekernels" are the LSTM, GRU, generator and slate
# pool kernels' shares of "kernels"; a run with no selector runs every
# other phase.
PHASES = ("kernels", "lstm", "grukernels", "beamkernels", "slatekernels",
          "serving", "train", "indexed", "gru", "small", "kernel6",
          "trainer")
SHARES = {"lstm", "grukernels", "beamkernels", "slatekernels"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="",
                    help="comma-separated phases to run after the build "
                         f"(of {', '.join(PHASES)}); default: all")
    only = [p for p in ap.parse_args().only.split(",") if p]
    if any(p not in PHASES for p in only):
        ap.error(f"--only takes phases of {PHASES}")
    full = not only
    run = set(only) if only else set(PHASES) - SHARES
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from context_attentive_ir_tpu_torch.ops.kernels.build import build

    log(card())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    seconds = {}

    def phase(name: str, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = round(time.perf_counter() - t, 1)
        log(f"phase {name}: {seconds[name]} s")
        return out

    ptxas = phase("build", lambda: build(ptxas_info=True))
    log(ptxas_summary(ptxas))
    log(tile_note())

    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("float32 comparisons run with TF32 off "
        "(torch.backends.cuda.matmul.allow_tf32 = "
        "torch.backends.cudnn.allow_tf32 = False)")

    errs = {}

    def check_rnn(rnn):
        errs[f"fwd_{rnn}"] = check_forward(gen, rnn)
        errs[f"pair_{rnn}"] = check_train_pair(gen, rnn)
        tiles = [check_tiles(gen, rnn)]
        if rnn == "gru":
            tiles.append(check_tiles(gen, rnn, GRU_TILE_SHAPES))
        for worst in tiles:
            for k, v in worst.items():
                d = errs[f"pair_{rnn}"][k]
                d[torch.bfloat16] = max(d[torch.bfloat16], v)

    def check_lstm():
        check_rnn("lstm")
        errs["rec"] = check_recurrence(gen)

    def check_beam():
        errs["beam"] = check_beamgen(gen)
        errs["int8"] = check_beamgen_modes(gen)
        check_beamgen_layouts(gen)
        check_beamgen_limits(gen)

    def check_all():
        check_lstm()
        check_rnn("gru")
        check_beam()
        errs["slate"] = check_slate(gen)
        check_refusals(gen)

    if "kernels" in run:
        phase("kernel checks", check_all)
    elif run & SHARES:
        if "lstm" in run:
            phase("lstm kernel checks", check_lstm)
        if "grukernels" in run:
            phase("gru kernel checks", lambda: check_rnn("gru"))
        if "beamkernels" in run:
            phase("generator kernel checks", check_beam)
        if "slatekernels" in run:
            errs["slate"] = phase("slate kernel checks",
                                  lambda: check_slate(gen))
    elif "kernel6" in run:
        errs["rec"] = phase("kernel 6 checks",
                            lambda: check_recurrence(gen))

    launches, train_ms = {}, {}
    if "serving" in run:
        with torch.inference_mode():
            launches.update(phase("serving", main_path))
    with tempfile.TemporaryDirectory() as tmp:
        if run & {"train", "indexed"}:
            # the indexed phase serves the train phase's checkpoint
            train_launches, ms, ckpt_path = phase(
                "train", lambda: train_path(tmp))
            launches.update(train_launches)
            train_ms.update(ms)
        if "indexed" in run:
            def indexed():
                with torch.inference_mode():
                    out = serving_paths(ckpt_path)
                    small_serving_check()
                return out
            launches.update(phase("indexed", indexed))
        if "gru" in run:
            gru_launches, ms = phase("gru", lambda: gru_paths(tmp))
            launches.update(gru_launches)
            train_ms.update(ms)
    if "small" in run:
        phase("small", small_model_check)
    if "kernel6" in run:
        with torch.inference_mode():
            launches.update(phase("kernel6", precomputed_path))
    if "trainer" in run:
        with tempfile.TemporaryDirectory() as tmp:
            launches.update(phase("trainer", lambda: trainer_paths(tmp)))

    bf16 = torch.bfloat16
    kernels = []

    def timing():
        rnns = [r for r in RNNS if f"fwd_{r}" in errs]
        kernels.extend(row for rnn in rnns for row in time_rnn(
            gen, rnn, launches, errs[f"fwd_{rnn}"][bf16],
            errs[f"pair_{rnn}"]))
        if "gru" in rnns:
            time_row_tiles(gen)
        if "rec" in errs:
            kernels.append(time_recurrence(gen, launches, errs["rec"][bf16]))
        if "beam" in errs:
            kernels.append(time_beamgen(gen, launches, errs["beam"][bf16]))
        if "slate" in errs:
            kernels.extend(time_slate(gen, launches, errs["slate"][bf16]))
        if "beam" in errs:
            kernels.extend(time_beamgen_modes(gen, launches,
                                              errs["beam"][bf16],
                                              errs["int8"]))

    if errs:
        phase("kernel timing", timing)
    if train_ms:
        log(f"train steps (CUDA events, mean of 5, B={B}): "
            f"{json.dumps(train_ms)}")
    log(f"phase seconds: {json.dumps(seconds)}")
    log(card())
    if not full:
        log("partial run (--only " + ",".join(only) + "): "
            + json.dumps({"kernels": kernels}))
        return 0
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
