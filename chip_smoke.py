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
   H = 100, H = 8, T = 1, T = 17, H = 64, 256 and 384), the LSTM pair in
   both dtypes also past the single block (E = 768, 1,024 and 2,048 through
   the x slabs, H = 416 and 512 on clusters of 2, 640 and 1,024 on
   clusters of 4 in bf16, H = 416 to 1,024 on float32 clusters, H = 1,100,
   1,152 and 2,048 on the step route), the LSTM recurrence on precomputed
   gates (kernel 6, with its autograd Function's gradients; in both dtypes
   also at rows one short of and one past the tensor-core tile's 64-row
   block, T = 1, masks with interior gaps and H = 256, 384 and 512, and
   640, 1,024 and 2,048 on the step route, and in bf16 the same bits
   twice), kernel 9 in
   bf16 also with 16-row blocks off their block and at its limits (E = 672
   and 1,024 at H = 128, H = 448 at E = 256), kernel 2, kernel 10 (slate pool) at
   the rank slate and suggest init's row counts and a row count off its
   tile at every multiple of 128 to 1,024 in both dtypes (the resident
   kernel in bf16 at 128 and 256, the wide route elsewhere; the wide
   route past 1,024 -- H = 1,152, 1,280, 2,304 and 4,096, rows off its
   128-token score tile, T = 1 and 65 -- and at 1,024 forced onto it),
   ``pool_supported`` held to ``cair_slate_pool`` called directly and
   ``pool_route`` to ``cair_slate_route`` at every multiple of 64 up to
   4,096, at the tiles' edges (T = 1, 7, 15, 17, 32, 33, 64 and 65 at H =
   128, 256, 384 and 1,024: the first T beyond the resident kernel's
   tile) with fully masked rows pooling to exactly 0,
   fewer than 8 rows refused, and its autograd Function's gradients,
   kernel 2's int8
   mode on a quantized table, and ``prune`` on and off and kernel 3
   (pipelined) against kernel 2, which must give the same bits, also on
   tables laid out as the decoders lay them (V = 50,004 with padded rows,
   the 4,096-word shortlist; kernel 3 at the greedy shape) and on a
   contiguous table with unaligned rows, at each kernel's last whole x
   tile and the E past it (x streamed), E = 3,000, and kc = 128 in every
   mode; then shapes a kernel cannot hold must be refused (the generator
   at kc = 129, kernel 6 at H = 192, the pool at H % 128 or 7 rows, a
   float16 encoder layer), and ``fused_supported`` /
   ``gru_fused_supported`` must say what the launchers take (the step
   routes' shapes E = 256 / 300 at H = 1,025 (GRU), 1,056 (GRU), 1,152,
   2,048 and 4,096 in both dtypes also held to the plain version),
   ``lstm_route`` / ``gru_route`` equal ``cair_lstm_route`` /
   ``cair_gru_route`` at every H to 4,096,
   ``beamgen_smem_bytes`` / ``beamgen_streams_x`` equal the generator
   launcher's plan at every (E, kc, mode) of a grid (kernel 6's one-block
   launcher called directly at H = 640 must refuse it, the step routes'
   launchers a cluster's or one block's shape, the generator's kc = 129);
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
   indexed, int8 and shortlist Engines card vs CPU; then the JAX package's
   run directories and the data-preparation path (``interop``): the
   train phase's state through ``Checkpointer`` as ``state.msgpack`` (the
   JAX format; its MiB, write and read seconds), read back bit for bit,
   ``Engine.from_checkpoint`` on it and on the same state as a pre-msgpack
   ``state.pt`` directory equal bit for bit to the in-memory Engine
   (``rank_batch``, beam-5 ``suggest_batch``), beam-5's walls and host
   reads a decode,
   ``prepare_data bm25`` on a click log of the AOL-scale fixture's first
   1,280 train sessions through the native scorer, ``cli.main`` CARS on
   its output for one epoch with the native vectorizer (its first 8
   batches bit-equal to the Python vectorizer's, the one-time pack timed
   both ways), ``--resume`` for one more epoch and ``--pretrained_path``
   from the run's ``state.msgpack`` files; then the GRU slice:
   CARS with GRU encoders and session recurrences (``rank_batch``, beam-5
   ``suggest_batch``, 8 Adam steps and an eval-loss step) and HRED-QS with
   GRUs (beam-5 and greedy ``suggest_batch``, 8 Adam steps, a checkpoint
   -> ``Engine.from_checkpoint`` round trip with equal suggestions); and
   small float32 CARS (LSTM), CARS (GRU), HRED-QS, seq2seq, ACG,
   untied-generator CARS, M-NSRF (LSTM and GRU) and M-MatchTensor Engines
   and train steps card vs CPU, and the eight rankers (Match-Tensor also
   with GRUs) ``rank_batch`` and train steps card vs CPU; then the doc
   encoder's two directions as one ``torch.matmul`` projection + kernel 6
   (``lstm_precomputed``, held to kernel 1 on the same weights); then the
   training entry point
   (``trainer_fit``): ``cli.main.main`` trains CARS on the first 2,560
   sessions of a seeded AOL-scale fixture of 5,120 with a 50,000-word
   vocabulary (B = 64, the ModelConfig training defaults, beam-5
   validation on 256 sessions) for 2 epochs, tests, reproduces the test
   metrics with ``--only_test`` and resumes for one more epoch, then the
   input pipeline, the training loop, validation and the early exit of
   the trained decoder are timed; the same for HRED-QS with GRUs on the
   first 1,280 sessions (``trainer_fit_hredqs``, 2 epochs; in the default
   run, as for every later ``cli.main`` but CARS's, without ``--resume``
   and the timings, which ``--only`` keeps); then the
   flat-source recommenders (``recommenders``): seq2seq and ACG at the
   same widths with S = 10 context turns (a source of [64, 150] tokens)
   behind ``Engine``, beam-5 and greedy ``suggest_batch`` for 64
   histories, 8 Adam steps each (the float32 NLL reading must fall), a
   checkpoint -> ``Engine.from_checkpoint`` round trip with equal
   suggestions each, a small float32 CARS ``Engine`` at beam 40 through
   the generator kernel (top-41), with and without a shortlist, equal to
   the CPU's up to near-tied scores (a beam-128 shortlist ``Engine``
   refused on the card), and ``cli.main`` for seq2seq and
   ACG as for HRED-QS on the first 1,280 sessions; then the multitask
   baselines (``multitask``): the logits step's top-6 (``exact`` and
   ``chunked`` equal to ``topk_desc`` on f32, bf16-rounded and
   integer-valued scores over [1,600 | 320, 50,000], and the three timed),
   M-MatchTensor's convolution stack at full width in two layouts (timed),
   M-NSRF and M-MatchTensor (nfilters 32) at the CARS serving widths
   behind ``Engine`` (``rank_batch`` for 64 requests, beam-5 and greedy
   ``suggest_batch`` decoding all 320 turns, peak memory read,
   ``index_documents`` refused), 8 Adam steps each on a ragged batch (the
   float32 NLL reading must fall; peak memory read), checkpoint round
   trips, and ``cli.main`` for both as for CARS (2,560 sessions, dev MAP
   above the untrained model's); then the rankers (``rankers``): ESM,
   DSSM (also with ``use_charngram``, byte ids [64, 50, 30, 16]), CDSSM,
   DUET, ARC-I, ARC-II, DRMM and Match-Tensor at their published widths
   (``MODEL_DEFAULTS``) with the serving vocabulary, emsize, lengths,
   slate and dtype behind ``Engine`` (``rank_batch`` for 64 requests x 50
   documents, peak memory read, ``suggest_batch`` refused; a GRU
   Match-Tensor's ``rank_batch``), 8 Adam steps each on a ragged
   ``RankBatch`` (the float32 rank-loss reading must fall; ESM's frozen
   table must not move), checkpoint round trips, and ``cli.main`` for each
   (Match-Tensor on the first 2,560 sessions, the others on 1,280;
   train, validate, test, ``--only_test``; dev MAP above the untrained
   model's, or kept at the fixture's ceiling where the untrained model
   already reaches it); then the wide LSTMs (``widelstm``): CARS at the
   serving widths with nhid 512 in bf16 and float32 (clusters of 2 and 4
   blocks) behind ``Engine`` (``rank_batch``, beam-5 ``suggest_batch``)
   and 4 Adam steps, the same with ``use_pallas_slate`` (its doc pool
   1,024 wide: kernel 10's wide route; ``rank_batch`` and 4 Adam steps
   at 8 sessions), ``cli.main --nhid 512`` in bf16 on the fixture's
   first 256 sessions (one epoch, beam-5 validation) and a bf16 CARS at
   emsize 768 (``rank_batch``), each against the same weights with
   ``use_pallas_rnn=False`` and ``use_pallas_slate=False`` on the card (scores, top-1 beam scores, losses
   within 2e-2 relative in bf16 and 1e-4 in float32; float32 top-1 tokens
   equal); then the wide GRUs (``widegru``): CARS with GRU encoders at
   nhid 512 in bf16 and float32 (clusters of 2 and 4 blocks;
   ``rank_batch``, beam-5 ``suggest_batch``, 4 Adam steps), HRED-QS at
   nhid 1,024 in bf16 (clusters of 4; beam-5 ``suggest_batch``, 4 Adam
   steps) and ``cli.main --rnn_type gru --nhid 512`` in bf16 on the first
   256 sessions, against the plain scan as above; then the generator past
   top-32 and one x tile (``widebeam``): CARS at the serving widths
   behind ``Engine`` at beams 40 and 127 (top-41, top-128) on the float
   and int8 tables and at beam 40 with a 4,096-id shortlist, and CARS at
   emsize 1,536 (x streamed) at beam 5, greedy and one beam-5 decode
   through kernel 3, and in float32 at beam 5, each against the same
   weights through the logits step (n-best scores within PAIR_TOL of the
   Engine's dtype), with the first step's log-probabilities both ways
   beside the bf16 rounding step of the logits; kernels 2, 2p, 2q and 3
   at the beam-40 (R = 12,800, kc = 41), beam-127 (R = 40,640, kc = 128) and
   beam-5 (E = 1,536 and 2,048) steps and at kc 33, 64, 127 and 128 (R =
   1,605), in bf16 and float32, held to their plain version on integer
   and random data, every mode of a table the same bits; then the float32
   tiles, kernels 1, 4, 5 and 7, 8, 9 on split TF32 (``f32bwd``, also
   ``f32``): their gates and the forwards' layout (shared memory, rows, h
   tiles) against the launchers at every H to 1,024 and their routes to
   1,152, 5 and 9 fed 4's and 8's boundaries at time chunks 1 and 6 the
   same bits (their recompute reproduces the forwards' states), all held
   to their plain versions in both directions (5 and 9 the same bits
   twice, 4 and 8 the bits of 1 and 7) at the doc encoder's rows
   with H = 128, 256, 384, 512 and 1,024, the recommenders' source, the
   edges of the one block, of the clusters and of the forwards' h tiles and
   64-row ranks (129, 160, 224, 257, 403, 404, 513, 640, 641, 1,000) and an
   odd E and H (37, 200), and timed beside cuDNN's exact-f32 module (the
   forwards at H = 128 and the source, the backward everywhere; the rows
   ``widelstm`` / ``widegru`` time already are held only), then a float32
   CARS and CARS-GRU at the serving widths: ``rank_batch`` through kernels
   1 / 7 (CARS also beam-5 ``suggest_batch`` through the split-TF32
   generator kernel 2, each call profiled once more) and 4 Adam steps
   through kernels 4 + 5 / 8 + 9, and a float32 CARS with
   ``use_pallas_slate`` (kernel 10's wide route at the doc pool's 256:
   ``rank_batch``, beam-5 ``suggest_batch``, whose init pools the clicked
   documents, and 4 Adam steps), against the plain scan and pool; then the step route (``widestep``): CARS at nhid 2,048 in bf16 (``rank_batch``,
   beam-5 ``suggest_batch``) and 1,152 in float32 (``rank_batch``), and 4
   Adam steps of each at 8 sessions, against the same weights on the
   plain scan; kernels 1, 4, 5 at ``[16000, 30, 256]`` -> 1,152 and 2,048
   in bf16 and 1,152 in float32 and at ``[64, 150, 256]`` -> 4,096 in
   bf16, every output held to its plain version on those inputs in both
   directions and timed beside cuDNN; kernel 6 at ``x_proj [16000, 30,
   4H]``, H = 640 and 2,048 in bf16 and 1,024 in float32, both directions
   counted, held to its plain version and to kernel 1 on the same weights,
   and timed; then the GRU's step route with the slate kernel past 1,024
   (``widegrustep``): CARS-GRU at nhid 1,152 with ``use_pallas_slate``
   (its doc pool 2,304 wide: kernel 10's wide route) in bf16
   (``rank_batch``, beam-5 ``suggest_batch``) and float32 (``rank_batch``),
   and 4 Adam steps of each at 8 sessions, against the same weights on the
   plain scan and pool; kernels 7, 8, 9 at ``[16000, 30, 256]`` -> 1,152
   and 2,048 in bf16 and 1,152 in float32, every output held to its plain
   version in both directions and timed beside cuDNN; kernel 10's wide
   route at ``[16000 | 1280, 30, 2304]`` in both dtypes and ``[1280, 30,
   4096]`` in bf16, and at H = 1,024 in bf16, held to its plain version,
   counted and timed.  Every
   call runs with every launch count set to 0
   just before it and read just after it and must launch exactly the
   kernels ``PATH_KERNELS`` names (``EXACT_LAUNCHES`` times, where fixed);
   each is timed (three steady walls) and profiled once;
5. kernel, plain-version and library times (CUDA events after warm-up)
   with each kernel's bound, printed as one ``{"kernels": [...]}`` line,
   the redesigned kernels' earlier times beside them in the log, kernels
   1, 4 and 5 also at the recommenders' source shape ``[64, 150, 256]``
   (rows with ``rows`` and ``steps``) and at ``[16000, 30, 256]`` -> 512
   and 1,024 in both dtypes and float32 -> 256 and 384, kernels 7, 8 and 9
   at ``[16000, 30, 256]`` -> 512 and 1,024 in both dtypes (rows with
   ``rows``, ``steps``, ``e``, ``h``, ``dtype``; checked against their
   plain versions on those inputs first), kernels 2, 2p, 2q and 3 at
   ``widebeam``'s steps and in float32 at the beam-5 and greedy steps
   (rows with ``step``, ``rows``, ``e``, ``kc``, ``dtype``), kernel 9
   with 16-row and 64-row
   blocks at the query and doc encoders' shapes, kernel 10 at every width
   to 1,024 in both dtypes at the rank slate's and suggest init's rows
   beside the plain version (three rounds each, median and range; the
   wide route forced beside the resident kernel; logged, the bf16 rows at
   256 and the float32 rank slate's in the line), and the train
   steps' times.

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
first for its checkpoint), ``interop`` (run directories, BM25 preparation,
the native vectorizer, beam-5's host reads; runs ``train`` first for its
state), ``gru`` (CARS-GRU and HRED-QS), ``small`` (the
small float32 models card vs CPU), ``kernel6`` (``lstm_precomputed``),
``f32bwd`` or ``f32`` (float32 kernels 1, 4, 5, 7, 8, 9 on split TF32:
gates, layouts, checks, forward timings at H = 128 and the source and
backward timings at H = 128 to 1,024, float32 CARS and CARS-GRU
``rank_batch``, CARS beam-5 ``suggest_batch`` and train steps against the
plain scan), ``widelstm`` (CARS at nhid 512 in bf16 and float32 -- ``rank_batch``,
beam-5 ``suggest_batch``, 4 train steps -- ``cli.main --nhid 512``, a bf16
CARS at emsize 768, each against the same model on the plain scan, and
kernels 1, 4, 5 timed at the doc encoder's rows and steps at H = 512 and
1,024 in both dtypes and float32 H = 256 and 384), ``widegru`` (CARS-GRU
at nhid 512 in bf16 and float32, HRED-QS at nhid 1,024 in bf16,
``cli.main --rnn_type gru --nhid 512``, each against the same model on the
plain scan, and kernels 7, 8, 9 timed at the doc encoder's rows and steps
at H = 512 and 1,024 in both dtypes), ``widebeam`` (CARS ``Engine``s at
beams 40 and 127 on the float and int8 tables and with a shortlist, CARS
at emsize 1,536 in bf16 and float32, each against the logits step, and
kernels 2, 2p, 2q, 3 held and timed past top-32 and one x tile),
``widestep`` (CARS at nhid 2,048 in bf16 and 1,152 in float32 against the
plain scan, kernels 1, 4, 5 and 6 on the step route held and timed),
``widegrustep`` (CARS-GRU at nhid 1,152 with the slate kernel in bf16 and
float32 against the plain scan and pool, kernels 7, 8, 9 on the step route
and kernel 10's wide route held and timed),
``trainer`` (``cli.main`` for
CARS and HRED-QS), ``recommenders``
(seq2seq and ACG serving, train steps, checkpoint round trips and
``cli.main``, and the beam-40 CARS Engines), ``multitask`` (the top-k and
conv timings, M-NSRF and M-MatchTensor serving, train steps, checkpoint
round trips and ``cli.main``), ``rankers`` (the eight rankers' serving,
train steps, checkpoint round trips and ``cli.main``).  Every phase prints
its seconds.  Such a run prints its kernel rows as a "partial run" line and
no ok line.
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
# float32 products run on the tensor cores in split TF32 (three TF32
# products of hi / lo halves keep about 22 of float32's 24 bits): 495 / 3 =
# 165 TFLOP/s is the least time float32-accurate work can take on the card,
# not the 67 TFLOP/s of f32 FMAs
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 165e12}
HBM_BYTES_PER_S = 3.35e12

# main-path widths (the serving configuration of bench.py)
VOCAB, EMSIZE, NHID, NHID_FFNN = 50_000, 256, 128, 256
B, S, N, LQ, LD = 64, 5, 50, 15, 30
BEAM = 5
MAX_CLICKS = 4  # ModelConfig.suggest_max_clicks: clicked docs per turn
N_CORPUS = 20_000  # documents in the cached-document index
SHORTLIST = 4096   # suggestion shortlist of the shortlist Engine
TRAIN_STEPS = 8
S_REC = 10  # the recommenders' context turns: a flat source of S_REC * LQ
TIME_CHUNK = 6  # the training pair's time chunk (lstm_fused_train default)
RANKERS = ("esm", "dssm", "cdssm", "duet", "arci", "arcii", "drmm",
           "match_tensor")
# the rankers that run no kernel of the port (Match-Tensor's encoders do)
KERNEL_FREE_RANKERS = RANKERS[:-1] + ("dssm_charngram",)


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
    """LSTM operands ``[x, w_ih, b, w_hh]`` in ``dtype`` and a length mask
    with row 0 full and row 1 fully masked.  W_hh's scale falls as
    1 / sqrt(H) above 1,024 units, keeping the recurrence's gain at its
    1,024-unit level: at a fixed 0.08 the H = 2,048 recurrence amplifies a
    one-ulp difference in h about 25-fold over 30 steps in bf16 and 55-fold
    in float32, so two correct implementations that round h at different
    last bits part by more than any tolerance
    (``scripts/torch_lstm_error_growth.py``)."""
    dev = "cuda"
    x = torch.randn((rows, steps, e), generator=gen, device=dev) * 0.5
    w_ih = torch.randn((e, 4 * h), generator=gen, device=dev) * 0.08
    b = torch.randn((4 * h,), generator=gen, device=dev) * 0.1
    w_hh = (torch.randn((h, 4 * h), generator=gen, device=dev) * 0.08
            * min(1.0, math.sqrt(1024 / h)))
    lens = torch.randint(0, steps + 1, (rows,), generator=gen, device=dev)
    lens[0] = steps
    if rows > 1:
        lens[1] = 0
    mask = torch.arange(steps, device=dev)[None, :] < lens[:, None]
    return [t.to(dtype) for t in (x, w_ih, b, w_hh)], mask


def gru_inputs(gen, dtype, rows=B * S * N, steps=LD, e=EMSIZE, h=NHID):
    """GRU operands ``[x, w_ih, b_ih, w_hh, b_hh]`` in ``dtype`` and a
    length mask with row 0 full and row 1 fully masked.  W_hh's scale falls
    as 1 / sqrt(H) above 1,024 units, as ``lstm_inputs``' does: the
    recurrence amplifies a one-ulp difference in h in any implementation."""
    dev = "cuda"
    x = torch.randn((rows, steps, e), generator=gen, device=dev) * 0.5
    w_ih = torch.randn((e, 3 * h), generator=gen, device=dev) * 0.08
    b_ih = torch.randn((3 * h,), generator=gen, device=dev) * 0.1
    w_hh = (torch.randn((h, 3 * h), generator=gen, device=dev) * 0.08
            * min(1.0, math.sqrt(1024 / h)))
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
               (B * S + 13, LQ), (B, S_REC * LQ))


def forward_errors(name: str, kernel, plain, make_inputs,
                   shapes=LSTM_SHAPES) -> dict:
    """Worst abs error per dtype of a forward kernel against its plain
    version over ``shapes`` (``(rows, steps, ...)``), both directions: f32
    abs (tol 1e-4), bf16 relative to max |plain| (tol 2e-2); masked
    outputs, fully masked rows and the padded steps a reversed walk starts
    with included, must be exactly 0.  ``make_inputs(dtype, *shape) -> (x,
    mask, weights)``; the kernel is called as ``kernel(x, mask, *weights,
    reverse)``."""
    out = {}
    for dtype, tol, kind in ((torch.float32, 1e-4, "abs"),
                             (torch.bfloat16, 2e-2, "rel")):
        out[dtype] = 0.0
        for shape in shapes:
            rows, steps = shape[:2]
            x, mask, w = make_inputs(dtype, *shape)
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
                (B * S + 13, LQ), (333, 17), (B, S_REC * LQ))


def pair_inputs(gen, rnn: str, dtype, rows, steps, **widths):
    """Seeded operands of ``rnn``'s training pair: x, the mask, the
    weights in the kernels' argument order and dL/d out.  ``widths``:
    ``e`` and ``h`` other than the main path's."""
    (x, *w), mask = RNNS[rnn][0](gen, dtype, rows, steps, **widths)
    dout = (torch.randn(x.shape[:2] + w[2].shape[:1], generator=gen,
                        device="cuda") * 0.5).to(dtype)
    return x, mask, w, dout


def pair_check(rnn: str, x, mask, w, dout, reverse) -> dict:
    """The training pair of ``rnn`` against its plain versions on the same
    inputs (the backward kernel and its plain version both read the
    residual kernel's boundary state): per output, (max abs error, max abs
    error / max |plain|).  Masked outputs must be 0, the backward kernel
    must give the same bits twice (no atomics), and the residual kernel's
    output must be the forward kernel's bits (kernel 4 = kernel 1, kernel 8
    = kernel 7)."""
    mod = rnn_kernels(rnn)
    names = RNNS[rnn][1]
    res, bwd = f"{rnn}_fused_res", f"{rnn}_fused_bwd"
    fwd = getattr(mod, res)(x, mask, *w, reverse, TIME_CHUNK)
    ref = getattr(mod, res + "_reference")(x, mask, *w, reverse, TIME_CHUNK)
    out, state = fwd[0], fwd[1:]
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


def held_errors(label: str, rnn: str, x, mask, w, dout, dtype) -> dict:
    """``pair_check`` in both directions, each output within PAIR_TOL
    [dtype] (raises otherwise), logged under ``label``; returns each
    output's worst max abs error."""
    tol = PAIR_TOL[dtype]
    rows, steps, e = x.shape
    at = f"{str(dtype)[6:]} [{rows},{steps},{e}]->{w[2].shape[0]}"
    worst = dict.fromkeys(RNNS[rnn][1], 0.0)
    for reverse in (False, True):
        way = "reverse" if reverse else "forward"
        errs = pair_check(rnn, x, mask, w, dout, reverse)
        log(f"{rnn} {label} {at} TC={TIME_CHUNK} {way}: " +
            ", ".join(f"{k} {a:.2e} ({r:.2e})" for k, (a, r) in errs.items())
            + f" (abs (rel); tol rel {tol:g}; masked outputs 0; "
            f"{rnn}_fused_bwd same bits twice, {rnn}_fused_res = "
            f"{rnn}_fused bits)")
        bad = {k: r for k, (_, r) in errs.items() if not r <= tol}
        if bad:
            raise AssertionError(f"{rnn} {label} {at} {way}: {bad} > {tol}")
        for k, (a, _) in errs.items():
            worst[k] = max(worst[k], a)
    return worst


def by_kernel(rnn: str, worst: dict) -> dict:
    """``held_errors``'s worst errors per kernel of the training pair."""
    names = RNNS[rnn][1]
    n_res = names.index("dx")   # outputs of the residual kernel
    return {f"{rnn}_fused_res": max(worst[k] for k in names[:n_res]),
            f"{rnn}_fused_bwd": max(worst[k] for k in names[n_res:])}


def check_train_pair(gen, rnn: str) -> dict:
    """The training pair of ``rnn`` (kernels 4 and 5, or 8 and 9) over
    TRAIN_SHAPES, both directions, f32 and bf16; returns each kernel's
    worst max abs error per dtype."""
    worst = {f"{rnn}_fused_res": {}, f"{rnn}_fused_bwd": {}}
    for dtype in (torch.float32, torch.bfloat16):
        for kernel in worst:
            worst[kernel][dtype] = 0.0
        for rows, steps in TRAIN_SHAPES:
            errs = by_kernel(rnn, held_errors(
                "train pair", rnn,
                *pair_inputs(gen, rnn, dtype, rows, steps), dtype))
            for kernel, a in errs.items():
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

# (rows, steps, E, H) of kernels 1, 4 and 5 past the single block's tiles,
# run in float32 and bf16: E streamed in slabs (768, 1,024, 2,048), the
# bf16 cluster of 2 (H = 416, 512) and of 4 (640, 1,024), the float32
# clusters (kernels 1, 4 and 5's split-TF32 tiles from 129: 2 ranks at
# 256, 4 at 300 to 512, 8 at 640 and 1,024), rows off the 16-row block (9 rows: one block
# of a cluster, mostly empty), T = 1 and a T the time chunk does not
# divide; past 1,024 the step route (bf16 H padded to 1,280 and 2,048 in
# tiles of 256, float32 tiles of 128, the last partial at 1,100)
WIDE_SHAPES = ((70, 7, 768, NHID), (40, 5, 1024, 256), (40, 7, 300, 300),
               (33, 7, 300, 416),
               (40, 5, 1024, 512), (50, 7, EMSIZE, 640),
               (17, 3, 300, 1024), (40, 5, 2048, NHID), (9, 1, 300, 640),
               (33, 7, 300, 1152), (17, 3, 768, 2048), (9, 1, 300, 1100))


def check_tiles(gen, rnn: str, shapes=TILE_SHAPES,
                dtype=torch.bfloat16) -> dict:
    """The training pair of ``rnn`` and its forward in ``dtype`` (bf16 by
    default) over ``shapes``, both directions (``held_errors``; masked
    outputs, rows whose mask is all False included, exactly 0).  Returns
    the worst max abs error of the residual kernel and of the backward."""
    worst = {f"{rnn}_fused_res": 0.0, f"{rnn}_fused_bwd": 0.0}
    for rows, steps, e, h in shapes:
        errs = by_kernel(rnn, held_errors(
            "tiles", rnn, *pair_inputs(gen, rnn, dtype, rows, steps, e=e,
                                       h=h), dtype))
        for kernel, a in errs.items():
            worst[kernel] = max(worst[kernel], a)
    return worst


# kernels 7, 8, 9 beyond TILE_SHAPES, run in float32 and bf16: kernel 9's
# 16-row blocks at rows off their block (the query encoder's B*S + 13; the
# doc encoder's row counts take 64-row blocks, TILE_SHAPES' 16,001 rows off
# theirs), E streamed (672, 1,024, 1,500: float32's old E + H <= 1,614
# passed), bf16's one block at its widest (448) and its clusters of 2 (480,
# 512) and 4 (544 padded to 576, 640, 1,024), float32's clusters (kernels
# 7, 8, 9's split-TF32 tiles from 129: 4 ranks at 404 and 512, 8 at 544 to
# 1,024), rows off the
# 16-row block (9 rows: one block of a cluster, mostly empty), T = 1 and a
# T the time chunk does not divide; past 1,024 the step route (bf16 H
# padded to 1,280 and 2,048 in tiles of 256, float32 tiles of 128, the last
# partial at 1,100)
GRU_TILE_SHAPES = ((B * S + 13, LQ, EMSIZE, NHID), (70, 7, 672, NHID),
                   (40, 5, EMSIZE, 448), (70, 7, 1024, NHID),
                   (70, 7, 1500, NHID), (33, 7, 300, 404),
                   (40, 5, EMSIZE, 480), (40, 5, 1024, 512),
                   (50, 7, EMSIZE, 544), (17, 3, 300, 1024),
                   (9, 1, 300, 640), (33, 7, 300, 1152),
                   (17, 3, 768, 2048), (9, 1, 300, 1100))


def tile_note() -> str:
    """The mma flavour and shared-memory bytes of the redesigned kernels at
    the main path's widths."""
    from context_attentive_ir_tpu_torch.ops.kernels.beamgen import (
        beamgen_smem_bytes,
    )
    from context_attentive_ir_tpu_torch.ops.kernels.lstm import (
        rec_smem_bytes,
        step_smem_bytes,
        tile_smem_bytes,
    )
    from context_attentive_ir_tpu_torch.ops.kernels.slate import (
        pool_smem_bytes,
    )

    return (f"tiles at E={EMSIZE} H={NHID} bf16: lstm_fused / lstm_fused_res "
            "mma.sync.m16n8k16 (bf16 in, f32 accumulate) + ldmatrix + a "
            "cp.async.bulk / mbarrier weight ring with x streamed beside "
            f"it, {tile_smem_bytes(EMSIZE, NHID)} bytes of "
            "dynamic shared memory a block of 64 rows; lstm_fused_bwd phase "
            f"A the same, {tile_smem_bytes(EMSIZE, NHID, backward=True)} "
            "bytes; at H = 512 / 1,024 a cluster of 2 / 4 blocks of 16 rows, "
            f"{tile_smem_bytes(EMSIZE, 512)} / {tile_smem_bytes(EMSIZE, 1024)}"
            " bytes a block (backward "
            f"{tile_smem_bytes(EMSIZE, 512, backward=True)} / "
            f"{tile_smem_bytes(EMSIZE, 1024, backward=True)}); gru_fused / gru_fused_res the same tiles with three "
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
            f"{pool_smem_bytes(128)} at H = 128; lstm_recurrence bf16 "
            "mma.sync.m16n8k16 + ldmatrix with W_hh resident (one "
            "cp.async.bulk a block) and the x_proj rows by cp.async.bulk "
            f"into one tile, {rec_smem_bytes(NHID)} bytes a block of 64 "
            f"rows, {-(-B * S * N // 64)} blocks at the doc encoder's rows; "
            "the step route (kernels 1, 4, 5 past H = 1,024, 6 past 512; a "
            "launch a step) bf16 blocks of 16 rows x 256 units, "
            f"{step_smem_bytes()} bytes (the dh product "
            f"{step_smem_bytes(backward=True)}), float32 32 rows x 128 units,"
            f" {step_smem_bytes(torch.float32)} "
            f"({step_smem_bytes(torch.float32, backward=True)}), at any E "
            "and H; kernels 7, 8, 9 past H = 1,024 the same with three gate "
            f"blocks, {step_smem_bytes(gates=3)} bytes "
            f"({step_smem_bytes(backward=True, gates=3)}), float32 "
            f"{step_smem_bytes(torch.float32, gates=3)} "
            f"({step_smem_bytes(torch.float32, True, 3)}); attn_pool "
            "elsewhere (the wide route) 128 x 128 score tiles from a "
            "three-slab cp.async ring, 57856 bytes a block (float32 108544,"
            " split TF32), "
            "then a block a document")


GRU_KERNELS = ("gru_fused", "gru_fused_res", "gru_fused_bwd")


def recurrence_inputs(gen, dtype, rows=B * S * N, steps=LD, h=NHID,
                      interior=False):
    """Kernel 6's operands from ``lstm_inputs``: ``x_proj = x @ W_ih + b``
    by ``torch.matmul`` (in ``dtype``), the mask (``interior``: random
    gaps, row 0 fully valid and row 1 fully masked), ``w_hh``."""
    (x, w_ih, b, w_hh), mask = lstm_inputs(gen, dtype, rows, steps, h=h)
    if interior:
        mask = torch.rand((rows, steps), generator=gen, device="cuda") < 0.6
        mask[0] = True
        if rows > 1:
            mask[1] = False
    return (torch.matmul(x, w_ih) + b).contiguous(), mask, w_hh


# (rows, steps, H, interior gaps) of kernel 6 beyond LSTM_SHAPES: rows one
# short of and one past the tensor-core route's 64-row block, T = 1, masks
# with interior gaps at the doc encoder's rows off the block, H = 256, 384
# and 512 (the CUDA-core route in both dtypes), and 640, 1,024 and 2,048
# (the step route: bf16 640 padded to 768) at rows off its blocks
REC_SHAPES = ((63, LD, NHID, False), (65, LD, NHID, True),
              (300, 1, NHID, True), (B * S * N + 7, LD, NHID, True),
              (300, LD, 256, True), (300, LD, 384, True),
              (300, LD, 512, False), (65, 7, 640, True),
              (63, 5, 1024, False), (40, 3, 2048, True))


def check_recurrence(gen) -> dict:
    """Kernel 6 against its plain version through ``forward_errors`` at
    LSTM_SHAPES and REC_SHAPES, the same bf16 bits on two calls, then
    ``lstm_recurrence``'s gradients (its autograd Function) against
    autograd of the plain version."""
    from context_attentive_ir_tpu_torch.ops.kernels.lstm import (
        lstm_recurrence,
        lstm_recurrence_fwd,
        lstm_recurrence_reference,
    )

    def make_inputs(dtype, rows, steps, h=NHID, interior=False):
        xp, mask, w_hh = recurrence_inputs(gen, dtype, rows, steps, h,
                                           interior)
        return xp, mask, [w_hh]

    out = forward_errors("lstm_recurrence", lstm_recurrence_fwd,
                         lstm_recurrence_reference, make_inputs)
    edges = forward_errors("lstm_recurrence", lstm_recurrence_fwd,
                           lstm_recurrence_reference, make_inputs,
                           REC_SHAPES)
    out = {dtype: max(err, edges[dtype]) for dtype, err in out.items()}

    xp, mask, w_hh = recurrence_inputs(gen, torch.bfloat16)
    for reverse in (False, True):
        once, twice = (lstm_recurrence_fwd(xp, mask, w_hh, reverse)
                       for _ in range(2))
        if not same_bits(once, twice):
            raise AssertionError("lstm_recurrence bf16 gives other bits on "
                                 "a second call")
    log(f"lstm_recurrence bf16 {list(xp.shape)}: the same bits on two "
        "calls, both directions")

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


def beamgen_inputs(gen, rows, dtype, integer, e=EMSIZE):
    dev = "cuda"
    if integer:
        x = torch.randint(-3, 4, (rows, e), generator=gen, device=dev)
        t = torch.randint(-3, 4, (e, VOCAB), generator=gen, device=dev)
    else:
        x = torch.randn((rows, e), generator=gen, device=dev) * 0.5
        t = torch.randn((e, VOCAB), generator=gen, device=dev) * 0.5
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
    # the plain version row chunk by row chunk (each row is its own): a
    # beam-127 step's [40640, 50000] logits sorted at once need ~40 GB
    chunk = max(1, (1 << 29) // tt.shape[1])
    parts = [generator_topk_lse_reference(x[r:r + chunk], tt, kc + 1, scale)
             for r in range(0, rows, chunk)]
    rv, ri, rlse = (torch.cat(p) for p in zip(*parts))
    del parts
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
    got = torch.empty_like(v)
    for r in range(0, rows, chunk):
        logits = x[r:r + chunk].float() @ tt.float()
        if scale is not None:
            logits = logits * scale[None, :]
        got[r:r + chunk] = logits.gather(1, i[r:r + chunk].long())
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
# suggest init's clicked docs B*S*C -- plus a row count off its tiles, at
# the documents' Ld and every width to 1,024 (H % 128 == 0: the resident
# kernel in bf16 at 128 and 256, the wide route otherwise), each checked in
# both dtypes
H2 = 2 * NHID
SLATE_ROWS = (B * S * N, B * S * N + 7, B * S * MAX_CLICKS)
TILED_POOLS = tuple(range(128, 1025, 128))
SLATE_SHAPES = tuple((r, LD, h) for h in TILED_POOLS for r in SLATE_ROWS)
# the tiles' edges at 333 rows: T = 1 (four documents of 16 rows a
# resident tile), 7, 15, 17 (two of 32), 32, 33 (one of 48), 64 (one of
# 64, the limit), 65 (beyond it: the wide route), on the resident kernel's
# widths, and the same T on the wide route at 384 and 1,024 (tokens off
# its 128-token score tile)
SLATE_SHAPES += tuple((333, t, h) for h in (128, 256, 384, 1024)
                      for t in (1, 7, 15, 17, 32, 33, 64, 65))
# the wide route (H above 1,024: a doc pool of 2 * nhid for nhid 576 and
# up): rows off its 128-token score tile, T = 1 and one past the tiles'
# 64, the CARS-GRU doc pool at nhid 1,152 (2,304) at suggest init's rows;
# H = 1,024 forced onto it (`wide`, the launcher's own route there)
WIDE_ROUTE_SHAPES = ((333, LD, 1152, False), (41, 1, 1152, False),
                     (40, 65, 1280, False),
                     (B * S * MAX_CLICKS + 7, LD, 2304, False),
                     (50, 7, 4096, False), (B * S * MAX_CLICKS, LD, 1024, True))


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
        pool_route,
    )

    out = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        out[dtype] = 0.0
        for rows, steps, h, wide in (*((*shape, False)
                                       for shape in SLATE_SHAPES),
                                     *WIDE_ROUTE_SHAPES):
            (s, q, w, b), mask = slate_inputs(gen, dtype, rows, steps, h)
            got = attn_pool(s, mask, q, w, b, wide=wide).float()
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
            log(f"attn_pool {dtype} [{rows},{steps},{h}] "
                f"({pool_route(h, steps, dtype, wide)}): max abs err "
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
    for h in (*TILED_POOLS, 1152, 2304):
        for dtype in (torch.float32, torch.bfloat16):
            (s, q, w, b), mask = slate_inputs(gen, dtype, 7, LD, h)
            try:
                attn_pool(s, mask, q, w, b)
            except ValueError as err:
                refused = str(err)
            else:
                raise AssertionError(f"attn_pool {dtype} R=7 H={h} was not "
                                     "refused")
    log(f"attn_pool R=7 refused at H = 128 .. 2304 in both dtypes "
        f"({refused})")
    check_pool_gate(gen)

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


def check_pool_gate(gen) -> None:
    """``pool_supported`` says what the launcher runs: at every multiple of
    64 up to 4,096, in both dtypes, ``cair_slate_pool`` called directly
    (past the wrapper's check of the gate, with the workspace
    ``cair_slate_pool_workspace`` asks for) succeeds exactly where the gate
    holds the width -- every multiple of 128 -- and refuses the rest
    itself.  ``pool_route`` is ``cair_slate_route`` at each of those widths,
    both dtypes, T = 1, 32, 33, 64, 65 and with and without ``wide``, and
    the workspace is asked for exactly on the wide route."""
    from context_attentive_ir_tpu_torch.ops.kernels.build import load_library
    from context_attentive_ir_tpu_torch.ops.kernels.slate import (
        pool_route,
        pool_supported,
    )

    lib = load_library()
    seen, moved = [], []
    names = {-1: None, 0: "resident", 1: "wide"}
    for h in range(64, 4097, 64):
        for code, dtype in enumerate((torch.float32, torch.bfloat16)):
            (s, q, w, b), mask = slate_inputs(gen, dtype, 40, 3, h)
            out = torch.empty((40, h), dtype=dtype, device="cuda")
            n_bytes = lib.cair_slate_pool_workspace(40, 3, h, code, 0)
            ws = torch.empty((max(n_bytes, 16),), dtype=torch.uint8,
                             device="cuda")
            rc = lib.cair_slate_pool(
                s.data_ptr(), mask.data_ptr(), q.data_ptr(), w.data_ptr(),
                b.data_ptr(), out.data_ptr(), ws.data_ptr(), 40, 3, h, code,
                0, torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            ok = pool_supported(h, 40)
            if (rc == 0) != ok or (n_bytes >= 0) != ok:
                raise AssertionError(f"pool_supported({h}, 40) = {ok} but "
                                     f"cair_slate_pool returned {rc} "
                                     f"(workspace {n_bytes})")
            seen.append(f"{h}:{'ran' if rc == 0 else f'refused ({rc})'}")
            for t in (1, 32, 33, 64, 65):
                for wide in (0, 1):
                    route = pool_route(h, t, dtype, bool(wide))
                    ws_bytes = lib.cair_slate_pool_workspace(40, t, h, code,
                                                             wide)
                    if (names[lib.cair_slate_route(40, t, h, code, wide)]
                            != route or (ws_bytes > 0) != (route == "wide")):
                        moved.append((h, str(dtype)[6:], t, wide))
    log("pool_supported held to cair_slate_pool, f32 / bf16 per width: "
        + ", ".join(seen))
    log(f"pool_route equal to cair_slate_route (and the workspace asked for "
        f"exactly on the wide route) at every multiple of 64 to 4,096, both "
        f"dtypes, T = 1 / 32 / 33 / 64 / 65, wide off and on: {not moved}")
    if moved:
        raise AssertionError(f"pool_route differs from cair_slate_route at "
                             f"(H, dtype, T, wide) {moved[:10]}")


def int8_inputs(gen, rows, dtype, integer, e=EMSIZE):
    """x [rows, e] and the int8 table of a random [V, e] embedding through
    quantize_embedding_table, transposed: (x, q_t [e, V], scale [V])."""
    from context_attentive_ir_tpu_torch.ops.layers import (
        quantize_embedding_table,
    )

    table = torch.randn((VOCAB, e), generator=gen, device="cuda") * 0.1
    q, scale = quantize_embedding_table(table.cpu().numpy())
    q_t = torch.from_numpy(q).cuda().t().contiguous()
    if integer:
        x = torch.randint(-3, 4, (rows, e), generator=gen, device="cuda")
    else:
        x = torch.randn((rows, e), generator=gen, device="cuda") * 0.5
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


def check_beamgen_modes(gen) -> dict:
    """Kernel 2's int8 mode against its plain version (the f32
    reference, not a bf16-rounded logits path), at the beam-5 and greedy
    shapes: integer-valued x exact, random x 0 index mismatches away from
    near ties.  ``prune`` on and off, and kernel 3 against kernel 2, must
    give the same bits.  Returns the int8 mode's max abs error on random
    data at the beam-5 shape by the dtype of x."""
    from context_attentive_ir_tpu_torch.ops.kernels.beamgen import (
        generator_topk_lse,
    )

    worst = {}
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
                if rows == B * S * BEAM and not integer:
                    worst[dtype] = v_err
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


# E of the limit checks: not multiples of 16 (100, 300: the zero-filled
# last k-slab), each kernel's last whole x tile and the E past it, and one
# far past every whole tile
LIMIT_ES = (100, 300, 3000)
WHOLE_TILE_TOPS = {(torch.bfloat16, False): 1264, (torch.bfloat16, True): 976,
                   (torch.float32, False): 496, (torch.float32, True): 352}
# (name, keyword arguments) of each generator mode; int8 takes a table of
# its own
GEN_MODES = (("serial", {}), ("pruned", {"prune": True}),
             ("int8", {"scale": True}), ("pipelined", {"pipeline": True}))


def beamgen_integer_case(gen, rows, e, v, dtype, int8):
    """Integer-valued x [rows, e] and table [e, v] (int8 with power-of-two
    scales for the int8 mode): every product and sum exact."""
    x = torch.randint(-3, 4, (rows, e), generator=gen, device="cuda")
    t = torch.randint(-3, 4, (e, v), generator=gen, device="cuda")
    if not int8:
        return x.to(dtype), t.to(dtype), None
    scale = 2.0 ** torch.randint(-3, 3, (v,), generator=gen,
                                 device="cuda").float()
    return x.to(dtype), t.to(torch.int8), scale


def check_beamgen_limits(gen) -> None:
    """The gates against the launchers.  ``beamgen_smem_bytes`` and
    ``beamgen_streams_x`` equal ``cair_beamgen_smem`` (the launcher's plan)
    at every (E, kc, mode) of a grid; every E runs in each dtype and
    kernel -- 100, 300, each kernel's last whole x tile and the E past it
    (x streamed), 3,000 -- exact on integer data; kc = 128 runs in every
    mode (E = 300 and 3,000); kc = 129 is refused by the wrapper and by the
    launcher called directly, and the next launch runs clean."""
    from context_attentive_ir_tpu_torch.ops.kernels.beamgen import (
        MAX_KC,
        beamgen_smem_bytes,
        beamgen_streams_x,
        beamgen_supported,
        generator_topk_lse,
    )
    from context_attentive_ir_tpu_torch.ops.kernels.build import load_library

    lib = load_library()
    checked = 0
    for (dtype, pipeline), top in WHOLE_TILE_TOPS.items():
        for mode, kw in GEN_MODES:
            if (mode == "pipelined") != pipeline:
                continue
            x_code = 0 if dtype == torch.float32 else 1
            t_code = 2 if mode == "int8" else x_code
            for e in (1, 15, 100, 256, 300, top, top + 1, 1536, 2048, 3000,
                      8192):
                for kc in (1, 32, 33, 64, 65, 128):
                    n, streamed = ctypes.c_longlong(), ctypes.c_int()
                    rc = lib.cair_beamgen_smem(
                        e, kc, x_code, t_code, int(mode == "pruned"),
                        int(pipeline), ctypes.byref(n), ctypes.byref(streamed))
                    want = (beamgen_smem_bytes(e, dtype, pipeline, kc),
                            beamgen_streams_x(e, dtype, pipeline))
                    if (rc != 0 or (n.value, bool(streamed.value)) != want
                            or not beamgen_supported(e, dtype, pipeline)):
                        raise AssertionError(
                            f"beamgen_smem_bytes / beamgen_streams_x {want} "
                            f"disagree with the launcher's ({rc}, {n.value}, "
                            f"{streamed.value}) at E={e} kc={kc} {dtype} "
                            f"{mode}")
                    checked += 1
    log(f"beamgen_smem_bytes and beamgen_streams_x equal the launcher's "
        f"plan at {checked} (E, kc, mode) points; every E is supported")

    for (dtype, pipeline), top in WHOLE_TILE_TOPS.items():
        for e in (LIMIT_ES[0], LIMIT_ES[1], top, top + 1, LIMIT_ES[2]):
            x, t, _ = beamgen_integer_case(gen, 70, e, 304, dtype, False)
            what = (f"generator_topk_lse{' pipeline' if pipeline else ''} "
                    f"E={e} {dtype} ({beamgen_smem_bytes(e, dtype, pipeline)}"
                    " bytes of shared memory, x "
                    f"{'streamed' if beamgen_streams_x(e, dtype, pipeline) else 'whole'})")
            hold(what, generator_topk_lse(x, t, 2, pipeline=pipeline), x, t,
                 2, True)
    for dtype in (torch.float32, torch.bfloat16):
        for e in (300, 3000):
            for mode, kw in GEN_MODES:
                x, t, scale = beamgen_integer_case(gen, 70, e, 304, dtype,
                                                   mode == "int8")
                kw = dict(kw, scale=scale) if mode == "int8" else kw
                hold(f"generator_topk_lse {mode} kc={MAX_KC} E={e} {dtype}",
                     generator_topk_lse(x, t, MAX_KC, **kw), x, t, MAX_KC,
                     True, scale)
    x, t, _ = beamgen_integer_case(gen, 70, EMSIZE, 304, torch.bfloat16,
                                   False)
    try:
        generator_topk_lse(x, t, MAX_KC + 1)
    except ValueError as err:
        log(f"generator_topk_lse kc={MAX_KC + 1} refused: {err}")
    else:
        raise AssertionError(f"generator_topk_lse ran at kc={MAX_KC + 1}")
    n_split, per = 1, -(-304 // 128)
    out = [torch.empty((n_split, 70, MAX_KC + 1), device="cuda")
           for _ in range(2)] + [torch.empty((n_split, 70), device="cuda")
                                 for _ in range(2)]
    res = [torch.empty((70, MAX_KC + 1), device="cuda") for _ in range(2)]
    lse = torch.empty((70,), device="cuda")
    rc = lib.cair_beamgen(
        x.data_ptr(), t.data_ptr(), None, 70, EMSIZE, EMSIZE, 304, 304,
        MAX_KC + 1, n_split, per, *(a.data_ptr() for a in out),
        *(a.data_ptr() for a in res), lse.data_ptr(), 1, 1, 0, 0,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    log(f"cair_beamgen kc={MAX_KC + 1} called directly: returned {rc}")
    if rc == 0:
        raise AssertionError(f"cair_beamgen ran at kc={MAX_KC + 1}")
    hold("generator_topk_lse after the refusals",
         generator_topk_lse(x, t, 2, pipeline=True), x, t, 2, True)
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

    def rec_at(h, strided=False, dtype=torch.float32):
        xp, mask, w_hh = recurrence_inputs(gen, dtype, 40, 3, h=h)
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
    # through all three kernels, one it rejects is refused by the backward;
    # every E and H in both dtypes (bf16: one block to 384, clusters of 2
    # and 4 to 1,024; float32: kernels 1, 4, 5's split-TF32 tiles one
    # block to 128, clusters of 2, 4, 8 to 1,024; the
    # step route above), the step route's shapes each held to the plain
    # version, both directions
    bf16 = torch.bfloat16
    for e, h, dtype in ((448, NHID, bf16), (512, NHID, bf16),
                        (512, 256, bf16), (EMSIZE, 512, bf16),
                        (64, 512, bf16), (300, 100, bf16),
                        (4096, NHID, bf16), (EMSIZE, 1024, bf16),
                        (EMSIZE, 1056, bf16), (EMSIZE, 1152, bf16),
                        (300, 2048, bf16), (EMSIZE, 4096, bf16),
                        (1400, NHID, torch.float32),
                        (1500, NHID, torch.float32),
                        (4096, NHID, torch.float32),
                        (EMSIZE, 256, torch.float32),
                        (EMSIZE, 403, torch.float32),
                        (EMSIZE, 404, torch.float32),
                        (EMSIZE, 512, torch.float32),
                        (EMSIZE, 1024, torch.float32),
                        (EMSIZE, 1025, torch.float32),
                        (EMSIZE, 1152, torch.float32),
                        (300, 2048, torch.float32),
                        (EMSIZE, 4096, torch.float32)):
        ok = fused_supported(e, h, 40, dtype)
        try:
            lstm_at(e, h, dtype) if ok else None
            res_at(e, h, dtype) if ok else None
            bwd_at(e, h, dtype)
            torch.cuda.synchronize()
            ran = True
        except (RuntimeError, ValueError) as err:
            ran, why = False, err
        log(f"fused_supported(E={e}, H={h}, {dtype}) = {ok}; the kernels "
            + ("ran" if ran else f"refused: {why}"))
        if ran != ok:
            raise AssertionError(f"fused_supported(E={e}, H={h}, {dtype}) "
                                 f"= {ok} but the kernels "
                                 f"{'ran' if ran else 'refused'}")
        if ran and h > 1024:
            held_errors("step route", "lstm",
                        *pair_inputs(gen, "lstm", dtype, 40, 3, e=e, h=h),
                        dtype)

    # the route rule the launchers apply (cair_lstm_route, lstm_route in
    # csrc/lstm_mma.cuh) is the one ops/kernels/lstm.py states, at every
    # multiple of 32 to 4,096 (and the odd 1,025), each dtype and kernel
    from context_attentive_ir_tpu_torch.ops.kernels.build import load_library
    from context_attentive_ir_tpu_torch.ops.kernels.lstm import lstm_route

    lib = load_library()
    names = ("single", "cluster", "step")
    moved = [(h, code, kernel) for h in (*range(32, 4097, 32), 1025)
             for code, dtype in enumerate((torch.float32, bf16))
             for kernel in range(3)
             if names[lib.cair_lstm_route(h, code, kernel)]
             != lstm_route(h, dtype, recurrence=kernel == 2)]
    log(f"lstm_route equal to cair_lstm_route at every H of 32 .. 4,096 "
        f"(multiples of 32) and 1,025, both dtypes, kernels 1/4, 5, 6: "
        f"{not moved}")
    if moved:
        raise AssertionError(f"lstm_route differs from the launchers' at "
                             f"(H, dtype, kernel) {moved}")

    def rec_held(h, dtype):
        # kernel 6 past 512 (the step route) against its plain version
        from context_attentive_ir_tpu_torch.ops.kernels.lstm import (
            lstm_recurrence_reference,
        )

        xp, mask, w_hh = recurrence_inputs(gen, dtype, 40, 3, h=h)
        for reverse in (False, True):
            got = lstm_recurrence(xp, mask, w_hh, reverse).float()
            ref = lstm_recurrence_reference(xp, mask, w_hh, reverse).float()
            err = float((got - ref).abs().max())
            rel = err / float(ref.abs().max())
            held = err if dtype == torch.float32 else rel
            tol = 1e-4 if dtype == torch.float32 else 2e-2
            log(f"lstm_recurrence {dtype} H={h} [40,3] reverse={reverse}: "
                f"max abs err {err:.3e}, rel {rel:.3e} (tol {tol:g}); masked "
                f"outputs 0: {bool((got[~mask] == 0).all())}")
            if not (held <= tol and bool((got[~mask] == 0).all())):
                raise AssertionError(f"lstm_recurrence H={h} {dtype}")

    for h in (640, 1024, 2048):
        for dtype in (torch.float32, bf16):
            rec_held(h, dtype)

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
    # one; every E and H in both dtypes (bf16: one block to 448, clusters of
    # 2 and 4 to 1,024, H padded to 64 in a cluster of 4; float32: kernels
    # 7, 8, 9 one block to 128, clusters of 2, 4, 8 to 1,024; the
    # step route above, bf16 H padded to a multiple of 256), the step
    # route's shapes each held to the plain version, both directions
    for e, h, dtype in ((672, NHID, bf16), (704, NHID, bf16),
                        (1024, NHID, bf16), (4096, NHID, bf16),
                        (EMSIZE, 448, bf16), (EMSIZE, 449, bf16),
                        (EMSIZE, 480, bf16), (64, 512, bf16),
                        (EMSIZE, 513, bf16), (EMSIZE, 1000, bf16),
                        (300, 1024, bf16), (EMSIZE, 1025, bf16),
                        (EMSIZE, 1056, bf16), (EMSIZE, 1152, bf16),
                        (300, 2048, bf16), (EMSIZE, 4096, bf16),
                        (300, 100, bf16), (1400, NHID, torch.float32),
                        (1500, NHID, torch.float32),
                        (4096, NHID, torch.float32),
                        (EMSIZE, 256, torch.float32),
                        (EMSIZE, 403, torch.float32),
                        (EMSIZE, 404, torch.float32),
                        (EMSIZE, 512, torch.float32),
                        (EMSIZE, 1024, torch.float32),
                        (EMSIZE, 1025, torch.float32),
                        (EMSIZE, 1056, torch.float32),
                        (EMSIZE, 1152, torch.float32),
                        (300, 2048, torch.float32),
                        (EMSIZE, 4096, torch.float32)):
        ok = gru_fused_supported(e, h, 40, dtype)
        refused = []
        for k in GRU_KERNELS:
            try:
                gru_at(k, e, h, dtype)
                torch.cuda.synchronize()
            except (RuntimeError, ValueError) as err:
                refused.append(f"{k}: {err}")
        log(f"gru_fused_supported(E={e}, H={h}, {dtype}) = {ok}; the "
            "kernels " + ("refused: " + "; ".join(refused) if refused
                          else "ran"))
        if ok == bool(refused):
            raise AssertionError(f"gru_fused_supported(E={e}, H={h}, "
                                 f"{dtype}) = {ok} but the kernels "
                                 f"{'refused' if refused else 'ran'}")
        if ok and h > 1024:
            held_errors("step route", "gru",
                        *pair_inputs(gen, "gru", dtype, 40, 3, e=e, h=h),
                        dtype)

    # the GRU's route rule (cair_gru_route, gru_route in csrc/lstm_mma.cuh)
    # is the one ops/kernels/gru.py states, at every multiple of 32 to
    # 4,096 (and the odd 1,025), each dtype (kernels 7, 8, 9 alike)
    from context_attentive_ir_tpu_torch.ops.kernels.gru import gru_route

    moved = [(h, code) for h in (*range(32, 4097, 32), 1025)
             for code, dtype in enumerate((torch.float32, bf16))
             if names[lib.cair_gru_route(h, code)] != gru_route(h, dtype)]
    log(f"gru_route equal to cair_gru_route at every H of 32 .. 4,096 "
        f"(multiples of 32) and 1,025, both dtypes, kernels 7, 8, 9: "
        f"{not moved}")
    if moved:
        raise AssertionError(f"gru_route differs from the launchers' at "
                             f"(H, dtype) {moved}")

    def beamgen_at(e, v=300, kc=2, **kw):
        x = torch.randn((70, e), generator=gen, device="cuda")
        t = torch.randn((e, v), generator=gen, device="cuda")
        return generator_topk_lse(x, t, kc, **kw)

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

    for name, fn in (("RNNLayer gru float16 (dtype)",
                      lambda: layer_at("gru", EMSIZE, 1152, torch.float16)),
                     ("lstm_recurrence H=192 (H % 128)", lambda: rec_at(192)),
                     ("lstm_recurrence bf16 H=192 (H % 128)",
                      lambda: rec_at(192, dtype=bf16)),
                     ("lstm_recurrence strided x_proj (contiguity)",
                      lambda: rec_at(NHID, strided=True)),
                     ("generator_topk_lse kc=129 (top-kc above 128)",
                      lambda: beamgen_at(EMSIZE, kc=129)),
                     ("attn_pool H=192 (H % 128)", lambda: pool_at(192)),
                     ("attn_pool H=2240 (H % 128)", lambda: pool_at(2240)),
                     ("attn_pool R=7 (rows)", lambda: pool_at(H2, 7)),
                     ("attn_pool R=7 H=2304 (rows)",
                      lambda: pool_at(2304, 7))):
        try:
            fn()
        except (RuntimeError, ValueError) as err:
            log(f"{name} refused: {type(err).__name__}: {err}")
        else:
            raise AssertionError(f"{name} was not refused")
    # kernel 6's one-block launcher refuses H = 640 itself (the wrapper
    # sends it to the step route's cair_lstm_step), and cair_lstm_step
    # refuses what is not the step route's: kernel 1 at H = 1,024 (a
    # cluster's) and kernel 6 at 512 (one block's), each called directly
    for code, dtype in enumerate((torch.float32, bf16)):
        for e, h, rec in ((EMSIZE, 1024, 0), (0, 512, 1)):
            xs = torch.zeros((40, 3, 4 * h if rec else e), dtype=dtype,
                             device="cuda")
            mask = torch.ones((40, 3), dtype=torch.bool, device="cuda")
            w = torch.zeros((e + h, 4 * h + 8), dtype=dtype, device="cuda")
            out = torch.empty((40, 3, h), dtype=dtype, device="cuda")
            ws = torch.empty((1 << 24,), dtype=torch.uint8, device="cuda")
            rc = load_library().cair_lstm_step(
                xs.data_ptr(), mask.data_ptr(), w.data_ptr(), w.data_ptr(),
                w.data_ptr(), out.data_ptr(), 0, 0, ws.data_ptr(), 40, 3, e,
                h, 0, 1, 0, rec, code,
                torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            log(f"cair_lstm_step {dtype} H={h} rec={rec} called directly "
                f"(not the step route's): returned {rc}")
            if rc == 0:
                raise AssertionError(f"cair_lstm_step {dtype} H={h} rec={rec} "
                                     "was not refused by the launcher")
    # cair_gru_step refuses a cluster's shape (H = 1,024), called directly
    for code, dtype in enumerate((torch.float32, bf16)):
        xs = torch.zeros((40, 3, EMSIZE), dtype=dtype, device="cuda")
        mask = torch.ones((40, 3), dtype=torch.bool, device="cuda")
        w = torch.zeros((EMSIZE + 1024, 3 * 1024 + 8), dtype=dtype,
                        device="cuda")
        out = torch.empty((40, 3, 1024), dtype=dtype, device="cuda")
        ws = torch.empty((1 << 24,), dtype=torch.uint8, device="cuda")
        rc = load_library().cair_gru_step(
            xs.data_ptr(), mask.data_ptr(), w.data_ptr(), w.data_ptr(),
            w.data_ptr(), w.data_ptr(), out.data_ptr(), 0, ws.data_ptr(), 40,
            3, EMSIZE, 1024, 0, 3, 0, code,
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        log(f"cair_gru_step {dtype} H=1024 called directly (not the step "
            f"route's): returned {rc}")
        if rc == 0:
            raise AssertionError(f"cair_gru_step {dtype} H=1024 was not "
                                 "refused by the launcher")
    for code, dtype in enumerate((torch.float32, bf16)):
        xp, mask, w_hh = recurrence_inputs(gen, dtype, 40, 3, h=640)
        out = torch.empty((40, 3, 640), dtype=dtype, device="cuda")
        rc = load_library().cair_lstm_rec(
            xp.data_ptr(), mask.data_ptr(), w_hh.data_ptr(), out.data_ptr(),
            40, 3, 640, 0, code, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        log(f"cair_lstm_rec {dtype} H=640 called directly: returned {rc}")
        if rc == 0:
            raise AssertionError(f"cair_lstm_rec {dtype} H=640 was not "
                                 "refused by the launcher")
    for dtype in (torch.float32, bf16):
        lstm_at(EMSIZE, NHID, dtype)
        res_at(EMSIZE, NHID, dtype)
        bwd_at(EMSIZE, NHID, dtype)
    rec_at(NHID)
    rec_at(NHID, dtype=bf16)
    layer_at("lstm", 300, 100, bf16)
    layer_at("lstm", EMSIZE, 1152, bf16)
    layer_at("lstm", EMSIZE, 1152, torch.float32)
    layer_at("gru", 300, 100, bf16)
    layer_at("gru", 4096, NHID, torch.float32)
    layer_at("gru", EMSIZE, 480, bf16)
    layer_at("gru", EMSIZE, 1152, bf16)
    layer_at("gru", EMSIZE, 1025, torch.float32)
    for k in GRU_KERNELS:
        for dtype in (torch.float32, bf16):
            gru_at(k, EMSIZE, NHID, dtype)
    beamgen_at(EMSIZE)
    beamgen_at(EMSIZE, 304, pipeline=True)
    pool_at(H2)
    pool_at(1152)
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
    words = np.asarray(word_dict.tokens())

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


# The generator kernel each fused decode path must launch, fixed here and
# not read from the dispatch table, so that a rewritten table cannot move
# a launch-count check with it: the unpruned serial kernel on the beam
# paths and for greedy (the table's beam_gen_prune rows: at 1,600
# rows, kc 6, pruning 0.6018 ms against 0.5785; at 320 rows, kc 2, 0.1694
# against 0.1674 -- both modes insert only what beats the kc-th entry, so
# pruning no longer wins by NEAR_TIE_MARGIN, and the JAX default, off,
# holds; kernel 3 0.6263 / 0.1832, off too).  table_choices() holds the
# committed table to these choices.
BEAM_GEN = "generator_topk_lse"
GREEDY_GEN = "generator_topk_lse"
# beams 40 and 127 (kc 41 and 128): the table has no row at their kc, so
# the pruned serial kernel (dispatch.PRUNE_ABOVE_KC: an unmeasured kc
# above 32 prunes)
WIDEBEAMS = (40, 127)
WIDEBEAM_GEN = "generator_topk_lse_pruned"


def table_choices() -> None:
    """The committed dispatch table makes the choices PATH_KERNELS expects
    at every row count the paths give the decode step (buckets of 1-64
    requests, whole or in two shards), and no row of it sends an RNN or a
    decode step to its plain version."""
    from context_attentive_ir_tpu_torch.ops import dispatch

    dispatch.reload_table()
    table = dispatch._load_table()
    m = dispatch.NEAR_TIE_MARGIN
    plain = [e for e in table
             if (e["kind"] in ("lstm", "gru")
                 and e["scan_ms"] < (1 - m) * e["kernel_ms"])
             or (e["kind"] == "beam_gen"
                 and e["xla_ms"] < (1 - m) * e["fused_ms"])]
    kernel = {BEAM + 1: BEAM_GEN, 2: GREEDY_GEN,
              **{b + 1: WIDEBEAM_GEN for b in WIDEBEAMS}}
    got = {}
    for kc, want in kernel.items():
        for rows in sorted({r * S * (kc - 1 if kc > 2 else 1)
                            for r in (1, 2, 4, 8, B // 2, B)}):
            pick = ("generator_topk_lse_pipelined"
                    if dispatch.prefer_pipelined_generator(rows, kc)
                    else "generator_topk_lse_pruned"
                    if dispatch.prefer_pruned_generator(rows, kc)
                    else "generator_topk_lse")
            if pick != want or not dispatch.prefer_fused_generator(
                    rows, VOCAB, EMSIZE, kc, t=LQ):
                got[f"{rows}x{kc}"] = pick
    log(f"dispatch table: {len(table)} rows, none preferring a plain "
        f"version: {not plain}; the generator choices PATH_KERNELS expects "
        f"({json.dumps({str(k): v for k, v in kernel.items()})}) hold at "
        f"every row count: {not got}")
    if plain or got:
        raise AssertionError(f"the committed dispatch table moved a main "
                             f"path's kernel: {plain} {got}")


# CARS's encoders on the step route: bf16 at --nhid 2,048 (bf16's tiles of
# 256), float32 at 1,152 (just past the clusters, nine tiles of 128)
STEP_NHID = {torch.bfloat16: 2048, torch.float32: 1152}
# sessions a train step: at B = 64 the plain scan's autograd keeps about 5
# f32 planes of [16,000, 8,192] a step -- about 79 GB a direction over 30
# steps -- so both sides of the comparison train at B = 8
STEP_TRAIN_B = 8
# (H, dtype, rows, steps, iterations) of kernels 1, 4, 5 alone on the step
# route: the doc encoder's rows and steps, and the recommenders' source
# (float32 at 1,152, the width CARS runs there: the 2,048 row took 36 s of
# the default run's time limit)
STEP_TIMED = ((1152, torch.bfloat16, B * S * N, LD, 3),
              (2048, torch.bfloat16, B * S * N, LD, 2),
              (1152, torch.float32, B * S * N, LD, 1),
              (4096, torch.bfloat16, B, S_REC * LQ, 3))
# (H, dtype) of kernel 6 alone at the doc encoder's rows and steps
STEP_REC = ((640, torch.bfloat16), (2048, torch.bfloat16),
            (1024, torch.float32))


# --nhid 1,152: the GRU kernels' step route (bf16 five tiles of 256, H
# padded to 1,280; float32 nine tiles of 128) and a doc pool of 2 * 1,152 =
# 2,304 units (kernel 10's wide route)
WIDEGRUSTEP_NHID = 1152
# (H, dtype, iterations) of kernels 7, 8, 9 alone at the doc encoder's rows
# and steps
WIDEGRUSTEP_TIMED = ((1152, torch.bfloat16, 3), (2048, torch.bfloat16, 2),
                     (1152, torch.float32, 1))
# (rows, H, dtype) of kernel 10's wide route alone at T = Ld: the rank
# slate and suggest init's clicked docs of CARS at --nhid 1,152 (2,304) and
# 2,048 (4,096)
WIDE_POOL_TIMED = ((B * S * N, 2304, torch.bfloat16),
                   (B * S * N, 2304, torch.float32),
                   (B * S * MAX_CLICKS, 2304, torch.bfloat16),
                   (B * S * MAX_CLICKS, 2304, torch.float32),
                   (B * S * MAX_CLICKS, 4096, torch.bfloat16))


# the kernels each main-path call launches; every other count stays 0
PATH_KERNELS = {
    "rank_batch": ("lstm_fused",),
    "suggest_beam5": ("lstm_fused", BEAM_GEN),
    "suggest_greedy": ("lstm_fused", GREEDY_GEN),
    "train_step": ("lstm_fused_res", "lstm_fused_bwd"),
    "eval_loss": ("lstm_fused",),
    "index_documents": ("lstm_fused",),
    "index_documents_proj": ("lstm_fused",),
    "rank_indexed": ("lstm_fused", "attn_pool"),
    "rank_indexed_clicks": ("lstm_fused", "attn_pool"),
    "rank_indexed_proj": ("lstm_fused",),
    "rank_batch_slate": ("lstm_fused", "attn_pool"),
    "suggest_beam5_int8": ("lstm_fused", "generator_topk_lse_int8"),
    "suggest_shortlist": ("lstm_fused", BEAM_GEN),
    # suggest init of the slate Engine pools the B*S*C clicked docs
    "decode_unpruned": ("lstm_fused", "generator_topk_lse", "attn_pool"),
    "decode_pipelined": ("lstm_fused", "generator_topk_lse_pipelined",
                         "attn_pool"),
    # CARS with GRU encoders and session recurrences, and HRED-QS (GRU)
    "rank_batch_gru": ("gru_fused",),
    "suggest_beam5_gru": ("gru_fused", BEAM_GEN),
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
    # the wide LSTMs: CARS at nhid 512 (bf16: clusters of 2; float32:
    # clusters of 4) and a bf16 CARS at emsize 768
    **{f"{p}_wide_{dt}": k for dt in ("bf16", "f32") for p, k in (
        ("rank_batch", ("lstm_fused",)),
        ("suggest_beam5", ("lstm_fused", BEAM_GEN)),
        ("train_step", ("lstm_fused_res", "lstm_fused_bwd")))},
    "trainer_fit_wide": ("lstm_fused", "lstm_fused_res", "lstm_fused_bwd"),
    "rank_batch_e768": ("lstm_fused",),
    # the wide GRUs: CARS-GRU at nhid 512 (bf16: clusters of 2; float32:
    # clusters of 4) and HRED-QS at nhid 1,024 (bf16: clusters of 4)
    **{f"{p}_widegru_{dt}": k for dt in ("bf16", "f32") for p, k in (
        ("rank_batch", ("gru_fused",)),
        ("suggest_beam5", ("gru_fused", BEAM_GEN)),
        ("train_step", ("gru_fused_res", "gru_fused_bwd")))},
    "suggest_beam5_hredqs_1024": ("gru_fused",),
    "train_step_hredqs_1024": ("gru_fused_res", "gru_fused_bwd"),
    "trainer_fit_widegru": ("gru_fused", "gru_fused_res", "gru_fused_bwd"),
    "trainer_fit_hredqs": ("gru_fused", "gru_fused_res", "gru_fused_bwd"),
    # the flat-source recommenders: their encoder over [B, S_REC * Lq]
    # through kernel 1 (serving) or 4 + 5 (training); their decode step is
    # the logits step (ACG's the copy mixture), with no generator kernel
    "suggest_beam5_seq2seq": ("lstm_fused",),
    "suggest_greedy_seq2seq": ("lstm_fused",),
    "suggest_beam5_acg": ("lstm_fused",),
    "suggest_greedy_acg": ("lstm_fused",),
    "train_step_seq2seq": ("lstm_fused_res", "lstm_fused_bwd"),
    "train_step_acg": ("lstm_fused_res", "lstm_fused_bwd"),
    "trainer_fit_seq2seq": ("lstm_fused", "lstm_fused_res", "lstm_fused_bwd"),
    "trainer_fit_acg": ("lstm_fused", "lstm_fused_res", "lstm_fused_bwd"),
    # a small float32 CARS at beam 40 (kc 41, within the generator kernels'
    # top-128), also with a shortlist
    "suggest_beam40_cars": ("lstm_fused", WIDEBEAM_GEN),
    "suggest_beam40_shortlist_cars": ("lstm_fused", WIDEBEAM_GEN),
    # widebeam: CARS at the serving widths at beams 40 and 127 on the float
    # and int8 tables and at beam 40 with a shortlist; CARS at emsize
    # 1,536 (x streamed) at beam 5, greedy and beam 5 through kernel 3
    **{f"suggest_beam{b}_{t}": ("lstm_fused", k) for b in WIDEBEAMS
       for t, k in (("wide", WIDEBEAM_GEN),
                    ("wide_int8", "generator_topk_lse_int8"))},
    "suggest_beam40_wide_shortlist": ("lstm_fused", WIDEBEAM_GEN),
    "suggest_beam5_e1536": ("lstm_fused", BEAM_GEN),
    "suggest_beam5_e1536_f32": ("lstm_fused", BEAM_GEN),
    "suggest_greedy_e1536": ("lstm_fused", GREEDY_GEN),
    "decode_pipelined_e1536": ("lstm_fused", "generator_topk_lse_pipelined"),
    # f32bwd: CARS and CARS-GRU at the serving widths in float32 (the
    # configuration's default dtype), kernels 1, 4, 5 and 7, 8, 9 on split
    # TF32
    "rank_batch_f32": ("lstm_fused",),
    "suggest_beam5_f32": ("lstm_fused", BEAM_GEN),
    "rank_batch_f32_gru": ("gru_fused",),
    "train_step_f32bwd": ("lstm_fused_res", "lstm_fused_bwd"),
    "train_step_f32bwd_gru": ("gru_fused_res", "gru_fused_bwd"),
    # f32bwd, widelstm: float32 CARS with the slate kernel at the serving
    # widths (the wide route at H = 256), CARS at nhid 512 with it in
    # both dtypes (H = 1,024)
    "rank_batch_f32_slate": ("lstm_fused", "attn_pool"),
    "suggest_beam5_f32_slate": ("lstm_fused", BEAM_GEN, "attn_pool"),
    "train_step_f32_slate": ("lstm_fused_res", "lstm_fused_bwd",
                             "attn_pool"),
    **{f"{p}_wide_{dt}_slate": k for dt in ("bf16", "f32") for p, k in (
        ("rank_batch", ("lstm_fused", "attn_pool")),
        ("train_step", ("lstm_fused_res", "lstm_fused_bwd", "attn_pool")))},
    # widestep: CARS on the step route (bf16 nhid 2,048, float32 1,152) and
    # the doc encoder as a matmul projection + kernel 6 past 512 units
    "rank_batch_step_bf16": ("lstm_fused",),
    "suggest_beam5_step_bf16": ("lstm_fused", BEAM_GEN),
    "train_step_step_bf16": ("lstm_fused_res", "lstm_fused_bwd"),
    "rank_batch_step_f32": ("lstm_fused",),
    "train_step_step_f32": ("lstm_fused_res", "lstm_fused_bwd"),
    **{f"lstm_precomputed_{h}_{str(dt)[6:]}": ("lstm_recurrence",)
       for h, dt in STEP_REC},
    # widegrustep: CARS-GRU at nhid 1,152 on the GRU's step route with the
    # slate kernel's wide route (suggest pools the clicked docs), and
    # kernel 10 alone
    "rank_batch_widegrustep_bf16": ("gru_fused", "attn_pool"),
    "suggest_beam5_widegrustep_bf16": ("gru_fused", BEAM_GEN, "attn_pool"),
    "train_step_widegrustep_bf16": ("gru_fused_res", "gru_fused_bwd",
                                    "attn_pool"),
    "rank_batch_widegrustep_f32": ("gru_fused", "attn_pool"),
    "train_step_widegrustep_f32": ("gru_fused_res", "gru_fused_bwd",
                                   "attn_pool"),
    **{f"attn_pool_{r}_{h}_{str(dt)[6:]}": ("attn_pool",)
       for r, h, dt in WIDE_POOL_TIMED},
    f"attn_pool_{B * S * MAX_CLICKS}_1024_bfloat16": ("attn_pool",),
    # M-NSRF and M-MatchTensor: both encoders through kernel 1 (ranking) or
    # 4 + 5 (training); suggestion encodes the queries alone and decodes
    # through the logits step (no generator kernel); the session recurrence
    # starts from a state and takes no kernel, as in JAX
    **{f"{p}_{m}": ("lstm_fused",) for m in ("mnsrf", "m_match_tensor")
       for p in ("rank_batch", "suggest_beam5", "suggest_greedy")},
    **{f"train_step_{m}": ("lstm_fused_res", "lstm_fused_bwd")
       for m in ("mnsrf", "m_match_tensor")},
    **{f"trainer_fit_{m}": ("lstm_fused", "lstm_fused_res", "lstm_fused_bwd")
       for m in ("mnsrf", "m_match_tensor")},
    # the rankers: Match-Tensor's two encoders through kernel 1 (ranking,
    # validation) or 4 + 5 (training), 7 with GRUs; the other seven (their
    # convolutions, match matrices and histograms in PyTorch, as outside
    # any Pallas kernel in JAX) launch no kernel of the port
    **{f"{p}_{m}": () for m in KERNEL_FREE_RANKERS
       for p in ("rank_batch", "train_step", "trainer_fit")},
    "rank_batch_match_tensor": ("lstm_fused",),
    "rank_batch_match_tensor_gru": ("gru_fused",),
    "train_step_match_tensor": ("lstm_fused_res", "lstm_fused_bwd"),
    "trainer_fit_match_tensor": ("lstm_fused", "lstm_fused_res",
                                 "lstm_fused_bwd"),
    # interop: the Engine over a state.msgpack (and a state.pt) directory,
    # cli.main on the BM25-prepared corpus
    "rank_batch_msgpack": ("lstm_fused",),
    "suggest_beam5_msgpack": ("lstm_fused", BEAM_GEN),
    "rank_batch_state_pt": ("lstm_fused",),
    "trainer_fit_bm25": ("lstm_fused", "lstm_fused_res", "lstm_fused_bwd"),
    "trainer_resume_bm25": ("lstm_fused", "lstm_fused_res",
                            "lstm_fused_bwd"),
    # parallel: the steps and the Engine on a two-replica mesh (one card
    # twice, and two cards where there are); each replica launches the
    # kernels of its shard
    **{f"{p}_{mesh}{dt}": k for mesh in ("mesh2", "cards2")
       for dt in ("", "_bf16") for p, k in (
           ("train_step", ("lstm_fused_res", "lstm_fused_bwd")),
           ("rank_batch", ("lstm_fused", "attn_pool")),
           ("suggest_beam5", ("lstm_fused", BEAM_GEN, "attn_pool")),
           ("index_documents", ("lstm_fused",)),
           ("rank_indexed", ("lstm_fused", "attn_pool")),
           ("rank_batch_min", ("lstm_fused", "attn_pool")),
           ("suggest_beam5_min", ("lstm_fused", BEAM_GEN, "attn_pool")),
           ("rank_indexed_min", ("lstm_fused", "attn_pool")))},
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
    **{f"{p}_widegru_{dt}": k for dt in ("bf16", "f32") for p, k in (
        ("rank_batch", {"gru_fused": 4}),
        ("suggest_beam5", {"gru_fused": 4}),
        ("train_step", {"gru_fused_res": 4, "gru_fused_bwd": 4}))},
    "suggest_beam5_hredqs_1024": {"gru_fused": 2},
    "train_step_hredqs_1024": {"gru_fused_res": 2, "gru_fused_bwd": 2},
    "rank_batch_f32": {"lstm_fused": 4},
    "rank_batch_f32_gru": {"gru_fused": 4},
    "train_step_f32bwd": {"lstm_fused_res": 4, "lstm_fused_bwd": 4},
    "train_step_f32bwd_gru": {"gru_fused_res": 4, "gru_fused_bwd": 4},
    **{f"rank_batch_{t}_slate": {"lstm_fused": 4, "attn_pool": 1}
       for t in ("f32", "wide_bf16", "wide_f32")},
    **{f"train_step_{t}_slate": {"lstm_fused_res": 4, "lstm_fused_bwd": 4,
                                 "attn_pool": 1}
       for t in ("f32", "wide_bf16", "wide_f32")},
    "lstm_precomputed": {"lstm_recurrence": 2},
    **{f"lstm_precomputed_{h}_{str(dt)[6:]}": {"lstm_recurrence": 2}
       for h, dt in STEP_REC},
    **{f"rank_batch_step_{dt}": {"lstm_fused": 4} for dt in ("bf16", "f32")},
    **{f"{p}_widegrustep_{dt}": k for dt in ("bf16", "f32") for p, k in (
        ("rank_batch", {"gru_fused": 4, "attn_pool": 1}),
        ("train_step", {"gru_fused_res": 4, "gru_fused_bwd": 4,
                        "attn_pool": 1}))},
    "suggest_beam5_widegrustep_bf16": {"gru_fused": 4},
    **{f"train_step_step_{dt}": {"lstm_fused_res": 4, "lstm_fused_bwd": 4}
       for dt in ("bf16", "f32")},
    **{f"suggest_{mode}_{m}": {"lstm_fused": 2} for mode in ("beam5", "greedy")
       for m in ("seq2seq", "acg")},
    **{f"train_step_{m}": {"lstm_fused_res": 2, "lstm_fused_bwd": 2}
       for m in ("seq2seq", "acg")},
    **{f"rank_batch_{m}": {"lstm_fused": 4} for m in ("mnsrf",
                                                      "m_match_tensor")},
    **{f"suggest_{mode}_{m}": {"lstm_fused": 2} for mode in ("beam5", "greedy")
       for m in ("mnsrf", "m_match_tensor")},
    **{f"train_step_{m}": {"lstm_fused_res": 4, "lstm_fused_bwd": 4}
       for m in ("mnsrf", "m_match_tensor", "match_tensor")},
    "rank_batch_match_tensor": {"lstm_fused": 4},
    "rank_batch_match_tensor_gru": {"gru_fused": 4},
    "rank_batch_msgpack": {"lstm_fused": 4},
    "rank_batch_state_pt": {"lstm_fused": 4},
    # two replicas: twice one replica's encoder launches
    **{f"{p}_{mesh}{dt}": k for mesh in ("mesh2", "cards2")
       for dt in ("", "_bf16") for p, k in (
           ("train_step", {"lstm_fused_res": 8, "lstm_fused_bwd": 8}),
           ("rank_batch", {"lstm_fused": 8}),
           ("index_documents", {"lstm_fused": 4}),
           ("rank_batch_min", {"lstm_fused": 8}))},
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
    words = np.asarray(word_dict.tokens())
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


def train_path(ckpt_dir: str) -> tuple[dict, dict, str, dict]:
    """The training path at full width (see the module docstring); the
    checkpoint goes under ``ckpt_dir``.  Returns ({path: launches},
    {"train_step": ms}, the checkpoint's path, {"state", "config",
    "word_dict", "model"} of the trained model)."""
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
    trained = {"state": state, "config": cfg, "word_dict": word_dict,
               "model": model}
    return launches, {"train_step": train_ms}, ckpt.latest_path, trained


def full_width_config(model_type: str, train: bool = False, **kw):
    """The main paths' widths (bf16) for ``model_type``: dropout 0 for
    serving, the ModelConfig default dropouts with ``train``; ``kw``
    replaces fields."""
    from context_attentive_ir_tpu_torch.config import default_config

    cfg = default_config(model_type).replace(**{
        "vocab_size": VOCAB, "emsize": EMSIZE, "nhid": NHID,
        "nhid_ffnn": NHID_FFNN, "max_query_len": LQ, "max_doc_len": LD,
        "max_session_len": S, "num_candidates": N,
        "compute_dtype": "bfloat16", **kw})
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
    """A model's teacher-forced NLL on ``batch`` with dropout off, its
    logits (ACG: its mixture probabilities; a multitask model: its
    ``gen_logits``) taken to float32 first: a reading of the training loss
    that resolves changes below bf16's spacing (0.0625 at ln 50,000)."""
    with torch.no_grad():
        out = model(batch)
        if isinstance(out, dict):
            out = out["gen_logits"]
        tmask = batch.target_mask & batch.row_mask.view(
            -1, *(1,) * (batch.target_mask.dim() - 1))
        return float(model.target_nll(out.float(), batch.target_out, tmask))


def train_steps(path: str, cfg, model, batch, steps: int = TRAIN_STEPS,
                reading=None):
    """``steps`` Adam steps of ``model`` on one batch, the second one
    counted against PATH_KERNELS[path] / EXACT_LAUNCHES.  The loss must
    fall: the step losses, or ``reading(model, batch)`` before and after
    the steps where one is given.  A model with no trainable parameter
    (ESM's published frozen table) must instead count its steps and move
    nothing.  Returns (state, step function, launches of the counted
    step)."""
    from context_attentive_ir_tpu_torch.train import (
        create_train_state,
        make_train_step,
        param_count,
    )

    before = reading(model, batch) if reading else None
    state = create_train_state(model, cfg)
    step = make_train_step(model, cfg)
    frozen = not any(state.tx.trainable(n) for n in state.params)
    weights = {n: p.detach().clone() for n, p in state.params.items()
               } if frozen else None
    log(f"{path}: {type(model).__name__} ({cfg.rnn_type} encoders, "
        f"{cfg.session_rnn_type} session RNN, where it has them) with "
        f"{param_count(state)} parameters, dropout {cfg.dropout}/"
        f"{cfg.dropout_emb}/{cfg.dropout_rnn}, {cfg.optimizer} lr "
        f"{cfg.learning_rate}, "
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
    if frozen:
        moved = [n for n, p in state.params.items()
                 if not torch.equal(p.detach(), weights[n])]
        log(f"{path}: no trainable parameter: count "
            f"{state.opt_state['count']}, parameters moved {moved}")
        if state.step != steps or moved:
            raise AssertionError(f"{path}: the frozen model's steps "
                                 "misbehaved")
        return state, step, launches
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


def rec_histories(rng, word_dict, n: int) -> list[list[str]]:
    """``n`` histories of S_REC query texts of 2..Lq words: flat sources of
    up to S_REC * Lq tokens."""
    words = np.asarray(word_dict.tokens())
    return [[" ".join(rng.choice(words, size=rng.randint(2, LQ + 1)))
             for _ in range(S_REC)] for _ in range(n)]


def recommender_paths(ckpt_dir: str) -> tuple[dict, dict]:
    """seq2seq and ACG at the serving widths with S_REC context turns (a
    flat source [B, S_REC * Lq] = [64, 150]): beam-5 and greedy
    ``suggest_batch`` for 64 histories, 8 Adam steps at the ModelConfig
    dropouts (the float32 NLL reading must fall), and a checkpoint ->
    ``Engine.from_checkpoint`` round trip with equal suggestions; each
    call counted, walled and profiled.  Then a small CARS at beam 40.
    Returns ({path: launches}, {path: train step ms})."""
    from context_attentive_ir_tpu_torch.models import build_model
    from context_attentive_ir_tpu_torch.serve import Engine
    from context_attentive_ir_tpu_torch.train import Checkpointer

    word_dict = synthetic_dictionary(VOCAB)
    hists = rec_histories(np.random.RandomState(10), word_dict, B)
    launches, train_ms = {}, {}
    for model_type in ("seq2seq", "acg"):
        cfg = full_width_config(model_type, max_session_len=S_REC)
        with torch.inference_mode():
            params = build_model(cfg, device="cuda", seed=0).state_dict()
            engines = {k: Engine(cfg, word_dict, params, beam_size=k,
                                 batch_bucket=B) for k in (BEAM, 1)}
        calls = tuple((f"suggest_{mode}_{model_type}",
                       lambda e=engines[k]: e.suggest_batch(hists))
                      for mode, k in (("beam5", BEAM), ("greedy", 1)))
        outs, first_ms = {}, {}
        with torch.inference_mode():
            for path, fn in calls:
                t = time.perf_counter()
                outs[path], launches[path] = counted(path, fn)
                first_ms[path] = (time.perf_counter() - t) * 1e3
            for (path, _), k in zip(calls, (BEAM, 1)):
                check_suggestions(path, outs[path], k)
            log(f"{model_type} (source [{B}, {S_REC * LQ}]): launches "
                f"{json.dumps({p: launches[p] for p, _ in calls})}; "
                f"first-call wall ms {json.dumps(first_ms)}; sample beam-5 "
                f"{outs[calls[0][0]][0][0]}, greedy {outs[calls[1][0]][0][0]}")
            walls = steady_walls(calls)
            log(f"steady wall ms (3 runs each, B={B}): {json.dumps(walls)}")
            for name, fn in calls:
                where_time_goes(name, fn)
        del engines, params

        path = f"train_step_{model_type}"
        tcfg = full_width_config(model_type, train=True,
                                 max_session_len=S_REC)
        model = build_model(tcfg, device="cuda", seed=0)
        batch = random_suggest_batch(np.random.RandomState(11),
                                     s=S_REC).to("cuda")
        state, step, launches[path] = train_steps(path, tcfg, model, batch,
                                                  reading=nll_f32)
        where_time_goes(path, lambda: step(state, batch, 1))
        train_ms[path] = timed_ms(lambda: step(state, batch, 1), iters=5,
                                  warmup=1)
        ckpt = Checkpointer(ckpt_dir, model_type)
        ckpt.save_latest(state, tcfg, word_dict, {"step": state.step})
        ckpt.wait()
        with torch.inference_mode():
            loaded = Engine.from_checkpoint(ckpt.latest_path, beam_size=BEAM,
                                            batch_bucket=8)
            got = loaded.suggest_batch(hists[:8])
            want = Engine(tcfg, word_dict, model.state_dict(),
                          beam_size=BEAM, batch_bucket=8).suggest_batch(
                hists[:8])
        log(f"{model_type} checkpoint -> Engine.from_checkpoint: beam-5 "
            f"suggestions for 8 histories equal to the in-memory Engine's: "
            f"{got == want}")
        if got != want:
            raise AssertionError(f"{model_type} Engine.from_checkpoint "
                                 "suggestions differ")
        del model, state, step, batch, loaded
        torch.cuda.empty_cache()
    launches.update(beam40_check())
    log(f"train steps (CUDA events, mean of 5 after warm-up, B={B}): "
        f"{json.dumps(train_ms)}")
    return launches, train_ms


def nbest_difference(got, want, tol: float) -> dict:
    """Compare two n-best lists (text, score) best first, as far as their
    scores tell them apart: the reference's real hypotheses (above
    NEG_INF) fall into groups whose neighbouring scores lie within
    ``tol`` (near-ties, which sums in another order may reorder); each
    group must hold the same texts in both lists, except the last group
    when it reaches the end of the list (a tied hypothesis past the n-th
    may take a place in it).  Both lists are taken in descending score
    order first.  Returns the groups that differ (``differ``), the groups
    (``groups``), the hypotheses in groups of two or more (``tied``), the
    hypotheses of a last group left unchecked (``unchecked``) and the
    max abs score difference by rank (``err``)."""
    got, want = (sorted(nb, key=lambda e: -e[1]) for nb in (got, want))
    real = [i for i, (_, sc) in enumerate(want) if sc > -1e8]
    out = dict(differ=0, groups=0, tied=0, unchecked=0,
               err=max((abs(got[i][1] - want[i][1]) for i in real),
                       default=0.0))
    start = 0
    for k in range(1, len(real) + 1):
        if k < len(real) and want[real[k - 1]][1] - want[real[k]][1] <= tol:
            continue
        group = real[start:k]
        out["groups"] += 1
        if len(group) > 1:
            out["tied"] += len(group)
        if k == len(real) and group[-1] == len(want) - 1:
            out["unchecked"] += len(group)
        elif ({got[i][0] for i in group} != {want[i][0] for i in group}):
            out["differ"] += 1
        start = k
    return out


# near-tied scores of the beam-40 check: a few times the 7.6e-6 by which
# float32 sums in another order moved a score on the H100 (PERF.md)
BEAM40_TIE_TOL = 3e-5


def nbest_check(name: str, got, want) -> dict:
    """``nbest_difference`` of every request's n-best with
    ``BEAM40_TIE_TOL``, logged; raises unless no group differs and the
    scores agree within 1e-4."""
    total = dict(differ=0, groups=0, tied=0, unchecked=0, err=0.0)
    for nb_g, nb_c in zip(got, want):
        d = nbest_difference(nb_g, nb_c, BEAM40_TIE_TOL)
        total = {k: max(v, d[k]) if k == "err" else v + d[k]
                 for k, v in total.items()}
    log(f"{name}: {sum(len(nb) for nb in want)} hypotheses in "
        f"{total['groups']} groups of scores within {BEAM40_TIE_TOL:g} "
        f"({total['tied']} hypotheses in groups of two or more, "
        f"{total['unchecked']} in last groups left unchecked), "
        f"{total['differ']} groups whose texts differ from the CPU "
        f"Engine's, score max abs err {total['err']:.3e} (tol 1e-4)")
    if not (total["differ"] == 0 and total["err"] <= 1e-4):
        raise AssertionError(f"{name} disagrees with the CPU Engine")
    return total


def beam40_check() -> dict:
    """A small float32 CARS ``Engine`` at beam 40 (top-41): it decodes
    through the generator kernel (kc 41, within the kernels' top-128), and
    its n-best lists are the CPU Engine's up to the order of near-tied
    scores (``nbest_difference`` with ``BEAM40_TIE_TOL``: forty beams of a
    random model lie about 4e-6 apart, below the 7.6e-6 that float32 sums
    in another order move them); so are those of a beam-40 shortlist
    Engine.  A shortlist Engine at beam 128 (top-129, past the kernels) is
    refused on the card.  Returns the launches."""
    from context_attentive_ir_tpu_torch.models import build_model
    from context_attentive_ir_tpu_torch.serve import Engine, ServeError

    cfg = small_config("cars")
    word_dict = synthetic_dictionary(SMALL_DIMS["vocab_size"])
    _, hists = small_requests(word_dict)
    params = build_model(cfg, device="cpu", seed=1).state_dict()
    launches = {}
    for path, shortlist in (("suggest_beam40_cars", 0),
                            ("suggest_beam40_shortlist_cars", 64)):
        gpu, cpu = (Engine(cfg, word_dict, params, beam_size=40,
                           batch_bucket=4, suggest_shortlist=shortlist,
                           device=d) for d in ("cuda", "cpu"))
        with torch.inference_mode():
            got, launches[path] = counted(path,
                                          lambda: gpu.suggest_batch(hists))
            want = cpu.suggest_batch(hists)
        log(f"small f32 CARS Engine at beam 40"
            f"{f' with a {shortlist}-id shortlist' if shortlist else ''}: "
            f"launches {json.dumps(launches[path])}")
        nbest_check(path, got, want)
    shortlisted = Engine(cfg, word_dict, params, beam_size=128,
                         batch_bucket=4, suggest_shortlist=200,
                         device="cuda")
    try:
        shortlisted.suggest_batch(hists)
    except ServeError as err:
        log(f"beam-128 shortlist Engine refused on the card: {err}")
        if "128" not in str(err):
            raise AssertionError("the refusal does not name the kernels' "
                                 "top-128") from err
    else:
        raise AssertionError("a beam-128 shortlist Engine ran on the card")
    return launches


# -- the multitask baselines (M-NSRF, M-MatchTensor) and the logits step's
# top-k ------------------------------------------------------------------------


def tied_rows(gen, rows: int, kind: str) -> torch.Tensor:
    """[rows, VOCAB] float32 scores of one logits step: ``normal`` (f32
    logits), ``bf16`` (logits rounded to bfloat16, as the bf16 models give
    them: ties at the top-k's edge in many rows) or ``integer`` (values in
    -3..3: every row tied at its edge)."""
    x = torch.randn(rows, VOCAB, generator=gen, device="cuda") * 3
    if kind == "bf16":
        return x.to(torch.bfloat16).float()
    if kind == "integer":
        return x.round().clamp(-3, 3)
    return x


def topk_check(gen) -> None:
    """The logits step's top-(K+1) at one beam-5 step of the multitask
    models (B*S*K = 1,600 rows) and of HRED-QS (B*K = 320 rows) over the
    50,000-word vocabulary: ``exact`` and ``chunked`` must give the stable
    sort's (``topk_desc``) values and indices, bit for bit, on f32,
    bf16-rounded and integer-valued scores; then the three are timed (CUDA
    events, mean of 20 after warm-up; the rows that need ``_resolve_tied``
    counted)."""
    from context_attentive_ir_tpu_torch.decode import beam

    kc = BEAM + 1
    for rows in (B * S * BEAM, B * BEAM):
        ms = {}
        for kind in ("normal", "bf16", "integer"):
            x = tied_rows(gen, rows, kind)
            want = beam.topk_desc(x, kc)
            top = torch.topk(x, kc + 1, dim=-1).values
            n_tied = int((top[:, kc - 1] == top[:, kc]).sum())
            for method in ("exact", "chunked"):
                got = beam._topk_rows(x, kc, method)
                if not (torch.equal(got[1], want[1]) and torch.equal(
                        got[0].view(torch.int32), want[0].view(torch.int32))):
                    raise AssertionError(f"top-k {method} [{rows}, {VOCAB}] "
                                         f"{kind} differs from topk_desc")
            ms[kind] = {"rows_tied_at_edge": n_tied, **{
                name: round(timed_ms(fn, iters=20), 4) for name, fn in (
                    ("topk_desc", lambda: beam.topk_desc(x, kc)),
                    ("exact", lambda: beam._topk_rows(x, kc, "exact")),
                    ("chunked", lambda: beam._topk_rows(x, kc, "chunked")),
                    ("torch.topk", lambda: torch.topk(x, kc + 1, dim=-1)))}}
        log(f"logits-step top-{kc} over [{rows}, {VOCAB}] float32: exact and "
            f"chunked equal to topk_desc (values and indices, f32, "
            f"bf16-rounded and integer scores); ms {json.dumps(ms)}")


def conv_layouts(gen) -> None:
    """M-MatchTensor's convolution stack at full width (the match tensor
    [B*S*N, Lq, Ld, C + 1] = [16000, 15, 30, 33], bf16): conv0 -> ReLU ->
    2x2 pool -> conv1 -> ReLU -> spatial max, forward and forward +
    backward, on the channels-last view the model passes (``ops/layers.Conv``)
    and on a contiguous NCHW copy; both give the same features, the times
    are logged (CUDA events, mean of 5)."""
    import torch.nn.functional as F

    C, bf16 = 32, torch.bfloat16
    x = torch.randn(B * S * N, LQ, LD, C + 1, generator=gen, device="cuda",
                    dtype=bf16)
    w0 = (torch.randn(C, C + 1, 3, 3, generator=gen, device="cuda") * 0.06
          ).to(bf16).requires_grad_()
    w1 = (torch.randn(C, C, 3, 3, generator=gen, device="cuda") * 0.06
          ).to(bf16).requires_grad_()

    def stack(inp):
        z = torch.relu(F.conv2d(inp, w0, padding=1))
        z = F.max_pool2d(z, 2, 2)
        return torch.relu(F.conv2d(z, w1, padding=1)).amax(dim=(2, 3))

    layouts = {"channels_last view": lambda: x.permute(0, 3, 1, 2),
               "contiguous NCHW": lambda: x.permute(0, 3, 1, 2).contiguous()}
    out, ms = {}, {}
    for name, view in layouts.items():
        with torch.no_grad():
            out[name] = stack(view())
            fwd = timed_ms(lambda: stack(view()), iters=5)
        both = timed_ms(lambda: stack(view().requires_grad_()).float()
                        .sum().backward(), iters=5)
        ms[name] = {"forward": round(fwd, 3), "forward+backward":
                    round(both, 3)}
    err = float((out["channels_last view"].float()
                 - out["contiguous NCHW"].float()).abs().max())
    log(f"M-MatchTensor conv stack [{B * S * N}, {LQ}, {LD}, {C + 1}] bf16: "
        f"ms {json.dumps(ms)}; features max abs difference between the "
        f"layouts {err:.3e}")


def memory_peak(fn):
    """(fn's result, peak MiB allocated during it, MiB allocated before)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return (out, torch.cuda.max_memory_allocated() / 2**20,
            before / 2**20)


def multitask_paths(ckpt_dir: str) -> tuple[dict, dict]:
    """M-NSRF and M-MatchTensor at the serving widths (bf16, seeded
    weights; M-MatchTensor's nfilters 32): ``rank_batch`` for 64 requests x
    50 docs, beam-5 and greedy ``suggest_batch`` for 64 histories (each
    decodes all B*S = 320 turns through the logits step), each counted,
    walled, profiled and its peak memory read; ``index_documents`` must
    raise ``ServeError``; 8 Adam steps on a ragged batch (padded turns,
    candidates and tokens: NEG_INF rows in bf16) at the ModelConfig
    dropouts with the float32 NLL reading falling and a peak-memory
    reading; a checkpoint -> ``Engine.from_checkpoint`` round trip with
    equal scores and suggestions.  Returns ({path: launches}, {path: train
    step ms})."""
    from context_attentive_ir_tpu_torch.models import build_model
    from context_attentive_ir_tpu_torch.serve import Engine, ServeError
    from context_attentive_ir_tpu_torch.train import Checkpointer

    word_dict = synthetic_dictionary(VOCAB)
    reqs, hists = requests(np.random.RandomState(0), word_dict, B)
    launches, train_ms = {}, {}
    for model_type in ("mnsrf", "m_match_tensor"):
        cfg = full_width_config(model_type)
        with torch.inference_mode():
            params = build_model(cfg, device="cuda", seed=0).state_dict()
            engines = {k: Engine(cfg, word_dict, params, beam_size=k,
                                 batch_bucket=B) for k in (BEAM, 1)}
        calls = ((f"rank_batch_{model_type}",
                  lambda e=engines[BEAM]: e.rank_batch(reqs)),
                 (f"suggest_beam5_{model_type}",
                  lambda e=engines[BEAM]: e.suggest_batch(hists)),
                 (f"suggest_greedy_{model_type}",
                  lambda e=engines[1]: e.suggest_batch(hists)))
        outs, first_ms, peak = {}, {}, {}
        with torch.inference_mode():
            for path, fn in calls:
                t = time.perf_counter()
                (outs[path], launches[path]), peak[path], base = memory_peak(
                    lambda p=path, f=fn: counted(p, f))
                first_ms[path] = (time.perf_counter() - t) * 1e3
            scores = outs[calls[0][0]]
            if len(scores) != B or any(len(x) != N for x in scores):
                raise AssertionError(f"{model_type} rank_batch returned the "
                                     "wrong shape")
            if not np.isfinite(np.asarray(scores)).all():
                raise AssertionError(f"{model_type} rank_batch returned "
                                     "non-finite scores")
            for (path, _), k in zip(calls[1:], (BEAM, 1)):
                check_suggestions(path, outs[path], k)
            log(f"{model_type}: launches "
                f"{json.dumps({p: launches[p] for p, _ in calls})}; "
                f"first-call wall ms {json.dumps(first_ms)}; peak MiB "
                f"allocated {json.dumps({p: round(v) for p, v in peak.items()})}"
                f" (weights and engines {base:.0f}); sample beam-5 "
                f"{outs[calls[1][0]][0][0]}, greedy {outs[calls[2][0]][0][0]}")
            try:
                engines[BEAM].index_documents(["a document"])
            except ServeError as err:
                log(f"{model_type} index_documents refused: {err}")
            else:
                raise AssertionError(f"{model_type} indexed documents")
            walls = steady_walls(calls)
            log(f"steady wall ms (3 runs each, B={B}): {json.dumps(walls)}")
            for name, fn in calls:
                where_time_goes(name, fn)
        del engines, params

        path = f"train_step_{model_type}"
        tcfg = full_width_config(model_type, train=True)
        model = build_model(tcfg, device="cuda", seed=0)
        batch = random_session_batch(np.random.RandomState(12),
                                     ragged=True).to("cuda")
        state, step, launches[path] = train_steps(path, tcfg, model, batch,
                                                  reading=nll_f32)
        _, peak_mib, base = memory_peak(lambda: step(state, batch, 1))
        log(f"{path}: peak MiB allocated in a step {peak_mib:.0f} (weights "
            f"and optimizer state {base:.0f})")
        where_time_goes(path, lambda: step(state, batch, 1))
        train_ms[path] = timed_ms(lambda: step(state, batch, 1), iters=5,
                                  warmup=1)
        ckpt = Checkpointer(ckpt_dir, model_type)
        ckpt.save_latest(state, tcfg, word_dict, {"step": state.step})
        ckpt.wait()
        with torch.inference_mode():
            loaded = Engine.from_checkpoint(ckpt.latest_path, beam_size=BEAM,
                                            batch_bucket=8)
            mem = Engine(tcfg, word_dict, model.state_dict(), beam_size=BEAM,
                         batch_bucket=8)
            same = (loaded.rank_batch(reqs[:8]) == mem.rank_batch(reqs[:8])
                    and loaded.suggest_batch(hists[:8])
                    == mem.suggest_batch(hists[:8]))
        log(f"{model_type} checkpoint -> Engine.from_checkpoint: rank_batch "
            f"and beam-5 suggestions for 8 requests equal to the in-memory "
            f"Engine's: {same}")
        if not same:
            raise AssertionError(f"{model_type} Engine.from_checkpoint "
                                 "differs")
        del model, state, step, batch, loaded, mem
        torch.cuda.empty_cache()
    log(f"train steps (CUDA events, mean of 5 after warm-up, B={B}): "
        f"{json.dumps(train_ms)}")
    return launches, train_ms


# -- the rankers -------------------------------------------------------------

RANKER_SESSIONS = 1280   # the rankers but Match-Tensor train on these
WORD_LEN = 16            # constants.MAX_WORD_LEN: DSSM's use_charngram


def ranker_config(model_type: str, train: bool = False, **kw):
    """A ranker at its published widths (``MODEL_DEFAULTS``: DSSM's tower
    300, CDSSM's 300 filters, ...), with the serving vocabulary, emsize,
    lengths, slate and dtype: dropout 0 for serving, the ModelConfig
    defaults with ``train``; ``kw`` replaces fields."""
    from context_attentive_ir_tpu_torch.config import default_config

    cfg = default_config(model_type).replace(**{
        "vocab_size": VOCAB, "emsize": EMSIZE, "max_query_len": LQ,
        "max_doc_len": LD, "max_session_len": S, "num_candidates": N,
        "compute_dtype": "bfloat16", **kw})
    if not train:
        cfg = cfg.replace(dropout=0.0, dropout_emb=0.0, dropout_rnn=0.0)
    return cfg


def random_rank_batch(rng, b=B, n=N, lq=LQ, ld=LD, vocab=VOCAB,
                      word_len=0):
    """A ragged numpy RankBatch of random ids: 1..Lq query tokens, 1..N
    candidates (the rest empty slots) of 0..Ld tokens, one click on a valid
    candidate in most rows (the others none), the last row padded; with
    ``word_len``, random byte ids."""
    from context_attentive_ir_tpu_torch.data.vectorize import RankBatch

    def ids(shape):
        return rng.randint(4, vocab, size=shape).astype(np.int32)

    def lengths(shape, lo, hi):
        return np.arange(hi)[None] < rng.randint(lo, hi + 1, size=shape)[
            ..., None]

    cand_mask = lengths((b,), 1, n)
    clicked = rng.randint(0, n, size=b)
    labels = np.zeros((b, n), np.float32)
    has = (rng.rand(b) < 0.85) & cand_mask[np.arange(b), clicked]
    labels[np.arange(b), clicked] = has
    chars = (lambda shape: rng.randint(4, 260, size=(*shape, word_len))
             .astype(np.int32)) if word_len else (lambda shape: None)
    return RankBatch(
        query=ids((b, lq)), query_mask=lengths((b,), 1, lq),
        docs=ids((b, n, ld)),
        doc_mask=lengths((b, n), 0, ld) & cand_mask[..., None],
        labels=labels, cand_mask=cand_mask, row_mask=np.arange(b) < b - 1,
        query_chars=chars((b, lq)), doc_chars=chars((b, n, ld)))


def rank_loss_f32(model, batch) -> float:
    """The listwise rank loss of a model's scores with dropout off, the
    scores taken to float32 first (bf16 reads the loss in steps of 0.03
    near ln 50)."""
    from context_attentive_ir_tpu_torch.models.losses import rank_loss

    with torch.no_grad():
        return float(rank_loss("listwise", model(batch).float(),
                               batch.labels, batch.cand_mask,
                               batch.row_mask))


def ranker_paths(ckpt_dir: str) -> tuple[dict, dict]:
    """The eight rankers at their published widths (``ranker_config``),
    B = 64 requests of one query and a 50-document slate: ``rank_batch``
    counted (Match-Tensor launches kernel 1 four times, the others no
    kernel of the port), walled, profiled, its peak memory read, and
    ``suggest_batch`` refused; DSSM also with ``use_charngram`` (byte ids
    [64, 50, 30, 16]); 8 Adam steps each on a ragged RankBatch at the
    ModelConfig dropouts (the float32 rank-loss reading must fall; ESM's
    frozen table must not move); a checkpoint -> ``Engine.from_checkpoint``
    round trip with equal scores; a GRU Match-Tensor's ``rank_batch``
    (kernel 7 four times).  Returns ({path: launches}, {path: train step
    ms})."""
    from context_attentive_ir_tpu_torch.models import build_model
    from context_attentive_ir_tpu_torch.serve import Engine, ServeError
    from context_attentive_ir_tpu_torch.train import Checkpointer

    word_dict = synthetic_dictionary(VOCAB)
    reqs, hists = requests(np.random.RandomState(0), word_dict, B)
    launches, train_ms, summary = {}, {}, {}
    variants = [(m, m, {}) for m in RANKERS]
    variants.insert(2, ("dssm_charngram", "dssm", {"use_charngram": True}))
    variants.append(("match_tensor_gru", "match_tensor",
                     {"rnn_type": "gru"}))
    for name, model_type, kw in variants:
        t_model = time.perf_counter()
        cfg = ranker_config(model_type, **kw)
        path = f"rank_batch_{name}"
        with torch.inference_mode():
            params = build_model(cfg, device="cuda", seed=0).state_dict()
            eng = Engine(cfg, word_dict, params, batch_bucket=B)
            t = time.perf_counter()
            (scores, launches[path]), peak, base = memory_peak(
                lambda: counted(path, lambda: eng.rank_batch(reqs)))
            first = (time.perf_counter() - t) * 1e3
            if len(scores) != B or any(len(x) != N for x in scores):
                raise AssertionError(f"{path} returned the wrong shape")
            if not np.isfinite(np.asarray(scores)).all():
                raise AssertionError(f"{path} returned non-finite scores")
            try:
                eng.suggest_batch(hists[:1])
            except ServeError as err:
                refusal = str(err)
            else:
                raise AssertionError(f"{name} suggested")
            calls = ((path, lambda: eng.rank_batch(reqs)),)
            walls = steady_walls(calls)
            log(f"{name}: {sum(p.numel() for p in params.values())} "
                f"parameters; launches {json.dumps(launches[path])}; "
                f"first-call wall {first:.1f} ms, steady {walls[path]}; peak "
                f"MiB allocated {peak:.0f} (weights and engine {base:.0f}); "
                f"suggest_batch refused: {refusal}")
            summary[path] = {"walls_ms": [round(x, 1) for x in walls[path]],
                             "peak_mib": round(peak)}
            where_time_goes(path, calls[0][1])
        del eng, params
        if name == "match_tensor_gru":
            continue

        path = f"train_step_{name}"
        tcfg = ranker_config(model_type, train=True, **kw)
        model = build_model(tcfg, device="cuda", seed=0)
        batch = random_rank_batch(
            np.random.RandomState(12),
            word_len=WORD_LEN if tcfg.use_charngram else 0).to("cuda")
        state, step, launches[path] = train_steps(path, tcfg, model, batch,
                                                  reading=rank_loss_f32)
        _, peak_mib, base = memory_peak(lambda: step(state, batch, 1))
        where_time_goes(path, lambda: step(state, batch, 1))
        train_ms[path] = timed_ms(lambda: step(state, batch, 1), iters=5,
                                  warmup=1)
        summary[path] = {"ms": round(train_ms[path], 2),
                         "peak_mib": round(peak_mib)}
        ckpt = Checkpointer(ckpt_dir, name)
        ckpt.save_latest(state, tcfg, word_dict, {"step": state.step})
        ckpt.wait()
        with torch.inference_mode():
            got = Engine.from_checkpoint(ckpt.latest_path,
                                         batch_bucket=8).rank_batch(reqs[:8])
            want = Engine(tcfg, word_dict, model.state_dict(),
                          batch_bucket=8).rank_batch(reqs[:8])
        log(f"{name} checkpoint -> Engine.from_checkpoint: rank_batch for 8 "
            f"requests equal to the in-memory Engine's: {got == want}; train "
            f"step peak MiB {peak_mib:.0f} (weights and optimizer state "
            f"{base:.0f})")
        if got != want:
            raise AssertionError(f"{name} Engine.from_checkpoint differs")
        del model, state, step, batch
        torch.cuda.empty_cache()
        log(f"{name}: serving, training and the round trip "
            f"{time.perf_counter() - t_model:.1f} s")
    log(f"rankers (B={B}, N={N}): {json.dumps(summary)}")
    return launches, train_ms


# (model type, encoders, tied generator) of the small card-vs-CPU checks
SMALL_MODELS = (("cars", "lstm", True), ("cars", "gru", True),
                ("hredqs", "gru", True), ("seq2seq", "lstm", True),
                ("acg", "gru", True), ("cars", "lstm", False),
                ("mnsrf", "lstm", True), ("mnsrf", "gru", True),
                ("m_match_tensor", "lstm", True),
                *((m, "lstm", True) for m in RANKERS),
                ("match_tensor", "gru", True))
SMALL_DIMS = dict(vocab_size=300, emsize=32, nhid=16, nhid_ffnn=32,
                  max_query_len=8, max_doc_len=12, max_session_len=3,
                  num_candidates=8, dropout=0.0, dropout_emb=0.0,
                  dropout_rnn=0.0)


def small_config(model_type: str, rnn: str = "lstm", tie: bool = True):
    from context_attentive_ir_tpu_torch.config import default_config

    return default_config(model_type).replace(
        rnn_type=rnn, session_rnn_type=rnn, tie_embeddings=tie, **SMALL_DIMS)


def small_requests(word_dict) -> tuple[list, list]:
    """Seeded ranking requests and histories (clicks, a one-query
    history) at SMALL_DIMS: six of each, past one bucket of 4."""
    rng = np.random.RandomState(9)
    words = word_dict.tokens()

    def text(n):
        return " ".join(rng.choice(words, size=n))

    reqs = [(text(4), [text(7) for _ in range(6)],
             [(text(3), [text(5)]), text(2)]) for _ in range(5)]
    hists = [[(text(3), [text(6), text(4)]), text(5)] for _ in range(5)]
    hists.append([text(6)])
    return reqs, hists


def small_model_check() -> None:
    """Small float32 models -- CARS with LSTMs, CARS with GRUs, HRED-QS
    with GRUs, seq2seq, ACG (its copy mixture), CARS with an untied
    generator, M-NSRF with LSTMs and with GRUs, M-MatchTensor (its
    convolutions in cuDNN, TF32 off), and the eight rankers (Match-Tensor
    also with GRUs; their ``rank_batch`` only): each ``Engine`` on the
    card (kernel 1 or 7, kernel 2 for tied CARS) must agree with the same
    ``Engine`` on the CPU (plain versions), and one SGD train step of each
    on the card (kernels 4/5 or 8/9) with the same step on the CPU, on
    ragged batches.  SGD keeps the
    update linear in the gradient, so a float32 rounding difference in a
    near-zero gradient element cannot flip an Adam step's sign and the
    parameters compare as tightly as the gradients."""
    from context_attentive_ir_tpu_torch.models import build_model, task_family
    from context_attentive_ir_tpu_torch.serve import Engine
    from context_attentive_ir_tpu_torch.train import (
        create_train_state,
        make_train_step,
    )

    word_dict = synthetic_dictionary(SMALL_DIMS["vocab_size"])
    reqs, hists = small_requests(word_dict)
    for model_type, rnn, tie in SMALL_MODELS:
        family = task_family(model_type)
        cfg = small_config(model_type, rnn, tie)
        params = build_model(cfg, device="cpu", seed=1).state_dict()
        if not tie:
            rnn = f"{rnn}, untied"
        for beam in ((3, 1) if family != "ranker" else (1,)):
            gpu = Engine(cfg, word_dict, params, beam_size=beam,
                         batch_bucket=4)
            cpu = Engine(cfg, word_dict, params, beam_size=beam,
                         batch_bucket=4, device="cpu")
            err = s_err = 0.0
            same = True
            if family != "recommender":
                rg, rc = gpu.rank_batch(reqs), cpu.rank_batch(reqs)
                err = max(abs(a - b) for x, y in zip(rg, rc)
                          for a, b in zip(x, y))
            if family != "ranker":
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
        if family == "multitask":
            batch = random_session_batch(np.random.RandomState(3), 6, 3, 8,
                                         8, 12, 300, ragged=True)
        elif family == "ranker":
            batch = random_rank_batch(np.random.RandomState(3), 6, 8, 8, 12,
                                      300)
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
        # ESM's published table is frozen: a grad_norm of 0 on both
        norm_rel = (abs(mg["grad_norm"] - mc["grad_norm"])
                    / (mc["grad_norm"] or 1.0))
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
# the multitask models (CARS, M-NSRF, M-MatchTensor) and Match-Tensor train
# on the fixture's first sessions (the vocabulary stays the whole
# fixture's): the default run's time limit; each model's dev MAP already
# rises above the untrained one's, or holds the ceiling, within the first
# epoch's 80 steps on all 5,120 sessions
FIT_TRAIN_SESSIONS = 2560
FIT_EPOCHS = {"cars": 2, "hredqs": 2, "seq2seq": 2, "acg": 2, "mnsrf": 2,
              "m_match_tensor": 2, **{m: 2 for m in RANKERS}}
MULTITASK = ("cars", "mnsrf", "m_match_tensor")
HRED_SESSIONS = 1280   # the recommenders train on the first sessions
MAP_CEILING = 0.99     # an untrained dev MAP at or above it has no room
TIMED_STEPS, PROFILED_STEPS = 20, 10


def fit_args(model_type: str, files: dict, run_dir: str, *extra) -> list:
    """The command line of one ``cli.main`` run at the serving widths (a
    ranker at its published widths, ``MODEL_DEFAULTS``)."""
    ranker = model_type in RANKERS
    widths = [] if ranker else ["--nhid", str(NHID), "--nhid_ffnn",
                                str(NHID_FFNN)]
    args = ["--model_type", model_type, "--model_dir", run_dir,
            "--model_name", f"{model_type}_fit", "--batch_size", str(B),
            "--test_batch_size", str(B), "--emsize", str(EMSIZE), *widths,
            "--max_query_len", str(LQ), "--max_doc_len", str(LD),
            "--max_session_len", str(S), "--num_candidates", str(N),
            "--compute_dtype", "bfloat16", "--beam_size", str(BEAM),
            "--display_iter", "5", "--test_file", str(files["test"])]
    if model_type == "hredqs":
        args += ["--rnn_type", "gru", "--session_rnn_type", "gru"]
    if model_type in (*MULTITASK, "match_tensor"):
        args += ["--max_examples", str(FIT_TRAIN_SESSIONS)]
    elif ranker:
        args += ["--max_examples", str(RANKER_SESSIONS)]
    else:
        args += ["--valid_metric", "bleu-1", "--max_examples",
                 str(HRED_SESSIONS)]
    return args + list(extra)


def trainer_path(model_type: str, files: dict, run_dir: str,
                 resume: bool = True) -> dict:
    """``cli.main.main`` at full width for ``model_type``: train with
    per-epoch official validation, test, ``--only_test``; with ``resume``,
    ``--resume`` for one more epoch, then the Trainer's parts timed on the
    resumed state.  Returns the counted launches of the training run."""
    from context_attentive_ir_tpu_torch.cli.main import (
        build_parser,
        main as cli_main,
        prepare,
    )
    from context_attentive_ir_tpu_torch.constants import EOS
    from context_attentive_ir_tpu_torch.data import prefetch
    from context_attentive_ir_tpu_torch.models import task_family
    from context_attentive_ir_tpu_torch.train.trainer import make_iterator

    # the multitask family trains on whole sessions and validates on MAP
    # and BLEU, a ranker on (query, slate) rows and MAP, a recommender on
    # (context, next query) pairs and BLEU
    family = task_family(model_type)
    mt = family == "multitask"
    ranks, suggests = family != "recommender", family != "ranker"
    path = "trainer_fit" if model_type == "cars" else (
        f"trainer_fit_{model_type}")
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
    # ESM's published table is frozen: its model has nothing to train
    n_trainable = sum(p.numel() for n, p in trainer.state.params.items()
                      if trainer.state.tx.trainable(n))
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
    if mt:
        steps = epochs * -(-FIT_TRAIN_SESSIONS // B)
    else:
        from context_attentive_ir_tpu_torch.data import (
            load_data,
            rank_examples,
            suggest_examples,
        )

        examples = rank_examples if ranks else suggest_examples
        n_ex = len(examples(load_data(
            files["train"], LQ, LD, N, S,
            FIT_TRAIN_SESSIONS if model_type == "match_tensor" else
            RANKER_SESSIONS if ranks else HRED_SESSIONS)))
        steps = epochs * -(-n_ex // B)
    if PATH_KERNELS[path]:
        fwd, res_k, bwd = PATH_KERNELS[path]
        per_step = 2 if family == "recommender" else 4  # encoders x dirs
        if (launches[res_k], launches[bwd]) != (per_step * steps,) * 2:
            raise AssertionError(
                f"{path}: {launches[res_k]} / {launches[bwd]} training-pair "
                f"launches, not {per_step} a step for {steps} steps")
    if len(hist) != epochs or (n_trainable and not hist[-1]["train_loss"]
                               < hist[0]["train_loss"]):
        raise AssertionError(f"{path}: the epoch train loss did not fall")
    if not all(math.isfinite(v) for h in hist + [test] for v in h.values()):
        raise AssertionError(f"{path}: non-finite metrics")
    want = (({"bleu-1", "bleu-4", "rouge-l"} if suggests else set())
            | ({"map", "mrr", "ndcg@10"} if ranks else set()))
    if not want <= set(hist[-1]) or not want <= set(test):
        raise AssertionError(f"{path}: metric columns missing: "
                             f"{sorted(hist[-1])}")
    # dev MAP must rise above the untrained model's; where the untrained
    # model already ranks at the fixture's ceiling (ESM, DSSM: the clicked
    # documents repeat the query's words, and a mean embedding keeps that)
    # it must stay there
    if ranks and n_trainable:
        if untrained["map"] >= MAP_CEILING:
            if not hist[-1]["map"] >= MAP_CEILING:
                raise AssertionError(
                    f"{path}: dev MAP {hist[-1]['map']} fell below "
                    f"{MAP_CEILING} from the untrained {untrained['map']}")
        elif not hist[-1]["map"] > untrained["map"]:
            raise AssertionError(f"{path}: dev MAP {hist[-1]['map']} not "
                                 f"above the untrained model's "
                                 f"{untrained['map']}")
    dumps = (([f"{name}.test.hyps.jsonl"] if suggests else [])
             + ([f"{name}.test.ranks.jsonl"] if ranks else []))
    for f in (f"{name}.mdl", f"{name}.mdl.checkpoint", *dumps):
        if not (runs / f).exists():
            raise AssertionError(f"{path}: {f} was not written")
    if not all((runs / f).read_text().strip() for f in dumps):
        raise AssertionError(f"{path}: an empty prediction dump")

    key = "map" if ranks else "bleu-1"
    retest = cli_main(fit_args(model_type, files, run_dir, "--only_test"))
    log(f"{path}: --only_test {key} {retest['test'][key]} == the run's "
        f"{test[key]}: {retest['test'][key] == test[key]}")
    if retest["test"] != test:
        raise AssertionError(f"{path}: --only_test does not reproduce the "
                             "test metrics")
    if not resume:
        return {path: launches}

    # a resumed run of one more epoch (cli.main's own steps, keeping its
    # Trainer for the timings below)
    resume_argv = fit_args(model_type, files, run_dir, *train, "--resume",
                           "--num_epochs", str(epochs + 1))
    _, run, trainer, train_s, dev_s, _ = prepare(
        build_parser().parse_args(resume_argv))
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
    log(f"{path}: validation of {len(dev_s)} dev sessions "
        f"({len(dev_batches)} batches) {valid_s:.3f} s")
    dec = trainer.decode_fn
    if suggests:
        dec.calls = dec.steps = 0
        done = rows = 0
        for b in dev_batches:
            seqs = dec(b)
            if mt:
                valid = (b.target_mask.any(-1)
                         & b.row_mask[:, None]).reshape(-1)
            else:
                valid = b.row_mask
            rows += int(valid.sum())
            done += int((seqs[valid] == EOS).any(-1).sum())
        log(f"{path}: beam-{BEAM} decode with early exit: {done}/{rows} "
            f"hypotheses ended in EOS before max_len "
            f"({done / max(rows, 1):.3f}), mean decode steps "
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
    slots = B * S * N if mt else B * N if ranks else B
    log(f"{path}: {n} steps of the Trainer's loop (prefetch "
        f"{run.prefetch_batches}, pack_cache {run.pack_cache}; an epoch has "
        f"{n_epoch}): {loop_s:.3f} s = {loop_s / n * 1e3:.1f} ms a step -> "
        f"{n * slots / loop_s:.0f} trained "
        f"{'docs' if ranks else 'examples'}/s")
    n = min(PROFILED_STEPS, n_epoch)
    where_time_goes(f"{path} training loop ({n} steps)", lambda: loop(n))
    where_time_goes(f"{path} validation", lambda: trainer.validate(
        dev_batches))
    del trainer
    torch.cuda.empty_cache()
    return {path: launches}


def fit_files(fixture_dir: str) -> dict:
    """The seeded AOL-scale fixtures of every ``cli.main`` run (50,000
    words, sessions of 2..S turns, N candidates, ``FIT_SESSIONS`` per
    file), written under ``fixture_dir`` by the first caller and shared by
    the later ones (a run with ``--max_examples`` reads the first
    sessions)."""
    from context_attentive_ir_tpu_torch.data.synthetic import (
        write_aol_scale_fixture,
    )

    files = {name: Path(fixture_dir) / f"{name}.jsonl"
             for name in FIT_SESSIONS}
    if not all(f.exists() for f in files.values()):
        t = time.perf_counter()
        for i, (name, n) in enumerate(FIT_SESSIONS.items()):
            write_aol_scale_fixture(
                files[name], n_sessions=n, n_topics=FIT_TOPICS,
                words_per_topic=FIT_WORDS, min_turns=2, max_turns=S,
                n_candidates=N, seed=20 + i)
        log(f"trainer fixtures {FIT_SESSIONS} written in "
            f"{time.perf_counter() - t:.1f} s")
    return files


def trainer_paths(tmp: str, fixture_dir: str,
                  model_types=("cars", "hredqs"), resumed=None) -> dict:
    """``trainer_path`` under ``tmp`` for each of ``model_types`` on the
    fixtures of ``fit_files(fixture_dir)`` (with ``--resume`` and the
    timings for those in ``resumed``; None: all)."""
    files = fit_files(fixture_dir)
    launches, failed = {}, []
    for model_type in model_types:
        # every model runs; a failed check fails the phase at its end
        try:
            t = time.perf_counter()
            launches.update(trainer_path(
                model_type, files, str(Path(tmp) / "runs"),
                resume=resumed is None or model_type in resumed))
            log(f"trainer_path {model_type}: "
                f"{time.perf_counter() - t:.1f} s")
        except AssertionError as err:
            log(f"FAILED {model_type}: {err}")
            failed.append(str(err))
    # cli.main's log handlers (stdout, a file under tmp) end with the phase
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
        h.close()
    if failed:
        raise AssertionError("; ".join(failed))
    return launches


# -- interop: run directories, data preparation, beam host reads -----------

INTEROP_SESSIONS = 1280   # the click log: the first train sessions


def host_reads(name: str, fn) -> dict:
    """One profiled call: its host reads of device values (scalar reads --
    ``bool`` / ``item`` of a CUDA tensor -- and ``nonzero``, each a sync)
    with their count and host ms (profiler overhead included)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    reads = {e.key: (e.count, e.cpu_time_total / 1e3)
             for e in prof.key_averages()
             if e.key in ("aten::_local_scalar_dense", "aten::nonzero")}
    out = {"reads": sum(n for n, _ in reads.values()),
           "ms": round(sum(ms for _, ms in reads.values()), 3),
           "by_op": {k: [n, round(ms, 3)] for k, (n, ms) in reads.items()}}
    log(f"{name}: host reads {json.dumps(out)}")
    return out


def write_click_log(train_file: Path, out_dir: Path, n: int
                    ) -> tuple[Path, Path, int]:
    """The first ``n`` sessions of a fixture as a click log (tab-separated
    session id, query, clicked title: one row a click, an empty click for
    a turn without one) and the distinct titles of their slates as the
    corpus.  Returns (log, corpus, rows)."""
    log_path, corpus_path = out_dir / "clicks.tsv", out_dir / "titles.txt"
    titles: dict[str, None] = {}
    rows = []
    with open(train_file) as f:
        for _, line in zip(range(n), f):
            sess = json.loads(line)
            for q in sess["query"]:
                clicks = [c["title"] for c in q["candidates"] if c["label"]]
                for c in q["candidates"]:
                    titles.setdefault(c["title"], None)
                rows += [f"{sess['session_id']}\t{q['text']}\t{c}\n"
                         for c in clicks or [""]]
    log_path.write_text("".join(rows))
    corpus_path.write_text("".join(f"{t}\n" for t in titles))
    return log_path, corpus_path, len(rows)


def interop_paths(tmp: str, fixture_dir: str, trained: dict) -> dict:
    """(i) the train phase's 8-step CARS state through ``Checkpointer`` as
    ``state.msgpack`` (the JAX package's format): read back bit for bit,
    an ``Engine.from_checkpoint`` on it equal bit for bit to the Engine
    over the weights in memory (``rank_batch`` over 64 requests, beam-5
    ``suggest_batch`` over 64 histories), and the same state as a
    ``state.pt`` directory (the port's format before msgpack) too; (ii)
    ``prepare_data bm25`` on a click log of the AOL-scale fixture's first
    ``INTEROP_SESSIONS`` train sessions over the distinct titles of their
    slates, through the native scorer; (iii) ``cli.main`` CARS on the
    prepared sessions for one epoch with the native vectorizer (its first
    8 batches bit-equal to the Python vectorizer's), ``--resume`` for one
    more epoch from its ``state.msgpack``, and ``--pretrained_path`` from
    its best; (iv) beam-5 ``suggest_batch`` timed, with its host reads.
    Returns {path: launches}."""
    import shutil

    from context_attentive_ir_tpu_torch.cli.main import (
        build_parser,
        main as cli_main,
        prepare,
    )
    from context_attentive_ir_tpu_torch.cli.prepare_data import (
        main as prepare_data,
    )
    from context_attentive_ir_tpu_torch.serve import Engine
    from context_attentive_ir_tpu_torch.train import Checkpointer
    from context_attentive_ir_tpu_torch.train.checkpoint import (
        STATE_FILE,
        TORCH_STATE_FILE,
    )
    from context_attentive_ir_tpu_torch.train.trainer import make_iterator

    state, cfg = trained["state"], trained["config"]
    word_dict, model = trained["word_dict"], trained["model"]
    root = Path(tmp) / "interop"
    launches = {}

    # (i) the full-width state through state.msgpack
    ckpt = Checkpointer(root / "runs", "cars")
    t = time.perf_counter()
    ckpt.save_latest(state, cfg, word_dict, {"epoch": 0})
    ckpt.wait()
    write_s = time.perf_counter() - t
    path = ckpt.latest_path
    mib = (path / STATE_FILE).stat().st_size / 2**20
    t = time.perf_counter()
    blob = Checkpointer.read_state(path)
    read_s = time.perf_counter() - t
    want = state.state_dict()
    same = (blob["step"] == want["step"]
            and blob["opt_state"]["count"] == want["opt_state"]["count"]
            and all(torch.equal(blob["params"][n], t)
                    for n, t in want["params"].items())
            and all(torch.equal(blob["opt_state"][k][n], t)
                    for k in ("mu", "nu")
                    for n, t in want["opt_state"][k].items()))
    log(f"interop: state.msgpack of the {state.step}-step CARS state "
        f"(params + Adam moments) {mib:.1f} MiB, write {write_s:.3f} s "
        f"(snapshot + encode + disk), read {read_s:.3f} s; read back bit "
        f"for bit: {same}")
    if not same:
        raise AssertionError("interop: state.msgpack does not read back "
                             "the saved state")
    reqs, hists = requests(np.random.RandomState(5), word_dict, B)
    mem = Engine(cfg, word_dict, model.state_dict(), beam_size=BEAM,
                 batch_bucket=B)
    loaded = Engine.from_checkpoint(path, beam_size=BEAM, batch_bucket=B)
    with torch.inference_mode():
        got_r, launches["rank_batch_msgpack"] = counted(
            "rank_batch_msgpack", lambda: loaded.rank_batch(reqs))
        got_s, launches["suggest_beam5_msgpack"] = counted(
            "suggest_beam5_msgpack", lambda: loaded.suggest_batch(hists))
        want_r, want_s = mem.rank_batch(reqs), mem.suggest_batch(hists)
    log(f"interop: Engine.from_checkpoint(state.msgpack) equal to the "
        f"in-memory Engine: rank_batch {got_r == want_r}, beam-5 "
        f"suggest_batch {got_s == want_s}")
    if got_r != want_r or got_s != want_s:
        raise AssertionError("interop: the msgpack Engine differs")
    old = root / "runs" / "cars_pt.mdl"
    shutil.copytree(path, old)
    (old / STATE_FILE).unlink()
    torch.save(want, old / TORCH_STATE_FILE)
    with torch.inference_mode():
        pt_engine = Engine.from_checkpoint(old, beam_size=BEAM,
                                           batch_bucket=B)
        got_pt, launches["rank_batch_state_pt"] = counted(
            "rank_batch_state_pt", lambda: pt_engine.rank_batch(reqs))
    log(f"interop: a state.pt directory still loads: rank_batch equal "
        f"{got_pt == want_r}")
    if got_pt != want_r:
        raise AssertionError("interop: the state.pt Engine differs")
    del loaded, pt_engine, blob, want

    # (iv) beam-5's walls and host reads (the early exit's finished.all(),
    # the exact top-k's tied-row flag): the syncs a decode makes
    def suggest():
        with torch.inference_mode():
            return mem.suggest_batch(hists)

    log(f"interop: beam-5 suggest_batch steady wall ms (3 runs, B={B}): "
        f"{json.dumps(steady_walls([('suggest_beam5', suggest)]))}")
    host_reads("suggest_beam5", suggest)

    # (ii) BM25 preparation of a click log
    files = fit_files(fixture_dir)
    log_path, corpus, n_clicks = write_click_log(files["train"], root,
                                                 INTEROP_SESSIONS)
    prepared = root / "bm25_train.jsonl"
    t = time.perf_counter()
    report = prepare_data(["bm25", "--log", str(log_path), "--corpus_file",
                           str(corpus), "--output", str(prepared),
                           "--num_candidates", str(N)])
    bm25_s = time.perf_counter() - t
    log(f"interop: prepare_data bm25 over {report['titles']} titles, "
        f"{report['sessions']} sessions, {report['turns']} turns "
        f"({n_clicks} log rows) in {bm25_s:.2f} s; turns with a click "
        f"appended {report['appended']}, dropped {report['dropped']}, "
        f"unmatched clicks {report['unmatched']}; native scorer "
        f"{report['native']}")
    if not report["native"]:
        raise AssertionError("interop: the native BM25 scorer did not run")

    # (iii) cli.main CARS on the prepared sessions
    run_dir = root / "fit"
    train = ["--train_file", str(prepared), "--dev_file", str(files["dev"]),
             "--model_name", "cars_bm25"]
    argv = fit_args("cars", files, str(run_dir), *train, "--num_epochs",
                    "1")
    _, run, trainer, train_s, _, _ = prepare(build_parser().parse_args(argv))
    if trainer.fast is None:
        raise AssertionError("interop: Trainer.fast is not set")
    kw = dict(shuffle=True, seed=run.seed)
    native_it = make_iterator(train_s, trainer.config, trainer.word_dict, B,
                              fast=trainer.fast, **kw)
    plain_it = make_iterator(train_s, trainer.config, trainer.word_dict, B,
                             **kw)
    for i, (a, b) in enumerate(zip(native_it.epoch(0), plain_it.epoch(0))):
        if i == 8:
            break
        for f in ("query", "query_mask", "docs", "doc_mask", "clicks",
                  "cand_mask", "turn_mask", "target_in", "target_out",
                  "target_mask", "row_mask"):
            if not np.array_equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"interop: native batch {i} differs "
                                     f"in {f}")
    pack_s = {}
    for name, fv in (("native", trainer.fast), ("python", None)):
        t = time.perf_counter()
        make_iterator(train_s, trainer.config, trainer.word_dict, B,
                      fast=fv, pack=True, **kw)
        pack_s[name] = round(time.perf_counter() - t, 3)
    log(f"interop: the first 8 batches native == Python; one-time pack of "
        f"{len(train_s)} sessions, s: {json.dumps(pack_s)}")
    del trainer, native_it, plain_it
    torch.cuda.empty_cache()

    t = time.perf_counter()
    res, launches["trainer_fit_bm25"] = counted(
        "trainer_fit_bm25", lambda: cli_main(argv))
    hist = res["fit"]["history"]
    log(f"interop: cli.main on the BM25 corpus, 1 epoch + test in "
        f"{time.perf_counter() - t:.1f} s: history "
        + json.dumps([{k: round(v, 4) for k, v in h.items()} for h in hist])
        + f"; test map {res['test']['map']:.4f}")
    steps = -(-len(train_s) // B)
    counts = launches["trainer_fit_bm25"]
    pair = (counts["lstm_fused_res"], counts["lstm_fused_bwd"])
    if pair != (4 * steps,) * 2:
        raise AssertionError(f"interop: training-pair launches {counts}, "
                             f"not 4 a step for {steps} steps")
    latest = run_dir / "cars_bm25.mdl.checkpoint"
    if not (latest / STATE_FILE).exists():
        raise AssertionError("interop: the run wrote no state.msgpack")
    res, launches["trainer_resume_bm25"] = counted(
        "trainer_resume_bm25", lambda: cli_main(fit_args(
            "cars", files, str(run_dir), *train, "--resume", "--num_epochs",
            "2")))
    epochs = [h["epoch"] for h in res["fit"]["history"]]
    log(f"interop: --resume from {STATE_FILE} continued at epoch {epochs}")
    if epochs != [1]:
        raise AssertionError("interop: the resumed run did not start at "
                             "epoch 1")
    best = run_dir / "cars_bm25.mdl"
    _, _, warm, _, _, _ = prepare(build_parser().parse_args(fit_args(
        "cars", files, str(run_dir), "--train_file", str(prepared),
        "--model_name", "cars_warm", "--pretrained_path", str(best))))
    warm.init_state()
    params = Checkpointer.read_state(best)["params"]
    loaded_ok = all(torch.equal(p.detach().cpu(), params[n])
                    for n, p in warm.model.named_parameters())
    log(f"interop: --pretrained_path from the best's {STATE_FILE}: weights "
        f"equal {loaded_ok}")
    if not loaded_ok:
        raise AssertionError("interop: --pretrained_path did not load")
    del warm
    torch.cuda.empty_cache()
    # cli.main's log handlers (stdout, a file under tmp) end with the phase
    root_logger = logging.getLogger()
    for h in list(root_logger.handlers):
        root_logger.removeHandler(h)
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


def time_rnn(gen, rnn: str, launches: dict, fwd_err: float | None = None,
             pair_err: dict | None = None, shape: tuple | None = None,
             dtype=torch.bfloat16, iters: int = 5, warmup: int = 2,
             sources: tuple | None = None, bwd_only: bool = False,
             **widths) -> list[dict]:
    """The forward kernel and the training pair of ``rnn`` (kernels 1, 4,
    5 or 7, 8, 9) at the doc encoder's shape, or at ``shape`` = (rows,
    steps) and ``widths`` (``e``, ``h``; then the rows carry ``rows``,
    ``steps``, ``e``, ``h`` and ``dtype``), one direction, in ``dtype``
    (bf16 by default), against their plain versions and cuDNN's module of
    the same recurrence as the yardstick (inference forward; training
    forward with autograd on; backward alone, from a retained graph), each
    the mean of ``iters`` calls.  Without ``pair_err`` the kernels are
    first held to their plain versions on these very inputs, both
    directions (``pair_check``: every output within PAIR_TOL, masked
    outputs 0, the backward the same bits twice), and the rows carry those
    errors.  ``warmup`` calls precede each timing; ``sources`` names the
    files the rows' kernels run from (default RNN_TIMING's); ``bwd_only``
    times (and returns the row of) the backward alone."""
    mod = rnn_kernels(rnn)
    cudnn_cls, default_sources, replaces = RNN_TIMING[rnn]
    sources = sources or default_sources
    fwd, res, bwd = f"{rnn}_fused", f"{rnn}_fused_res", f"{rnn}_fused_bwd"
    plain = {k: getattr(mod, k + "_reference") for k in (fwd, res, bwd)}
    x, mask, w, dout = pair_inputs(gen, rnn, dtype,
                                   *(shape or (B * S * N, LD)), **widths)
    rows, steps, e = x.shape
    h = w[2].shape[0]
    if pair_err is None:
        worst = held_errors("path shape", rnn, x, mask, w, dout, dtype)
        fwd_err = worst["out"]
        pair_err = {k: {dtype: a} for k, a in by_kernel(rnn, worst).items()}
    out, *state = getattr(mod, res)(x, mask, *w)
    cudnn = cudnn_cls(e, h, batch_first=True, device="cuda", dtype=dtype)
    ms, plain_ms, lib = {}, {}, {}
    few = min(iters, 3)
    wu = {"warmup": warmup}
    if not bwd_only:
        with torch.inference_mode():
            ms[fwd] = timed_ms(lambda: getattr(mod, fwd)(x, mask, *w), iters,
                               **wu)
            plain_ms[fwd] = timed_ms(lambda: plain[fwd](x, mask, *w), few,
                                     **wu)
            lib[fwd] = timed_ms(lambda: cudnn(x), iters, **wu)
        ms[res] = timed_ms(lambda: getattr(mod, res)(x, mask, *w), iters,
                           **wu)
        plain_ms[res] = timed_ms(lambda: plain[res](x, mask, *w), few, **wu)
    ms[bwd] = timed_ms(lambda: getattr(mod, bwd)(x, mask, *w, *state, dout),
                       iters, **wu)
    plain_ms[bwd] = timed_ms(lambda: plain[bwd](x, mask, *w, *state, dout),
                             few, **wu)
    # cuDNN's training graph at H = 2,048 in float32 wants ~20 GB: the
    # kernels' outputs and the allocator's cached blocks go first
    n_out, n_state, state_numel = out.numel(), len(state), state[0].numel()
    del out, state
    torch.cuda.empty_cache()
    xg = x.detach().requires_grad_()
    if not bwd_only:
        lib[res] = timed_ms(lambda: cudnn(xg), iters, **wu)
    o, _ = cudnn(xg)
    wrt = [xg, *cudnn.parameters()]
    lib[bwd] = timed_ms(lambda: torch.autograd.grad(o, wrt, dout,
                                                    retain_graph=True), iters,
                        **wu)
    del o
    torch.cuda.empty_cache()

    gates = w[0].shape[1] // h
    weights = sum(t.numel() for t in w) * x.element_size()
    boundaries = n_state * state_numel * 4
    flops_f = 2.0 * rows * steps * (e + h) * gates * h
    elt = x.element_size()
    bytes_f = (x.numel() + n_out) * elt + weights + mask.numel()
    # recompute + dx + dh + dW_ih + dW_hh: three times the forward's flops
    bytes_b = ((2 * x.numel() + dout.numel()) * elt + 2 * weights
               + mask.numel() + boundaries)
    rows_out = []
    for name, src, line, flops, n_bytes, err, what in (
            (fwd, sources[0], replaces[0], flops_f, bytes_f, fwd_err,
             "inference forward"),
            (res, sources[1], replaces[1], flops_f, bytes_f + boundaries,
             pair_err[res][dtype], "training forward"),
            (bwd, sources[2], replaces[2], 3 * flops_f, bytes_b,
             pair_err[bwd][dtype], "backward alone")):
        if name not in ms:
            continue
        bnd, by = bound_ms(flops, n_bytes, dtype)
        log(f"{name} {str(dtype)[6:]} [{rows},{steps},{e}]->{h} one "
            f"direction, TC="
            f"{TIME_CHUNK}: kernel {ms[name]:.3f} ms, plain "
            f"{plain_ms[name]:.3f} ms, cuDNN {cudnn_cls.__name__} {what} "
            f"{lib[name]:.3f} ms, bound {bnd:.4f} ms ({by})")
        extra = {}
        if shape is None:
            log_earlier(name, ms[name], plain_ms[name], lib[name], bnd)
        else:
            extra = {"rows": rows, "steps": steps}
            if widths:
                extra.update(e=e, h=h, dtype=str(dtype)[6:])
        rows_out.append(kernel_row(name, src, line, launches, err, ms[name],
                                   plain_ms[name], lib[name], bnd, by,
                                   **extra))
    return rows_out


# -- the float32 tiles: kernels 1, 4, 5 and 7, 8, 9 on split TF32 ----------

# (rows, steps, E, H) at which float32 kernels 1, 4, 5 and 7, 8, 9 are held
# to their plain versions (both directions, 5 and 9 the same bits twice, 4
# and 8 the bits of 1 and 7) and timed beside cuDNN's exact-f32 module: the
# doc encoder's rows at H = 128 (the main shape; forwards and backward),
# 256, 384, 512 and 1,024 (backward), and the recommenders' source [64,
# 150] (forwards and backward); WIDE_TIMED / WIDEGRU_TIMED time some of
# them in a default run already
F32_TILE_TIMED = ((B * S * N, LD, EMSIZE, NHID),
                  (B, S_REC * LQ, EMSIZE, NHID),
                  (B * S * N, LD, EMSIZE, 256), (B * S * N, LD, EMSIZE, 384),
                  (B * S * N, LD, EMSIZE, 512), (B * S * N, LD, EMSIZE, 1024))
# and held only: the edges of the one block (128 / 129) and of the
# clusters of 2, 4 and 8 (256 / 257, 512 / 513), the old CUDA-core
# kernels' (403 / 404), the forwards' two h tiles (LSTM 224, GRU 160) and
# their 64-row ranks' last width (640; 641 padded to 768 takes 32), 1,000
# (padded to 1,024), an odd E and H, rows off the blocks
F32_TILE_HELD = ((333, 7, EMSIZE, 129), (333, 7, EMSIZE, 160),
                 (333, 7, EMSIZE, 224), (333, 7, EMSIZE, 257),
                 (333, 7, EMSIZE, 403), (333, 7, EMSIZE, 404),
                 (65, 7, 300, 513), (65, 7, 300, 640), (65, 7, 300, 641),
                 (33, 5, 300, 1000), (B * S + 13, LQ, 37, 200))


def f32_tile_gates(lib) -> None:
    """The float32 tiles' gates and routes against the launchers at every
    H to 1,024 (routes to 1,152): kernels 5 and 9's workspace query refuses
    exactly the padded widths whose tiles ``f32_smem_bytes(...,
    backward=True)`` says do not fit, and the forwards' layout
    (``cair_f32_fwd_layout``: shared memory, rows, h tiles) is
    ``f32_smem_bytes`` / ``f32_forward_tiles``' at every padded H."""
    from context_attentive_ir_tpu_torch.ops.kernels.gru import gru_route
    from context_attentive_ir_tpu_torch.ops.kernels.lstm import (
        f32_cluster,
        f32_forward_tiles,
        f32_smem_bytes,
        f32_tile_hidden,
        lstm_route,
        tile_smem_bytes,
    )

    f32 = torch.float32
    rows, ks, tiles = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    moved = []
    for rnn, gates in (("lstm", 4), ("gru", 3)):
        for h in range(1, MAX_F32_TILED + 1):
            hp = f32_tile_hidden(h)
            for e in (37, EMSIZE):
                ep = -(-e // 32) * 32
                held = f32_smem_bytes(e, h, True, gates) > 0
                ws = (lib.cair_lstm_bwd_workspace(40, 3, ep, hp, 2, 0)
                      if rnn == "lstm"
                      else lib.cair_gru_bwd_workspace(40, 3, ep, hp, 2, 0, 0))
                if held != (ws >= 0):
                    moved.append((rnn, "backward", e, h))
            # the forwards at the doc encoder's, the query encoder's and
            # the source's row counts (the rows a block follow them)
            for n_rows in (B * S * N, B * S, B):
                n = lib.cair_f32_fwd_layout(hp, gates, n_rows,
                                            ctypes.byref(rows),
                                            ctypes.byref(ks),
                                            ctypes.byref(tiles))
                m, t = f32_forward_tiles(hp, gates, n_rows)
                want = tile_smem_bytes(32, hp, False, gates, m,
                                       f32_cluster(hp), f32, t)
                if (n != want or n <= 0 or (rows.value, tiles.value) != (m, t)
                        or (n_rows == B * S * N
                            and n != f32_smem_bytes(EMSIZE, h, False, gates))):
                    moved.append((rnn, "forward", h, n_rows))
    log(f"float32 tiles: f32_smem_bytes / f32_forward_tiles equal to the "
        f"launchers' (kernels 5, 9: the workspace query at E = 37, "
        f"{EMSIZE}; kernels 1, 4, 7, 8: cair_f32_fwd_layout's bytes, rows "
        f"and h tiles at {B * S * N}, {B * S} and {B} rows) at every H of "
        f"1 .. {MAX_F32_TILED} (f32_cluster: one block to 128, "
        f"{f32_cluster(256)} ranks to 256, {f32_cluster(512)} to 512, "
        f"{f32_cluster(1024)} to 1,024; the forwards' rows and h tiles at "
        f"128 / 256 / 512 / 1,024 for {B * S * N} rows: "
        f"{[f32_forward_tiles(h) for h in (128, 256, 512, 1024)]}): "
        f"{not moved}")
    if moved:
        raise AssertionError(f"float32 gates differ from the launchers at "
                             f"(rnn, kernel, ...) {moved[:10]}")
    names = ("single", "cluster", "step")
    moved = [h for h in range(1, 1153)
             if any(names[lib.cair_lstm_route(h, 0, k)] != lstm_route(h, f32)
                    for k in (0, 1))
             or names[lib.cair_gru_route(h, 0)] != gru_route(h, f32)]
    log(f"float32 tiles: lstm_route / gru_route equal to the launchers' "
        f"(kernels 1, 4, 5; 7, 8, 9) at every H of 1 .. 1,152: {not moved}")
    if moved:
        raise AssertionError(f"float32 routes differ at H {moved}")


def recompute_bits(gen, rnn: str, h: int) -> None:
    """Kernel 5 (9) fed kernel 4's (8's) boundaries at a time chunk of 1
    and of TIME_CHUNK gives the same bits exactly when its recompute of a
    chunk reproduces the forward's states bit for bit (its reverse pass,
    parked sums and phase B do not depend on the chunk); logs and raises
    otherwise."""
    mod = rnn_kernels(rnn)
    x, mask, w, dout = pair_inputs(gen, rnn, torch.float32, 333, 13, h=h)
    outs = []
    for tc in (1, TIME_CHUNK):
        state = getattr(mod, f"{rnn}_fused_res")(x, mask, *w, False, tc)[1:]
        outs.append(getattr(mod, f"{rnn}_fused_bwd")(x, mask, *w, *state,
                                                    dout, False, tc))
    err = max(float((a - b).abs().max()) for a, b in zip(*outs))
    log(f"{rnn}_fused_bwd float32 [333,13,{x.shape[2]}]->{h} from "
        f"{rnn}_fused_res's boundaries at time chunks 1 and {TIME_CHUNK}: "
        f"the same bits {same_bits(*outs)} (max abs difference {err:.3e})")
    if not same_bits(*outs):
        raise AssertionError(f"{rnn}_fused_bwd's recompute differs from "
                             f"{rnn}_fused_res's states at H = {h}")


def f32bwd_paths(gen, timed_elsewhere=()) -> tuple[dict, list[dict]]:
    """The default dtype's tiles: float32 kernels 1, 4, 5 and 7, 8, 9
    (split TF32) at each of F32_TILE_TIMED held to their plain versions,
    both directions, and timed beside their bound, plain version and
    cuDNN's exact-f32 module -- the forwards at H = 128 (the main shape and
    the source), the backward at every row -- (but the (rnn, H) of
    ``timed_elsewhere``: held there), at F32_TILE_HELD held; their gates
    and routes against the launchers (``f32_tile_gates``); kernels 5 and
    9 recomputing the forwards' bits (``recompute_bits``); then float32
    CARS and CARS-GRU at the serving widths: ``rank_batch`` through
    kernels 1 and 7 and four Adam steps through 4 + 5 and 8 + 9, each
    against the plain scan.  Returns the launches and the timing rows."""
    from context_attentive_ir_tpu_torch.ops.kernels.build import load_library

    f32 = torch.float32
    f32_tile_gates(load_library())
    launches, rows = {}, []
    for rnn in RNNS:
        for h in (NHID, 512):   # one block; a cluster of 4 ranks
            recompute_bits(gen, rnn, h)
        for r, t, e, h in F32_TILE_HELD:
            held_errors("f32 tiles", rnn, *pair_inputs(gen, rnn, f32, r, t,
                                                       e=e, h=h), f32)
        for r, t, e, h in F32_TILE_TIMED:
            if (rnn, h) in timed_elsewhere and (r, t) == (B * S * N, LD):
                held_errors("f32 tiles", rnn, *pair_inputs(
                    gen, rnn, f32, r, t, e=e, h=h), f32)
                continue
            rows.extend(time_rnn(gen, rnn, launches, shape=(r, t),
                                 dtype=f32, iters=2, warmup=1,
                                 bwd_only=h != NHID, e=e, h=h))
            torch.cuda.empty_cache()
    word_dict = synthetic_dictionary(VOCAB)
    # CARS in float32 (the configuration's default) answers beam-5
    # suggestions through the split-TF32 generator (kernel 2p), profiled
    for tag, kw in (("f32", {}), ("f32_gru", GRU)):
        wide_serving(word_dict, full_width_config(
            "cars", compute_dtype="float32", **kw), tag, f32, launches,
            suggest=tag == "f32", profile=True)
        torch.cuda.empty_cache()
    for tag, kw in (("f32bwd", {}), ("f32bwd_gru", GRU)):
        wide_train(full_width_config("cars", compute_dtype="float32", **kw),
                   tag, f32, launches)
        torch.cuda.empty_cache()
    # the default dtype's slate pool: kernel 10's wide route in split
    # TF32 at the rank slate, suggest init's clicked docs and a train step
    cfg = full_width_config("cars", compute_dtype="float32",
                            use_pallas_slate=True)
    params = wide_serving(word_dict, cfg, "f32_slate", f32, launches)
    wide_train(cfg, "f32_slate", f32, launches, params=params)
    del params
    torch.cuda.empty_cache()
    log(f"f32 tiles launches per path: {json.dumps(launches)}")
    return launches, rows


# -- the wide LSTMs: kernels 1, 4, 5 past the single block --------------------

WIDE_NHID = 512      # --nhid 512: bf16 clusters of 2, float32 clusters of 4
WIDE_EMSIZE = 768    # a bf16 embedding past the staged x tile (E <= 480)
WIDE_FIT_SESSIONS = 256
# (H, dtype) of the timed wide kernels at the doc encoder's rows and steps:
# H = 512 and 1,024 in both dtypes, and float32's one block at 256 and 384
WIDE_TIMED = ((512, torch.bfloat16), (1024, torch.bfloat16),
              (512, torch.float32), (1024, torch.float32),
              (256, torch.float32), (384, torch.float32))


def within_tol(path: str, got, want, dtype) -> None:
    """max |got - want| within PAIR_TOL[dtype] of max |want| (the kernels
    against the same model on the plain scan and pool, on the card)."""
    g, w = (np.asarray(v, np.float64) for v in (got, want))
    err = float(np.abs(g - w).max())
    scale = max(float(np.abs(w).max()), 1e-30)
    log(f"{path}: max abs difference from the plain scan and pool {err:.3e} "
        f"(rel {err / scale:.2e}; tol rel {PAIR_TOL[dtype]:g})")
    if not err <= PAIR_TOL[dtype] * scale:
        raise AssertionError(f"{path}: {err} > {PAIR_TOL[dtype]} * {scale} "
                             "from the plain scan and pool")


def plain_config(cfg):
    """``cfg`` on the plain scan and the plain pool: the same model with
    use_pallas_rnn and use_pallas_slate off."""
    return cfg.replace(use_pallas_rnn=False, use_pallas_slate=False)


def wide_serving(word_dict, cfg, tag: str, dtype, launches: dict,
                 suggest: bool = True, rank: bool = True,
                 profile: bool = False) -> dict:
    """``Engine.rank_batch`` (unless not ``rank``) and beam-5
    ``suggest_batch`` (unless not ``suggest``) of ``cfg``, counted, against
    the same weights on the plain scan and pool (``plain_config``); with
    ``profile``, one more call of each profiled (``where_time_goes``).
    Returns those weights
    (``cfg``'s model seeded 0), for ``wide_train``."""
    from context_attentive_ir_tpu_torch.models import build_model
    from context_attentive_ir_tpu_torch.serve import Engine

    params = build_model(cfg, device="cuda", seed=0).state_dict()
    eng, ref = (Engine(c, word_dict, params, beam_size=BEAM, batch_bucket=B)
                for c in (cfg, plain_config(cfg)))
    reqs, hists = requests(np.random.RandomState(16), word_dict, B)
    with torch.inference_mode():
        if rank:
            path = f"rank_batch_{tag}"
            scores, launches[path] = counted(path,
                                             lambda: eng.rank_batch(reqs))
            within_tol(path, scores, ref.rank_batch(reqs), dtype)
            if profile:
                where_time_goes(path, lambda: eng.rank_batch(reqs))
        if not suggest:
            return params
        path = f"suggest_beam5_{tag}"
        sugg, launches[path] = counted(path, lambda: eng.suggest_batch(hists))
        want = ref.suggest_batch(hists)
        if profile:
            where_time_goes(path, lambda: eng.suggest_batch(hists))
    check_suggestions(path, sugg, BEAM)
    within_tol(path + " top-1 scores", [nb[0][1] for nb in sugg],
               [nb[0][1] for nb in want], dtype)
    same = sum(a[0][0] == b[0][0] for a, b in zip(sugg, want))
    log(f"{path}: top-1 suggestions equal to the plain scan's in {same} of "
        f"{B} requests")
    if dtype == torch.float32 and same != B:
        raise AssertionError(f"{path}: float32 suggestions differ from the "
                             "plain scan's")
    return params


def wide_train(cfg, tag: str, dtype, launches: dict, b: int = B,
               fall: str = "last", params: dict | None = None) -> None:
    """Four Adam steps of ``cfg``'s model (CARS on a session batch, HRED-QS
    on a suggestion batch) of ``b`` sessions through the training pair
    (kernels 4 + 5 or 8 + 9; the second step counted) and the same through
    the plain scan, from the same weights (``params``, or ``cfg``'s model
    seeded 0: one seeded init, loaded into both): the losses must fall
    (``fall`` "last": the last below the first; "some": a later one below
    the first) and agree within PAIR_TOL."""
    from context_attentive_ir_tpu_torch.models import build_model
    from context_attentive_ir_tpu_torch.train import (
        create_train_state,
        make_train_step,
    )

    rng = np.random.RandomState(17)
    batch = (random_suggest_batch(rng, b=b) if cfg.model_type == "hredqs"
             else random_session_batch(rng, b=b)).to("cuda")
    path = f"train_step_{tag}"
    losses = {}
    init = (params if params is not None
            else build_model(cfg, device="cuda", seed=0).state_dict())
    for kernel in (True, False):
        c = cfg if kernel else plain_config(cfg)
        model = build_model(c, device="cuda", seed=None)
        model.load_state_dict(init)
        state, step = create_train_state(model, c), make_train_step(model, c)
        out = []
        for i in range(4):
            if kernel and i == 1:
                (state, m), launches[path] = counted(
                    path, lambda: step(state, batch, 1))
            else:
                state, m = step(state, batch, 1)
            out.append(float(m["loss"]))
        losses[kernel] = out
        del model, state, step
    log(f"{path}: 4 Adam steps at B = {b}, losses through the kernels "
        f"{[round(v, 5) for v in losses[True]]}, through the plain scan "
        f"{[round(v, 5) for v in losses[False]]}")
    later = losses[True][-1] if fall == "last" else min(losses[True][1:])
    if not (all(math.isfinite(v) for v in losses[True])
            and later < losses[True][0]):
        raise AssertionError(f"{path}: the loss did not fall")
    within_tol(path + " losses", losses[True], losses[False], dtype)


def wide_fit(files: dict, run_dir: str, launches: dict,
             path: str = "trainer_fit_wide", *extra: str) -> None:
    """``cli.main --model_type cars --nhid 512 --compute_dtype bfloat16``
    (and the arguments ``extra``) on the fixture's first WIDE_FIT_SESSIONS
    sessions, one epoch with beam-5 validation and a test, counted as
    ``path``; then the same with --use_pallas_rnn false: the epoch's train
    loss within PAIR_TOL of it."""
    from context_attentive_ir_tpu_torch.cli.main import main as cli_main

    hist = {}
    for kernel in (True, False):
        argv = fit_args("cars", files, str(Path(run_dir) / str(kernel)),
                        "--train_file", str(files["train"]), "--dev_file",
                        str(files["dev"]), "--num_epochs", "1",
                        "--max_examples", str(WIDE_FIT_SESSIONS), "--nhid",
                        str(WIDE_NHID), *extra,
                        *(() if kernel else ("--use_pallas_rnn", "false")))
        t = time.perf_counter()
        if kernel:
            res, launches[path] = counted(path, lambda: cli_main(argv))
        else:
            res = cli_main(argv)
        h = res["fit"]["history"]
        log(f"{path} ({'kernels' if kernel else 'plain scan'}): "
            f"cli.main --nhid {WIDE_NHID} {' '.join(extra)} bf16, "
            f"{WIDE_FIT_SESSIONS} "
            f"sessions, 1 epoch + test in {time.perf_counter() - t:.1f} s; "
            f"history " + json.dumps([{k: round(v, 4) for k, v in e.items()}
                                      for e in h]) + "; test " + json.dumps(
                {k: round(v, 4) for k, v in res["test"].items()}))
        if not all(math.isfinite(v) for e in h + [res["test"]]
                   for v in e.values()):
            raise AssertionError(f"{path}: non-finite metrics")
        hist[kernel] = h[-1]["train_loss"]
    within_tol(f"{path} train loss", [hist[True]], [hist[False]],
               torch.bfloat16)


def wide_paths(gen, fixture_dir: str) -> tuple[dict, list[dict]]:
    """The slice's path: CARS at the serving widths with nhid 512 in bf16
    and float32 (rank_batch, beam-5 suggest_batch, 4 train steps), cli.main
    at nhid 512 in bf16, a bf16 CARS at emsize 768 (rank_batch), each
    against the same model on the plain scan; then kernels 1, 4, 5 at the
    doc encoder's rows and steps at each of WIDE_TIMED, held to their plain
    versions on the same inputs, both directions, and timed beside cuDNN.
    Returns the launches and the timing rows."""
    word_dict = synthetic_dictionary(VOCAB)
    launches = {}
    for tag, dt in (("wide_bf16", "bfloat16"), ("wide_f32", "float32")):
        dtype = getattr(torch, dt)
        cfg = full_width_config("cars", nhid=WIDE_NHID, compute_dtype=dt)
        params = wide_serving(word_dict, cfg, tag, dtype, launches)
        wide_train(cfg, tag, dtype, launches, params=params)
        # the doc pool 2 * nhid = 1,024 wide on kernel 10's wide route
        slate = cfg.replace(use_pallas_slate=True)
        wide_serving(word_dict, slate, f"{tag}_slate", dtype, launches,
                     suggest=False)
        wide_train(slate, f"{tag}_slate", dtype, launches, b=STEP_TRAIN_B,
                   fall="some", params=params)
        del params
        torch.cuda.empty_cache()
    wide_serving(word_dict, full_width_config("cars", emsize=WIDE_EMSIZE),
                 "e768", torch.bfloat16, launches, suggest=False)
    with tempfile.TemporaryDirectory() as tmp:
        wide_fit(fit_files(fixture_dir), tmp, launches)
    torch.cuda.empty_cache()
    log(f"wide LSTM launches per path: {json.dumps(launches)}")

    rows = []
    for h, dtype in WIDE_TIMED:
        rows.extend(time_rnn(gen, "lstm", launches,
                             shape=(B * S * N, LD), dtype=dtype,
                             iters=3 if dtype == torch.bfloat16 else 1,
                             warmup=1, e=EMSIZE, h=h))
        torch.cuda.empty_cache()
    return launches, rows


# -- the wide GRUs: kernels 7, 8, 9 past the single block --------------------

# HRED-QS at its published width class (about 1,000 units): bf16 clusters
# of 4
WIDEGRU_HRED_NHID = 1024
# (H, dtype) of the timed wide GRU kernels at the doc encoder's rows and
# steps: bf16 clusters of 2 and 4, float32 clusters of 4 and 8
WIDEGRU_TIMED = ((512, torch.bfloat16), (1024, torch.bfloat16),
                 (512, torch.float32), (1024, torch.float32))


def widegru_paths(gen, fixture_dir: str) -> tuple[dict, list[dict]]:
    """The slice's path: CARS with GRU encoders at the serving widths and
    nhid 512 in bf16 and float32 (rank_batch, beam-5 suggest_batch, 4 Adam
    steps), HRED-QS at nhid 1,024 in bf16 (beam-5 suggest_batch, 4 Adam
    steps), cli.main for CARS-GRU at nhid 512 in bf16, each against the
    same model on the plain scan; then kernels 7, 8, 9 at the doc encoder's
    rows and steps at each of WIDEGRU_TIMED, held to their plain versions
    on the same inputs, both directions, and timed beside cuDNN.  Returns
    the launches and the timing rows."""
    word_dict = synthetic_dictionary(VOCAB)
    launches = {}
    for tag, dt in (("widegru_bf16", "bfloat16"), ("widegru_f32", "float32")):
        dtype = getattr(torch, dt)
        cfg = full_width_config("cars", nhid=WIDE_NHID, compute_dtype=dt,
                                **GRU)
        wide_serving(word_dict, cfg, tag, dtype, launches)
        wide_train(cfg, tag, dtype, launches)
        torch.cuda.empty_cache()
    cfg = full_width_config("hredqs", nhid=WIDEGRU_HRED_NHID, **GRU)
    wide_serving(word_dict, cfg, "hredqs_1024", torch.bfloat16, launches,
                 rank=False)
    wide_train(cfg, "hredqs_1024", torch.bfloat16, launches)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        wide_fit(fit_files(fixture_dir), tmp, launches, "trainer_fit_widegru",
                 "--rnn_type", "gru", "--session_rnn_type", "gru")
    torch.cuda.empty_cache()
    log(f"wide GRU launches per path: {json.dumps(launches)}")

    rows = []
    for h, dtype in WIDEGRU_TIMED:
        rows.extend(time_rnn(gen, "gru", launches,
                             shape=(B * S * N, LD), dtype=dtype,
                             iters=3 if dtype == torch.bfloat16 else 1,
                             warmup=1, e=EMSIZE, h=h))
        torch.cuda.empty_cache()
    return launches, rows


# -- the step route: kernels 1, 4, 5 past H = 1,024, kernel 6 past 512 --------

def step_recurrence_rows(gen, launches: dict) -> list[dict]:
    """Kernel 6 on the step route at x_proj [B*S*N, Ld, 4H] for each of
    STEP_REC: both directions counted as ``lstm_precomputed_<H>_<dtype>``
    (a ``torch.matmul`` projection before each), each held to its plain
    version (f32 1e-4 abs, bf16 2e-2 rel.; masked outputs 0) and to kernel
    1 on the same weights (bf16, which reads x_proj rounded: max 2e-2 abs,
    mean 5e-4, as lstm_precomputed; f32 1e-4 abs), then timed beside the
    plain version.  No single PyTorch call runs an LSTM from precomputed
    gates: library_ms null."""
    from context_attentive_ir_tpu_torch.ops.kernels.lstm import (
        lstm_fused,
        lstm_recurrence,
        lstm_recurrence_fwd,
        lstm_recurrence_reference,
    )

    rows_out = []
    for h, dtype in STEP_REC:
        dt = str(dtype)[6:]
        (x, w_ih, b, w_hh), mask = lstm_inputs(gen, dtype, h=h)
        xp = (torch.matmul(x, w_ih) + b).contiguous()
        path = f"lstm_precomputed_{h}_{dt}"
        with torch.inference_mode():
            outs, launches[path] = counted(path, lambda: [
                lstm_recurrence(xp, mask, w_hh, rev) for rev in (False, True)])
            worst = worst_rel = 0.0
            for reverse, got in zip((False, True), outs):
                ref = lstm_recurrence_reference(xp, mask, w_hh, reverse)
                if not bool((got[~mask] == 0).all()):
                    raise AssertionError(f"{path}: masked outputs not zero")
                err = float((got.float() - ref.float()).abs().max())
                worst = max(worst, err)
                worst_rel = max(worst_rel, err / float(ref.float().abs().max()))
                del ref
                k1 = lstm_fused(x, mask, w_ih, b, w_hh, reverse).float()
                diff = (got.float() - k1).abs()
                d_max, d_mean = float(diff.max()), float(diff.mean())
                del k1, diff
                tol_k1 = (2e-2, 5e-4) if dtype == torch.bfloat16 else (1e-4,
                                                                        1e-4)
                log(f"{path} reverse={reverse}: vs kernel 1 on the same "
                    f"weights max abs diff {d_max:.3e} (tol {tol_k1[0]:g}), "
                    f"mean {d_mean:.3e} (tol {tol_k1[1]:g})")
                if not (d_max <= tol_k1[0] and d_mean <= tol_k1[1]):
                    raise AssertionError(f"{path}: disagrees with kernel 1")
            del outs
            tol = 1e-4 if dtype == torch.float32 else 2e-2
            held = worst if dtype == torch.float32 else worst_rel
            log(f"lstm_recurrence {dt} [{xp.shape[0]},{LD},{4 * h}]->{h} "
                f"both directions: max abs err {worst:.3e}, max rel err "
                f"{worst_rel:.3e} (tol {'abs' if dtype == torch.float32 else 'rel'} "
                f"{tol:g}; masked outputs 0)")
            if not held <= tol:
                raise AssertionError(f"{path}: error {held} > {tol}")
            ms = timed_ms(lambda: lstm_recurrence_fwd(xp, mask, w_hh), 3,
                          warmup=1)
            plain = timed_ms(lambda: lstm_recurrence_reference(xp, mask,
                                                               w_hh), 1,
                             warmup=1)
        rows, steps = xp.shape[:2]
        flops = 2.0 * rows * steps * h * 4 * h
        n_bytes = ((xp.numel() + rows * steps * h + w_hh.numel())
                   * xp.element_size() + mask.numel())
        bnd, by = bound_ms(flops, n_bytes, dtype)
        log(f"lstm_recurrence {dt} [{rows},{steps},{4 * h}]->{h} one "
            f"direction (step route): kernel {ms:.3f} ms, plain {plain:.3f} "
            f"ms, library none, bound {bnd:.4f} ms ({by})")
        rows_out.append(kernel_row("lstm_recurrence", "lstm_step.cu",
                                   "lstm.py:129", launches, worst, ms, plain,
                                   None, bnd, by, rows=rows, steps=steps,
                                   h=h, dtype=dt))
        del x, w_ih, b, w_hh, mask, xp
        torch.cuda.empty_cache()
    return rows_out


def widestep_paths(gen) -> tuple[dict, list[dict]]:
    """The slice's path: CARS at the serving widths with nhid 2,048 in bf16
    (rank_batch and beam-5 suggest_batch at B = 64) and 1,152 in float32
    (rank_batch), and 4 Adam steps each at STEP_TRAIN_B sessions, against
    the same model on the plain scan; then kernels 1, 4, 5 alone at each of
    STEP_TIMED, held to their plain versions on the same inputs, both
    directions, and timed beside cuDNN; then kernel 6 alone
    (step_recurrence_rows).  Returns the launches and the timing rows."""
    word_dict = synthetic_dictionary(VOCAB)
    launches = {}
    t0 = time.perf_counter()

    def lap(what: str) -> None:
        nonlocal t0
        torch.cuda.synchronize()
        log(f"widestep {what}: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()

    for dtype, tag in ((torch.bfloat16, "step_bf16"),
                       (torch.float32, "step_f32")):
        cfg = full_width_config("cars", nhid=STEP_NHID[dtype],
                                compute_dtype=str(dtype)[6:])
        params = wide_serving(word_dict, cfg, tag, dtype, launches,
                              suggest=dtype == torch.bfloat16)
        torch.cuda.empty_cache()
        lap(f"serving {tag}")
        log(f"train_step_{tag} at B = {STEP_TRAIN_B} sessions: at B = {B} "
            "the plain scan's autograd would keep about 5 f32 planes of "
            "[16,000, 8,192] a step, about 79 GB a direction over 30 steps")
        # float32 at nhid 1,152: Adam's fourth step at the default learning
        # rate raises the loss on these 8 sessions, through the plain scan
        # to the same digits, so a later step below the first is asked
        wide_train(cfg, tag, dtype, launches, b=STEP_TRAIN_B,
                   fall="last" if dtype == torch.bfloat16 else "some",
                   params=params)
        del params
        torch.cuda.empty_cache()
        lap(f"train {tag}")
    log(f"step route launches per path: {json.dumps(launches)}")

    rows = []
    for h, dtype, n_rows, steps, iters in STEP_TIMED:
        rows.extend(time_rnn(gen, "lstm", launches, shape=(n_rows, steps),
                             dtype=dtype, iters=iters, warmup=1,
                             sources=("lstm_step.cu",) * 3, e=EMSIZE, h=h))
        torch.cuda.empty_cache()
        lap(f"kernels 1, 4, 5 at [{n_rows}, {steps}] -> {h} "
            f"{str(dtype)[6:]}")
    rows.extend(step_recurrence_rows(gen, launches))
    lap("kernel 6")
    return launches, rows


# -- CARS-GRU past the clusters, with the slate kernel (widegrustep) ---------

def wide_pool_rows(gen, launches: dict) -> list[dict]:
    """Kernel 10's wide route alone at each of WIDE_POOL_TIMED, counted as
    ``attn_pool_<rows>_<H>_<dtype>``, held to ``attn_pool_reference`` run
    in f32 on the same inputs (f32 1e-4 abs, bf16 2e-2 rel.; fully masked
    rows exactly 0), then timed beside the plain version; then the same
    at H = 1,024, R = B*S*C, bf16.  No single PyTorch call computes this
    pool: library_ms null."""
    from context_attentive_ir_tpu_torch.ops.kernels.slate import (
        attn_pool,
        attn_pool_reference,
    )

    rows_out = []
    for n_rows, h, dtype in (*WIDE_POOL_TIMED,
                             (B * S * MAX_CLICKS, 1024, torch.bfloat16)):
        dt = str(dtype)[6:]
        (s, q, w, b), mask = slate_inputs(gen, dtype, n_rows, LD, h)
        path = f"attn_pool_{n_rows}_{h}_{dt}"
        with torch.inference_mode():
            got, launches[path] = counted(
                path, lambda: attn_pool(s, mask, q, w, b))
            ref = attn_pool_reference(s.float(), mask, q.float(), w.float(),
                                      b.float())
            err = float((got.float() - ref).abs().max())
            rel = err / float(ref.abs().max())
            zeros = bool((got[~mask.any(-1)] == 0).all())
            del got, ref
            tol = 1e-4 if dtype == torch.float32 else 2e-2
            held = err if dtype == torch.float32 else rel
            log(f"attn_pool {dt} [{n_rows},{LD},{h}] (wide route): max abs "
                f"err {err:.3e} (rel {rel:.3e}; tol "
                f"{'abs' if dtype == torch.float32 else 'rel'} {tol:g}); "
                f"fully masked rows exactly 0: {zeros}")
            if not (held <= tol and zeros):
                raise AssertionError(f"{path} disagrees")
            ms = timed_ms(lambda: attn_pool(s, mask, q, w, b), 3, warmup=1)
            plain = timed_ms(lambda: attn_pool_reference(s, mask, q, w, b),
                             1, warmup=1)
        size = s.element_size()
        flops = 2.0 * n_rows * LD * h * h + 4.0 * n_rows * LD * h
        n_bytes = ((s.numel() + q.numel() + w.numel() + b.numel()
                    + n_rows * h) * size + mask.numel())
        bnd, by = bound_ms(flops, n_bytes, dtype)
        log(f"attn_pool {dt} [{n_rows},{LD},{h}] (wide route): kernel "
            f"{ms:.3f} ms, plain {plain:.3f} ms, library none, bound {bnd:.4f} ms "
            f"({by})")
        rows_out.append(kernel_row(
            "attn_pool", "slate_pool.cu", "slate.py:158", launches, err, ms,
            plain, None, bnd, by, rows=n_rows, steps=LD, h=h, dtype=dt,
            wide=True))
        del s, q, w, b, mask
        torch.cuda.empty_cache()
    return rows_out


def widegrustep_paths(gen) -> tuple[dict, list[dict]]:
    """The slice's path: CARS-GRU at the serving widths with nhid 1,152 and
    the slate kernel (use_pallas_slate), in bf16 (rank_batch and beam-5
    suggest_batch at B = 64) and float32 (rank_batch), and 4 Adam steps of
    each at STEP_TRAIN_B sessions, against the same model on the plain scan
    and pool; then kernels 7, 8, 9 alone at each of WIDEGRUSTEP_TIMED, held
    to their plain versions on the same inputs, both directions, and timed
    beside cuDNN; then kernel 10's wide route alone (wide_pool_rows).
    Returns the launches and the timing rows."""
    word_dict = synthetic_dictionary(VOCAB)
    launches = {}
    t0 = time.perf_counter()

    def lap(what: str) -> None:
        nonlocal t0
        torch.cuda.synchronize()
        log(f"widegrustep {what}: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()

    for dtype, tag in ((torch.bfloat16, "widegrustep_bf16"),
                       (torch.float32, "widegrustep_f32")):
        cfg = full_width_config("cars", nhid=WIDEGRUSTEP_NHID,
                                compute_dtype=str(dtype)[6:],
                                use_pallas_slate=True, **GRU)
        params = wide_serving(word_dict, cfg, tag, dtype, launches,
                              suggest=dtype == torch.bfloat16)
        torch.cuda.empty_cache()
        lap(f"serving {tag}")
        # Adam's fourth step at the default learning rate may raise the
        # loss on these 8 sessions (widestep's float32 CARS did, through
        # the plain scan to the same digits): a later step below the first
        wide_train(cfg, tag, dtype, launches, b=STEP_TRAIN_B, fall="some",
                   params=params)
        del params
        torch.cuda.empty_cache()
        lap(f"train {tag}")
    log(f"widegrustep launches per path: {json.dumps(launches)}")

    rows = []
    for h, dtype, iters in WIDEGRUSTEP_TIMED:
        rows.extend(time_rnn(gen, "gru", launches, shape=(B * S * N, LD),
                             dtype=dtype, iters=iters, warmup=1,
                             sources=("lstm_step.cu",) * 3, e=EMSIZE, h=h))
        torch.cuda.empty_cache()
        lap(f"kernels 7, 8, 9 at [{B * S * N}, {LD}] -> {h} "
            f"{str(dtype)[6:]}")
    rows.extend(wide_pool_rows(gen, launches))
    lap("kernel 10")
    return launches, rows


# -- the generator past top-32 and one x tile (widebeam) ---------------------

WIDEBEAM_EMSIZE = 1536   # past every kernel's whole x tile (bf16 kernel 2: 1,264)
# (step, rows, E, kc) of the generator kernels timed alone: the beam-40
# and beam-127 steps at the serving widths, the beam-5 step past one x
# tile, and a sweep of kc past one slot at a row count off the 64-row block
WIDEBEAM_SHAPES = (("beam-40", B * S * 40, EMSIZE, 41),
                   ("beam-127", B * S * 127, EMSIZE, 128),
                   ("beam-5", B * S * BEAM, WIDEBEAM_EMSIZE, BEAM + 1),
                   ("beam-5", B * S * BEAM, 2048, BEAM + 1),
                   *(("kc sweep", B * S * BEAM + 5, EMSIZE, kc)
                     for kc in (33, 64, 127, 128)))


class logits_step:
    """Within it, an ``Engine`` decodes through the model's logits step
    (``beam_search`` over ``model.decode_step``), or with a shortlist the
    shortlist's plain step on the gathered columns: the reference of a
    fused decode on the same weights.  ``make_fused_beam_step`` is patched
    in ``serve`` to give way."""

    def __enter__(self):
        from context_attentive_ir_tpu_torch import serve
        from context_attentive_ir_tpu_torch.decode import (
            make_shortlist_xla_step,
        )

        self.orig = serve.make_fused_beam_step

        def plain(model, memory, memory_mask, kc, dtype=torch.bfloat16,
                  shortlist=None, **_):
            if shortlist is None:
                return None
            return make_shortlist_xla_step(model, memory, memory_mask, kc,
                                           dtype, shortlist)

        serve.make_fused_beam_step = plain
        return self

    def __exit__(self, *exc):
        from context_attentive_ir_tpu_torch import serve

        serve.make_fused_beam_step = self.orig


def nbest_scores_within(path: str, got, want, dtype) -> None:
    """Each request's n-best scores, best first, rank by rank within
    PAIR_TOL[dtype] of the reference's largest |score|, over the
    reference's real hypotheses (above NEG_INF); the lists as long."""
    worst, scale, real = 0.0, 1e-30, 0
    for nb_g, nb_w in zip(got, want):
        g = sorted((sc for _, sc in nb_g), reverse=True)
        w = sorted((sc for _, sc in nb_w), reverse=True)
        if len(g) != len(w):
            raise AssertionError(f"{path}: n-best of {len(g)}, not "
                                 f"{len(w)}")
        for a, b in zip(g, w):
            if b > -1e8:
                real += 1
                worst = max(worst, abs(a - b))
                scale = max(scale, abs(b))
    same = sum(a[0][0] == b[0][0] for a, b in zip(got, want))
    log(f"{path}: {real} real hypotheses, n-best scores max abs difference "
        f"from the logits step {worst:.3e} (rel {worst / scale:.2e}; tol "
        f"rel {PAIR_TOL[dtype]:g}); top-1 text equal in {same} of "
        f"{len(want)} requests")
    if not worst <= PAIR_TOL[dtype] * scale:
        raise AssertionError(f"{path}: n-best scores off the logits step's")


def widebeam_engines(launches: dict) -> None:
    """CARS at the serving widths (bf16, seeded weights) behind ``Engine``:
    beam-40 and beam-127 ``suggest_batch`` on the float table and on the
    int8 table, beam 40 with a 4,096-id shortlist; then CARS at emsize
    1,536 (x streamed in every generator kernel): beam-5 and greedy
    ``suggest_batch`` and one beam-5 decode through the pipelined kernel 3
    (the pruned serial kernel's bits), the first step's log-probabilities
    of both steps (``first_step_rounding``), and beam 5 in float32.  Each
    counted run is held to the same weights through the logits step
    (``nbest_scores_within``, at PAIR_TOL of the run's dtype)."""
    from context_attentive_ir_tpu_torch.decode import (
        beam_search,
        make_fused_beam_step,
    )
    from context_attentive_ir_tpu_torch.models.multitask.cars import CARS
    from context_attentive_ir_tpu_torch.serve import (
        Engine,
        quantize_embedding_params,
    )

    word_dict = synthetic_dictionary(VOCAB)
    _, hists = requests(np.random.RandomState(18), word_dict, B)
    cfg = full_width_config("cars")
    params = CARS(cfg, device="cuda", seed=0).state_dict()
    q_cfg = cfg.replace(quantize_embeddings=True)
    q_params = quantize_embedding_params(params)

    def run(path, eng, beam, dtype=torch.bfloat16):
        t = time.perf_counter()
        with torch.inference_mode():
            out, launches[path] = counted(path,
                                          lambda: eng.suggest_batch(hists))
            first = (time.perf_counter() - t) * 1e3
            with logits_step():
                want = eng.suggest_batch(hists)
        log(f"{path}: launches {json.dumps(launches[path])}, first-call "
            f"wall {first:.1f} ms")
        check_suggestions(path, out, beam)
        nbest_scores_within(path, out, want, dtype)
        return out

    for beam in WIDEBEAMS:
        for tag, c, p in (("wide", cfg, params), ("wide_int8", q_cfg,
                                                   q_params)):
            run(f"suggest_beam{beam}_{tag}",
                Engine(c, word_dict, p, beam_size=beam, batch_bucket=B), beam)
            torch.cuda.empty_cache()
    run("suggest_beam40_wide_shortlist",
        Engine(cfg, word_dict, params, beam_size=40, batch_bucket=B,
               suggest_shortlist=SHORTLIST), 40)
    del params, q_params
    torch.cuda.empty_cache()

    cfg = full_width_config("cars", emsize=WIDEBEAM_EMSIZE)
    params = CARS(cfg, device="cuda", seed=0).state_dict()
    eng = Engine(cfg, word_dict, params, beam_size=BEAM, batch_bucket=B)
    greedy = Engine(cfg, word_dict, params, beam_size=1, batch_bucket=B)
    run("suggest_beam5_e1536", eng, BEAM)
    run("suggest_greedy_e1536", greedy, 1)
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

    with torch.inference_mode():
        piped, launches["decode_pipelined_e1536"] = counted(
            "decode_pipelined_e1536", lambda: decode(pipeline=True))
        serial = decode(prune=True)
    same = all(torch.equal(a, b) for a, b in zip(piped, serial))
    log(f"decode_pipelined_e1536: launches "
        f"{json.dumps(launches['decode_pipelined_e1536'])}; tokens and "
        f"scores equal to the pruned serial kernel's: {same}")
    if not same:
        raise AssertionError("kernel 3 at E=1536 differs from kernel 2")
    first_step_rounding(model, batch)
    del eng, greedy, params, model
    torch.cuda.empty_cache()

    cfg = full_width_config("cars", emsize=WIDEBEAM_EMSIZE,
                            compute_dtype="float32")
    params = CARS(cfg, device="cuda", seed=0).state_dict()
    run("suggest_beam5_e1536_f32",
        Engine(cfg, word_dict, params, beam_size=BEAM, batch_bucket=B), BEAM,
        torch.float32)
    del params
    torch.cuda.empty_cache()


def first_step_rounding(model, batch) -> None:
    """The first decode step of ``batch`` (BOS from the init state) both
    ways: the top-2 log-probabilities of the fused step (the kernel's f32
    sums) against the logits step's (its bf16 logits, then log_softmax in
    float32), beside the bf16 rounding step at the largest |logit|: the
    cause of the bf16 Engines' n-best differences."""
    from context_attentive_ir_tpu_torch.constants import BOS
    from context_attentive_ir_tpu_torch.decode import make_fused_beam_step

    with torch.inference_mode():
        state, memory, mask = model.decode_init(batch)
        tokens = torch.full((memory.shape[0],), BOS, dtype=torch.long,
                            device=memory.device)
        _, logits, _ = model.decode_step(state, tokens, memory, mask)
        step = make_fused_beam_step(model, memory, mask, 2, torch.bfloat16)
        _, (vals, idx, lse) = step(state, tokens)
        plain = logits.float()
        plain = (plain.gather(1, idx.long())
                 - torch.logsumexp(plain, -1, keepdim=True))
        fused = vals - lse[:, None]
        top = float(logits.float().abs().max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    log(f"first decode step at emsize {WIDEBEAM_EMSIZE}: logits step "
        f"{logits.dtype}, largest |logit| {top:.4g} (bf16 step there "
        f"{ulp:.3g}); top-2 log-probabilities of the fused step (f32 sums) "
        f"off the logits step's by up to "
        f"{float((plain - fused).abs().max()):.3e}, the top-2 gap under "
        f"{ulp:.3g} in {int(((fused[:, 0] - fused[:, 1]) < ulp).sum())} "
        f"of {fused.shape[0]} rows")


def widebeam_kernels(gen, launches: dict) -> list[dict]:
    """Kernels 2, 2p, 2q (int8 table) and 3 alone at
    ``WIDEBEAM_SHAPES`` in bfloat16 and float32: each mode held to its
    plain version (``hold``) on integer data (vals and idx exact) and on
    random data, every mode of one table giving the same bits, then timed
    beside the plain version and the library call (matmul + logsumexp +
    topk, a yardstick only).  Returns the timing rows."""
    from context_attentive_ir_tpu_torch.ops.kernels.beamgen import (
        beamgen_streams_x,
        generator_topk_lse,
        generator_topk_lse_reference,
    )

    names = {"serial": "generator_topk_lse",
             "pruned": "generator_topk_lse_pruned",
             "int8": "generator_topk_lse_int8",
             "pipelined": "generator_topk_lse_pipelined"}
    rows_out = []
    for step, rows, e, kc in WIDEBEAM_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            errs = {}
            for data in ("integer", "random"):
                integer = data == "integer"
                x, tt, _ = (beamgen_integer_case(gen, rows, e, VOCAB, dtype,
                                                 False) if integer else
                            (*beamgen_inputs(gen, rows, dtype, False, e),
                             None))
                outs = {}
                for mode, kw in GEN_MODES:
                    if mode == "int8":
                        continue
                    outs[mode] = generator_topk_lse(x, tt, kc, **kw)
                name = (f"generator_topk_lse {step} R={rows} E={e} kc={kc} "
                        f"{dtype} {data}")
                errs["serial"] = hold(name, outs["serial"], x, tt, kc,
                                      integer)
                same = all(same_bits(outs["serial"], o)
                           for o in outs.values())
                log(f"{name}: serial = pruned = pipelined, same bits: {same}")
                if not same:
                    raise AssertionError(f"{name}: the modes differ")
                errs["pruned"] = errs["pipelined"] = errs["serial"]
                del outs
                xq, q_t, scale = (
                    beamgen_integer_case(gen, rows, e, VOCAB, dtype, True)
                    if integer else int8_inputs(gen, rows, dtype, False, e))
                base = generator_topk_lse(xq, q_t, kc, scale=scale)
                pruned = generator_topk_lse(xq, q_t, kc, scale=scale,
                                            prune=True)
                errs["int8"] = hold(f"{name} int8", base, xq, q_t, kc,
                                    integer, scale)
                if not same_bits(base, pruned):
                    raise AssertionError(f"{name} int8: prune changes "
                                         "the bits")
                del base, pruned, xq, q_t
                torch.cuda.empty_cache()
            # timing on the random data of the last pass
            x, tt = beamgen_inputs(gen, rows, dtype, False, e)
            size = 2 if dtype == torch.bfloat16 else 4
            flops = 2.0 * rows * e * VOCAB
            out_bytes = rows * (kc * 8 + 4)
            big = rows * VOCAB > 2e8
            plain = timed_ms(lambda: generator_topk_lse_reference(x, tt, kc),
                             1 if big else 3, 1)

            def library(table, scl=None):
                logits = torch.matmul(x, table)
                if scl is not None:
                    logits = logits * scl
                return (torch.logsumexp(logits.float(), -1),
                        torch.topk(logits, kc))

            lib = timed_ms(lambda: library(tt), 2 if big else 5, 1)
            for mode, kw in GEN_MODES:
                if mode == "int8":
                    _, q_t, scale = int8_inputs(gen, 1, dtype, False, e)
                    table, kw = q_t, {"scale": scale, "prune": True}
                    n_bytes = x.numel() * size + q_t.numel() + VOCAB * 4
                    q_bf16 = q_t.to(dtype)
                    lib_ms = timed_ms(lambda: library(q_bf16,
                                                      scale.to(dtype)),
                                      2 if big else 5, 1)
                else:
                    table = tt
                    n_bytes = (x.numel() + tt.numel()) * size
                    lib_ms = lib
                ms = timed_ms(lambda: generator_topk_lse(x, table, kc, **kw),
                              2 if big else 5, 1)
                bnd, by = bound_ms(flops, n_bytes + out_bytes, dtype)
                log(f"generator_topk_lse {mode} {step} {dtype} R={rows} "
                    f"E={e} V={VOCAB} kc={kc} (x "
                    f"{'streamed' if beamgen_streams_x(e, dtype, mode == 'pipelined') else 'whole'}"
                    f"): kernel {ms:.3f} ms, plain {plain:.3f} ms, library "
                    f"{lib_ms:.3f} ms, bound {bnd:.4f} ms ({by})")
                rows_out.append(kernel_row(
                    names[mode], "beamgen.cu", "beamgen.py:286", launches,
                    errs[mode], ms, plain, lib_ms, bnd, by, step=step,
                    rows=rows, e=e, kc=kc, dtype=str(dtype).split(".")[-1]))
            del x, tt
            torch.cuda.empty_cache()
    return rows_out


def widebeam_paths(gen) -> tuple[dict, list[dict]]:
    """The slice's path: ``widebeam_engines``, then ``widebeam_kernels``.
    Returns the launches and the timing rows."""
    launches = {}
    widebeam_engines(launches)
    log(f"widebeam launches per path: {json.dumps(launches)}")
    return launches, widebeam_kernels(gen, launches)


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
    log_earlier("lstm_recurrence", ms, plain, None, bnd)
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


SLATE_TIMED_ROWS = (B * S * N, B * S * MAX_CLICKS)
SLATE_ROUNDS = 3   # alternating kernel / plain rounds a shape


def time_slate(gen, launches: dict, max_err: dict) -> list[dict]:
    """Kernel 10 at every width to 1,024 (TILED_POOLS), in both dtypes, at
    the rank slate (R = B*S*N) and suggest init's clicked docs (R = B*S*C),
    T = Ld: the kernel on its route and the plain version, timed in
    SLATE_ROUNDS alternating rounds (the median and the range logged), the
    wide route forced (``wide=True``) where the route is the resident
    kernel's, and the bound, beside the parent's time (EARLIER_MS; logged,
    not measured in this run).  The bf16 rows at H2 and the float32 row at
    the rank slate's shape go into the kernels line with their medians
    (``max_err``: each dtype's error there).  No single PyTorch call
    computes this pool, so library_ms is null."""
    from context_attentive_ir_tpu_torch.ops.kernels.slate import (
        attn_pool,
        attn_pool_reference,
        pool_route,
    )

    def spread(v):
        return f"{np.median(v):.3f} ms ({min(v):.3f}-{max(v):.3f})"

    rows_out = []
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype)[6:]
        for h in TILED_POOLS:
            for rows in SLATE_TIMED_ROWS:
                (s, q, w, b), mask = slate_inputs(gen, dtype, rows, LD, h)
                flops = 2.0 * rows * LD * h * h + 4.0 * rows * LD * h
                iters = max(2, min(20, int(4e11 / flops)))
                route = pool_route(h, LD, dtype)
                kernel, plain = [], []
                for _ in range(SLATE_ROUNDS):
                    kernel.append(timed_ms(
                        lambda: attn_pool(s, mask, q, w, b), iters))
                    plain.append(timed_ms(
                        lambda: attn_pool_reference(s, mask, q, w, b),
                        max(1, iters // 2)))
                ms, plain_ms = float(np.median(kernel)), float(np.median(plain))
                extra = {}
                if route != "wide":
                    extra["wide_ms"] = timed_ms(
                        lambda: attn_pool(s, mask, q, w, b, wide=True), iters)
                n_bytes = ((s.numel() + q.numel() + w.numel() + b.numel()
                            + rows * h) * s.element_size() + mask.numel())
                bnd, by = bound_ms(flops, n_bytes, dtype)
                earlier = EARLIER_MS["attn_pool"].get((dt, h, rows))
                log(f"attn_pool {dt} [{rows},{LD},{h}] ({route}): kernel "
                    f"{spread(kernel)}, plain {spread(plain)}"
                    + (f", the wide route forced {extra['wide_ms']:.3f} ms"
                       if extra else "")
                    + f", library none (no single PyTorch call), bound "
                    f"{bnd:.4f} ms ({by}); {ms / plain_ms:.2f} x plain, "
                    f"{ms / bnd:.1f} x its bound; the parent's "
                    + ("not taken" if earlier is None else
                       f"{earlier:.3f} ms (not this run: an H100 80GB HBM3 "
                       f"at 700 W), {earlier / ms:.2f} x this"))
                if h == H2 and (dtype == torch.bfloat16 or rows == B * S * N):
                    rows_out.append(kernel_row(
                        "attn_pool", "slate_pool.cu", "slate.py:158",
                        launches, max_err[dtype], ms, plain_ms, None, bnd, by,
                        rows=rows, steps=LD, h=h, dtype=dt, **extra))
                del s, q, w, b, mask
                torch.cuda.empty_cache()
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
            EMSIZE, g_kc, 1, t_code, int("prune" in kw), int("pipeline" in kw),
            ctypes.byref(resident))
        blocks = resident.value
        # every mode is split as the serial kernel's residency gives
        slots = _sm_count(0) * _blocks_per_sm(0, EMSIZE, 1, t_code)
        log(f"generator_topk_lse {name} bf16: greedy R={g_rows} kc={g_kc} "
            f"{ms:.3f} ms; {blocks} block(s) an SM, splits (n, tiles) at "
            f"R={rows}: {vocab_splits(rows, VOCAB, slots)}, at R={g_rows}: "
            f"{vocab_splits(g_rows, VOCAB, slots)}")
    return rows_out


def time_beamgen_f32(gen, launches: dict, max_err: dict,
                     int8_err: dict) -> list[dict]:
    """Kernels 2, 2p, 2q and 3 on float32 x (split TF32) at the beam-5
    (R = 1600, kc = 6) and greedy (R = 320, kc = 2) steps: kernel, plain
    version and library call (f32 matmul with TF32 off + logsumexp +
    topk; for int8 the matmul on the float-cast int8 table, times the
    scale), the bound at split TF32's 165 TFLOP/s.  The max abs errors are
    the beam-5 step's, of ``check_beamgen`` / ``check_beamgen_modes``."""
    from context_attentive_ir_tpu_torch.ops.kernels.beamgen import (
        generator_topk_lse,
        generator_topk_lse_reference,
    )

    f32 = torch.float32
    rows_out = []
    for step, rows, kc in (("beam-5", B * S * BEAM, BEAM + 1),
                           ("greedy", B * S, 2)):
        x, tt = beamgen_inputs(gen, rows, f32, integer=False)
        _, q_t, scale = int8_inputs(gen, rows, f32, integer=False)
        flops = 2.0 * rows * EMSIZE * VOCAB
        out_bytes = rows * (kc * 8 + 4)

        def library(table, scl=None):
            logits = torch.matmul(x, table)
            if scl is not None:
                logits = logits * scl
            return torch.logsumexp(logits, -1), torch.topk(logits, kc)

        lib = timed_ms(lambda: library(tt), 10)
        q_f32 = q_t.float()
        lib_q = timed_ms(lambda: library(q_f32, scale), 10)
        for name, kw, table in (
                ("generator_topk_lse", {}, tt),
                ("generator_topk_lse_pruned", {"prune": True}, tt),
                ("generator_topk_lse_int8", {"scale": scale, "prune": True},
                 q_t),
                ("generator_topk_lse_pipelined", {"pipeline": True}, tt)):
            int8 = "scale" in kw
            ms = timed_ms(lambda: generator_topk_lse(x, table, kc, **kw), 10)
            plain = timed_ms(lambda: generator_topk_lse_reference(
                x, table, kc, kw.get("scale")), 5)
            n_bytes = (x.numel() * 4 + q_t.numel() + scale.numel() * 4
                       if int8 else (x.numel() + tt.numel()) * 4)
            bnd, by = bound_ms(flops, n_bytes + out_bytes, f32)
            lib_ms = lib_q if int8 else lib
            log(f"{name} float32 (split TF32) {step} R={rows} E={EMSIZE} "
                f"V={VOCAB} kc={kc}: kernel {ms:.3f} ms, plain {plain:.3f} "
                f"ms, library {lib_ms:.3f} ms, bound {bnd:.4f} ms ({by}); "
                f"{ms / lib_ms:.2f} x the library call")
            err = (int8_err if int8 else max_err)[f32]
            rows_out.append(kernel_row(
                name, "beamgen.cu", "beamgen.py:286", launches, err, ms,
                plain, lib_ms, bnd, by, step=step, rows=rows, e=EMSIZE,
                kc=kc, dtype="float32"))
        del x, tt, q_t, q_f32
        torch.cuda.empty_cache()
    return rows_out


def log_earlier(name: str, ms: float, plain: float, lib, bnd: float) -> None:
    """Log a redesigned kernel's time beside its last CUDA-core version's
    (for the log only: EARLIER_MS was not measured in this run)."""
    earlier = EARLIER_MS.get(name)
    if earlier is not None:
        log(f"{name}: {ms:.3f} ms "
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


# -- the parallel phase: data parallelism over a device mesh -----------------

MESH_STEPS = 4          # Adam steps sharded against the same unsharded
MESH_CORPUS = 4_000     # documents of the sharded index
MESH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# float32 parameters after one Adam step from the same state, at an
# element whose gradient stands clear of rounding noise (NOISE_TAU)
PARAM_TOL = 1e-6
# the whole-batch gradient reduced on the primary against the single one,
# every element, relative to the single gradient's largest element
GRAD_TOL = 1e-5
# An element of the single run's gradient below NOISE_TAU times its
# largest element (over the model) is rounding noise, decided from the
# single run alone: a sum that cancels far below its terms (the listwise
# loss does not change when every score of a slate shifts by one
# constant, so the score bias's gradient is 0 up to rounding).  Adam
# divides a gradient by its own size, so two summation orders can move
# such an element by up to lr each, opposite ways: a noise element is
# held to 2 lr, and at most NOISE_SHARE of a leaf's elements may use that
# bound, unless the leaf's whole gradient is noise.  The score MLP's first
# bias cancels the same way at a unit active on every document of a slate:
# in one H100 step 27 of its 256 elements (10.5 %) used the bound, the
# largest share of any leaf, and 521 of 66,436,100 element updates in all
# over the 4 steps.
NOISE_TAU = 1e-3
NOISE_SHARE = 0.25
TAUS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2)   # logged beside NOISE_TAU


def mesh_train(name: str, mesh, dtype: str) -> dict:
    """MESH_STEPS Adam steps of CARS at the serving widths (dropout 0) on
    ``mesh`` against the unsharded step, on a ragged batch (uneven valid
    rows, tokens and clicks across shards), two ways from one init.  Free
    running, as a user trains: every step's loss and grad norm within
    MESH_TOL relative.  Step by step, each sharded step starting from the
    unsharded run's weights and optimizer state (float32): the reduced
    gradient within GRAD_TOL of the single one's largest element, and the
    updated parameters within PARAM_TOL, or within 2 lr at an element
    whose single-run gradient is rounding noise (NOISE_TAU; at most
    NOISE_SHARE of a leaf).  Returns the launches of the counted sharded
    step."""
    from context_attentive_ir_tpu_torch.models.multitask.cars import CARS
    from context_attentive_ir_tpu_torch.parallel import shard_batch
    from context_attentive_ir_tpu_torch.train import (
        create_train_state,
        make_train_step,
    )

    cfg = full_width_config("cars", compute_dtype=dtype)
    host = random_session_batch(np.random.RandomState(7), ragged=True)
    models, states, steps, grads = [], [], [], []
    # single, sharded free running, sharded from the single's state
    for m in (None, mesh, mesh):
        model = CARS(cfg, device=mesh.primary, seed=0)
        state = create_train_state(model, cfg)
        seen = {}

        def keep(params, g, opt_state, apply=state.tx.apply, seen=seen):
            seen.clear()
            seen.update({n: t.detach().float().clone()
                         for n, t in g.items() if t is not None})
            return apply(params, g, opt_state)

        state.tx.apply = keep
        models.append(model)
        states.append(state)
        steps.append(make_train_step(model, cfg, m))
        grads.append(seen)
    single, free, synced = states
    f32 = dtype == "float32"
    lr = cfg.learning_rate
    launches, rel, per_step = None, 0.0, []
    grad_err, worst, where, n_excused, excused_err = 0.0, 0.0, "", 0, 0.0
    share, share_at, n_el = 0.0, "", 0
    by_tau = {t: [0.0, 0] for t in TAUS}  # worst clear diff, noise diffs
    for i in range(MESH_STEPS):
        with torch.no_grad():
            for p, q in zip(models[2].parameters(), models[0].parameters()):
                p.copy_(q)
            for k, v in single.opt_state.items():
                if isinstance(v, dict):
                    for n, t in v.items():
                        synced.opt_state[k][n].copy_(t)
                else:
                    synced.opt_state[k] = v
            synced.step = single.step
        _, out3 = steps[1](free, shard_batch(host, mesh), 1)
        shards = shard_batch(host, mesh)
        if i == 1:
            (_, out2), launches = counted(
                f"train_step_{name}", lambda: steps[2](synced, shards, 1))
        else:
            _, out2 = steps[2](synced, shards, 1)
        _, out1 = steps[0](single, host.to(mesh.primary), 1)
        pair = [(float(out1[k]), float(out3[k]), float(out2[k]))
                for k in ("loss", "grad_norm")]
        per_step.append(pair)
        rel = max([rel] + [abs(a - b) / max(abs(a), 1e-30)
                           for a, *bs in pair for b in bs])
        if not f32:
            continue
        g1, g2 = grads[0], grads[2]
        top = max(float(t.abs().max()) for t in g1.values())
        grad_err = max([grad_err] + [float((g2[n] - g1[n]).abs().max())
                                     / top for n in g1])
        for (n, p2), p1 in zip(models[2].named_parameters(),
                               models[0].parameters()):
            diff = (p2.detach().float() - p1.detach().float()).abs()
            n_el += diff.numel()
            g = g1[n].abs() if n in g1 else torch.zeros_like(diff)
            for t, acc in by_tau.items():
                clear = g >= t * top
                if bool(clear.any()):
                    acc[0] = max(acc[0], float(diff[clear].max()))
                acc[1] += int(((~clear) & (diff > PARAM_TOL)).sum())
            noise = g < NOISE_TAU * top
            clear = diff[~noise]
            if clear.numel() and float(clear.max()) > worst:
                worst, where = float(clear.max()), n
            excused = noise & (diff > PARAM_TOL)
            k = int(excused.sum())
            if k:
                n_excused += k
                excused_err = max(excused_err, float(diff[excused].max()))
                if not bool(noise.all()) and k / diff.numel() > share:
                    share, share_at = k / diff.numel(), n
    tol = MESH_TOL[dtype]
    log(f"train_step_{name} ({dtype}, {mesh.size} replicas on "
        f"{[str(d) for d in mesh.devices]}): (loss, grad norm) single, "
        f"sharded free running, sharded from the single's state a step "
        f"{json.dumps(per_step)}, max rel diff {rel:.3e} (tol {tol})")
    if f32:
        log(f"train_step_{name} step by step: reduced gradient max abs "
            f"diff {grad_err:.3e} of the largest element (tol {GRAD_TOL}); "
            f"updated parameters max abs diff {worst:.3e} at {where} (tol "
            f"{PARAM_TOL}) where the single gradient is at least "
            f"{NOISE_TAU} of the largest; {n_excused} of {n_el} element "
            f"updates below it and past {PARAM_TOL}, at most "
            f"{excused_err:.3e} (tol 2 lr = {2 * lr:.1e}), at most "
            f"{share:.3%} of a leaf ({share_at or '-'}; tol "
            f"{NOISE_SHARE:.0%}); by threshold (worst clear diff, noise "
            f"updates past {PARAM_TOL}): "
            f"{json.dumps({str(t): v for t, v in by_tau.items()})}")
    if not (rel <= tol and (not f32 or (
            grad_err <= GRAD_TOL and worst <= PARAM_TOL
            and excused_err <= 2 * lr and share <= NOISE_SHARE))):
        raise AssertionError(f"train_step_{name} ({dtype}) disagrees with "
                             "the unsharded step")
    return launches


def mesh_serving(name: str, mesh, dtype: str) -> dict:
    """The sharded Engine against the single one at B = 64: rank_batch,
    beam-5 suggest_batch, index_documents + rank_indexed_batch with the
    slate kernel, then a bucket of one request a shard.  Scores within
    MESH_TOL (suggestion scores relative to their size), float32
    suggestion tokens equal.  Returns {path: launches}."""
    from context_attentive_ir_tpu_torch.models.multitask.cars import CARS
    from context_attentive_ir_tpu_torch.serve import Engine

    cfg = full_width_config("cars", compute_dtype=dtype,
                            use_pallas_slate=True)
    word_dict = synthetic_dictionary(VOCAB)
    params = CARS(cfg, device=mesh.primary, seed=0).state_dict()
    single = Engine(cfg, word_dict, params, beam_size=BEAM, batch_bucket=B,
                    device=mesh.primary)
    sharded = Engine(cfg, word_dict, params, beam_size=BEAM, batch_bucket=B,
                     mesh=mesh)
    rng = np.random.RandomState(11)
    reqs, hists = requests(rng, word_dict, B)
    corpus = corpus_texts(rng, word_dict, MESH_CORPUS)
    ids = [[int(i) for i in rng.choice(MESH_CORPUS, N, replace=False)]
           for _ in range(B)]
    plain = [(h[-1], d, [q for q, _ in h[:-1]]) for h, d in zip(hists, ids)]
    index_1 = single.index_documents(corpus)
    launches = {}
    suf = "" if dtype == "float32" else "_bf16"
    index_2, launches[f"index_documents_{name}{suf}"] = counted(
        f"index_documents_{name}{suf}",
        lambda: sharded.index_documents(corpus))
    tol = MESH_TOL[dtype]
    worst = {"index_states": float((index_2["states"].float()
                                    - index_1["states"].float())
                                   .abs().max())}
    small = Engine(cfg, word_dict, params, beam_size=BEAM, batch_bucket=2,
                   mesh=mesh)
    small_1 = Engine(cfg, word_dict, params, beam_size=BEAM,
                     batch_bucket=2, device=mesh.primary)
    calls = (
        ("rank_batch", lambda e: e.rank_batch(reqs), sharded, single),
        ("suggest_beam5", lambda e: e.suggest_batch(hists), sharded, single),
        ("rank_indexed", lambda e: e.rank_indexed_batch(
            plain, index_2 if e is sharded else index_1), sharded, single),
        ("rank_batch_min", lambda e: e.rank_batch(reqs[:2]), small,
         small_1),
        ("suggest_beam5_min", lambda e: e.suggest_batch(hists[:2]), small,
         small_1),
        ("rank_indexed_min", lambda e: e.rank_indexed_batch(
            plain[:2], index_2 if e is small else index_1), small,
         small_1))
    same_tokens = True
    for path, fn, eng, ref in calls:
        key = f"{path}_{name}{suf}"
        got, launches[key] = counted(key, lambda: fn(eng))
        want = fn(ref)
        if path.startswith("suggest"):
            # a beam score is a sum of 16 log-probabilities (|score| ~ 80
            # with random weights), each step's logsumexp merged over
            # vocab splits that follow the row count: held relative
            same_tokens &= ([[t for t, _ in nb] for nb in got]
                            == [[t for t, _ in nb] for nb in want])
            err = max(abs(a[1] - b[1]) / max(1.0, abs(b[1]))
                      for x, y in zip(got, want) for a, b in zip(x, y))
        else:
            err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
        worst[path] = err
    walls = steady_walls((
        ("rank_batch single", lambda: single.rank_batch(reqs)),
        ("rank_batch sharded", lambda: sharded.rank_batch(reqs)),
        ("suggest_beam5 single", lambda: single.suggest_batch(hists)),
        ("suggest_beam5 sharded", lambda: sharded.suggest_batch(hists))))
    log(f"Engine on {name} ({dtype}) steady wall ms (3 runs each, B={B}): "
        f"{json.dumps(walls)}")
    log(f"Engine on {name} ({dtype}, {mesh.size} replicas, buckets "
        f"{sharded.batch_bucket} and {small.batch_bucket}) against the "
        f"single Engine: max abs diff (suggestions: relative) "
        f"{json.dumps(worst)} (tol {tol}), "
        f"suggestion tokens equal: {same_tokens}; launches "
        f"{json.dumps({k: {n: c for n, c in v.items() if c} for k, v in launches.items()})}")
    if max(worst.values()) > tol or (dtype == "float32"
                                     and not same_tokens):
        raise AssertionError(f"the Engine on {name} ({dtype}) disagrees "
                             "with the single Engine")
    return launches


def request_batch_ms(eng, reqs) -> dict:
    """The request -> batch host ms of ``rank_batch`` (sessions and
    ``build_session_batch``, no device work) through ``utils.timed``, and
    one ``rank_batch`` under ``utils.profile_trace``: its trace file, wall
    and device-busy ms."""
    from context_attentive_ir_tpu_torch.data import build_session_batch
    from context_attentive_ir_tpu_torch.utils import profile_trace, timed

    def host_batch():
        sessions = [eng._to_sessions(h, q, d) for q, d, h in reqs]
        return build_session_batch(sessions, eng.word_dict, eng.shapes,
                                   batch_size=eng._bucket(len(sessions)))

    host_batch()
    runs = []
    for _ in range(3):
        with timed() as box:
            host_batch()
        runs.append(box["seconds"] * 1e3)
    with tempfile.TemporaryDirectory() as logdir:
        with profile_trace(logdir) as prof:
            with timed() as wall:
                scores = eng.rank_batch(reqs)
        trace = Path(logdir) / "trace.json"
        size = trace.stat().st_size if trace.exists() else 0
    from torch.autograd import DeviceType

    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    out = {"request_to_batch_ms": runs, "rank_batch_profiled_ms":
           wall["seconds"] * 1e3, "device_busy_ms": busy,
           "trace_bytes": size}
    log(f"rank_batch B={len(reqs)}: request -> batch host ms (utils.timed, "
        f"3 runs) {[round(r, 2) for r in runs]}; one call under "
        f"utils.profile_trace: wall {out['rank_batch_profiled_ms']:.1f} ms, "
        f"device busy {busy:.1f} ms, trace.json {size} bytes")
    if size == 0 or len(scores) != len(reqs):
        raise AssertionError("profile_trace wrote no trace")
    return out


def other_card_launch() -> None:
    """Kernels 1 and 2 on tensors of card 1 while card 0 is current must
    give the bits they give on card 0 (the launchers set up and launch on
    the current device; the wrappers make the operands' card current)."""
    from context_attentive_ir_tpu_torch.ops.kernels.beamgen import (
        generator_topk_lse,
    )
    from context_attentive_ir_tpu_torch.ops.kernels.lstm import lstm_fused

    gen = torch.Generator(device="cuda:0").manual_seed(3)
    (x, w_ih, b, w_hh), mask = lstm_inputs(gen, torch.bfloat16, rows=1280)
    bx, tt = beamgen_inputs(gen, B * S * BEAM, torch.bfloat16, False)
    args = {"lstm_fused": (lstm_fused, (x, mask, w_ih, b, w_hh)),
            "generator_topk_lse": (generator_topk_lse, (bx, tt, BEAM + 1))}
    same = {}
    with torch.cuda.device(0):
        for name, (fn, xs) in args.items():
            a = fn(*xs)
            c = fn(*(t.to("cuda:1") if isinstance(t, torch.Tensor) else t
                     for t in xs))
            torch.cuda.synchronize(1)
            a = a if isinstance(a, tuple) else (a,)
            c = c if isinstance(c, tuple) else (c,)
            same[name] = all(torch.equal(p, q.to("cuda:0"))
                             for p, q in zip(a, c))
    log(f"kernels on card 1 with card 0 current give card 0's bits: "
        f"{json.dumps(same)}")
    if not all(same.values()):
        raise AssertionError("a kernel launched on the wrong card")


def refuses_plain(eng, hists) -> None:
    """On the card a dispatch-table row that prefers a plain version
    raises instead of trading the kernel for it: an RNN row preferring the
    scan (RNNLayer.kernel_ok), a beam_gen row preferring the logits step
    (the Engine's decode step).  The committed table comes back after."""
    from context_attentive_ir_tpu_torch.ops import dispatch
    from context_attentive_ir_tpu_torch.ops.rnn import RNNLayer
    from context_attentive_ir_tpu_torch.serve import ServeError

    layer = RNNLayer(EMSIZE, NHID, use_kernel=True, dtype=torch.bfloat16,
                     device="cuda")
    x = torch.randn(B, LQ, EMSIZE, device="cuda")
    mask = torch.ones(B, LQ, dtype=torch.bool, device="cuda")
    cases = (
        ("rnn_scan", {"kind": "lstm", "mode": "infer", "t": LQ,
                      "e": EMSIZE, "h": NHID, "dtype": "bfloat16",
                      "rows": B, "kernel_ms": 9.0, "scan_ms": 1.0},
         lambda: torch.no_grad()(layer)(x, mask), ValueError),
        ("logits_step", {"kind": "beam_gen", "rows": B * S * BEAM,
                         "v": VOCAB, "e": EMSIZE, "kc": BEAM + 1,
                         "fused_ms": 9.0, "xla_ms": 1.0},
         lambda: eng.suggest_batch(hists[:1]), ServeError))
    refused = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "table.json"
        old, dispatch.TABLE_PATH = dispatch.TABLE_PATH, path
        try:
            for name, row, fn, err in cases:
                dispatch.write_table([row], path)
                try:
                    fn()
                    refused[name] = False
                except err:
                    refused[name] = True
        finally:
            dispatch.TABLE_PATH = old
            dispatch.reload_table()
    log(f"a table row preferring a plain version raises on the card: "
        f"{json.dumps(refused)}")
    if not all(refused.values()):
        raise AssertionError("a dispatch-table row sent the card to a "
                             "plain version")


def parallel_paths() -> dict:
    """The parallel phase: the train step and the Engine on a two-replica
    mesh of the one card (and of two cards where there are two), in
    float32 and bfloat16, against their unsharded selves; the request ->
    batch host ms; the dispatch table's readings taken again beside the
    committed table's choices.  Returns {path: launches}."""
    from context_attentive_ir_tpu_torch.ops import dispatch
    from context_attentive_ir_tpu_torch.parallel import make_mesh
    from context_attentive_ir_tpu_torch.serve import Engine

    meshes = [("mesh2", make_mesh(["cuda:0", "cuda:0"]))]
    if torch.cuda.device_count() >= 2:
        meshes.append(("cards2", make_mesh(["cuda:0", "cuda:1"])))
        other_card_launch()
    launches = {}
    for name, mesh in meshes:
        for dtype in ("float32", "bfloat16"):
            suf = "" if dtype == "float32" else "_bf16"
            launches[f"train_step_{name}{suf}"] = mesh_train(
                f"{name}{suf}", mesh, dtype)
            launches.update(mesh_serving(name, mesh, dtype))

    from context_attentive_ir_tpu_torch.models.multitask.cars import CARS

    cfg = full_width_config("cars")
    word_dict = synthetic_dictionary(VOCAB)
    eng = Engine(cfg, word_dict, CARS(cfg, device="cuda", seed=0)
                 .state_dict(), beam_size=BEAM, batch_bucket=B)
    reqs, hists = requests(np.random.RandomState(0), word_dict, B)
    request_batch_ms(eng, reqs)
    refuses_plain(eng, hists)

    sys.path.insert(0, str(ROOT / "scripts"))
    from torch_dispatch_table import decisions, measure

    table = dispatch._load_table()
    readings = measure(seed=1)
    log(f"dispatch table readings now: {json.dumps(readings)}")
    log(f"their choices now: {json.dumps(decisions(readings))}; the "
        f"committed table's: {json.dumps(decisions(table))}")
    return launches



def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


MAX_F32_TILED = 1024   # the float32 tile kernels hold H to here

# the timing rows' earlier readings (ms, one H100 80GB HBM3 at 700 W; the
# recurrent kernels at the doc-encoder shape, the generator's modes at the
# beam-5 step's, bf16, as the last chip_smoke run before their redesign
# read them): the last CUDA-core versions of the kernels that have since
# been redesigned; kernel 10 by (dtype, H, rows) at T = Ld, the route of
# the last commit with its CUDA-core kernel (the resident kernel at bf16 H
# = 128 / 256, the CUDA-core kernel elsewhere), the mean of two runs of
# `scripts/torch_kernel_digest.py --root` on that commit in one call.  Logged beside the new times,
# never put into the kernels line, which holds only what this run
# measured.
EARLIER_MS = {"lstm_fused": 11.269, "lstm_fused_res": 11.256,
              "lstm_fused_bwd": 44.075, "gru_fused": 10.068,
              "gru_fused_res": 9.722, "gru_fused_bwd": 28.380,
              "generator_topk_lse": 5.233,
              "generator_topk_lse_pruned": 3.036,
              "generator_topk_lse_int8": 3.041,
              "generator_topk_lse_pipelined": 3.761,
              "lstm_recurrence": 3.795,
              "attn_pool": {
                  ("bfloat16", 128, B * S * N): 0.322,
                  ("bfloat16", 128, B * S * MAX_CLICKS): 0.048,
                  ("bfloat16", 256, B * S * N): 0.448,
                  ("bfloat16", 256, B * S * MAX_CLICKS): 0.065,
                  ("bfloat16", 384, B * S * N): 8.484,
                  ("bfloat16", 384, B * S * MAX_CLICKS): 2.085,
                  ("bfloat16", 512, B * S * N): 15.266,
                  ("bfloat16", 512, B * S * MAX_CLICKS): 3.856,
                  ("bfloat16", 640, B * S * N): 22.469,
                  ("bfloat16", 640, B * S * MAX_CLICKS): 5.412,
                  ("bfloat16", 768, B * S * N): 42.953,
                  ("bfloat16", 768, B * S * MAX_CLICKS): 5.483,
                  ("bfloat16", 896, B * S * N): 62.312,
                  ("bfloat16", 896, B * S * MAX_CLICKS): 7.996,
                  ("bfloat16", 1024, B * S * N): 256.511,
                  ("bfloat16", 1024, B * S * MAX_CLICKS): 32.196,
                  ("float32", 128, B * S * N): 0.935,
                  ("float32", 128, B * S * MAX_CLICKS): 0.640,
                  ("float32", 256, B * S * N): 3.883,
                  ("float32", 256, B * S * MAX_CLICKS): 1.924,
                  ("float32", 384, B * S * N): 10.718,
                  ("float32", 384, B * S * MAX_CLICKS): 2.724,
                  ("float32", 512, B * S * N): 34.739,
                  ("float32", 512, B * S * MAX_CLICKS): 8.691,
                  ("float32", 640, B * S * N): 41.758,
                  ("float32", 640, B * S * MAX_CLICKS): 8.276,
                  ("float32", 768, B * S * N): 90.648,
                  ("float32", 768, B * S * MAX_CLICKS): 11.442,
                  ("float32", 896, B * S * N): 188.612,
                  ("float32", 896, B * S * MAX_CLICKS): 23.694,
                  ("float32", 1024, B * S * N): 1019.877,
                  ("float32", 1024, B * S * MAX_CLICKS): 127.731}}

# --only selectors, in running order.  "lstm", "grukernels",
# "beamkernels" and "slatekernels" are the LSTM, GRU, generator and slate
# pool kernels' shares of "kernels"; a run with no selector runs every
# other phase.
PHASES = ("kernels", "lstm", "grukernels", "beamkernels", "slatekernels",
          "serving", "parallel", "train", "indexed", "interop", "gru",
          "small", "kernel6", "f32bwd", "widelstm", "widegru", "widebeam",
          "widestep", "widegrustep", "trainer",
          "recommenders", "multitask", "rankers")
SHARES = {"lstm", "grukernels", "beamkernels", "slatekernels"}
ALIASES = {"f32": "f32bwd"}   # other names of a phase


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="",
                    help="comma-separated phases to run after the build "
                         f"(of {', '.join(PHASES)}; f32 is f32bwd); default: "
                         "all")
    only = [ALIASES.get(p, p) for p in ap.parse_args().only.split(",") if p]
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
    table_choices()

    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("float32 comparisons run with TF32 off "
        "(torch.backends.cuda.matmul.allow_tf32 = "
        "torch.backends.cudnn.allow_tf32 = False)")

    errs = {}

    def merge_tiles(rnn, worst, dtype=torch.bfloat16):
        for k, v in worst.items():
            d = errs[f"pair_{rnn}"][k]
            d[dtype] = max(d[dtype], v)

    def check_rnn(rnn):
        errs[f"fwd_{rnn}"] = check_forward(gen, rnn)
        errs[f"pair_{rnn}"] = check_train_pair(gen, rnn)
        merge_tiles(rnn, check_tiles(gen, rnn))
        if rnn == "gru":
            for dtype in (torch.float32, torch.bfloat16):
                merge_tiles(rnn, check_tiles(gen, rnn, GRU_TILE_SHAPES,
                                             dtype), dtype)

    def check_lstm():
        check_rnn("lstm")
        for dtype in (torch.float32, torch.bfloat16):
            merge_tiles("lstm", check_tiles(gen, "lstm", WIDE_SHAPES, dtype),
                        dtype)
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
    if "parallel" in run:
        launches.update(phase("parallel", parallel_paths))
    # the cli.main phases share one set of fixtures
    fixture_dir = tempfile.TemporaryDirectory()
    with tempfile.TemporaryDirectory() as tmp:
        if run & {"train", "indexed", "interop"}:
            # the indexed phase serves the train phase's checkpoint, the
            # interop phase writes its state again
            train_launches, ms, ckpt_path, trained = phase(
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
        if "interop" in run:
            launches.update(phase("interop", lambda: interop_paths(
                tmp, fixture_dir.name, trained)))
            del trained
        if "gru" in run:
            gru_launches, ms = phase("gru", lambda: gru_paths(tmp))
            launches.update(gru_launches)
            train_ms.update(ms)
    if "small" in run:
        phase("small", small_model_check)
    if "kernel6" in run:
        with torch.inference_mode():
            launches.update(phase("kernel6", precomputed_path))
    wide_rows = []
    if "f32bwd" in run:
        # the float32 rows the wide phases time anyway are held here
        elsewhere = ({("lstm", h) for h, dt in WIDE_TIMED if dt == torch.float32}
                     if "widelstm" in run else set())
        if "widegru" in run:
            elsewhere |= {("gru", h) for h, dt in WIDEGRU_TIMED
                          if dt == torch.float32}
        f32_launches, rows = phase("f32bwd", lambda: f32bwd_paths(
            gen, elsewhere))
        launches.update(f32_launches)
        wide_rows.extend(rows)
    if "widelstm" in run:
        wide_launches, rows = phase(
            "widelstm", lambda: wide_paths(gen, fixture_dir.name))
        launches.update(wide_launches)
        wide_rows.extend(rows)
    if "widegru" in run:
        wide_launches, rows = phase(
            "widegru", lambda: widegru_paths(gen, fixture_dir.name))
        launches.update(wide_launches)
        wide_rows.extend(rows)
    if "widebeam" in run:
        wide_launches, rows = phase("widebeam", lambda: widebeam_paths(gen))
        launches.update(wide_launches)
        wide_rows.extend(rows)
    if "widestep" in run:
        wide_launches, rows = phase("widestep", lambda: widestep_paths(gen))
        launches.update(wide_launches)
        wide_rows.extend(rows)
    if "widegrustep" in run:
        wide_launches, rows = phase("widegrustep",
                                    lambda: widegrustep_paths(gen))
        launches.update(wide_launches)
        wide_rows.extend(rows)
    # the default run keeps --resume and the Trainer's timings for CARS
    # alone (its time limit), a phase run alone keeps them for each of its
    # models but the rankers
    def resumed(*model_types):
        return model_types if full else None

    if "trainer" in run:
        with tempfile.TemporaryDirectory() as tmp:
            launches.update(phase("trainer", lambda: trainer_paths(
                tmp, fixture_dir.name, resumed=resumed("cars"))))
    if "recommenders" in run:
        def recommenders(tmp):
            rec_launches, ms = recommender_paths(tmp)
            rec_launches.update(trainer_paths(tmp, fixture_dir.name,
                                              ("seq2seq", "acg"), resumed()))
            return rec_launches, ms
        with tempfile.TemporaryDirectory() as tmp:
            rec_launches, ms = phase("recommenders",
                                     lambda: recommenders(tmp))
            launches.update(rec_launches)
            train_ms.update(ms)
    if "multitask" in run:
        def multitask(tmp):
            topk_check(gen)
            conv_layouts(gen)
            mt_launches, ms = multitask_paths(tmp)
            mt_launches.update(trainer_paths(
                tmp, fixture_dir.name, ("mnsrf", "m_match_tensor"),
                resumed()))
            return mt_launches, ms
        with tempfile.TemporaryDirectory() as tmp:
            mt_launches, ms = phase("multitask", lambda: multitask(tmp))
            launches.update(mt_launches)
            train_ms.update(ms)
    if "rankers" in run:
        def rankers(tmp):
            rk_launches, ms = ranker_paths(tmp)
            # Match-Tensor on the first FIT_TRAIN_SESSIONS, the other seven
            # on the first RANKER_SESSIONS; train, validate, test,
            # --only_test
            rk_launches.update(trainer_paths(tmp, fixture_dir.name, RANKERS,
                                             resumed=()))
            return rk_launches, ms
        with tempfile.TemporaryDirectory() as tmp:
            rk_launches, ms = phase("rankers", lambda: rankers(tmp))
            launches.update(rk_launches)
            train_ms.update(ms)
    fixture_dir.cleanup()

    bf16 = torch.bfloat16
    kernels = []

    def timing():
        rnns = [r for r in RNNS if f"fwd_{r}" in errs]
        kernels.extend(row for rnn in rnns for row in time_rnn(
            gen, rnn, launches, errs[f"fwd_{rnn}"][bf16],
            errs[f"pair_{rnn}"]))
        if "lstm" in rnns:
            # the recommenders' encoder over their flat source [B, S*Lq]
            kernels.extend(time_rnn(gen, "lstm", launches,
                                    errs["fwd_lstm"][bf16],
                                    errs["pair_lstm"],
                                    shape=(B, S_REC * LQ)))
        if "gru" in rnns:
            time_row_tiles(gen)
        if "rec" in errs:
            kernels.append(time_recurrence(gen, launches, errs["rec"][bf16]))
        if "beam" in errs:
            kernels.append(time_beamgen(gen, launches, errs["beam"][bf16]))
        if "slate" in errs:
            kernels.extend(time_slate(gen, launches, errs["slate"]))
        if "beam" in errs:
            kernels.extend(time_beamgen_modes(gen, launches,
                                              errs["beam"][bf16],
                                              errs["int8"][bf16]))
            kernels.extend(time_beamgen_f32(gen, launches, errs["beam"],
                                            errs["int8"]))

    if errs:
        phase("kernel timing", timing)
    kernels.extend(wide_rows)
    # every row's launches from the whole run's counts (a phase's rows were
    # made before the later phases ran)
    for row in kernels:
        row.update(by_path(launches, row["name"]))
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
