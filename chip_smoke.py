#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``context_attentive_ir_tpu_torch``)
on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions;
2. the build of the kernel library from ``context_attentive_ir_tpu_torch/
   csrc`` (``nvcc`` for sm_90a, timed);
3. every kernel against its plain PyTorch version on the card at every
   shape the main path gives it and at row counts off its row block, in
   float32 (TF32 off for matmuls and cuDNN) and bfloat16; then shapes a
   kernel cannot hold must be refused with the launcher's CUDA error;
4. the main path at full width: CARS at the serving widths (vocab 50,000,
   emsize 256, nhid 128, nhid_ffnn 256, S=5, N=50, Lq=15, Ld=30, bf16,
   seeded random weights) behind ``serve.Engine``, answering ``rank_batch``
   for 64 requests, then beam-5 and greedy ``suggest_batch`` for 64
   histories, each call run with every kernel's launch count set to 0
   just before it and read just after it (rank must launch kernel 1 only,
   both suggest calls kernels 1 and 2); then a small float32 CARS whose
   ``Engine`` on the card must agree with the same ``Engine`` on the CPU
   (plain versions);
5. kernel, plain-version and library times (CUDA events after warm-up)
   with each kernel's bound, printed as one ``{"kernels": [...]}`` line.

The last line is ``{"ok": true, "device": {...}}``.  The script needs a
card: without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
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
    lens[1] = 0
    mask = torch.arange(steps, device=dev)[None, :] < lens[:, None]
    return [t.to(dtype) for t in (x, w_ih, b, w_hh)], mask


# (rows, steps) kernel 1 sees on the main path -- doc encoder, query
# encoder, suggest's clicked-doc encoder -- plus row counts off the 32-row
# block, so the last block's row guard is checked at serving widths
LSTM_SHAPES = ((B * S * N, LD), (B * S, LQ), (B * S * MAX_CLICKS, LD),
               (B * S * N + 7, LD), (B * S * MAX_CLICKS + 5, LD),
               (B * S + 13, LQ))


def check_lstm(gen) -> dict:
    """Worst bf16 and f32 abs error of kernel 1 over LSTM_SHAPES."""
    from context_attentive_ir_tpu_torch.ops.kernels.lstm import (
        lstm_fused,
        lstm_fused_reference,
    )

    out = {}
    for dtype, tol, kind in ((torch.float32, 1e-4, "abs"),
                             (torch.bfloat16, 2e-2, "rel")):
        out[dtype] = 0.0
        for rows, steps in LSTM_SHAPES:
            (x, w_ih, b, w_hh), mask = lstm_inputs(gen, dtype, rows, steps)
            worst_abs = worst_rel = 0.0
            for reverse in (False, True):
                got = lstm_fused(x, mask, w_ih, b, w_hh, reverse).float()
                ref = lstm_fused_reference(x, mask, w_ih, b, w_hh,
                                           reverse).float()
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                if not bool((got[~mask] == 0).all()):
                    raise AssertionError("lstm_fused: masked outputs not "
                                         "zero")
                worst_abs = max(worst_abs, err)
                worst_rel = max(worst_rel, err / float(ref.abs().max()))
            worst = worst_abs if kind == "abs" else worst_rel
            log(f"lstm_fused {dtype} [{rows},{steps},{x.shape[2]}]"
                f"->{w_hh.shape[0]} both directions: max abs err "
                f"{worst_abs:.3e}, max rel err {worst_rel:.3e} (tol {kind} "
                f"{tol:g})")
            if not worst <= tol:
                raise AssertionError(f"lstm_fused {dtype} [{rows},{steps}]: "
                                     f"{kind} error {worst} > {tol}")
            out[dtype] = max(out[dtype], worst_abs)
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


def check_beamgen(gen) -> dict:
    """Kernel 2 against its plain version at the decode steps' shapes
    (beam-5 and greedy rows) and at row counts off the 64-row block."""
    from context_attentive_ir_tpu_torch.ops.kernels.beamgen import (
        generator_topk_lse,
        generator_topk_lse_reference,
    )

    out = {}
    for rows, kc in ((B * S * BEAM, BEAM + 1), (B * S, 2),
                     (B * S * BEAM + 5, BEAM + 1), (B * S + 3, 2)):
        for dtype in (torch.float32, torch.bfloat16):
            for integer in (True, False):
                x, tt = beamgen_inputs(gen, rows, dtype, integer)
                v, i, lse = generator_topk_lse(x, tt, kc)
                rv, ri, rlse = generator_topk_lse_reference(x, tt, kc + 1)
                torch.cuda.synchronize()
                lse_rel = float(((lse - rlse).abs() / rlse.abs()).max())
                v_err = float((v - rv[:, :kc]).abs().max())
                name = (f"generator_topk_lse R={rows} kc={kc} {dtype} "
                        f"{'integer' if integer else 'random'}")
                if integer:
                    exact = (torch.equal(v, rv[:, :kc])
                             and torch.equal(i, ri[:, :kc]))
                    log(f"{name}: vals/idx exact={exact}, lse max rel err "
                        f"{lse_rel:.3e}")
                    if not exact or lse_rel > 1e-6:
                        raise AssertionError(f"{name} disagrees")
                else:
                    # an index may differ from the plain version's only at
                    # a near-tie position, and must score (in the plain
                    # f32 logits) what the plain version has there
                    scale = rv.abs().amax(-1, keepdim=True)
                    logits = x.float() @ tt.float()
                    got = logits.gather(1, i.long())
                    del logits
                    miss = i != ri[:, :kc]
                    unexplained = miss & ~near_tie_positions(rv, kc)
                    off = ((got - rv[:, :kc]).abs() > 1e-5 * scale).any(-1)
                    dup = (i.sort(-1).values.diff(dim=-1) == 0).any(-1)
                    n_miss = int(miss.any(-1).sum())
                    n_unexplained = int(unexplained.any(-1).sum())
                    n_off, n_dup = int(off.sum()), int(dup.sum())
                    v_rel = v_err / float(rv.abs().max())
                    log(f"{name}: idx mismatch rows {n_miss}/{rows} "
                        f"(outside a near tie {n_unexplained}, index "
                        f"scoring off its value {n_off}, repeated index "
                        f"{n_dup}), vals max abs err {v_err:.3e} (rel "
                        f"{v_rel:.3e}), lse max rel err {lse_rel:.3e}")
                    if (n_unexplained or n_off or n_dup or v_rel > 1e-5
                            or lse_rel > 1e-5):
                        raise AssertionError(f"{name} disagrees")
                    if rows == B * S * BEAM:
                        out[dtype] = v_err
    return out


def check_refusals(gen) -> None:
    """Shapes a kernel's block cannot hold raise with the launcher's CUDA
    error, and the next launch still runs clean."""
    from context_attentive_ir_tpu_torch.ops.kernels.beamgen import (
        generator_topk_lse,
    )
    from context_attentive_ir_tpu_torch.ops.kernels.lstm import lstm_fused

    def lstm_at(e, h):
        (x, w_ih, b, w_hh), mask = lstm_inputs(gen, torch.float32, 40, 3,
                                               e=e, h=h)
        return lstm_fused(x, mask, w_ih, b, w_hh)

    def beamgen_at(e):
        x = torch.randn((70, e), generator=gen, device="cuda")
        t = torch.randn((e, 300), generator=gen, device="cuda")
        return generator_topk_lse(x, t, 2)

    for name, fn in (("lstm_fused E=4096 (shared tile)",
                      lambda: lstm_at(4096, NHID)),
                     ("lstm_fused H=1024 (threads per block)",
                      lambda: lstm_at(EMSIZE, 1024)),
                     ("generator_topk_lse E=1024 (shared tile)",
                      lambda: beamgen_at(1024))):
        try:
            fn()
        except RuntimeError as err:
            log(f"{name} refused: {err}")
        else:
            raise AssertionError(f"{name} was not refused")
    lstm_at(EMSIZE, NHID)
    beamgen_at(EMSIZE)
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
    from context_attentive_ir_tpu_torch.ops.kernels import beamgen, lstm

    return {"lstm_fused": lstm.lstm_fused,
            "generator_topk_lse": beamgen.generator_topk_lse}


# the kernels each main-path call launches; every other count stays 0
PATH_KERNELS = {
    "rank_batch": ("lstm_fused",),
    "suggest_beam5": ("lstm_fused", "generator_topk_lse"),
    "suggest_greedy": ("lstm_fused", "generator_topk_lse"),
}


def by_path(launches: dict, kernel: str) -> dict:
    """``{"launches": total, "launches_by_path": {path: n}}`` of one kernel
    from main_path's per-path counts."""
    per = {path: counts[kernel] for path, counts in launches.items()}
    return {"launches": sum(per.values()), "launches_by_path": per}


def main_path() -> dict:
    from context_attentive_ir_tpu_torch.config import default_config
    from context_attentive_ir_tpu_torch.models.multitask.cars import CARS
    from context_attentive_ir_tpu_torch.serve import Engine

    cfg = default_config("cars").replace(
        vocab_size=VOCAB, emsize=EMSIZE, nhid=NHID, nhid_ffnn=NHID_FFNN,
        max_query_len=LQ, max_doc_len=LD, max_session_len=S,
        num_candidates=N, compute_dtype="bfloat16", dropout=0.0,
        dropout_emb=0.0, dropout_rnn=0.0)
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
        fns = counters()
        for f in fns.values():
            f.launches = 0
        t = time.perf_counter()
        outs[path] = fn()
        torch.cuda.synchronize()
        first_ms[path] = (time.perf_counter() - t) * 1e3
        launches[path] = {k: f.launches for k, f in fns.items()}
    log(f"main path launches per path: {json.dumps(launches)}")
    log(f"first-call wall ms: {json.dumps(first_ms)}")
    for path, counts in launches.items():
        for k, n in counts.items():
            if (n > 0) != (k in PATH_KERNELS[path]):
                raise AssertionError(f"{path} launched kernel {k} {n} times;"
                                     f" it must launch {PATH_KERNELS[path]}")
    scores = outs["rank_batch"]
    sugg, sugg_g = outs["suggest_beam5"], outs["suggest_greedy"]

    if len(scores) != B or any(len(s) != N for s in scores):
        raise AssertionError("rank_batch returned the wrong shape")
    if not np.isfinite(np.asarray(scores)).all():
        raise AssertionError("rank_batch returned non-finite scores")
    for out, k in ((sugg, BEAM), (sugg_g, 1)):
        if len(out) != B or any(len(nb) != k for nb in out):
            raise AssertionError("suggest_batch returned the wrong shape")
        if not all(isinstance(t, str) and np.isfinite(sc)
                   for nb in out for t, sc in nb):
            raise AssertionError("suggest_batch returned bad suggestions")
    if sum(len(t) > 0 for nb in sugg for t, _ in nb) == 0:
        raise AssertionError("beam suggestions are all empty")
    log(f"sample suggestion: {sugg[0][0]}; greedy: {sugg_g[0][0]}")

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


def small_reference_check() -> None:
    """A small float32 CARS: the Engine on the card (kernels) must agree
    with the same Engine on the CPU (plain versions)."""
    from context_attentive_ir_tpu_torch.config import default_config
    from context_attentive_ir_tpu_torch.models.multitask.cars import CARS
    from context_attentive_ir_tpu_torch.serve import Engine

    cfg = default_config("cars").replace(
        vocab_size=300, emsize=32, nhid=16, nhid_ffnn=32, max_query_len=8,
        max_doc_len=12, max_session_len=3, num_candidates=8, dropout=0.0,
        dropout_emb=0.0, dropout_rnn=0.0)
    word_dict = synthetic_dictionary(cfg.vocab_size)
    params = CARS(cfg, device="cpu", seed=1).state_dict()
    rng = np.random.RandomState(1)
    words = word_dict.tokens()

    def text(n):
        return " ".join(rng.choice(words, size=n))

    reqs = [(text(4), [text(7) for _ in range(6)],
             [(text(3), [text(5)]), text(2)]) for _ in range(5)]
    hists = [[(text(3), [text(6), text(4)]), text(5)] for _ in range(5)]
    for beam in (3, 1):
        gpu = Engine(cfg, word_dict, params, beam_size=beam, batch_bucket=4)
        cpu = Engine(cfg, word_dict, params, beam_size=beam, batch_bucket=4,
                     device="cpu")
        rg, rc = gpu.rank_batch(reqs), cpu.rank_batch(reqs)
        err = max(abs(a - b) for x, y in zip(rg, rc) for a, b in zip(x, y))
        sg, sc = gpu.suggest_batch(hists), cpu.suggest_batch(hists)
        same = [[t for t, _ in nb] for nb in sg] == [[t for t, _ in nb]
                                                      for nb in sc]
        s_err = max(abs(a[1] - b[1]) for x, y in zip(sg, sc)
                    for a, b in zip(x, y))
        log(f"small f32 CARS, beam {beam}: card vs CPU rank max abs err "
            f"{err:.3e} (tol 1e-4), suggestions identical={same}, score "
            f"max abs err {s_err:.3e} (tol 1e-4)")
        if not (err <= 1e-4 and same and s_err <= 1e-4):
            raise AssertionError("card Engine disagrees with CPU Engine")


# -- phase 5: times ----------------------------------------------------------


def time_lstm(gen, launches: dict, max_err: float) -> dict:
    from context_attentive_ir_tpu_torch.ops.kernels.lstm import (
        lstm_fused,
        lstm_fused_reference,
    )

    dtype = torch.bfloat16
    (x, w_ih, b, w_hh), mask = lstm_inputs(gen, dtype)
    rows, steps, e = x.shape
    h = w_hh.shape[0]
    ms = timed_ms(lambda: lstm_fused(x, mask, w_ih, b, w_hh), 5)
    plain = timed_ms(lambda: lstm_fused_reference(x, mask, w_ih, b, w_hh), 5)
    cudnn = torch.nn.LSTM(e, h, batch_first=True, device="cuda", dtype=dtype)
    with torch.inference_mode():
        lib = timed_ms(lambda: cudnn(x), 5)
    flops = 2.0 * rows * steps * (e + h) * 4 * h
    n_bytes = (x.numel() + rows * steps * h + w_ih.numel() + b.numel()
               + w_hh.numel()) * 2 + mask.numel()
    bnd, by = bound_ms(flops, n_bytes, dtype)
    log(f"lstm_fused bf16 [{rows},{steps},{e}]->{h} one direction: kernel "
        f"{ms:.3f} ms, plain {plain:.3f} ms, cuDNN nn.LSTM {lib:.3f} ms, "
        f"bound {bnd:.4f} ms ({by})")
    return {"name": "lstm_fused", "route": "cuda",
            "source": "context_attentive_ir_tpu_torch/csrc/lstm_fwd.cu",
            "replaces": "context_attentive_ir_tpu/ops/pallas/lstm.py:314",
            **by_path(launches, "lstm_fused"), "max_abs_err": max_err,
            "ms": ms,
            "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib}


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
    return {"name": "generator_topk_lse", "route": "cuda",
            "source": "context_attentive_ir_tpu_torch/csrc/beamgen.cu",
            "replaces": "context_attentive_ir_tpu/ops/pallas/beamgen.py:286",
            **by_path(launches, "generator_topk_lse"), "max_abs_err": max_err,
            "ms": ms,
            "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from context_attentive_ir_tpu_torch.ops.kernels.build import build

    log(card())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t = time.perf_counter()
    ptxas = build(ptxas_info=True)
    log(f"kernel library built in {time.perf_counter() - t:.1f} s")
    log(ptxas)

    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("float32 comparisons run with TF32 off "
        "(torch.backends.cuda.matmul.allow_tf32 = "
        "torch.backends.cudnn.allow_tf32 = False)")
    lstm_err = check_lstm(gen)
    beam_err = check_beamgen(gen)
    check_refusals(gen)

    with torch.inference_mode():
        launches = main_path()
        small_reference_check()

    kernels = [time_lstm(gen, launches, lstm_err[torch.bfloat16]),
               time_beamgen(gen, launches, beam_err[torch.bfloat16])]
    log(card())
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
