#!/usr/bin/env python3
"""Wall times of the PyTorch port's CARS ``Engine`` at wide beams, and the
device time of the generator's split merge, to compare two checkouts on
one card.

    python3 scripts/torch_generator_times.py [--root DIR] [--iters N]
        [--cases NAME,...]

Imports the package of the checkout at DIR (default: the one this script
lies in), builds CARS at the serving widths (vocab 50,000, emsize 256,
nhid 128, bfloat16, 64 requests of 5 turns, seeded weights) and prints one
line per ``suggest_batch`` case: beams 5, 40 and 127 on the float table,
40 and 127 on the int8 table, beam 40 with a 4,096-id shortlist, and beam
5 in float32 (the configuration's default dtype).
Each line gives the mean, median and least wall time of ``--iters``
calls after one warm-up call (host clock, the card synchronised), the
device time of one more call (the sum of its kernels' times,
``torch.profiler``), and the generator kernel launches of one call by
mode (none: the call decoded through the model's logits step); a case the
Engine refuses prints its error.  ``--cases`` keeps the cases of those
names (``beam5_float``, ``beam40_int8``, ...).  First, for the beam-5
step (R = 1,600, kc 6) and the greedy step (R = 320, kc 2) of kernel 2,
the mean device time of each kernel of one ``generator_topk_lse`` call
(``torch.profiler``; a merge kernel's name holds ``merge``).  Run the
script for each checkout in one call, in turns (A, B, B, A).  Needs a
card.
"""

from __future__ import annotations

import argparse
import importlib
import sys
import time
from pathlib import Path

import numpy as np
import torch

VOCAB, EMSIZE, NHID, NHID_FFNN = 50_000, 256, 128, 256
B, S, N, LQ, LD = 64, 5, 50, 15, 30
SHORTLIST = 4096
MODES = ("launches", "launches_pruned", "launches_int8", "launches_pipelined")


def synthetic_dictionary(data, vocab: int):
    d = data.Dictionary()
    for k in range(vocab - len(d)):
        d.add(f"w{k}")
    return d


def histories(rng, word_dict, n: int):
    words = np.asarray(word_dict.tokens())

    def text(lo, hi):
        return " ".join(rng.choice(words, size=rng.randint(lo, hi + 1)))

    return [[(text(2, LQ), [text(5, LD) for _ in range(rng.randint(1, 3))])
             for _ in range(S - 1)] + [text(2, LQ)] for _ in range(n)]


def device_ms(fn) -> float | None:
    """The summed device time of ``fn``'s kernels (ms), or None when the
    profiler sees none."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        total += (getattr(ev, "device_time_total", None)
                  or getattr(ev, "cuda_time_total", 0) or 0)
    return total / 1e3 if total else None


def engine_times(pkg, iters: int, only: set[str]) -> None:
    config = importlib.import_module(f"{pkg}.config")
    data = importlib.import_module(f"{pkg}.data")
    cars = importlib.import_module(f"{pkg}.models.multitask.cars")
    serve = importlib.import_module(f"{pkg}.serve")
    gen = importlib.import_module(f"{pkg}.ops.kernels.beamgen"
                                  ).generator_topk_lse

    word_dict = synthetic_dictionary(data, VOCAB)
    hists = histories(np.random.RandomState(18), word_dict, B)
    cfg = config.default_config("cars").replace(
        vocab_size=VOCAB, emsize=EMSIZE, nhid=NHID, nhid_ffnn=NHID_FFNN,
        max_query_len=LQ, max_doc_len=LD, max_session_len=S,
        num_candidates=N, compute_dtype="bfloat16", dropout=0.0,
        dropout_emb=0.0, dropout_rnn=0.0)
    params = cars.CARS(cfg, device="cuda", seed=0).state_dict()
    q_cfg = cfg.replace(quantize_embeddings=True)
    q_params = serve.quantize_embedding_params(params)
    cases = [(f"beam{b}_{tag}", c, p, b, {})
             for b, tags in ((5, ("float",)), (40, ("float", "int8")),
                             (127, ("float", "int8")))
             for tag in tags
             for c, p in ([(cfg, params)] if tag == "float"
                          else [(q_cfg, q_params)])]
    cases.append(("beam40_shortlist", cfg, params, 40,
                  {"suggest_shortlist": SHORTLIST}))
    f32_cfg = cfg.replace(compute_dtype="float32")
    cases.append(("beam5_f32", f32_cfg, cars.CARS(
        f32_cfg, device="cuda", seed=0).state_dict(), 5, {}))
    for name, c, p, beam, kw in cases:
        if only and name not in only:
            continue
        try:
            eng = serve.Engine(c, word_dict, p, beam_size=beam,
                               batch_bucket=B, **kw)
            with torch.inference_mode():
                eng.suggest_batch(hists)
                torch.cuda.synchronize()
                walls = []
                for k in range(iters):
                    for attr in MODES:
                        setattr(gen, attr, 0)
                    t = time.perf_counter()
                    eng.suggest_batch(hists)
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t) * 1e3)
                    if k == 0:
                        launches = {a: getattr(gen, a) for a in MODES
                                    if getattr(gen, a)}
                busy = device_ms(lambda: eng.suggest_batch(hists))
        except serve.ServeError as err:
            print(f"engine {name}: refused: {err}", flush=True)
            continue
        busy = "not measured" if busy is None else f"{busy:.2f} ms"
        print(f"engine {name}: suggest_batch wall mean {np.mean(walls):.1f} "
              f"ms, median {np.median(walls):.1f}, least {min(walls):.1f} "
              f"over {iters} calls, device {busy}; generator launches a "
              f"call {launches or 'none (logits step)'}", flush=True)
        del eng
        torch.cuda.empty_cache()


def merge_times(pkg) -> None:
    from torch.profiler import ProfilerActivity, profile

    gen = importlib.import_module(f"{pkg}.ops.kernels.beamgen"
                                  ).generator_topk_lse
    g = torch.Generator().manual_seed(6)
    table = (torch.randn((EMSIZE, VOCAB), generator=g) * 0.1).to(
        "cuda", torch.bfloat16)
    for step, rows, kc in (("beam-5", 1600, 6), ("greedy", 320, 2)):
        x = (torch.randn((rows, EMSIZE), generator=g)).to("cuda",
                                                          torch.bfloat16)
        for _ in range(3):
            gen(x, table, kc)
        torch.cuda.synchronize()
        calls = 20
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                gen(x, table, kc)
            torch.cuda.synchronize()
        times = {}
        for ev in prof.key_averages():
            dev = getattr(ev, "device_time_total", None)
            if dev is None:
                dev = getattr(ev, "cuda_time_total", 0)
            if dev and ev.count:
                times[ev.key] = (dev / calls, ev.count / calls)
        if not times:
            print(f"kernel 2 {step} R={rows} kc={kc}: the profiler saw no "
                  "device time (not measured)", flush=True)
            continue
        for key, (us, n) in sorted(times.items(), key=lambda kv: -kv[1][0]):
            print(f"kernel 2 {step} R={rows} kc={kc}: {key[:60]} "
                  f"{us:.2f} us a call ({n:g} launches)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--cases", default="")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    pkg = "context_attentive_ir_tpu_torch"
    mod = importlib.import_module(pkg)
    if not Path(mod.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {mod.__file__}, not from {root}")
    print(f"package of {root}", flush=True)
    merge_times(pkg)
    engine_times(pkg, args.iters, {c for c in args.cases.split(",") if c})
    return 0


if __name__ == "__main__":
    sys.exit(main())
