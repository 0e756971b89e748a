#!/usr/bin/env python3
"""Device times of the generator kernels -- kernel 2 (serial), 2p
(``prune``), 2q (the int8 table, pruned as the int8 Engine runs it) and 3
(``pipeline``) -- in bfloat16 and float32 at the decode steps' shapes, to
compare two checkouts on one card.

    python3 scripts/torch_generator_kernel_times.py [--root DIR]
        [--shapes NAME,...] [--dtypes bfloat16,float32]

Imports the package of the checkout at DIR (default: the one this script
lies in) and makes, on the card from one seed, x [R, E] and a table
[E, 50,000] (0.5 * standard normal; the int8 table of the same embedding
with its per-row scale).  For each shape and dtype it prints one line per
kernel: the mean device time of a few calls after one warm-up call (CUDA
events), then the library call's time (``torch.matmul`` with TF32 off,
``logsumexp`` and ``topk``; int8: the matmul on the table cast to x's
dtype, times the scale) and the bound (2 * R * E * V operations at 989
TFLOP/s bf16 or split TF32's 165 TFLOP/s float32, against the inputs'
bytes at 3.35 TB/s).  Shapes (``--shapes`` keeps those named):
``beam5`` (R = 1,600, E = 256, kc = 6), ``greedy`` (320, 256, 2),
``kc33`` / ``kc128`` (1,605, 256), ``beam40`` (12,800, 256, 41),
``beam127`` (40,640, 256, 128), ``e1536`` / ``e2048`` (1,600, E, 6).
Run it for each checkout in one call, in turns (A, B, B, A).  Needs a
card.
"""

from __future__ import annotations

import argparse
import importlib
import subprocess
import sys
from pathlib import Path

import torch

VOCAB = 50_000
SHAPES = {"beam5": (1600, 256, 6), "greedy": (320, 256, 2),
          "kc33": (1605, 256, 33), "kc128": (1605, 256, 128),
          "beam40": (12_800, 256, 41), "beam127": (40_640, 256, 128),
          "e1536": (1600, 1536, 6), "e2048": (1600, 2048, 6)}
PEAK = {torch.bfloat16: 989e12, torch.float32: 165e12}
HBM = 3.35e12
MODES = (("2", {}), ("2p", {"prune": True}), ("2q", {"prune": True}),
         ("3", {"pipeline": True}))


def timed_ms(fn, iters: int) -> float:
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


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def inputs(dtype, rows: int, e: int):
    gen = torch.Generator(device="cuda").manual_seed(rows + e)
    x = (torch.randn((rows, e), generator=gen, device="cuda") * 0.5)
    emb = torch.randn((VOCAB, e), generator=gen, device="cuda") * 0.5
    scale = emb.abs().amax(-1) / 127.0
    q_t = torch.round(emb / scale[:, None]).to(torch.int8).t().contiguous()
    return x.to(dtype), emb.t().contiguous().to(dtype), q_t, scale


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--dtypes", default="bfloat16,float32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    beamgen = importlib.import_module(
        "context_attentive_ir_tpu_torch.ops.kernels.beamgen")
    if not Path(beamgen.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {beamgen.__file__}, not from {root}")
    gen_fn = beamgen.generator_topk_lse
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"generator kernels of {root} on {card()}", flush=True)
    for name in args.shapes.split(","):
        rows, e, kc = SHAPES[name]
        iters = 2 if rows * kc > 1e6 else 5
        for dname in args.dtypes.split(","):
            dtype = getattr(torch, dname)
            x, table, q_t, scale = inputs(dtype, rows, e)
            size = x.element_size()
            out = rows * (kc * 8 + 4)
            t_ops = 2.0 * rows * e * VOCAB / PEAK[dtype] * 1e3
            at = f"{name} R={rows} E={e} kc={kc} {dname}"
            for mode, kw in MODES:
                tab, kw = ((q_t, dict(kw, scale=scale)) if mode == "2q"
                           else (table, kw))
                ms = timed_ms(lambda: gen_fn(x, tab, kc, **kw), iters)
                n_bytes = (x.numel() * size + out
                           + (q_t.numel() + VOCAB * 4 if mode == "2q"
                              else table.numel() * size))
                bound = max(t_ops, n_bytes / HBM * 1e3)
                print(f"kernel {mode} {at}: {ms:.4f} ms (bound {bound:.4f})",
                      flush=True)

            def library(t, s=None):
                logits = torch.matmul(x, t)
                if s is not None:
                    logits = logits * s
                return torch.logsumexp(logits.float(), -1), torch.topk(
                    logits, kc)

            q_cast = q_t.to(dtype)
            s_cast = scale.to(dtype)
            lib = timed_ms(lambda: library(table), iters)
            lib_q = timed_ms(lambda: library(q_cast, s_cast), iters)
            print(f"library {at}: {lib:.4f} ms, int8 table {lib_q:.4f} ms",
                  flush=True)
            del x, table, q_t, scale, q_cast
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
