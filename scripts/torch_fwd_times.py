#!/usr/bin/env python3
"""Device times of the port's float32 recurrent forwards -- kernels 1, 4
(LSTM) and 7, 8 (GRU) -- beside their bound, their plain versions and
cuDNN's exact-f32 module, and of what surrounds them on the default
dtype's paths, to compare two checkouts on one card.

    python3 scripts/torch_fwd_times.py [--root DIR] [--hidden 128,256,...]
                                       [--no-plain] [--steps]

Builds the kernel library of the checkout at DIR (default: the one this
script lies in) and prints one line per recurrence, kernel and shape: the
doc encoder's rows and steps ``[16000, 30, 256] -> H`` for each H of
``--hidden`` and the recommenders' source ``[64, 150, 256] -> 128``, one
direction, time chunk 6, float32 with TF32 off for cuDNN and matmuls.
Each line holds the kernel's ms (CUDA events, mean of several calls after
warm-up), the plain version's (``--no-plain`` skips it), cuDNN's
``nn.LSTM`` / ``nn.GRU`` inference forward (kernels 1, 7) or training
forward (4, 8), and the bound: max(flops / 165 TFLOP/s, split TF32's
rate, bytes / 3.35 TB/s), with the bytes of x, out, the weights, the mask
and the boundaries each moved once.  Then ``stage_lstm_weights`` in
float32 alone at H = 128 and 1,024 (the staged ``[W_ih; W_hh]`` every
float32 tile kernel reads), and with ``--steps`` a float32 CARS and
CARS-GRU train step at the serving widths (chip_smoke's
``full_width_config``, B = 64 sessions; CUDA events, mean of 5 after 2).
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

ROWS, STEPS, EMBED, TIME_CHUNK = 16000, 30, 256, 6
SOURCE = (64, 150, EMBED, 128)
PEAK_F32 = 165e12       # split TF32: a third of TF32's 495 TFLOP/s
HBM = 3.35e12


def timed_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` calls after ``warmup``
    (CUDA events)."""
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


def inputs(gates: int, n_bias: int, rows, steps, embed, hidden):
    """x, mask, the weights in the kernels' argument order (LSTM w_ih, b,
    w_hh; GRU w_ih, b_ih, w_hh, b_hh), float32 on the card from one seed;
    W_hh scaled by min(1, sqrt(1024 / H)) as chip_smoke scales it."""
    gen = torch.Generator().manual_seed(gates * 100 + hidden)
    x = torch.randn((rows, steps, embed), generator=gen) * 0.5
    w_ih = torch.randn((embed, gates * hidden), generator=gen) * 0.08
    w_hh = (torch.randn((hidden, gates * hidden), generator=gen) * 0.08
            * min(1.0, (1024 / hidden) ** 0.5))
    biases = [torch.randn((gates * hidden,), generator=gen) * 0.1
              for _ in range(n_bias)]
    lens = torch.randint(1, steps + 1, (rows,), generator=gen)
    lens[0] = steps
    mask = torch.arange(steps)[None, :] < lens[:, None]
    w = [w_ih, biases[0], w_hh] if n_bias == 1 else [w_ih, biases[0], w_hh,
                                                      biases[1]]
    return x.cuda(), mask.cuda(), [t.cuda() for t in w]


def bound_ms(rows, steps, embed, hidden, gates, res: bool) -> float:
    flops = 2.0 * rows * steps * (embed + hidden) * gates * hidden
    n_bytes = (4 * rows * steps * (embed + hidden) + rows * steps
               + 4 * (embed + hidden + 2) * gates * hidden)
    if res:   # the boundaries: h (and the LSTM's c) before each chunk
        n_bytes += ((gates == 4) + 1) * 4 * rows * hidden * -(
            -steps // TIME_CHUNK)
    return 1e3 * max(flops / PEAK_F32, n_bytes / HBM)


def kernel_lines(mods, shapes, plain: bool) -> None:
    for rnn, gates, n_bias, cudnn_cls in (("lstm", 4, 1, torch.nn.LSTM),
                                          ("gru", 3, 2, torch.nn.GRU)):
        mod = mods[rnn]
        for rows, steps, embed, hidden in shapes:
            x, mask, w = inputs(gates, n_bias, rows, steps, embed, hidden)
            iters = 3 if hidden >= 512 else 10
            cudnn = cudnn_cls(embed, hidden, batch_first=True, device="cuda")
            xg = x.detach().requires_grad_()
            for name, res in ((f"{rnn}_fused", False),
                              (f"{rnn}_fused_res", True)):
                fn = getattr(mod, name)
                ref = getattr(mod, name + "_reference")
                args = (x, mask, *w)
                kw = {"time_chunk": TIME_CHUNK} if res else {}
                with torch.inference_mode(not res):
                    ms = timed_ms(lambda: fn(*args, **kw), iters)
                    plain_ms = (timed_ms(lambda: ref(*args, **kw), 1)
                                if plain else float("nan"))
                if res:
                    lib = timed_ms(lambda: cudnn(xg), iters)
                else:
                    with torch.inference_mode():
                        lib = timed_ms(lambda: cudnn(x), iters)
                print(f"{name} float32 [{rows},{steps},{embed}]->{hidden}: "
                      f"kernel {ms:.3f} ms | plain {plain_ms:.3f} ms | cuDNN "
                      f"{'training' if res else 'inference'} forward "
                      f"{lib:.3f} ms | bound "
                      f"{bound_ms(rows, steps, embed, hidden, gates, res):.4f}"
                      " ms", flush=True)
            del x, mask, w, cudnn, xg
            torch.cuda.empty_cache()


def staging_lines(lstm) -> None:
    """``stage_lstm_weights`` in float32 at E = 256, H = 128 (one matrix)
    and 1,024 (one a rank of ``f32_cluster``'s 8), LSTM and GRU gates."""
    for gates in (4, 3):
        for hidden in (128, 1024):
            gen = torch.Generator().manual_seed(hidden)
            w_ih = torch.randn((EMBED, gates * hidden), generator=gen).cuda()
            w_hh = torch.randn((hidden, gates * hidden), generator=gen).cuda()
            ranks = lstm.f32_cluster(hidden)
            ms = timed_ms(lambda: lstm.stage_lstm_weights(w_ih, w_hh, ranks,
                                                          gates), 20, 2)
            n_bytes = 2 * 4 * (EMBED + hidden) * gates * hidden
            print(f"stage_lstm_weights float32 E={EMBED} H={hidden} "
                  f"gates={gates} ranks={ranks}: {ms:.4f} ms (bound "
                  f"{1e3 * n_bytes / HBM:.4f} ms by bytes)", flush=True)


def step_lines() -> None:
    """A float32 CARS and CARS-GRU Adam step at the serving widths."""
    import numpy as np

    chip_smoke = importlib.import_module("chip_smoke")
    from context_attentive_ir_tpu_torch.models import build_model
    from context_attentive_ir_tpu_torch.train import (
        create_train_state,
        make_train_step,
    )

    for tag, kw in (("cars", {}), ("cars_gru", chip_smoke.GRU)):
        cfg = chip_smoke.full_width_config("cars", compute_dtype="float32",
                                           **kw)
        model = build_model(cfg, device="cuda", seed=0)
        state, step = create_train_state(model, cfg), make_train_step(model,
                                                                      cfg)
        batch = chip_smoke.random_session_batch(
            np.random.RandomState(17)).to("cuda")
        box = [state]

        def call():
            box[0], _ = step(box[0], batch, 1)

        ms = timed_ms(call, 5, 2)
        print(f"train step float32 {tag} B={chip_smoke.B}: {ms:.3f} ms",
              flush=True)
        del model, state, step, box
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--hidden", default="128,256,384,512,1024")
    ap.add_argument("--no-plain", action="store_true")
    ap.add_argument("--steps", action="store_true")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    if not torch.cuda.is_available():
        print("torch_fwd_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    mods = {rnn: importlib.import_module(
        f"context_attentive_ir_tpu_torch.ops.kernels.{rnn}")
        for rnn in ("lstm", "gru")}
    if not Path(mods["lstm"].__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {mods['lstm'].__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"forwards of {root} on {card}; TF32 off", flush=True)
    shapes = [(ROWS, STEPS, EMBED, int(h)) for h in args.hidden.split(",")]
    kernel_lines(mods, shapes + [SOURCE], not args.no_plain)
    staging_lines(mods["lstm"])
    if args.steps:
        step_lines()
    return 0


if __name__ == "__main__":
    sys.exit(main())
