#!/usr/bin/env python3
"""Device time by kernel of the port's recurrent backwards (kernels 5 and
9: phase A, phase B's weight-gradient products, a cluster's phase C dx
product, the fixed-order sums), one call each, under ``torch.profiler``;
with ``--cars-step``, of a whole CARS and CARS-GRU train step instead.

    python3 scripts/torch_bwd_profile.py [--dtype float32|bfloat16]
                                         [--hidden 128,256,1024]
                                         [--cars-step] [--root DIR]

Inputs are the digest script's seeded ones (``torch_kernel_digest.inputs``)
at the doc encoder's rows and steps, ``[16000, 30, 256] -> H``, one
direction, time chunk 6, the backward fed its residual kernel's plain
boundaries; one warm-up call precedes the profiled one.  Prints one line a
recurrence and width: each kernel's device ms and launches, largest first.
``--cars-step``: one Adam step of chip_smoke's ``full_width_config``
CARS (and CARS-GRU) in ``--dtype`` at B = 64 sessions, after two warm-up
steps, its device ms by kernel (the ten largest and the total).
``--root``: the checkout whose package and chip_smoke run (default: this
one), to compare two in one call.  Needs a card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from scripts.torch_kernel_digest import (  # noqa: E402
    EMBED,
    ROWS,
    STEPS,
    TIME_CHUNK,
    inputs,
)


def device_rows(fn):
    """``fn()`` once under ``torch.profiler``: (total device ms, [(kernel,
    ms, launches)] largest first)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.device_time_total / 1e3, e.count)
                   for e in prof.key_averages() if e.device_time_total > 0),
                  key=lambda r: -r[1])
    return sum(t for _, t, _ in rows), rows


def cars_steps(dtype: str) -> int:
    """One profiled Adam step each of a CARS and a CARS-GRU at the serving
    widths in ``dtype``."""
    import numpy as np

    import chip_smoke
    from context_attentive_ir_tpu_torch.models import build_model
    from context_attentive_ir_tpu_torch.train import (
        create_train_state,
        make_train_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for tag, kw in (("cars", {}), ("cars_gru", chip_smoke.GRU)):
        cfg = chip_smoke.full_width_config("cars", compute_dtype=dtype, **kw)
        model = build_model(cfg, device="cuda", seed=0)
        box = [create_train_state(model, cfg)]
        step = make_train_step(model, cfg)
        batch = chip_smoke.random_session_batch(
            np.random.RandomState(17)).to("cuda")

        def call():
            box[0], _ = step(box[0], batch, 1)

        for _ in range(2):
            call()
        torch.cuda.synchronize()
        total, rows = device_rows(call)
        print(f"train step {dtype} {tag} B={chip_smoke.B}: {total:.2f} ms on "
              "the device; " + "; ".join(f"{k[:64]} {t:.2f} ms x{c}"
                                         for k, t, c in rows[:10]),
              flush=True)
        del model, box, step
        torch.cuda.empty_cache()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--hidden", default="128,256,1024")
    ap.add_argument("--cars-step", action="store_true")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_bwd_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from context_attentive_ir_tpu_torch.ops.kernels import gru, lstm

    dtype = getattr(torch, args.dtype)
    print(torch.cuda.get_device_name(0), f"({lstm.__file__})", flush=True)
    if args.cars_step:
        return cars_steps(args.dtype)
    for h in (int(v) for v in args.hidden.split(",")):
        for rnn, mod, gates, n_bias in (("lstm", lstm, 4, 1),
                                        ("gru", gru, 3, 2)):
            x, mask, w, dout = inputs(gates, n_bias, dtype, ROWS, STEPS,
                                      EMBED, h)
            w = w if rnn == "lstm" else [w[0], w[1], w[3], w[2]]
            state = getattr(mod, f"{rnn}_fused_res_reference")(
                x, mask, *w, False, TIME_CHUNK)[1:]

            def call():
                return getattr(mod, f"{rnn}_fused_bwd")(
                    x, mask, *w, *state, dout, False, TIME_CHUNK)

            call()
            torch.cuda.synchronize()
            total, rows = device_rows(call)
            print(f"{rnn}_fused_bwd {args.dtype} [{ROWS},{STEPS},{EMBED}]->{h}"
                  f": {total:.2f} ms on the device; " + "; ".join(
                      f"{k[:72]} {t:.2f} ms x{c}"
                      for k, t, c in rows[:5]), flush=True)
            del x, mask, w, dout, state
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
