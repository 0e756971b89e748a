#!/usr/bin/env python3
"""Device time by kernel of the port's recurrent backwards (kernels 5 and
9: phase A, phase B's weight-gradient products, a cluster's phase C dx
product, the fixed-order sums), one call each, under ``torch.profiler``.

    python3 scripts/torch_bwd_profile.py [--dtype float32|bfloat16]
                                         [--hidden 128,256,1024]

Inputs are the digest script's seeded ones (``torch_kernel_digest.inputs``)
at the doc encoder's rows and steps, ``[16000, 30, 256] -> H``, one
direction, time chunk 6, the backward fed its residual kernel's plain
boundaries; one warm-up call precedes the profiled one.  Prints one line a
recurrence and width: each kernel's device ms and launches, largest first.
Needs a card.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--hidden", default="128,256,1024")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_bwd_profile: no CUDA device", file=sys.stderr)
        return 1
    from context_attentive_ir_tpu_torch.ops.kernels import gru, lstm

    dtype = getattr(torch, args.dtype)
    print(torch.cuda.get_device_name(0), flush=True)
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
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            rows = sorted(((e.key, e.device_time_total / 1e3, e.count)
                           for e in prof.key_averages()
                           if e.device_time_total > 0),
                          key=lambda r: -r[1])
            total = sum(t for _, t, _ in rows)
            print(f"{rnn}_fused_bwd {args.dtype} [{ROWS},{STEPS},{EMBED}]->{h}"
                  f": {total:.2f} ms on the device; " + "; ".join(
                      f"{k[:72]} {t:.2f} ms x{c}"
                      for k, t, c in rows[:5]), flush=True)
            del x, mask, w, dout, state
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
