#!/usr/bin/env python3
"""How far the bf16 and float32 LSTM kernels part from their plain
versions step by step, at the doc encoder's rows and steps, as H and the
recurrent weights' scale grow.

    python3 scripts/torch_lstm_error_growth.py

For each case, kernel 1 (``lstm_fused``) and its plain version
(``lstm_fused_reference``) run on the same seeded inputs ``[16000, 30,
256] -> H`` (x ~ 0.5 N(0, 1), W_ih ~ 0.08 N(0, 1), W_hh ~ ``scale`` N(0,
1), every step unmasked) and the script prints the largest absolute
difference at every third step, the last step's median and 99.9th
percentile (over its first million values), and how many of the last
step's values differ by more than 0.02.  Both sides round h to the compute
dtype before the recurrent product; where the recurrence amplifies a
difference in those last bits, the difference grows with the step in any
pair of implementations, and the float32 case shows the growth without the
bf16 rounding.  Needs a card.
"""

from __future__ import annotations

import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from context_attentive_ir_tpu_torch.ops.kernels.lstm import (  # noqa: E402
    lstm_fused,
    lstm_fused_reference,
)

ROWS, STEPS, EMBED = 16000, 30, 256
# (H, dtype, W_hh scale): 1,024 on a cluster, 1,152 and 2,048 on the step
# route at the fixed scale, 2,048 at 1,152's gain, 2,048 in float32
CASES = ((1024, torch.bfloat16, 0.08), (1152, torch.bfloat16, 0.08),
         (2048, torch.bfloat16, 0.08),
         (2048, torch.bfloat16, 0.08 * math.sqrt(1152 / 2048)),
         (2048, torch.float32, 0.08))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_lstm_error_growth: needs a card", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    for h, dtype, scale in CASES:
        dev = "cuda"
        x = torch.randn((ROWS, STEPS, EMBED), generator=gen, device=dev) * 0.5
        w_ih = torch.randn((EMBED, 4 * h), generator=gen, device=dev) * 0.08
        b = torch.randn((4 * h,), generator=gen, device=dev) * 0.1
        w_hh = torch.randn((h, 4 * h), generator=gen, device=dev) * scale
        x, w_ih, b, w_hh = (t.to(dtype) for t in (x, w_ih, b, w_hh))
        mask = torch.ones((ROWS, STEPS), dtype=torch.bool, device=dev)
        with torch.inference_mode():
            got = lstm_fused(x, mask, w_ih, b, w_hh).float()
            ref = lstm_fused_reference(x, mask, w_ih, b, w_hh).float()
        d = (got - ref).abs()
        by_step = [float(d[:, t].max()) for t in range(0, STEPS, 3)]
        last = d[:, -1].flatten()
        q = torch.quantile(last[:1_000_000],
                           torch.tensor([0.5, 0.999], device=dev))
        print(f"H={h} {str(dtype)[6:]} W_hh scale {scale:.4f}: max abs "
              f"difference at steps 0, 3, ..., 27: "
              + " ".join(f"{v:.2e}" for v in by_step)
              + f"; last step median {float(q[0]):.2e}, p99.9 "
              f"{float(q[1]):.2e}, above 0.02: {int((last > 0.02).sum())} "
              f"of {last.numel()}", flush=True)
        del x, w_ih, b, w_hh, got, ref, d, last
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
