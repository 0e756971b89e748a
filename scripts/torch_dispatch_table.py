#!/usr/bin/env python3
"""Measure the PyTorch port's dispatch table on the card and write it.

    python3 scripts/torch_dispatch_table.py [--dry-run] [--generator]

Times, with CUDA events (mean of several calls after warm-up), each choice
that ``context_attentive_ir_tpu_torch/ops/dispatch.py`` makes, at the
shapes the serving and training paths give it (bf16, E = 256, H = 128,
V = 50,000):

- ``lstm`` / ``gru`` rows, ``infer`` and ``train``: the fused kernels
  (kernel 1 / 7; the pairs 4 + 5 / 8 + 9 with a backward) against the
  plain scan (``x @ W_ih + b`` and ``lstm_scan`` / ``gru_scan``; autograd
  for the backward), one direction, at the doc encoder's [16000, 30], the
  clicked documents' [1280, 30], the query encoder's [320, 15] and the
  recommenders' flat source [64, 150];
- ``beam_gen``: the serial generator kernel against the logits step's
  work (the product, an f32 logsumexp and ``topk_exact``), per step, at
  the beam-5 step (R = 1600, kc = 6) and the greedy one (R = 320, kc = 2);
- ``beam_gen_prune`` / ``beam_gen_pipe``: the pruned and the pipelined
  kernel against the serial one at the same two shapes;
- ``beam_topk``: the logits step's ``chunked`` top-kc against ``exact``.

The inputs are seeded random tensors (a random-weight model's scores: the
conservative case for ``prune``, whose skips grow with front-loaded
scores).  Writes ``ops/dispatch_table.json`` with the card's name and
power limit in its ``comment`` (``--dry-run`` prints the rows and writes
nothing; ``--generator`` measures the ``beam_*`` rows alone and keeps the
table's other rows as they are).  ``chip_smoke.py --only parallel`` takes the same readings again
and logs them beside the committed table's choices.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

EMBED, HIDDEN, VOCAB = 256, 128, 50_000
RNN_SHAPES = ((16000, 30), (1280, 30), (320, 15), (64, 150))
BEAM_SHAPES = ((1600, 6), (320, 2))   # (rows, kc): beam-5, greedy


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def timed_ms(fn, iters: int = 5, warmup: int = 2) -> float:
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


def rnn_rows(gen) -> list[dict]:
    from context_attentive_ir_tpu_torch.ops.kernels.gru import (
        gru_fused,
        gru_fused_train,
    )
    from context_attentive_ir_tpu_torch.ops.kernels.lstm import (
        lstm_fused,
        lstm_fused_train,
    )
    from context_attentive_ir_tpu_torch.ops.rnn import gru_scan, lstm_scan

    dt, dev = torch.bfloat16, "cuda"
    out = []
    for kind, g in (("lstm", 4), ("gru", 3)):
        for rows, t in RNN_SHAPES:
            def rand(*shape, scale=0.1):
                return (torch.randn(shape, generator=gen, device=dev)
                        * scale).to(dt)

            x = rand(rows, t, EMBED, scale=1.0)
            mask = torch.ones(rows, t, dtype=torch.bool, device=dev)
            w_ih, b = rand(EMBED, g * HIDDEN), rand(g * HIDDEN)
            w_hh = rand(HIDDEN, g * HIDDEN)
            b_hh = (rand(g * HIDDEN),) if kind == "gru" else ()
            leaves = (x, w_ih, b, w_hh, *b_hh)

            def kernel(train, leaves=leaves):
                fn = {("lstm", False): lstm_fused,
                      ("lstm", True): lstm_fused_train,
                      ("gru", False): gru_fused,
                      ("gru", True): gru_fused_train}[(kind, train)]
                x, w_ih, b, w_hh, *b_hh = leaves
                o = fn(x, mask, w_ih, b, w_hh, *b_hh)
                if train:
                    o.float().sum().backward()

            def scan(train, leaves=leaves):
                x, w_ih, b, w_hh, *b_hh = leaves
                h0 = torch.zeros(rows, HIDDEN, dtype=dt, device=dev)
                if kind == "lstm":
                    o, _ = lstm_scan(x @ w_ih + b, mask, w_hh, h0, h0)
                else:
                    o, _ = gru_scan(x @ w_ih + b, mask, w_hh, b_hh[0], h0)
                if train:
                    o.float().sum().backward()

            for train in (False, True):
                args = tuple(v.detach().requires_grad_(train)
                             for v in leaves)
                with torch.set_grad_enabled(train):
                    k_ms = timed_ms(lambda: kernel(train, args))
                    s_ms = timed_ms(lambda: scan(train, args), iters=3)
                out.append({"kind": kind,
                            "mode": "train" if train else "infer", "t": t,
                            "e": EMBED, "h": HIDDEN, "dtype": "bfloat16",
                            "rows": rows, "kernel_ms": round(k_ms, 4),
                            "scan_ms": round(s_ms, 4)})
    return out


def beam_rows(gen) -> list[dict]:
    from context_attentive_ir_tpu_torch.decode.beam import _topk_rows
    from context_attentive_ir_tpu_torch.ops.kernels.beamgen import (
        generator_topk_lse,
    )

    dt, dev = torch.bfloat16, "cuda"
    table_t = (torch.randn((EMBED, VOCAB), generator=gen, device=dev)
               * 0.5).to(dt)
    out = []
    for rows, kc in BEAM_SHAPES:
        x = (torch.randn((rows, EMBED), generator=gen, device=dev)
             * 0.5).to(dt)

        def logits_step():
            logits = (x @ table_t).float()
            return torch.logsumexp(logits, -1), _topk_rows(logits, kc,
                                                           "exact")

        serial = timed_ms(lambda: generator_topk_lse(x, table_t, kc), 10)
        pruned = timed_ms(lambda: generator_topk_lse(x, table_t, kc,
                                                     prune=True), 10)
        piped = timed_ms(lambda: generator_topk_lse(x, table_t, kc,
                                                    pipeline=True), 10)
        plain = timed_ms(logits_step, 10)
        scores = (x @ table_t).float()
        exact = timed_ms(lambda: _topk_rows(scores, kc, "exact"), 10)
        chunked = timed_ms(lambda: _topk_rows(scores, kc, "chunked"), 10)
        out += [
            {"kind": "beam_gen", "rows": rows, "v": VOCAB, "e": EMBED,
             "kc": kc, "fused_ms": round(serial, 4),
             "xla_ms": round(plain, 4)},
            {"kind": "beam_gen_prune", "rows": rows, "kc": kc,
             "prune_ms": round(pruned, 4), "base_ms": round(serial, 4)},
            {"kind": "beam_gen_pipe", "rows": rows, "kc": kc,
             "pipe_ms": round(piped, 4), "serial_ms": round(serial, 4)},
            {"kind": "beam_topk", "v": VOCAB, "kc": kc, "rows": rows,
             "exact_ms": round(exact, 4), "chunked_ms": round(chunked, 4)},
        ]
    return out


def measure(seed: int = 0, generator_only: bool = False) -> list[dict]:
    """Every row of the table, measured now on the card; with
    ``generator_only`` the ``beam_*`` rows, the committed table's others
    kept."""
    from context_attentive_ir_tpu_torch.ops import dispatch
    from context_attentive_ir_tpu_torch.ops.kernels.build import build

    build()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if not generator_only:
        return rnn_rows(gen) + beam_rows(gen)
    dispatch.reload_table()
    kept = [e for e in dispatch._load_table()
            if not e["kind"].startswith("beam")]
    return kept + beam_rows(gen)


def decisions(entries: list[dict]) -> dict:
    """The choice ``ops.dispatch`` makes at each measured row's own shape
    when ``entries`` is its table."""
    from context_attentive_ir_tpu_torch.ops import dispatch

    old = dispatch.TABLE_PATH
    with tempfile.TemporaryDirectory() as tmp:
        dispatch.TABLE_PATH = Path(tmp) / "table.json"
        try:
            dispatch.write_table(entries, dispatch.TABLE_PATH)
            out = {}
            for e in entries:
                k, rows = e["kind"], e.get("rows")
                if k in ("lstm", "gru"):
                    out[f"{k}_{e['mode']}_{rows}x{e['t']}"] = (
                        "kernel" if dispatch.prefer_kernel(
                            k, rows, e["t"], e["e"], e["h"], e["dtype"],
                            e["mode"] == "train") else "scan")
                elif k == "beam_gen":
                    out[f"beam_gen_{rows}_kc{e['kc']}"] = (
                        "fused" if dispatch.prefer_fused_generator(
                            rows, e["v"], e["e"], e["kc"]) else "logits")
                elif k == "beam_gen_prune":
                    out[f"prune_{rows}_kc{e['kc']}"] = (
                        dispatch.prefer_pruned_generator(rows, e["kc"]))
                elif k == "beam_gen_pipe":
                    out[f"pipeline_{rows}_kc{e['kc']}"] = (
                        dispatch.prefer_pipelined_generator(rows, e["kc"]))
                elif k == "beam_topk":
                    out[f"chunked_topk_{rows}_kc{e['kc']}"] = (
                        dispatch.prefer_chunked_topk(e["v"], e["kc"]))
        finally:
            dispatch.TABLE_PATH = old
            dispatch.reload_table()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dry-run", action="store_true",
                    help="print the rows, write nothing")
    ap.add_argument("--generator", action="store_true",
                    help="measure the beam_* rows alone, keep the others")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_dispatch_table: no CUDA device", file=sys.stderr)
        return 1
    name = card()
    entries = measure(generator_only=args.generator)
    for e in entries:
        print(json.dumps(e))
    print(json.dumps(decisions(entries)))
    if not args.dry_run:
        from context_attentive_ir_tpu_torch.ops.dispatch import write_table

        write_table(entries, comment=(
            f"H100 readings ({name}; bf16; CUDA events, mean of 3-10 "
            "calls) by scripts/torch_dispatch_table.py; consulted by "
            "context_attentive_ir_tpu_torch.ops.dispatch"))
        print(f"wrote the table ({len(entries)} rows) on {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
