#!/usr/bin/env python3
"""SHA-256 digests of the PyTorch port's kernels' outputs on seeded
inputs, to show whether two checkouts compute the same bits, and the
recurrent kernels' device times, to compare two checkouts on one card.

    python3 scripts/torch_kernel_digest.py [--root DIR]

Builds the kernel library of the checkout at DIR (default: the one this
script lies in) and prints one line per kernel, dtype and direction:
kernels 1, 4 and 5 (LSTM) and 7, 8 and 9 (GRU) at the doc encoder's shape
[16000, 30, 256] -> 128 and -> 256, at the two other block layouts of
the bf16 tiles below H = 512 ([1000, 9, 512] -> 256, [2000, 13, 300] ->
384, E and H not multiples of 32 padded), on clusters ([640, 7, 256] ->
512 and 1,024) and past them ([640, 7, 256] -> 1,152: the step route;
a checkout whose gate refuses a shape prints "not held" there), time
chunk 6, kernel 6 (the recurrence on
precomputed gates) at x_proj [16000, 30, 512] -> 128, the generator's kernel 2
(serial, ``prune``, int8 ``scale``) and 3 (``pipeline``) at the beam-5
step's shape (R = 1600, E = 256, V = 50,000, kc = 6), the greedy step's (R
= 320, kc = 2), the old top-kc (R = 1605, E = 300, kc = 32), top-33 and
top-128 (R = 1605, E = 256) and each dtype's last whole x tile of kernel 3
(E = 976 bf16, 352 float32), each
generator line ending in its serial kernel's time, and the slate pool's
kernel 10 at every width to 1,024 at the rank slate's and suggest init's
rows ([16000 | 1280, 30, H]), at T = 65 (past the resident kernel's
tile) and 33, past 1,024 (H = 2,304) and at 1,024 forced onto the wide
route, in float32 and
bfloat16, with a digest of each output's bytes, each line ending in its
time (``--only slate``: these lines alone); then float32 kernels 5 and 9 alone at the
shapes of their split-TF32 tiles (F32_BWD_SHAPES: the recommenders'
source [64, 150, 256] -> 128, the doc encoder's rows at H = 384, 512 and
1,024, the one block's and the old kernel's edges, an odd E and H), each
line ending in its time over F32_ITERS calls.  Two checkouts print the
same digest for a kernel exactly when it gives the same bits.  The
backward kernels (5, 9) are fed the boundaries of their residual kernels'
plain versions, so their lines do not move with kernels 4 and 8.  A
recurrent kernel's line ends in `` | <t> ms``: the mean of ITERS calls
(CUDA events, after two warm-up calls); run the script for each checkout
in one call, in turns (A, B, B, A), and compare the digests with
``cut -d'|' -f1``.  Needs a card.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import sys
from pathlib import Path

import torch

ROWS, STEPS, EMBED, HIDDEN, TIME_CHUNK = 16000, 30, 256, 128, 6
# (rows, steps, E, H) of the recurrent kernels' digests
RNN_SHAPES = ((ROWS, STEPS, EMBED, HIDDEN), (ROWS, STEPS, EMBED, 256),
              (1000, 9, 512, 256), (2000, 13, 300, 384),
              (640, 7, EMBED, 512), (640, 7, EMBED, 1024),
              (640, 7, EMBED, 1152))
ITERS = 5
# (rows, steps, E, H) of float32 kernels 5 and 9 alone, timed over
# F32_ITERS calls after one warm-up call
F32_BWD_SHAPES = ((64, 150, EMBED, HIDDEN), (ROWS, STEPS, EMBED, 384),
                  (ROWS, STEPS, EMBED, 512), (ROWS, STEPS, EMBED, 1024),
                  (2000, 13, EMBED, 256), (2000, 13, EMBED, 257),
                  (2000, 13, EMBED, 403), (2000, 13, EMBED, 404),
                  (2000, 13, 37, 200))
F32_ITERS = 2
BEAM_ROWS, VOCAB, KC = 1600, 50_000, 6
# (rows, E, kc) of the generator digests: the beam-5 and greedy steps, the
# old top-32 off the row block, past one and four top-kc slots, kernel 3's
# last whole x tile (E by dtype)
GEN_SHAPES = ((BEAM_ROWS, EMBED, KC), (320, EMBED, 2), (1605, 300, 32),
              (1605, EMBED, 33), (1605, EMBED, 128), (BEAM_ROWS, None, KC))
WHOLE_TILE = {torch.float32: 352, torch.bfloat16: 976}


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def inputs(gates: int, n_bias: int, dtype, rows=ROWS, steps=STEPS,
           embed=EMBED, hidden=HIDDEN):
    """x, mask, [w_ih, biases..., w_hh] (the kernels' argument order is
    built by the caller), dout; made on the CPU from one seed."""
    gen = torch.Generator().manual_seed(gates)
    x = torch.randn((rows, steps, embed), generator=gen) * 0.5
    w_ih = torch.randn((embed, gates * hidden), generator=gen) * 0.08
    w_hh = torch.randn((hidden, gates * hidden), generator=gen) * 0.08
    biases = [torch.randn((gates * hidden,), generator=gen) * 0.1
              for _ in range(n_bias)]
    lens = torch.randint(0, steps + 1, (rows,), generator=gen)
    lens[0], lens[1] = steps, 0
    mask = torch.arange(steps)[None, :] < lens[:, None]
    dout = torch.randn((rows, steps, hidden), generator=gen) * 0.5
    cuda = [t.to("cuda", dtype) for t in (x, w_ih, *biases, w_hh, dout)]
    return cuda[0], mask.cuda(), cuda[1:-1], cuda[-1]


def timed_ms(fn, iters: int = ITERS, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, after ``warmup``
    warm-up calls (CUDA events)."""
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


def generator_inputs(dtype, rows=BEAM_ROWS, embed=EMBED):
    """x [rows, embed], table_t [embed, 50000] and its int8 form (q_t,
    scale), made on the CPU from one seed."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((rows, embed), generator=gen) * 0.5
    emb = torch.randn((VOCAB, embed), generator=gen) * 0.5
    scale = emb.abs().amax(-1) / 127.0
    q_t = torch.round(emb / scale[:, None]).to(torch.int8).t().contiguous()
    return (x.to("cuda", dtype), emb.t().contiguous().to("cuda", dtype),
            q_t.cuda(), scale.cuda())


def generator_digests(beamgen, dtype, name: str) -> None:
    for rows, embed, kc in GEN_SHAPES:
        embed = embed or WHOLE_TILE[dtype]
        x, table_t, q_t, scale = generator_inputs(dtype, rows, embed)
        at = "" if (rows, embed, kc) == GEN_SHAPES[0] else \
            f" R={rows} E={embed} kc={kc}"
        for kernel, table, kw in (
                ("generator_topk_lse", table_t, {}),
                ("generator_topk_lse_pruned", table_t, {"prune": True}),
                ("generator_topk_lse_int8", q_t, {"scale": scale}),
                ("generator_topk_lse_int8_pruned", q_t,
                 {"scale": scale, "prune": True}),
                ("generator_topk_lse_pipelined", table_t,
                 {"pipeline": True})):
            out = beamgen.generator_topk_lse(x, table, kc, **kw)
            torch.cuda.synchronize()
            line = f"{kernel} {name}{at}: {digest(*out)}"
            if not kw:
                ms = timed_ms(lambda: beamgen.generator_topk_lse(x, table,
                                                                 kc))
                line += f" | {ms:.3f} ms"
            print(line, flush=True)


def recurrence_digests(lstm, dtype, name: str) -> None:
    """Kernel 6 at x_proj [16000, 30, 512] -> 128 (row 0 full, row 1 fully
    masked), both directions, inputs made on the CPU from one seed."""
    gen = torch.Generator().manual_seed(6)
    x_proj = torch.randn((ROWS, STEPS, 4 * HIDDEN), generator=gen) * 0.5
    w_hh = torch.randn((HIDDEN, 4 * HIDDEN), generator=gen) * 0.08
    lens = torch.randint(0, STEPS + 1, (ROWS,), generator=gen)
    lens[0], lens[1] = STEPS, 0
    mask = (torch.arange(STEPS)[None, :] < lens[:, None]).cuda()
    x_proj, w_hh = (t.to("cuda", dtype) for t in (x_proj, w_hh))
    for reverse in (False, True):
        out = lstm.lstm_recurrence_fwd(x_proj, mask, w_hh, reverse)
        torch.cuda.synchronize()
        way = "reverse" if reverse else "forward"
        print(f"lstm_recurrence {name} {way}: {digest(out)}", flush=True)


# (rows, steps, H, wide) of kernel 10's lines: every width to 1,024 at the
# rank slate's and suggest init's rows, T = 65 (past the resident tile)
# and 33, the wide route past 1,024 and forced at 1,024
SLATE_SHAPES = (*((r, STEPS, h, False) for h in range(128, 1025, 128)
                  for r in (ROWS, 1280)),
                (1280, 65, 256, False), (1280, 33, 1024, False),
                (1280, STEPS, 2304, False), (1280, STEPS, 1024, True))


def slate_digests(slate, dtype, name: str) -> None:
    """Kernel 10 at each of SLATE_SHAPES (rows 0 and 5 fully masked),
    inputs made on the card from one seed a shape, each line ending in the
    mean device time of ITERS calls (fewer at the largest shapes)."""
    for i, (rows, steps, h, wide) in enumerate(SLATE_SHAPES):
        at = (f" [{rows},{steps},{h}]" + (" wide" if wide else ""))
        if not slate.pool_supported(h, rows):
            print(f"attn_pool {name}{at}: not held", flush=True)
            continue
        gen = torch.Generator(device="cuda").manual_seed(10 + i)

        def uniform(*shape, scale=1.0):
            return ((torch.rand(shape, generator=gen, device="cuda") * 2 - 1)
                    * scale)

        states = uniform(rows, steps, h)
        query = uniform(rows, h)
        w_p = uniform(h, h, scale=0.1)
        b_p = uniform(h, scale=0.1)
        lens = torch.randint(0, steps + 1, (rows,), generator=gen,
                             device="cuda")
        lens[0], lens[5] = 0, 0
        mask = torch.arange(steps, device="cuda")[None, :] < lens[:, None]
        args = [(t * mask[..., None] if t is states else t).to(dtype)
                for t in (states, query, w_p, b_p)]
        del states, query, w_p, b_p

        def call():
            return slate.attn_pool(args[0], mask, *args[1:], wide=wide)

        out = call()
        torch.cuda.synchronize()
        flops = 2.0 * rows * steps * h * h
        ms = timed_ms(call, max(2, min(ITERS, int(2e11 / flops))), 1)
        print(f"attn_pool {name}{at}: {digest(out)} | {ms:.3f} ms",
              flush=True)
        del args, mask, out
        torch.cuda.empty_cache()


def f32_bwd_digests(lstm, gru) -> None:
    """Float32 kernels 5 and 9 at F32_BWD_SHAPES, both directions, fed the
    boundaries of their residual kernels' plain versions."""
    for (rnn, mod, gates, n_bias), shape in (
            (r, s) for r in (("lstm", lstm, 4, 1), ("gru", gru, 3, 2))
            for s in F32_BWD_SHAPES):
        at = " [%d,%d,%d]->%d" % shape
        x, mask, w, dout = inputs(gates, n_bias, torch.float32, *shape)
        w = w if rnn == "lstm" else [w[0], w[1], w[3], w[2]]
        for reverse in (False, True):
            state = getattr(mod, f"{rnn}_fused_res_reference")(
                x, mask, *w, reverse, TIME_CHUNK)[1:]

            def call():
                return getattr(mod, f"{rnn}_fused_bwd")(
                    x, mask, *w, *state, dout, reverse, TIME_CHUNK)

            outs = call()
            torch.cuda.synchronize()
            ms = timed_ms(call, F32_ITERS, 1)
            way = "reverse" if reverse else "forward"
            print(f"{rnn}_fused_bwd float32 alone {way}{at}: "
                  f"{digest(*outs)} | {ms:.3f} ms", flush=True)
            del state, outs
        del x, mask, w, dout
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--only", choices=("all", "slate"), default="all",
                    help="slate: kernel 10's lines alone")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    if not torch.cuda.is_available():
        print("torch_kernel_digest: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    lstm = importlib.import_module(
        "context_attentive_ir_tpu_torch.ops.kernels.lstm")
    gru = importlib.import_module(
        "context_attentive_ir_tpu_torch.ops.kernels.gru")
    beamgen = importlib.import_module(
        "context_attentive_ir_tpu_torch.ops.kernels.beamgen")
    slate = importlib.import_module(
        "context_attentive_ir_tpu_torch.ops.kernels.slate")
    if not Path(lstm.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {lstm.__file__}, not from {root}")
    print(f"kernels of {root}")
    if args.only == "slate":
        for dtype in (torch.float32, torch.bfloat16):
            slate_digests(slate, dtype, str(dtype).split(".")[-1])
        return 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for (rnn, mod, gates, n_bias), shape in (
                (r, s) for r in (("lstm", lstm, 4, 1), ("gru", gru, 3, 2))
                for s in RNN_SHAPES):
            at = "" if shape == RNN_SHAPES[0] else " [%d,%d,%d]->%d" % shape
            held = (lstm.fused_supported if rnn == "lstm"
                    else gru.gru_fused_supported)(shape[2], shape[3],
                                                  shape[0], dtype)
            if not held:
                print(f"{rnn}_fused* {name}{at}: not held", flush=True)
                continue
            x, mask, w, dout = inputs(gates, n_bias, dtype, *shape)
            # the modules' argument order: lstm (w_ih, b, w_hh), gru
            # (w_ih, b_ih, w_hh, b_hh)
            w = w if rnn == "lstm" else [w[0], w[1], w[3], w[2]]
            for reverse in (False, True):
                way = ("reverse" if reverse else "forward") + at
                state = getattr(mod, f"{rnn}_fused_res_reference")(
                    x, mask, *w, reverse, TIME_CHUNK)[1:]
                calls = {
                    f"{rnn}_fused": lambda: (getattr(mod, f"{rnn}_fused")(
                        x, mask, *w, reverse),),
                    f"{rnn}_fused_res": lambda: getattr(
                        mod, f"{rnn}_fused_res")(x, mask, *w, reverse,
                                                 TIME_CHUNK),
                    f"{rnn}_fused_bwd": lambda: getattr(
                        mod, f"{rnn}_fused_bwd")(x, mask, *w, *state, dout,
                                                 reverse, TIME_CHUNK)}
                for kernel, call in calls.items():
                    with torch.inference_mode(kernel == f"{rnn}_fused"):
                        outs = call()
                        torch.cuda.synchronize()
                        ms = timed_ms(call)
                    print(f"{kernel} {name} {way}: {digest(*outs)} | "
                          f"{ms:.3f} ms", flush=True)
                del state, outs
            del x, mask, w, dout
            torch.cuda.empty_cache()
        recurrence_digests(lstm, dtype, name)
        generator_digests(beamgen, dtype, name)
        slate_digests(slate, dtype, name)
    f32_bwd_digests(lstm, gru)
    return 0


if __name__ == "__main__":
    sys.exit(main())
