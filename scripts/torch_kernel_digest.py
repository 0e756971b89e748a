#!/usr/bin/env python3
"""SHA-256 digests of the PyTorch port's kernels' outputs on seeded
inputs, to show whether two checkouts compute the same bits.

    python3 scripts/torch_kernel_digest.py [--root DIR]

Builds the kernel library of the checkout at DIR (default: the one this
script lies in) and prints one line per kernel, dtype and direction:
kernels 1, 4 and 5 (LSTM) and 7, 8 and 9 (GRU) at the doc encoder's shape
[16000, 30, 256] -> 128, time chunk 6, the generator's kernel 2
(serial, ``prune``, int8 ``scale``) and 3 (``pipeline``) at the beam-5
step's shape (R = 1600, E = 256, V = 50,000, kc = 6), and the slate pool's
kernel 10 at the rank slate's and suggest init's shapes ([16000, 30, 256]
and [1280, 30, 256]), in float32 and bfloat16, with a digest of each
output's bytes.  Two checkouts print the
same line for a kernel exactly when it gives the same bits.  The backward
kernels (5, 9) are fed the boundaries of their residual kernels' plain
versions, so their lines do not move with kernels 4 and 8.  Needs a card.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import sys
from pathlib import Path

import torch

ROWS, STEPS, EMBED, HIDDEN, TIME_CHUNK = 16000, 30, 256, 128, 6
BEAM_ROWS, VOCAB, KC = 1600, 50_000, 6


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def inputs(gates: int, n_bias: int, dtype):
    """x, mask, [w_ih, biases..., w_hh] (the kernels' argument order is
    built by the caller), dout; made on the CPU from one seed."""
    gen = torch.Generator().manual_seed(gates)
    x = torch.randn((ROWS, STEPS, EMBED), generator=gen) * 0.5
    w_ih = torch.randn((EMBED, gates * HIDDEN), generator=gen) * 0.08
    w_hh = torch.randn((HIDDEN, gates * HIDDEN), generator=gen) * 0.08
    biases = [torch.randn((gates * HIDDEN,), generator=gen) * 0.1
              for _ in range(n_bias)]
    lens = torch.randint(0, STEPS + 1, (ROWS,), generator=gen)
    lens[0], lens[1] = STEPS, 0
    mask = torch.arange(STEPS)[None, :] < lens[:, None]
    dout = torch.randn((ROWS, STEPS, HIDDEN), generator=gen) * 0.5
    cuda = [t.to("cuda", dtype) for t in (x, w_ih, *biases, w_hh, dout)]
    return cuda[0], mask.cuda(), cuda[1:-1], cuda[-1]


def generator_inputs(dtype):
    """x [1600, 256], table_t [256, 50000] and its int8 form (q_t, scale),
    made on the CPU from one seed."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((BEAM_ROWS, EMBED), generator=gen) * 0.5
    emb = torch.randn((VOCAB, EMBED), generator=gen) * 0.5
    scale = emb.abs().amax(-1) / 127.0
    q_t = torch.round(emb / scale[:, None]).to(torch.int8).t().contiguous()
    return (x.to("cuda", dtype), emb.t().contiguous().to("cuda", dtype),
            q_t.cuda(), scale.cuda())


def generator_digests(beamgen, dtype, name: str) -> None:
    x, table_t, q_t, scale = generator_inputs(dtype)
    for kernel, table, kw in (
            ("generator_topk_lse", table_t, {}),
            ("generator_topk_lse_pruned", table_t, {"prune": True}),
            ("generator_topk_lse_int8", q_t, {"scale": scale}),
            ("generator_topk_lse_int8_pruned", q_t,
             {"scale": scale, "prune": True}),
            ("generator_topk_lse_pipelined", table_t, {"pipeline": True})):
        out = beamgen.generator_topk_lse(x, table, KC, **kw)
        torch.cuda.synchronize()
        print(f"{kernel} {name}: {digest(*out)}", flush=True)


def slate_digests(slate, dtype, name: str) -> None:
    """Kernel 10 at R = 16,000 and 1,280 documents of T = 30, H = 256 (rows
    0 and 5 fully masked), inputs made on the CPU from one seed."""
    gen = torch.Generator().manual_seed(10)
    for rows in (16000, 1280):
        states = torch.rand((rows, STEPS, 2 * HIDDEN), generator=gen) * 2 - 1
        query = torch.rand((rows, 2 * HIDDEN), generator=gen) * 2 - 1
        w_p = (torch.rand((2 * HIDDEN, 2 * HIDDEN), generator=gen) * 2 - 1
               ) * 0.1
        b_p = (torch.rand((2 * HIDDEN,), generator=gen) * 2 - 1) * 0.1
        lens = torch.randint(0, STEPS + 1, (rows,), generator=gen)
        lens[0], lens[5] = 0, 0
        mask = torch.arange(STEPS)[None, :] < lens[:, None]
        states = states * mask[..., None]
        out = slate.attn_pool(*(t.to("cuda", dtype) if t.is_floating_point()
                                else t.cuda()
                                for t in (states, mask, query, w_p, b_p)))
        torch.cuda.synchronize()
        print(f"attn_pool {name} R={rows}: {digest(out)}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    root = Path(ap.parse_args().root).resolve()
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
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for rnn, mod, gates, n_bias in (("lstm", lstm, 4, 1),
                                        ("gru", gru, 3, 2)):
            x, mask, w, dout = inputs(gates, n_bias, dtype)
            # the modules' argument order: lstm (w_ih, b, w_hh), gru
            # (w_ih, b_ih, w_hh, b_hh)
            w = w if rnn == "lstm" else [w[0], w[1], w[3], w[2]]
            for reverse in (False, True):
                way = "reverse" if reverse else "forward"
                with torch.no_grad():
                    fwd = getattr(mod, f"{rnn}_fused")(x, mask, *w, reverse)
                res = getattr(mod, f"{rnn}_fused_res")(x, mask, *w, reverse,
                                                       TIME_CHUNK)
                state = getattr(mod, f"{rnn}_fused_res_reference")(
                    x, mask, *w, reverse, TIME_CHUNK)[1:]
                bwd = getattr(mod, f"{rnn}_fused_bwd")(
                    x, mask, *w, *state, dout, reverse, TIME_CHUNK)
                torch.cuda.synchronize()
                for kernel, outs in ((f"{rnn}_fused", (fwd,)),
                                     (f"{rnn}_fused_res", res),
                                     (f"{rnn}_fused_bwd", bwd)):
                    print(f"{kernel} {name} {way}: {digest(*outs)}",
                          flush=True)
        generator_digests(beamgen, dtype, name)
        slate_digests(slate, dtype, name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
