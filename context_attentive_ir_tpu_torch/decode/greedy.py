"""Greedy decoding (port of ``context_attentive_ir_tpu/decode/greedy.py``).

Step functions return raw logits ``[B, V]`` or, in the fused-generator
mode, ``(vals [B, Kc], idx [B, Kc], lse [B])`` with ``Kc >= 2`` (greedy
blocks at most one token, EOS under ``min_length``, so the best unblocked
token is always within the top 2).  ``early_exit`` breaks out of the loop
once every row is finished, which is exactly the JAX identity step: the
remaining positions stay PAD and the scores are unchanged.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..constants import BOS, EOS, PAD
from ..ops.masking import NEG_INF
from .beam import tree_leaves

StepFn = Callable[..., tuple]


def greedy_decode(step_fn: StepFn, init_state, batch_size: int,
                  max_len: int, min_length: int = 0,
                  early_exit: bool = False):
    """Returns (tokens [B, max_len], logprob_sum [B])."""
    state = init_state
    dev = next(tree_leaves(state)).device
    tokens = torch.full((batch_size,), BOS, dtype=torch.long, device=dev)
    finished = torch.zeros((batch_size,), dtype=torch.bool, device=dev)
    total = torch.zeros((batch_size,), dtype=torch.float32, device=dev)
    out_toks = torch.full((batch_size, max_len), PAD, dtype=torch.long,
                          device=dev)
    for t in range(max_len):
        if early_exit and bool(finished.all()):
            break
        out = step_fn(state, tokens)
        state = out[0]
        blocked = min_length > 0 and t < min_length
        if isinstance(out[1], (tuple, list)):
            vals, idx, lse = out[1]
            if vals.shape[-1] < 2:
                raise ValueError(
                    "fused greedy step must provide at least 2 entries (one "
                    f"spare slot for a blocked EOS), got {vals.shape[-1]}")
            vals, lse = vals.float(), lse.float()
            if blocked:
                vals = vals.masked_fill(idx == EOS, NEG_INF)
            j = torch.argmax(vals, dim=-1, keepdim=True)
            next_tok = torch.gather(idx, 1, j)[:, 0].long()
            step_lp = torch.gather(vals, 1, j)[:, 0] - lse
        else:
            logp = out[1]
            # normaliser taken before any EOS block (the model distribution)
            lse = torch.logsumexp(logp.float(), dim=-1)
            if blocked:
                logp = logp.clone()
                logp[:, EOS] = NEG_INF
            next_tok = torch.argmax(logp, dim=-1)
            step_lp = logp.amax(dim=-1).float() - lse
        next_tok = next_tok.masked_fill(finished, PAD)
        total = total + torch.where(finished, 0.0, step_lp)
        finished = finished | (next_tok == EOS)
        out_toks[:, t] = next_tok
        tokens = next_tok
    return out_toks, total
