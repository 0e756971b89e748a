"""Beam search (port of ``context_attentive_ir_tpu/decode/beam.py``, the
``legacy`` bookkeeping and ``exact`` top-k the JAX package uses off-TPU).

Beam state is a tree (dicts/tuples) of ``[B*K, ...]`` tensors; each step is
per-beam top-(K+1) over the raw scores -> merge over ``[B, K*(K+1)]`` ->
gather, and finished beams are frozen by forcing PAD continuations at zero
added log-prob.  The GNMT length penalty ranks the hypotheses.  Every top-k
breaks ties toward the lower index, as ``lax.top_k`` does (a stable
descending sort).

Step functions return ``(state, logits [B*K, V])`` (normalised in-loop by a
logsumexp), optionally with their attention as a third value ``attn
[B*K, L]``, or, in the fused-generator mode, ``(state, (vals [B*K, Kc],
idx [B*K, Kc], lse [B*K]))`` from ``ops/kernels/beamgen.py``.  With
attention exposed and ``coverage_beta > 0`` the accumulated coverage is
penalised at ranking time (``penalties.COVERAGE_PENALTIES``).

``early_exit`` breaks out of the step loop once every beam of every row is
finished.  That is exactly the JAX identity step (``beam.py`` frozen
branch): the remaining positions stay PAD and scores, lengths and finished
flags are unchanged.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..constants import BOS, EOS, PAD
from ..ops.masking import NEG_INF
from .penalties import COVERAGE_PENALTIES, LENGTH_PENALTIES

StepFn = Callable[..., tuple]


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a dict/tuple/list tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree):
    """Iterate over the tensor leaves of a dict/tuple/list tree."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def topk_desc(x: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, descending, ties
    to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_beams(tree, parent: torch.Tensor, batch_size: int,
                  beam_size: int):
    """Reindex leaves [B*K, ...] by parent beam ids [B, K]."""
    offsets = torch.arange(batch_size, device=parent.device)[:, None]
    flat_idx = (parent + offsets * beam_size).reshape(-1)
    return tree_map(lambda x: x.index_select(0, flat_idx), tree)


def beam_search(step_fn: StepFn, init_state, batch_size: int, max_len: int,
                beam_size: int = 5, alpha: float = 0.6,
                return_nbest: bool = False, min_length: int = 0,
                length_penalty: str = "wu", coverage_beta: float = 0.0,
                coverage_penalty: str = "wu",
                cov_mask: torch.Tensor | None = None,
                early_exit: bool = False):
    """Returns (best tokens [B, max_len], best score [B]); with
    ``return_nbest`` the full beams ([B, K, max_len], [B, K]) sorted by
    normalised score.  ``init_state`` holds ``[B, ...]`` leaves and is tiled
    here.  ``min_length`` forbids EOS before that many real tokens.
    ``cov_mask [B, L]`` marks the real source positions for the coverage
    term (all of them when None); the fused-generator mode exposes no
    attention and takes no coverage penalty."""
    B, K = batch_size, beam_size
    state = tree_map(lambda x: x.repeat_interleave(K, dim=0), init_state)
    dev = next(tree_leaves(state)).device
    tokens = torch.full((B, K), BOS, dtype=torch.long, device=dev)
    logps = torch.tensor([0.0] + [NEG_INF] * (K - 1), dtype=torch.float32,
                         device=dev).repeat(B, 1)
    finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
    lengths = torch.zeros((B, K), dtype=torch.long, device=dev)
    seqs = torch.full((B, K, max_len), PAD, dtype=torch.long, device=dev)
    cov = None   # [B, K, L] once a logits step has exposed its attention

    for t in range(max_len):
        if early_exit and bool(finished.all()):
            break
        out = step_fn(state, tokens.reshape(B * K))
        state = out[0]
        if isinstance(out[1], (tuple, list)):
            t1, i1, lse = out[1]
            Kc = t1.shape[-1]
            if Kc < K + 1:
                raise ValueError(
                    f"fused step must provide at least K+1={K + 1} entries, "
                    f"got {Kc} (exactness needs one spare slot for a "
                    "blocked EOS, like the per-beam top-(K+1))")
            t1 = t1.float()
            lse = lse.float()[:, None]
        else:
            scores32 = out[1].float()
            Kc = min(K + 1, scores32.shape[-1])
            lse = torch.logsumexp(scores32, dim=-1, keepdim=True)
            t1, i1 = topk_desc(scores32, Kc)
        logp_top = (t1 - lse).reshape(B, K, Kc)
        i1 = i1.reshape(B, K, Kc).long()
        pad_row = torch.full((Kc,), NEG_INF, dtype=torch.float32, device=dev)
        pad_row[0] = 0.0
        logp_top = torch.where(finished[..., None], pad_row, logp_top)
        i1 = i1.masked_fill(finished[..., None], PAD)
        if min_length > 0 and t < min_length:
            block = (i1 == EOS) & ~finished[..., None]
            logp_top = logp_top.masked_fill(block, NEG_INF)
        total = logps[..., None] + logp_top                     # [B, K, Kc]
        top_logp, top_idx = topk_desc(total.reshape(B, K * Kc), K)
        parent = top_idx // Kc
        tok = torch.gather(i1.reshape(B, K * Kc), 1, top_idx)
        state = _gather_beams(state, parent, B, K)
        finished_p = torch.gather(finished, 1, parent)
        still = ~finished_p
        lengths = torch.gather(lengths, 1, parent) + still.long()
        if (coverage_beta > 0 and len(out) == 3
                and not isinstance(out[1], (tuple, list))):
            attn = out[2].reshape(B, K, -1).float()
            if cov is None:
                cov = torch.zeros_like(attn)
            cov = torch.gather(cov, 1, parent[..., None].expand_as(cov))
            cov = cov + attn * still[..., None]
        finished = finished_p | (tok == EOS)
        seqs = torch.gather(seqs, 1, parent[..., None].expand(B, K, max_len))
        seqs[:, :, t] = torch.where(still, tok, PAD)
        tokens, logps = tok, top_logp

    norm = logps / LENGTH_PENALTIES[length_penalty](lengths.clamp_min(1),
                                                    alpha)
    if cov is not None:
        mask = (torch.ones_like(cov, dtype=torch.bool) if cov_mask is None
                else cov_mask[:, None, :])
        norm = norm + COVERAGE_PENALTIES[coverage_penalty](cov, mask,
                                                           coverage_beta)
    ranked = norm + finished.float() * 1e4
    if return_nbest:
        order = torch.argsort(-ranked, dim=-1, stable=True)     # [B, K]
        nb_seqs = torch.gather(seqs, 1,
                               order[..., None].expand(B, K, max_len))
        return nb_seqs, torch.gather(norm, 1, order)
    best = torch.argmax(ranked, dim=-1)
    rows = torch.arange(B, device=dev)
    return seqs[rows, best], norm[rows, best]
