"""Beam search (port of ``context_attentive_ir_tpu/decode/beam.py``, the
``legacy`` bookkeeping the JAX package uses off-TPU, and its ``topk_method``
choices).

Beam state is a tree (dicts/tuples) of ``[B*K, ...]`` tensors; each step is
per-beam top-(K+1) over the raw scores -> merge over ``[B, K*(K+1)]`` ->
gather, and finished beams are frozen by forcing PAD continuations at zero
added log-prob.  The GNMT length penalty ranks the hypotheses.  Every top-k
breaks ties toward the lower index, as ``lax.top_k`` does.  The per-beam
top-(K+1) over the vocabulary (``_topk_rows``) sorts no row: ``exact`` is
``topk_exact`` (a library top-k, then the order of its few winners fixed);
``chunked`` is the JAX two-stage form on top of it; ``approx`` takes
``exact`` (off the TPU ``lax.approx_max_k`` returns ``lax.top_k``'s values
and indices) and ``auto`` the port's dispatch table's choice.
The merge over ``K * (K+1)`` columns keeps the stable sort (``topk_desc``).

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
from ..ops.dispatch import prefer_chunked_topk
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
    """The k largest along the last axis, descending, ties to the lower
    index, by a stable sort of the whole axis (which, unlike ``lax.top_k``,
    holds -0.0 and +0.0 equal): for short rows and the plain versions."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


TOPK_METHODS = ("auto", "exact", "chunked", "approx")


def _sortable_int(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 whose signed order is ``lax.top_k``'s total order
    of the floats (-0.0 below +0.0; NaN not handled)."""
    b = x.contiguous().view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def _packed_keys(x: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """int64 keys, unique within a row, whose descending order is
    ``lax.top_k``'s: the value (``_sortable_int``) in the high 32 bits,
    ``0xFFFFFFFF - column`` in the low ones (ties to the lower column)."""
    return _sortable_int(x).long() * (1 << 32) + (0xFFFFFFFF - cols)


def _resolve_tied(x: torch.Tensor, top: torch.Tensor, idx: torch.Tensor,
                  k: int) -> torch.Tensor:
    """Top-k columns of rows whose k-th largest value ``thr`` is tied past
    the k slots: the columns above ``thr`` (all within ``idx``), then the
    lowest columns that equal it (+0.0 before -0.0), found by a top-k of
    their negated ranks (float32, exact below 2**24).  ``top`` / ``idx``:
    the rows' library top-k values and columns [n, k]."""
    V = x.shape[-1]
    thr = top[:, -1:]
    cols = torch.arange(V, device=x.device, dtype=torch.float32)
    neg_rank = torch.where(torch.signbit(x), -V - cols, -cols)
    _, tied = torch.topk(torch.where(x == thr, neg_rank, float("-inf")), k,
                         dim=-1)
    above = top > thr
    n_above = above.sum(-1, keepdim=True)
    first = idx.gather(1, torch.argsort((~above).int(), dim=1, stable=True))
    slot = torch.arange(k, device=x.device)[None]
    rest = tied.gather(1, (slot - n_above).clamp_min(0))
    return torch.where(slot < n_above, first, rest)


def topk_exact(x: torch.Tensor, k: int):
    """``lax.top_k`` of each row of ``x [R, V]`` (float32): the k largest,
    descending, ties to the lower column, +0.0 above -0.0; no sort over V.

    A library top-(k+1) gives the k largest values; where the k-th is
    strictly above the (k+1)-th the set of columns is unique, and only the
    order of the k winners is fixed (by their packed keys).  Rows whose
    k-th value is tied past the k slots (which the library may fill from
    any of the tied columns) take ``_resolve_tied``; finding them reads one
    flag a row on the host.  A row no wider than k is ordered whole."""
    R, V = x.shape
    if k >= V:
        idx = torch.arange(V, device=x.device).expand(R, V)
    else:
        top, idx = torch.topk(x, k + 1, dim=-1)
        tied = (top[:, k - 1] == top[:, k]).nonzero()[:, 0]
        top, idx = top[:, :k], idx[:, :k]
        if tied.numel():
            idx = idx.index_copy(0, tied, _resolve_tied(
                x.index_select(0, tied), top.index_select(0, tied),
                idx.index_select(0, tied), k))
    order = _packed_keys(x.gather(1, idx), idx).argsort(dim=1,
                                                        descending=True)
    idx = idx.gather(1, order)
    return x.gather(1, idx), idx


def _chunk_count(v: int, kc: int) -> int:
    """Largest G <= 32 with G | V and V/G >= 4*Kc (0 if none)."""
    for g in range(32, 1, -1):
        if v % g == 0 and v // g >= 4 * kc:
            return g
    return 0


def _resolve_topk_method(method: str, v: int = 0, kc: int = 0) -> str:
    """``auto`` resolves from the port's dispatch table of H100 rows
    (``ops.dispatch.prefer_chunked_topk`` at ``v`` and ``kc``: ``chunked``
    where a row measured it faster, ``exact`` elsewhere), as the JAX
    package resolves it from its TPU table; ``approx`` is ``exact``: off
    the TPU ``lax.approx_max_k`` returns ``lax.top_k``'s values and
    indices at the beam's widths.  Both choices give the same bits."""
    if method not in TOPK_METHODS:
        raise ValueError(f"unknown topk_method {method!r}; choose from "
                         f"{TOPK_METHODS}")
    if method == "auto":
        return "chunked" if prefer_chunked_topk(v, kc) else "exact"
    return "exact" if method == "approx" else method


def _topk_rows(scores: torch.Tensor, kc: int, method: str):
    """Top-``kc`` of each row of ``[R, V]`` (JAX ``_topk_rows``): ``exact``
    is ``topk_exact``; ``chunked`` the exact two-stage form -- top-kc
    within each of G vocab chunks, then top-kc over the G*kc chunk winners
    (every global winner is within its chunk's top-kc, and chunk order is
    column order, so the ties resolve as in one stage); it takes ``exact``
    where ``_chunk_count`` finds no G."""
    method = _resolve_topk_method(method, scores.shape[-1], kc)
    if method == "chunked":
        v = scores.shape[-1]
        g = _chunk_count(v, kc)
        if g:
            r, vc = scores.shape[0], v // g
            tc, ic = topk_exact(scores.reshape(r * g, vc), kc)
            base = (torch.arange(g, device=scores.device) * vc)[None, :, None]
            gid = (ic.reshape(r, g, kc) + base).reshape(r, g * kc)
            t1, sel = topk_exact(tc.reshape(r, g * kc), kc)
            return t1, gid.gather(1, sel)
    return topk_exact(scores, kc)


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
                topk_method: str = "auto", early_exit: bool = False):
    """Returns (best tokens [B, max_len], best score [B]); with
    ``return_nbest`` the full beams ([B, K, max_len], [B, K]) sorted by
    normalised score.  ``init_state`` holds ``[B, ...]`` leaves and is tiled
    here.  ``min_length`` forbids EOS before that many real tokens.
    ``cov_mask [B, L]`` marks the real source positions for the coverage
    term (all of them when None); the fused-generator mode exposes no
    attention and takes no coverage penalty.  ``topk_method`` picks the
    logits step's per-beam top-(K+1) (``_topk_rows``)."""
    _resolve_topk_method(topk_method)   # raises on an unknown one
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
            t1, i1 = _topk_rows(scores32, Kc, topk_method)
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
