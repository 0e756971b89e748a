"""Measured dispatch between a kernel and its plain version, and between
the kernels' exact variants (port of
``context_attentive_ir_tpu/ops/dispatch.py``).

The JAX package keeps one table of TPU timings; the port keeps its own,
``dispatch_table.json`` beside this module, with rows measured on the H100
by ``scripts/torch_dispatch_table.py`` (its ``comment`` names the card and
its power limit).  No TPU row is copied: a TPU time says nothing about the
H100.  The lookups follow the JAX package's: an exact match on the shape
keys, the nearest row count (and vocabulary) by log distance, and
``NEAR_TIE_MARGIN`` before a row overrides the default.

The defaults differ where the JAX package's default is its TPU's plain
formulation.  On the H100 every choice between a hand-written kernel and
the plain PyTorch version defaults to the kernel, measured or not: an
inference RNN shape the table has not measured takes the kernel (the JAX
rule, ``rows < SCAN_FASTER_ROWS = 6000``, is a TPU crossover; at the doc
encoder's 16,000 rows it would send the H100 to a scan seven times
slower), and a measured row prefers the plain version only when that wins
by the margin.  ``prefer_fused_generator`` follows the same rule.  Such a
row decides only on CPU tensors, where the kernels' plain versions run:
on CUDA tensors ``RNNLayer.kernel_ok`` and the Engine's decode step raise
on it rather than trade a kernel for plain PyTorch on the card (every
H100 row measured so far prefers the kernel).  Choices between two exact
kernel variants (the chunked top-k, the pipelined or pruned generator)
keep the JAX default, off, unless a row measured the variant faster by
the margin; the one exception is the pruned generator above
``PRUNE_ABOVE_KC``, on by default (``prefer_pruned_generator``).

``prefer_fused_bookkeeping`` has no counterpart: the port's beam search
has one bookkeeping, which the JAX package's ``legacy`` and ``fused`` both
match.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

# The JAX package's TPU crossover, kept for reference and for the tests
# that hold the port's lookups to the JAX ones; the port's dispatch never
# reads it.
SCAN_FASTER_ROWS = 6000

# Margin by which a measured row must favour the non-default choice before
# the lookup takes it: timing noise between runs must not flip an exact,
# speed-only decision.
NEAR_TIE_MARGIN = 0.05

# Above this top-kc (one slot a lane in kernel 2's running top-kc) an
# unmeasured row count prunes.  The rule dates from the unpruned kernel's
# kc argmax passes a vocab tile (3-31x the pruned kernel's time at kc
# 33-128); both modes now insert only the columns that beat a row's kc-th
# entry and differ by the pruned mode's lockstep vote (PERF.md), so
# either choice costs about the same.
PRUNE_ABOVE_KC = 32

TABLE_PATH = Path(__file__).with_name("dispatch_table.json")

_table_cache: list[dict] | None = None


def _load_table() -> list[dict]:
    global _table_cache
    if _table_cache is None:
        # an absent file is a table of no rows; a malformed one raises
        _table_cache = (json.loads(TABLE_PATH.read_text())["entries"]
                        if TABLE_PATH.exists() else [])
    return _table_cache


def reload_table() -> None:
    """Drop the cached table (tests, and after ``write_table``)."""
    global _table_cache
    _table_cache = None


def _nearest(matches: list[dict], **points) -> dict:
    """The row nearest to ``points`` (key -> value) in summed log
    distance."""
    return min(matches, key=lambda x: sum(
        abs(math.log(max(v, 1) / x[k])) for k, v in points.items()))


def prefer_kernel(kind: str, rows: int, t: int, e: int, h: int,
                  dtype: str, training: bool) -> bool:
    """Should this ``[rows, t, e] -> h`` recurrence (``kind`` 'lstm' |
    'gru', ``dtype`` 'bfloat16' | 'float32') run on the fused kernels
    (kernel 1 / 7 for inference, the pairs 4 + 5 / 8 + 9 for training)
    rather than the plain scan?  Unmeasured: yes, in both modes.  Measured
    (an exact (kind, mode, t, e, h, dtype) match, the nearest row count):
    yes unless the scan was faster by more than ``NEAR_TIE_MARGIN``."""
    mode = "train" if training else "infer"
    matches = [x for x in _load_table()
               if x["kind"] == kind and x["mode"] == mode
               and x["t"] == t and x["e"] == e and x["h"] == h
               and x["dtype"] == dtype]
    if not matches:
        return True
    best = _nearest(matches, rows=rows)
    return not best["scan_ms"] < (1 - NEAR_TIE_MARGIN) * best["kernel_ms"]


def prefer_chunked_topk(v: int, kc: int) -> bool:
    """Should the logits step's top-kc be the chunked two-stage one
    (``decode/beam.py:_topk_rows``; both are exact)?  Measured
    ``beam_topk`` rows (exact ``kc``, nearest ``v``) decide; unmeasured:
    no."""
    matches = [x for x in _load_table()
               if x["kind"] == "beam_topk" and x["kc"] == kc]
    if not matches:
        return False
    best = _nearest(matches, v=v)
    return best["chunked_ms"] < (1 - NEAR_TIE_MARGIN) * best["exact_ms"]


def prefer_fused_generator(rows: int, v: int, e: int, kc: int,
                           t: int | None = None) -> bool:
    """Should a decode step run the fused generator kernel (kernels 2 / 3:
    projection, top-kc and logsumexp without the ``[rows, V]`` logits)
    rather than the logits step?  Unmeasured: yes.  Measured ``beam_gen``
    rows (exact (e, kc), nearest rows and v) decide: the logits step only
    when it was faster by more than ``NEAR_TIE_MARGIN``.  With ``t`` and a
    row carrying two-step totals (``fused_t2_ms`` / ``xla_t2_ms``) the
    comparison is of ``t2 + (t - 2) * per-step``, as in JAX; otherwise of
    the per-step times ``fused_ms`` / ``xla_ms``."""
    matches = [x for x in _load_table()
               if x["kind"] == "beam_gen" and x["kc"] == kc
               and x["e"] == e]
    if not matches:
        return True
    best = _nearest(matches, rows=rows, v=v)
    fused, plain = best["fused_ms"], best["xla_ms"]
    if t is not None and "fused_t2_ms" in best and "xla_t2_ms" in best:
        fused = best["fused_t2_ms"] + (t - 2) * fused
        plain = best["xla_t2_ms"] + (t - 2) * plain
    return not plain < (1 - NEAR_TIE_MARGIN) * fused


def prefer_pipelined_generator(rows: int, kc: int) -> bool:
    """Should the fused generator run kernel 3 (pipelined) rather than the
    serial kernel 2?  Both give the same bits.  Measured ``beam_gen_pipe``
    rows (exact ``kc``, nearest rows) decide; unmeasured: no."""
    matches = [x for x in _load_table()
               if x["kind"] == "beam_gen_pipe" and x["kc"] == kc]
    if not matches:
        return False
    best = _nearest(matches, rows=rows)
    return best["pipe_ms"] < (1 - NEAR_TIE_MARGIN) * best["serial_ms"]


def prefer_pruned_generator(rows: int, kc: int) -> bool:
    """Should the serial generator kernel skip the selection of a vocab
    tile whose best score cannot enter any row's top-kc (``prune``;
    exact, ties included)?  Measured ``beam_gen_prune`` rows (exact
    ``kc``, nearest rows) decide; unmeasured: no up to ``PRUNE_ABOVE_KC``
    (the JAX default), yes above it."""
    matches = [x for x in _load_table()
               if x["kind"] == "beam_gen_prune" and x["kc"] == kc]
    if not matches:
        return kc > PRUNE_ABOVE_KC
    best = _nearest(matches, rows=rows)
    return best["prune_ms"] < (1 - NEAR_TIE_MARGIN) * best["base_ms"]


_RNN_KEY = ("kind", "mode", "t", "e", "h", "dtype", "rows")


def merge_rnn_entries(new: list[dict], old: list[dict]) -> list[dict]:
    """Freshly measured RNN rows merged into an existing table: every row
    of another kind, and every RNN row not measured again in ``new``, is
    kept."""
    merged = list(new)
    fresh = {tuple(e[k] for k in _RNN_KEY) for e in new}
    for e in old:
        if e.get("kind") not in ("lstm", "gru"):
            merged.append(e)
        elif tuple(e[k] for k in _RNN_KEY) not in fresh:
            merged.append(e)
    return merged


def write_table(entries: list[dict], path: Path | None = None,
                comment: str = "") -> None:
    """Write ``entries`` (RNN rows: {kind: lstm | gru, mode, t, e, h,
    dtype, rows, kernel_ms, scan_ms}; ``beam_topk``: {v, kc, exact_ms,
    chunked_ms}; ``beam_gen``: {rows, v, e, kc, fused_ms, xla_ms};
    ``beam_gen_pipe``: {rows, kc, pipe_ms, serial_ms}; ``beam_gen_prune``:
    {rows, kc, prune_ms, base_ms}) with ``comment`` (the card, its power
    limit and the script) and drop the cached table."""
    payload = {"comment": comment, "entries": entries}
    (path or TABLE_PATH).write_text(json.dumps(payload, indent=1) + "\n")
    reload_table()
