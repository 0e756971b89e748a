"""Structured logging: console + file + JSONL metric stream.

Parity target: the reference's python ``logging`` to console +
``model_name.txt``, args json dump, and result tables (SURVEY.md SS5.5).
The rebuild adds a machine-readable ``metrics.jsonl`` stream (one JSON
object per event) as promised in SURVEY.md SS5.5's rebuild column.

A copy of ``context_attentive_ir_tpu/utils/logging.py`` (no JAX in it), kept so
that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path


def setup_logging(log_file: str | Path | None = None,
                  level: int = logging.INFO) -> logging.Logger:
    root = logging.getLogger()
    root.setLevel(level)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s",
                            "%m/%d %H:%M:%S")
    if not any(isinstance(h, logging.StreamHandler) for h in root.handlers):
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        root.addHandler(sh)
    if log_file is not None:
        log_file = Path(log_file)
        log_file.parent.mkdir(parents=True, exist_ok=True)
        # dedup by target path: repeat calls in one process (train run then
        # only_test, test suites driving the CLI) must not stack handlers
        # (duplicated lines + leakage into earlier runs' log files)
        target = str(log_file.resolve())
        for h in list(root.handlers):
            if isinstance(h, logging.FileHandler):
                if h.baseFilename == target:
                    return root
                root.removeHandler(h)
                h.close()
        fh = logging.FileHandler(target)
        fh.setFormatter(fmt)
        root.addHandler(fh)
    return root


class MetricsWriter:
    """Append-only JSONL metric stream + optional tensorboard scalars.

    Tensorboard output (SURVEY.md SS5.5 rebuild column) uses
    ``torch.utils.tensorboard`` when available (torch-cpu ships in this
    image); absent that, the JSONL stream is the source of truth.
    """

    def __init__(self, path: str | Path, tensorboard: bool = False):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(
                    log_dir=str(self.path.parent / "tb"))
            except Exception:  # pragma: no cover - optional dep
                self._tb = None

    def write(self, event: str, step: int | None = None, **fields):
        rec = {"event": event, "time": time.time(), **fields}
        if step is not None:
            rec["step"] = step
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in fields.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(f"{event}/{k}", v, step or 0)
            self._tb.flush()
        return rec


def format_table(rows: list[dict], title: str = "") -> str:
    """Human-readable results table (the prettytable analogue)."""
    if not rows:
        return title
    cols = list(rows[0].keys())
    widths = {c: max(len(str(c)), *(len(_fmt(r.get(c))) for r in rows))
              for c in cols}
    sep = "+" + "+".join("-" * (widths[c] + 2) for c in cols) + "+"
    out = [title, sep,
           "|" + "|".join(f" {c:<{widths[c]}} " for c in cols) + "|", sep]
    for r in rows:
        out.append("|" + "|".join(
            f" {_fmt(r.get(c)):<{widths[c]}} " for c in cols) + "|")
    out.append(sep)
    return "\n".join(x for x in out if x)


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.4f}"
    return str(v)
