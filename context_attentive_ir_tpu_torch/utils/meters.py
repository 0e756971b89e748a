"""AverageMeter / Timer bookkeeping.

Parity target: ``neuroir/utils/misc.py`` / ``timer.py`` (SURVEY.md SS2.9,
marker ``exp:``).

A copy of ``context_attentive_ir_tpu/utils/meters.py`` (no JAX in it), kept so
that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import time


class AverageMeter:
    """Running average of a scalar."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0


class Timer:
    """Resumable wall-clock timer."""

    def __init__(self):
        self.running = True
        self.total = 0.0
        self.start = time.time()

    def reset(self):
        self.running = True
        self.total = 0.0
        self.start = time.time()
        return self

    def resume(self):
        if not self.running:
            self.running = True
            self.start = time.time()
        return self

    def stop(self):
        if self.running:
            self.running = False
            self.total += time.time() - self.start
        return self

    def time(self) -> float:
        if self.running:
            return self.total + time.time() - self.start
        return self.total
