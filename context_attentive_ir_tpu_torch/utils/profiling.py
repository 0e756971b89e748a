"""Tracing, timing and numerical-debug helpers (port of
``context_attentive_ir_tpu/utils/profiling.py``).

- ``profile_trace(logdir)``: a ``torch.profiler`` trace around a block,
  over the CPU and, when a card is there, over CUDA, written into
  ``logdir`` as a Chrome trace (``trace.json``; open it in Perfetto or
  ``chrome://tracing``);
- ``timed(sync_value)``: a wall-clock block timer that fences on the
  value's device before it reads the clock -- a CUDA synchronize for a
  tensor on the card, a host copy otherwise;
- ``debug_mode(nans=True)``: autograd's anomaly mode, which names the
  forward op whose backward produced a NaN.  ``disable_jit`` is accepted
  for the JAX signature and changes nothing: the port runs eagerly, op by
  op, always.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def profile_trace(logdir: str | Path):
    """``torch.profiler`` trace around a block, over the card too when
    there is one, exported to ``logdir/trace.json``.  Yields the profiler
    (``key_averages()`` and the rest are read after the block)."""
    from torch.profiler import ProfilerActivity, profile

    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(logdir / "trace.json"))


def _fence(value) -> None:
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            torch.cuda.synchronize(value.device)
        else:
            value.cpu()
    elif isinstance(value, dict):
        for v in value.values():
            _fence(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _fence(v)


@contextlib.contextmanager
def timed(sync_value=None):
    """Wall-clock a block into the yielded dict's ``seconds``; with
    ``sync_value`` (a tensor, or a dict / list / tuple of them) the clock
    stops only after the work behind it has finished on its device."""
    box = {}
    t0 = time.perf_counter()
    yield box
    if sync_value is not None:
        _fence(sync_value)
    box["seconds"] = time.perf_counter() - t0


@contextlib.contextmanager
def debug_mode(nans: bool = True, disable_jit: bool = False):
    """Anomaly detection for a block: a backward that produces a NaN
    raises, naming the forward op behind it (with ``nans=False`` only the
    forward traces are recorded).  ``disable_jit`` has no effect (the
    port has no jit)."""
    del disable_jit
    with torch.autograd.detect_anomaly(check_nan=nans):
        yield
