"""``utils/profiling.py`` of the port: ``timed`` fences on its value's
device, ``debug_mode`` names the op behind a NaN gradient,
``profile_trace`` writes a Chrome trace of the block."""

import json
import time

import pytest
import torch

from context_attentive_ir_tpu_torch import utils
from context_attentive_ir_tpu_torch.utils.profiling import (
    debug_mode,
    profile_trace,
    timed,
)


def test_exports():
    assert utils.timed is timed and utils.debug_mode is debug_mode
    assert utils.profile_trace is profile_trace


def test_timed_measures_the_block():
    x = torch.ones(64, 64)
    with timed(x) as box:
        time.sleep(0.02)
        y = x @ x
    assert box["seconds"] >= 0.02
    with timed({"y": y, "rest": [y, (y,)]}) as box:
        pass
    assert 0 <= box["seconds"] < 1.0
    with timed() as box:
        pass
    assert box["seconds"] >= 0


def test_debug_mode_catches_a_nan_gradient():
    w = torch.tensor([0.0, 1.0], requires_grad=True)

    def nan_backward():
        (w.sqrt() * 0.0).sum().backward()   # d sqrt(0) = inf, * 0 -> nan

    nan_backward()                            # silently NaN without it
    assert torch.isnan(w.grad).any()
    w.grad = None
    with debug_mode():
        with pytest.raises(RuntimeError, match="nan"):
            nan_backward()
    with debug_mode(nans=False, disable_jit=True):
        nan_backward()                        # traces only, no NaN check
    assert not torch.is_anomaly_enabled()


def test_profile_trace_writes_a_trace(tmp_path):
    logdir = tmp_path / "prof"
    with profile_trace(logdir) as prof:
        torch.randn(32, 32) @ torch.randn(32, 32)
    trace = logdir / "trace.json"
    assert trace.is_file()
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert len(prof.key_averages()) > 0
