"""The port's measured dispatch (``context_attentive_ir_tpu_torch/ops/
dispatch.py``) against the JAX package's (``ops/dispatch.py``): the cases
of tests/test_dispatch.py, each table handed to both modules.

The lookups agree (exact key match, nearest rows / vocabulary by log
distance, the near-tie margin), but for one intended difference, asserted
as such: between a kernel and its plain version the port's default is the
kernel, where the JAX package's is its TPU's plain formulation.  So an
unmeasured inference RNN shape takes the kernel (JAX: ``rows <
SCAN_FASTER_ROWS``, a TPU crossover), and so does an unmeasured or
near-tie ``prefer_fused_generator`` (JAX: the XLA logits step).  The
variant choices (chunked top-k, pipelined, pruned generator) keep the JAX
default.
"""

import json

import pytest
import torch
from test_torch_serve import BUCKET, REAL, _texts, served  # noqa: F401

from context_attentive_ir_tpu.ops import dispatch as jax_dispatch
from context_attentive_ir_tpu_torch.ops import dispatch
from context_attentive_ir_tpu_torch.ops import rnn
from context_attentive_ir_tpu_torch.ops.layers import reset_parameters
from context_attentive_ir_tpu_torch.ops.rnn import RNNLayer
from context_attentive_ir_tpu_torch.serve import Engine as PortEngine


@pytest.fixture
def table(tmp_path):
    """``table(entries)`` points both modules at one table file; the
    shipped tables come back afterwards."""
    old = (dispatch.TABLE_PATH, jax_dispatch.TABLE_PATH)
    path = tmp_path / "table.json"

    def use(entries):
        path.write_text(json.dumps({"entries": entries}))
        for mod in (dispatch, jax_dispatch):
            mod.TABLE_PATH = path
            mod.reload_table()
        return path

    yield use
    dispatch.TABLE_PATH, jax_dispatch.TABLE_PATH = old
    dispatch.reload_table()
    jax_dispatch.reload_table()


def _entry(rows, kernel_ms, scan_ms, **kw):
    base = dict(kind="lstm", mode="infer", t=30, e=256, h=128,
                dtype="bfloat16", rows=rows, kernel_ms=kernel_ms,
                scan_ms=scan_ms)
    base.update(kw)
    return base


def _both(name, *args, **kw):
    return (getattr(dispatch, name)(*args, **kw),
            getattr(jax_dispatch, name)(*args, **kw))


def test_training_always_kernel(table):
    table([])
    for args in (("lstm", 10 ** 6, 30, 256, 128, "bfloat16", True),
                 ("gru", 8, 5, 32, 128, "float32", True)):
        assert _both("prefer_kernel", *args) == (True, True)


def test_training_rule_overridden_by_measured_train_rows(table):
    table([_entry(2000, kernel_ms=9.0, scan_ms=1.0, mode="train")])
    assert _both("prefer_kernel", "lstm", 2000, 30, 256, 128, "bfloat16",
                 True) == (False, False)
    assert _both("prefer_kernel", "lstm", 2000, 15, 256, 128, "bfloat16",
                 True) == (True, True)
    # inference at the same family ignores train rows: both unmeasured,
    # where both rules take the kernel at 2,000 rows
    assert _both("prefer_kernel", "lstm", 2000, 30, 256, 128, "bfloat16",
                 False) == (True, True)


def test_beam_gen_dispatch(table):
    table([
        dict(kind="beam_gen", v=50_000, e=256, kc=6, rows=1600,
             fused_ms=6.3, xla_ms=8.9),
        dict(kind="beam_gen", v=5_000, e=256, kc=6, rows=1600,
             fused_ms=3.0, xla_ms=1.0),
        dict(kind="beam_gen", v=50_000, e=256, kc=2, rows=320,
             fused_ms=0.08, xla_ms=0.11, fused_t2_ms=6.2, xla_t2_ms=0.3),
    ])
    same = [((1600, 50_000, 256, 6), {}, True),
            ((2000, 40_000, 256, 6), {}, True),
            ((1600, 5_000, 256, 6), {}, False),
            ((320, 50_000, 256, 2), {"t": 16}, False),
            ((320, 50_000, 256, 2), {"t": 300}, True),
            ((320, 50_000, 256, 2), {}, True),
            ((1600, 50_000, 256, 6), {"t": 4}, True)]
    for args, kw, want in same:
        assert _both("prefer_fused_generator", *args, **kw) == (want, want)
    # unmeasured (e, kc): the port's default is the kernel, JAX's the
    # logits step
    for args in ((1600, 50_000, 300, 6), (1600, 50_000, 256, 4)):
        assert _both("prefer_fused_generator", *args) == (True, False)


def test_beam_gen_pipe_dispatch(table):
    table([dict(kind="beam_gen_pipe", rows=1600, kc=6, pipe_ms=20.0,
                serial_ms=30.0),
           dict(kind="beam_gen_pipe", rows=320, kc=2, pipe_ms=7.0,
                serial_ms=6.0)])
    for args, want in (((1600, 6), True), ((3000, 6), True),
                       ((320, 2), False), ((1600, 4), False)):
        assert _both("prefer_pipelined_generator", *args) == (want, want)


def test_beam_gen_prune_dispatch(table):
    table([dict(kind="beam_gen_prune", rows=1600, kc=6, prune_ms=1.27,
                base_ms=1.62),
           dict(kind="beam_gen_prune", rows=320, kc=2, prune_ms=1.0,
                base_ms=1.02)])
    for args, want in (((1600, 6), True), ((3000, 6), True),
                       ((320, 2), False), ((1600, 4), False)):
        assert _both("prefer_pruned_generator", *args) == (want, want)


def test_unmeasured_wide_top_kc_prunes(table):
    """The intended difference: an unmeasured kc above one slot a lane
    (``PRUNE_ABOVE_KC`` = 32) prunes in the port, where JAX keeps its
    default (off); at and below it both keep off, and a measured row still
    decides."""
    table([dict(kind="beam_gen_prune", rows=12800, kc=41, prune_ms=9.0,
                base_ms=8.0)])
    assert dispatch.PRUNE_ABOVE_KC == 32
    for rows in (320, 12800):
        for kc in (2, 6, 32):
            assert _both("prefer_pruned_generator", rows, kc) == (False,
                                                                 False)
        for kc in (33, 64, 128):
            assert _both("prefer_pruned_generator", rows, kc) == (True,
                                                                 False)
        assert _both("prefer_pruned_generator", rows, 41) == (False, False)


def test_nearest_row_point_decides(table):
    table([_entry(2000, kernel_ms=2.0, scan_ms=3.0),
           _entry(16000, kernel_ms=7.0, scan_ms=5.0)])
    for rows, want in ((1000, True), (3000, True), (12000, False),
                       (10 ** 6, False), (5000, True), (7000, False)):
        assert _both("prefer_kernel", "lstm", rows, 30, 256, 128,
                     "bfloat16", False) == (want, want)


def test_unmeasured_inference_shape_takes_the_kernel(table):
    """The intended difference: JAX's unmeasured rule is its TPU crossover
    (``rows < SCAN_FASTER_ROWS``); the port's is the kernel at any row
    count (on the H100 the doc encoder's 16,000 rows run kernel 1 about
    eight times faster than the scan)."""
    table([_entry(2000, kernel_ms=9.0, scan_ms=1.0)])
    for kind, t, dt in (("lstm", 15, "bfloat16"), ("lstm", 30, "float32"),
                        ("gru", 30, "bfloat16")):
        below = jax_dispatch.SCAN_FASTER_ROWS - 1
        above = jax_dispatch.SCAN_FASTER_ROWS
        assert _both("prefer_kernel", kind, below, t, 256, 128, dt,
                     False) == (True, True)
        assert _both("prefer_kernel", kind, above, t, 256, 128, dt,
                     False) == (True, False)
        assert _both("prefer_kernel", kind, 16000, t, 256, 128, dt,
                     False) == (True, False)
    assert dispatch.SCAN_FASTER_ROWS == jax_dispatch.SCAN_FASTER_ROWS


def test_missing_table_takes_the_defaults(table):
    path = table([])
    path.unlink()
    for mod in (dispatch, jax_dispatch):
        mod.reload_table()
    assert _both("prefer_kernel", "lstm", 100, 30, 256, 128, "bfloat16",
                 False) == (True, True)
    assert _both("prefer_kernel", "lstm", 60000, 30, 256, 128, "bfloat16",
                 False) == (True, False)
    assert _both("prefer_pruned_generator", 1600, 6) == (False, False)
    assert _both("prefer_chunked_topk", 50_000, 6) == (False, False)


def test_malformed_table_raises(table):
    """Only an absent file means no rows (above); a table that does not
    parse, or has no ``entries``, raises instead of quietly taking the
    defaults."""
    path = table([])
    for text, err in (("{not json", ValueError),
                      (json.dumps({"rows": []}), KeyError)):
        path.write_text(text)
        dispatch.reload_table()
        with pytest.raises(err):
            dispatch.prefer_kernel("lstm", 100, 30, 256, 128, "bfloat16",
                                   False)


def test_a_row_preferring_the_scan_takes_it_on_cpu_tensors(table,
                                                           monkeypatch):
    """``RNNLayer.kernel_ok`` follows a row that measured the scan faster
    on CPU tensors, where the kernels' plain versions run (on CUDA tensors
    such a row raises); both routes give the same output (f32, 1e-6)."""
    torch.manual_seed(0)
    layer = RNNLayer(16, 8, use_kernel=True, device="cpu")
    reset_parameters(layer, 0)  # a ParamModule's parameters start empty
    x = torch.randn(4, 5, 16)
    mask = torch.ones(4, 5, dtype=torch.bool)
    mask[1, 3:] = False
    calls = []
    scan = rnn.lstm_scan
    monkeypatch.setattr(rnn, "lstm_scan",
                        lambda *a, **k: calls.append(1) or scan(*a, **k))
    table([])
    assert layer.kernel_ok(x, None)
    with torch.no_grad():
        want, want_h = layer(x, mask)
    assert not calls
    table([_entry(4, kernel_ms=9.0, scan_ms=1.0, t=5, e=16, h=8,
                  dtype="float32")])
    assert not layer.kernel_ok(x, None)
    with torch.no_grad():
        got, got_h = layer(x, mask)
    assert calls
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(got_h, want_h, rtol=0, atol=1e-6)


def test_a_row_preferring_the_logits_step_takes_it_on_cpu_tensors(
        table, served):
    """An Engine on CPU tensors follows a ``beam_gen`` row that measured
    the logits step faster (on CUDA tensors such a row raises): the same
    beams as the fused step's plain version, tokens equal, scores within
    1e-4 (f32)."""
    _, _, _, (pcfg, pwd, psd), sessions = served
    hists = [list(h) + [q] for q, _, h in _texts(sessions)]
    table([])
    eng = PortEngine(pcfg, pwd, psd, beam_size=5, batch_bucket=BUCKET,
                     device="cpu")
    want = eng.suggest_batch(hists)
    table([dict(kind="beam_gen", rows=64, v=pcfg.vocab_size,
                e=pcfg.emsize, kc=kc, fused_ms=9.0, xla_ms=1.0)
           for kc in (2, 6)])
    assert not dispatch.prefer_fused_generator(64, pcfg.vocab_size,
                                               pcfg.emsize, 6)
    got = eng.suggest_batch(hists)
    n_real = 0
    for nb_g, nb_w in zip(got, want):
        for (tg, sg), (tw, sw) in zip(nb_g, nb_w):
            if sw > REAL:
                n_real += 1
                assert tg == tw
                assert abs(sg - sw) <= 1e-4
    assert n_real >= len(hists)


def test_near_tie_margin(table):
    """Both take the default on a near tie; the defaults differ only
    between a kernel and its plain version."""
    assert dispatch.NEAR_TIE_MARGIN == jax_dispatch.NEAR_TIE_MARGIN
    table([
        dict(kind="beam_gen_pipe", rows=1600, kc=6, pipe_ms=29.84,
             serial_ms=30.01),
        dict(kind="beam_gen", v=50_000, e=256, kc=6, rows=1600,
             fused_ms=8.8, xla_ms=8.9),
        dict(kind="beam_topk", v=50_000, kc=6, chunked_ms=8.8,
             exact_ms=8.9),
        _entry(2000, kernel_ms=3.0, scan_ms=2.9),
    ])
    assert _both("prefer_pipelined_generator", 1600, 6) == (False, False)
    assert _both("prefer_chunked_topk", 50_000, 6) == (False, False)
    assert _both("prefer_fused_generator", 1600, 50_000, 256, 6) == (
        True, False)
    assert _both("prefer_kernel", "lstm", 2000, 30, 256, 128, "bfloat16",
                 False) == (True, False)
    assert not hasattr(dispatch, "prefer_fused_bookkeeping")


def test_beam_topk_dispatch(table):
    table([dict(kind="beam_topk", v=50_000, kc=6, chunked_ms=1.2,
                exact_ms=2.0),
           dict(kind="beam_topk", v=5_000, kc=6, chunked_ms=1.0,
                exact_ms=0.5),
           dict(kind="beam_topk", v=50_000, kc=4, chunked_ms=3.0,
                exact_ms=1.0)])
    for args, want in (((50_000, 6), True), ((40_000, 6), True),
                       ((5_000, 6), False), ((50_000, 4), False),
                       ((50_000, 5), False)):
        assert _both("prefer_chunked_topk", *args) == (want, want)


def test_merge_rnn_entries_matches_jax():
    old_rows = [
        _entry(2000, kernel_ms=1.0, scan_ms=2.0),
        _entry(8000, kernel_ms=3.0, scan_ms=2.5),
        _entry(2000, kernel_ms=1.1, scan_ms=2.1, mode="train"),
        dict(kind="beam_topk", v=50_000, kc=6, exact_ms=1.0,
             chunked_ms=3.0),
        dict(kind="beam_gen", v=50_000, e=256, kc=6, rows=1600,
             fused_ms=6.3, xla_ms=8.9),
        dict(kind="beam_gen_pipe", rows=1600, kc=6, pipe_ms=30.0,
             serial_ms=29.8),
    ]
    new_rows = [_entry(2000, kernel_ms=0.9, scan_ms=2.0)]
    assert (dispatch.merge_rnn_entries(new_rows, old_rows)
            == jax_dispatch.merge_rnn_entries(new_rows, old_rows))


def test_write_table_round_trip(tmp_path):
    old = dispatch.TABLE_PATH
    try:
        dispatch.TABLE_PATH = tmp_path / "out.json"
        dispatch.write_table([_entry(4000, 2.0, 1.0)],
                             path=dispatch.TABLE_PATH, comment="a card")
        assert json.loads(dispatch.TABLE_PATH.read_text())["comment"] == (
            "a card")
        assert not dispatch.prefer_kernel("lstm", 4000, 30, 256, 128,
                                          "bfloat16", False)
    finally:
        dispatch.TABLE_PATH = old
        dispatch.reload_table()


def test_checked_in_table_is_self_consistent_and_names_its_card():
    """The shipped table holds H100 rows only (its comment names the card
    and its power limit), no TPU row, and every decision at a row's own
    shape follows from that row under the margin rule; the main paths'
    shapes keep their kernels."""
    dispatch.reload_table()
    blob = json.loads(dispatch.TABLE_PATH.read_text())
    assert "H100" in blob["comment"] and " W" in blob["comment"]
    assert "torch_dispatch_table.py" in blob["comment"]
    jax_rows = json.loads(jax_dispatch.TABLE_PATH.read_text())["entries"]
    assert not [e for e in blob["entries"] if e in jax_rows]
    m = dispatch.NEAR_TIE_MARGIN
    rnn = [e for e in blob["entries"] if e["kind"] in ("lstm", "gru")]
    assert len(rnn) >= 8
    for e in rnn:
        got = dispatch.prefer_kernel(e["kind"], e["rows"], e["t"], e["e"],
                                     e["h"], e["dtype"],
                                     e["mode"] == "train")
        assert got == (not e["scan_ms"] < (1 - m) * e["kernel_ms"]), e
    for e in blob["entries"]:
        if e["kind"] == "beam_gen_prune":
            assert dispatch.prefer_pruned_generator(e["rows"], e["kc"]) == (
                e["prune_ms"] < (1 - m) * e["base_ms"]), e
    for kind in ("lstm", "gru"):
        for train in (False, True):
            assert dispatch.prefer_kernel(kind, 16000, 30, 256, 128,
                                          "bfloat16", train)
    assert dispatch.prefer_fused_generator(1600, 50_000, 256, 6, t=16)
