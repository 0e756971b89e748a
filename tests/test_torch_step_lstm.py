"""The step route of the LSTM kernels (``csrc/lstm_step.cu``,
``ops/kernels/lstm.py``): kernels 1, 4 and 5 above H = 1,024 and kernel 6
above H = 512, in both dtypes.

- ``step_forward`` / ``step_backward`` / ``step_recurrence``, a
  plain-PyTorch emulation of the route's algorithm -- unit tiles of U units
  (bf16: 256, H zero-padded to a multiple of it; float32: 128), each
  tile's own staged weights (``stage_lstm_weights(..., H / U)``), a step's
  k-sum over x_t's slabs and then h_{t-1}'s, h read from one buffer and
  written to the other, c and the boundaries through state buffers; the
  backward's recompute planes, the dgates a step from the previous step's
  tiles' dh partials added in tile order (or the carried dh where that
  step was masked), db summed over 16-row groups, each tile's dh partial
  from its own staged W_hh rows, phase B's dW and phase C's dx over all
  (row, step) pairs; kernel 6 with E = 0, its accumulators started from
  x_proj -- against the Pallas kernels in interpret mode and the plain
  versions.
- The gates at the new contract: ``fused_supported`` against the JAX gate,
  ``lstm_route``, ``step_smem_bytes`` against the launcher's arithmetic,
  the wrappers' hidden sizes and ``RNNLayer`` on card tensors.

Tolerances as ``tests/test_torch_lstm_tiles.py``: outputs and boundaries
1e-5 abs; gradients 2e-5 times the largest magnitude of the JAX (plain)
gradient; kernel 6 2e-5 abs as ``tests/test_torch_lstm_rec.py``.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lstm_tiles import TOL, _close_rel, _inputs, _max_err
from test_torch_wide_lstm import _cell, _gates, _jax, _rank_weights, _steps

from context_attentive_ir_tpu.ops.pallas.lstm import _lstm_pallas_fwd_impl
from context_attentive_ir_tpu.ops.pallas.lstm import (
    fused_supported as jax_fused_supported,
)
from context_attentive_ir_tpu_torch.ops.kernels import gru as G
from context_attentive_ir_tpu_torch.ops.kernels import lstm as K
from context_attentive_ir_tpu_torch.ops.rnn import RNNLayer

BF16, F32 = torch.bfloat16, torch.float32
DG_ROWS = 16   # rows a thread of the dgates kernel sums db over (kDgRows)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulation runs many small tensor ops; beside five other test
    workers torch's intra-op threads contend for the cores (a case took
    150 s in a loaded run against 1.5 s alone), so this module runs them
    on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# -- the emulation of the step route -------------------------------------------


def _padded(x, w_ih, b, w_hh, units):
    """The operands at the route's widths: E to a multiple of 32, H to one
    of the unit tile (bf16's wrapper pads so; float32's last tile is
    partial, which zero units past H compute alike)."""
    return K.pad_lstm_operands(x, w_ih, b, w_hh, units)


def step_forward(x, mask, w_ih, b, w_hh, units, ks=32, reverse=False,
                 time_chunk=6):
    """Kernels 1 / 4 on the step route: a launch a step, in which unit tile
    r computes its units from its staged weights, x_t's slabs and the h
    buffer of the step before, and writes them into the other buffer; the
    state before a chunk's first step is copied out.  Returns (out, hb,
    cb)."""
    B, T, E = x.shape
    H = w_hh.shape[0]
    n_tiles = H // units
    tc = K.chunk_len(T, time_chunk)
    w, bias = _rank_weights(w_ih, w_hh, b, n_tiles)
    hbuf = [torch.zeros((B, H)), torch.zeros((B, H))]
    c = torch.zeros((B, H))
    out = torch.zeros((B, T, H))
    hb = torch.zeros((-(-T // tc), B, H))
    cb = torch.zeros_like(hb)
    for s, t in enumerate(_steps(0, T, reverse)):
        h_cur, h_next = hbuf[s % 2], hbuf[(s + 1) % 2]
        if K._first_in_chunk(t, T, tc, reverse):
            hb[t // tc], cb[t // tc] = h_cur, c
        c_next = torch.empty_like(c)
        m = mask[:, t, None]
        for r in range(n_tiles):
            u = slice(r * units, (r + 1) * units)
            *_, c_new, h_new = _cell(_gates(x[:, t], h_cur, w[r], bias[r], E,
                                            ks), c[:, u], units)
            c_next[:, u] = torch.where(m, c_new, c[:, u])
            h_next[:, u] = torch.where(m, h_new, h_cur[:, u])
            out[:, t, u] = h_new * m
        c = c_next
    return out, hb, cb


def step_backward(x, mask, w_ih, b, w_hh, hb, cb, dout, units, ks=32,
                  reverse=False, time_chunk=6):
    """Kernel 5 on the step route: per chunk in reverse, the recompute from
    (hb, cb) keeping each cell's six planes and h_{t-1}; then a step at a
    time the dgates -- dh the previous step's tiles' partials added in tile
    order where that step was unmasked, else the carried dh -- with db
    summed per 16-row group, and each tile's partial of dh = dgates_r @
    W_hh[:, tile r's columns]^T from its staged rows (none after the run's
    last step); phase B's dW and db, phase C's dx.  Returns (dx, dw_ih, db,
    dw_hh)."""
    B, T, E = x.shape
    H = w_hh.shape[0]
    n_tiles = H // units
    tc = K.chunk_len(T, time_chunk)
    w, bias = _rank_weights(w_ih, w_hh, b, n_tiles)
    dgates = torch.zeros((B, T, 4 * H))
    h_prev = torch.zeros((B, T, H))
    partial = torch.zeros((n_tiles, B, H))
    dh_st, dc_st = torch.zeros((B, H)), torch.zeros((B, H))
    groups = -(-B // DG_ROWS)
    db_part = torch.zeros((groups, 4 * H))
    n_chunks = -(-T // tc)
    t_prev = None
    for q in range(n_chunks):
        chunk = q if reverse else n_chunks - 1 - q
        t_lo, t_hi = chunk * tc, min((chunk + 1) * tc, T)
        h, c = hb[chunk].clone(), cb[chunk].clone()
        planes = []
        for t in _steps(t_lo, t_hi, reverse):
            m = mask[:, t, None]
            h_next, c_next, pl = torch.empty_like(h), torch.empty_like(c), []
            for r in range(n_tiles):
                u = slice(r * units, (r + 1) * units)
                i, f, g, o, c_new, h_new = _cell(
                    _gates(x[:, t], h, w[r], bias[r], E, ks), c[:, u], units)
                pl.append((i, f, g, o, c[:, u], c_new))
                h_next[:, u] = torch.where(m, h_new, h[:, u])
                c_next[:, u] = torch.where(m, c_new, c[:, u])
            h_prev[:, t] = h
            planes.append((t, pl))
            h, c = h_next, c_next
        for k, (t, pl) in reversed(list(enumerate(planes))):
            if t_prev is None:
                dh, dc = torch.zeros((B, H)), torch.zeros((B, H))
            else:
                total = partial[0].clone()
                for r in range(1, n_tiles):
                    total = total + partial[r]
                dh = torch.where(mask[:, t_prev, None], total, dh_st)
                dc = dc_st
            m = mask[:, t, None]
            d_all = torch.zeros((B, 4, H))
            dc_next = dc.clone()
            for r, (i, f, g, o, c_prev, c_new) in enumerate(pl):
                u = slice(r * units, (r + 1) * units)
                dh_new = dout[:, t, u] + dh[:, u]
                tanh_c = torch.tanh(c_new)
                dcn = dc[:, u] + dh_new * o * (1.0 - tanh_c * tanh_c)
                d = torch.stack([dcn * g * i * (1.0 - i),
                                 dcn * c_prev * f * (1.0 - f),
                                 dcn * i * (1.0 - g * g),
                                 dh_new * tanh_c * o * (1.0 - o)], 1)
                d_all[:, :, u] = torch.where(m[..., None], d, 0.0)
                dc_next[:, u] = torch.where(m, dcn * f, dc[:, u])
            dh_st, dc_st = dh, dc_next
            dgates[:, t] = d_all.reshape(B, 4 * H)
            for grp in range(groups):
                rows = d_all[grp * DG_ROWS:(grp + 1) * DG_ROWS]
                db_part[grp] += rows.reshape(-1, 4 * H).sum(0)
            t_prev = t
            if q + 1 == n_chunks and k == 0:
                break
            for r in range(n_tiles):
                u = slice(r * units, (r + 1) * units)
                partial[r] = d_all[:, :, u].reshape(B, 4 * units) @ w[r, E:].T
    g2 = dgates.reshape(B * T, 4 * H)
    dx = (g2 @ w_ih.T).reshape(B, T, E)
    dw_ih = x.reshape(B * T, E).T @ g2
    dw_hh = h_prev.reshape(B * T, H).T @ g2
    db = db_part[0].clone()
    for grp in range(1, groups):
        db = db + db_part[grp]
    return dx, dw_ih, db, dw_hh


def step_recurrence(x_proj, mask, w_hh, units, ks=32, reverse=False):
    """Kernel 6 on the step route: the step kernel with E = 0, unit tile
    r's accumulators started from the x_proj columns of its units and
    h_{t-1}'s slabs added from its staged W_hh rows."""
    B, T, G4 = x_proj.shape
    H = G4 // 4
    n_tiles = H // units
    w = K.stage_lstm_weights(w_hh[:0], w_hh, n_tiles)[..., :-8]
    hbuf = [torch.zeros((B, H)), torch.zeros((B, H))]
    c = torch.zeros((B, H))
    out = torch.zeros((B, T, H))
    for s, t in enumerate(_steps(0, T, reverse)):
        h_cur, h_next = hbuf[s % 2], hbuf[(s + 1) % 2]
        c_next = torch.empty_like(c)
        m = mask[:, t, None]
        gates = x_proj[:, t].reshape(B, 4, n_tiles, units)
        for r in range(n_tiles):
            u = slice(r * units, (r + 1) * units)
            acc = _gates(x_proj[:, t, :0], h_cur, w[r],
                         gates[:, :, r].reshape(B, 4 * units), 0, ks)
            *_, c_new, h_new = _cell(acc, c[:, u], units)
            c_next[:, u] = torch.where(m, c_new, c[:, u])
            h_next[:, u] = torch.where(m, h_new, h_cur[:, u])
            out[:, t, u] = h_new * m
        c = c_next
    return out


def _run_step(b, t, e, h, tc, reverse, units, seed=5):
    """The emulation on ``_inputs``' operands padded to the route's
    widths, cut back to E and H: ((out, hb, cb), (dx, dw_ih, db,
    dw_hh))."""
    x, mask, w_ih, bias, w_hh, dout = map(torch.from_numpy,
                                          _inputs(seed, b, t, e, h))
    xp, w_ihp, bp, w_hhp = _padded(x, w_ih, bias, w_hh, units)
    hp = w_hhp.shape[0]
    out, hb, cb = step_forward(xp, mask, w_ihp, bp, w_hhp, units,
                               reverse=reverse, time_chunk=tc)
    grads = step_backward(xp, mask, w_ihp, bp, w_hhp, hb, cb,
                          K._pad_last(dout, hp), units, reverse=reverse,
                          time_chunk=tc)
    assert not out[~mask].any() and not out[..., h:].any()
    dx, dw_ih, db, dw_hh = grads
    return ((out[..., :h], hb[..., :h], cb[..., :h]),
            (dx[..., :e], K._cut_gates(dw_ih[:e], h, hp),
             K._cut_gates(db, h, hp), K._cut_gates(dw_hh[:h], h, hp)))


# -- against the Pallas kernels and the plain versions --------------------------

@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("units", [256, 128], ids=["bf16_tiles",
                                                   "f32_tiles"])
def test_step_route_matches_jax_at_1152(units, reverse):
    """H = 1,152: bf16's five tiles of 256 (H padded to 1,280) and
    float32's nine of 128, against ``_lstm_fused_res_impl`` /
    ``_lstm_fused_bwd_impl`` in interpret mode."""
    b, t, e, h, tc = 16, 3, 300, 1152, 2
    assert jax_fused_supported(e, h, b)
    assert K.lstm_route(h, BF16) == K.lstm_route(h, F32) == "step"
    (out, hb, cb), got = _run_step(b, t, e, h, tc, reverse, units)
    (out_j, hb_j, cb_j), ref = _jax(5, b, t, e, h, tc, reverse)
    assert _max_err(out, out_j) <= TOL
    assert _max_err(hb, hb_j) <= TOL and _max_err(cb, cb_j) <= TOL
    for name, g, r in zip(("dx", "dw_ih", "db", "dw_hh"), got, ref):
        assert g.shape == r.shape, name
        _close_rel(g, r)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("h,units", [(2048, 256), (2048, 128), (1100, 128)],
                         ids=["2048_bf16_tiles", "2048_f32_tiles",
                              "1100_partial_f32_tile"])
def test_step_route_matches_the_plain_versions(h, units, reverse):
    """H = 2,048 in both tile widths, and float32's partial last tile (H =
    1,100: eight tiles of 128 and one of 76), against
    ``lstm_fused_res_reference`` / ``lstm_fused_bwd_reference`` -- each the
    wrapper's CPU route -- on the same operands."""
    b, t, e, tc = 18, 3, 40, 2
    (out, hb, cb), got = _run_step(b, t, e, h, tc, reverse, units)
    x, mask, w_ih, bias, w_hh, dout = map(torch.from_numpy,
                                          _inputs(5, b, t, e, h))
    out_r, hb_r, cb_r = K.lstm_fused_res(x, mask, w_ih, bias, w_hh, reverse,
                                         tc, device="cpu")
    ref = K.lstm_fused_bwd(x, mask, w_ih, bias, w_hh, hb_r, cb_r, dout,
                           reverse, tc, device="cpu")
    assert _max_err(out, out_r) <= TOL
    assert _max_err(hb, hb_r) <= TOL and _max_err(cb, cb_r) <= TOL
    for name, g, r in zip(("dx", "dw_ih", "db", "dw_hh"), got, ref):
        assert g.shape == r.shape, name
        _close_rel(g, r)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("units", [256, 128], ids=["bf16_tiles",
                                                   "f32_tiles"])
def test_kernel6_step_route_matches_lstm_pallas_at_640(units, reverse):
    """Kernel 6 at H = 640 (bf16: x_proj's gate blocks and W_hh zero-padded
    to 768, three tiles; float32: five tiles of 128) against
    ``_lstm_pallas_fwd_impl`` in interpret mode and the plain version."""
    rng = np.random.RandomState(7)
    b, t, h = 24, 5, 640
    x_proj = (rng.normal(size=(b, t, 4 * h)) * 0.5).astype(np.float32)
    w_hh = (rng.normal(size=(h, 4 * h)) * 0.05).astype(np.float32)
    mask = rng.rand(b, t) < 0.7
    mask[0], mask[1] = True, False
    want = np.asarray(_lstm_pallas_fwd_impl(
        *map(jnp.asarray, (x_proj, mask, w_hh)), reverse=reverse, block_b=16,
        time_chunk=4, interpret=True))
    xp, m, whh = map(torch.from_numpy, (x_proj, mask, w_hh))
    hp = K.step_hidden(h, BF16 if units == 256 else F32)
    assert hp == (768 if units == 256 else 640)
    xpp = K._pad_gates(xp, h, hp)
    whhp = torch.nn.functional.pad(K._pad_gates(whh, h, hp),
                                   (0, 0, 0, hp - h))
    got = step_recurrence(xpp, m, whhp, units, reverse=reverse)
    assert not got[..., h:].any() and not got[~m].any()
    assert _max_err(got[..., :h], want) <= 2e-5
    assert _max_err(got[..., :h],
                    K.lstm_recurrence_reference(xp, m, whh, reverse)) <= 2e-5


# -- the gates at the new contract ----------------------------------------------

@pytest.mark.parametrize("dtype", [BF16, F32])
def test_fused_supported_takes_every_hidden_size(dtype):
    for h in (1025, 1152, 2048, 4096, 8192):
        for e in (1, 256, 300, 4096):
            assert K.fused_supported(e, h, 1, dtype), (e, h)
    # equal to the JAX gate wherever that one holds a shape
    for h in range(128, 8193, 128):
        for e, rows in ((256, 8), (37, 64), (2048, 16000)):
            assert K.fused_supported(e, h, rows, dtype) is \
                jax_fused_supported(e, h, rows), (e, h, rows)
    assert not K.fused_supported(256, 2048, 0, dtype)
    assert not K.fused_supported(0, 2048, 8, dtype)
    assert not K.fused_supported(256, 2048, 8, torch.float16)


@pytest.mark.parametrize("h,dtype,kernel,route", [
    (128, BF16, "fwd", "single"), (384, BF16, "fwd", "single"),
    (385, BF16, "fwd", "cluster"), (1024, BF16, "fwd", "cluster"),
    (1025, BF16, "fwd", "step"), (1056, BF16, "bwd", "step"),
    (4096, BF16, "bwd", "step"),
    (128, F32, "fwd", "single"), (129, F32, "fwd", "cluster"),
    (256, F32, "fwd", "cluster"), (257, F32, "fwd", "cluster"),
    (128, F32, "bwd", "single"), (129, F32, "bwd", "cluster"),
    (403, F32, "bwd", "cluster"), (404, F32, "bwd", "cluster"),
    (1024, F32, "bwd", "cluster"), (1025, F32, "fwd", "step"),
    (1025, F32, "bwd", "step"),
    (128, BF16, "rec", "single"), (512, F32, "rec", "single"),
    (640, BF16, "rec", "step"), (640, F32, "rec", "step"),
    (2048, F32, "rec", "step")])
def test_route_rule(h, dtype, kernel, route):
    """``lstm_route`` (``csrc/lstm_mma.cuh``'s rule): kernels 1, 4, 5 keep
    one block or a cluster up to 1,024 units (float32 past 128 on
    ``f32_cluster``'s ranks, forward and backward alike) and take the step
    route above, kernel 6 above 512, in both dtypes; the cluster's own rule
    says 0 above 1,024."""
    assert K.lstm_route(h, dtype, recurrence=kernel == "rec") == route
    if route == "step" and kernel != "rec":
        assert K.lstm_cluster(h) == 0
        assert K.tile_smem_bytes(256, h) == 0


def test_step_smem_bytes_is_the_launchers_sum():
    """``step_smem`` in ``csrc/lstm_mma.cuh`` written out: the 64-byte
    header, three slabs of a depth of the 256-unit tile's gate columns (2 *
    1,024 + 16 bytes a row), three x slots of 16 rows, then the bias (4 *
    256 f32) or the dgates tile (16 rows of 8 * 256 + 16); 32 k-rows a slab
    where they fit.  float32 (``csrc/lstm_step.cu``): a chunk of 256 k-rows
    and the dh product's 512, rows of 36 floats."""
    fwd = 64 + 3 * 32 * 2064 + 3 * 16 * (2 * 32 + 16) + 16 * 256
    bwd32 = 64 + 3 * 32 * 2064 + 3 * 16 * 80 + 16 * 2064
    bwd = 64 + 3 * 16 * 2064 + 3 * 16 * (2 * 16 + 16) + 16 * 2064
    assert (fwd, bwd) == (206_144, 134_464)
    assert bwd32 > K.SMEM_LIMIT >= fwd
    assert K.step_smem_bytes(BF16) == fwd
    assert K.step_smem_bytes(BF16, backward=True) == bwd
    assert K.step_smem_bytes(F32) == 256 * 36 * 4 == 36_864
    assert K.step_smem_bytes(F32, backward=True) == 512 * 36 * 4


@pytest.mark.parametrize("h,dtype,hp", [(1025, BF16, 1280), (1152, BF16, 1280),
                                        (2048, BF16, 2048), (640, BF16, 768),
                                        (1152, F32, 1152), (1100, F32, 1100)])
def test_step_hidden(h, dtype, hp):
    assert K.step_hidden(h, dtype) == hp
    assert K.STEP_UNITS[dtype] == (256 if dtype == BF16 else 128)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("h", [640, 1024, 2048])
def test_recurrence_wrapper_holds_multiples_of_128_past_512(h, dtype):
    rng = np.random.RandomState(0)
    xp = torch.from_numpy(rng.normal(size=(3, 2, 4 * h)).astype(np.float32))
    whh = torch.from_numpy(rng.normal(size=(h, 4 * h)).astype(np.float32))
    mask = torch.ones((3, 2), dtype=torch.bool)
    assert K._check_rec_args(xp.to(dtype), mask, whh.to(dtype)) == (3, 2, h)
    assert K.lstm_route(h, dtype, recurrence=True) == "step"


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_layer_takes_the_lstm_past_1024_on_card_tensors(dtype):
    """On card tensors the LSTM layer takes its kernels at 1,152 units (the
    step route), and so does the GRU's (its own step route)."""
    def on_card(e):
        return SimpleNamespace(shape=(64, 30, e), is_cuda=True)

    lstm = RNNLayer(256, 1152, use_kernel=True, dtype=dtype, device="cpu")
    assert lstm.kernel_ok(on_card(256), None) is True
    assert lstm.kernel_ok(on_card(256), None, training=True) is True
    assert G.gru_fused_supported(256, 1152, 64, dtype)
    gru = RNNLayer(256, 1152, use_kernel=True, dtype=dtype, device="cpu",
                   rnn_type="gru")
    assert gru.kernel_ok(on_card(256), None) is True
