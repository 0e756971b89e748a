"""The step route of the GRU kernels (``csrc/lstm_step.cu`` with three gate
blocks, ``ops/kernels/gru.py``): kernels 7, 8 and 9 above H = 1,024, in
both dtypes.

- ``step_forward`` / ``step_backward``, a plain-PyTorch emulation of the
  route's algorithm -- unit tiles of U units (bf16: 256, H zero-padded to a
  multiple of it; float32: 128, the last tile partial), each tile's own
  columns of [W_ih; W_hh] (bf16: ``stage_lstm_weights(..., H / U, 3)``), a
  step's slots r, z, xn, hn summed over x_t's slabs and then h_{t-1}'s
  (the n columns of an x slab into xn, of an h slab into hn), h read from
  one buffer and written to the other and carried in f32, the boundaries
  copied out at each chunk's first step; the backward's recompute planes
  (h_prev, r, z, n, hn), the four gradient slots a step with dh the
  previous step's tiles' partials added in tile order and then that
  step's dh' z (or the carried dh where that step was masked), db summed
  over 16-row groups, each tile's dh partial from slots 0, 1, 3 of its
  units against its own W_hh rows, phase B's dW and phase C's dx over all
  (row, step) pairs -- against the Pallas kernels in interpret mode at H =
  1,152 and the plain versions at 2,048 and 1,100 (float32's partial
  tile).  A zero-padded unit stays exactly 0.
- The gates at the new contract: ``gru_fused_supported`` against the JAX
  gate, ``gru_route``, ``gru_step_hidden``, ``step_smem_bytes`` with three
  gate blocks against the launcher's arithmetic, the padding and
  ``RNNLayer`` on card tensors.

Tolerances as ``tests/test_torch_wide_gru.py``: outputs and boundaries
1e-5 abs; gradients 2e-5 times the largest magnitude of the JAX (plain)
gradient (dW sums B*T terms in another order).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from test_torch_gru_bwd_tiles import NAMES, _close_rel
from test_torch_wide_gru import (
    TOL,
    _cell,
    _inputs,
    _jax,
    _max_err,
    _rank_weights,
    _slots,
    _steps,
)

from context_attentive_ir_tpu.ops.pallas.gru import (
    gru_fused_supported as jax_gru_fused_supported,
)
from context_attentive_ir_tpu_torch.ops.kernels import gru as G
from context_attentive_ir_tpu_torch.ops.kernels import lstm as K
from context_attentive_ir_tpu_torch.ops.rnn import RNNLayer

BF16, F32 = torch.bfloat16, torch.float32
DG_ROWS = 16   # rows a thread of the gradient-slot kernel sums db over


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulation runs many small tensor ops; beside five other test
    workers torch's intra-op threads contend for the cores, so this module
    runs them on one thread (as ``tests/test_torch_step_lstm.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the emulation of the step route -------------------------------------------

def _tile_weights(w_ih, b_ih, w_hh, b_hh, units):
    """Each unit tile's [E + H, 3 * own] columns of [W_ih; W_hh] (gate
    order r, z, n) and its four bias slots [4, own] (r and z from b_ih +
    b_hh, xn from b_ih_n, hn from b_hh_n), ``own`` its units (the last
    float32 tile may hold fewer than ``units``)."""
    H = w_hh.shape[0]
    full = torch.cat([w_ih, w_hh])
    tiles = []
    for u0 in range(0, H, units):
        cols = [slice(q * H + u0, q * H + min(u0 + units, H))
                for q in range(3)]
        w = torch.cat([full[:, c] for c in cols], 1)
        bias = torch.stack([b_ih[cols[0]] + b_hh[cols[0]],
                            b_ih[cols[1]] + b_hh[cols[1]],
                            b_ih[cols[2]], b_hh[cols[2]]])
        tiles.append((slice(u0, min(u0 + units, H)), w, bias))
    return tiles


def step_forward(x, mask, w_ih, b_ih, w_hh, b_hh, units, ks=32,
                 reverse=False, time_chunk=6):
    """Kernels 7 / 8 on the step route: a launch a step, in which unit tile
    r computes the r, z and n columns of its units from its own weights,
    x_t's slabs and the h buffer of the step before, and writes them into
    the other buffer; h before a chunk's first step is copied out.
    Returns (out, hb)."""
    B, T, E = x.shape
    H = w_hh.shape[0]
    tc = K.chunk_len(T, time_chunk)
    tiles = _tile_weights(w_ih, b_ih, w_hh, b_hh, units)
    hbuf = [torch.zeros((B, H)), torch.zeros((B, H))]
    out = torch.zeros((B, T, H))
    hb = torch.zeros((-(-T // tc), B, H))
    for s, t in enumerate(_steps(0, T, reverse)):
        h_cur, h_next = hbuf[s % 2], hbuf[(s + 1) % 2]
        if K._first_in_chunk(t, T, tc, reverse):
            hb[t // tc] = h_cur
        m = mask[:, t, None]
        for u, w, bias in tiles:
            *_, h_new = _cell(_slots(x[:, t], h_cur, w, bias, E, ks),
                              h_cur[:, u])
            h_next[:, u] = torch.where(m, h_new, h_cur[:, u])
            out[:, t, u] = h_new * m
    return out, hb


def step_backward(x, mask, w_ih, b_ih, w_hh, b_hh, hb, dout, units, ks=32,
                  reverse=False, time_chunk=6):
    """Kernel 9 on the step route: per chunk in reverse, the recompute from
    hb keeping each cell's planes and h_{t-1}; then a step at a time the
    four gradient slots [da_r, da_z, da_n, da_n * r] -- dh the previous
    step's tiles' partials added in tile order, then that step's dh' z,
    where it was unmasked, else the carried dh -- with db summed per 16-row
    group, and each tile's partial of dh = slots {0, 1, 3} of its units @
    its W_hh rows^T (none after the run's last step); phase B's dW and db,
    phase C's dx.  Returns (dx, dw_ih, db_ih, dw_hh, db_hh)."""
    B, T, E = x.shape
    H = w_hh.shape[0]
    tc = K.chunk_len(T, time_chunk)
    tiles = _tile_weights(w_ih, b_ih, w_hh, b_hh, units)
    slots = torch.zeros((B, T, 4, H))
    h_prev = torch.zeros((B, T, H))
    partial = torch.zeros((len(tiles), B, H))
    dh_st, dhz_st = torch.zeros((B, H)), torch.zeros((B, H))
    groups = -(-B // DG_ROWS)
    db_part = torch.zeros((groups, 4 * H))
    n_chunks = -(-T // tc)
    t_prev = None
    for q in range(n_chunks):
        chunk = q if reverse else n_chunks - 1 - q
        t_lo, t_hi = chunk * tc, min((chunk + 1) * tc, T)
        h = hb[chunk].clone()
        planes = []
        for t in _steps(t_lo, t_hi, reverse):
            m = mask[:, t, None]
            h_next, pl = torch.empty_like(h), []
            for u, w, bias in tiles:
                *act, h_new = _cell(_slots(x[:, t], h, w, bias, E, ks),
                                    h[:, u])
                pl.append(act)
                h_next[:, u] = torch.where(m, h_new, h[:, u])
            h_prev[:, t] = h
            planes.append((t, h, pl))
            h = h_next
        for k, (t, hp, pl) in reversed(list(enumerate(planes))):
            if t_prev is None:
                dh = torch.zeros((B, H))
            else:
                total = partial[0].clone()
                for r in range(1, len(tiles)):
                    total = total + partial[r]
                dh = torch.where(mask[:, t_prev, None], total + dhz_st,
                                 dh_st)
            m = mask[:, t, None]
            s_all = torch.zeros((B, 4, H))
            dhz = torch.zeros((B, H))
            for (u, _, _), (rg, zg, ng, hn) in zip(tiles, pl):
                dh_new = dout[:, t, u] + dh[:, u]
                da_n = dh_new * (1.0 - zg) * (1.0 - ng * ng)
                dz = dh_new * (hp[:, u] - ng)
                sl = torch.stack([da_n * hn * rg * (1.0 - rg),
                                  dz * zg * (1.0 - zg), da_n, da_n * rg], 1)
                s_all[:, :, u] = torch.where(m[..., None], sl, 0.0)
                dhz[:, u] = torch.where(m, dh_new * zg, 0.0)
            dh_st, dhz_st = dh, dhz
            slots[:, t] = s_all
            for grp in range(groups):
                rows = s_all[grp * DG_ROWS:(grp + 1) * DG_ROWS]
                db_part[grp] += rows.reshape(-1, 4 * H).sum(0)
            t_prev = t
            if q + 1 == n_chunks and k == 0:
                break
            for r, (u, w, _) in enumerate(tiles):
                a_hh = torch.cat([s_all[:, 0, u], s_all[:, 1, u],
                                  s_all[:, 3, u]], 1)
                partial[r] = a_hh @ w[E:].T
    g = slots.reshape(B * T, 4 * H)
    hp2 = h_prev.reshape(B * T, H)
    dx = (g[:, :3 * H] @ w_ih.T).reshape(B, T, E)
    dw_ih = x.reshape(B * T, E).T @ g[:, :3 * H]
    dw_hh = torch.cat([hp2.T @ g[:, :2 * H], hp2.T @ g[:, 3 * H:]], 1)
    db = db_part[0].clone()
    for grp in range(1, groups):
        db = db + db_part[grp]
    return (dx, dw_ih, db[:3 * H], dw_hh,
            torch.cat([db[:2 * H], db[3 * H:]]))


def _run_step(b, t, e, h, tc, reverse, units):
    """The emulation on ``_inputs``' operands (E zero-padded to a multiple
    of 32; bf16's tiles: H to one of 256, as ``pad_gru_operands`` pads the
    step route), cut back to E and H: ((out, hb), grads)."""
    args, dout = _inputs(b, t, e, h)
    x, mask, w_ih, b_ih, w_hh, b_hh = map(torch.from_numpy, args)
    if units == 256:
        x, w_ih, b_ih, w_hh, b_hh = G.pad_gru_operands(x, w_ih, b_ih, w_hh,
                                                       b_hh)
    else:
        x, w_ih, w_hh, b_ih, b_hh = K.pad_operands(x, w_ih, w_hh,
                                                   (b_ih, b_hh), G.GATES, 1)
    hp = w_hh.shape[0]
    out, hb = step_forward(x, mask, w_ih, b_ih, w_hh, b_hh, units,
                           reverse=reverse, time_chunk=tc)
    grads = step_backward(x, mask, w_ih, b_ih, w_hh, b_hh, hb,
                          K._pad_last(torch.from_numpy(dout), hp), units,
                          reverse=reverse, time_chunk=tc)
    assert not out[~mask].any() and not out[..., h:].any()
    dx, dw_ih, db_ih, dw_hh, db_hh = grads
    cut = [K._cut_gates(g, h, hp, G.GATES)
           for g in (dw_ih[:e], db_ih, dw_hh[:h], db_hh)]
    return (out[..., :h], hb[..., :h]), (dx[..., :e], *cut)


# -- against the Pallas kernels and the plain versions --------------------------

@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("units", [256, 128], ids=["bf16_tiles",
                                                   "f32_tiles"])
def test_step_route_matches_jax_at_1152(units, reverse):
    """H = 1,152: bf16's five tiles of 256 (H padded to 1,280) and
    float32's nine of 128, against ``_gru_fused_res_impl`` /
    ``_gru_fused_bwd_impl`` in interpret mode."""
    b, t, e, h, tc = 16, 3, 300, 1152, 2
    assert jax_gru_fused_supported(e, h, b)
    assert G.gru_route(h, BF16) == G.gru_route(h, F32) == "step"
    (out, hb), got = _run_step(b, t, e, h, tc, reverse, units)
    (out_j, hb_j), ref = _jax(b, t, e, h, tc, reverse)
    assert _max_err(out, out_j) <= TOL and _max_err(hb, hb_j) <= TOL
    for name, g, r in zip(NAMES, got, ref):
        assert g.shape == r.shape, name
        _close_rel(g, r)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("h,units", [(2048, 256), (2048, 128), (1100, 128)],
                         ids=["2048_bf16_tiles", "2048_f32_tiles",
                              "1100_partial_f32_tile"])
def test_step_route_matches_the_plain_versions(h, units, reverse):
    """H = 2,048 in both tile widths, and float32's partial last tile (H =
    1,100: eight tiles of 128 and one of 76), against
    ``gru_fused_res_reference`` / ``gru_fused_bwd_reference`` -- each the
    wrapper's CPU route -- on the same operands."""
    b, t, e, tc = 18, 3, 40, 2
    (out, hb), got = _run_step(b, t, e, h, tc, reverse, units)
    args, dout = _inputs(b, t, e, h)
    tx = list(map(torch.from_numpy, args))
    out_r, hb_r = G.gru_fused_res(*tx, reverse=reverse, time_chunk=tc,
                                  device="cpu")
    ref = G.gru_fused_bwd(*tx, hb_r, torch.from_numpy(dout), reverse=reverse,
                          time_chunk=tc, device="cpu")
    assert _max_err(out, out_r) <= TOL and _max_err(hb, hb_r) <= TOL
    for name, g, r in zip(NAMES, got, ref):
        assert g.shape == r.shape, name
        _close_rel(g, r)


def test_tile_weights_are_the_staged_tiles():
    """bf16's unit tiles read ``stage_lstm_weights(..., H / 256, 3)``: tile
    r's staged matrix is the emulation's columns of tile r, and its bias
    slots are ``_rank_weights``'."""
    e, h, units = 64, 1280, 256
    rng = np.random.RandomState(3)
    w_ih, w_hh = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  for s in ((e, 3 * h), (h, 3 * h)))
    b_ih, b_hh = (torch.from_numpy(rng.normal(size=3 * h).astype(np.float32))
                  for _ in range(2))
    staged, bias = _rank_weights(w_ih, b_ih, w_hh, b_hh, h // units)
    tiles = _tile_weights(w_ih, b_ih, w_hh, b_hh, units)
    assert len(tiles) == staged.shape[0] == 5
    for r, (u, w, b) in enumerate(tiles):
        assert u == slice(r * units, (r + 1) * units)
        assert torch.equal(w, staged[r]) and torch.equal(b, bias[r])


def test_zero_padded_units_stay_exactly_zero():
    """bf16 pads H = 1,100 to 1,280 with zero weights and biases: a padded
    unit's slots are 0, so r = z = 1/2 and n = 0 exactly, its h stays 0
    from the zero start (out, hb) and every gradient of it is 0."""
    b, t, e, h, tc = 18, 4, 40, 1100, 3
    args, dout = _inputs(b, t, e, h)
    x, mask, w_ih, b_ih, w_hh, b_hh = map(torch.from_numpy, args)
    xp, wi, bi, wh, bh = G.pad_gru_operands(x, w_ih, b_ih, w_hh, b_hh)
    hp = wh.shape[0]
    assert hp == G.gru_step_hidden(h, BF16) == 1280
    tiles = _tile_weights(wi, bi, wh, bh, 256)
    u, w, bias = tiles[-1]              # units 1,024 .. 1,279: 76 real
    h0 = torch.randn((b, hp))
    h0[:, h:] = 0.0
    rg, zg, ng, _, h_new = _cell(_slots(xp[:, 0], h0, w, bias, 64, 32),
                                 h0[:, u])
    pad = slice(h - u.start, None)
    assert (rg[:, pad] == 0.5).all() and (zg[:, pad] == 0.5).all()
    assert (ng[:, pad] == 0).all() and (h_new[:, pad] == 0).all()
    for reverse in (False, True):
        out, hb = step_forward(xp, mask, wi, bi, wh, bh, 256,
                               reverse=reverse, time_chunk=tc)
        assert not out[..., h:].any() and not hb[..., h:].any()
        grads = step_backward(xp, mask, wi, bi, wh, bh, hb,
                              K._pad_last(torch.from_numpy(dout), hp), 256,
                              reverse=reverse, time_chunk=tc)
        dw_ih, db_ih, dw_hh, db_hh = grads[1:]
        for g in (dw_ih, db_ih, dw_hh, db_hh):
            assert not g.reshape(*g.shape[:-1], 3, hp)[..., h:].any()
        assert not dw_hh[h:].any()


# -- the gates at the new contract ----------------------------------------------

@pytest.mark.parametrize("dtype", [BF16, F32])
def test_gru_fused_supported_takes_every_hidden_size(dtype):
    for h in (1025, 1056, 1100, 1152, 2048, 4096, 8192):
        for e in (1, 256, 300, 4096):
            assert G.gru_fused_supported(e, h, 1, dtype), (e, h)
    # equal to the JAX gate wherever that one holds a shape
    for h in range(128, 8193, 128):
        for e, rows in ((256, 8), (37, 64), (2048, 16000)):
            assert G.gru_fused_supported(e, h, rows, dtype) is \
                jax_gru_fused_supported(e, h, rows), (e, h, rows)
    assert not G.gru_fused_supported(256, 2048, 0, dtype)
    assert not G.gru_fused_supported(0, 2048, 8, dtype)
    assert not G.gru_fused_supported(256, 2048, 8, torch.float16)


@pytest.mark.parametrize("h,dtype,kernel,route", [
    (128, BF16, "fwd", "single"), (448, BF16, "fwd", "single"),
    (449, BF16, "fwd", "cluster"), (1024, BF16, "bwd", "cluster"),
    (1025, BF16, "fwd", "step"), (1056, BF16, "bwd", "step"),
    (4096, BF16, "bwd", "step"),
    (128, F32, "fwd", "single"), (129, F32, "fwd", "cluster"),
    (256, F32, "fwd", "cluster"), (257, F32, "fwd", "cluster"),
    (128, F32, "bwd", "single"), (129, F32, "bwd", "cluster"),
    (403, F32, "bwd", "cluster"), (404, F32, "bwd", "cluster"),
    (1024, F32, "bwd", "cluster"), (1025, F32, "fwd", "step"),
    (1025, F32, "bwd", "step"), (2048, F32, "bwd", "step")])
def test_route_rule(h, dtype, kernel, route):
    """``gru_route`` (``csrc/lstm_mma.cuh``'s rule): kernels 7, 8, 9 keep
    one block or a cluster up to 1,024 units (float32 past 128 on
    ``f32_cluster``'s ranks, forward and backward alike) and take the step
    route above, in both dtypes; the cluster's own rule says 0 above
    1,024."""
    assert G.gru_route(h, dtype) == route
    if route == "step":
        assert G.gru_cluster(G.gru_tile_hidden(h)) == 0


@pytest.mark.parametrize("h,dtype,hp", [(1025, BF16, 1280), (1152, BF16, 1280),
                                        (2048, BF16, 2048), (2049, BF16, 2304),
                                        (1152, F32, 1152), (1100, F32, 1100)])
def test_step_hidden_and_padding(h, dtype, hp):
    """bf16 pads the step route's H to a multiple of its 256-unit tile;
    float32's last tile is partial (no padding).  ``pad_gru_operands``
    pads so past 1,024 and keeps the cluster's padding to 1,024."""
    assert G.gru_step_hidden(h, dtype) == hp
    if dtype == BF16:
        w_hh = torch.zeros((h, 3 * h))
        b = torch.zeros(3 * h)
        _, wi, _, wh, _ = G.pad_gru_operands(torch.zeros((1, 1, 40)),
                                             torch.zeros((40, 3 * h)), b,
                                             w_hh, b)
        assert wh.shape == (hp, 3 * hp) and wi.shape == (64, 3 * hp)
    assert G.pad_gru_operands(*[torch.zeros(s) for s in (
        (1, 1, 40), (40, 3 * 1000), (3000,), (1000, 3000), (3000,))]
    )[3].shape == (1024, 3072)


def test_step_smem_bytes_with_three_gates():
    """``step_smem`` in ``csrc/lstm_mma.cuh`` with the GRU's three gate
    blocks, written out: the 64-byte header, three slabs of 32 k-rows of
    the 256-unit tile's 3 * 256 gate columns (6 * 256 + 16 bytes a row),
    three x slots of 16 rows, then the bias (4 * 256 f32) or the four
    gradient slots (16 rows of 8 * 256 + 16); float32 a chunk of 256
    k-rows and the dh product's 3 * 128, rows of 36 floats."""
    fwd = 64 + 3 * 32 * 1552 + 3 * 16 * (2 * 32 + 16) + 16 * 256
    bwd = 64 + 3 * 32 * 1552 + 3 * 16 * 80 + 16 * 2064
    assert (fwd, bwd) == (156_992, 185_920)
    assert K.step_smem_bytes(BF16, gates=3) == fwd
    assert K.step_smem_bytes(BF16, backward=True, gates=3) == bwd
    assert K.step_smem_bytes(F32, gates=3) == 256 * 36 * 4
    assert K.step_smem_bytes(F32, backward=True, gates=3) == 384 * 36 * 4
    # the LSTM's sums are unchanged
    assert K.step_smem_bytes(BF16) == 206_144
    assert K.step_smem_bytes(BF16, backward=True) == 134_464


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("h", [1025, 1152, 2048])
def test_layer_takes_the_gru_past_1024_on_card_tensors(h, dtype):
    """On card tensors the GRU layer takes its kernels past 1,024 units
    (the step route), inference and training."""
    def on_card(e):
        return SimpleNamespace(shape=(64, 30, e), is_cuda=True)

    gru = RNNLayer(256, h, use_kernel=True, dtype=dtype, device="cpu",
                   rnn_type="gru")
    assert gru.kernel_ok(on_card(256), None) is True
    assert gru.kernel_ok(on_card(256), None, training=True) is True
