"""Kernels 1, 4 and 5 at every width the JAX kernels take (``ops/kernels/
lstm.py``, ``csrc/lstm_mma.cuh``): any E, H up to 1,024 in both dtypes.

- The plain versions against ``_lstm_fused_res_impl`` /
  ``_lstm_fused_bwd_impl`` in Pallas interpret mode at wide shapes.
- ``cluster_forward`` / ``cluster_backward``, a plain-PyTorch emulation of
  the kernels' algorithm -- x multiplied slab by slab beside the weights,
  the gate columns split over the ranks of a cluster, each rank reading its
  own staged weight matrix (``stage_lstm_weights(..., ranks)``) and the
  whole h, dh summed from the ranks' partials in rank order, dx as one
  product with W_ih^T after the recurrence (phase C) -- against the same
  Pallas kernels.
- The gates (``fused_supported``, ``gru_fused_supported``,
  ``tile_smem_bytes``, ``f32_smem_bytes``) at the new contract, each
  against the arithmetic of the launcher it mirrors, and ``RNNLayer``
  taking the new shapes on card tensors.

Tolerances as ``tests/test_torch_lstm_tiles.py``: outputs and boundaries
1e-5 abs; gradients 2e-5 times the largest magnitude of the JAX gradient.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lstm_tiles import TOL, _close_rel, _inputs, _max_err

from context_attentive_ir_tpu.ops.pallas.lstm import (
    _lstm_fused_bwd_impl,
    _lstm_fused_res_impl,
)
from context_attentive_ir_tpu.ops.pallas.lstm import (
    fused_supported as jax_fused_supported,
)
from context_attentive_ir_tpu_torch.ops.kernels import gru as G
from context_attentive_ir_tpu_torch.ops.kernels import lstm as K
from context_attentive_ir_tpu_torch.ops.rnn import RNNLayer

BF16, F32 = torch.bfloat16, torch.float32

# (rows, T, E, H, time chunk): E past the single block's staged x tile,
# H of one block, of a cluster of 2 and of 4
WIDE = [(16, 3, 768, 128, 2), (16, 3, 1024, 256, 2), (24, 3, 300, 512, 2),
        (16, 3, 1024, 512, 2), (16, 3, 300, 1024, 2)]

_JAX = {}


def _jax(seed, b, t, e, h, tc, reverse):
    """The Pallas kernels in interpret mode: ((out, hb, cb), grads)."""
    key = (seed, b, t, e, h, tc, reverse)
    if key not in _JAX:
        x, mask, w_ih, bias, w_hh, dout = _inputs(seed, b, t, e, h)
        jx = list(map(jnp.asarray, (x, mask, w_ih, bias, w_hh)))
        fwd = _lstm_fused_res_impl(*jx, reverse=reverse, block_b=16,
                                   time_chunk=tc, interpret=True)
        bwd = _lstm_fused_bwd_impl(*jx, fwd[1], fwd[2], jnp.asarray(dout),
                                   reverse=reverse, block_b=16,
                                   time_chunk=tc, interpret=True)
        _JAX[key] = (tuple(np.asarray(v)[..., :b, :] if i else np.asarray(v)
                           for i, v in enumerate(fwd)),
                     tuple(np.asarray(v) for v in bwd))
    return _JAX[key]


# -- the emulation of the kernels' algorithm ----------------------------------

def _rank_weights(w_ih, w_hh, b, ranks):
    """Each rank's [E + H, 4 Hc] slice of the staged weights (the 8 padding
    columns cut) and its [4 Hc] bias, gate order i, f, g, o."""
    staged = K.stage_lstm_weights(w_ih, w_hh, ranks)
    if ranks == 1:
        staged = staged[None]
    hc = w_hh.shape[0] // ranks
    bias = b.reshape(4, ranks, hc).permute(1, 0, 2).reshape(ranks, 4 * hc)
    return staged[..., :-8], bias


def _gates(x_t, h, w, bias, e, ks):
    """A rank's gate pre-activations as the kernels sum them: the bias,
    then x_t's slabs of ``ks`` columns against the slabs of W_ih rows, then
    h's against W_hh's (h of every unit, as every rank stages it)."""
    acc = bias.expand(x_t.shape[0], -1).clone()
    for k0 in range(0, e, ks):
        acc = acc + x_t[:, k0:k0 + ks] @ w[k0:k0 + ks]
    for k0 in range(0, h.shape[1], ks):
        acc = acc + h[:, k0:k0 + ks] @ w[e + k0:e + k0 + ks]
    return acc


def _cell(acc, c, hc):
    i, f, g, o = acc.reshape(-1, 4, hc).unbind(1)
    i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), \
        torch.sigmoid(o)
    c_new = f * c + i * g
    return i, f, g, o, c_new, o * torch.tanh(c_new)


def _steps(t_lo, t_hi, reverse):
    steps = range(t_lo, t_hi)
    return reversed(steps) if reverse else steps


def cluster_forward(x, mask, w_ih, b, w_hh, ranks, ks=16, reverse=False,
                    time_chunk=6):
    """Kernels 1 / 4 as a cluster of ``ranks`` blocks computes them: rank
    r the units r*Hc .. (r+1)*Hc - 1 from its own staged weights and the
    whole h, which every rank then receives.  Returns (out, hb, cb)."""
    B, T, E = x.shape
    H = w_hh.shape[0]
    hc = H // ranks
    tc = K.chunk_len(T, time_chunk)
    w, bias = _rank_weights(w_ih, w_hh, b, ranks)
    h = torch.zeros((B, H))
    c = torch.zeros((B, H))
    out = torch.zeros((B, T, H))
    hb = torch.zeros((-(-T // tc), B, H))
    cb = torch.zeros_like(hb)
    for t in _steps(0, T, reverse):
        if K._first_in_chunk(t, T, tc, reverse):
            hb[t // tc], cb[t // tc] = h, c
        h_next, c_next = h.clone(), c.clone()
        m = mask[:, t, None]
        for r in range(ranks):
            u = slice(r * hc, (r + 1) * hc)
            *_, c_new, h_new = _cell(_gates(x[:, t], h, w[r], bias[r], E, ks),
                                     c[:, u], hc)
            h_next[:, u] = torch.where(m, h_new, h[:, u])
            c_next[:, u] = torch.where(m, c_new, c[:, u])
            out[:, t, u] = h_new * m
        h, c = h_next, c_next
    return out, hb, cb


def cluster_backward(x, mask, w_ih, b, w_hh, hb, cb, dout, ranks, ks=16,
                     reverse=False, time_chunk=6):
    """Kernel 5 as a cluster computes it: per chunk in reverse, the
    recompute of ``cluster_forward``, then per step each rank's dgates of
    its units, its partial of dh = dgates_r @ W_hh[:, rank's columns]^T
    (its slabs' rows) for every unit, the partials added in rank order;
    phase B's dW and db over all (row, step) pairs and phase C's dx =
    dgates @ W_ih^T.  Returns (dx, dw_ih, db, dw_hh)."""
    B, T, E = x.shape
    H = w_hh.shape[0]
    hc = H // ranks
    tc = K.chunk_len(T, time_chunk)
    w, bias = _rank_weights(w_ih, w_hh, b, ranks)
    dgates_all = torch.zeros((B, T, 4 * H))
    h_prev_all = torch.zeros((B, T, H))
    dh = torch.zeros((B, H))
    dc = torch.zeros((B, H))
    db = torch.zeros((4 * H,))
    n_chunks = -(-T // tc)
    for q in range(n_chunks):
        chunk = q if reverse else n_chunks - 1 - q
        t_lo, t_hi = chunk * tc, min((chunk + 1) * tc, T)
        h, c = hb[chunk].clone(), cb[chunk].clone()
        saved = []
        for t in _steps(t_lo, t_hi, reverse):
            m = mask[:, t, None]
            h_next, c_next, acts = h.clone(), c.clone(), []
            for r in range(ranks):
                u = slice(r * hc, (r + 1) * hc)
                i, f, g, o, c_new, h_new = _cell(
                    _gates(x[:, t], h, w[r], bias[r], E, ks), c[:, u], hc)
                acts.append((i, f, g, o, c[:, u], c_new))
                h_next[:, u] = torch.where(m, h_new, h[:, u])
                c_next[:, u] = torch.where(m, c_new, c[:, u])
            saved.append((t, h, acts))
            h, c = h_next, c_next
        for t, h_prev, acts in reversed(saved):
            m = mask[:, t, None].float()
            dh_next = torch.zeros((B, H))
            dg = torch.zeros((B, 4, H))
            for r, (i, f, g, o, c_prev, c_new) in enumerate(acts):
                u = slice(r * hc, (r + 1) * hc)
                dh_new = m * (dout[:, t, u] + dh[:, u])
                tanh_c = torch.tanh(c_new)
                dcn = m * dc[:, u] + dh_new * o * (1.0 - tanh_c * tanh_c)
                d = torch.stack([dcn * g * i * (1.0 - i),
                                 dcn * c_prev * f * (1.0 - f),
                                 dcn * i * (1.0 - g * g),
                                 dh_new * tanh_c * o * (1.0 - o)], 1)
                dg[:, :, u] = d
                dc[:, u] = (1.0 - m) * dc[:, u] + dcn * f
                # the rank's partial of dh over every unit, from the W_hh
                # rows of its own slabs, added in rank order
                dh_next = dh_next + d.reshape(B, 4 * hc) @ w[r, E:].T
            dh = (1.0 - m) * dh + dh_next
            dgates_all[:, t] = dg.reshape(B, 4 * H)
            h_prev_all[:, t] = h_prev
            db += dg.reshape(B, 4 * H).sum(0)
    g2 = dgates_all.reshape(B * T, 4 * H)
    dx = (g2 @ w_ih.T).reshape(B, T, E)
    dw_ih = x.reshape(B * T, E).T @ g2
    dw_hh = h_prev_all.reshape(B * T, H).T @ g2
    return dx, dw_ih, db, dw_hh


# -- against the Pallas kernels ---------------------------------------------

@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b,t,e,h,tc", WIDE)
def test_plain_versions_match_jax_at_wide_shapes(b, t, e, h, tc, reverse):
    assert jax_fused_supported(e, h, b)
    x, mask, w_ih, bias, w_hh, dout = _inputs(5, b, t, e, h)
    tx = list(map(torch.from_numpy, (x, mask, w_ih, bias, w_hh)))
    out, hb, cb = K.lstm_fused_res(*tx, reverse=reverse, time_chunk=tc,
                                   device="cpu")
    got = K.lstm_fused_bwd(*tx, hb, cb, torch.from_numpy(dout),
                           reverse=reverse, time_chunk=tc, device="cpu")
    (out_j, hb_j, cb_j), ref = _jax(5, b, t, e, h, tc, reverse)
    assert not out[~tx[1]].any()
    assert _max_err(out, out_j) <= TOL
    assert _max_err(hb, hb_j) <= TOL and _max_err(cb, cb_j) <= TOL
    for name, g, r in zip(("dx", "dw_ih", "db", "dw_hh"), got, ref):
        assert g.shape == r.shape, name
        _close_rel(g, r)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b,t,e,h,tc", WIDE)
def test_cluster_algorithm_matches_jax(b, t, e, h, tc, reverse):
    """The emulation at the layout the card takes for H: one block up to
    384, 2 ranks up to 512, 4 up to 1,024 (bf16's ``lstm_cluster``), 16
    k-rows a slab."""
    ranks = K.lstm_cluster(h)
    assert ranks == (1 if h <= 384 else 2 if h <= 512 else 4)
    x, mask, w_ih, bias, w_hh, dout = map(torch.from_numpy,
                                          _inputs(5, b, t, e, h))
    # the wrapper's zero-padding of E to a multiple of 32 (H is one here)
    x, w_ih, bias, w_hh = K.pad_lstm_operands(x, w_ih, bias, w_hh)
    out, hb, cb = cluster_forward(x, mask, w_ih, bias, w_hh, ranks,
                                  reverse=reverse, time_chunk=tc)
    dx, dw_ih, db, dw_hh = cluster_backward(x, mask, w_ih, bias, w_hh, hb,
                                            cb, dout, ranks, reverse=reverse,
                                            time_chunk=tc)
    got = (dx[..., :e], dw_ih[:e], db, dw_hh)
    (out_j, hb_j, cb_j), ref = _jax(5, b, t, e, h, tc, reverse)
    assert not out[~mask].any()
    assert _max_err(out, out_j) <= TOL
    assert _max_err(hb, hb_j) <= TOL and _max_err(cb, cb_j) <= TOL
    for name, g, r in zip(("dx", "dw_ih", "db", "dw_hh"), got, ref):
        assert g.shape == r.shape, name
        _close_rel(g, r)


def test_float32_cluster_of_four_matches_jax():
    """float32's split of H = 512: four ranks of 128 units
    (``f32_cluster``), slabs of 16 k-rows."""
    b, t, e, h, tc = 16, 3, 300, 512, 2
    assert K.f32_cluster(h) == 4 and K.f32_tile_hidden(h) == h
    x, mask, w_ih, bias, w_hh, dout = map(torch.from_numpy,
                                          _inputs(5, b, t, e, h))
    x, w_ih, bias, w_hh = K.pad_lstm_operands(x, w_ih, bias, w_hh)
    out, hb, cb = cluster_forward(x, mask, w_ih, bias, w_hh, 4, ks=16,
                                  time_chunk=tc)
    dx, dw_ih, db, dw_hh = cluster_backward(x, mask, w_ih, bias, w_hh, hb,
                                            cb, dout, 4, ks=16,
                                            time_chunk=tc)
    got = (dx[..., :e], dw_ih[:e], db, dw_hh)
    (out_j, hb_j, cb_j), ref = _jax(5, b, t, e, h, tc, False)
    assert _max_err(out, out_j) <= TOL and _max_err(cb, cb_j) <= TOL
    for g, r in zip(got, ref):
        _close_rel(g, r)


def test_rank_weights_are_the_column_slices():
    """Rank r's staged matrix holds the gate columns q*H + r*Hc + j of
    [W_ih; W_hh] for every gate q, 8 zero columns a row, one contiguous
    [E + H, 4 Hc + 8] matrix a rank."""
    e, h, ranks = 64, 256, 4
    hc = h // ranks
    w_ih = torch.randn((e, 4 * h)).bfloat16()
    w_hh = torch.randn((h, 4 * h)).bfloat16()
    staged = K.stage_lstm_weights(w_ih, w_hh, ranks)
    assert staged.shape == (ranks, e + h, 4 * hc + 8)
    assert staged.is_contiguous() and staged.data_ptr() % 16 == 0
    assert staged.stride(1) * staged.element_size() == 8 * hc + 16
    full = torch.cat([w_ih, w_hh])
    for r in range(ranks):
        for q in range(4):
            assert torch.equal(staged[r, :, q * hc:(q + 1) * hc],
                               full[:, q * h + r * hc:q * h + (r + 1) * hc])
    assert not staged[..., 4 * hc:].any()
    assert torch.equal(K.stage_lstm_weights(w_ih, w_hh, 1),
                       K.stage_lstm_weights(w_ih, w_hh))


# -- the gates at the new contract --------------------------------------------

@pytest.mark.parametrize("dtype", [BF16, F32])
def test_fused_supported_takes_every_width_up_to_1024(dtype):
    """Every width up to 1,024 on one block or a cluster; past it the step
    route (``tests/test_torch_step_lstm.py``) takes every H too."""
    for e in (256, 300, 512, 768, 1024, 2048):
        for h in (128, 256, 384, 512, 640, 768, 1024):
            assert K.fused_supported(e, h, 64, dtype), (e, h)
            assert K.lstm_route(h, dtype) != "step"
    for h in (1025, 1152):
        assert K.fused_supported(256, h, 64, dtype)
        assert K.lstm_route(h, dtype) == "step"
        assert K.lstm_cluster(h) == 0


def _mma_smem(hk, hc, gates, m, backward, c):
    """``mma_smem`` of ``csrc/lstm_mma.cuh`` written out."""
    h_row, slot_row = 2 * hk + 16, 8 * hc + 16

    def exch(units):
        return m * (units + 8) * 4

    staged = (2 if c > 1 else 1) * m * h_row
    if backward:
        rev = m * slot_row + (c * exch(hc) if c > 1 else
                              exch(hk) if gates == 3 else 0)
        staged = max(staged, rev)
    for depth in (32, 16):
        n = (64 + 3 * depth * (2 * gates * hc + 16) + 3 * m * (2 * depth + 16)
             + staged + (exch(hk) if backward and gates == 4 and c == 1
                         else 0) + 16 * hc)
        if n <= K.SMEM_LIMIT:
            return n
    return 0


@pytest.mark.parametrize("h", [32, 128, 256, 384, 416, 512, 544, 640, 768,
                               1024, 1056])
@pytest.mark.parametrize("backward", [False, True])
def test_tile_smem_bytes_is_the_launchers_sum(h, backward):
    c = K.lstm_cluster(h)
    if c == 0:
        assert K.tile_smem_bytes(256, h, backward) == 0
        return
    m = 16 if c > 1 else 16 * K.tile_config(h)[1]
    want = _mma_smem(h, h // c, 4, m, backward, c)
    for e in (32, 256, 4096):  # E takes no shared memory
        assert K.tile_smem_bytes(e, h, backward) == want > 0


def f32_tiles_smem(h, gates=4, depth=False, ranks=None):
    """``mma_smem`` of ``csrc/lstm_mma.cuh`` for the split-TF32 phase A of
    float32 kernels 5 (``gates`` 4) and 9 (3), written out: one block to
    H = 128, 2, 4 or 8 ranks of at most 128 units above (``ranks``: a
    cluster of that many instead), H padded to 32 (16 C in a cluster of
    C), 64 / 32 rows a block by H, 32 a rank of 2 or 4, 16 of 8;
    three slabs of 32, 16 or 8 k-rows of gates * Hc + 8 floats, three x
    slots (+ 16 bytes a row), the union of the h tile(s) and the gradient
    tile of four f32 slots with the dh partials, kernel 5's dh tile after
    it in one block, the bias, seven warps' partials of the reverse
    products (32 lanes x 8 floats each).  ``depth``: (bytes, rows a block,
    the slab depth) instead.""" 
    c = ranks or (1 if h <= 128 else 2 if h <= 256 else 4 if h <= 512
                  else 8)
    hp = -(-h // max(32, 16 * c)) * max(32, 16 * c)
    hc = hp // c
    m = (32 if c <= 4 else 16) if c > 1 else \
        64 if hp <= 64 else 32
    fwd = (2 if c > 1 else 1) * m * (4 * hp + 16)
    exch = c * m * (hc + 8) * 4 if c > 1 else \
        m * (hp + 8) * 4 if gates == 3 else 0
    union = max(fwd, m * (16 * hc + 16) + exch)
    after = m * (hp + 8) * 4 if gates == 4 and c == 1 else 0
    for ks in (32, 16, 8):
        n = (64 + 3 * ks * 4 * (gates * hc + 8) + 3 * m * (4 * ks + 16)
             + union + after + 16 * hc + 7 * 32 * 8 * 4)
        if n <= K.SMEM_LIMIT:
            return (n, m, ks) if depth else n
    return (0, m, 0) if depth else 0


def f32_fwd_tiles_smem(h, gates=4, layout=False):
    """``f32_fwd_smem`` of ``csrc/lstm_mma.cuh`` for the split-TF32
    forwards, kernels 1, 4 (``gates`` 4) and 7, 8 (3), written out: the
    backward's ranks (one block to H = 128, then 2, 4 or 8 of at most 128
    units; H padded to 32, 16 C in a cluster of C), 64 rows where one h
    tile of them fits, else 32; three slabs of 32, 16 or 8 k-rows of gates
    * Hc + 8 floats, three x slots (+ 16 bytes a row), the h tiles -- one
    in a block; two in a rank where they fit at a slab as deep as one tile
    allows, else one --, the bias.  ``layout``: (bytes, rows, slab depth,
    h tiles)."""
    c = 1 if h <= 128 else 2 if h <= 256 else 4 if h <= 512 else 8
    hp = -(-h // max(32, 16 * c)) * max(32, 16 * c)
    hc = hp // c

    def fit(m, tiles):
        for ks in (32, 16, 8):
            n = (64 + 3 * ks * 4 * (gates * hc + 8) + 3 * m * (4 * ks + 16)
                 + tiles * m * (4 * hp + 16) + 16 * hc)
            if n <= K.SMEM_LIMIT:
                return n, ks
        return 0, 0

    m = 64 if fit(64, 1)[0] else 32
    one, two = fit(m, 1), fit(m, 2)
    if c > 1 and two[0] and two[1] >= one[1]:
        n, ks, tiles = *two, 2
    else:
        n, ks, tiles = *one, 1
    return (n, m, ks, tiles) if layout else n


@pytest.mark.parametrize("h,c,hc", [(128, 1, 128), (403, 4, 112),
                                    (404, 4, 112), (512, 4, 128),
                                    (640, 8, 80), (1000, 8, 128),
                                    (1024, 8, 128), (1025, 0, 0)])
def test_float32_cluster_and_shared_memory(h, c, hc):
    """``f32_cluster`` and ``f32_smem_bytes`` against the launchers
    (``csrc/lstm_common.cuh``, ``f32_fwd_smem`` / ``mma_smem`` in
    ``csrc/lstm_mma.cuh``): the split-TF32 tiles, one block to 128 and
    ranks of Hc <= 128 units above, forward and backward alike -- the
    forwards' 64 rows in one block, 32 a rank with one or two h tiles
    (``f32_fwd_tiles_smem``), the backward's (``f32_tiles_smem``)."""
    assert K.f32_cluster(h) == c
    if not c:
        assert K.f32_smem_bytes(256, h) == 0
        assert K.f32_smem_bytes(256, h, backward=True) == 0
        return
    hp = K.f32_tile_hidden(h)
    assert hp // c == hc and hc % 16 == 0 and hc <= 128
    _, rows, _, tiles = f32_fwd_tiles_smem(h, layout=True)
    assert K.f32_forward_tiles(hp) == (rows, tiles)
    for e in (1, 256, 4096):
        assert K.f32_smem_bytes(e, h) == f32_fwd_tiles_smem(h) > 0
        assert (K.f32_smem_bytes(e, h, backward=True) == f32_tiles_smem(h)
                > 0)


@pytest.mark.parametrize("e", [768, 1024, 4096])
def test_gru_bf16_takes_every_e(e):
    """The GRU's kernels take every E and H too (past 448 in bf16 on
    clusters, ``gru_cluster``; float32 with x in chunks; past 1,024 the
    step route)."""
    for h in (128, 448, 480, 1024):
        assert G.gru_fused_supported(e, h, 64, BF16)
    assert G.gru_fused_supported(e, 1152, 64, BF16)
    assert G.gru_fused_supported(e, 128, 64, F32)
    assert G.gru_fused_supported(e, 1025, 64, F32)


@pytest.mark.parametrize("e,h,dtype", [(256, 512, BF16), (256, 512, F32),
                                       (512, 1024, BF16), (768, 128, BF16),
                                       (2048, 640, F32), (300, 416, BF16)])
def test_layer_takes_wide_shapes_on_card_tensors(e, h, dtype):
    def on_card():
        return SimpleNamespace(shape=(64, 30, e), is_cuda=True)

    layer = RNNLayer(e, h, use_kernel=True, dtype=dtype, device="cpu")
    assert layer.kernel_ok(on_card(), None) is True
    assert layer.kernel_ok(on_card(), None, training=True) is True
    # past 1,024 the LSTM and the GRU take their step routes
    wide = RNNLayer(e, 1152, use_kernel=True, dtype=dtype, device="cpu")
    assert wide.kernel_ok(on_card(), None, training=True) is True
    gru = RNNLayer(e, 1152, use_kernel=True, dtype=dtype, device="cpu",
                   rnn_type="gru")
    assert gru.kernel_ok(on_card(), None) is True
