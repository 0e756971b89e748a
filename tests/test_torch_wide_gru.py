"""Kernels 7, 8 and 9 at every width the JAX kernels take up to 1,024
(``ops/kernels/gru.py``, ``csrc/gru_fwd.cu``, ``csrc/gru_bwd.cu``): any E,
H up to 1,024 in both dtypes.

- The plain versions against ``_gru_fused_res_impl`` /
  ``_gru_fused_bwd_impl`` in Pallas interpret mode at wide shapes.
- ``cluster_forward`` / ``cluster_backward``, a plain-PyTorch emulation of
  the kernels' algorithm past one block -- x multiplied slab by slab beside
  the weights, the r, z and n columns split over the ranks of a cluster,
  each rank reading its own staged weight matrix
  (``stage_lstm_weights(..., ranks, gates=3)``) and the whole h, the n
  gate's ``x @ W_in`` and ``h @ W_hn`` in slots of their own, dh summed from
  the ranks' partials of gradient slots {0, 1, 3} in rank order and then
  ``dh' z``, dx as one product with W_ih^T after the recurrence (phase C)
  -- against the same Pallas kernels.
- The gate (``gru_fused_supported``, ``gru_cluster``, ``tile_smem_bytes``
  with three gates, ``f32_smem_bytes``) at every H from 32 to 1,056,
  against the JAX gate and the arithmetic of the launchers it mirrors, and
  ``RNNLayer`` taking the new shapes on card tensors.

Tolerances as ``tests/test_torch_gru_bwd_tiles.py``: outputs and
boundaries 1e-5 abs; gradients 2e-5 times the largest magnitude of the JAX
gradient (dW sums B*T terms in another order).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gru_bwd_tiles import NAMES, _close_rel
from test_torch_gru_bwd_tiles import _inputs as _gru_inputs
from test_torch_wide_lstm import f32_fwd_tiles_smem, f32_tiles_smem

from context_attentive_ir_tpu.ops.pallas.gru import (
    _gru_fused_bwd_impl,
    _gru_fused_res_impl,
)
from context_attentive_ir_tpu.ops.pallas.gru import (
    gru_fused_supported as jax_gru_fused_supported,
)
from context_attentive_ir_tpu_torch.ops.kernels import gru as G
from context_attentive_ir_tpu_torch.ops.kernels import lstm as K
from context_attentive_ir_tpu_torch.ops.rnn import RNNLayer

TOL = 1e-5
BF16, F32 = torch.bfloat16, torch.float32

# (rows, T, E, H, time chunk): H of a cluster of 2 (512) and of 4 (640,
# 1,024), E past the single block's old x tile (1,024)
WIDE = [(16, 3, 300, 512, 2), (16, 3, 1024, 512, 2), (16, 3, 300, 640, 2),
        (16, 3, 300, 1024, 2)]

_JAX = {}


def _inputs(b, t, e, h):
    return _gru_inputs(7, b, t, e, h)


def _jax(b, t, e, h, tc, reverse):
    """The Pallas kernels in interpret mode: ((out, hb), grads)."""
    key = (b, t, e, h, tc, reverse)
    if key not in _JAX:
        args, dout = _inputs(b, t, e, h)
        jx = list(map(jnp.asarray, args))
        out, hb = _gru_fused_res_impl(*jx, reverse=reverse, block_b=16,
                                      time_chunk=tc, interpret=True)
        grads = _gru_fused_bwd_impl(*jx, hb, jnp.asarray(dout),
                                    reverse=reverse, block_b=16,
                                    time_chunk=tc, interpret=True)
        _JAX[key] = ((np.asarray(out), np.asarray(hb)[:, :b]),
                     tuple(np.asarray(g) for g in grads))
    return _JAX[key]


def _max_err(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


# -- the emulation of the kernels' algorithm ----------------------------------

def _rank_weights(w_ih, b_ih, w_hh, b_hh, ranks):
    """Each rank's [E + H, 3 Hc] slice of the staged weights (the 8 padding
    columns cut) and its four bias slots [4, Hc]: r and z from b_ih + b_hh,
    xn from b_ih_n, hn from b_hh_n."""
    staged = K.stage_lstm_weights(w_ih, w_hh, ranks, G.GATES)
    if ranks == 1:
        staged = staged[None]
    hc = w_hh.shape[0] // ranks
    bi = b_ih.reshape(3, ranks, hc).permute(1, 0, 2)
    bh = b_hh.reshape(3, ranks, hc).permute(1, 0, 2)
    bias = torch.stack([bi[:, 0] + bh[:, 0], bi[:, 1] + bh[:, 1], bi[:, 2],
                        bh[:, 2]], 1)
    return staged[..., :-8], bias


def _slots(x_t, h, w, bias, e, ks):
    """A rank's slots r, z, xn, hn as the kernels sum them: the bias, then
    x_t's slabs of ``ks`` columns against the W_ih rows (the n columns into
    xn), then h's against the W_hh rows (the n columns into hn)."""
    hc = bias.shape[-1]
    acc = bias[:, None, :].repeat(1, x_t.shape[0], 1)
    for k0 in range(0, e, ks):
        p = x_t[:, k0:k0 + ks] @ w[k0:k0 + ks]
        acc[0] += p[:, :hc]
        acc[1] += p[:, hc:2 * hc]
        acc[2] += p[:, 2 * hc:]
    for k0 in range(0, h.shape[1], ks):
        p = h[:, k0:k0 + ks] @ w[e + k0:e + k0 + ks]
        acc[0] += p[:, :hc]
        acc[1] += p[:, hc:2 * hc]
        acc[3] += p[:, 2 * hc:]
    return acc


def _cell(acc, h_own):
    r, z = torch.sigmoid(acc[0]), torch.sigmoid(acc[1])
    n = torch.tanh(acc[2] + r * acc[3])
    return r, z, n, acc[3], (1.0 - z) * n + z * h_own


def _steps(t_lo, t_hi, reverse):
    steps = range(t_lo, t_hi)
    return reversed(steps) if reverse else steps


def _recompute_step(x_t, h, m, w, bias, ranks, e, ks):
    """One step of every rank from the whole h: the next h and each rank's
    (r, z, n, hn)."""
    hc = h.shape[1] // ranks
    h_next, acts = h.clone(), []
    for r in range(ranks):
        u = slice(r * hc, (r + 1) * hc)
        *act, h_new = _cell(_slots(x_t, h, w[r], bias[r], e, ks), h[:, u])
        acts.append(act)
        h_next[:, u] = torch.where(m, h_new, h[:, u])
    return h_next, acts


def cluster_forward(x, mask, w_ih, b_ih, w_hh, b_hh, ranks, ks=16,
                    reverse=False, time_chunk=6):
    """Kernels 7 / 8 as a cluster of ``ranks`` blocks computes them: rank r
    the units r*Hc .. (r+1)*Hc - 1 from its own staged weights and the whole
    h, which every rank then receives.  Returns (out, hb)."""
    B, T, E = x.shape
    H = w_hh.shape[0]
    tc = K.chunk_len(T, time_chunk)
    w, bias = _rank_weights(w_ih, b_ih, w_hh, b_hh, ranks)
    h = torch.zeros((B, H))
    out = torch.zeros((B, T, H))
    hb = torch.zeros((-(-T // tc), B, H))
    for t in _steps(0, T, reverse):
        if K._first_in_chunk(t, T, tc, reverse):
            hb[t // tc] = h
        m = mask[:, t, None]
        h, _ = _recompute_step(x[:, t], h, m, w, bias, ranks, E, ks)
        out[:, t] = h * m
    return out, hb


def cluster_backward(x, mask, w_ih, b_ih, w_hh, b_hh, hb, dout, ranks,
                     ks=16, reverse=False, time_chunk=6):
    """Kernel 9 as a cluster computes it: per chunk in reverse, the
    recompute of ``cluster_forward``, then per step each rank's four
    gradient slots [da_r, da_z, da_n, da_n * r] of its units and its partial
    of slots {0, 1, 3} @ W_hh[:, its columns]^T (its slabs' h rows) for
    every unit, the partials added in rank order, then dh' z; phase B's dW
    and db over all (row, step) pairs and phase C's dx = slots 0..2 @
    W_ih^T.  Returns (dx, dw_ih, db_ih, dw_hh, db_hh)."""
    B, T, E = x.shape
    H = w_hh.shape[0]
    hc = H // ranks
    tc = K.chunk_len(T, time_chunk)
    w, bias = _rank_weights(w_ih, b_ih, w_hh, b_hh, ranks)
    slots_all = torch.zeros((B, T, 4, H))
    h_prev_all = torch.zeros((B, T, H))
    dh = torch.zeros((B, H))
    n_chunks = -(-T // tc)
    for q in range(n_chunks):
        chunk = q if reverse else n_chunks - 1 - q
        t_lo, t_hi = chunk * tc, min((chunk + 1) * tc, T)
        h = hb[chunk].clone()
        saved = []
        for t in _steps(t_lo, t_hi, reverse):
            h_next, acts = _recompute_step(x[:, t], h, mask[:, t, None], w,
                                           bias, ranks, E, ks)
            saved.append((t, h, acts))
            h = h_next
        for t, h_prev, acts in reversed(saved):
            m = mask[:, t, None]
            partial_sum = torch.zeros((B, H))
            dhz = torch.zeros((B, H))
            for r, (rg, zg, ng, hn) in enumerate(acts):
                u = slice(r * hc, (r + 1) * hc)
                dh_new = dout[:, t, u] + dh[:, u]
                da_n = dh_new * (1.0 - zg) * (1.0 - ng * ng)
                dz = dh_new * (h_prev[:, u] - ng)
                s = torch.stack([da_n * hn * rg * (1.0 - rg),
                                 dz * zg * (1.0 - zg), da_n, da_n * rg], 1)
                s = torch.where(m[:, :, None], s, torch.zeros(()))
                slots_all[:, t, :, u] = s
                dhz[:, u] = dh_new * zg
                # the rank's partial of dh over every unit, from the W_hh
                # rows of its own slabs (slot 3 in the n block's place),
                # added in rank order
                a_hh = torch.cat([s[:, 0], s[:, 1], s[:, 3]], 1)
                partial_sum = partial_sum + a_hh @ w[r, E:].T
            dh = torch.where(m, partial_sum + dhz, dh)
            h_prev_all[:, t] = h_prev
    g = slots_all.reshape(B * T, 4 * H)
    xf = x.reshape(B * T, E)
    hp = h_prev_all.reshape(B * T, H)
    dx = (g[:, :3 * H] @ w_ih.T).reshape(B, T, E)
    dw_ih = xf.T @ g[:, :3 * H]
    dw_hh = torch.cat([hp.T @ g[:, :2 * H], hp.T @ g[:, 3 * H:]], 1)
    db = g.sum(0)
    return (dx, dw_ih, db[:3 * H], dw_hh,
            torch.cat([db[:2 * H], db[3 * H:]]))


# -- against the Pallas kernels ---------------------------------------------

@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b,t,e,h,tc", WIDE)
def test_plain_versions_match_jax_at_wide_shapes(b, t, e, h, tc, reverse):
    assert jax_gru_fused_supported(e, h, b)
    args, dout = _inputs(b, t, e, h)
    tx = list(map(torch.from_numpy, args))
    out, hb = G.gru_fused_res(*tx, reverse=reverse, time_chunk=tc,
                              device="cpu")
    got = G.gru_fused_bwd(*tx, hb, torch.from_numpy(dout), reverse=reverse,
                          time_chunk=tc, device="cpu")
    (out_j, hb_j), ref = _jax(b, t, e, h, tc, reverse)
    assert not out[~tx[1]].any()
    assert _max_err(out, out_j) <= TOL and _max_err(hb, hb_j) <= TOL
    for name, g, r in zip(NAMES, got, ref):
        assert g.shape == r.shape, name
        _close_rel(g, r)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b,t,e,h,tc", WIDE)
def test_cluster_algorithm_matches_jax(b, t, e, h, tc, reverse):
    """The emulation at the layout the card takes for H in bf16: 2 ranks at
    512, 4 at 640 and 1,024 (``gru_cluster``), 16 k-rows a slab."""
    ranks = G.gru_cluster(h)
    assert ranks == (2 if h <= 512 else 4) and G.gru_tile_hidden(h) == h
    args, dout = _inputs(b, t, e, h)
    x, mask, w_ih, b_ih, w_hh, b_hh = map(torch.from_numpy, args)
    # the wrapper's zero-padding of E to a multiple of 32 (H is one here)
    x, w_ih, b_ih, w_hh, b_hh = G.pad_gru_operands(x, w_ih, b_ih, w_hh, b_hh)
    out, hb = cluster_forward(x, mask, w_ih, b_ih, w_hh, b_hh, ranks,
                              reverse=reverse, time_chunk=tc)
    dx, dw_ih, *rest = cluster_backward(x, mask, w_ih, b_ih, w_hh, b_hh, hb,
                                        torch.from_numpy(dout), ranks,
                                        reverse=reverse, time_chunk=tc)
    got = (dx[..., :e], dw_ih[:e], *rest)
    (out_j, hb_j), ref = _jax(b, t, e, h, tc, reverse)
    assert not out[~mask].any()
    assert _max_err(out, out_j) <= TOL and _max_err(hb, hb_j) <= TOL
    for name, g, r in zip(NAMES, got, ref):
        assert g.shape == r.shape, name
        _close_rel(g, r)


def test_float32_cluster_of_four_matches_jax():
    """float32's split of H = 512: four ranks of 128 units
    (``f32_cluster``) in kernels 7, 8 (64 rows and one h tile a rank,
    ``f32_forward_tiles``) and 9; slabs of 32 k-rows."""
    b, t, e, h, tc = 16, 3, 300, 512, 2
    assert K.f32_cluster(h) == 4 and K.f32_forward_tiles(h, 3) == (64, 1)
    args, dout = _inputs(b, t, e, h)
    x, mask, w_ih, b_ih, w_hh, b_hh = map(torch.from_numpy, args)
    # zero columns of x past E (slabs of 32 k-rows) add nothing
    x, w_ih, b_ih, w_hh, b_hh = G.pad_gru_operands(x, w_ih, b_ih, w_hh, b_hh)
    out, hb = cluster_forward(x, mask, w_ih, b_ih, w_hh, b_hh, 4, ks=32,
                              time_chunk=tc)
    dx, dw_ih, *rest = cluster_backward(x, mask, w_ih, b_ih, w_hh, b_hh, hb,
                                        torch.from_numpy(dout), 4, ks=32,
                                        time_chunk=tc)
    got = (dx[..., :e], dw_ih[:e], *rest)
    (out_j, hb_j), ref = _jax(b, t, e, h, tc, False)
    assert _max_err(out, out_j) <= TOL and _max_err(hb, hb_j) <= TOL
    for g, r in zip(got, ref):
        _close_rel(g, r)


def test_rank_weights_are_the_column_slices():
    """Rank r's staged matrix holds the gate columns q*H + r*Hc + j of
    [W_ih; W_hh] for every gate q of r, z, n, 8 zero columns a row, one
    contiguous [E + H, 3 Hc + 8] matrix a rank."""
    e, h, ranks = 64, 256, 4
    hc = h // ranks
    w_ih = torch.randn((e, 3 * h)).bfloat16()
    w_hh = torch.randn((h, 3 * h)).bfloat16()
    staged = K.stage_lstm_weights(w_ih, w_hh, ranks, G.GATES)
    assert staged.shape == (ranks, e + h, 3 * hc + 8)
    assert staged.is_contiguous() and staged.data_ptr() % 16 == 0
    assert staged.stride(1) * staged.element_size() == 6 * hc + 16
    full = torch.cat([w_ih, w_hh])
    for r in range(ranks):
        for q in range(3):
            assert torch.equal(staged[r, :, q * hc:(q + 1) * hc],
                               full[:, q * h + r * hc:q * h + (r + 1) * hc])
    assert not staged[..., 3 * hc:].any()


# -- the gate at the new contract --------------------------------------------

def _mma_smem(h, c, backward):
    """``mma_smem`` of ``csrc/lstm_mma.cuh`` for the GRU's three gate
    blocks, written out: 16-row ranks in a cluster, ``pick_config``'s rows
    in one block; a single block's backward keeps a full-H f32 dh tile
    inside its union, a rank one tile of Hc columns a source rank."""
    hc = h // c
    m = 16 if c > 1 else 16 * K.tile_config(h)[1]
    staged = (2 if c > 1 else 1) * m * (2 * h + 16)
    if backward:
        exch = c * m * (hc + 8) * 4 if c > 1 else m * (h + 8) * 4
        staged = max(staged, m * (8 * hc + 16) + exch)
    for depth in (32, 16):
        n = (64 + 3 * depth * (6 * hc + 16) + 3 * m * (2 * depth + 16)
             + staged + 16 * hc)
        if n <= K.SMEM_LIMIT:
            return n
    return 0


def _f32_smem(e, h, backward):
    """The float32 launchers' sums (``f32_fwd_smem`` / ``mma_smem`` in
    ``csrc/lstm_mma.cuh``): the split-TF32 tiles with three gate blocks,
    the forward's (``f32_fwd_tiles_smem``) and the backward's
    (``f32_tiles_smem``); E takes none."""
    if K.f32_cluster(h) == 0:
        return 0
    return f32_tiles_smem(h, 3) if backward else f32_fwd_tiles_smem(h, 3)


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_gate_is_the_launchers_at_every_hidden_size(dtype):
    """At every H from 32 to 1,056 and E of 1, 300 and 4,096: the gate
    holds every H, wherever the JAX gate holds too; up to 1,024 exactly
    where the launchers' arithmetic does -- bf16: H padded to 32 (64 in a
    cluster of 4), ``gru_cluster``'s blocks whose tiles fit, forward and
    backward; float32: the split-TF32 tiles of kernels 7, 8 and 9 at
    ``f32_tile_hidden``, ``f32_cluster``'s ranks of at most 128 units whose
    tiles fit, forward and backward -- and above it on the step route,
    whose blocks' shared memory no width changes."""
    for h in range(32, 1057):
        for e in (1, 300, 4096):
            ok = G.gru_fused_supported(e, h, 8, dtype)
            assert ok, (e, h)
            if jax_gru_fused_supported(e, h, 8):
                assert ok
            if h > 1024:
                assert G.gru_route(h, dtype) == "step"
                assert K.step_smem_bytes(dtype, True, G.GATES) > 0
                continue
            if dtype == BF16:
                hp = G.gru_tile_hidden(h)
                c = G.gru_cluster(hp)
                assert c == (1 if hp <= 448 else 2 if hp <= 512
                             else 4 if hp <= 1024 else 0)
                held = c > 0 and hp % 32 == 0 and (hp // c) % 16 == 0
                held = held and all(_mma_smem(hp, c, bw) > 0
                                    for bw in (False, True))
                assert ok is held, (e, h)
                if c:
                    assert hp // c <= 256 or c == 1   # a rank's 8 warps
                    for bw in (False, True):
                        assert K.tile_smem_bytes(
                            K._round_up(e, 32), hp, bw, G.GATES,
                            ranks=c) == _mma_smem(hp, c, bw)
            else:
                held = all(0 < _f32_smem(e, h, bw) <= K.SMEM_LIMIT
                           for bw in (False, True))
                c = K.f32_cluster(h)
                held = held and c > 0 and K.f32_tile_hidden(h) // c <= 128
                assert ok is held, (e, h)
                if c:
                    assert K.f32_smem_bytes(e, h, True, G.GATES) == \
                        _f32_smem(e, h, True)
                    assert K.f32_smem_bytes(e, h, False, G.GATES) == \
                        _f32_smem(e, h, False)


@pytest.mark.parametrize("h,hp,c", [(448, 448, 1), (449, 480, 2),
                                    (512, 512, 2), (513, 576, 4),
                                    (544, 576, 4), (1000, 1024, 4),
                                    (1024, 1024, 4), (1025, 1056, 0)])
def test_cluster_rule_and_padding(h, hp, c):
    """One block to 448, 2 ranks to 512, 4 to 1,024 (a rank's units a
    multiple of 16); the wrapper's padding keeps the first H units (a padded
    unit stays at exactly 0)."""
    assert G.gru_tile_hidden(h) == hp and G.gru_cluster(hp) == c
    if not c:
        return
    args, _ = _inputs(3, 2, 40, h)
    tx = [torch.from_numpy(a) for a in args]
    xp, *wp = G.pad_gru_operands(tx[0], *tx[2:])
    assert wp[2].shape == (hp, 3 * hp) and xp.shape[-1] == 64
    out = G.gru_fused_res_reference(xp, tx[1], *wp, time_chunk=2)[0]
    ref = G.gru_fused_res_reference(*tx, time_chunk=2)[0]
    assert not out[..., h:].any()
    assert _max_err(out[..., :h], ref) <= TOL


@pytest.mark.parametrize("e,h,dtype", [(256, 512, BF16), (256, 512, F32),
                                       (256, 1024, BF16), (256, 1024, F32),
                                       (300, 480, BF16), (256, 404, F32),
                                       (1500, 256, F32), (4096, 640, BF16)])
def test_layer_takes_wide_shapes_on_card_tensors(e, h, dtype):
    def on_card():
        return SimpleNamespace(shape=(64, 30, e), is_cuda=True)

    layer = RNNLayer(e, h, use_kernel=True, dtype=dtype, device="cpu",
                     rnn_type="gru")
    assert layer.kernel_ok(on_card(), None) is True
    assert layer.kernel_ok(on_card(), None, training=True) is True
    # past 1,024 units the step route holds it too
    wide = RNNLayer(e, 1152, use_kernel=True, dtype=dtype, device="cpu",
                    rnn_type="gru")
    assert wide.kernel_ok(on_card(), None) is True
