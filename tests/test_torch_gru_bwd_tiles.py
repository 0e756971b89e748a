"""What surrounds kernel 9's bf16 tensor-core phase A (``csrc/gru_bwd.cu``,
``ops/kernels/gru.py``) on the host: its shared-memory sizing (a four-slot
gradient tile, the dh exchange inside the staged area), the limits it sets
(``gru_fused_supported``), the rows a block takes (``bwd_row_tiles``), the
padding the wrapper does, and a plain-PyTorch emulation of the kernel's
algorithm held to the JAX package at f32 on ragged shapes.

The emulation follows ``gru_bwd_mma_kernel`` step by step: the padded
operands and the staged ``[W_ih; W_hh]`` cut into slabs of ``ks`` k-rows;
the recompute as kernel 8's slab algorithm (four f32 slots, h carried in
f32 and staged rounded); the five planes ``(h_prev, r, z, n, hn)`` a cell;
the four gradient slots ``[da_r, da_z, da_n, da_n * r]`` rounded into one
``[B, 4H]`` tile; ``dx_t`` as slots 0..2 against each W_ih slab and the
product in dh as slots 0, 1, 3 against each W_hh slab (a slab's rows are
the product's output columns); dh carried on masked steps; phase B as
``X^T G`` and ``H_prev^T G`` over every (row, step); db as per-block sums of
the f32 slots (blocks of 16 * ``bwd_row_tiles`` rows) added in block order.

JAX side: ``_gru_fused_bwd_impl`` in Pallas interpret mode on
``_gru_fused_res_impl``'s boundaries where the JAX ``gru_fused_supported``
holds (H a multiple of 128, at least 8 rows), else ``jax.vjp`` of
``gru_pallas_reference``.  Tolerance: 2e-5 times the largest magnitude of
the JAX gradient (dW sums B*T terms in another order), as
``tests/test_torch_gru_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from context_attentive_ir_tpu.ops.pallas.gru import (
    _gru_fused_bwd_impl,
    _gru_fused_res_impl,
    gru_pallas_reference,
)
from context_attentive_ir_tpu.ops.pallas.gru import (
    gru_fused_supported as jax_gru_fused_supported,
)
from context_attentive_ir_tpu_torch.ops.kernels import gru as K
from context_attentive_ir_tpu_torch.ops.kernels import lstm as L

REL = 2e-5
BF16, F32 = torch.bfloat16, torch.float32
NAMES = ("dx", "dw_ih", "db_ih", "dw_hh", "db_hh")


def _inputs(seed, b, t, e, h):
    rng = np.random.RandomState(seed)
    x = (rng.normal(size=(b, t, e)) * 0.3).astype(np.float32)
    w_ih = (rng.normal(size=(e, 3 * h)) * 0.1).astype(np.float32)
    b_ih = (rng.normal(size=(3 * h,)) * 0.1).astype(np.float32)
    w_hh = (rng.normal(size=(h, 3 * h)) * 0.1).astype(np.float32)
    b_hh = (rng.normal(size=(3 * h,)) * 0.1).astype(np.float32)
    lens = rng.randint(0, t + 1, size=(b,))
    lens[0] = t
    if b > 2:
        lens[1] = lens[-1] = 0   # rows whose mask is all False
    mask = np.arange(t)[None, :] < lens[:, None]
    dout = rng.normal(size=(b, t, h)).astype(np.float32)
    return (x, mask, w_ih, b_ih, w_hh, b_hh), dout


def _np(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                      np.float32)


def _close_rel(got, ref, rel=REL):
    err = float(np.max(np.abs(_np(got) - _np(ref))))
    scale = max(float(np.max(np.abs(_np(ref)))), 1e-30)
    assert err <= rel * scale, (err, scale)


# -- shared memory and limits -------------------------------------------------

def _bwd_bytes(e, h, m, depth):
    """The GRU backward's sum written out: mbarriers, three slabs of
    ``depth`` rows of 3H + 8 bf16, the union of the forward's tiles and
    {m rows of four slots of H + 8 bf16, the f32 dh exchange}, the bias."""
    fwd = 2 * m * (2 * e + 16) + m * (2 * h + 16)
    rev = m * (2 * 4 * h + 16) + m * (h + 8) * 4
    return 64 + 3 * depth * (2 * 3 * h + 16) + max(fwd, rev) + 16 * h


@pytest.mark.parametrize("e,h,rows,n_bytes", [
    (256, 128, None, _bwd_bytes(256, 128, 64, 32)),   # the main path
    (256, 128, 16, _bwd_bytes(256, 128, 16, 32)),     # 16-row blocks
    (672, 128, None, _bwd_bytes(672, 128, 64, 16)),   # E's limit: 16 k-rows
    (704, 128, None, 0),
    (256, 448, None, _bwd_bytes(256, 448, 16, 16)),   # H's limit
    (256, 480, None, 0),
    (64, 32, None, _bwd_bytes(64, 32, 64, 32)),
    (32, 512, None, 0)])
def test_gru_backward_tiles_count_four_slots(e, h, rows, n_bytes):
    assert L.tile_smem_bytes(e, h, backward=True, gates=3,
                             rows=rows) == n_bytes
    assert n_bytes <= L.SMEM_LIMIT
    if n_bytes:
        # the union holds the forward's tiles: kernel 9 fits where it fits
        assert n_bytes >= L.tile_smem_bytes(e, h, gates=3, rows=rows) > 0


def test_the_four_slot_tile_sets_the_hidden_limit():
    """The gradient tile has four slots of H, not the forward's three gate
    blocks: with three, H = 480 would fit at E = 256; with four it does
    not, and 448 is the limit."""
    m, h = 16, 480
    fwd = 2 * m * (2 * 256 + 16) + m * (2 * h + 16)
    three = m * (2 * 3 * h + 16) + m * (h + 8) * 4
    ring = 3 * 16 * (2 * 3 * h + 16)
    assert 64 + ring + max(fwd, three) + 16 * h <= L.SMEM_LIMIT
    assert L.tile_smem_bytes(256, 480, backward=True, gates=3) == 0
    assert L.tile_smem_bytes(256, 448, backward=True, gates=3) > 0


@pytest.mark.parametrize("e,h", [(256, 128), (300, 100), (640, 96),
                                 (256, 416), (100, 256)])
def test_the_lstm_backward_keeps_its_layout(e, h):
    """Kernel 5's sum is unchanged: the dh exchange after the union."""
    ep, hp = L._round_up(e, 32), L._round_up(h, 32)
    m = 16 * L.tile_config(hp)[1]
    fwd = 2 * m * (2 * ep + 16) + m * (2 * hp + 16)
    tiles = max(fwd, m * (8 * hp + 16)) + m * (hp + 8) * 4
    for depth in (32, 16):
        n_bytes = 64 + 3 * depth * (8 * hp + 16) + tiles + 16 * hp
        if n_bytes <= L.SMEM_LIMIT:
            break
    else:
        n_bytes = 0
    assert L.tile_smem_bytes(ep, hp, backward=True) == n_bytes


@pytest.mark.parametrize("e,h,ok", [
    (672, 128, True), (673, 128, False), (256, 448, True),
    (256, 449, False), (300, 100, True), (1, 1, True), (32, 512, False)])
def test_bf16_limits_are_kernel_9s_tiles(e, h, ok):
    assert K.gru_fused_supported(e, h, 40, BF16) is ok
    ep, hp = L._round_up(e, 32), L._round_up(h, 32)
    assert ok is (hp <= 512 and L.tile_smem_bytes(
        ep, hp, backward=True, gates=3) > 0)


@pytest.mark.parametrize("h,rows,tiles", [
    (128, 320, 1), (128, 8384, 1), (128, 8385, 4), (128, 16000, 4),
    (256, 4192, 1), (256, 4193, 2), (64, 16000, 4), (384, 16000, 1),
    (512, 1, 1)])
def test_bwd_row_tiles_takes_16_rows_below_one_wave(h, rows, tiles):
    """16-row blocks where the tiles' own would give fewer blocks than the
    card's 132 SMs (the query encoder's 320 rows: 5 blocks of 64, 20 of
    16), the tiles' own above."""
    assert K.bwd_row_tiles(h, rows) == tiles
    own = L.tile_config(h)[1]
    assert tiles == (1 if -(-rows // (16 * own)) < K.SMALL_GRID else own)


# -- the wrapper's padding ------------------------------------------------------

@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b,t,e,h", [(5, 4, 300, 100), (4, 3, 37, 19)])
def test_padding_leaves_the_gradients_unchanged(b, t, e, h, reverse):
    """What the wrapper does on the card, through the plain versions: the
    padded GRU's gradients, cut back, are the original's, and a padded unit
    or input column gets exactly 0."""
    args, dout = _inputs(3, b, t, e, h)
    tx = [torch.from_numpy(a) for a in args]
    hb = K.gru_fused_res_reference(*tx, reverse, 2)[1]
    ref = K.gru_fused_bwd_reference(*tx, hb, torch.from_numpy(dout),
                                    reverse, 2)
    xp, *wp = K.pad_gru_operands(tx[0], *tx[2:])
    hp = wp[2].shape[0]
    got = K.gru_fused_bwd_reference(
        xp, tx[1], *wp, L._pad_last(hb, hp),
        L._pad_last(torch.from_numpy(dout), hp), reverse, 2)
    dx, dw_ih, db_ih, dw_hh, db_hh = got
    ep = xp.shape[-1]
    assert not dx[..., e:].any() and not dw_ih[e:].any()
    assert not dw_hh[h:].any()
    for w in (dw_ih, db_ih, dw_hh, db_hh):
        assert not w.reshape(*w.shape[:-1], 3, hp)[..., h:].any()
    cut = (dx[..., :e], L._cut_gates(dw_ih[:e], h, hp, 3),
           L._cut_gates(db_ih, h, hp, 3), L._cut_gates(dw_hh[:h], h, hp, 3),
           L._cut_gates(db_hh, h, hp, 3))
    assert ep % 32 == 0 and hp % 32 == 0
    for name, g, r in zip(NAMES, cut, ref):
        assert g.shape == r.shape, name
        _close_rel(g, r, 1e-6)


# -- the tile algorithm against JAX ------------------------------------------------

def slab_backward(x, mask, w_ih, b_ih, w_hh, b_hh, hb, dout, reverse,
                  time_chunk, ks, row_tiles):
    """Kernel 9's bf16 algorithm in plain PyTorch (see the module note):
    ``(dx, dw_ih, db_ih, dw_hh, db_hh)``, cut back to E and H."""
    B, T, E = x.shape
    H = w_hh.shape[0]
    cdt, wdt = x.dtype, w_ih.dtype
    x, w_ih, b_ih, w_hh, b_hh = K.pad_gru_operands(x, w_ih, b_ih, w_hh, b_hh)
    ep, hp = x.shape[-1], w_hh.shape[0]
    hb = L._pad_last(hb.float(), hp)
    dout = L._pad_last(dout, hp).float()
    staged = L.stage_lstm_weights(w_ih, w_hh).float()
    slabs = [(k0, staged[k0:k0 + ks, :3 * hp])
             for k0 in range(0, ep + hp, ks)]
    assert all((k0 + ks <= ep) is (k0 < ep) for k0, _ in slabs)
    bias = torch.cat([b_ih[:2 * hp].float() + b_hh[:2 * hp].float(),
                      b_ih[2 * hp:].float(), b_hh[2 * hp:].float()])
    tc = L.chunk_len(T, time_chunk)
    n_chunks = -(-T // tc)
    m_rows = 16 * row_tiles
    n_blocks = -(-B // m_rows)

    def rnd(v):
        return v.to(cdt).float()

    xf = x.float()
    dx = torch.zeros((B, T, ep))
    dh = torch.zeros((B, hp))
    db_part = torch.zeros((n_blocks, 4 * hp))
    slots_c = torch.zeros((B, T, 4 * hp))   # phase B's operands
    h_prev_c = torch.zeros((B, T, hp))
    for q in range(n_chunks):
        chunk = q if reverse else n_chunks - 1 - q
        steps = range(chunk * tc, min((chunk + 1) * tc, T))
        h = hb[chunk].clone()
        h_tile = rnd(h)
        planes = []
        for t in (reversed(steps) if reverse else steps):
            acc = bias.reshape(4, 1, hp).repeat(1, B, 1)   # r, z, xn, hn
            for k0, slab in slabs:
                x_slab = k0 < ep
                a = (xf[:, t, k0:k0 + ks] if x_slab
                     else h_tile[:, k0 - ep:k0 - ep + ks])
                acc[0] += a @ slab[:, :hp]
                acc[1] += a @ slab[:, hp:2 * hp]
                acc[2 if x_slab else 3] += a @ slab[:, 2 * hp:]
            r, z = torch.sigmoid(acc[0]), torch.sigmoid(acc[1])
            n = torch.tanh(acc[2] + r * acc[3])
            planes.append((t, h, r, z, n, acc[3]))
            h_prev_c[:, t] = h_tile
            m = mask[:, t, None]
            h_new = (1.0 - z) * n + z * h
            h = torch.where(m, h_new, h)
            h_tile = torch.where(m, rnd(h_new), h_tile)
        for t, h_prev, r, z, n, hn in reversed(planes):
            m = mask[:, t, None]
            dh_new = dout[:, t] + dh
            dz = dh_new * (h_prev - n)
            da_n = dh_new * (1.0 - z) * (1.0 - n * n)
            slots = torch.cat([da_n * hn * r * (1.0 - r), dz * z * (1.0 - z),
                               da_n, da_n * r], -1)
            slots = torch.where(m, slots, torch.zeros(()))
            for blk in range(n_blocks):
                db_part[blk] += slots[blk * m_rows:(blk + 1) * m_rows].sum(0)
            tile = rnd(slots)
            slots_c[:, t] = tile
            a_hh = torch.cat([tile[:, :2 * hp], tile[:, 3 * hp:]], -1)
            prod = torch.zeros((B, hp))
            for k0, slab in slabs:
                if k0 < ep:
                    dx[:, t, k0:k0 + ks] = tile[:, :3 * hp] @ slab.T
                else:
                    prod[:, k0 - ep:k0 - ep + ks] = a_hh @ slab.T
            dh = torch.where(m, prod + dh_new * z, dh)
    g = slots_c.reshape(B * T, 4 * hp)
    hc = h_prev_c.reshape(B * T, hp)
    dw_ih = xf.reshape(B * T, ep).T @ g[:, :3 * hp]
    dw_hh = torch.cat([hc.T @ g[:, :2 * hp], hc.T @ g[:, 3 * hp:]], 1)
    db = torch.zeros(4 * hp)
    for blk in range(n_blocks):   # sum_partials_kernel's order
        db = db + db_part[blk]
    db_ih = db[:3 * hp]
    db_hh = torch.cat([db[:2 * hp], db[3 * hp:]])
    return (dx[..., :E].to(cdt), L._cut_gates(dw_ih[:E], H, hp, 3).to(wdt),
            L._cut_gates(db_ih, H, hp, 3).to(wdt),
            L._cut_gates(dw_hh[:H], H, hp, 3).to(wdt),
            L._cut_gates(db_hh, H, hp, 3).to(wdt))


def _jax_gradients(args, dout, reverse, tc):
    """The JAX gradients and boundaries: the Pallas kernels in interpret
    mode where the JAX gate holds, else ``jax.vjp`` of the reference (and
    the port's own plain boundaries, which the reference does not give)."""
    jx = [jnp.asarray(a) for a in args]
    B, T = args[1].shape
    E, H = args[0].shape[-1], args[4].shape[0]
    if jax_gru_fused_supported(E, H, B):
        _, hb = _gru_fused_res_impl(*jx, reverse=reverse, block_b=16,
                                    time_chunk=tc, interpret=True)
        grads = _gru_fused_bwd_impl(*jx, hb, jnp.asarray(dout),
                                    reverse=reverse, block_b=16,
                                    time_chunk=tc, interpret=True)
        return [np.asarray(g) for g in grads], np.asarray(hb)[:, :B]
    _, vjp = jax.vjp(lambda x, wi, bi, wh, bh: gru_pallas_reference(
        x, jx[1], wi, bi, wh, bh, reverse=reverse), jx[0], *jx[2:])
    hb = K.gru_fused_res_reference(*(torch.from_numpy(a) for a in args),
                                   reverse, tc)[1]
    return [np.asarray(g) for g in vjp(jnp.asarray(dout))], hb.numpy()


# (rows, T, E, H, time chunk): rows off the 16-row block (17, 70) and one
# row, T = 1, 15 (Lq), 17, 30 (Ld), 33, E and H off the tiles' 32 (300 /
# 100, 20 / 40), rows whose mask is all False
RAGGED = [(17, 15, 40, 128, 6), (70, 30, 24, 128, 6), (9, 33, 24, 128, 6),
          (9, 17, 300, 100, 4), (3, 1, 20, 40, 6)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b,t,e,h,tc", RAGGED)
def test_tile_algorithm_matches_jax_at_ragged_shapes(b, t, e, h, tc,
                                                     reverse):
    args, dout = _inputs(5, b, t, e, h)
    grads_j, hb_j = _jax_gradients(args, dout, reverse, tc)
    tx = [torch.from_numpy(a) for a in args]
    hb = torch.from_numpy(np.array(hb_j))
    td = torch.from_numpy(dout)
    hp = L._round_up(h, 32)
    own = L.tile_config(hp)[1]
    assert K.bwd_row_tiles(hp, b) == 1   # these rows take 16-row blocks
    plain = K.gru_fused_bwd(*tx, hb, td, reverse=reverse, time_chunk=tc,
                            device="cpu")
    for ks, row_tiles in ((32, 1), (16, own)):
        got = slab_backward(*tx, hb, td, reverse, tc, ks, row_tiles)
        for name, g, j, p in zip(NAMES, got, grads_j, plain):
            assert g.shape == j.shape == p.shape, name
            _close_rel(g, j)
            _close_rel(g, p)
        # masked steps have no input gradient
        assert not got[0][~tx[1]].any()


@pytest.mark.parametrize("reverse", [False, True])
def test_tile_algorithm_rounds_where_the_plain_version_does(reverse):
    """bf16 operands: the emulation's rounding points (h before h @ W_hh and
    dW_hh, the slots before every product) are the plain version's, so
    the two agree to f32 summation order."""
    args, dout = _inputs(6, 12, 7, 64, 32)
    tx = [torch.from_numpy(a).to(BF16) if a.dtype == np.float32
          else torch.from_numpy(a) for a in args]
    td = torch.from_numpy(dout).to(BF16)
    hb = K.gru_fused_res_reference(*tx, reverse, 3)[1]
    ref = K.gru_fused_bwd_reference(*tx, hb, td, reverse, 3)
    got = slab_backward(*tx, hb, td, reverse, 3, 32, 1)
    for name, g, r in zip(NAMES, got, ref):
        assert g.dtype == r.dtype == BF16, name
        # one bf16 rounding of values that differ in their last f32 bits
        _close_rel(g.float(), r.float(), 2 ** -7)
