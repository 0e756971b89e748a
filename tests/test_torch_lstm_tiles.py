"""What surrounds the bf16 tensor-core LSTM kernels on the host
(``ops/kernels/lstm.py``): the shape limits (``fused_supported``,
``tile_config``, ``tile_smem_bytes``), the zero-padding of E and H to the
tiles' multiple (``pad_lstm_operands``), and the plain versions the card's
kernels are held to, at the ragged shapes that stress those tiles, against
the JAX package at f32.

JAX side: ``lstm_pallas_fused``'s kernels in Pallas interpret mode where
the JAX ``fused_supported`` holds (H a multiple of 128, at least 8 rows);
elsewhere (H = 100, H = 8, 1 row) the JAX ``lstm_scan`` on ``x @ W_ih + b``
and its ``jax.vjp``.  Tolerances: outputs and boundaries 1e-5 abs;
gradients 2e-5 times the largest magnitude of the JAX gradient (dW sums
B*T terms in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from context_attentive_ir_tpu.ops.pallas.lstm import (
    _lstm_fused_bwd_impl,
    _lstm_fused_res_impl,
    lstm_pallas_reference,
)
from context_attentive_ir_tpu.ops.pallas.lstm import (
    fused_supported as jax_fused_supported,
)
from context_attentive_ir_tpu_torch.ops.kernels import lstm as K

TOL = 1e-5
REL = 2e-5
BF16, F32 = torch.bfloat16, torch.float32


def _inputs(seed, b, t, e, h, empty_rows=True):
    rng = np.random.RandomState(seed)
    x = (rng.normal(size=(b, t, e)) * 0.3).astype(np.float32)
    w_ih = (rng.normal(size=(e, 4 * h)) * 0.1).astype(np.float32)
    bias = (rng.normal(size=(4 * h,)) * 0.1).astype(np.float32)
    w_hh = (rng.normal(size=(h, 4 * h)) * 0.1).astype(np.float32)
    lens = rng.randint(0, t + 1, size=(b,))
    lens[0] = t
    if empty_rows and b > 2:
        lens[1] = lens[-1] = 0   # rows whose mask is all False
    mask = np.arange(t)[None, :] < lens[:, None]
    dout = rng.normal(size=(b, t, h)).astype(np.float32)
    return x, mask, w_ih, bias, w_hh, dout


def _np(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                      np.float32)


def _max_err(a, b):
    return float(np.max(np.abs(_np(a) - _np(b))))


def _close_rel(got, ref, rel=REL):
    scale = max(float(np.max(np.abs(_np(ref)))), 1e-30)
    assert _max_err(got, ref) <= rel * scale, (_max_err(got, ref), scale)


# -- the limits ---------------------------------------------------------------

@pytest.mark.parametrize("hidden,config", [
    (32, (1, 4)), (64, (1, 4)), (96, (2, 4)), (128, (2, 4)), (160, (4, 2)),
    (256, (4, 2)), (288, (8, 1)), (512, (8, 1))])
def test_tile_config_by_hidden_size(hidden, config):
    g, mt = K.tile_config(hidden)
    assert (g, mt) == config
    assert 8 * g * 8 >= hidden          # eight warps of g groups of 8 units
    assert 16 * g * mt <= 128           # accumulators a thread


@pytest.mark.parametrize("e,h,backward,n_bytes", [
    # mbarriers + 3 slabs of 32 x (8h + 16) + 3 x slots of 64 x (2 * 32 +
    # 16) + h tile + bias, 64 rows; E takes no shared memory
    (256, 128, False, 64 + 3 * 32 * 1040 + 3 * 64 * 80 + 64 * 272 + 2048),
    # the backward: the union of the h tile and the dgates tile, + dh
    (256, 128, True, 64 + 3 * 32 * 1040 + 3 * 64 * 80 + 64 * 1040
     + 64 * 136 * 4 + 2048),
    # 32 k-rows do not fit: 16
    (320, 384, True, 64 + 3 * 16 * 3088 + 3 * 16 * 48 + 16 * 3088
     + 16 * 392 * 4 + 6144),
    # a cluster of 2 ranks of 256 units: two h tiles of all 512; the
    # backward's partials of dh, one tile of 256 + 8 floats a rank
    (256, 512, False, 64 + 3 * 16 * 2064 + 3 * 16 * 48 + 2 * 16 * 1040
     + 4096),
    (4096, 1024, True, 64 + 3 * 16 * 2064 + 3 * 16 * 48 + 16 * 2064
     + 4 * 16 * 264 * 4 + 4096),
    (512, 1056, True, 0), (4096, 1152, False, 0), (256, 1088, False, 0)])
def test_tile_smem_bytes(e, h, backward, n_bytes):
    assert K.tile_smem_bytes(e, h, backward) == n_bytes
    assert n_bytes <= K.SMEM_LIMIT


@pytest.mark.parametrize("e,h,dtype,ok", [
    (256, 128, BF16, True),     # the main path
    (300, 100, BF16, True),     # padded to 320, 128
    (37, 8, BF16, True),
    (480, 128, BF16, True),     # E is streamed: any E ...
    (481, 1152, BF16, True),    # ... and H above 1,024 the step route
    (512, 256, BF16, True),
    (256, 384, BF16, True),     # the largest H of one block ...
    (256, 1025, BF16, True),    # ... 1,056 after padding: the step route
    (32, 1152, BF16, True),
    (256, 1056, BF16, True),    # hidden above 1,024: the step route
    (256, 128, F32, True),
    (256, 1152, F32, True),     # no cluster of 8 blocks: the step route
    (256, 403, F32, True),      # 4 * 403 * 144 = 232,128 <= 232,448
    (256, 1025, F32, True),
    (1485, 128, F32, True),     # x staged in chunks: any E ...
    (1487, 1152, F32, True),    # ... and H above 1,024 the step route
    (256, 1153, F32, True),     # hidden above 1,024
    (256, 128, torch.float16, False),
    (0, 128, BF16, False), (256, 0, BF16, False)])
def test_fused_supported_at_and_beyond_each_limit(e, h, dtype, ok):
    assert K.fused_supported(e, h, 40, dtype) is ok


def test_fused_supported_needs_a_row_and_defaults_to_float32():
    assert not K.fused_supported(256, 128, 0)
    assert K.fused_supported(256, 128, 1)
    assert K.fused_supported(256, 400, 1) is K.fused_supported(
        256, 400, 1, F32)


# -- padding -----------------------------------------------------------------

PAD_SHAPES = [(5, 3, 300, 100), (4, 2, 64, 8), (3, 2, 37, 19),
              (3, 2, 32, 40), (3, 2, 40, 32)]


@pytest.mark.parametrize("b,t,e,h", PAD_SHAPES)
def test_pad_lstm_operands_shapes_and_zeros(b, t, e, h):
    x, _, w_ih, bias, w_hh, _ = map(torch.from_numpy, _inputs(0, b, t, e, h))
    xp, wp, bp, whp = K.pad_lstm_operands(x, w_ih, bias, w_hh)
    ep, hp = -(-e // 32) * 32, -(-h // 32) * 32
    assert xp.shape == (b, t, ep) and wp.shape == (ep, 4 * hp)
    assert bp.shape == (4 * hp,) and whp.shape == (hp, 4 * hp)
    for p in (xp, wp, bp, whp):
        assert p.is_contiguous() and p.data_ptr() % 16 == 0
    # the originals sit in the first E rows / H columns of each gate block
    assert torch.equal(xp[..., :e], x) and not xp[..., e:].any()
    assert torch.equal(wp[:e].reshape(e, 4, hp)[..., :h],
                       w_ih.reshape(e, 4, h))
    assert torch.equal(whp[:h].reshape(h, 4, hp)[..., :h],
                       w_hh.reshape(h, 4, h))
    assert torch.equal(bp.reshape(4, hp)[:, :h], bias.reshape(4, h))
    # everything else is zero
    assert int((wp != 0).sum()) == int((w_ih != 0).sum())
    assert int((whp != 0).sum()) == int((w_hh != 0).sum())
    assert int((bp != 0).sum()) == int((bias != 0).sum())
    # cutting the gate blocks back round-trips
    assert torch.equal(K._cut_gates(wp[:e], h, hp), w_ih)
    assert torch.equal(K._cut_gates(bp, h, hp), bias)
    assert torch.equal(K._cut_gates(whp[:h], h, hp), w_hh)


def test_pad_lstm_operands_leaves_aligned_operands_alone():
    x, _, w_ih, bias, w_hh, _ = map(torch.from_numpy, _inputs(0, 4, 3, 64, 32))
    out = K.pad_lstm_operands(x, w_ih, bias, w_hh)
    for got, t in zip(out, (x, w_ih, bias, w_hh)):
        assert got.data_ptr() == t.data_ptr() and got.shape == t.shape


def test_pad_lstm_operands_copies_a_misaligned_view():
    base = torch.zeros(4 * 3 * 64 + 1)
    x = base[1:].view(4, 3, 64)          # 4 bytes off the allocation
    _, _, w_ih, bias, w_hh, _ = map(torch.from_numpy, _inputs(0, 4, 3, 64, 32))
    xp = K.pad_lstm_operands(x, w_ih, bias, w_hh)[0]
    assert xp.data_ptr() % 16 == 0 and torch.equal(xp, x)


@pytest.mark.parametrize("e,h", [(64, 32), (256, 128), (32, 96)])
def test_stage_lstm_weights_is_the_ring_layout(e, h):
    """One [E + H, 4H + 8] matrix, W_ih over W_hh, 8 zero columns a row: a
    slab of ks rows is ks * (8H + 16) contiguous bytes, the staged rows'
    stride in shared memory."""
    rng = np.random.RandomState(7)
    w_ih = torch.from_numpy(rng.normal(size=(e, 4 * h)).astype(np.float32))
    w_hh = torch.from_numpy(rng.normal(size=(h, 4 * h)).astype(np.float32))
    staged = K.stage_lstm_weights(w_ih.bfloat16(), w_hh.bfloat16())
    assert staged.shape == (e + h, 4 * h + 8) and staged.is_contiguous()
    assert staged.dtype == BF16 and staged.data_ptr() % 16 == 0
    assert staged.stride(0) * staged.element_size() == 8 * h + 16
    assert torch.equal(staged[:e, :4 * h], w_ih.bfloat16())
    assert torch.equal(staged[e:, :4 * h], w_hh.bfloat16())
    assert not staged[:, 4 * h:].any()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b,t,e,h", PAD_SHAPES[:3])
def test_padding_leaves_the_plain_versions_unchanged(b, t, e, h, reverse):
    """The padded LSTM's first E / H entries are the original's: what the
    wrappers do on the card, through the plain versions."""
    x, mask, w_ih, bias, w_hh, dout = map(torch.from_numpy,
                                          _inputs(1, b, t, e, h))
    out, hb, cb = K.lstm_fused_res_reference(x, mask, w_ih, bias, w_hh,
                                             reverse, 2)
    grads = K.lstm_fused_bwd_reference(x, mask, w_ih, bias, w_hh, hb, cb,
                                       dout, reverse, 2)
    xp, wp, bp, whp = K.pad_lstm_operands(x, w_ih, bias, w_hh)
    hp = whp.shape[0]
    out_p, hb_p, cb_p = K.lstm_fused_res_reference(xp, mask, wp, bp, whp,
                                                   reverse, 2)
    assert not out_p[..., h:].any() and not cb_p[..., h:].any()
    for got, ref in ((out_p, out), (hb_p, hb), (cb_p, cb)):
        assert _max_err(got[..., :h], ref) <= 1e-6
    dx_p, dwih_p, db_p, dwhh_p = K.lstm_fused_bwd_reference(
        xp, mask, wp, bp, whp, hb_p, cb_p, K._pad_last(dout, hp), reverse, 2)
    assert not dx_p[..., e:].any()
    cut = (dx_p[..., :e], K._cut_gates(dwih_p[:e], h, hp),
           K._cut_gates(db_p, h, hp), K._cut_gates(dwhh_p[:h], h, hp))
    for got, ref in zip(cut, grads):
        assert got.shape == ref.shape
        _close_rel(got, ref, 1e-5)
    # a padded unit has no gradient
    assert float(db_p.reshape(4, hp)[:, h:].abs().max()) == 0.0


# -- the plain versions at the tiles' ragged shapes, against JAX ---------------

# (rows, T, E, H, time chunk): rows off the 64-row block, E and H off the
# tiles' multiple, T = 1, T off the time chunk
RAGGED = [(1, 5, 24, 128, 6), (33, 7, 40, 128, 6), (9, 6, 300, 100, 4),
          (9, 7, 20, 8, 3), (12, 1, 24, 128, 6), (10, 17, 24, 16, 6),
          (65, 5, 16, 128, 2)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b,t,e,h,tc", RAGGED)
def test_plain_versions_match_jax_at_ragged_shapes(b, t, e, h, tc, reverse):
    x, mask, w_ih, bias, w_hh, dout = _inputs(2, b, t, e, h)
    tx = list(map(torch.from_numpy, (x, mask, w_ih, bias, w_hh)))
    out, hb, cb = K.lstm_fused_res(*tx, reverse=reverse, time_chunk=tc,
                                   device="cpu")
    n_chunks = -(-t // K.chunk_len(t, tc))
    assert out.shape == (b, t, h) and hb.shape == cb.shape == (n_chunks, b, h)
    assert not out[~tx[1]].any()          # masked outputs exactly 0
    got = K.lstm_fused_bwd(*tx, hb, cb, torch.from_numpy(dout),
                           reverse=reverse, time_chunk=tc, device="cpu")
    assert not got[0][~tx[1]].any()       # masked steps get no gradient
    jx = list(map(jnp.asarray, (x, mask, w_ih, bias, w_hh)))
    if jax_fused_supported(e, h, b):
        # the Pallas kernels, interpret mode, their own chunk length
        jtc = K.chunk_len(t, tc)
        out_j, hb_j, cb_j = _lstm_fused_res_impl(
            *jx, reverse=reverse, block_b=16, time_chunk=jtc, interpret=True)
        ref = _lstm_fused_bwd_impl(*jx, hb_j, cb_j, jnp.asarray(dout),
                                   reverse=reverse, block_b=16,
                                   time_chunk=jtc, interpret=True)
        assert _max_err(hb, np.asarray(hb_j)[:, :b]) <= TOL
        assert _max_err(cb, np.asarray(cb_j)[:, :b]) <= TOL
    else:
        def scan(x, w_ih, bias, w_hh):
            return lstm_pallas_reference(x @ w_ih + bias, jnp.asarray(mask),
                                         w_hh, reverse=reverse)

        out_j, vjp = jax.vjp(scan, jx[0], *jx[2:])
        ref = vjp(jnp.asarray(dout))
    assert _max_err(out, out_j) <= TOL
    for name, g, r in zip(("dx", "dw_ih", "db", "dw_hh"), got, ref):
        assert g.shape == r.shape, name
        _close_rel(g, r)


@pytest.mark.parametrize("reverse", [False, True])
def test_chunks_at_the_recommenders_source(reverse):
    """The flat source of seq2seq / ACG, [64 rows, T = 150], which no other
    path gives the training pair: 25 chunks of the time chunk 6, the
    boundary states and the gradients as the Pallas kernels in interpret
    mode give them (E narrowed to 24 for the CPU)."""
    b, t, e, h, tc = 64, 150, 24, 128, 6
    x, mask, w_ih, bias, w_hh, dout = _inputs(3, b, t, e, h)
    tx = list(map(torch.from_numpy, (x, mask, w_ih, bias, w_hh)))
    out, hb, cb = K.lstm_fused_res(*tx, reverse=reverse, time_chunk=tc,
                                   device="cpu")
    assert K.chunk_len(t, tc) == tc and hb.shape == cb.shape == (25, b, h)
    got = K.lstm_fused_bwd(*tx, hb, cb, torch.from_numpy(dout),
                           reverse=reverse, time_chunk=tc, device="cpu")
    jx = list(map(jnp.asarray, (x, mask, w_ih, bias, w_hh)))
    assert jax_fused_supported(e, h, b)
    out_j, hb_j, cb_j = _lstm_fused_res_impl(
        *jx, reverse=reverse, block_b=16, time_chunk=tc, interpret=True)
    ref = _lstm_fused_bwd_impl(*jx, hb_j, cb_j, jnp.asarray(dout),
                               reverse=reverse, block_b=16, time_chunk=tc,
                               interpret=True)
    assert _max_err(out, out_j) <= TOL
    assert _max_err(hb, np.asarray(hb_j)[:, :b]) <= TOL
    assert _max_err(cb, np.asarray(cb_j)[:, :b]) <= TOL
    for name, g, r in zip(("dx", "dw_ih", "db", "dw_hh"), got, ref):
        assert g.shape == r.shape, name
        _close_rel(g, r)


def test_jax_gate_splits_the_ragged_shapes_as_the_docstring_says():
    kernel = [s for s in RAGGED if jax_fused_supported(s[2], s[3], s[0])]
    assert [s[:4] for s in kernel] == [(33, 7, 40, 128), (12, 1, 24, 128),
                                       (65, 5, 16, 128)]
