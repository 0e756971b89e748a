"""What surrounds the bf16 tensor-core GRU forwards (kernels 7 and 8,
``ops/kernels/gru.py``) on the host: the shape limits
(``gru_fused_supported``, ``tile_smem_bytes`` with three gate blocks), the
zero-padding of E and H to the tiles' multiple (``pad_gru_operands``), the
staged weights, and a plain-PyTorch emulation of the kernels' slab
algorithm held to the JAX package at f32 on ragged shapes.

The emulation follows ``csrc/gru_fwd.cu`` step by step: the padded operands
and the staged ``[W_ih; W_hh]`` cut into slabs of ``ks`` k-rows; four f32
slots per (row, unit) started from the biases (r and z from ``b_ih + b_hh``,
xn from ``b_ih_n``, hn from ``b_hh_n``); r and z take every slab, the n
columns of an x slab go into xn and those of an h slab into hn; h carried in
f32 and staged rounded to the input dtype for the next step's product.

JAX side: ``_gru_fused_impl`` / ``_gru_fused_res_impl`` in Pallas interpret
mode where the JAX ``gru_fused_supported`` holds (H a multiple of 128, at
least 8 rows); elsewhere (1 row, H = 100, H = 8, H = 16) the JAX
``gru_scan`` on ``x @ W_ih + b_ih``, whose final state over the steps
before a chunk is that chunk's boundary.  Tolerance: 1e-5 abs.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from context_attentive_ir_tpu.ops.pallas.gru import (
    _gru_fused_impl,
    _gru_fused_res_impl,
)
from context_attentive_ir_tpu.ops.pallas.gru import (
    gru_fused_supported as jax_gru_fused_supported,
)
from context_attentive_ir_tpu.ops.rnn import gru_scan as jax_gru_scan
from context_attentive_ir_tpu_torch.ops.kernels import gru as K
from context_attentive_ir_tpu_torch.ops.kernels import lstm as L
from context_attentive_ir_tpu_torch.ops.rnn import RNNLayer

TOL = 1e-5
BF16, F32 = torch.bfloat16, torch.float32


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
    return x, mask, w_ih, b_ih, w_hh, b_hh


def _max_err(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


# -- the limits ---------------------------------------------------------------

@pytest.mark.parametrize("e,h,dtype,ok", [
    (256, 128, BF16, True),     # the main path
    (300, 100, BF16, True),     # padded to 320, 128
    (37, 8, BF16, True),
    (480, 128, BF16, True),     # the LSTM's widest E at H = 128 ...
    (672, 128, BF16, True),     # ... and the GRU's: x is streamed ...
    (673, 1152, BF16, True),    # ... and past H = 1,024 the step route
    (256, 384, BF16, True),     # the LSTM's largest single block at E = 256
    (256, 403, BF16, True),
    (256, 448, BF16, True),     # the GRU's single block, kernel 9's four slots
    (256, 449, BF16, True),     # 480 after padding: a cluster of 2
    (1486, 1152, BF16, True),   # no cluster holds H above 1,024: the step route
    (32, 512, BF16, True),      # a cluster of 2 at H = 512
    (256, 513, BF16, True),     # 576 after padding: a cluster of 4
    (256, 1024, BF16, True), (256, 1025, BF16, True),
    (256, 128, F32, True),      # float32: x staged in chunks ...
    (1485, 128, F32, True),
    (1487, 128, F32, True),     # ... so any E
    (256, 403, F32, True),      # kernel 9's one block (4H rows) ...
    (256, 404, F32, True),      # ... then clusters of up to 8 blocks
    (256, 513, F32, True), (256, 1024, F32, True),
    (256, 1025, F32, True),     # more than 8 blocks of 128: the step route
    (256, 128, torch.float16, False), (0, 128, BF16, False),
    (256, 0, BF16, False)])
def test_gru_fused_supported_at_and_beyond_each_limit(e, h, dtype, ok):
    assert K.gru_fused_supported(e, h, 40, dtype) is ok
    assert K.gru_fused_supported(e, h, 0, dtype) is False


@pytest.mark.parametrize("e,h", [(672, 128), (256, 403), (300, 100),
                                 (256, 448), (256, 449), (704, 128)])
def test_gru_bf16_limit_is_the_forward_tiles_and_kernel_9(e, h):
    """bf16 holds a shape up to 1,024 units exactly when, padded, kernel
    9's tensor-core tiles fit on ``gru_cluster``'s blocks; those hold the
    three-gate forward's tiles, so the forward fits wherever kernel 9
    does."""
    ep, hp = L._round_up(e, 32), K.gru_tile_hidden(h)
    c = K.gru_cluster(hp)
    held = c > 0 and L.tile_smem_bytes(ep, hp, backward=True, gates=3,
                                       ranks=c) > 0
    assert K.gru_fused_supported(e, h, 1, BF16) is (hp <= 1024 and held)
    if held:
        assert L.tile_smem_bytes(ep, hp, gates=3, ranks=c) > 0


@pytest.mark.parametrize("e,h,gates,n_bytes", [
    # mbarriers + 3 slabs of 32 x (2 * gates * h + 16) + 3 x slots of 64 x
    # (2 * 32 + 16) + h tile + bias (four f32 slots of h), 64 rows
    (256, 128, 3, 64 + 3 * 32 * 784 + 3 * 64 * 80 + 64 * 272 + 2048),
    (256, 128, 4, 64 + 3 * 32 * 1040 + 3 * 64 * 80 + 64 * 272 + 2048),
    # 32 k-rows do not fit: 16
    (672, 448, 3, 64 + 3 * 16 * 2704 + 3 * 16 * 48 + 16 * 912 + 7168),
    # 16 rows a block above H = 256
    (256, 416, 3, 64 + 3 * 16 * 2512 + 3 * 16 * 48 + 16 * 848 + 6656),
    # E takes no shared memory
    (320, 128, 3, 64 + 3 * 32 * 784 + 3 * 64 * 80 + 64 * 272 + 2048),
    (704, 1152, 3, 0), (4096, 1152, 3, 0), (704, 1152, 4, 0)])
def test_tile_smem_bytes_by_gate_count(e, h, gates, n_bytes):
    assert L.tile_smem_bytes(e, h, gates=gates) == n_bytes
    assert n_bytes <= L.SMEM_LIMIT
    if gates == 4:   # the default is the LSTM's
        assert L.tile_smem_bytes(e, h) == n_bytes


def test_layer_takes_the_new_bf16_limit():
    """``RNNLayer`` takes a bf16 GRU past one x tile (E = 672) and past the
    kernels' clusters (H above 1,024: the step route) on CPU and CUDA
    tensors; a dtype the kernels do not take goes to the scan on CPU
    tensors and is refused on CUDA tensors."""
    def on_card(e):
        return SimpleNamespace(shape=(5, 4, e), is_cuda=True)

    for e, h, dtype, held in ((672, 128, BF16, True),
                              (704, 1152, BF16, True),
                              (704, 1152, torch.float16, False)):
        layer = RNNLayer(e, h, use_kernel=True, dtype=dtype, device="cpu",
                         rnn_type="gru")
        assert layer.kernel_ok(torch.zeros(5, 4, e), None) is held
        if held:
            assert layer.kernel_ok(on_card(e), None) is True
        else:
            with pytest.raises(ValueError, match="use_kernel=False"):
                layer.kernel_ok(on_card(e), None)


# -- padding and staging -------------------------------------------------------

PAD_SHAPES = [(5, 3, 300, 100), (4, 2, 64, 8), (3, 2, 37, 19),
              (3, 2, 32, 40), (3, 2, 40, 32)]


@pytest.mark.parametrize("b,t,e,h", PAD_SHAPES)
def test_pad_gru_operands_shapes_and_zeros(b, t, e, h):
    x, _, w_ih, b_ih, w_hh, b_hh = map(torch.from_numpy,
                                       _inputs(0, b, t, e, h))
    xp, wp, bip, whp, bhp = K.pad_gru_operands(x, w_ih, b_ih, w_hh, b_hh)
    ep, hp = -(-e // 32) * 32, -(-h // 32) * 32
    assert xp.shape == (b, t, ep) and wp.shape == (ep, 3 * hp)
    assert bip.shape == bhp.shape == (3 * hp,)
    assert whp.shape == (hp, 3 * hp)
    for p in (xp, wp, bip, whp, bhp):
        assert p.is_contiguous() and p.data_ptr() % 16 == 0
    # the originals sit in the first E rows / H columns of each gate block
    assert torch.equal(xp[..., :e], x) and not xp[..., e:].any()
    assert torch.equal(wp[:e].reshape(e, 3, hp)[..., :h],
                       w_ih.reshape(e, 3, h))
    assert torch.equal(whp[:h].reshape(h, 3, hp)[..., :h],
                       w_hh.reshape(h, 3, h))
    for bp, bias in ((bip, b_ih), (bhp, b_hh)):
        assert torch.equal(bp.reshape(3, hp)[:, :h], bias.reshape(3, h))
        assert int((bp != 0).sum()) == int((bias != 0).sum())
    # everything else is zero
    assert int((wp != 0).sum()) == int((w_ih != 0).sum())
    assert int((whp != 0).sum()) == int((w_hh != 0).sum())
    # cutting the gate blocks back round-trips
    assert torch.equal(L._cut_gates(wp[:e], h, hp, 3), w_ih)
    assert torch.equal(L._cut_gates(bip, h, hp, 3), b_ih)
    assert torch.equal(L._cut_gates(whp[:h], h, hp, 3), w_hh)


def test_pad_gru_operands_leaves_aligned_operands_alone():
    ops = list(map(torch.from_numpy, _inputs(0, 4, 3, 64, 32)))
    del ops[1]
    out = K.pad_gru_operands(*ops)
    for got, t in zip(out, ops):
        assert got.data_ptr() == t.data_ptr() and got.shape == t.shape


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b,t,e,h", PAD_SHAPES[:3])
def test_padding_leaves_the_plain_versions_unchanged(b, t, e, h, reverse):
    """The padded GRU's first H units equal the original's and a padded
    unit stays exactly 0: what the wrappers do on the card, through the
    plain versions."""
    x, mask, *w = map(torch.from_numpy, _inputs(1, b, t, e, h))
    out, hb = K.gru_fused_res_reference(x, mask, *w, reverse, 2)
    xp, *wp = K.pad_gru_operands(x, *w)
    out_p, hb_p = K.gru_fused_res_reference(xp, mask, *wp, reverse, 2)
    assert not out_p[..., h:].any() and not hb_p[..., h:].any()
    assert _max_err(out_p[..., :h], out) <= 1e-6
    assert _max_err(hb_p[..., :h], hb) <= 1e-6


@pytest.mark.parametrize("e,h", [(64, 32), (256, 128), (32, 96)])
def test_staged_gru_weights_are_the_ring_layout(e, h):
    """One [E + H, 3H + 8] matrix, W_ih over W_hh, 8 zero columns a row: a
    slab of ks rows is ks * (6H + 16) contiguous bytes, the staged rows'
    stride in shared memory."""
    _, _, w_ih, _, w_hh, _ = map(torch.from_numpy, _inputs(7, 2, 1, e, h))
    staged = L.stage_lstm_weights(w_ih.bfloat16(), w_hh.bfloat16())
    assert staged.shape == (e + h, 3 * h + 8) and staged.is_contiguous()
    assert staged.dtype == BF16 and staged.data_ptr() % 16 == 0
    assert staged.stride(0) * staged.element_size() == 6 * h + 16
    assert torch.equal(staged[:e, :3 * h], w_ih.bfloat16())
    assert torch.equal(staged[e:, :3 * h], w_hh.bfloat16())
    assert not staged[:, 3 * h:].any()


# -- the slab algorithm at the tiles' ragged shapes, against JAX ---------------

def slab_forward(x, mask, w_ih, b_ih, w_hh, b_hh, reverse, time_chunk, ks):
    """Kernels 7 and 8's tile algorithm in plain PyTorch (see the module
    note): ``(out [B, T, H]`` in x's dtype, ``hb`` float32 ``[ceil(T / tc),
    B, H])``."""
    B, T, _ = x.shape
    H = w_hh.shape[0]
    x, w_ih, b_ih, w_hh, b_hh = K.pad_gru_operands(x, w_ih, b_ih, w_hh, b_hh)
    ep, hp = x.shape[-1], w_hh.shape[0]
    staged = L.stage_lstm_weights(w_ih, w_hh).float()
    bias = torch.cat([b_ih[:2 * hp].float() + b_hh[:2 * hp].float(),
                      b_ih[2 * hp:].float(), b_hh[2 * hp:].float()])
    tc = L.chunk_len(T, time_chunk)
    h = torch.zeros((B, hp))
    h_tile = torch.zeros((B, hp))   # h as the next product reads it
    out = torch.zeros((B, T, hp))
    hb = torch.zeros((-(-T // tc), B, hp))
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        if L._first_in_chunk(t, T, tc, reverse):
            hb[t // tc] = h
        acc = bias.reshape(4, 1, hp).repeat(1, B, 1)   # r, z, xn, hn
        for k0 in range(0, ep + hp, ks):
            x_slab = k0 < ep
            assert (k0 + ks <= ep) is x_slab   # all x rows or all h rows
            a = (x[:, t, k0:k0 + ks].float() if x_slab
                 else h_tile[:, k0 - ep:k0 - ep + ks])
            slab = staged[k0:k0 + ks]
            acc[0] += a @ slab[:, :hp]
            acc[1] += a @ slab[:, hp:2 * hp]
            acc[2 if x_slab else 3] += a @ slab[:, 2 * hp:3 * hp]
        r, z = torch.sigmoid(acc[0]), torch.sigmoid(acc[1])
        n = torch.tanh(acc[2] + r * acc[3])
        h_new = (1.0 - z) * n + z * h
        m = mask[:, t, None]
        h = torch.where(m, h_new, h)
        h_tile = torch.where(m, h_new.to(x.dtype).float(), h_tile)
        out[:, t] = torch.where(m, h_new, torch.zeros(()))
    return out[..., :H].to(x.dtype), hb[..., :H]


def _jax_boundaries(jx, tc, reverse):
    """hb from the JAX scan: the final state over the steps processed
    before each chunk."""
    x, mask, w_ih, b_ih, w_hh, b_hh = jx
    xp = x @ w_ih + b_ih
    T = x.shape[1]
    h0 = jnp.zeros((x.shape[0], w_hh.shape[0]), jnp.float32)
    hb = []
    for c in range(-(-T // tc)):
        steps = slice((c + 1) * tc, T) if reverse else slice(0, c * tc)
        if xp[:, steps].shape[1] == 0:
            hb.append(h0)
        else:
            hb.append(jax_gru_scan(xp[:, steps], mask[:, steps], w_hh, b_hh,
                                   h0, reverse=reverse)[1])
    return np.stack([np.asarray(v) for v in hb])


# (rows, T, E, H, time chunk): rows off the 64-row block (1, 33), E and H
# off the tiles' multiple (E = 300 H = 100, H = 8), T = 1, T = 17, H = 256
RAGGED = [(1, 5, 24, 128, 6), (33, 7, 40, 128, 6), (9, 6, 300, 100, 4),
          (9, 7, 20, 8, 3), (12, 1, 24, 128, 6), (10, 17, 24, 16, 6),
          (9, 5, 16, 256, 2)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b,t,e,h,tc", RAGGED)
def test_slab_algorithm_matches_jax_at_ragged_shapes(b, t, e, h, tc,
                                                     reverse):
    arrays = _inputs(2, b, t, e, h)
    tx = list(map(torch.from_numpy, arrays))
    jx = list(map(jnp.asarray, arrays))
    jtc = L.chunk_len(t, tc)
    if jax_gru_fused_supported(e, h, b):
        # the Pallas kernels, interpret mode, their own chunk length
        out_j, hb_j = _gru_fused_res_impl(*jx, reverse=reverse, block_b=16,
                                          time_chunk=jtc, interpret=True)
        fwd_j = _gru_fused_impl(*jx, reverse=reverse, block_b=16,
                                time_chunk=jtc, interpret=True)
        assert _max_err(np.asarray(fwd_j), out_j) == 0.0
        hb_j = np.asarray(hb_j)[:, :b]
    else:
        xp = jx[0] @ jx[2] + jx[3]
        out_j = jax_gru_scan(xp, jx[1], jx[4], jx[5],
                             jnp.zeros((b, h), jnp.float32),
                             reverse=reverse)[0]
        hb_j = _jax_boundaries(jx, jtc, reverse)
    for ks in (32, 16):
        out, hb = slab_forward(*tx, reverse, tc, ks)
        assert out.shape == (b, t, h) and hb.shape == hb_j.shape
        assert not out[~tx[1]].any()          # masked outputs exactly 0
        assert _max_err(out, out_j) <= TOL
        assert _max_err(hb, hb_j) <= TOL
    # the plain version the card's kernels are held to agrees as well
    out_p, hb_p = K.gru_fused_res(*tx, reverse=reverse, time_chunk=tc,
                                  device="cpu")
    assert _max_err(out_p, out) <= TOL and _max_err(hb_p, hb) <= TOL


def test_jax_gate_splits_the_ragged_shapes_as_the_docstring_says():
    kernel = [s for s in RAGGED if jax_gru_fused_supported(s[2], s[3], s[0])]
    assert [s[:4] for s in kernel] == [(33, 7, 40, 128), (12, 1, 24, 128),
                                       (9, 5, 16, 256)]
