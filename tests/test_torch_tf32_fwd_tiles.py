"""The split-TF32 tiles of float32 kernels 1, 4 (LSTM) and 7, 8 (GRU)
(``csrc/lstm_fwd.cu``, ``csrc/gru_fwd.cu`` on ``csrc/lstm_mma.cuh``'s
tiles), on the CPU.

``lstm_fwd_tiles`` / ``gru_fwd_tiles`` emulate the forwards as the tiles
compute them: the operands zero-padded as the wrappers pad them (E to 32,
H to ``f32_tile_hidden``), each rank's staged weights
(``stage_lstm_weights(..., ranks)``), per step ``[x_t | h] @ W`` in split
TF32 from the bias on (``split_mm``: per k step of 8 the products lo*hi,
hi*lo, hi*hi in that order; the GRU's n gate as its x and h slabs' slots
xn and hn apart), the cell in f32, every rank reading the whole h; the
carried state (kernel 4's hb, cb; kernel 8's hb) before each time chunk in
processing order.  They are held to the JAX package's
``_lstm_fused_res_impl`` / ``_gru_fused_res_impl`` (Pallas interpret mode):
outputs and boundaries within 2e-5 times the largest magnitude of the JAX
output (split TF32 keeps about 22 of float32's 24 bits, and its sums run
in another order), at H = 32, 64 and 136 (padded to 160), an odd E, one
block and a cluster of 2, both directions.  The rows and h tiles a block
or rank takes (``f32_forward_tiles``) change no value: a row's sums are
the same whatever block holds it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gru_bwd_tiles import _inputs as _gru_inputs
from test_torch_lstm_tiles import _close_rel
from test_torch_lstm_tiles import _inputs as _lstm_inputs
from test_torch_tf32_tiles import _pad, _rank_weights, split_mm

from context_attentive_ir_tpu.ops.pallas.gru import _gru_fused_res_impl
from context_attentive_ir_tpu.ops.pallas.lstm import _lstm_fused_res_impl
from context_attentive_ir_tpu_torch.ops.kernels import gru as G
from context_attentive_ir_tpu_torch.ops.kernels import lstm as K


def _steps(t_count, reverse):
    return range(t_count - 1, -1, -1) if reverse else range(t_count)


def lstm_fwd_tiles(x, mask, w_ih, b, w_hh, ranks, reverse=False,
                   time_chunk=2):
    """Kernels 1 and 4 in float32 as the tiles compute them, on padded
    operands: ranks of Hc = H / ranks units, each from its own staged
    weights and the whole h.  Returns (out, hb, cb)."""
    B, T, _ = x.shape
    H = w_hh.shape[0]
    hc = H // ranks
    tc = K.chunk_len(T, time_chunk)
    w = _rank_weights(w_ih, w_hh, ranks, 4)
    bias = b.reshape(4, ranks, hc).permute(1, 0, 2).reshape(ranks, 4 * hc)
    h, c = torch.zeros((B, H)), torch.zeros((B, H))
    out = torch.zeros((B, T, H))
    hb = torch.zeros((-(-T // tc), B, H))
    cb = torch.zeros_like(hb)
    for t in _steps(T, reverse):
        if K._first_in_chunk(t, T, tc, reverse):
            hb[t // tc], cb[t // tc] = h, c
        m = mask[:, t, None]
        xh = torch.cat([x[:, t], h], 1)
        h_next, c_next = h.clone(), c.clone()
        for r in range(ranks):
            u = slice(r * hc, (r + 1) * hc)
            acc = split_mm(xh, w[r], bias[r].expand(B, -1))
            i, f, g, o = acc.reshape(B, 4, hc).unbind(1)
            c_new = (torch.sigmoid(f) * c[:, u]
                     + torch.sigmoid(i) * torch.tanh(g))
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            h_next[:, u] = torch.where(m, h_new, h[:, u])
            c_next[:, u] = torch.where(m, c_new, c[:, u])
            out[:, t, u] = h_new * m
        h, c = h_next, c_next
    return out, hb, cb


def gru_fwd_tiles(x, mask, w_ih, b_ih, w_hh, b_hh, ranks, reverse=False,
                  time_chunk=2):
    """Kernels 7 and 8 in float32 as the tiles compute them, on padded
    operands: slots r, z from both slabs (from b_ih + b_hh), xn from the x
    slabs (b_ih_n), hn from the h slabs (b_hh_n); ranks of Hc units, each
    from its own staged weights and the whole h.  Returns (out, hb)."""
    B, T, E = x.shape
    H = w_hh.shape[0]
    hc = H // ranks
    tc = K.chunk_len(T, time_chunk)
    w = _rank_weights(w_ih, w_hh, ranks, 3)

    def of_rank(v, r):
        return v.reshape(3, ranks, hc)[:, r].reshape(3 * hc)

    h = torch.zeros((B, H))
    out = torch.zeros((B, T, H))
    hb = torch.zeros((-(-T // tc), B, H))
    for t in _steps(T, reverse):
        if K._first_in_chunk(t, T, tc, reverse):
            hb[t // tc] = h
        m = mask[:, t, None]
        xh = torch.cat([x[:, t], h], 1)
        h_next = h.clone()
        for r in range(ranks):
            u = slice(r * hc, (r + 1) * hc)
            bi, bh = of_rank(b_ih, r), of_rank(b_hh, r)
            rz = split_mm(xh, w[r, :, :2 * hc],
                          (bi[:2 * hc] + bh[:2 * hc]).expand(B, -1))
            xn = split_mm(x[:, t], w[r, :E, 2 * hc:],
                          bi[2 * hc:].expand(B, -1))
            hn = split_mm(h, w[r, E:, 2 * hc:], bh[2 * hc:].expand(B, -1))
            rg, zg = torch.sigmoid(rz).split(hc, 1)
            h_new = (1.0 - zg) * torch.tanh(xn + rg * hn) + zg * h[:, u]
            h_next[:, u] = torch.where(m, h_new, h[:, u])
            out[:, t, u] = h_new * m
        h = h_next
    return out, hb


# (rows, T, E, H, time chunk, ranks, reverse): one block at H = 32 with an
# odd E and at 64, the unit split of a cluster of 2 at 64, the card's 2
# ranks at 136 (padded to 160) in both directions
CASES = [(16, 3, 37, 32, 2, 1, False), (16, 3, 64, 64, 2, 1, True),
         (16, 3, 64, 64, 2, 2, False), (12, 4, 40, 136, 2, 2, False),
         (12, 4, 40, 136, 2, 2, True)]


def _padded(e, h, ranks):
    """(Ep, Hp) the wrappers run (E, H) at: the card's ranks, or a cluster
    of ``ranks`` at a width one block holds (H to 16 ranks)."""
    ep, hp, c = _pad(1, 1, e, h, 4)
    return ep, hp if ranks == c else K._round_up(h, max(32, 16 * ranks))


@pytest.mark.parametrize("b,t,e,h,tc,ranks,reverse", CASES)
def test_lstm_forward_tiles_match_jax(b, t, e, h, tc, ranks, reverse):
    x, mask, w_ih, bias, w_hh, _ = _lstm_inputs(31, b, t, e, h)
    ref = _lstm_fused_res_impl(*map(jnp.asarray, (x, mask, w_ih, bias,
                                                  w_hh)),
                               reverse=reverse, block_b=16, time_chunk=tc,
                               interpret=True)
    ep, hp = _padded(e, h, ranks)
    tx, tw, tb, th = K.pad_lstm_operands(
        *map(torch.from_numpy, (x, w_ih, bias, w_hh)), hp)
    assert th.shape[0] == hp and tx.shape[-1] == ep
    out, hb, cb = lstm_fwd_tiles(tx, torch.from_numpy(mask), tw, tb, th,
                                 ranks, reverse, tc)
    assert not out[..., h:].any() and not hb[..., h:].any()
    for got, want in ((out, ref[0]), (hb, np.asarray(ref[1])[:, :b]),
                      (cb, np.asarray(ref[2])[:, :b])):
        got = got[..., :h]
        assert got.shape == np.shape(want)
        _close_rel(got, np.asarray(want))


@pytest.mark.parametrize("b,t,e,h,tc,ranks,reverse", CASES)
def test_gru_forward_tiles_match_jax(b, t, e, h, tc, ranks, reverse):
    args, _ = _gru_inputs(33, b, t, e, h)
    ref = _gru_fused_res_impl(*map(jnp.asarray, args), reverse=reverse,
                              block_b=16, time_chunk=tc, interpret=True)
    ep, hp = _padded(e, h, ranks)
    x, mask, w_ih, b_ih, w_hh, b_hh = map(torch.from_numpy, args)
    tx, tw_ih, tb_ih, tw_hh, tb_hh = G.pad_gru_operands(x, w_ih, b_ih, w_hh,
                                                        b_hh, hp)
    assert tw_hh.shape[0] == hp and tx.shape[-1] == ep
    out, hb = gru_fwd_tiles(tx, mask, tw_ih, tb_ih, tw_hh, tb_hh, ranks,
                            reverse, tc)
    # a padded unit (r = z = 1/2, n = 0) stays at exactly 0
    assert not out[..., h:].any() and not hb[..., h:].any()
    for got, want in ((out, ref[0]), (hb, np.asarray(ref[1])[:, :b])):
        got = got[..., :h]
        assert got.shape == np.shape(want)
        _close_rel(got, np.asarray(want))


@pytest.mark.parametrize("h,gates,rows,tiles", [
    (32, 4, 64, 1), (128, 4, 64, 1), (128, 3, 64, 1), (160, 4, 64, 1),
    (160, 3, 64, 2), (224, 4, 64, 2), (256, 4, 64, 1), (256, 3, 64, 2),
    (512, 4, 64, 1), (640, 3, 64, 1), (768, 4, 32, 1), (1024, 4, 32, 1),
    (1024, 3, 32, 1)])
def test_forward_rows_and_h_tiles(h, gates, rows, tiles):
    """The float32 forwards' blocks (``f32_forward_tiles``, the rule of
    ``f32_fwd_smem`` in ``csrc/lstm_mma.cuh``): 64 rows in one block to
    H = 128 and in a rank of ``f32_cluster``'s clusters where one 64-row h
    tile fits (to 640), else 32; two h tiles where they fit at a slab as
    deep as one tile allows, else one -- past 640 no rank holds two 32-row
    tiles of f32 h (2 x 32 x 4,112 bytes at 1,024)."""
    assert K.f32_forward_tiles(h, gates) == (rows, tiles)
    c = K.f32_cluster(h)
    n_bytes = K.tile_smem_bytes(32, h, False, gates, rows, ranks=c,
                                dtype=torch.float32, h_tiles=tiles)
    assert 0 < n_bytes <= K.SMEM_LIMIT
    if rows == 32:
        assert K.tile_smem_bytes(32, h, False, gates, 64, ranks=c,
                                 dtype=torch.float32, h_tiles=1) == 0
        assert K.tile_smem_bytes(32, h, False, gates, 32, ranks=c,
                                 dtype=torch.float32, h_tiles=2) == 0


@pytest.mark.parametrize("h,rows,want", [
    (128, 16000, (64, 1)), (128, 5000, (32, 1)), (128, 1280, (16, 1)),
    (128, 64, (16, 1)), (512, 1280, (32, 1)), (512, 64, (16, 2)),
    (1024, 1280, (32, 1)), (1024, 64, (16, 1))])
def test_forward_rows_follow_the_row_count(h, rows, want):
    """Fewer rows a block where the row blocks, times the ranks, would
    leave some of the card's 132 SMs idle (the query encoder's 320 rows,
    the recommenders' 64): the most of 64, 32, 16 rows that fill the card,
    else 16 -- a row's sums are the same in any block."""
    c = K.f32_cluster(h)
    assert K.f32_forward_tiles(h, 4, rows) == want
    m = want[0]
    assert m == 16 or -(-rows // m) * c >= K.FILL_BLOCKS
    assert m == K.f32_forward_tiles(h)[0] or (
        -(-rows // (2 * m)) * c < K.FILL_BLOCKS)
