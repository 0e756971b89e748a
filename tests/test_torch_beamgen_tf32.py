"""The float32 generator kernels on split-TF32 tensor cores (kernels 2 and
3 on float32 x, ``csrc/beamgen_common.cuh`` namespace tc) and the
selection every mode runs, emulated on the CPU.

- **The score tile.**  ``tests/test_torch_beamgen_tiles.py``'s emulation
  of the kernels (row blocks, vocab splits, online logsumexp, running
  top-kc, the warp merge) with each 64 x 128 score tile computed as the
  float32 tiles compute it: ``split_mm`` (``tests/test_torch_tf32_tiles``:
  each operand split into hi = tf32(v) and lo = v - hi, per k step of 8 the
  products lo*hi, hi*lo, hi*hi in that order), a fresh accumulator for
  each 32-row k-slab added into the tile's sum (``promote=4``); an int8
  table is exact in TF32 (its lo part 0).  Held to the JAX package's
  ``generator_topk_lse`` in Pallas interpret mode and to its reference at
  float32, at E = 100, 256 and 497 (past float32 kernel 2's whole x tile
  of 496), kc = 2, 6, 33 and 128, float and int8 tables, ``prune`` on and
  off.  Integer data (every product and sum exact in split TF32, integers
  up to 2^11 splitting with lo = 0): vals and idx exact, lse within 1e-6
  relative.  Random data: an index may differ from JAX's only at a near
  tie (the reference's neighbouring values within 1e-5 of the row's
  largest), where it must score what JAX has there; no index repeats;
  vals within 1e-5 of the row's largest, lse within 1e-5 relative --
  chip_smoke.py's ``hold``.
- **The selection.**  ``insert_gains`` (every mode: only a tile's columns
  that beat the row's running kc-th entry are inserted, first lane first,
  each lane its columns l, l + 32, l + 64, l + 96 in turn), emulated step
  by step, against the kc exact argmax passes over [tile | buffer] that it
  replaced: the same vals and idx over a run of tiles at kc 1, 6, 32, 33,
  64, 127 and 128, on integer data full of ties and on random data.
"""

import numpy as np
import pytest
import torch
from test_torch_beamgen_tiles import (
    _beats,
    _data,
    _insert,
    _jax,
    _top,
    tiles_forward,
)
from test_torch_tf32_tiles import split_mm

from context_attentive_ir_tpu_torch.ops.kernels import beamgen as K

NO_INDEX = 2 ** 31 - 1
SLAB_STEPS = 4     # k steps of 8 in one 32-row slab: one fresh accumulator
ROWS, VOCAB = 53, 999   # off the 64-row block, a ragged last tile
ES = (100, 256, 497)
KCS = (2, 6, 33, 128)
TIE = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of small tensor ops: one intra-op thread beside the
    other test workers (as ``test_torch_beamgen_tiles``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32_tile(xb, tile_t):
    """A score tile as the float32 kernels compute it."""
    return split_mm(xb, tile_t, promote=SLAB_STEPS)


def _logits(x, t, scale):
    """The exact logits in float64 (the int8 mode's scale after the dot)."""
    out = x.astype(np.float64) @ t.astype(np.float64)
    return out if scale is None else out * scale[None, :].astype(np.float64)


def _near_ties(rv, kc):
    """[R, kc]: position p of the top-(kc+1) values ``rv`` lies within
    TIE of the row's largest |value| of its neighbour p-1 or p+1
    (chip_smoke.py's ``near_tie_positions``)."""
    scale = np.abs(rv).max(-1, keepdims=True)
    tie = np.abs(rv[:, :-1] - rv[:, 1:]) <= TIE * scale
    covered = tie.copy()
    covered[:, 1:] |= tie[:, :kc - 1]
    return covered


def _hold(got, refs, logits, kc, integer):
    v, i, lse = got
    if integer:
        for rv, ri, rlse in refs:
            np.testing.assert_array_equal(v, rv[:, :kc])
            np.testing.assert_array_equal(i, ri[:, :kc])
            np.testing.assert_allclose(lse, rlse, rtol=1e-6, atol=0)
        return
    exact = -np.sort(-logits, axis=-1)[:, :kc + 1]
    top = np.abs(exact).max(-1, keepdims=True)
    tie = _near_ties(exact, kc)
    scored = np.take_along_axis(logits, i.astype(np.int64), -1)
    assert not (np.diff(np.sort(i, -1), axis=-1) == 0).any()
    for rv, ri, rlse in refs:
        rv, ri = rv[:, :kc], ri[:, :kc]
        assert not ((i != ri) & ~tie).any()
        assert (np.abs(scored - rv) <= TIE * top).all()
        assert (np.abs(v - rv) <= TIE * top).all()
        np.testing.assert_allclose(lse, rlse, rtol=1e-5, atol=0)


_JAX_CACHE = {}


@pytest.mark.parametrize("data", ["integer", "random"])
@pytest.mark.parametrize("mode", ["float", "int8"])
@pytest.mark.parametrize("e", ES)
def test_tf32_tiles_match_jax(e, mode, data):
    integer = data == "integer"
    int8 = mode == "int8"
    key = (e, int8, integer)
    if key not in _JAX_CACHE:
        x, t, scale = _data(31 + e + integer, ROWS, VOCAB, integer, int8, e=e)
        _JAX_CACHE[key] = (x, t, scale, _jax(x, t, scale, K.MAX_KC))
    x, t, scale, refs = _JAX_CACHE[key]
    assert K.beamgen_streams_x(e, torch.float32) is (e > 496)
    logits = _logits(x, t, scale)
    s = None if scale is None else torch.from_numpy(scale)
    for kc in KCS:
        outs = [tiles_forward(torch.from_numpy(x), torch.from_numpy(t), kc,
                              s, prune=prune, slots=3, mm=tf32_tile)
                for prune in (False, True)]
        for a, b in zip(*outs):   # prune on and off: the same bits
            np.testing.assert_array_equal(a, b)
        _hold(outs[0], refs, logits, kc, integer)


def test_tf32_tile_is_close_to_the_f32_product():
    """The emulated split product stays within split TF32's bound of the
    float64 product at the serving width: 5 * 2^-22 of sum |a||b| a term
    plus f32 accumulation (E * 2^-24 of it)."""
    rng = np.random.RandomState(5)
    x = (rng.normal(size=(64, 256)) * 0.5).astype(np.float32)
    t = (rng.normal(size=(256, 128)) * 0.5).astype(np.float32)
    got = tf32_tile(torch.from_numpy(x), torch.from_numpy(t)).double()
    want = x.astype(np.float64) @ t.astype(np.float64)
    mag = np.abs(x).astype(np.float64) @ np.abs(t).astype(np.float64)
    bound = (5 * 2.0 ** -22 + 256 * 2.0 ** -24) * mag
    assert (np.abs(got.numpy() - want) <= bound).all()
    # integer data: exact (lo = 0)
    xi = rng.randint(-3, 4, size=(64, 256)).astype(np.float32)
    ti = rng.randint(-3, 4, size=(256, 128)).astype(np.float32)
    assert torch.equal(tf32_tile(torch.from_numpy(xi), torch.from_numpy(ti)),
                       torch.from_numpy(xi @ ti))


# -- the selection -----------------------------------------------------------


def _lanes(tile_v, tile_i, ok):
    """A tile's [R, 128] columns as the lanes hold them: [R, 32, 4], lane l
    column c = tile column l + 32 c."""
    r = tile_v.shape[0]
    return (tile_v.reshape(r, 4, 32).transpose(0, 2, 1),
            tile_i.reshape(r, 4, 32).transpose(0, 2, 1),
            ok.reshape(4, 32).T)


def insert_select(tile_v, tile_i, ok, buf_v, buf_i):
    """``insert_gains`` on every row (numpy, in place on the buffers):
    while some lane holds a column that beats the row's running kc-th
    entry and was not inserted yet, the first such lane's first such
    column is inserted (``_insert``: ``insert_entry``)."""
    v, i, okl = _lanes(tile_v, tile_i, ok)
    r = v.shape[0]
    done = np.zeros(v.shape, bool)
    rows = np.arange(r)
    while True:
        kth_v, kth_i = buf_v[:, -1:, None], buf_i[:, -1:, None]
        cand = okl[None] & ~done & _beats(v, i, kth_v, kth_i)
        lanes = cand.any(-1)                       # [R, 32]
        live = lanes.any(-1)
        if not live.any():
            return
        src = lanes.argmax(-1)                     # the first lane
        first = cand[rows, src].argmax(-1)         # its first column
        cv = v[rows, src, first]
        ci = i[rows, src, first]
        done[rows[live], src[live], first[live]] = True
        _insert(buf_v, buf_i, cv, ci, live)


def passes_select(tile_v, tile_i, ok, buf_v, buf_i):
    """The selection it replaced: kc exact argmax passes over [tile |
    buffer], pass p's winner (by ``beats``; of equal candidates the first
    in lane order, then the buffer) entry p of the new buffer."""
    kc = buf_v.shape[1]
    v, i, okl = _lanes(tile_v, tile_i, ok)
    r = v.shape[0]
    cv = np.concatenate([v.reshape(r, -1), buf_v], -1)
    ci = np.concatenate([i.reshape(r, -1), buf_i], -1)
    avail = np.concatenate([np.broadcast_to(okl.reshape(-1), (r, 128)),
                            np.ones((r, kc), bool)], -1).copy()
    new_v = np.full((r, kc), -np.inf, np.float32)
    new_i = np.full((r, kc), NO_INDEX, np.int64)
    rows = np.arange(r)
    for p in range(kc):
        val = np.where(avail, cv, -np.inf)
        best = val.max(-1, keepdims=True)
        idx = np.where(avail & (val == best), ci, NO_INDEX)
        win_i = idx.min(-1, keepdims=True)
        owner = (avail & (val == best) & (ci == win_i)).argmax(-1)
        any_avail = avail.any(-1)
        new_v[:, p] = np.where(any_avail, cv[rows, owner], -np.inf)
        new_i[:, p] = np.where(any_avail, ci[rows, owner], NO_INDEX)
        avail[rows[any_avail], owner[any_avail]] = False
    buf_v[:], buf_i[:] = new_v, new_i


@pytest.mark.parametrize("data", ["integer", "random"])
@pytest.mark.parametrize("kc", [1, 6, 32, 33, 64, 127, 128])
def test_insertion_selects_what_the_passes_select(kc, data):
    """Over a run of tiles (V = 1,000: a ragged last tile), the insertion
    and the passes leave the same running top-kc after every tile, and
    the last one is the exact top-kc of the scores seen (ties to the lower
    index)."""
    rng = np.random.RandomState(kc + (data == "integer"))
    r, v = 40, 1000
    if data == "integer":   # a handful of values: ties everywhere
        scores = rng.randint(-3, 4, size=(r, v)).astype(np.float32)
    else:
        scores = rng.normal(size=(r, v)).astype(np.float32)
    bufs = [(np.full((r, kc), -np.inf, np.float32),
             np.full((r, kc), NO_INDEX, np.int64)) for _ in range(2)]
    for tile in range(-(-v // K.TILE)):
        cols = np.arange(tile * K.TILE, (tile + 1) * K.TILE)
        ok = cols < v
        tv = np.where(ok, scores[:, np.minimum(cols, v - 1)], -np.inf)
        tv = tv.astype(np.float32)
        ti = np.broadcast_to(np.where(ok, cols, NO_INDEX), (r, K.TILE))
        insert_select(tv, ti, ok, *bufs[0])
        passes_select(tv, ti, ok, *bufs[1])
        np.testing.assert_array_equal(bufs[0][0], bufs[1][0])
        np.testing.assert_array_equal(bufs[0][1], bufs[1][1])
    want_v, want_i = _top(torch.from_numpy(scores),
                          torch.arange(v).expand(r, v), kc)
    np.testing.assert_array_equal(bufs[0][0], want_v.numpy())
    np.testing.assert_array_equal(bufs[0][1], want_i.numpy())

