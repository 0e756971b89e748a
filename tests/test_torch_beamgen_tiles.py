"""What surrounds the generator kernels (kernel 2 in its float, pruned and
int8 modes, kernel 3; ``ops/kernels/beamgen.py``) on the host, and a
plain-PyTorch emulation of their algorithm held to the JAX package.

The emulation follows ``csrc/beamgen.cu`` and ``csrc/beamgen_common.cuh``:
row blocks of 64 rows; the vocab cut into 128-column tiles and split into
runs of tiles (``vocab_splits``); per (row block, split) an online
logsumexp and a running top-kc over the tiles in ascending order, the
selection of a tile skipped for a row when ``prune`` finds no column of
the tile beating the row's kc-th entry; a tile's scores summed over x's
k-slabs in ascending k where the kernels stream x (``slab``); an int8
table widened to bf16 (exact) before the dot and the scale applied to the
f32 score after it; the table read through its padded row stride with
columns past the logical V masked; the running top-kc held as the
kernels hold it, entry p on lane p % 32 in slot p // 32 (``slots``
registers a lane); then the merge of the splits per row in split order
(the lse merge ``m + log(sum_s s_s * exp(m_s - m))``; the top-kc by the
kernel's tie rule, larger value, else lower index, as the warp merge
runs it: each split's sorted entries inserted one by one until one no
longer beats the running kc-th).

JAX side: ``generator_topk_lse`` in Pallas interpret mode and its XLA
reference.  Tolerance: on integer-valued data vals and idx bit-exact and
lse within 1e-6 relative (the online logsumexp sums the same exact
exponentials in another order); on random data idx exact and vals / lse
within 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from context_attentive_ir_tpu.ops.layers import (
    quantize_embedding_table as jax_quantize,
)
from context_attentive_ir_tpu.ops.pallas.beamgen import (
    generator_topk_lse as jax_kernel,
)
from context_attentive_ir_tpu.ops.pallas.beamgen import (
    generator_topk_lse_reference as jax_reference,
)
from context_attentive_ir_tpu_torch.config import default_config
from context_attentive_ir_tpu_torch.decode import fused_generator_table
from context_attentive_ir_tpu_torch.decode.fusedgen import _shortlisted
from context_attentive_ir_tpu_torch.models.multitask.cars import CARS
from context_attentive_ir_tpu_torch.ops.kernels import beamgen as K

E = 40
NO_INDEX = 2 ** 31 - 1
BF16, F32 = torch.bfloat16, torch.float32


def _data(seed, r, v, integer=False, int8=False, front=False, e=E):
    """x [r, e] f32 and table_t [e, v] (int8 with its scale [v] when
    ``int8``: integer data small integers with power-of-two scales, random
    data through the JAX package's quantizer); ``front`` puts every row's
    top scores in the first 128 columns, so ``prune`` skips later tiles."""
    rng = np.random.RandomState(seed)
    if integer:
        x = rng.randint(-3, 4, size=(r, e)).astype(np.float32)
        t = rng.randint(-3, 4, size=(e, v)).astype(np.float32)
    else:
        x = (rng.normal(size=(r, e)) * 0.5).astype(np.float32)
        t = (rng.normal(size=(e, v)) * 0.5).astype(np.float32)
    if front:
        x = np.abs(x) + 0.1
        t[:, :128] = np.abs(t[:, :128]) + 1.0
        t[:, 128:] = -np.abs(t[:, 128:])
    if not int8:
        return x, t, None
    if integer:
        q = t.T.astype(np.int8)
        scale = (2.0 ** rng.randint(-3, 3, size=(v, 1))).astype(np.float32)
    else:
        q, scale = jax_quantize(t.T)
    return x, np.ascontiguousarray(q.T), scale.reshape(-1)


def _jax(x, t, scale, kc, prune=False, kernel=True):
    """The JAX kernel's outputs (Pallas interpret mode) and its
    reference's, or the reference's alone."""
    s = None if scale is None else jnp.asarray(scale)
    outs = [jax_reference(jnp.asarray(x), jnp.asarray(t), kc, scale=s)]
    if kernel:
        outs.append(jax_kernel(jnp.asarray(x), jnp.asarray(t), kc,
                               block_r=64, block_v=512, interpret=True,
                               scale=s, prune=prune))
    return [tuple(np.asarray(a) for a in out) for out in outs]


def _top(vals, idx, kc):
    """The kc best of each row's candidates by the kernels' rule: larger
    value, else lower index (a stable sort by index, then by value)."""
    order = torch.argsort(idx, dim=-1, stable=True)
    vals, idx = vals.gather(-1, order), idx.gather(-1, order)
    order = torch.argsort(vals, dim=-1, descending=True, stable=True)
    return vals.gather(-1, order)[:, :kc], idx.gather(-1, order)[:, :kc]


def _beats(av, ai, bv, bi):
    """The kernels' order: a larger value, or an equal one at a lower
    index."""
    return (av > bv) | ((av == bv) & (ai < bi))


def _insert(buf_v, buf_i, cv, ci, rows):
    """``insert_entry`` for the rows ``rows`` (numpy, in place): (cv, ci),
    which beats the row's kc-th entry, lands after the entries that beat
    it; every later entry p takes entry p - 1's place (lane p % 32 - 1 of
    slot p // 32, or lane 31 of the slot before) and the kc-th falls out.
    Buffers are [rows, kc] in entry order p = 32 * slot + lane."""
    bv, bi = buf_v[rows], buf_i[rows]
    cv, ci = cv[rows, None], ci[rows, None]
    pos = _beats(bv, bi, cv, ci).sum(-1, keepdims=True)
    p = np.arange(bv.shape[1])
    up_v = np.concatenate([bv[:, :1], bv[:, :-1]], -1)
    up_i = np.concatenate([bi[:, :1], bi[:, :-1]], -1)
    buf_v[rows] = np.where(p < pos, bv, np.where(p == pos, cv, up_v))
    buf_i[rows] = np.where(p < pos, bi, np.where(p == pos, ci, up_i))


def _warp_merge(part_v, part_i, kc):
    """The warp merge: each split's sorted partial entered entry
    by entry while the entry beats the running kc-th (a row stops at the
    first that does not: the rest of that split cannot enter).  In numpy:
    thousands of row-vector steps, each too small for torch's threads."""
    part_v, part_i = part_v.numpy(), part_i.numpy()
    r = part_v.shape[1]
    vals = np.full((r, kc), -np.inf, np.float32)
    idx = np.full((r, kc), NO_INDEX, np.int64)
    for s in range(part_v.shape[0]):
        live = np.ones(r, bool)
        for q in range(kc):
            cv, ci = part_v[s, :, q], part_i[s, :, q]
            live &= _beats(cv, ci, vals[:, -1], idx[:, -1])
            if not live.any():
                break
            _insert(vals, idx, cv, ci, live)
    return torch.from_numpy(vals), torch.from_numpy(idx)


def tiles_forward(x, table_t, kc, scale=None, prune=False, slots=264,
                  stats=None, slab=None, mm=None):
    """The generator kernels' algorithm in plain PyTorch (f32): ``table_t``
    [E, V] may be a view whose rows lie ``ld`` elements apart; what lies
    past V in a row is read with the tile and masked, as the kernels do.
    ``slab``: x streamed in k-slabs of that many rows (32, every kernel),
    each tile's score the sum of the slabs' products in ascending k.
    ``mm(x_block, tile)``: a tile's score as the kernel's tiles compute it
    (the float32 kernels' split TF32); by default the f32 product."""
    r, e = x.shape
    # the running top-kc as the kernels lay it out: slot j of lane l holds
    # entry 32 * j + l, so [rows, slots, 32] flattens to entry order
    n_slots = K.slots(kc)
    assert 32 * n_slots >= kc
    v = table_t.shape[1]
    ld = table_t.stride(0)
    store = table_t.as_strided((table_t.shape[0], ld), (ld, 1))
    if scale is not None:
        store = store.to(BF16)   # the widening: exact for int8
    store = store.float()
    n_split, per = K.vocab_splits(r, v, slots)
    n_tiles = -(-v // K.TILE)
    assert (n_split - 1) * per < n_tiles <= n_split * per
    part_v = torch.full((n_split, r, kc), -torch.inf)
    part_i = torch.full((n_split, r, kc), NO_INDEX, dtype=torch.int64)
    part_m = torch.full((n_split, r), -torch.inf)
    part_s = torch.zeros((n_split, r))
    for row0 in range(0, r, K.ROW_BLOCK):
        xb = x[row0:row0 + K.ROW_BLOCK].float()
        rows = slice(row0, row0 + xb.shape[0])
        for s in range(n_split):
            m = torch.full((xb.shape[0],), -torch.inf)
            ssum = torch.zeros(xb.shape[0])
            lanes = (xb.shape[0], n_slots, 32)
            buf_v = torch.full(lanes, -torch.inf).flatten(1)[:, :kc]
            buf_i = torch.full(lanes, NO_INDEX,
                               dtype=torch.int64).flatten(1)[:, :kc]
            for tile in range(s * per, min(n_tiles, (s + 1) * per)):
                cols = torch.arange(tile * K.TILE, (tile + 1) * K.TILE)
                ok = cols < v
                tile_t = store[:, cols.clamp(max=ld - 1)]
                if mm is not None:
                    sc = mm(xb, tile_t)
                elif slab is None:
                    sc = xb @ tile_t
                else:
                    sc = torch.zeros((xb.shape[0], K.TILE))
                    for k0 in range(0, e, slab):
                        sc = sc + xb[:, k0:k0 + slab] @ tile_t[k0:k0 + slab]
                if scale is not None:
                    sc = sc * torch.where(ok, scale[cols.clamp(max=v - 1)],
                                          1.0)
                sc = torch.where(ok, sc, -torch.inf)
                m_new = torch.maximum(m, sc.max(-1).values)
                ssum = (ssum * torch.exp(m - m_new)
                        + torch.where(ok, torch.exp(sc - m_new[:, None]),
                                      0.0).sum(-1))
                m = m_new
                idx = torch.where(ok, cols, NO_INDEX).expand_as(sc)
                sel = torch.ones(xb.shape[0], dtype=torch.bool)
                if prune:
                    kth_v, kth_i = buf_v[:, -1:], buf_i[:, -1:]
                    sel = (ok & ((sc > kth_v) | ((sc == kth_v)
                                                 & (idx < kth_i)))).any(-1)
                    if stats is not None:
                        stats["skipped"] += int((~sel).sum())
                nv, ni = _top(torch.cat([sc, buf_v], -1),
                              torch.cat([idx, buf_i], -1), kc)
                buf_v = torch.where(sel[:, None], nv, buf_v)
                buf_i = torch.where(sel[:, None], ni, buf_i)
            part_v[s, rows], part_i[s, rows] = buf_v, buf_i
            part_m[s, rows], part_s[s, rows] = m, ssum
    m = part_m.max(0).values
    total = torch.zeros(r)
    for s in range(n_split):
        total = total + part_s[s] * torch.exp(part_m[s] - m)
    vals, idx = _warp_merge(part_v, part_i, kc)
    return (vals.numpy(), idx.to(torch.int32).numpy(),
            (m + torch.log(total)).numpy())


def _emulate(x, t, scale, kc, **kw):
    return tiles_forward(torch.from_numpy(x), torch.from_numpy(t), kc,
                         None if scale is None else torch.from_numpy(scale),
                         **kw)


def _agree(got, refs, integer):
    for rv, ri, rlse in refs:
        v, i, lse = got
        if integer:
            np.testing.assert_array_equal(v, rv)
        else:
            np.testing.assert_allclose(v, rv, rtol=1e-5, atol=0)
        np.testing.assert_array_equal(i, ri)
        np.testing.assert_allclose(lse, rlse, rtol=1e-6 if integer else 1e-5,
                                   atol=0)


# -- the emulation against the JAX package ----------------------------------


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulation runs thousands of small tensor ops; in a test worker
    beside five others torch's intra-op threads contend for the cores (a
    case took 30-70 s in the suite against 1-4 s alone), so this module
    runs them on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SHAPES = [(53, 999), (129, 1002)]   # R off the 64-row block; V off the tile,
# 1002 = 2 mod 8 (unaligned bf16 rows); kc past one slot (33), at two
# slots' end (64) and at the top (128, the JAX kernel's _KPAD)
KCS = [1, 2, 6, 32, 33, 64, 128]
_JAX_CACHE = {}


def _case(shape, integer, int8):
    key = (shape, integer, int8)
    if key not in _JAX_CACHE:
        r, v = shape
        x, t, scale = _data(7 + 2 * r + integer, r, v, integer, int8)
        _JAX_CACHE[key] = (x, t, scale, _jax(x, t, scale, K.MAX_KC))
    return _JAX_CACHE[key]


@pytest.mark.parametrize("data", ["integer", "random"])
@pytest.mark.parametrize("mode", ["float", "prune", "int8", "int8-prune"])
@pytest.mark.parametrize("shape", SHAPES, ids=["53x999", "129x1002"])
def test_tiles_match_jax(shape, mode, data):
    """Every kc of one case against the JAX kernel's and reference's
    top-128 (whose first kc entries are the top-kc)."""
    integer = data == "integer"
    x, t, scale, refs = _case(shape, integer, mode.startswith("int8"))
    for kc in KCS:
        got = _emulate(x, t, scale, kc, prune=mode.endswith("prune"))
        _agree(got, [(v[:, :kc], i[:, :kc], lse) for v, i, lse in refs],
               integer)


# (E, slab, kernel): past every whole x tile -- E = 1,300 above bf16
# kernel 2's 1,264, E = 2,100 above everything -- with each kernel's slab
WIDE = [(1300, 32, "bf16"), (2100, 32, "bf16"), (1300, 32, "f32"),
        (2100, 32, "f32-pipeline")]


@pytest.mark.parametrize("data", ["integer", "random"])
@pytest.mark.parametrize("e,slab,kernel", WIDE,
                         ids=[f"E{e}-{k}" for e, _, k in WIDE])
def test_streamed_x_slabs_match_jax(e, slab, kernel, data):
    """x in k-slabs: each tile's score summed slab by slab in ascending k,
    at kc 6 and 128 (one slot and four), pruned and not, against the JAX
    kernel (E padded to 128 inside it) and its reference.  Integer data:
    vals and idx bit-exact, lse within 1e-6 relative.  Random data: idx
    exact, lse within 1e-5 relative, vals within 1e-5 of the row's largest
    score (a sum of E = 2,100 products in another order moves a score by
    an amount set by the terms' size, not by the score's own)."""
    integer = data == "integer"
    dtype = F32 if kernel.startswith("f32") else BF16
    pipeline = kernel.endswith("pipeline")
    assert K.beamgen_streams_x(e, dtype, pipeline)
    key = ("wide", e, integer)
    if key not in _JAX_CACHE:   # one JAX run per E and data kind
        x, t, _ = _data(17 + e + integer, 53, 300, integer, e=e)
        _JAX_CACHE[key] = (x, t, _jax(x, t, None, K.MAX_KC))
    x, t, refs = _JAX_CACHE[key]
    for kc in (6, 128):
        for prune in (False, True):
            v, i, lse = _emulate(x, t, None, kc, prune=prune, slab=slab)
            for rv, ri, rlse in refs:
                rv, ri = rv[:, :kc], ri[:, :kc]
                np.testing.assert_array_equal(i, ri)
                if integer:
                    np.testing.assert_array_equal(v, rv)
                else:
                    top = np.abs(rv).max(-1, keepdims=True)
                    assert (np.abs(v - rv) <= 1e-5 * top).all()
                np.testing.assert_allclose(
                    lse, rlse, rtol=1e-6 if integer else 1e-5, atol=0)


@pytest.mark.parametrize("slots", [1, 3, 7, 132, 264, 10_000])
def test_split_counts(slots):
    """One split, several, a ragged last split and one tile a split give
    the same vals and idx, and lse within 1e-6 relative."""
    r, v = 53, 999
    x, t, scale, refs = _case((r, v), False, False)
    n_split, per = K.vocab_splits(r, v, slots)
    got = _emulate(x, t, scale, 6, slots=slots)
    one = _emulate(x, t, scale, 6, slots=1)
    np.testing.assert_array_equal(got[0], one[0])
    np.testing.assert_array_equal(got[1], one[1])
    np.testing.assert_allclose(got[2], one[2], rtol=1e-6, atol=0)
    _agree(got, [(a[:, :6], b[:, :6], c) for a, b, c in refs], False)
    if slots == 3:   # 8 tiles in 3 splits of 3: the last holds 2
        assert (n_split, per) == (3, 3)


def test_ragged_and_whole_wave_splits():
    assert K.vocab_splits(1600, 50_000, 264) == (10, 40)
    assert K.vocab_splits(320, 50_000, 264) == (49, 8)
    # float32 (one block an SM) and bf16 past one slot
    assert K.vocab_splits(1600, 50_000, 132) == (5, 79)
    assert K.vocab_splits(320, 50_000, 132) == (25, 16)
    for rows, v, slots in ((1, 1, 1), (53, 999, 9), (129, 1002, 1),
                           (5000, 4096, 264), (1600, 50_004, 264),
                           (40_640, 50_000, 132)):
        n, per = K.vocab_splits(rows, v, slots)
        tiles = -(-v // K.TILE)
        assert (n - 1) * per < tiles <= n * per
        blocks = -(-rows // K.ROW_BLOCK) * n
        assert blocks <= max(slots, -(-rows // K.ROW_BLOCK))


@pytest.mark.parametrize("kc", [2, 6])
def test_ties_at_tile_and_split_edges(kc):
    """Equal maxima at columns 127 | 128 (a tile edge) and 255 | 256 (a
    split edge: 4 tiles in splits of 2) go to the lower index first."""
    v = 512
    x = np.ones((8, E), np.float32)
    t = np.zeros((E, v), np.float32)
    for c in (127, 128, 255, 256, 300, 511):
        t[:, c] = 1.0
    t[:, 400] = 0.5
    got = _emulate(x, t, None, kc, slots=2)
    assert K.vocab_splits(8, v, 2) == (2, 2)
    assert got[1][0].tolist() == [127, 128, 255, 256, 300, 511][:kc]
    refs = _jax(x, t, None, kc)
    for flags in ({}, {"prune": True}):
        _agree(_emulate(x, t, None, kc, slots=2, **flags), refs, True)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_front_loaded_prune_skips_and_agrees(int8):
    x, t, scale = _data(11, 53, 999, int8=int8, front=True)
    stats = {"skipped": 0}
    got = _emulate(x, t, scale, 6, prune=True, slots=1, stats=stats)
    assert stats["skipped"] >= 53 * 6   # rows skip most of the 8 tiles
    base = _emulate(x, t, scale, 6, slots=1)
    for a, b in zip(got, base):
        np.testing.assert_array_equal(a, b)
    _agree(got, _jax(x, t, scale, 6, prune=True), False)


@pytest.mark.parametrize("dtype", [F32, BF16, torch.int8])
def test_padded_row_stride_never_reaches_the_result(dtype):
    """A view of a table whose padding holds NaN (or -128): the emulation
    reads the padding with its tiles and masks it, so its outputs are the
    contiguous table's; the wrapper's plain version takes the view too."""
    r, v = 53, 1002
    int8 = dtype == torch.int8
    x, t, scale = _data(13, r, v, int8=int8)
    ld = 1024
    store = torch.full((E, ld), -128 if int8 else float("nan"))
    store = store.to(torch.int8 if int8 else F32)
    view = store[:, :v]
    view.copy_(torch.from_numpy(t))
    if dtype == BF16:   # bf16 values, held in f32 for the emulation
        view.copy_(view.to(BF16).float())
        t = view.numpy().copy()
    assert view.stride(0) == ld and not view.is_contiguous()
    s = None if scale is None else torch.from_numpy(scale)
    got = tiles_forward(torch.from_numpy(x), view, 6, s)
    for a, b in zip(got, _emulate(x, t, scale, 6)):
        np.testing.assert_array_equal(a, b)
    _agree(got, _jax(x, t, scale, 6, kernel=False), False)
    plain = K.generator_topk_lse(torch.from_numpy(x), view, 6, scale=s,
                                 device="cpu")
    np.testing.assert_array_equal(plain[1].numpy(), got[1])


# -- the wrapper's table layout ----------------------------------------------


@pytest.mark.parametrize("dtype,v,ld", [(BF16, 999, 1000), (BF16, 1002, 1008),
                                        (BF16, 50_004, 50_008),
                                        (torch.int8, 1002, 1008),
                                        (torch.int8, 50_004, 50_016),
                                        (F32, 999, 1000), (F32, 1002, 1004)])
def test_aligned_table_pads_unaligned_rows(dtype, v, ld):
    t = torch.arange(E * v).reshape(E, v).remainder(101).to(dtype)
    assert not K.table_aligned(t)
    got = K.aligned_table(t)
    assert got.shape == (E, v) and got.stride() == (ld, 1)
    assert K.table_aligned(got) and K.aligned_table(got) is got
    assert torch.equal(got, t)
    pad = got.as_strided((E, ld), (ld, 1))[:, v:]
    assert pad.numel() == 0 or not pad.any()


def test_aligned_table_keeps_aligned_and_copies_transposes():
    t = torch.randn(E, 1024).to(BF16)
    assert K.aligned_table(t) is t
    assert not K.table_aligned(t[:, 1:])            # start off 16 bytes
    assert K.aligned_table(t[:, 1:]).stride() == (1024, 1)
    emb = torch.randn(1000, E)
    got = K.aligned_table(emb.t())                  # [E, V] of [V, E]
    assert got.stride() == (1000, 1) and torch.equal(got, emb.t())


def _tiny_model(vocab):
    cfg = default_config("cars").replace(
        vocab_size=vocab, emsize=8, nhid=4, nhid_ffnn=8, max_query_len=5,
        max_doc_len=6, max_session_len=2, num_candidates=4, dropout=0.0,
        dropout_emb=0.0, dropout_rnn=0.0)
    return CARS(cfg, device="cpu", seed=3)


def test_decoders_build_the_padded_table_once():
    """fused_generator_table and the shortlist gather return views the
    kernels read as they lie (so no step copies the table), holding the
    embedding's values."""
    model = _tiny_model(45)   # 45 bf16 = 90-byte rows: padded to 96
    table_t, scale = fused_generator_table(model)
    assert scale is None and table_t.shape == (8, 45)
    assert table_t.stride() == (48, 1) and K.table_aligned(table_t)
    assert torch.equal(table_t,
                       model.embeddings.embedding.detach().to(BF16).t())
    sl_t, _, sl = _shortlisted(table_t, None, [0, 3, 5, 44, 7])
    assert sl_t.shape == (8, 5) and K.table_aligned(sl_t)
    assert torch.equal(sl_t, table_t[:, sl.long()])


# -- the shared tiles' limits ------------------------------------------------


# the last E whose whole x tile fits, per dtype and kernel
WHOLE_TILE_TOPS = [(BF16, False, 1264), (BF16, True, 976), (F32, False, 496),
                   (F32, True, 352)]


def _launcher_smem(e, dtype, pipeline):
    """``plan`` in csrc/beamgen.cu, written out: (the pipelined header,)
    the whole x tile or none, the score buffer(s) and the ring of four
    slots: a 32-row table slab (bf16 rows of 128 elements + 16 bytes,
    float32 of 128 + 8 elements) and, streamed, a [64, 32] x slab (rows of
    32 elements + 16 bytes)."""
    if dtype == F32:
        stream = e > (352 if pipeline else 496)
        x_tile = 0 if stream else 64 * (4 * (-(-e // 8) * 8) + 16)
        slot = 32 * (4 * 136) + (64 * (4 * 32 + 16) if stream else 0)
        return ((64 if pipeline else 0) + x_tile
                + (2 if pipeline else 1) * 64 * 136 * 4 + 4 * slot)
    stream = e > (976 if pipeline else 1264)
    x_tile = 0 if stream else 64 * (2 * (-(-e // 16) * 16) + 16)
    slot = 32 * (2 * 128 + 16) + (64 * (2 * 32 + 16) if stream else 0)
    return ((64 if pipeline else 0) + x_tile
            + (2 if pipeline else 1) * 64 * 136 * 4 + 4 * slot)


@pytest.mark.parametrize("dtype,pipeline,top", WHOLE_TILE_TOPS)
def test_beamgen_supported_at_and_past_each_limit(dtype, pipeline, top):
    """Every E >= 1 is held: up to ``top`` with the whole x tile, past it
    with x streamed (the switch of ``tc::stream_x`` / ``f32_stream_x``);
    ``beamgen_smem_bytes`` is the launcher's sum at every (E, kc, mode),
    and the kc it takes is the JAX kernel's 1 .. 128."""
    assert not K.beamgen_streams_x(top, dtype, pipeline)
    assert K.beamgen_streams_x(top + 1, dtype, pipeline)
    assert K.beamgen_smem_bytes(top, dtype, pipeline) <= K.SMEM_LIMIT
    for e in (1, 15, 16, 100, 256, 300, top, top + 1, 1300, 2048, 2100,
              4096, 12_288):
        assert K.beamgen_supported(e, dtype, pipeline)
        assert K.beamgen_streams_x(e, dtype, pipeline) is (e > top)
        for kc in (1, 32, 33, 64, 65, 128):
            assert (K.beamgen_smem_bytes(e, dtype, pipeline, kc)
                    == _launcher_smem(e, dtype, pipeline) <= K.SMEM_LIMIT)
    assert not K.beamgen_supported(0, dtype, pipeline)
    for kc in (0, 129):
        with pytest.raises(ValueError, match="kc"):
            K.beamgen_smem_bytes(256, dtype, pipeline, kc)


def test_smem_bytes_of_the_serving_width():
    # x tile 64 x (2*256 + 16) + one score buffer 64 x 136 x 4 + the ring
    # of four 32-row slabs
    assert K.beamgen_smem_bytes(256, BF16) == 33_792 + 34_816 + 34_816
    assert (K.beamgen_smem_bytes(256, BF16, pipeline=True)
            == 64 + 33_792 + 2 * 34_816 + 34_816)
    # E not a multiple of 16 stages the last k-slab zero-filled to 16
    assert K.beamgen_smem_bytes(300, BF16) == K.beamgen_smem_bytes(304, BF16)
    # float32: x tile 64 x (4*256 + 16), one score buffer, four 32-row
    # slabs of 136 floats (17,408 bytes each)
    assert K.beamgen_smem_bytes(256, F32) == 66_560 + 34_816 + 69_632
    assert (K.beamgen_smem_bytes(256, F32, pipeline=True)
            == 64 + 66_560 + 2 * 34_816 + 69_632)
    assert K.beamgen_smem_bytes(100, F32) == K.beamgen_smem_bytes(104, F32)
    # streamed: no x tile; four slots of a table slab and a [64, 32] x
    # slab (80-byte rows)
    assert (K.beamgen_smem_bytes(1536, BF16)
            == 34_816 + 4 * (8_704 + 5_120) == 90_112)
    assert (K.beamgen_smem_bytes(1536, BF16, pipeline=True)
            == 64 + 2 * 34_816 + 4 * (8_704 + 5_120))
    # float32 streamed: slots of a 17,408-byte table slab and a [64, 32]
    # x slab (144-byte rows)
    assert (K.beamgen_smem_bytes(2048, F32)
            == 34_816 + 4 * (17_408 + 9_216) == 141_312)
    assert (K.beamgen_smem_bytes(2048, F32, pipeline=True)
            == 64 + 2 * 34_816 + 4 * (17_408 + 9_216))


def test_kc_limit_is_the_jax_kernels():
    """The kernels' top-kc limit is the JAX kernel's lane-padded buffer
    (``_KPAD``): it takes kc = 128 (``test_tiles_match_jax``) and asserts
    at 129, as the port's wrapper refuses 129 on card tensors; the slots a
    lane gives a row."""
    from context_attentive_ir_tpu.ops.pallas import beamgen as jax_beamgen

    assert K.MAX_KC == jax_beamgen._KPAD == 128
    assert [K.slots(kc) for kc in (1, 32, 33, 64, 65, 128)] == [1, 1, 2, 2,
                                                               4, 4]
    x, t, _ = _data(3, 8, 200)
    with pytest.raises(AssertionError):
        jax_kernel(jnp.asarray(x), jnp.asarray(t), 129, block_r=64,
                   block_v=256, interpret=True)
