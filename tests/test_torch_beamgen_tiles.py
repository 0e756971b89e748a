"""What surrounds the generator kernels (kernel 2 in its float, pruned and
int8 modes, kernel 3; ``ops/kernels/beamgen.py``) on the host, and a
plain-PyTorch emulation of their algorithm held to the JAX package.

The emulation follows ``csrc/beamgen.cu`` and ``csrc/beamgen_common.cuh``:
row blocks of 64 rows; the vocab cut into 128-column tiles and split into
runs of tiles (``vocab_splits``); per (row block, split) an online
logsumexp and a running top-kc over the tiles in ascending order, the
selection of a tile skipped for a row when ``prune`` finds no column of
the tile beating the row's kc-th entry; an int8 table widened to bf16
(exact) before the dot and the scale applied to the f32 score after it;
the table read through its padded row stride with columns past the
logical V masked; then the merge of the splits per row in split order
(the lse merge ``m + log(sum_s s_s * exp(m_s - m))``, the top-kc by the
kernel's tie rule: larger value, else lower index).

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


def _data(seed, r, v, integer=False, int8=False, front=False):
    """x [r, E] f32 and table_t [E, v] (int8 with its scale [v] when
    ``int8``: integer data small integers with power-of-two scales, random
    data through the JAX package's quantizer); ``front`` puts every row's
    top scores in the first 128 columns, so ``prune`` skips later tiles."""
    rng = np.random.RandomState(seed)
    if integer:
        x = rng.randint(-3, 4, size=(r, E)).astype(np.float32)
        t = rng.randint(-3, 4, size=(E, v)).astype(np.float32)
    else:
        x = (rng.normal(size=(r, E)) * 0.5).astype(np.float32)
        t = (rng.normal(size=(E, v)) * 0.5).astype(np.float32)
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


def tiles_forward(x, table_t, kc, scale=None, prune=False, slots=264,
                  whole_wave=True, stats=None):
    """The generator kernels' algorithm in plain PyTorch (f32): ``table_t``
    [E, V] may be a view whose rows lie ``ld`` elements apart; what lies
    past V in a row is read with the tile and masked, as the kernels do."""
    r, _ = x.shape
    v = table_t.shape[1]
    ld = table_t.stride(0)
    store = table_t.as_strided((table_t.shape[0], ld), (ld, 1))
    if scale is not None:
        store = store.to(BF16)   # the widening: exact for int8
    store = store.float()
    n_split, per = K.vocab_splits(r, v, slots, whole_wave)
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
            buf_v = torch.full((xb.shape[0], kc), -torch.inf)
            buf_i = torch.full((xb.shape[0], kc), NO_INDEX, dtype=torch.int64)
            for tile in range(s * per, min(n_tiles, (s + 1) * per)):
                cols = torch.arange(tile * K.TILE, (tile + 1) * K.TILE)
                ok = cols < v
                tile_t = store[:, cols.clamp(max=ld - 1)]
                sc = xb @ tile_t
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
    vals = torch.full((r, kc), -torch.inf)
    idx = torch.full((r, kc), NO_INDEX, dtype=torch.int64)
    for s in range(n_split):
        vals, idx = _top(torch.cat([vals, part_v[s]], -1),
                         torch.cat([idx, part_i[s]], -1), kc)
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

SHAPES = [(53, 999), (129, 1002)]   # R off the 64-row block; V off the tile,
KCS = [1, 2, 6, 32]                 # 1002 = 2 mod 8 (unaligned bf16 rows)
_JAX_CACHE = {}


def _case(shape, integer, int8):
    key = (shape, integer, int8)
    if key not in _JAX_CACHE:
        r, v = shape
        x, t, scale = _data(7 + 2 * r + integer, r, v, integer, int8)
        _JAX_CACHE[key] = (x, t, scale, _jax(x, t, scale, 32))
    return _JAX_CACHE[key]


@pytest.mark.parametrize("data", ["integer", "random"])
@pytest.mark.parametrize("mode", ["float", "prune", "int8", "int8-prune"])
@pytest.mark.parametrize("shape", SHAPES, ids=["53x999", "129x1002"])
def test_tiles_match_jax(shape, mode, data):
    """Every kc of one case against the JAX kernel's and reference's
    top-32 (whose first kc entries are the top-kc)."""
    integer = data == "integer"
    x, t, scale, refs = _case(shape, integer, mode.startswith("int8"))
    for kc in KCS:
        got = _emulate(x, t, scale, kc, prune=mode.endswith("prune"))
        _agree(got, [(v[:, :kc], i[:, :kc], lse) for v, i, lse in refs],
               integer)


@pytest.mark.parametrize("slots,whole_wave", [(1, True), (3, True),
                                              (7, True), (264, True),
                                              (10_000, True), (264, False)])
def test_split_counts(slots, whole_wave):
    """One split, several, a ragged last split and one tile a split give
    the same vals and idx, and lse within 1e-6 relative."""
    r, v = 53, 999
    x, t, scale, refs = _case((r, v), False, False)
    n_split, per = K.vocab_splits(r, v, slots, whole_wave)
    got = _emulate(x, t, scale, 6, slots=slots, whole_wave=whole_wave)
    one = _emulate(x, t, scale, 6, slots=1)
    np.testing.assert_array_equal(got[0], one[0])
    np.testing.assert_array_equal(got[1], one[1])
    np.testing.assert_allclose(got[2], one[2], rtol=1e-6, atol=0)
    _agree(got, [(a[:, :6], b[:, :6], c) for a, b, c in refs], False)
    if slots == 3:   # 8 tiles in 3 splits of 3: the last holds 2
        assert (n_split, per) == (3, 3)


def test_ragged_and_whole_wave_splits():
    assert K.vocab_splits(1600, 50_000, 264) == (10, 40)
    assert K.vocab_splits(1600, 50_000, 264, whole_wave=False) == (11, 36)
    assert K.vocab_splits(320, 50_000, 264) == (49, 8)
    assert K.vocab_splits(1600, 50_000, 132) == (5, 79)
    for rows, v, slots in ((1, 1, 1), (53, 999, 9), (129, 1002, 1),
                           (5000, 4096, 264), (1600, 50_004, 264)):
        for whole in (True, False):
            n, per = K.vocab_splits(rows, v, slots, whole)
            tiles = -(-v // K.TILE)
            assert (n - 1) * per < tiles <= n * per
            if whole:
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


@pytest.mark.parametrize("dtype,pipeline,top", [(BF16, False, 1264),
                                                (BF16, True, 976),
                                                (F32, False, 908),
                                                (F32, True, 652)])
def test_beamgen_supported_at_and_past_each_limit(dtype, pipeline, top):
    assert K.beamgen_supported(top, dtype, pipeline)
    assert not K.beamgen_supported(top + 1, dtype, pipeline)
    assert K.beamgen_smem_bytes(top, dtype, pipeline) <= K.SMEM_LIMIT
    assert K.beamgen_smem_bytes(top + 1, dtype, pipeline) > K.SMEM_LIMIT
    for e in (1, 100, 256, 300):
        assert K.beamgen_supported(e, dtype, pipeline)
    assert not K.beamgen_supported(0, dtype, pipeline)


def test_smem_bytes_of_the_serving_width():
    # x tile 64 x (2*256 + 16) + one score buffer 64 x 136 x 4 + the ring
    # of four 32-row slabs
    assert K.beamgen_smem_bytes(256, BF16) == 33_792 + 34_816 + 34_816
    assert (K.beamgen_smem_bytes(256, BF16, pipeline=True)
            == 64 + 33_792 + 2 * 34_816 + 34_816)
    # E not a multiple of 16 stages the last k-slab zero-filled to 16
    assert K.beamgen_smem_bytes(300, BF16) == K.beamgen_smem_bytes(304, BF16)
    assert K.beamgen_smem_bytes(256, F32) == 256 * 64 * 4
