"""What surrounds kernel 10's bf16 resident kernel (``csrc/slate_pool.cu``,
``ops/kernels/slate.py``) on the host: the document tiles (``pool_tiles``),
the shared-memory sizing at and beyond its limit (``pool_smem_bytes``), the
route between the resident kernel and the wide route
(``pool_route``; ``pool_supported`` unchanged), and a plain-PyTorch
emulation of the resident kernel's algorithm held to the JAX package at
f32 on ragged shapes.

The emulation follows ``slate_pool_tc_kernel``: tiles of 64 token rows
holding whole documents, each document's T padded with zero rows to a
multiple of 16; the tile's projection ``tile @ W_p`` with bf16 operands and
f32 accumulation; ``tanh(. + b_p)`` times the document's query, summed per
warp over its H / 8 columns and then over the 8 warps in order; a masked
softmax over each document's T scores at once (masked tokens -1e30 and
weight 0); ``sum_t p_t x_t / max(s, 1e-13)``.

JAX side: ``_pool_fused_impl`` in Pallas interpret mode (block 16, time
chunk 6; its online softmax sums in another order) and the port's plain
version.  Tolerance: 1e-5 abs, as ``tests/test_torch_slate.py``; fully
masked rows pool to exactly 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from context_attentive_ir_tpu.ops.pallas.slate import _pool_fused_impl
from context_attentive_ir_tpu_torch.ops.kernels import slate as S

TOL = 1e-5
BF16, F32 = torch.bfloat16, torch.float32


def _inputs(seed, r, t, h=128):
    """Rows 0 and 3 fully masked (when there are enough), row 1 fully
    valid; masked tokens zeroed, as the encoders leave them."""
    rng = np.random.RandomState(seed)
    states = (rng.normal(size=(r, t, h)) * 0.5).astype(np.float32)
    query = (rng.normal(size=(r, h)) * 0.5).astype(np.float32)
    w_p = (rng.normal(size=(h, h)) * 0.15).astype(np.float32)
    b_p = (rng.normal(size=(h,)) * 0.1).astype(np.float32)
    lens = rng.randint(1, t + 1, size=(r,))
    lens[0] = 0
    if r > 3:
        lens[1], lens[3] = t, 0
    mask = np.arange(t)[None, :] < lens[:, None]
    return states * mask[:, :, None], mask, query, w_p, b_p


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


# -- tiles, shared memory and the gate -----------------------------------------

@pytest.mark.parametrize("steps,t_pad,docs", [
    (1, 16, 4), (15, 16, 4), (16, 16, 4), (17, 32, 2), (30, 32, 2),
    (32, 32, 2), (33, 48, 1), (48, 48, 1), (64, 64, 1)])
def test_pool_tiles_hold_whole_documents(steps, t_pad, docs):
    assert S.pool_tiles(steps) == (t_pad, docs)
    assert docs * t_pad <= S.TILE_ROWS < (docs + 1) * t_pad
    assert t_pad % 16 == 0 and t_pad - 16 < steps <= t_pad


@pytest.mark.parametrize("hidden,n_bytes", [
    # mbarriers + W_p and two buffers of 64 rows (2H + 16 bytes each) +
    # two buffers' queries (4 documents) + score exchange + weights + sums
    (128, 64 + 128 * 272 + 2 * 64 * 272 + 2 * 4 * 256 + 2048 + 256 + 16),
    (256, 64 + 256 * 528 + 2 * 64 * 528 + 2 * 4 * 512 + 2048 + 256 + 16),
    (384, 64 + 384 * 784 + 2 * 64 * 784 + 2 * 4 * 768 + 2048 + 256 + 16),
    (512, 64 + 512 * 1040 + 2 * 64 * 1040 + 2 * 4 * 1024 + 2048 + 256
     + 16)])
def test_pool_smem_bytes_at_and_beyond_the_limit(hidden, n_bytes):
    """H = 256 fits a block (209,232 of 232,448 bytes); at H = 384 W_p
    alone (301,056 bytes) does not, so 384 and 512 take the wide
    route."""
    assert S.pool_smem_bytes(hidden) == n_bytes
    assert (n_bytes <= S.SMEM_LIMIT) is (hidden <= 256)
    if hidden == 384:
        assert hidden * (2 * hidden + 16) > S.SMEM_LIMIT


@pytest.mark.parametrize("hidden,steps,dtype,tc", [
    (256, 30, BF16, "resident"), (128, 30, BF16, "resident"),
    (256, 1, BF16, "resident"), (256, 64, BF16, "resident"),
    (256, 65, BF16, "wide"), (256, 0, BF16, "wide"),
    (384, 30, BF16, "wide"), (512, 30, BF16, "wide"),
    (256, 30, F32, "wide"), (128, 30, torch.float16, None)])
def test_pool_tensor_cores_gate(hidden, steps, dtype, tc):
    """The resident kernel takes bf16 at H = 128 / 256 with 1 <= T <= 64;
    every other shape takes the wide route (tensor cores in both dtypes);
    float16 is refused."""
    assert S.pool_route(hidden, steps, dtype) == tc


@pytest.mark.parametrize("hidden", [128, 256, 384, 512])
def test_pool_supported_is_unchanged(hidden):
    """No shape the first kernel took is refused: every 128-aligned width
    from 8 rows, whatever T and dtype (the tensor-core gate only routes)."""
    assert S.pool_supported(hidden, 8) and S.pool_supported(hidden, 16_007)
    assert not S.pool_supported(hidden, 7)
    assert not S.pool_supported(hidden + 64, 16)


# -- the tile algorithm against JAX ------------------------------------------------

def tile_pool(states, mask, query, w_p, b_p):
    """Kernel 10's tensor-core algorithm in plain PyTorch (see the module
    note); returns the pooled rows in f32, before the kernel's final
    rounding to the states' dtype."""
    R, T, H = states.shape
    t_pad, docs = S.pool_tiles(T)
    sf, qf = states.float(), query.float()
    wf, bf = w_p.float(), b_p.float()
    out = torch.zeros((R, H))
    for doc0 in range(0, R, docs):
        nd = min(docs, R - doc0)
        tile = torch.zeros((S.TILE_ROWS, H))
        q_rows = torch.zeros((S.TILE_ROWS, H))
        for d in range(nd):
            tile[d * t_pad:d * t_pad + T] = sf[doc0 + d]
            q_rows[d * t_pad:(d + 1) * t_pad] = qf[doc0 + d]
        val = torch.tanh(tile @ wf + bf) * q_rows
        part = val.reshape(S.TILE_ROWS, 8, H // 8).sum(-1)   # per warp
        score = part[:, 0]
        for w in range(1, 8):   # the warps' partials in order
            score = score + part[:, w]
        for d in range(nd):
            rows = slice(d * t_pad, d * t_pad + T)
            m = mask[doc0 + d]
            sc = torch.where(m, score[rows], torch.tensor(-1e30))
            p = torch.where(m, torch.exp(sc - sc.max()), torch.zeros(()))
            den = p.sum()
            out[doc0 + d] = (p[:, None] * tile[rows]).sum(0) / torch.clamp(
                den, min=1e-13)
    return out


# (rows, T): T = 1 (four documents a tile), 15, 17 (two of 32 rows), 30
# (Ld), 33 (one of 48), 64 (one of 64, the limit); rows off the tiles (37
# is 9 tiles of 4 and one of 1, 18 tiles of 2 and one of 1)
RAGGED = [(37, 1), (37, 15), (37, 17), (37, 30), (21, 33), (9, 64)]


@pytest.mark.parametrize("r,t", RAGGED)
def test_tile_algorithm_matches_jax_at_ragged_shapes(r, t):
    args = _inputs(1, r, t)
    ta = [torch.from_numpy(a) for a in args]
    got = tile_pool(*ta)
    jax_out = np.asarray(_pool_fused_impl(*map(jnp.asarray, args),
                                          block_r=16, time_chunk=6,
                                          interpret=True))
    plain = S.attn_pool(*ta, device="cpu")
    assert got.shape == (r, args[0].shape[-1])
    assert _max_err(got, jax_out) <= TOL
    assert _max_err(got, plain) <= TOL
    empty = ~args[1].any(-1)
    assert empty.sum() >= 1
    for out in (got.numpy(), jax_out, plain.numpy()):
        assert not out[empty].any()   # fully masked rows exactly 0


def test_tile_algorithm_at_the_slates_width():
    """H = 256 (CARS's 2 * nhid): 8 warps of 32 columns a tile."""
    args = _inputs(2, 13, 30, h=256)
    ta = [torch.from_numpy(a) for a in args]
    jax_out = np.asarray(_pool_fused_impl(*map(jnp.asarray, args),
                                          block_r=16, time_chunk=6,
                                          interpret=True))
    assert _max_err(tile_pool(*ta), jax_out) <= TOL


@pytest.mark.parametrize("r,t", [(37, 30), (21, 17)])
def test_tile_algorithm_on_bf16_operands(r, t):
    """bf16 operands, f32 accumulation: the emulation agrees with the plain
    version run in f32 on the same rounded inputs (as chip_smoke holds the
    kernel) and, once rounded, is within one bf16 rounding of it."""
    args = _inputs(3, r, t)
    ta = [torch.from_numpy(a) for a in args]
    tb = [t_.to(BF16) if t_.is_floating_point() else t_ for t_ in ta]
    got = tile_pool(*tb)
    ref = S.attn_pool_reference(*(t_.float() if t_.is_floating_point()
                                  else t_ for t_ in tb))
    assert _max_err(got, ref) <= TOL
    scale = float(ref.abs().max())
    assert _max_err(got.to(BF16).float(), ref) <= 2 ** -8 * scale
    assert not got[~tb[1].any(-1)].any()
