"""Kernel 10's wide route (``csrc/slate_pool.cu``, ``ops/kernels/slate.py``):
every shape the resident kernel does not take -- float32 at every width,
bfloat16 from H = 384 and past a tile's 64 tokens -- and past H = 1,024.

- ``wide_route``, a plain-PyTorch emulation of the route's algorithm --
  the score kernel's partial scores ``tanh(states @ W_p[:, tile] +
  b_p[tile]) . query[tile]`` a column tile of 128 at a time (float32
  operands through the split-TF32 product, ``split_mm`` of
  ``tests/test_torch_tf32_tiles.py``: each operand split on its bit
  pattern into hi = tf32(v) and lo, per k step of 8 lo*hi, hi*lo, hi*hi,
  a k-slab of 32 into a fresh accumulator added to the tile's; bf16
  operands with f32 accumulation), the pool kernel's sum of a token's
  partials in tile order, each document's masked softmax at once (masked
  tokens score -1e30 and weigh 0; a fully masked row pools to exactly 0)
  and the weighted sum divided by ``max(sum p, 1e-13)`` -- against the JAX
  pool (``_pool_fused_impl``) in Pallas interpret mode at H = 384, 1,024
  and 1,152 (ragged R, T = 1, 7, 30, 32, 33, 64) and against
  ``attn_pool_reference`` at every width to 1,024 that the route takes at
  the documents' 30 tokens, in both dtypes, and at 2,304 and 4,096.
- The gate and the route rule: ``pool_supported`` is the JAX gate at
  every multiple of 64 up to 4,096; ``pool_route`` at every multiple of
  128 to 4,096, T = 0, 1, 32, 33, 64, 65, both dtypes, against the rule
  written out.

Tolerance: 1e-5 abs on f32 operands (bf16: the reference run in f32 on
the same bf16-rounded operands; the emulation and the references sum the
same products in other orders; split TF32 keeps about 22 of float32's 24
bits; |pooled| <= 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_tf32_tiles import split_mm, tf32

from context_attentive_ir_tpu.ops.pallas.slate import _pool_fused_impl
from context_attentive_ir_tpu.ops.pallas.slate import (
    pool_supported as jax_pool_supported,
)
from context_attentive_ir_tpu_torch.ops.attention import AttentionPool
from context_attentive_ir_tpu_torch.ops.kernels import slate as P
from context_attentive_ir_tpu_torch.ops.layers import reset_parameters

TOL = 1e-5
BF16, F32 = torch.bfloat16, torch.float32
SCORE_COLS = 128   # W_p columns of a score tile (kScoreCols)
SCORE_K = 32       # k-rows of a slab (kScoreK)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensor ops beside five other test workers: one torch thread,
    as the other emulation tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, r, t, h):
    """Encoder-like operands in f32: states in (-1, 1), zero where masked;
    rows 0 and 5 fully masked, row 1 fully valid (as chip_smoke's)."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(0, t + 1, size=(r,))
    lens[0], lens[1], lens[5] = 0, t, 0
    mask = np.arange(t)[None, :] < lens[:, None]
    states = (rng.uniform(-1, 1, (r, t, h)) * mask[..., None]).astype(
        np.float32)
    query = rng.uniform(-1, 1, (r, h)).astype(np.float32)
    w_p = (rng.uniform(-1, 1, (h, h)) * np.sqrt(6.0 / (2 * h))).astype(
        np.float32)
    b_p = (rng.uniform(-1, 1, (h,)) * 0.1).astype(np.float32)
    return states, mask, query, w_p, b_p


def _rounded(args, dtype):
    """The operands as the kernel reads them in ``dtype``, in f32."""
    return [torch.from_numpy(a) if a.dtype == bool
            else torch.from_numpy(a).to(dtype).float() for a in args]


def score_partials(states, query, w_p, b_p, dtype=F32):
    """The score kernel: [H / 128, R, T] partial scores, one a column tile
    of W_p, each reduced over the tile's columns; ``dtype`` the kernel's
    (float32: the split-TF32 product, a fresh accumulator a k-slab)."""
    R, T, H = states.shape
    x = states.reshape(-1, H)
    parts = []
    for c0 in range(0, H, SCORE_COLS):
        cols = slice(c0, c0 + SCORE_COLS)
        if dtype == F32:
            acc = split_mm(x, w_p[:, cols], promote=SCORE_K // 8)
        else:   # bf16 operands: exact products, f32 accumulation
            acc = x @ w_p[:, cols]
        h = torch.tanh(acc.reshape(R, T, -1) + b_p[cols])
        parts.append(torch.einsum("rth,rh->rt", h, query[:, cols]))
    return torch.stack(parts)


def wide_route(states, mask, query, w_p, b_p, dtype=F32):
    """The wide route end to end on operands already rounded to ``dtype``
    and given in f32: the partials added in tile order, the masked softmax
    of each document's T scores at once, the pooled sum in f32 (before the
    kernel's final rounding to ``dtype``)."""
    parts = score_partials(states, query, w_p, b_p, dtype)
    score = parts[0]
    for q in range(1, parts.shape[0]):
        score = score + parts[q]
    score = torch.where(mask, score, torch.full((), -1e30))
    m = score.max(-1, keepdim=True).values
    p = torch.where(mask, torch.exp(score - m), torch.zeros(()))
    den = p.sum(-1, keepdim=True).clamp_min(1e-13)
    return torch.einsum("rt,rth->rh", p, states) / den


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


@pytest.mark.parametrize("h,t", [(h, t) for h in (384, 1024)
                                 for t in (1, 7, 30, 32, 33, 64)])
def test_wide_route_matches_jax_pool(h, t):
    """The widths the resident kernel cannot hold: 9 documents in float32
    against the JAX Pallas pool in interpret mode (block 16, time chunk 6:
    its online softmax sums in another order); rows 0 and 5 fully
    masked."""
    assert all(P.pool_route(h, t, dt) == "wide" for dt in (F32, BF16))
    args = _inputs(h + t, 9, t, h)
    got = wide_route(*map(torch.from_numpy, args))
    want = np.asarray(_pool_fused_impl(
        *map(jnp.asarray, args), block_r=16, time_chunk=6, interpret=True))
    assert got.shape == (9, h)
    assert _max_err(got, want) <= TOL
    empty = ~args[1].any(-1)
    assert empty.sum() >= 2
    assert not got[empty].any() and not want[empty].any()


# every width to 1,024 and dtype the wide route takes at the documents' Ld
TILED_CASES = [(h, dt) for dt in (F32, BF16) for h in range(128, 1025, 128)
               if P.pool_route(h, 30, dt) == "wide"]


@pytest.mark.parametrize("h,dtype", TILED_CASES)
def test_wide_route_matches_the_plain_version_to_1024(h, dtype):
    """13 documents of 30 tokens: the emulation against
    ``attn_pool_reference`` -- the wrapper's CPU route -- run in f32 on the
    same operands; fully masked rows exactly 0."""
    assert len(TILED_CASES) == 14
    s, mask, q, w, b = _rounded(_inputs(2 * h, 13, 30, h), dtype)
    got = wide_route(s, mask, q, w, b, dtype)
    ref = P.attn_pool(s, mask, q, w, b, device="cpu")
    assert (got[~mask.any(-1)] == 0).all()
    assert _max_err(got, ref) <= TOL


def test_split_tf32_product_is_float32_accurate():
    """The float32 score kernel's product, split TF32 in slabs of 32,
    keeps float32's accuracy where one TF32 product would not: at H =
    1,024 the projection is within 2^-20 of the largest |x| . |w| of the
    float64 product, a single TF32 product of the same operands is not."""
    args = _inputs(3, 6, 30, 1024)
    x = torch.from_numpy(args[0]).reshape(-1, 1024)
    w = torch.from_numpy(args[3])[:, :SCORE_COLS]
    want = x.double() @ w.double()
    bound = 2 ** -20 * float((x.abs().double() @ w.abs().double()).max())
    acc = split_mm(x, w, promote=SCORE_K // 8)
    assert float((acc.double() - want).abs().max()) <= bound
    one = (tf32(x).double() @ tf32(w).double())
    assert float((one - want).abs().max()) > bound


@pytest.mark.parametrize("r,t", [(24, 7), (9, 1), (17, 13)])
def test_wide_route_matches_jax_pool_at_1152(r, t):
    """H = 1,152 (nine column tiles): the emulation against the JAX Pallas
    pool in interpret mode and the plain version; rows off the JAX row
    tile, T = 1 and a T its time chunk does not divide."""
    h = 1152
    assert jax_pool_supported(h, r) and P.pool_supported(h, r)
    assert all(P.pool_route(h, t, dt) == "wide" for dt in (F32, BF16))
    args = _inputs(3, r, t, h)
    want = np.asarray(_pool_fused_impl(*map(jnp.asarray, args),
                                       interpret=True))
    s, mask, q, w, b = map(torch.from_numpy, args)
    got = wide_route(s, mask, q, w, b)
    assert not got[~mask.any(-1)].any()
    assert _max_err(got, want) <= TOL
    assert _max_err(got, P.attn_pool_reference(s, mask, q, w, b)) <= TOL


@pytest.mark.parametrize("r,t,h", [(9, 5, 2304), (8, 3, 4096)])
def test_wide_route_matches_the_plain_version(r, t, h):
    """The CARS-GRU doc pool at --nhid 1,152 (2,304) and 2,048 (4,096)
    against ``attn_pool_reference`` -- the wrapper's CPU route -- on the
    same operands; fully masked rows exactly 0."""
    s, mask, q, w, b = map(torch.from_numpy, _inputs(5, r, t, h))
    got = wide_route(s, mask, q, w, b)
    ref = P.attn_pool(s, mask, q, w, b, device="cpu")
    assert (got[~mask.any(-1)] == 0).all()
    assert _max_err(got, ref) <= TOL


def test_partials_sum_to_the_scores():
    """A token's partials, one a column tile, add up to its score
    ``tanh(states @ W_p + b_p) . query``."""
    s, mask, q, w, b = map(torch.from_numpy, _inputs(7, 10, 4, 384))
    parts = score_partials(s, q, w, b)
    assert parts.shape == (3, 10, 4)
    full = torch.einsum("rth,rh->rt", torch.tanh(s @ w + b), q)
    assert _max_err(parts.sum(0), full) <= TOL


def test_bf16_operands_match_the_plain_version_in_f32():
    """On bf16-rounded operands (what the bf16 kernel reads) the emulation
    in f32 matches the plain version run in f32 on the same values: the
    kernel's products accumulate in f32 and it rounds only its output."""
    s, mask, q, w, b = _rounded(_inputs(9, 12, 6, 1280), BF16)
    got = wide_route(s, mask, q, w, b, BF16)
    assert _max_err(got, P.attn_pool_reference(s, mask, q, w, b)) <= TOL


def test_pool_supported_is_the_jax_gate():
    """Every multiple of 64 up to 4,096 at 7, 8, 9 and 16,000 rows: the
    port's gate equals the JAX one (every multiple of 128 from 8 rows),
    and past 1,024 units the wide route takes it."""
    for h in range(64, 4097, 64):
        for rows in (7, 8, 9, 16000):
            assert P.pool_supported(h, rows) is \
                jax_pool_supported(h, rows), (h, rows)
            assert P.pool_supported(h, rows) is \
                P.pool_jax_gate(h, rows), (h, rows)
        for dt in (F32, BF16):
            route = P.pool_route(h, 30, dt)
            assert (route is None) is (h % 128 != 0), (h, dt)
            if h > 1024 and h % 128 == 0:
                assert route == "wide", (h, dt)


def _expected_route(h, t, dtype):
    """The rule written out: the resident kernel for bf16 at H = 128 / 256
    with 1 <= T <= 64, the wide route for every other shape."""
    return ("resident" if dtype == BF16 and h in (128, 256) and 1 <= t <= 64
            else "wide")


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_pool_route_at_every_width(dtype):
    for h in range(128, 4097, 128):
        for t in (0, 1, 32, 33, 64, 65):
            assert P.pool_route(h, t, dtype) == _expected_route(h, t, dtype)
            assert P.pool_route(h, t, dtype, wide=True) == "wide"
        assert P.pool_route(h + 64, 30, dtype) is None
        assert P.pool_route(h, -1, dtype) is None
    assert P.pool_route(0, 30, dtype) is None
    assert P.pool_route(256, 30, torch.float16) is None


@pytest.mark.parametrize("hidden", [2304, 4096])
def test_attention_pool_plain_on_cpu_past_1024(hidden):
    """A kernel-enabled pool on CPU tensors at a wide-route width runs the
    plain formulation and equals the pool built without the kernel."""
    s, mask, q, _, _ = map(torch.from_numpy, _inputs(11, 9, 3, hidden))
    pools = [AttentionPool(hidden, hidden, use_query=True, device="cpu",
                           use_kernel=k) for k in (True, False)]
    reset_parameters(pools[0], 0)
    pools[1].load_state_dict(pools[0].state_dict())
    with torch.no_grad():
        a, b = (p(s, mask, q) for p in pools)
    assert torch.equal(a, b)
