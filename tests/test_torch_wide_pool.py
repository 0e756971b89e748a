"""Kernel 10 past H = 1,024: the slate pool's wide route
(``csrc/slate_pool.cu``, ``ops/kernels/slate.py``).

- ``wide_route``, a plain-PyTorch emulation of the route's algorithm --
  the score kernel's partial scores ``tanh(states @ W_p[:, tile] +
  b_p[tile]) . query[tile]`` a column tile of 128 at a time, the pool
  kernel's sum of a token's partials in tile order, each document's masked
  softmax at once (masked tokens score -1e30 and weigh 0; a fully masked
  row pools to exactly 0) and the weighted sum divided by ``max(sum p,
  1e-13)`` -- against the JAX pool (``_pool_fused_impl``) in Pallas
  interpret mode at H = 1,152 and against ``attn_pool_reference`` at
  2,304 and 4,096.
- The gate at the new contract: ``pool_supported`` is the JAX gate at
  every multiple of 64 up to 4,096, and ``pool_wide`` the launcher's rule.

Tolerance: 1e-5 abs on f32 operands (the emulation and the references sum
the same f32 products in other orders; |pooled| <= 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from context_attentive_ir_tpu.ops.pallas.slate import _pool_fused_impl
from context_attentive_ir_tpu.ops.pallas.slate import (
    pool_supported as jax_pool_supported,
)
from context_attentive_ir_tpu_torch.ops.attention import AttentionPool
from context_attentive_ir_tpu_torch.ops.kernels import slate as P
from context_attentive_ir_tpu_torch.ops.layers import reset_parameters

TOL = 1e-5
SCORE_COLS = 128   # W_p columns of a score tile (kScoreCols)


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


def score_partials(states, query, w_p, b_p):
    """The score kernel: [H / 128, R, T] partial scores, one a column tile
    of W_p, each reduced over the tile's columns."""
    H = states.shape[-1]
    parts = []
    for c0 in range(0, H, SCORE_COLS):
        cols = slice(c0, c0 + SCORE_COLS)
        h = torch.tanh(states @ w_p[:, cols] + b_p[cols])
        parts.append(torch.einsum("rth,rh->rt", h, query[:, cols]))
    return torch.stack(parts)


def wide_route(states, mask, query, w_p, b_p):
    """The wide route end to end: the partials added in tile order, the
    masked softmax of each document's T scores at once, the pooled sum."""
    parts = score_partials(states, query, w_p, b_p)
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


@pytest.mark.parametrize("r,t", [(24, 7), (9, 1), (17, 13)])
def test_wide_route_matches_jax_pool_at_1152(r, t):
    """H = 1,152 (nine column tiles): the emulation against the JAX Pallas
    pool in interpret mode and the plain version; rows off the JAX row
    tile, T = 1 and a T its time chunk does not divide."""
    h = 1152
    assert jax_pool_supported(h, r) and P.pool_supported(h, r)
    assert P.pool_wide(h)
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
    args = _inputs(9, 12, 6, 1280)
    s, mask, q, w, b = (torch.from_numpy(a) for a in args)
    s, q, w, b = (t.bfloat16().float() for t in (s, q, w, b))
    got = wide_route(s, mask, q, w, b)
    assert _max_err(got, P.attn_pool_reference(s, mask, q, w, b)) <= TOL


def test_pool_supported_is_the_jax_gate():
    """Every multiple of 64 up to 4,096 at 7, 8, 9 and 16,000 rows: the
    port's gate equals the JAX one (every multiple of 128 from 8 rows),
    and past 1,024 units the wide route takes it."""
    assert P.CUDA_CORE_MAX_HIDDEN == 1024
    for h in range(64, 4097, 64):
        for rows in (7, 8, 9, 16000):
            assert P.pool_supported(h, rows) is \
                jax_pool_supported(h, rows), (h, rows)
            assert P.pool_supported(h, rows) is \
                P.pool_jax_gate(h, rows), (h, rows)
        assert P.pool_wide(h) is (h > 1024)


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
