"""The port's fused generator step (``ops/kernels/beamgen.py``, plain
version on the CPU) and its decoders against the JAX package at f32.

The JAX kernel runs in Pallas interpret mode, as in
tests/test_pallas_beamgen.py.  Integer-valued data makes every product and
sum exact, so vals, idx and lse must match bit for bit; on random data idx
must match exactly and vals/lse within 1e-5 relative.  Ties must go to the
lower vocab index, as ``lax.top_k`` orders them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from context_attentive_ir_tpu.decode import beam_search as jax_beam_search
from context_attentive_ir_tpu.decode import greedy_decode as jax_greedy
from context_attentive_ir_tpu.ops.pallas.beamgen import (
    generator_topk_lse as jax_kernel,
)
from context_attentive_ir_tpu.ops.pallas.beamgen import (
    generator_topk_lse_reference as jax_reference,
)
from context_attentive_ir_tpu_torch.constants import EOS
from context_attentive_ir_tpu_torch.decode import beam_search, greedy_decode
from context_attentive_ir_tpu_torch.ops.kernels.beamgen import (
    generator_topk_lse,
)


def _data(seed, r=53, e=96, v=999, integer=False):
    """V = 999 is a multiple of no tile width."""
    rng = np.random.RandomState(seed)
    if integer:
        x = rng.randint(-3, 4, size=(r, e)).astype(np.float32)
        t = rng.randint(-3, 4, size=(e, v)).astype(np.float32)
    else:
        x = (rng.normal(size=(r, e)) * 0.5).astype(np.float32)
        t = (rng.normal(size=(e, v)) * 0.5).astype(np.float32)
    return x, t


def _jax_both(x, t, kc):
    kern = jax_kernel(jnp.asarray(x), jnp.asarray(t), kc, block_r=16,
                      block_v=256, interpret=True)
    ref = jax_reference(jnp.asarray(x), jnp.asarray(t), kc)
    return [tuple(np.asarray(a) for a in out) for out in (kern, ref)]


def _port(x, t, kc):
    return tuple(a.numpy() for a in generator_topk_lse(
        torch.from_numpy(x), torch.from_numpy(t), kc, device="cpu"))


@pytest.mark.parametrize("kc", [2, 6])
def test_integer_data_bit_exact(kc):
    x, t = _data(0, integer=True)
    got = _port(x, t, kc)
    for ref in _jax_both(x, t, kc):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kc", [2, 6])
def test_random_data_close(kc):
    x, t = _data(1)
    v, i, lse = _port(x, t, kc)
    for rv, ri, rlse in _jax_both(x, t, kc):
        np.testing.assert_array_equal(i, ri)
        np.testing.assert_allclose(v, rv, rtol=1e-5, atol=0)
        np.testing.assert_allclose(lse, rlse, rtol=1e-5, atol=0)


@pytest.mark.parametrize("kc", [2, 7])
def test_ties_go_to_the_lower_index(kc):
    """Columns repeat, so many values tie exactly, within and across the
    JAX kernel's vocab tiles."""
    x = np.ones((8, 8), np.float32)
    t = np.tile((np.arange(64) % 4)[None, :], (8, 1)).astype(np.float32) / 4
    v, i, _ = _port(x, t, kc)
    for rv, ri, _ in _jax_both(x, t, kc):
        np.testing.assert_array_equal(v, rv)
        np.testing.assert_array_equal(i, ri)
    assert i[0].tolist() == [3, 7, 11, 15, 19, 23, 27][:kc]


@pytest.mark.parametrize("kc", [0, 129, 1000])
def test_wrapper_rejects_kc_out_of_range(kc):
    """On CPU tensors the plain version takes any 1 <= kc <= V (here V =
    32); the kernels' own MAX_KC = 128 applies on CUDA tensors only."""
    x, t = _data(2, v=32)
    with pytest.raises(ValueError, match="kc"):
        generator_topk_lse(torch.from_numpy(x), torch.from_numpy(t), kc,
                           device="cpu")


# -- decoders: the port's fused step mode vs the JAX logits mode -----------

B, K, V, E, T = 5, 3, 97, 32, 9


def _toy(seed=3):
    """A tied linear decoder whose EOS logit grows with the step count, so
    every hypothesis ends before ``T`` and early exit skips steps."""
    rng = np.random.RandomState(seed)
    table = rng.normal(size=(V, E + 1)).astype(np.float32)
    table[:, E] = 0.0
    table[EOS, E] = 3.0
    w = (rng.normal(size=(E, E)) * 0.3).astype(np.float32)
    emb = (rng.normal(size=(V, E)) * 0.5).astype(np.float32)
    h0 = rng.normal(size=(B, E)).astype(np.float32)
    return table, w, emb, h0


def _jax_step(table, w, emb):
    table, w, emb = map(jnp.asarray, (table, w, emb))

    def step(state, tokens):
        h = state["h"] * 0.9 + jnp.take(emb, tokens, axis=0)
        t = state["t"] + 1.0
        proj = jnp.concatenate([jnp.tanh(h @ w), t[:, None]], -1)
        return {"h": h, "t": t}, proj @ table.T

    return step


def _port_step(table, w, emb, kc, calls):
    table_t = torch.from_numpy(np.ascontiguousarray(table.T))
    w, emb = torch.from_numpy(w), torch.from_numpy(emb)

    def step(state, tokens):
        calls.append(1)
        h = state["h"] * 0.9 + emb[tokens]
        t = state["t"] + 1.0
        proj = torch.cat([torch.tanh(h @ w), t[:, None]], -1)
        return {"h": h, "t": t}, generator_topk_lse(proj, table_t, kc,
                                                    device="cpu")

    return step


def _init(h0, framework):
    t0 = np.zeros((B,), np.float32)
    if framework == "jax":
        return {"h": jnp.asarray(h0), "t": jnp.asarray(t0)}
    return {"h": torch.from_numpy(h0), "t": torch.from_numpy(t0)}


@pytest.mark.parametrize("early_exit", [False, True])
def test_beam_search_matches_jax(early_exit):
    table, w, emb, h0 = _toy()
    ref_s, ref_sc = jax_beam_search(_jax_step(table, w, emb),
                                    _init(h0, "jax"), B, T, K, min_length=2,
                                    return_nbest=True, early_exit=early_exit)
    calls = []
    got_s, got_sc = beam_search(_port_step(table, w, emb, K + 1, calls),
                                _init(h0, "torch"), B, T, K, min_length=2,
                                return_nbest=True, early_exit=early_exit)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    np.testing.assert_allclose(got_sc.numpy(), np.asarray(ref_sc), rtol=0,
                               atol=1e-5)
    assert (len(calls) < T) == early_exit
    best_s, best_sc = beam_search(_port_step(table, w, emb, K + 1, []),
                                  _init(h0, "torch"), B, T, K, min_length=2,
                                  early_exit=early_exit)
    np.testing.assert_array_equal(best_s.numpy(), got_s[:, 0].numpy())
    np.testing.assert_allclose(best_sc.numpy(), got_sc[:, 0].numpy())


@pytest.mark.parametrize("early_exit", [False, True])
def test_greedy_matches_jax(early_exit):
    table, w, emb, h0 = _toy()
    ref_s, ref_sc = jax_greedy(_jax_step(table, w, emb), _init(h0, "jax"),
                               B, T, min_length=2, early_exit=early_exit)
    calls = []
    got_s, got_sc = greedy_decode(_port_step(table, w, emb, 2, calls),
                                  _init(h0, "torch"), B, T, min_length=2,
                                  early_exit=early_exit)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    np.testing.assert_allclose(got_sc.numpy(), np.asarray(ref_sc), rtol=0,
                               atol=1e-5)
    assert (len(calls) < T) == early_exit


def test_fused_step_needs_a_spare_slot():
    table, w, emb, h0 = _toy()
    with pytest.raises(ValueError, match="K\\+1"):
        beam_search(_port_step(table, w, emb, K, []), _init(h0, "torch"),
                    B, T, K)
    with pytest.raises(ValueError, match="at least 2"):
        greedy_decode(_port_step(table, w, emb, 1, []), _init(h0, "torch"),
                      B, T)
