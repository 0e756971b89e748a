"""The last ``ops`` modules of the JAX package in the port:
``GlobalAttention`` (dot / general / mlp), ``Highway``, ``Maxout`` and
``bilstm_scan``, each against the JAX module on the same seeded inputs,
with the JAX parameters carried over by ``convert.module_params_from_jax``
(f32; JAX at ``highest`` matmul precision, as the conftest sets it).
Tolerance: 1e-5 absolute on outputs of magnitude <= a few units (the
alignments, which sum to one, at 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from context_attentive_ir_tpu.ops import GlobalAttention as JaxAttention
from context_attentive_ir_tpu.ops import Highway as JaxHighway
from context_attentive_ir_tpu.ops import Maxout as JaxMaxout
from context_attentive_ir_tpu.ops.rnn import bilstm_scan as jax_bilstm
from context_attentive_ir_tpu_torch.convert import module_params_from_jax
from context_attentive_ir_tpu_torch.ops import (
    GlobalAttention,
    Highway,
    Maxout,
    bilstm_scan,
    lstm_scan,
)

TOL = 1e-5


def _port(module, params):
    module.load_state_dict(module_params_from_jax(
        module, jax.device_get(params)))
    return module


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("attn_type", ["dot", "general", "mlp"])
@pytest.mark.parametrize("rank", [3, 2])
def test_global_attention_matches_jax(attn_type, rank):
    rng = np.random.RandomState(0)
    B, Tq, S, H = 3, 4, 6, 8
    q = rng.randn(B, Tq, H).astype(np.float32)
    if rank == 2:
        q = q[:, 0]
    m = rng.randn(B, S, H).astype(np.float32)
    mask = np.arange(S)[None] < np.array([[6], [3], [1]])
    jm = JaxAttention(dim=H, attn_type=attn_type)
    params = jm.init(jax.random.key(1), q, m, mask)["params"]
    want_h, want_a = jm.apply({"params": params}, q, m, mask)
    pm = _port(GlobalAttention(H, attn_type, device="cpu"), params)
    got_h, got_a = pm(_t(q), _t(m), _t(mask))
    assert got_h.shape == want_h.shape and got_a.shape == want_a.shape
    np.testing.assert_allclose(got_h.detach().numpy(), want_h, atol=TOL)
    np.testing.assert_allclose(got_a.detach().numpy(), want_a, atol=1e-6)
    # masked memory slots get no weight
    assert float(got_a[..., 1:].reshape(B, -1)[2].abs().max()) == 0.0
    names = {"dot": {"linear_out.kernel"},
             "general": {"linear_in.kernel", "linear_out.kernel"},
             "mlp": {"query_proj.kernel", "query_proj.bias",
                     "memory_proj.kernel", "v", "linear_out.kernel",
                     "linear_out.bias"}}[attn_type]
    assert set(pm.state_dict()) == names


def test_global_attention_refuses_unknown_type():
    with pytest.raises(ValueError, match="attn_type"):
        GlobalAttention(8, "concat", device="cpu")


@pytest.mark.parametrize("num_layers", [1, 2])
def test_highway_matches_jax(num_layers):
    x = np.random.RandomState(2).randn(5, 7, 12).astype(np.float32)
    jm = JaxHighway(num_layers=num_layers)
    params = jm.init(jax.random.key(3), x)["params"]
    pm = _port(Highway(12, num_layers, device="cpu"), params)
    np.testing.assert_allclose(pm(_t(x)).detach().numpy(),
                               jm.apply({"params": params}, x), atol=TOL)
    assert {n.split(".")[0] for n in pm.state_dict()} == {
        f"{k}{i}" for k in ("lin", "gate") for i in range(num_layers)}


@pytest.mark.parametrize("pool_size", [2, 3])
def test_maxout_matches_jax(pool_size):
    x = np.random.RandomState(4).randn(6, 10).astype(np.float32)
    jm = JaxMaxout(features=5, pool_size=pool_size)
    params = jm.init(jax.random.key(5), x)["params"]
    pm = _port(Maxout(10, 5, pool_size, device="cpu"), params)
    got = pm(_t(x)).detach().numpy()
    assert got.shape == (6, 5)
    np.testing.assert_allclose(got, jm.apply({"params": params}, x),
                               atol=TOL)


def test_bilstm_scan_matches_jax_and_two_scans():
    rng = np.random.RandomState(6)
    B, T, H = 4, 7, 5
    xf, xb = (rng.randn(B, T, 4 * H).astype(np.float32) for _ in range(2))
    wf, wb = (rng.randn(H, 4 * H).astype(np.float32) * 0.3
              for _ in range(2))
    mask = np.arange(T)[None] < np.array([[7], [4], [1], [0]])
    want = jax_bilstm(jnp.asarray(xf), jnp.asarray(xb), jnp.asarray(mask),
                      jnp.asarray(wf), jnp.asarray(wb))
    got = bilstm_scan(_t(xf), _t(xb), _t(mask), _t(wf), _t(wb))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL)
    zeros = torch.zeros(B, H)
    of, (hf, _) = lstm_scan(_t(xf), _t(mask), _t(wf), zeros, zeros)
    ob, (hb, _) = lstm_scan(_t(xb), _t(mask), _t(wb), zeros, zeros,
                            reverse=True)
    for g, w in zip(got, (of, ob, hf, hb)):
        torch.testing.assert_close(g, w, rtol=0, atol=TOL)
