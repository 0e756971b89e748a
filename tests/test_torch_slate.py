"""The port's slate pool (kernel 10's plain version, ``ops/kernels/slate.py``)
against the JAX package at f32.

The JAX kernel runs in Pallas interpret mode, as in
tests/test_pallas_slate.py, at a row block (16) and time chunk (6) that
the test's R and T are not multiples of.  Pooled values agree within 1e-5
(the kernel's online softmax sums in another order than the two-pass
reference).  A fully masked row pools to exactly 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cars import port_batch, port_model, tiny_setup

from context_attentive_ir_tpu.models import build_model
from context_attentive_ir_tpu.ops.pallas.slate import (
    _pool_fused_impl,
)
from context_attentive_ir_tpu.ops.pallas.slate import (
    attn_pool_reference as jax_reference,
)
from context_attentive_ir_tpu_torch.ops.attention import AttentionPool
from context_attentive_ir_tpu_torch.ops.kernels.slate import (
    AttnPoolFn,
    attn_pool,
    attn_pool_reference,
    pool_supported,
)

TOL = 1e-5


def _inputs(seed, r=37, t=7, h=128):
    """R = 37 is off the 16-row block, T = 7 off the 6-step chunk; row 3
    is fully masked and row 0 fully valid."""
    rng = np.random.RandomState(seed)
    states = (rng.normal(size=(r, t, h)) * 0.5).astype(np.float32)
    query = (rng.normal(size=(r, h)) * 0.5).astype(np.float32)
    w_p = (rng.normal(size=(h, h)) * 0.15).astype(np.float32)
    b_p = (rng.normal(size=(h,)) * 0.1).astype(np.float32)
    lens = rng.randint(1, t + 1, size=(r,))
    lens[0], lens[3] = t, 0
    mask = np.arange(t)[None, :] < lens[:, None]
    return states * mask[:, :, None], mask, query, w_p, b_p


def _port(args):
    return attn_pool(*map(torch.from_numpy, args), device="cpu").numpy()


@pytest.mark.parametrize("r,t", [(37, 7), (16, 30), (9, 1)])
def test_pool_matches_jax_kernel_and_reference(r, t):
    args = _inputs(0, r, t)
    got = _port(args)
    jargs = tuple(map(jnp.asarray, args))
    kern = np.asarray(_pool_fused_impl(*jargs, block_r=16, time_chunk=6,
                                       interpret=True))
    ref = np.asarray(jax_reference(*jargs))
    np.testing.assert_allclose(got, kern, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    masked = ~args[1].any(-1)
    assert (got[masked] == 0).all() and (kern[masked] == 0).all()


def test_pool_gradients_match_jax_vjp():
    s, m, q, w, b = _inputs(1, 21, 5)
    g = np.random.RandomState(2).normal(size=(21, 128)).astype(np.float32)
    _, vjp = jax.vjp(lambda s_, q_, w_, b_: jax_reference(s_, jnp.asarray(m),
                                                          q_, w_, b_),
                     *map(jnp.asarray, (s, q, w, b)))
    want = vjp(jnp.asarray(g))
    inputs = [torch.from_numpy(a).requires_grad_() for a in (s, q, w, b)]
    out = AttnPoolFn.apply(inputs[0], torch.from_numpy(m), *inputs[1:],
                           "cpu")
    out.backward(torch.from_numpy(g))
    for name, t, ref in zip(("states", "query", "w_p", "b_p"), inputs,
                            want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=TOL, err_msg=name)


def test_pool_supported_contract():
    assert pool_supported(128, 8) and pool_supported(256, 16000)
    assert not pool_supported(96, 64) and not pool_supported(256, 7)


def test_wrapper_on_cpu_runs_the_plain_version():
    args = tuple(map(torch.from_numpy, _inputs(3, 12, 4)))
    before = attn_pool.launches
    np.testing.assert_array_equal(attn_pool(*args, device="cpu").numpy(),
                                  attn_pool_reference(*args).numpy())
    assert attn_pool.launches == before
    with pytest.raises(ValueError, match="device"):
        attn_pool(*args, device="meta")


@pytest.mark.parametrize("use_kernel", [False, True])
def test_attention_pool_on_cpu_keeps_its_formulation(use_kernel):
    """With ``use_kernel`` the CPU pool still runs the module's own
    formulation (the kernel is for CUDA tensors): equal to the plain
    pool of kernel 10 on the same weights."""
    s, m, q, w, b = _inputs(4, 10, 6)
    pool = AttentionPool(128, 128, use_query=True, device="cpu",
                         use_kernel=use_kernel)
    with torch.no_grad():
        pool.proj_kernel.copy_(torch.from_numpy(w))
        pool.proj_bias.copy_(torch.from_numpy(b))
    lead = (2, 5)
    got = pool(torch.from_numpy(s).reshape(*lead, 6, 128),
               torch.from_numpy(m).reshape(*lead, 6),
               torch.from_numpy(q).reshape(*lead, 128))
    want = attn_pool_reference(*map(torch.from_numpy, (s, m, q, w, b)))
    np.testing.assert_allclose(got.reshape(10, 128).detach().numpy(),
                               want.numpy(), rtol=0, atol=TOL)


def test_cars_with_slate_flag_matches_jax():
    """CARS with ``use_pallas_slate`` (H2 = 128, the kernel's width): the
    port on the CPU equals the port without the flag and the JAX model
    with it (which runs its XLA pool off the TPU)."""
    _, cfg, _, batch, _, _ = tiny_setup()
    cfg = cfg.replace(nhid=64)
    params = jax.device_get(build_model(cfg).init(
        {"params": jax.random.key(0)}, batch, True)["params"])
    slate = cfg.replace(use_pallas_slate=True)
    want = np.asarray(build_model(slate).apply({"params": params}, batch,
                                               method="score"))
    pbatch = port_batch(batch)
    on, off = (port_model(c, params).score(pbatch).numpy()
               for c in (slate, cfg))
    np.testing.assert_array_equal(on, off)
    np.testing.assert_allclose(on, want, rtol=0, atol=1e-5)
