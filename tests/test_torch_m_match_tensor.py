"""M-MatchTensor in the port against the JAX package at f32: the ``Conv``
layer against flax ``nn.Conv`` (kernel ``[kh, kw, in, out]``,
``padding="SAME"`` = one on each side of a 3x3 window) and ``max_pool``
against ``nn.max_pool`` (2x2 stride 2 ``VALID``: odd sizes floor), values
and gradients; then, through the checks of ``tests/test_torch_mnsrf.py``,
the parameter tree, the model (slate scores over the match tensor and
teacher-forced logits, ``decode_init``, ``decode_step``), the multitask
loss and every gradient, three SGD steps, the ``Engine`` (``rank_batch``,
beam-5 and greedy suggestions within and past ``suggest_max_clicks``,
``ServeError`` on the cached-document calls) and ``cli.main`` train ->
test.  Tolerances as stated there; the layers 1e-5 of the largest
reference value (sums of 45 products in another order), the match tensor
1e-6 abs.  The query and document lengths are odd
(5 and 7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from test_torch_mnsrf import (
    VARIANTS,
    check_decode,
    check_engine,
    check_forward,
    check_loss_and_grads,
    check_main,
    check_param_tree,
    check_three_sgd_steps,
    mt_setup,
    port_batch,
    port_model,
    variant_id,
)

from context_attentive_ir_tpu.models import build_model as jax_build_model
from context_attentive_ir_tpu_torch.config import ModelConfig as PortConfig
from context_attentive_ir_tpu_torch.models import (
    build_model,
    get_model_class,
    task_family,
)
from context_attentive_ir_tpu_torch.models.multitask.m_match_tensor import (
    MMatchTensor,
)
from context_attentive_ir_tpu_torch.ops.layers import Conv, max_pool


def _np(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                      np.float32)


# -- layers -------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(5, 7), (8, 6)])
def test_conv_matches_flax(hw):
    """Output size kept (SAME), one padded row / column on each side:
    values, the input gradient and both parameter gradients."""
    rng = np.random.RandomState(0)
    x = rng.normal(size=(3, *hw, 5)).astype(np.float32)
    w = rng.normal(size=(3, 4 * hw[0] * hw[1])).astype(np.float32)
    conv = nn.Conv(4, kernel_size=(3, 3), padding="SAME")
    params = conv.init(jax.random.key(0), jnp.asarray(x))["params"]
    params = {"kernel": np.array(params["kernel"]),
              "bias": rng.normal(size=4).astype(np.float32)}

    def f(p, xx):
        y = conv.apply({"params": p}, xx)
        return jnp.sum(y.reshape(3, -1) * w), y

    (val_j, y_j), (gp_j, gx_j) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    layer = Conv(5, 4, (3, 3), "SAME", device="cpu")
    assert tuple(layer.kernel.shape) == (3, 3, 5, 4)
    with torch.no_grad():
        layer.kernel.copy_(torch.from_numpy(params["kernel"]))
        layer.bias.copy_(torch.from_numpy(params["bias"]))
    xt = torch.from_numpy(x).requires_grad_()
    y = layer(xt)
    assert tuple(y.shape) == (3, *hw, 4)
    (y.reshape(3, -1) * torch.from_numpy(w)).sum().backward()
    for got, ref in ((y, y_j), (xt.grad, gx_j),
                     (layer.kernel.grad, gp_j["kernel"]),
                     (layer.bias.grad, gp_j["bias"])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(_np(got), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    # padding pinned at one on each side: a one-hot input at the corner
    # reaches output (i, j) < (2, 2) through kernel tap (1 - i, 1 - j)
    probe = torch.zeros(1, *hw, 5)
    probe[0, 0, 0, 0] = 1.0
    with torch.no_grad():
        out = layer(probe) - layer.bias
    ref = params["kernel"][:2, :2, 0][::-1, ::-1]
    np.testing.assert_allclose(_np(out[0, :2, :2]), ref, rtol=0, atol=1e-6)
    # an even window pads as flax does, (k - 1) // 2 before and k // 2
    # after (held to nn.Conv in tests/test_torch_rank_data.py)
    assert Conv(5, 4, (2, 3), "SAME", device="cpu").pad == ((0, 1), (1, 1))


def test_max_pool_matches_flax_floor_and_tie_gradients():
    """2x2 stride 2 over odd sizes (5 -> 2, 7 -> 3); on tied windows the
    gradient goes to the first maximum in both."""
    rng = np.random.RandomState(1)
    x = rng.randint(0, 3, size=(2, 5, 7, 3)).astype(np.float32)
    w = rng.normal(size=(2, 2, 3, 3)).astype(np.float32)

    def f(xx):
        y = nn.max_pool(xx, window_shape=(2, 2), strides=(2, 2))
        return jnp.sum(y * w), y

    (val_j, y_j), g_j = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = max_pool(xt, (2, 2), (2, 2))
    assert tuple(y.shape) == (2, 2, 3, 3)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(_np(y), np.asarray(y_j))
    np.testing.assert_allclose(_np(xt.grad), np.asarray(g_j), rtol=0,
                               atol=1e-6)
    assert np.count_nonzero(_np(xt.grad)) == y.numel()


def test_match_tensor_matches_jax():
    """The ``[B*S*N, Lq, Ld, C + 1]`` tensor: the masked channel products
    and the exact-match channel equal the JAX construction."""
    st = mt_setup("m_match_tensor")
    jm = jax_build_model(st.cfg)
    var = {"params": st.params}

    def jax_tensor(mdl, batch):
        q = mdl.embeddings.lookup_padded(batch.query, True)
        d = mdl.embeddings.lookup_padded(batch.docs, True)
        B, S, Lq = batch.query.shape
        N, Ld = batch.docs.shape[2:]
        qs, _ = mdl.query_encoder(q.reshape(B * S, Lq, -1),
                                  batch.query_mask.reshape(B * S, Lq), True)
        ds, _ = mdl.doc_encoder(d.reshape(B * S * N, Ld, -1),
                                batch.doc_mask.reshape(B * S * N, Ld), True)
        qp = mdl.q_proj(qs.reshape(B, S, Lq, -1))
        dp = mdl.d_proj(ds.reshape(B, S, N, Ld, -1))
        t = qp[:, :, None, :, None, :] * dp[:, :, :, None, :, :]
        ex = ((batch.query[:, :, None, :, None]
               == batch.docs[:, :, :, None, :])
              & (batch.query[:, :, None, :, None] != 0))
        t = jnp.concatenate([t, ex[..., None].astype(t.dtype)], -1)
        pm = (batch.query_mask[:, :, None, :, None]
              & batch.doc_mask[:, :, :, None, :])
        return (t * pm[..., None]).reshape(B * S * N, Lq, Ld, -1)

    ref = jax.jit(lambda v, b: jm.apply(v, b, method=jax_tensor))(
        var, st.batch)
    pm = port_model(st.cfg, st.params)
    b = port_batch(st.batch)
    with torch.no_grad():
        q_states, _ = pm.query_states(b)
        got = pm.match_tensor(b, q_states, pm.doc_states(b))
    assert got.shape == ref.shape and got.shape[-1] == st.cfg.nfilters + 1
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=0, atol=1e-6)
    assert float(got[..., -1].sum()) > 0   # some exact matches


# -- the model ---------------------------------------------------------------


@pytest.fixture(scope="module", params=VARIANTS, ids=variant_id)
def setup(request):
    return mt_setup("m_match_tensor", *request.param)


def test_param_tree_matches_jax(setup):
    check_param_tree(setup)


def test_forward_matches_jax(setup):
    check_forward(setup)


def test_loss_and_grads_match_jax(setup):
    check_loss_and_grads(setup)


def test_three_sgd_steps_match_jax(setup):
    check_three_sgd_steps(setup)


def test_decode_init_and_steps_match_jax(setup):
    check_decode(setup)


@pytest.fixture(scope="module")
def engine_setup():
    return mt_setup("m_match_tensor", "lstm", True, seed=1)


@pytest.mark.parametrize("beam_size", [5, 1])
def test_engine_matches_jax(engine_setup, beam_size):
    check_engine(engine_setup, beam_size)


def test_model_registry():
    assert task_family("m_match_tensor") == "multitask"
    assert get_model_class("m_match_tensor") is MMatchTensor
    cfg = PortConfig(model_type="m_match_tensor", vocab_size=20, emsize=8,
                     nhid=4, nfilters=3)
    model = build_model(cfg, device="cpu")
    assert isinstance(model, MMatchTensor)
    assert tuple(model.conv0.kernel.shape) == (3, 3, 4, 3)
    with pytest.raises(ValueError, match="m_match_tensor"):
        MMatchTensor(cfg.replace(model_type="mnsrf"), device="cpu")


def test_main_end_to_end(tmp_path):
    check_main(tmp_path, "m_match_tensor")
