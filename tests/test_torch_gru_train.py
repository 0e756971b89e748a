"""The port's GRU training pair (``ops/kernels/gru.py`` kernels 8 and 9,
plain versions on the CPU) and the encoders that train through it, against
the JAX package at f32.

The JAX kernels run in Pallas interpret mode, as tests/test_pallas_gru.py
runs them.  Shapes are deliberately awkward: B off the JAX row block (16),
T off the time chunk (7 with chunk 4, 15 with chunk 6), a length-0 row,
random biases.  Tolerances, tighter than tests/test_pallas_gru.py's
(forward 5e-4 abs / 2e-3 rel, gradients 3e-2 abs / 3e-3 rel): forward
outputs and boundaries 2e-5 abs (f32 sums of up to E + H terms in another
order); gradients 2e-5 times the largest magnitude of the JAX gradient (dW
sums B*T terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from context_attentive_ir_tpu.ops.pallas.gru import (
    _gru_fused_bwd_impl,
    _gru_fused_res_impl,
    gru_pallas_reference,
)
from context_attentive_ir_tpu.ops.rnn import RNNEncoder as JaxRNNEncoder
from context_attentive_ir_tpu_torch.ops import rnn as port_rnn
from context_attentive_ir_tpu_torch.ops.kernels.gru import (
    GRUFusedTrain,
    gru_fused_bwd,
    gru_fused_res,
    gru_fused_res_reference,
    gru_fused_train,
)
from context_attentive_ir_tpu_torch.ops.rnn import RNNEncoder

TOL = 2e-5
REL = 2e-5
NAMES = ("dx", "dw_ih", "db_ih", "dw_hh", "db_hh")


def _inputs(seed, b=24, t=7, e=128, h=128):
    rng = np.random.RandomState(seed)
    x = (rng.normal(size=(b, t, e)) * 0.3).astype(np.float32)
    w_ih = (rng.normal(size=(e, 3 * h)) * 0.1).astype(np.float32)
    b_ih = (rng.normal(size=(3 * h,)) * 0.1).astype(np.float32)
    w_hh = (rng.normal(size=(h, 3 * h)) * 0.1).astype(np.float32)
    b_hh = (rng.normal(size=(3 * h,)) * 0.1).astype(np.float32)
    lens = rng.randint(0, t + 1, size=(b,))
    lens[0], lens[1] = t, 0
    mask = np.arange(t)[None, :] < lens[:, None]
    dout = rng.normal(size=(b, t, h)).astype(np.float32)
    return (x, mask, w_ih, b_ih, w_hh, b_hh), dout


def _np(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                      np.float32)


def _max_err(a, b):
    return float(np.max(np.abs(_np(a) - _np(b))))


def _close_rel(got, ref, rel=REL):
    scale = max(float(np.max(np.abs(_np(ref)))), 1e-30)
    assert _max_err(got, ref) <= rel * scale, (_max_err(got, ref), scale)


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# (T, time chunk): T off the chunk both times; (15, 6) is the query
# encoder's own Lq with the training default chunk
SHAPES = [(7, 4), (15, 6)]


@pytest.mark.parametrize("t,tc", SHAPES)
@pytest.mark.parametrize("reverse", [False, True])
def test_res_reference_matches_jax_res_kernel(reverse, t, tc):
    """Kernel 8's plain version: ``(out, hb)`` against the Pallas residual
    kernel in interpret mode."""
    args, _ = _inputs(0, t=t)
    out_j, hb_j = _gru_fused_res_impl(*map(jnp.asarray, args),
                                      reverse=reverse, block_b=16,
                                      time_chunk=tc, interpret=True)
    out, hb = gru_fused_res(*_t(args), reverse=reverse, time_chunk=tc,
                            device="cpu")
    B, H = args[0].shape[0], args[4].shape[0]
    assert out.shape == out_j.shape
    assert hb.shape == (hb_j.shape[0], B, H)
    assert _max_err(out, out_j) <= TOL
    assert _max_err(hb, np.asarray(hb_j)[:, :B]) <= TOL
    # the first chunk processed starts from zeros
    assert float(hb[-1 if reverse else 0].abs().max()) == 0.0
    assert torch.equal(out, gru_fused_res_reference(*_t(args), reverse,
                                                    tc)[0])


@pytest.mark.parametrize("t,tc", SHAPES)
@pytest.mark.parametrize("reverse", [False, True])
def test_bwd_reference_matches_jax_bwd_kernel(reverse, t, tc):
    """Kernel 9's plain version: its five gradients against the Pallas
    backward kernel (interpret mode) on the Pallas residual kernel's
    ``hb``, and against ``jax.vjp`` of ``gru_pallas_reference``."""
    args, dout = _inputs(1, t=t)
    jx = list(map(jnp.asarray, args))
    _, hb_j = _gru_fused_res_impl(*jx, reverse=reverse, block_b=16,
                                  time_chunk=tc, interpret=True)
    kern = _gru_fused_bwd_impl(*jx, hb_j, jnp.asarray(dout),
                               reverse=reverse, block_b=16, time_chunk=tc,
                               interpret=True)
    _, vjp = jax.vjp(lambda x, wi, bi, wh, bh: gru_pallas_reference(
        x, jx[1], wi, bi, wh, bh, reverse=reverse),
        jx[0], *jx[2:])
    scan = vjp(jnp.asarray(dout))
    B = args[0].shape[0]
    got = gru_fused_bwd(*_t(args), torch.from_numpy(np.array(hb_j[:, :B])),
                        torch.from_numpy(dout), reverse=reverse,
                        time_chunk=tc, device="cpu")
    for name, g, k, s in zip(NAMES, got, kern, scan):
        assert g.shape == k.shape == s.shape, name
        _close_rel(g, k)
        _close_rel(g, s)
    # masked steps have no input gradient
    assert float(got[0][~torch.from_numpy(args[1])].abs().max()) == 0.0


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("time_chunk", [3, 6, 50])
def test_gru_fused_train_grads_match_jax_vjp(reverse, time_chunk):
    """Autograd through ``GRUFusedTrain`` (kernels 8 and 9, plain versions)
    against ``jax.vjp`` of the scan reference, at any chunk length (50 >
    T)."""
    args, dout = _inputs(2, b=11, t=7, e=24, h=16)
    x, mask, w_ih, b_ih, w_hh, b_hh = args

    def ref(x, w_ih, b_ih, w_hh, b_hh):
        return gru_pallas_reference(x, jnp.asarray(mask), w_ih, b_ih, w_hh,
                                    b_hh, reverse=reverse)

    out_j, vjp = jax.vjp(ref, *map(jnp.asarray, (x, w_ih, b_ih, w_hh,
                                                 b_hh)))
    grads_j = vjp(jnp.asarray(dout))
    leaves = [t.requires_grad_() for t in _t((x, w_ih, b_ih, w_hh, b_hh))]
    out = gru_fused_train(leaves[0], torch.from_numpy(mask), *leaves[1:],
                          reverse=reverse, time_chunk=time_chunk,
                          device="cpu")
    assert out.grad_fn is not None
    assert type(out.grad_fn).__name__ == GRUFusedTrain.__name__ + "Backward"
    assert _max_err(out, out_j) <= TOL
    out.backward(torch.from_numpy(dout))
    for leaf, g_j in zip(leaves, grads_j):
        _close_rel(leaf.grad, g_j)


def test_training_wrappers_need_the_requested_device(monkeypatch):
    args, dout = _inputs(3, b=3, t=2, e=8, h=4)
    args = _t(args)
    hb = torch.zeros(1, 3, 4)
    dout = torch.from_numpy(dout)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: gru_fused_res(*args),
                 lambda: gru_fused_bwd(*args, hb, dout),
                 lambda: gru_fused_train(*args)):
        with pytest.raises(RuntimeError, match="is_available"):
            call()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for call in (lambda: gru_fused_res(*args),
                 lambda: gru_fused_bwd(*args, hb, dout)):
        with pytest.raises(ValueError, match="device"):
            call()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = torch.from_numpy(np.array(v))
    return out


@pytest.mark.parametrize("num_layers", [1, 2])
def test_rnn_encoder_trains_through_the_pair(monkeypatch, num_layers):
    """With grad mode on, ``RNNEncoder(use_kernel=True, rnn_type="gru")``
    takes ``gru_fused_train`` (never kernel 7), and its input and weight
    gradients equal the flax encoder's ``jax.grad``; under ``no_grad`` it
    takes ``gru_fused``."""
    rng = np.random.RandomState(6)
    b, t, e, h = 9, 6, 24, 16
    x = (rng.normal(size=(b, t, e)) * 0.5).astype(np.float32)
    lens = rng.randint(0, t + 1, size=(b,))
    lens[0] = t
    mask = np.arange(t)[None, :] < lens[:, None]
    w_out = rng.normal(size=(b, t, 2 * h)).astype(np.float32)
    enc = JaxRNNEncoder(h, num_layers, "gru", True, use_pallas=True)
    params = jax.device_get(enc.init(jax.random.key(0), jnp.asarray(x),
                                     jnp.asarray(mask))["params"])
    params = jax.tree_util.tree_map(
        lambda v: v + rng.normal(size=v.shape).astype(np.float32) * 0.1,
        params)

    def loss_j(params, x):
        out, fin = enc.apply({"params": params}, x, jnp.asarray(mask))
        return jnp.sum(out * w_out) + jnp.sum(fin)

    g_params, g_x = jax.grad(loss_j, argnums=(0, 1))(params, jnp.asarray(x))
    calls = []
    for name in ("gru_fused", "gru_fused_train", "lstm_fused",
                 "lstm_fused_train"):
        fn = getattr(port_rnn, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(port_rnn, name, spy)
    port = RNNEncoder(e, h, num_layers, True, use_kernel=True, device="cpu",
                      rnn_type="gru")
    port.load_state_dict(_flat(params))
    xt = torch.from_numpy(x).requires_grad_()
    out, fin = port(xt, torch.from_numpy(mask))
    ((out * torch.from_numpy(w_out)).sum() + fin.sum()).backward()
    assert calls == ["gru_fused_train"] * (2 * num_layers)
    _close_rel(xt.grad, g_x)
    flat_g = _flat(g_params)
    assert {n for n, _ in port.named_parameters()} == set(flat_g)
    for name, p in port.named_parameters():
        _close_rel(p.grad, flat_g[name])
    calls.clear()
    with torch.no_grad():
        port(xt, torch.from_numpy(mask))
    assert calls == ["gru_fused"] * (2 * num_layers)
