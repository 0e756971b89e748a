"""The port's LSTM training pair (``ops/kernels/lstm.py`` kernels 4 and 5,
plain versions on the CPU) and the encoders that train through it, against
the JAX package at f32.

The JAX kernels run in Pallas interpret mode, as tests/test_pallas_lstm.py
runs them.  Shapes are deliberately awkward: B off the JAX row block (16),
T off the time chunk (4), a length-0 row.  Tolerances: forward outputs and
boundaries 2e-5 abs (f32 sums of 256 terms in another order); gradients
2e-5 times the largest magnitude of the JAX gradient (dW sums B*T terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from context_attentive_ir_tpu.ops.pallas.lstm import (
    _lstm_fused_bwd_impl,
    _lstm_fused_res_impl,
    lstm_pallas_reference,
)
from context_attentive_ir_tpu.ops.rnn import RNNEncoder as JaxRNNEncoder
from context_attentive_ir_tpu_torch.ops import rnn as port_rnn
from context_attentive_ir_tpu_torch.ops.kernels.lstm import (
    chunk_len,
    lstm_fused,
    lstm_fused_bwd,
    lstm_fused_res,
    lstm_fused_res_reference,
    lstm_fused_train,
)
from context_attentive_ir_tpu_torch.ops.rnn import RNNEncoder

TOL = 2e-5
REL = 2e-5


def _inputs(seed, b=24, t=7, e=128, h=128):
    rng = np.random.RandomState(seed)
    x = (rng.normal(size=(b, t, e)) * 0.3).astype(np.float32)
    w_ih = (rng.normal(size=(e, 4 * h)) * 0.1).astype(np.float32)
    bias = (rng.normal(size=(4 * h,)) * 0.1).astype(np.float32)
    w_hh = (rng.normal(size=(h, 4 * h)) * 0.1).astype(np.float32)
    lens = rng.randint(0, t + 1, size=(b,))
    lens[0], lens[1] = t, 0
    mask = np.arange(t)[None, :] < lens[:, None]
    dout = rng.normal(size=(b, t, h)).astype(np.float32)
    return x, mask, w_ih, bias, w_hh, dout


def _np(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                      np.float32)


def _max_err(a, b):
    return float(np.max(np.abs(_np(a) - _np(b))))


def _close_rel(got, ref, rel=REL):
    scale = max(float(np.max(np.abs(_np(ref)))), 1e-30)
    assert _max_err(got, ref) <= rel * scale, (_max_err(got, ref), scale)


@pytest.mark.parametrize("reverse", [False, True])
def test_res_reference_matches_jax_res_kernel(reverse):
    x, mask, w_ih, bias, w_hh, _ = _inputs(0)
    out_j, hb_j, cb_j = _lstm_fused_res_impl(
        *map(jnp.asarray, (x, mask, w_ih, bias, w_hh)), reverse=reverse,
        block_b=16, time_chunk=4, interpret=True)
    out, hb, cb = lstm_fused_res(*map(torch.from_numpy,
                                      (x, mask, w_ih, bias, w_hh)),
                                 reverse=reverse, time_chunk=4, device="cpu")
    B = x.shape[0]
    assert out.shape == out_j.shape
    assert hb.shape == cb.shape == (hb_j.shape[0], B, w_hh.shape[0])
    assert _max_err(out, out_j) <= TOL
    assert _max_err(hb, np.asarray(hb_j)[:, :B]) <= TOL
    assert _max_err(cb, np.asarray(cb_j)[:, :B]) <= TOL
    # the first chunk processed starts from zeros
    first = -1 if reverse else 0
    assert float(hb[first].abs().max()) == 0.0
    # kernel 1's plain version is the same forward
    assert torch.equal(out, lstm_fused_res_reference(
        *map(torch.from_numpy, (x, mask, w_ih, bias, w_hh)), reverse)[0])


@pytest.mark.parametrize("reverse", [False, True])
def test_bwd_reference_matches_jax_bwd_kernel(reverse):
    x, mask, w_ih, bias, w_hh, dout = _inputs(1)
    jx = list(map(jnp.asarray, (x, mask, w_ih, bias, w_hh)))
    _, hb_j, cb_j = _lstm_fused_res_impl(*jx, reverse=reverse, block_b=16,
                                         time_chunk=4, interpret=True)
    ref = _lstm_fused_bwd_impl(*jx, hb_j, cb_j, jnp.asarray(dout),
                               reverse=reverse, block_b=16, time_chunk=4,
                               interpret=True)
    B = x.shape[0]
    got = lstm_fused_bwd(
        *map(torch.from_numpy, (x, mask, w_ih, bias, w_hh)),
        torch.from_numpy(np.array(hb_j[:, :B])),
        torch.from_numpy(np.array(cb_j[:, :B])), torch.from_numpy(dout),
        reverse=reverse, time_chunk=4, device="cpu")
    for name, g, r in zip(("dx", "dw_ih", "db", "dw_hh"), got, ref):
        assert g.shape == r.shape, name
        _close_rel(g, r)
    # masked steps have no input gradient
    assert float(got[0][~torch.from_numpy(mask)].abs().max()) == 0.0


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("time_chunk", [3, 6, 50])
def test_lstm_fused_train_grads_match_jax_vjp(reverse, time_chunk):
    """Autograd through kernels 4 and 5 (plain versions) against
    ``jax.vjp`` of the scan reference, at any chunk length (50 > T)."""
    x, mask, w_ih, bias, w_hh, dout = _inputs(2, b=11, t=7, e=24, h=16)

    def ref(x, w_ih, bias, w_hh):
        return lstm_pallas_reference(x @ w_ih + bias, jnp.asarray(mask),
                                     w_hh, reverse=reverse)

    out_j, vjp = jax.vjp(ref, *map(jnp.asarray, (x, w_ih, bias, w_hh)))
    grads_j = vjp(jnp.asarray(dout))
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (x, w_ih, bias, w_hh)]
    out = lstm_fused_train(leaves[0], torch.from_numpy(mask), *leaves[1:],
                           reverse=reverse, time_chunk=time_chunk,
                           device="cpu")
    assert _max_err(out, out_j) <= TOL
    out.backward(torch.from_numpy(dout))
    for leaf, g_j in zip(leaves, grads_j):
        _close_rel(leaf.grad, g_j)


def test_chunk_len_caps_at_the_sequence():
    assert chunk_len(30, 6) == 6 and chunk_len(4, 6) == 4
    assert chunk_len(0, 6) == 1
    x, mask, w_ih, bias, w_hh, _ = _inputs(3, b=5, t=4, e=8, h=4)
    _, hb, _ = lstm_fused_res(*map(torch.from_numpy,
                                   (x, mask, w_ih, bias, w_hh)),
                              time_chunk=6, device="cpu")
    assert hb.shape == (1, 5, 4)


def test_lstm_fused_refuses_to_drop_a_gradient():
    x, mask, w_ih, bias, w_hh, _ = _inputs(4, b=3, t=2, e=8, h=4)
    args = list(map(torch.from_numpy, (x, mask, w_ih, bias, w_hh)))
    args[2].requires_grad_()
    with pytest.raises(RuntimeError, match="lstm_fused_train"):
        lstm_fused(*args, device="cpu")
    with torch.no_grad():
        out = lstm_fused(*args, device="cpu")
    assert out.shape == (3, 2, 4)


def test_training_wrappers_need_the_requested_device(monkeypatch):
    x, mask, w_ih, bias, w_hh, dout = _inputs(5, b=3, t=2, e=8, h=4)
    args = list(map(torch.from_numpy, (x, mask, w_ih, bias, w_hh)))
    hb = torch.zeros(1, 3, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        lstm_fused_res(*args)
    with pytest.raises(RuntimeError, match="is_available"):
        lstm_fused_bwd(*args, hb, hb, torch.from_numpy(dout))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="device"):
        lstm_fused_res(*args)
    with pytest.raises(ValueError, match="device"):
        lstm_fused_bwd(*args, hb, hb, torch.from_numpy(dout))


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
    """With grad mode on, ``RNNEncoder(use_kernel=True)`` takes
    ``lstm_fused_train`` (never kernel 1), and its input and weight
    gradients equal the flax encoder's ``jax.grad``; under ``no_grad`` it
    takes ``lstm_fused``."""
    rng = np.random.RandomState(6)
    b, t, e, h = 9, 6, 24, 16
    x = (rng.normal(size=(b, t, e)) * 0.5).astype(np.float32)
    lens = rng.randint(0, t + 1, size=(b,))
    lens[0] = t
    mask = np.arange(t)[None, :] < lens[:, None]
    w_out = rng.normal(size=(b, t, 2 * h)).astype(np.float32)
    enc = JaxRNNEncoder(h, num_layers, "lstm", True, use_pallas=True)
    params = enc.init(jax.random.key(0), jnp.asarray(x),
                      jnp.asarray(mask))["params"]

    def loss_j(params, x):
        out, fin = enc.apply({"params": params}, x, jnp.asarray(mask))
        return jnp.sum(out * w_out) + jnp.sum(fin)

    (g_params, g_x) = jax.grad(loss_j, argnums=(0, 1))(params,
                                                       jnp.asarray(x))
    calls = []
    for name in ("lstm_fused", "lstm_fused_train"):
        fn = getattr(port_rnn, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(port_rnn, name, spy)
    port = RNNEncoder(e, h, num_layers, True, use_kernel=True, device="cpu")
    port.load_state_dict(_flat(jax.device_get(params)))
    xt = torch.from_numpy(x).requires_grad_()
    out, fin = port(xt, torch.from_numpy(mask))
    ((out * torch.from_numpy(w_out)).sum() + fin.sum()).backward()
    assert calls == ["lstm_fused_train"] * (2 * num_layers)
    _close_rel(xt.grad, g_x)
    flat_g = _flat(jax.device_get(g_params))
    for name, p in port.named_parameters():
        _close_rel(p.grad, flat_g[name])
    calls.clear()
    with torch.no_grad():
        port(xt, torch.from_numpy(mask))
    assert calls == ["lstm_fused"] * (2 * num_layers)


def test_encoder_dropout_between_layers():
    """Inter-layer dropout: identity when deterministic, seeded noise
    otherwise (reproducible from the generator's seed)."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.normal(size=(5, 4, 8)).astype(np.float32))
    mask = torch.ones(5, 4, dtype=torch.bool)
    enc = RNNEncoder(8, 4, 2, True, use_kernel=True, device="cpu",
                     dropout=0.5)
    with torch.no_grad():
        torch.manual_seed(0)
        for p in enc.parameters():
            p.normal_(0, 0.3)
        plain = RNNEncoder(8, 4, 2, True, use_kernel=True, device="cpu")
        plain.load_state_dict(enc.state_dict())
        det, _ = enc(x, mask)
        assert torch.equal(det, plain(x, mask)[0])

        def noisy(seed):
            gen = torch.Generator().manual_seed(seed)
            return enc(x, mask, deterministic=False, generator=gen)[0]

        assert torch.equal(noisy(1), noisy(1))
        assert not torch.equal(noisy(1), noisy(2))
        assert not torch.equal(noisy(1), det)
