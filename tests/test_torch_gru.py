"""The port's GRU forward against the JAX package at f32: ``gru_scan``, the
``RNNLayer`` / ``RNNEncoder`` GRU (scan path and the path through kernel
7, whose plain version runs on CPU tensors), and kernel 7's plain version
against the Pallas kernel in interpret mode (as tests/test_pallas_gru.py
runs it) and ``gru_pallas_reference``.

Inputs come from ``numpy.random.RandomState``; the biases are random, so
the separate ``b_hh`` of the n slot is exercised.  Every batch has a
length-0 row.  Tolerance: 2e-5 abs on outputs and final states (f32 sums
of up to E + H terms in another order), tighter than
tests/test_pallas_gru.py's 5e-4 abs / 2e-3 rel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from context_attentive_ir_tpu.ops.pallas.gru import (
    _gru_fused_impl,
    gru_pallas_reference,
)
from context_attentive_ir_tpu.ops.rnn import RNNEncoder as JaxRNNEncoder
from context_attentive_ir_tpu.ops.rnn import RNNLayer as JaxRNNLayer
from context_attentive_ir_tpu.ops.rnn import gru_scan as jax_gru_scan
from context_attentive_ir_tpu_torch.ops import rnn as port_rnn
from context_attentive_ir_tpu_torch.ops.kernels.gru import (
    _check_cuda_args,
    gru_fused,
    gru_fused_reference,
)
from context_attentive_ir_tpu_torch.ops.rnn import (
    RNNEncoder,
    RNNLayer,
    gru_scan,
)

TOL = 2e-5


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
    return x, mask, w_ih, b_ih, w_hh, b_hh


def _max_err(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return float(np.max(np.abs(a.astype(np.float32)
                               - np.asarray(b, np.float32))))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_scan_matches_jax(reverse):
    x, mask, w_ih, b_ih, w_hh, b_hh = _inputs(0, b=9, t=6, e=20, h=12)
    rng = np.random.RandomState(1)
    h0 = (rng.normal(size=(9, 12)) * 0.5).astype(np.float32)
    x_proj = x @ w_ih + b_ih
    out_j, h_j = jax_gru_scan(*map(jnp.asarray, (x_proj, mask, w_hh, b_hh,
                                                  h0)), reverse=reverse)
    out, h = gru_scan(*_t(x_proj, mask, w_hh, b_hh, h0), reverse=reverse)
    assert out.shape == out_j.shape and h.shape == h_j.shape
    assert _max_err(out, out_j) <= TOL
    assert _max_err(h, h_j) <= TOL
    # the length-0 row keeps its initial state and outputs zeros
    assert torch.equal(h[1], torch.from_numpy(h0[1]))
    assert float(out[1].abs().max()) == 0.0


def _jax_params(module, x, mask, seed):
    """The flax module's params with every bias replaced by random values
    (flax initialises them to 0), as numpy."""
    params = jax.device_get(module.init(jax.random.key(seed), jnp.asarray(x),
                                        jnp.asarray(mask))["params"])
    rng = np.random.RandomState(seed + 100)

    def fill(tree):
        return {k: fill(v) if isinstance(v, dict) else (
            (rng.normal(size=v.shape) * 0.2).astype(np.float32)
            if k.startswith("b_") else np.asarray(v)) for k, v in tree.items()}

    return fill(params)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = torch.from_numpy(np.array(v))
    return out


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_rnn_layer_gru_matches_jax(bidirectional, use_kernel):
    """``RNNLayer(rnn_type="gru")`` against the flax layer (scan path on
    the CPU): outputs and final state, through the scan or through kernel
    7's plain version (final state read from the outputs)."""
    x, mask, *_ = _inputs(2, b=10, t=7, e=24, h=16)
    jl = JaxRNNLayer(features=16, rnn_type="gru",
                     bidirectional=bidirectional)
    params = _jax_params(jl, x, mask, 0)
    out_j, fin_j = jl.apply({"params": params}, jnp.asarray(x),
                            jnp.asarray(mask))
    port = RNNLayer(24, 16, bidirectional, use_kernel, device="cpu",
                    rnn_type="gru")
    port.load_state_dict(_flat(params))
    with torch.no_grad():
        out, fin = port(*_t(x, mask))
    assert out.shape == out_j.shape and fin.shape == fin_j.shape
    assert _max_err(out, out_j) <= TOL
    assert _max_err(fin, fin_j) <= TOL


@pytest.mark.parametrize("num_layers", [1, 2])
def test_rnn_encoder_gru_matches_jax(monkeypatch, num_layers):
    """The stacked GRU encoder with ``use_kernel`` takes kernel 7 (plain
    version here) for every layer and direction under ``no_grad``, and
    matches the flax encoder."""
    x, mask, *_ = _inputs(3, b=11, t=6, e=20, h=12)
    enc = JaxRNNEncoder(12, num_layers, "gru", True)
    params = _jax_params(enc, x, mask, 1)
    out_j, fin_j = enc.apply({"params": params}, jnp.asarray(x),
                             jnp.asarray(mask))
    calls = []

    def spy(*a, **k):
        calls.append("gru_fused")
        return gru_fused(*a, **k)

    monkeypatch.setattr(port_rnn, "gru_fused", spy)
    port = RNNEncoder(20, 12, num_layers, True, use_kernel=True,
                      device="cpu", rnn_type="gru")
    port.load_state_dict(_flat(params))
    with torch.no_grad():
        out, fin = port(*_t(x, mask))
    assert calls == ["gru_fused"] * (2 * num_layers)
    assert _max_err(out, out_j) <= TOL
    assert _max_err(fin, fin_j) <= TOL


@pytest.mark.parametrize("e", [128, 300])
@pytest.mark.parametrize("reverse", [False, True])
def test_fused_reference_matches_pallas_kernel(reverse, e):
    """Kernel 7's plain version against the Pallas kernel (interpret mode,
    row block 16, time chunk 4 -- B and T off both) and the JAX scan
    reference; E = 300 is the GloVe width the Pallas kernel lane-pads."""
    x, mask, w_ih, b_ih, w_hh, b_hh = _inputs(4, e=e)
    jx = list(map(jnp.asarray, (x, mask, w_ih, b_ih, w_hh, b_hh)))
    kern = _gru_fused_impl(*jx, reverse=reverse, block_b=16, time_chunk=4,
                           interpret=True)
    ref = gru_pallas_reference(*jx, reverse=reverse)
    got = gru_fused(*_t(x, mask, w_ih, b_ih, w_hh, b_hh), reverse=reverse,
                    device="cpu")
    assert got.shape == kern.shape
    assert _max_err(got, kern) <= TOL
    assert _max_err(got, ref) <= TOL
    assert float(got[~torch.from_numpy(mask)].abs().max()) == 0.0
    assert torch.equal(got, gru_fused_reference(
        *_t(x, mask, w_ih, b_ih, w_hh, b_hh), reverse))


def test_gru_fused_refuses_to_drop_a_gradient():
    args = _t(*_inputs(5, b=3, t=2, e=8, h=4))
    args[4].requires_grad_()
    with pytest.raises(RuntimeError, match="gru_fused_train"):
        gru_fused(*args, device="cpu")
    with torch.no_grad():
        assert gru_fused(*args, device="cpu").shape == (3, 2, 4)


def test_gru_fused_needs_the_requested_device(monkeypatch):
    args = _t(*_inputs(6, b=3, t=2, e=8, h=4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        gru_fused(*args)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="device"):
        gru_fused(*args)


def test_launcher_argument_checks():
    """The CUDA launchers' checks (run before any pointer reaches the
    kernel): one float dtype, a bool mask, three gates and two biases,
    contiguous tensors."""
    x, mask, w_ih, b_ih, w_hh, b_hh = _t(*_inputs(7, b=3, t=2, e=8, h=4))
    assert _check_cuda_args("k", x, mask, w_ih, b_ih, w_hh, b_hh) == (3, 2,
                                                                      8, 4)
    with pytest.raises(TypeError, match="dtype"):
        _check_cuda_args("k", x, mask, w_ih, b_ih, w_hh, b_hh.double())
    with pytest.raises(TypeError, match="mask"):
        _check_cuda_args("k", x, mask.int(), w_ih, b_ih, w_hh, b_hh)
    good = dict(x=x, mask=mask, w_ih=w_ih, b_ih=b_ih, w_hh=w_hh, b_hh=b_hh)
    for bad in (dict(w_ih=w_ih[:, :8]), dict(b_hh=b_hh[:8]),
                dict(w_hh=torch.zeros(4, 16)), dict(mask=mask[:, :1])):
        args = {**good, **{k: v.contiguous() for k, v in bad.items()}}
        with pytest.raises(ValueError, match="one GRU"):
            _check_cuda_args("k", *args.values())
    with pytest.raises(ValueError, match="contiguous"):
        _check_cuda_args("k", x.transpose(0, 1).contiguous().transpose(0, 1),
                         mask, w_ih, b_ih, w_hh, b_hh)


def test_unknown_rnn_type_is_refused():
    with pytest.raises(ValueError, match="rnn_type"):
        RNNLayer(8, 4, device="cpu", rnn_type="rnn")
