"""The port's fused LSTM (``ops/kernels/lstm.py``, plain version on the CPU)
and LSTM encoders against the JAX package at f32.

The JAX fused kernel runs in Pallas interpret mode, as in
tests/test_pallas_lstm.py.  Shapes are deliberately awkward: B not a
multiple of 16, T not a multiple of the time chunk, E not 128-aligned, and
a length-0 row.  Tolerance: max abs error 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from context_attentive_ir_tpu.ops.pallas.lstm import _lstm_fused_impl
from context_attentive_ir_tpu.ops.rnn import RNNEncoder as JaxRNNEncoder
from context_attentive_ir_tpu.ops.rnn import lstm_scan as jax_lstm_scan
from context_attentive_ir_tpu_torch.ops.kernels.lstm import (
    lstm_fused,
    lstm_fused_reference,
)
from context_attentive_ir_tpu_torch.ops.rnn import RNNEncoder, lstm_scan

TOL = 1e-5


def _inputs(seed, b=21, t=7, e=40, h=128):
    rng = np.random.RandomState(seed)
    x = (rng.normal(size=(b, t, e)) * 0.5).astype(np.float32)
    w_ih = (rng.normal(size=(e, 4 * h)) * 0.1).astype(np.float32)
    bias = (rng.normal(size=(4 * h,)) * 0.1).astype(np.float32)
    w_hh = (rng.normal(size=(h, 4 * h)) * 0.1).astype(np.float32)
    lens = rng.randint(0, t + 1, size=(b,))
    lens[0], lens[1] = t, 0
    mask = np.arange(t)[None, :] < lens[:, None]
    return x, mask, w_ih, bias, w_hh


def _np(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                      np.float32)


def _max_err(a, b):
    return float(np.max(np.abs(_np(a) - _np(b))))


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_fused_matches_jax_kernel(reverse):
    x, mask, w_ih, bias, w_hh = _inputs(0)
    ref = _lstm_fused_impl(*map(jnp.asarray, (x, mask, w_ih, bias, w_hh)),
                           reverse=reverse, block_b=16, time_chunk=4,
                           interpret=True)
    got = lstm_fused(*map(torch.from_numpy, (x, mask, w_ih, bias, w_hh)),
                     reverse=reverse, device="cpu")
    assert got.shape == ref.shape
    assert _max_err(got, ref) <= TOL
    assert bool((got[~torch.from_numpy(mask)] == 0).all())


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_fused_and_scan_match_jax_scan(reverse):
    x, mask, w_ih, bias, w_hh = _inputs(1, b=9, t=5, e=24, h=16)
    b, h = x.shape[0], w_hh.shape[0]
    zeros = np.zeros((b, h), np.float32)
    ref, (hT, cT) = jax_lstm_scan(jnp.asarray(x @ w_ih + bias),
                                  jnp.asarray(mask), jnp.asarray(w_hh),
                                  jnp.asarray(zeros), jnp.asarray(zeros),
                                  reverse=reverse)
    xt, mt, wt, bt, wht = map(torch.from_numpy, (x, mask, w_ih, bias, w_hh))
    assert _max_err(lstm_fused_reference(xt, mt, wt, bt, wht, reverse),
                    ref) <= TOL
    out, (h_p, c_p) = lstm_scan(xt @ wt + bt, mt, wht,
                                torch.zeros(b, h), torch.zeros(b, h),
                                reverse=reverse)
    assert _max_err(out, ref) <= TOL
    assert _max_err(h_p, hT) <= TOL and _max_err(c_p, cT) <= TOL


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = torch.from_numpy(np.array(v))
    return out


@pytest.mark.parametrize("num_layers", [1, 2])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_rnn_encoder_matches_flax(use_kernel, num_layers):
    """Port ``RNNEncoder`` (kernel path or scan path) vs the flax encoder
    with converted weights: token states and the final state ``hT``."""
    rng = np.random.RandomState(2)
    b, t, e, h = 11, 6, 24, 16
    x = (rng.normal(size=(b, t, e)) * 0.5).astype(np.float32)
    lens = rng.randint(0, t + 1, size=(b,))
    lens[0] = 0
    mask = np.arange(t)[None, :] < lens[:, None]
    enc = JaxRNNEncoder(h, num_layers, "lstm", True, use_pallas=use_kernel)
    params = enc.init(jax.random.key(0), jnp.asarray(x),
                      jnp.asarray(mask))["params"]
    out_j, fin_j = enc.apply({"params": params}, jnp.asarray(x),
                             jnp.asarray(mask))
    port = RNNEncoder(e, h, num_layers, True, use_kernel=use_kernel,
                      device="cpu")
    port.load_state_dict(_flat(jax.device_get(params)))
    out_p, fin_p = port(torch.from_numpy(x), torch.from_numpy(mask))
    assert out_p.shape == out_j.shape and fin_p.shape == fin_j.shape
    assert _max_err(out_p, out_j) <= TOL
    assert _max_err(fin_p, fin_j) <= TOL
