"""The port's LSTM recurrence on precomputed gates (``ops/kernels/lstm.py``
kernel 6: ``lstm_recurrence``, its plain version on the CPU) against the JAX
package's ``lstm_pallas`` at f32.

The Pallas kernel runs in interpret mode, as tests/test_pallas_lstm.py runs
it.  Shapes are awkward on purpose: B off the JAX row block (16), T off the
time chunk (4), front-contiguous masks with a full and an empty row, and
masks with interior gaps.  Tolerances: forward 2e-5 abs (f32 sums of 128
terms in another order); gradients 2e-5 times the largest magnitude of the
JAX gradient; ``matmul`` + recurrence against the port's fused plain
version 2e-5 abs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from context_attentive_ir_tpu.ops.pallas.lstm import (
    _lstm_pallas_fwd_impl,
    lstm_pallas,
    lstm_pallas_reference,
)
from context_attentive_ir_tpu_torch.ops.kernels import lstm as port_lstm
from context_attentive_ir_tpu_torch.ops.kernels.lstm import (
    lstm_fused_reference,
    lstm_recurrence,
    lstm_recurrence_fwd,
    lstm_recurrence_reference,
)

TOL = 2e-5
REL = 2e-5


def _inputs(seed, b=24, t=7, h=128, masks="front"):
    rng = np.random.RandomState(seed)
    x_proj = (rng.normal(size=(b, t, 4 * h)) * 0.5).astype(np.float32)
    w_hh = (rng.normal(size=(h, 4 * h)) * 0.3).astype(np.float32)
    if masks == "front":
        lens = rng.randint(0, t + 1, size=(b,))
        lens[0], lens[1] = t, 0
        mask = np.arange(t)[None, :] < lens[:, None]
    else:   # interior gaps
        mask = rng.rand(b, t) < 0.6
        mask[0], mask[1] = True, False
    return x_proj, mask, w_hh


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _max_err(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return float(np.max(np.abs(a - np.asarray(b))))


@pytest.mark.parametrize("masks", ["front", "interior"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", [(24, 7), (37, 5), (16, 8)])
def test_plain_version_matches_pallas_kernel(shape, reverse, masks):
    xp, mask, whh = _inputs(0, *shape, masks=masks)
    jx = [jnp.asarray(a) for a in (xp, mask, whh)]
    kernel = _lstm_pallas_fwd_impl(*jx, reverse=reverse, block_b=16,
                                   time_chunk=4, interpret=True)
    scan = lstm_pallas_reference(*jx, reverse=reverse)
    got = lstm_recurrence_reference(*_t(xp, mask, whh), reverse)
    assert got.dtype == torch.float32 and tuple(got.shape) == (*shape, 128)
    assert _max_err(got, kernel) <= TOL
    assert _max_err(got, scan) <= TOL
    assert (got.numpy()[~mask] == 0).all()


@pytest.mark.parametrize("reverse", [False, True])
def test_wrapper_takes_plain_version_on_cpu(reverse, monkeypatch):
    monkeypatch.setattr(lstm_recurrence, "launches", 0)
    xp, mask, whh = _t(*_inputs(1))
    want = lstm_recurrence_reference(xp, mask, whh, reverse)
    assert torch.equal(lstm_recurrence(xp, mask, whh, reverse, "cpu"), want)
    assert torch.equal(lstm_recurrence_fwd(xp, mask, whh, reverse, "cpu"),
                       want)
    assert lstm_recurrence.launches == 0


def test_reverse_carries_zeros_through_leading_padding():
    """A reversed walk over a front-contiguous mask starts on the padded
    steps: they must leave the state at zero, so the first valid step sees
    the same state as a sequence cut to its length."""
    xp, mask, whh = _inputs(2, b=6, t=9)
    mask[:] = np.arange(9)[None, :] < 4
    full = lstm_recurrence_reference(*_t(xp, mask, whh), True)
    cut = lstm_recurrence_reference(*_t(xp[:, :4], mask[:, :4], whh), True)
    assert torch.equal(full[:, :4], cut)
    assert (full[:, 4:] == 0).all()


@pytest.mark.parametrize("masks", ["front", "interior"])
@pytest.mark.parametrize("reverse", [False, True])
def test_gradients_match_jax_custom_vjp(reverse, masks):
    xp, mask, whh = _inputs(3, b=10, t=5, masks=masks)
    g = np.random.RandomState(4).normal(size=(10, 5, 128)).astype(np.float32)

    def loss(xp_, whh_):
        # the custom_vjp's backward is jax.vjp of the scan reference
        return jnp.sum(lstm_pallas_reference(xp_, jnp.asarray(mask), whh_,
                                             reverse=reverse)
                       * jnp.asarray(g))

    jdx, jdw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(xp),
                                              jnp.asarray(whh))
    txp, tmask, twhh = _t(xp, mask, whh)
    txp.requires_grad_()
    twhh.requires_grad_()
    out = lstm_recurrence(txp, tmask, twhh, reverse, "cpu")
    out.backward(torch.from_numpy(g))
    for got, want in ((txp.grad, jdx), (twhh.grad, jdw)):
        want = np.asarray(want)
        assert _max_err(got, want) <= REL * float(np.abs(want).max())


def test_jax_custom_vjp_is_the_reference_vjp():
    """``lstm_pallas``'s own gradient (its ``_bwd``) where the backend can
    run its forward; the port's Function mirrors that pairing."""
    xp, mask, whh = _inputs(5, b=16, t=4)
    from context_attentive_ir_tpu.ops.pallas.lstm import _bwd

    g = np.ones((16, 4, 128), np.float32)
    dxp, none, dwhh = _bwd(False, tuple(jnp.asarray(a) for a in
                                        (xp, mask, whh)), jnp.asarray(g))
    assert none is None
    txp, tmask, twhh = _t(xp, mask, whh)
    txp.requires_grad_()
    twhh.requires_grad_()
    lstm_recurrence(txp, tmask, twhh, False, "cpu").backward(
        torch.from_numpy(g))
    for got, want in ((txp.grad, dxp), (twhh.grad, dwhh)):
        want = np.asarray(want)
        assert _max_err(got, want) <= REL * float(np.abs(want).max())


@pytest.mark.parametrize("reverse", [False, True])
def test_matmul_then_recurrence_is_the_fused_lstm(reverse):
    rng = np.random.RandomState(6)
    b, t, e, h = 19, 6, 48, 128
    x = (rng.normal(size=(b, t, e)) * 0.3).astype(np.float32)
    w_ih = (rng.normal(size=(e, 4 * h)) * 0.1).astype(np.float32)
    bias = (rng.normal(size=(4 * h,)) * 0.1).astype(np.float32)
    _, mask, w_hh = _inputs(7, b, t, h)
    x, tmask, w_ih, bias, w_hh = _t(x, mask, w_ih, bias, w_hh)
    got = lstm_recurrence(torch.matmul(x, w_ih) + bias, tmask, w_hh, reverse,
                          "cpu")
    want = lstm_fused_reference(x, tmask, w_ih, bias, w_hh, reverse)
    assert _max_err(got, want.numpy()) <= TOL


def test_plain_version_rounds_h_like_the_kernel():
    """bf16: h is cast to ``w_hh``'s dtype before the product, gates and
    state stay f32, the output takes ``x_proj``'s dtype."""
    xp, mask, whh = _t(*_inputs(8, b=5, t=4))
    out = lstm_recurrence_reference(xp.bfloat16(), mask, whh.bfloat16())
    assert out.dtype == torch.bfloat16
    ref = lstm_recurrence_reference(xp.bfloat16().float(), mask,
                                    whh.bfloat16().float())
    assert _max_err(out.float(), ref.numpy()) <= 2e-2


def test_argument_checks():
    xp, mask, whh = _t(*_inputs(9, b=4, t=3))
    check = port_lstm._check_rec_args
    assert check(xp, mask, whh) == (4, 3, 128)
    with pytest.raises(TypeError, match="dtype"):
        check(xp.half(), mask, whh.half())
    with pytest.raises(TypeError, match="dtype"):
        check(xp, mask, whh.bfloat16())
    with pytest.raises(TypeError, match="bool"):
        check(xp, mask.float(), whh)
    with pytest.raises(ValueError, match="do not form"):
        check(xp, mask[:, :2], whh)
    with pytest.raises(ValueError, match="do not form"):
        check(xp, mask, whh[:64])
    with pytest.raises(ValueError, match="multiple of 128"):
        check(xp[..., :256].contiguous(), mask, whh[:64, :256].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        check(xp.transpose(0, 1).contiguous().transpose(0, 1), mask, whh)


def test_device_rules(monkeypatch):
    xp, mask, whh = _t(*_inputs(10, b=4, t=3))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        lstm_recurrence(xp, mask, whh)
    # with a card, CPU tensors handed to the CUDA wrapper raise
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="device"):
        lstm_recurrence(xp, mask, whh)
