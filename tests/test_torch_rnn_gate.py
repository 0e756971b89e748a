"""``RNNLayer``'s shape gate (``ops/rnn.py``): a shape the fused kernels do
not hold goes through ``lstm_scan`` / ``gru_scan`` as the JAX ``_pallas_ok``
sends it, a shape they hold goes through the kernel wrappers (their plain
versions on the CPU) and reads hT from the outputs; either way the layer,
the encoder and a whole CARS match the JAX package at f32 from the same
weights.  Tolerances: layer and encoder outputs 1e-5 abs, CARS scores 1e-4
abs (as ``tests/test_torch_cars.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cars import port_batch, port_model, tiny_setup

from context_attentive_ir_tpu.ops.rnn import RNNLayer as JaxRNNLayer
from context_attentive_ir_tpu_torch.ops import rnn as port_rnn
from context_attentive_ir_tpu_torch.ops.kernels.gru import gru_fused_supported
from context_attentive_ir_tpu_torch.ops.kernels.lstm import fused_supported
from context_attentive_ir_tpu_torch.ops.rnn import RNNLayer

TOL = 1e-5
BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("e,h,dtype,ok", [
    (256, 128, F32, True), (256, 128, BF16, True),
    (300, 100, BF16, True),          # padded to 320, 128 for the tiles
    (256, 403, F32, True),           # 4H * 36 * 4 = 232,128 <= 232,448
    (256, 449, BF16, False),         # kernel 9's tiles hold H <= 448
    (1485, 128, F32, True),          # (E + H) * 36 * 4 = 232,272
    (1487, 128, BF16, False),
    (64, 512, F32, False),           # 2H = 1024 threads, but 4H k-rows
    (64, 513, F32, False),           # 2H > 1024 threads
    (256, 128, torch.float16, False), (0, 128, F32, False)])
def test_gru_fused_supported_at_and_beyond_each_limit(e, h, dtype, ok):
    assert gru_fused_supported(e, h, 40, dtype) is ok
    assert gru_fused_supported(e, h, 0, dtype) is False


def _layer_inputs(seed, b, t, e):
    rng = np.random.RandomState(seed)
    x = (rng.normal(size=(b, t, e)) * 0.3).astype(np.float32)
    lens = rng.randint(1, t + 1, size=(b,))
    lens[0], lens[1] = t, 0
    mask = np.arange(t)[None, :] < lens[:, None]
    return x, mask


def _jax_layer(rnn_type, h, x, mask, seed=0):
    layer = JaxRNNLayer(features=h, rnn_type=rnn_type, use_pallas=True)
    params = layer.init(jax.random.key(seed), jnp.asarray(x),
                        jnp.asarray(mask))["params"]
    # the zero-initialised biases would hide a bias fault
    rng = np.random.RandomState(seed + 1)
    params = {k: (jnp.asarray(rng.normal(size=v.shape).astype(np.float32)
                              * 0.1) if k.startswith("b_") else v)
              for k, v in params.items()}
    out, final = layer.apply({"params": params}, jnp.asarray(x),
                             jnp.asarray(mask))
    return params, np.asarray(out), np.asarray(final)


def _port_layer(rnn_type, e, h, params, use_kernel=True):
    layer = RNNLayer(e, h, use_kernel=use_kernel, device="cpu",
                     rnn_type=rnn_type)
    layer.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in params.items()})
    return layer


def _count_calls(monkeypatch):
    """Count the kernel wrappers' and the scans' calls through the layer."""
    calls = {}
    for name in ("lstm_fused", "lstm_fused_train", "gru_fused",
                 "gru_fused_train", "lstm_scan", "gru_scan"):
        fn = getattr(port_rnn, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)

        monkeypatch.setattr(port_rnn, name, counted)
    return calls


# (rnn, E, H, the kernels hold it): H = 520 is beyond 2H <= 1024 threads,
# E = 1700 beyond the staged tile; an odd E and H stay with the kernels
# (float32 has no alignment rule; bfloat16 is zero-padded by the wrapper)
GATE_SHAPES = [("lstm", 24, 16, True), ("lstm", 37, 19, True),
               ("lstm", 12, 520, False), ("lstm", 1700, 8, False),
               ("gru", 24, 16, True), ("gru", 37, 19, True),
               ("gru", 12, 520, False), ("gru", 1700, 8, False)]


@pytest.mark.parametrize("rnn,e,h,held", GATE_SHAPES)
def test_layer_routes_by_shape_and_matches_jax(monkeypatch, rnn, e, h, held):
    supported = gru_fused_supported if rnn == "gru" else fused_supported
    assert supported(e, h, 5, F32) is held
    x, mask = _layer_inputs(3, 5, 4, e)
    params, out_j, final_j = _jax_layer(rnn, h, x, mask)
    layer = _port_layer(rnn, e, h, params)
    assert layer.kernel_ok(torch.from_numpy(x), None) is held
    calls = _count_calls(monkeypatch)
    with torch.no_grad():
        out, final = layer(torch.from_numpy(x), torch.from_numpy(mask))
    kernel, scan = f"{rnn}_fused", f"{rnn}_scan"
    assert calls == ({kernel: 2} if held else {scan: 2})
    assert out.shape == out_j.shape and final.shape == final_j.shape
    np.testing.assert_allclose(out.numpy(), out_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(final.numpy(), final_j, rtol=0, atol=TOL)


@pytest.mark.parametrize("rnn", ["lstm", "gru"])
def test_layer_refuses_card_tensors_beyond_the_limit(rnn):
    """On CUDA tensors the layer never leaves the kernels by itself: a shape
    they do not hold raises and names the way to the scan; a shape they hold,
    an initial state or ``use_kernel=False`` decide as on the CPU."""
    from types import SimpleNamespace

    def on_card(e):
        return SimpleNamespace(shape=(5, 4, e), is_cuda=True)

    layer = RNNLayer(12, 520, use_kernel=True, device="cpu", rnn_type=rnn)
    with pytest.raises(ValueError, match="use_kernel=False"):
        layer.kernel_ok(on_card(12), None)
    assert layer.kernel_ok(on_card(12), torch.zeros(5, 520)) is False
    assert RNNLayer(12, 520, use_kernel=False, device="cpu",
                    rnn_type=rnn).kernel_ok(on_card(12), None) is False
    assert RNNLayer(12, 16, use_kernel=True, device="cpu",
                    rnn_type=rnn).kernel_ok(on_card(12), None) is True


@pytest.mark.parametrize("rnn", ["lstm", "gru"])
def test_layer_trains_through_the_scan_beyond_the_limit(monkeypatch, rnn):
    """With a gradient needed, an unsupported shape still takes the scan
    (and autograd through it), a supported one the training pair."""
    x, mask = _layer_inputs(4, 4, 3, 10)
    for h, want in ((520, f"{rnn}_scan"), (16, f"{rnn}_fused_train")):
        layer = RNNLayer(10, h, use_kernel=True, device="cpu", rnn_type=rnn)
        gen = torch.Generator().manual_seed(h)
        with torch.no_grad():
            for p in layer.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
        calls = _count_calls(monkeypatch)
        out, _ = layer(torch.from_numpy(x), torch.from_numpy(mask))
        out.sum().backward()
        assert calls == {want: 2}
        assert all(p.grad is not None and torch.isfinite(p.grad).all()
                   for p in layer.parameters())
        monkeypatch.undo()


@pytest.mark.parametrize("rnn", ["lstm", "gru"])
def test_kernel_path_reads_hT_from_the_outputs(rnn):
    """The kernel branch reads hT as the JAX kernel branch does (the last
    valid output; the first for the reverse direction) and agrees with the
    scan's carried state on front-contiguous masks; an initial state or
    ``use_kernel=False`` takes the scan."""
    x, mask = _layer_inputs(5, 6, 5, 12)
    params, _, _ = _jax_layer(rnn, 8, x, mask)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    with torch.no_grad():
        out_k, fin_k = _port_layer(rnn, 12, 8, params)(xt, mt)
        plain = _port_layer(rnn, 12, 8, params, use_kernel=False)
        out_s, fin_s = plain(xt, mt)
    assert plain.kernel_ok(xt, None) is False
    assert _port_layer(rnn, 12, 8, params).kernel_ok(
        xt, torch.zeros(6, 8)) is False
    np.testing.assert_allclose(out_k.numpy(), out_s.numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(fin_k.numpy(), fin_s.numpy(), rtol=0, atol=TOL)
    last = (mask.sum(-1) - 1).clip(0)
    np.testing.assert_array_equal(
        fin_k[:, :8].numpy(), out_k[np.arange(6), last, :8].numpy())
    np.testing.assert_array_equal(fin_k[:, 8:].numpy(),
                                  out_k[:, 0, 8:].numpy())
    assert not fin_k[1].any()            # a length-0 row ends at zero


# CARS end to end: nhid beyond the float32 kernels' 2H <= 1024 threads goes
# through the scan in every encoder; an odd emsize stays with the kernels
CARS_CASES = [("nhid_beyond_the_limit", dict(nhid=520), "lstm_scan"),
              ("odd_emsize", dict(emsize=37), "lstm_fused"),
              ("gru_nhid_beyond_the_limit",
               dict(nhid=520, rnn_type="gru", session_rnn_type="gru"),
               "gru_scan")]


@pytest.mark.parametrize("name,overrides,route",
                         CARS_CASES, ids=[c[0] for c in CARS_CASES])
def test_cars_beyond_the_limits_matches_jax(monkeypatch, name, overrides,
                                            route):
    jm, cfg, params, batch, _, _ = tiny_setup(n_sessions=3, **overrides)
    assert cfg.use_pallas_rnn
    pm = port_model(cfg, params)
    calls = _count_calls(monkeypatch)
    with torch.no_grad():
        got = pm.score(port_batch(batch))
    ref = jm.apply({"params": params}, batch, method=jm.score)
    # query and document encoders, two directions each; the session
    # recurrences carry a state and never take a kernel
    kernels = {k: n for k, n in calls.items() if not k.endswith("_scan")}
    assert kernels == ({route: 4} if route.endswith("_fused") else {})
    assert calls.get(route, 0) >= 4
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)
