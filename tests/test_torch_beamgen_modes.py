"""The fused generator's modes in the port (``ops/kernels/beamgen.py``,
plain version on the CPU) against the JAX package at f32: the int8 table
(``scale=``), the pruned selection (``prune=True``) and the pipelined
kernel (``pipeline=True``).

The JAX kernels run in Pallas interpret mode with the same flags, at a
row block and vocab tile that R = 53 and V = 999 are not multiples of.
Integer-valued data makes every product and sum exact, so values and
indices must match bit for bit; on random data indices match exactly and
values and lse within 1e-5 relative.  Every mode gives the same outputs as
the serial float kernel (the JAX package's contract).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from context_attentive_ir_tpu.ops.layers import (
    quantize_embedding_table as jax_quantize,
)
from context_attentive_ir_tpu.ops.pallas.beamgen import (
    generator_topk_lse as jax_kernel,
)
from context_attentive_ir_tpu.ops.pallas.beamgen import (
    generator_topk_lse_reference as jax_reference,
)
from context_attentive_ir_tpu_torch.ops.kernels.beamgen import (
    generator_topk_lse,
)

R, E, V = 53, 96, 999


def _data(seed, integer=False, int8=False, front=False):
    """x [R, E] and table_t [E, V] (int8 with its scale [V] when
    ``int8``); ``front`` puts every row's top scores in the first 256
    columns (one JAX vocab tile), so the pruned kernel really skips."""
    rng = np.random.RandomState(seed)
    if integer:
        x = rng.randint(-3, 4, size=(R, E)).astype(np.float32)
        t = rng.randint(-3, 4, size=(E, V)).astype(np.float32)
    else:
        x = (rng.normal(size=(R, E)) * 0.5).astype(np.float32)
        t = (rng.normal(size=(E, V)) * 0.5).astype(np.float32)
    if front:
        x = np.abs(x) + 0.1
        t[:, :256] = np.abs(t[:, :256]) + 1.0
        t[:, 256:] = -np.abs(t[:, 256:])
    if not int8:
        return x, t, None
    if integer:   # integer rows already, power-of-two scales: exact
        q = t.T.astype(np.int8)
        scale = 2.0 ** rng.randint(-3, 3, size=(V, 1)).astype(np.float32)
    else:
        q, scale = jax_quantize(t.T)
    return x, np.ascontiguousarray(q.T), scale.reshape(-1)


def _jax(x, t, scale, kc, **flags):
    s = None if scale is None else jnp.asarray(scale)
    kern = jax_kernel(jnp.asarray(x), jnp.asarray(t), kc, block_r=16,
                      block_v=256, interpret=True, scale=s, **flags)
    ref = jax_reference(jnp.asarray(x), jnp.asarray(t), kc, scale=s)
    return [tuple(np.asarray(a) for a in out) for out in (kern, ref)]


def _port(x, t, scale, kc, **flags):
    s = None if scale is None else torch.from_numpy(scale)
    return tuple(a.numpy() for a in generator_topk_lse(
        torch.from_numpy(x), torch.from_numpy(t), kc, scale=s, device="cpu",
        **flags))


MODES = [dict(int8=True, flags={}), dict(int8=True, flags={"prune": True}),
         dict(int8=False, flags={"prune": True}),
         dict(int8=False, flags={"pipeline": True})]
IDS = ["int8", "int8-prune", "prune", "pipeline"]


@pytest.mark.parametrize("kc", [2, 6])
@pytest.mark.parametrize("mode", MODES, ids=IDS)
def test_integer_data_bit_exact(mode, kc):
    x, t, scale = _data(0, integer=True, int8=mode["int8"])
    got = _port(x, t, scale, kc, **mode["flags"])
    for ref in _jax(x, t, scale, kc, **mode["flags"]):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("front", [False, True], ids=["random", "front"])
@pytest.mark.parametrize("kc", [2, 6])
@pytest.mark.parametrize("mode", MODES, ids=IDS)
def test_random_data_close(mode, kc, front):
    x, t, scale = _data(1, int8=mode["int8"], front=front)
    v, i, lse = _port(x, t, scale, kc, **mode["flags"])
    for rv, ri, rlse in _jax(x, t, scale, kc, **mode["flags"]):
        np.testing.assert_array_equal(i, ri)
        np.testing.assert_allclose(v, rv, rtol=1e-5, atol=0)
        np.testing.assert_allclose(lse, rlse, rtol=1e-5, atol=0)


def test_every_mode_equals_the_serial_float_kernel():
    """prune and pipeline are the same function as the serial kernel, in
    the port's plain version as in the JAX kernels."""
    x, t, _ = _data(2, front=True)
    base = _port(x, t, None, 6)
    for flags in ({"prune": True}, {"pipeline": True}):
        for a, b in zip(_port(x, t, None, 6, **flags), base):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(_jax(x, t, None, 6, **flags)[0],
                        _jax(x, t, None, 6)[0]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("flags,match", [
    ({"prune": True, "pipeline": True}, "prune"),
    ({"pipeline": True, "int8": True}, "int8"),
])
def test_refused_flag_pairs(flags, match):
    x, t, scale = _data(3, int8=flags.pop("int8", False))
    s = None if scale is None else torch.from_numpy(scale)
    with pytest.raises(ValueError, match=match):
        generator_topk_lse(torch.from_numpy(x), torch.from_numpy(t), 2,
                           scale=s, device="cpu", **flags)


def test_scale_must_cover_the_vocab():
    x, t, scale = _data(4, int8=True)
    with pytest.raises(ValueError, match="scale"):
        generator_topk_lse(torch.from_numpy(x), torch.from_numpy(t), 2,
                           scale=torch.from_numpy(scale[:-1]), device="cpu")
