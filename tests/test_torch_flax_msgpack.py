"""The port's flax msgpack codec (``train/flax_msgpack.py``) against the
``msgpack`` package and ``flax.serialization``: every msgpack type in every
width decoded as ``msgpack.unpackb`` decodes it, and the types of a state
tree (maps with str keys, ints, strs) encoded to ``msgpack.packb``'s bytes,
anything else refused; flax trees both ways (the port's bytes of a state
tree equal flax's and restore through ``msgpack_restore``; flax's bytes,
numpy scalars and complex numbers included, decode to equal leaves),
bfloat16, int8, 0-d and empty arrays, and arrays split into chunks
(``MAX_CHUNK_SIZE`` lowered for the test in both packages)."""

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from context_attentive_ir_tpu_torch.train import flax_msgpack as fm

SCALARS = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1,
    2**32, 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
    -2**31 - 1, -2**63, 1.5, -0.0, float("inf"), 1e300,
    "", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 65536, "é∑",
    b"", b"x" * 255, b"y" * 256, b"z" * 65536,
]
CONTAINERS = [
    [], [1] * 15, [1] * 16, [2] * 65536, {}, {str(i): i for i in range(15)},
    {str(i): i for i in range(16)}, {str(i): i for i in range(65536)},
    {"a": [1, {"b": None}], "c": {"d": "e"}},
]
EXT_SIZES = [1, 2, 4, 8, 16, 3, 17, 255, 256, 65535, 65536]


def _state_typed(obj) -> bool:
    """True for what the encoder writes: ints, strs, str-keyed maps."""
    if isinstance(obj, dict):
        return all(isinstance(k, str) and _state_typed(v)
                   for k, v in obj.items())
    return isinstance(obj, (int, str)) and not isinstance(obj, bool)


@pytest.mark.parametrize("obj", SCALARS + CONTAINERS,
                         ids=lambda o: repr(o)[:24])
def test_every_type_and_width_both_ways(obj):
    ref = msgpack.packb(obj)
    if _state_typed(obj):
        assert fm.dumps(obj) == ref
    else:
        with pytest.raises(TypeError):
            fm.dumps(obj)
    back = fm.loads(ref)
    assert back == msgpack.unpackb(ref, raw=False, strict_map_key=False)
    assert type(back) is type(msgpack.unpackb(ref, strict_map_key=False))


def test_float32_decodes():
    ref = msgpack.packb(1.25, use_single_float=True)
    assert ref[0] == 0xCA and fm.loads(ref) == 1.25


@pytest.mark.parametrize("n", EXT_SIZES)
def test_ext_forms_decode(n):
    data = bytes(range(256)) * (n // 256) + bytes(range(n % 256))
    ref = msgpack.packb(msgpack.ExtType(42, data))
    assert fm.loads(ref) == fm.ExtType(42, data)


def test_bad_data_raises():
    with pytest.raises(ValueError):
        fm.loads(msgpack.packb([1, 2, 3])[:-1])
    with pytest.raises(ValueError):
        fm.loads(msgpack.packb(1) + b"\x01")
    with pytest.raises(ValueError):
        fm.loads(b"\xc1")
    with pytest.raises(TypeError):
        fm.dumps({"x": object()})


def _sorted(tree):
    """Keys in sorted order, as ``msgpack_serialize`` copies a tree (a
    ``tree_map``, which sorts dict keys)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _jax_tree():
    rng = np.random.RandomState(0)
    return _sorted({
        "params": {"w": rng.randn(3, 4).astype(np.float32),
                   "b16": jnp.asarray(rng.randn(5, 2), jnp.bfloat16),
                   "q": rng.randint(-128, 127, size=(7,)).astype(np.int8),
                   "f64": rng.randn(2).astype(np.float64),
                   "i64": np.arange(3, dtype=np.int64),
                   "empty": np.zeros((0, 4), np.float32),
                   "mask": np.array([True, False, True])},
        "step": np.array(7, np.int32), "count": 3,
        "scalar": np.float32(2.5), "cplx": 1 - 2j, "name": "x", "none": None,
        "masked": {},
    })


def _port_tree(tree):
    """The same tree with the arrays as torch tensors."""
    if isinstance(tree, dict):
        return {k: _port_tree(v) for k, v in tree.items()}
    if (isinstance(tree, (jnp.ndarray, np.ndarray))
            and tree.dtype == jnp.bfloat16):
        bits = np.asarray(tree).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    return tree


def _equal(got, want, path="tree"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want), path
    elif isinstance(got, torch.Tensor):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape, path
        if got.dtype == torch.bfloat16:
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16), path)
        else:
            assert got.numpy().dtype == want.dtype, path
            np.testing.assert_array_equal(got.numpy(), want, path)
    else:
        assert got == want and type(got) is type(want) or (
            isinstance(want, np.generic) and got == want.item()), path


def test_flax_bytes_decode_to_equal_leaves():
    tree = _jax_tree()
    _equal(fm.loads(serialization.msgpack_serialize(tree)), tree)


def test_port_bytes_equal_flax_and_restore_through_flax():
    tree = {k: v for k, v in _jax_tree().items()
            if k in ("count", "masked", "params", "step")}
    data = fm.dumps(_port_tree(tree))
    assert data == serialization.msgpack_serialize(tree)
    _equal(_port_tree(serialization.msgpack_restore(data)),
           _port_tree(tree))


@pytest.mark.parametrize("leaf", [
    None, True, 1.5, b"x", [1], (1,), np.int8(3), np.zeros(2, np.float32),
    1 - 2j, fm.ExtType(42, b"x")], ids=lambda o: type(o).__name__)
def test_encoder_refuses_what_no_state_holds(leaf):
    with pytest.raises(TypeError):
        fm.dumps({"params": {"w": torch.zeros(2)}, "x": leaf})
    with pytest.raises(TypeError):
        fm.dumps({1: torch.zeros(2)})


def test_decoded_arrays_are_their_own_memory():
    data = fm.dumps({"w": torch.arange(6, dtype=torch.float32)})
    w = fm.loads(bytearray(data))["w"]
    w += 1      # writable, and not a view of the (now changed) buffer
    assert fm.loads(data)["w"].tolist() == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_chunked_arrays_both_ways(monkeypatch, dtype):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(fm, "MAX_CHUNK_SIZE", 64)
    t = (torch.arange(300, dtype=torch.float32) * 0.25 - 20).to(dtype)
    t = t.reshape(3, 100)
    np_t = (t.view(torch.int16).numpy().view(jnp.bfloat16)
            if dtype == torch.bfloat16 else t.numpy())
    tree = {"big": np_t, "small": np.ones(2, np.float32)}
    ref = serialization.msgpack_serialize(tree)
    ported = {"big": t, "small": torch.ones(2)}
    data = fm.dumps(ported)
    assert data == ref
    assert b"__msgpack_chunked_array__" in data
    back = fm.loads(ref)
    assert back["big"].dtype == dtype and torch.equal(back["big"], t)
    restored = serialization.msgpack_restore(data)["big"]
    np.testing.assert_array_equal(np.asarray(restored).view(np.uint8),
                                  np_t.view(np.uint8))
