"""flax's msgpack format, read and written without ``flax`` or ``msgpack``.

The JAX package stores a train state with ``flax.serialization.to_bytes``:
the state dict (nested maps with string keys, ``"0"``, ``"1"``, ... for
tuples) packed by ``msgpack`` with flax's extension types
(``flax/serialization.py``, ``_MsgpackExtType``):

- code 1, an ndarray: the payload is itself the msgpack of ``[shape,
  dtype name, raw C-order bytes]``;
- code 2, a Python complex: the msgpack of ``[real, imag]``;
- code 3, a numpy scalar: an ndarray payload of shape ``[]``.

An array of more than ``MAX_CHUNK_SIZE`` bytes is stored as the map
``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...}, "chunks":
{"0": flat chunk, ...}}`` (chunks of ``MAX_CHUNK_SIZE // itemsize``
elements), because msgpack caps one object at 2**31 - 1 bytes.

``loads`` reads msgpack's types in every width, since the files come from
flax: nil, bool, int (fixint, 8 to 64 bits, signed and unsigned), float
32 / 64, str, bin, array and map (fix, 16 and 32-bit lengths) and ext
(fixext 1-16, ext 8 / 16 / 32).  ``dumps`` writes only what a state tree
holds: maps with str keys, ints and tensors, each in the narrowest form,
as ``msgpack.packb`` does, so the bytes equal flax's.  Arrays decode to CPU
``torch.Tensor``s (``bfloat16`` too: its bits travel as int16) and are
copied out of the buffer whole, never element by element.
"""

from __future__ import annotations

import struct
from typing import Any, NamedTuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3

# dtype name (numpy's) <-> torch dtype; bfloat16 has no numpy dtype here
_DTYPES = {
    "bool": torch.bool, "int8": torch.int8, "uint8": torch.uint8,
    "int16": torch.int16, "uint16": torch.uint16, "int32": torch.int32,
    "uint32": torch.uint32, "int64": torch.int64, "uint64": torch.uint64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
    "complex64": torch.complex64, "complex128": torch.complex128,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


class ExtType(NamedTuple):
    """An ext object whose code is not one of flax's."""

    code: int
    data: bytes


# -- encoding ----------------------------------------------------------------


def _np_bytes(t: torch.Tensor) -> tuple[str, memoryview]:
    """(dtype name, the C-order bytes) of a tensor, without an element
    loop."""
    if t.dtype not in _NAMES:
        raise TypeError(f"no msgpack dtype for {t.dtype}")
    t = t.detach().to("cpu").contiguous()
    raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    arr = raw.numpy().reshape(-1)
    return _NAMES[t.dtype], memoryview(arr.view(np.uint8))


class _Packer:
    """Writes what ``state_to_flax`` produces: maps with str keys, ints and
    tensors (flax's ndarray ext, chunked above ``MAX_CHUNK_SIZE`` bytes)."""

    def __init__(self):
        self.parts: list = []

    def out(self, fmt: str, *vals) -> None:
        self.parts.append(struct.pack(fmt, *vals))

    def pack(self, obj: Any) -> None:
        if isinstance(obj, bool):
            raise TypeError("cannot msgpack bool")
        if isinstance(obj, int):
            self.pack_int(obj)
        elif isinstance(obj, str):
            data = obj.encode("utf-8")
            self.header(len(data), 0xA0, 32, 0xD9, 0xDA, 0xDB)
            self.parts.append(data)
        elif isinstance(obj, dict):
            self.header(len(obj), 0x80, 16, None, 0xDE, 0xDF)
            for k, v in obj.items():
                if not isinstance(k, str):
                    raise TypeError(f"map key {k!r} is not a str")
                self.pack(k)
                self.pack(v)
        elif isinstance(obj, torch.Tensor):
            self.pack_array(obj)
        else:
            raise TypeError(f"cannot msgpack {type(obj).__name__}")

    def pack_int(self, x: int) -> None:
        if 0 <= x < 0x80 or -32 <= x < 0:
            self.out(">b" if x < 0 else ">B", x)
        elif x >= 0:
            for code, fmt, top in ((0xCC, ">BB", 0xFF), (0xCD, ">BH", 0xFFFF),
                                   (0xCE, ">BI", 0xFFFFFFFF),
                                   (0xCF, ">BQ", 2**64 - 1)):
                if x <= top:
                    return self.out(fmt, code, x)
            raise OverflowError(f"{x} does not fit msgpack's uint64")
        else:
            for code, fmt, low in ((0xD0, ">Bb", -0x80),
                                   (0xD1, ">Bh", -0x8000),
                                   (0xD2, ">Bi", -0x80000000),
                                   (0xD3, ">Bq", -2**63)):
                if x >= low:
                    return self.out(fmt, code, x)
            raise OverflowError(f"{x} does not fit msgpack's int64")

    def header(self, n: int, fix: int | None, fix_max: int, c8, c16,
               c32) -> None:
        """The length header of a str / bin / array / map."""
        if fix is not None and n < fix_max:
            self.out(">B", fix | n)
        elif c8 is not None and n <= 0xFF:
            self.out(">BB", c8, n)
        elif n <= 0xFFFF:
            self.out(">BH", c16, n)
        elif n <= 0xFFFFFFFF:
            self.out(">BI", c32, n)
        else:
            raise ValueError(f"msgpack object of {n} entries or bytes")

    def ext(self, code: int, payload: list) -> None:
        """An ext object; ``payload`` is a list of bytes-like parts."""
        n = sum(len(p) if isinstance(p, bytes) else p.nbytes
                for p in payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            self.out(">Bb", fixext[n], code)
        elif n <= 0xFF:
            self.out(">BBb", 0xC7, n, code)
        elif n <= 0xFFFF:
            self.out(">BHb", 0xC8, n, code)
        elif n <= 0xFFFFFFFF:
            self.out(">BIb", 0xC9, n, code)
        else:
            raise ValueError(f"msgpack ext payload of {n} bytes")
        self.parts.extend(payload)

    def pack_array(self, t: torch.Tensor) -> None:
        if t.numel() * t.element_size() > MAX_CHUNK_SIZE:
            flat = t.detach().reshape(-1)
            size = max(1, int(MAX_CHUNK_SIZE / t.element_size()))
            chunks = [flat[i:i + size] for i in range(0, flat.numel(), size)]
            self.header(3, 0x80, 16, None, 0xDE, 0xDF)
            self.pack(CHUNKED)
            self.parts.append(b"\xc3")     # True
            self.pack("shape")
            self.pack({str(i): d for i, d in enumerate(t.shape)})
            self.pack("chunks")
            self.pack({str(i): c for i, c in enumerate(chunks)})
        else:
            self.ext(EXT_NDARRAY, _ndarray_payload(t))


def _ndarray_payload(t: torch.Tensor) -> list:
    """flax's ``_ndarray_to_bytes``: the msgpack of [shape, dtype, bytes],
    as parts (the array's bytes are not copied here)."""
    name, data = _np_bytes(t)
    head = _Packer()
    head.header(3, 0x90, 16, None, 0xDC, 0xDD)
    head.header(t.dim(), 0x90, 16, None, 0xDC, 0xDD)
    for d in t.shape:
        head.pack_int(d)
    head.pack(name)
    head.header(data.nbytes, None, 0, 0xC4, 0xC5, 0xC6)
    return [b"".join(head.parts), data]


def dumps(obj: Any) -> bytes:
    """msgpack bytes of a state tree: maps with str keys, ints and tensors
    (flax's ndarray ext, chunked above ``MAX_CHUNK_SIZE`` bytes).  Anything
    else raises ``TypeError``."""
    p = _Packer()
    p.pack(obj)
    return b"".join(p.parts)


# -- decoding ----------------------------------------------------------------


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends inside an object")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        try:
            vals = struct.unpack_from(fmt, self.buf, self.pos)
        except struct.error as e:
            raise ValueError("msgpack data ends inside an object") from e
        self.pos += struct.calcsize(fmt)
        return vals[0]

    def read(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B",
                   0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I",
                   0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
                   0xC9: ">I"}
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack(lengths[b])))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str(self.unpack(lengths[b]))
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack(lengths[b]))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(lengths[b]))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack(lengths[b])
            return self.ext(self.unpack(">b"), n)
        if 0xD4 <= b <= 0xD8:
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        raise ValueError(f"invalid msgpack type byte 0x{b:02x}")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        if CHUNKED in out:
            return _unchunk(out)
        return out

    def ext(self, code: int, n: int) -> Any:
        end = self.pos + n
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            arr = self.ndarray()
            out = arr if code == EXT_NDARRAY else arr.item()
        elif code == EXT_COMPLEX:
            re, im = self.read()
            out = complex(re, im)
        else:
            return ExtType(code, bytes(self.take(n)))
        if self.pos != end:
            raise ValueError(f"msgpack ext {code}: payload of {n} bytes "
                             f"holds {self.pos - end + n}")
        return out

    def ndarray(self) -> torch.Tensor:
        """flax's ``_ndarray_from_bytes``, into a CPU tensor."""
        if self.unpack(">B") != 0x93:
            raise ValueError("flax ndarray payload is not [shape, dtype, "
                             "data]")
        shape, name = self.read(), self.read()
        b = self.unpack(">B")
        fmt = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}.get(b)
        if fmt is None:
            raise ValueError("flax ndarray data is not a msgpack bin")
        data = self.take(self.unpack(fmt))
        if isinstance(name, bytes):
            name = name.decode()
        if name not in _DTYPES:
            raise ValueError(f"flax ndarray of unknown dtype {name!r}")
        dtype = _DTYPES[name]
        width = torch.empty((), dtype=dtype).element_size()
        if len(data) != width * int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"flax ndarray {shape} {name}: {len(data)} "
                             "bytes")
        if not len(data):
            return torch.empty(shape, dtype=dtype)
        raw = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
        return raw.view(dtype).reshape(shape)


def _unchunk(d: dict) -> torch.Tensor:
    shape = [d["shape"][str(i)] for i in range(len(d["shape"]))]
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return torch.cat(chunks).reshape(shape)


def loads(data) -> Any:
    """The object of one msgpack document (bytes or any buffer): maps as
    dicts, arrays as lists, flax's ndarrays as CPU tensors (a chunked array
    joined again), its numpy scalars as Python numbers, other ext objects
    as ``ExtType``."""
    r = _Reader(data)
    out = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack "
                         "object")
    return out
