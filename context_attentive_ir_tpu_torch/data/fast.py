"""ctypes bindings for the native vectorizer (``native/fastvec.cpp``): the
API of ``context_attentive_ir_tpu/data/fast.py`` (``FastVocab``,
``encode_batch``, ``encode_targets``, ``available``, ``get_lib``).

The library is built from the repository's source with ``g++`` at first
use, into ``build/torch_native/`` (apart from the JAX package's
``build/libfastvec.so``), and rebuilt when the source is newer.  The build
writes a temporary file and renames it into place, so processes that
build at once never load a half-written library.  Where ``g++`` or the
source is missing, ``available()`` is False and the callers vectorize in
Python (``data/vectorize.py``), which gives the same batches.

Tokens are whitespace-free and non-empty (``load_data`` splits on
whitespace): the native path joins a text's tokens with spaces and splits
them again in C++.  The library lowercases and splits ASCII only, while
the ``Dictionary`` looks a word up through ``normalize`` (NFD, Unicode
lowercase) and ``str.split`` splits on Unicode whitespace too; so a text
that is not plain ASCII is split and normalized here before the native
call, and every text encodes to the Python path's ids.
"""

from __future__ import annotations

import ctypes
import logging
import os
import re
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..constants import BOS, EOS
from .dictionary import Dictionary, normalize

logger = logging.getLogger(__name__)

_REPO = Path(__file__).resolve().parent.parent.parent
NATIVE_SRC = _REPO / "native"
NATIVE_BUILD = _REPO / "build" / "torch_native"


def build_native(name: str) -> Optional[Path]:
    """``build/torch_native/lib<name>.so`` from ``native/<name>.cpp``
    (built or rebuilt as needed), or None where it cannot be built."""
    src = NATIVE_SRC / f"{name}.cpp"
    lib = NATIVE_BUILD / f"lib{name}.so"
    if not src.exists():
        return None
    if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
        return lib
    try:
        NATIVE_BUILD.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=NATIVE_BUILD)
        os.close(fd)
        try:
            subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", "-shared",
                            "-o", tmp, str(src)], check=True,
                           capture_output=True, timeout=300)
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    except (OSError, subprocess.SubprocessError) as e:
        logger.info("native %s build unavailable: %s", name, e)
        return None
    return lib


def load_native(name: str) -> Optional[ctypes.CDLL]:
    path = build_native(name)
    if path is None:
        return None
    try:
        return ctypes.CDLL(str(path))
    except OSError as e:
        logger.info("native %s load failed: %s", name, e)
        return None


@lru_cache(maxsize=None)
def get_lib() -> Optional[ctypes.CDLL]:
    """The fastvec library with its signatures declared, or None."""
    lib = load_native("fastvec")
    if lib is None:
        return None
    i32p, u8p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8)
    lib.fv_vocab_create.restype = ctypes.c_void_p
    lib.fv_vocab_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_int32]
    lib.fv_vocab_free.restype = None
    lib.fv_vocab_free.argtypes = [ctypes.c_void_p]
    lib.fv_vocab_size.restype = ctypes.c_int32
    lib.fv_vocab_size.argtypes = [ctypes.c_void_p]
    lib.fv_encode_batch.restype = None
    lib.fv_encode_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
        ctypes.c_int32, i32p, u8p]
    lib.fv_encode_target.restype = None
    lib.fv_encode_target.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, u8p, ctypes.c_int32]
    return lib


# ASCII the library splits as ``str.split`` does: no \x1c-\x1f, which
# ``str.split`` takes for whitespace and the library does not
_NATIVE_SPLIT = re.compile(r"[^\x1c-\x1f]*\Z")


def available() -> bool:
    return get_lib() is not None


class FastVocab:
    """A native vocabulary built from a ``Dictionary``: its words in index
    order (specials included), so native ids are the Dictionary's."""

    def __init__(self, word_dict: Dictionary):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native fastvec unavailable")
        self._lib = lib
        words = [word_dict.ind2tok[i].encode("utf-8")
                 for i in range(len(word_dict))]
        arr = (ctypes.c_char_p * len(words))(*words)
        self.uncase = word_dict.uncase
        self._handle = lib.fv_vocab_create(arr, len(words),
                                           1 if self.uncase else 0)
        self.size = lib.fv_vocab_size(self._handle)

    def _bytes(self, text: str) -> bytes:
        """``text`` as the library must see it: plain ASCII as it is, any
        other text split by ``str.split`` and its words normalized as the
        ``Dictionary`` normalizes them (module docstring)."""
        if not (text.isascii() and _NATIVE_SPLIT.match(text)):
            text = " ".join(normalize(w, self.uncase) for w in text.split())
        return text.encode("utf-8")

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.fv_vocab_free(self._handle)
            self._handle = None

    def encode_batch(self, texts: Sequence[str], max_len: int
                     ) -> tuple[np.ndarray, np.ndarray]:
        """texts -> (ids [n, max_len] int32, mask [n, max_len] bool)."""
        n = len(texts)
        out = np.empty((n, max_len), np.int32)
        mask = np.empty((n, max_len), np.uint8)
        arr = (ctypes.c_char_p * n)(*[self._bytes(t) for t in texts])
        self._lib.fv_encode_batch(
            self._handle, arr, n, max_len,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out, mask.astype(bool)

    def encode_targets(self, texts: Sequence[str], max_len: int):
        """texts -> (tin, tout, tmask [n, max_len]): ``(BOS + ids)[:L]``,
        ``(ids + EOS)[:L]`` and the latter's mask."""
        n = len(texts)
        tin = np.empty((n, max_len), np.int32)
        tout = np.empty((n, max_len), np.int32)
        tmask = np.empty((n, max_len), np.uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        for i, t in enumerate(texts):
            self._lib.fv_encode_target(
                self._handle, self._bytes(t), BOS, EOS,
                tin[i].ctypes.data_as(i32p), tout[i].ctypes.data_as(i32p),
                tmask[i].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                max_len)
        return tin, tout, tmask.astype(bool)
