"""Build and load the port's CUDA kernel library.

The sources ``context_attentive_ir_tpu_torch/csrc/*.cu`` (with their
shared ``*.cuh`` headers) export plain
``extern "C"`` launchers.  At first use they are compiled by ``nvcc`` for
``sm_90a`` -- one ``nvcc -c`` per source, all started together, then one
link -- into ``build/torch_kernels/libcair_torch_kernels.so`` beside the
package, and loaded with ``ctypes``.  The library is rebuilt whenever the
sources' or headers' hash changes.  Nothing here runs at import time, so the CPU tests
import the kernel modules without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
LIB_NAME = "libcair_torch_kernels.so"
GENCODE = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = GENCODE + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
# (argtypes, restype) of every exported function; pointers and the stream
# are c_void_p so ctypes never truncates them to 32 bits
SIGNATURES = {
    "cair_lstm_fwd": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
                      _I),
    "cair_lstm_fwd_res": ([_P] * 8 + [_I] * 7 + [_P], _I),
    "cair_lstm_rec": ([_P] * 4 + [_I] * 5 + [_P], _I),
    "cair_lstm_bwd_workspace": ([_I] * 6, ctypes.c_longlong),
    "cair_lstm_bwd": ([_P] * 15 + [_I] * 7 + [_P], _I),
    "cair_gru_fwd": ([_P] * 7 + [_I] * 6 + [_P], _I),
    "cair_gru_fwd_res": ([_P] * 8 + [_I] * 7 + [_P], _I),
    "cair_gru_bwd_workspace": ([_I] * 7, ctypes.c_longlong),
    "cair_gru_bwd": ([_P] * 16 + [_I] * 8 + [_P], _I),
    "cair_beamgen_occupancy": ([_I] * 5 + [_IP], _I),
    "cair_beamgen": ([_P, _P, _P] + [_I] * 7 + [_P] * 7 + [_I] * 4 + [_P],
                     _I),
    "cair_slate_pool": ([_P] * 6 + [_I] * 4 + [_P], _I),
    "cair_error_string": ([_I], ctypes.c_char_p),
}


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's "
                           "kernels are built on the machine with the card")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # the sources and their headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build(ptxas_info: bool = False) -> str:
    """Compile the library unless an up-to-date one exists.  Returns the
    compiler output (per-kernel registers and spills with ``ptxas_info``);
    raises with that output if a source does not compile."""
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _digest()
    if lib.is_file() and stamp.is_file() and stamp.read_text() == digest:
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    extra = ["-Xptxas=-v"] if ptxas_info else []
    procs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _obj, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}"
    link = subprocess.run(
        [nvcc, *GENCODE, "-shared", "-o", str(tmp),
         *[str(obj) for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return "\n".join(log)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The built library with every function's signature declared."""
    build()
    lib = ctypes.CDLL(str(BUILD_DIR / LIB_NAME))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(rc: int, launcher: str) -> None:
    """Raise if a launcher returned a CUDA error (an oversize shared tile,
    a hidden size the block cannot hold, a failed launch)."""
    if rc != 0:
        msg = load_library().cair_error_string(rc).decode()
        raise RuntimeError(f"{launcher} failed with CUDA error {rc}: {msg}")
