"""ctypes binding for the port's native frame decoder
(`runtime/native/fastload.cpp`, a copy of `dvg_tpu`'s, C ABI
`dvg_decode_batch` / `dvg_version`): threaded PNG/JPEG decoding with a
bilinear resize into float32 batches.

The library builds at first use, never at import, with g++ into
`dvg_tpu_torch/build/libdvgload-<hash>.so`, where the hash covers the
source and the flags, so an edited source never loads a stale library. It
needs libpng, libjpeg and zlib with their headers. Where it cannot be
built, `is_available()` is False and `status()` says why; the frame
datasets then decode with the port's numpy decoder (`data/frames.py`), as
`dvg_tpu` decodes through PIL without its native library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SRC = Path(__file__).resolve().parent / "native" / "fastload.cpp"
BUILD = Path(__file__).resolve().parent.parent / "build"
# the flags of dvg_tpu/runtime/native/Makefile, so both libraries decode
# bit for bit alike
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
LIBS = ("-lpng", "-ljpeg", "-lz", "-lpthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_status: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(CXX_FLAGS + LIBS).encode()).hexdigest()
    return BUILD / f"libdvgload-{digest[:16]}.so"


def build() -> Path:
    """Compile the decoder unless its library exists; raises RuntimeError
    with the compiler's first error line if it cannot be built."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++ or $CXX) on PATH")
    BUILD.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC), *LIBS],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, timeout=300)
    if res.returncode:
        lines = res.stdout.strip().splitlines() or ["(no output)"]
        first = next((ln for ln in lines if "error" in ln), lines[-1])
        raise RuntimeError(f"{Path(cxx).name} failed: {first.strip()}")
    os.replace(tmp, lib)
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _status
    with _lock:
        if _status is None:
            try:
                lib = ctypes.CDLL(str(build()))
                lib.dvg_decode_batch.restype = ctypes.c_int
                lib.dvg_decode_batch.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_float), ctypes.c_int]
                if lib.dvg_version() != 1:
                    raise RuntimeError(f"dvg_version {lib.dvg_version()}, "
                                       "want 1")
                _lib, _status = lib, library_path().name
            except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
                _status = f"the native decoder is not built: {e}"
        return _lib


def is_available() -> bool:
    """Whether the native decoder is built and loaded (building it on the
    first call)."""
    return _load() is not None


def status() -> str:
    """The native decoder's library, or why it is not built."""
    _load()
    return _status


def decode_batch(paths: Sequence[str], height: int, width: int,
                 channels: int, out: Optional[np.ndarray] = None,
                 n_threads: int = 0) -> np.ndarray:
    """Decode `paths` into a (N, H, W, C) float32 array in [0, 1]; a file
    that is missing or does not decode raises IOError naming it.

    `out` may be any float32 C-contiguous array with N*H*W*C elements (e.g.
    a (T, B, H, W, C) batch buffer laid out so path k fills slot k)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(_status)
    n = len(paths)
    if out is None:
        out = np.empty((n, height, width, channels), np.float32)
    assert out.dtype == np.float32 and out.flags.c_contiguous
    assert out.size == n * height * width * channels
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    rc = lib.dvg_decode_batch(
        arr, n, height, width, channels,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads)
    if rc != 0:
        raise IOError(f"fastload failed on {paths[-rc - 1]!r}")
    return out
