"""Build the port's CUDA sources into shared libraries with a plain C
interface, and load them with ctypes.

Each `csrc/<name>.cu` compiles with nvcc for sm_90a into
`dvg_tpu_torch/build/lib<name>-<hash>.so`, where the hash covers the source
and the flags, so an edited source never loads a stale library. The build
happens at first use, from the sources in the package. nvcc comes from
`$CUDA_HOME/bin`, then from PATH, then from the toolkit's default prefix
`/usr/local/cuda`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    candidates = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels build at first use")


def library_path(name: str) -> Tuple[Path, Path]:
    """(source, library) of kernel source `name`."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return src, BUILD / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> str:
    """Compile source `name` unless its library exists. Returns nvcc's
    output ('' when the library was already built); raises with that
    output if the compile fails."""
    src, lib = library_path(name)
    if lib.exists():
        return ""
    BUILD.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    res = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stdout}")
    os.replace(tmp, lib)
    return res.stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source `name`, built if needed."""
    with _lock:
        if name not in _loaded:
            build(name)
            _loaded[name] = ctypes.CDLL(str(library_path(name)[1]))
        return _loaded[name]
