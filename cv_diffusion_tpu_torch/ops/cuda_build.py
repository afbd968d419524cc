"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by one ``nvcc`` call for sm_90a into
a shared library with a plain C interface, in ``_build/`` (git-ignored),
named by a hash of the source and the flags, so a later process reuses it.
:func:`load` opens the library through ``ctypes`` at first use; nothing is
built or loaded when a module is imported.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from typing import Callable, Dict, NamedTuple

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(_PACKAGE_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
CUDA_ROOTS = ("/usr/local/cuda",)   # searched after PATH and $CUDA_HOME


class Built(NamedTuple):
    path: str      # the shared library
    log: str       # nvcc's output (ptxas register and shared-memory report)
    compiled: bool  # False when an earlier build was reused


def source(name: str) -> str:
    """Path of ``csrc/<name>``."""
    return os.path.join(CSRC_DIR, name)


def _nvcc(src: str) -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"),) + CUDA_ROOTS:
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under $CUDA_HOME or "
        f"/usr/local/cuda): the kernel is built from {src} with the CUDA "
        "toolkit")


def build(src: str) -> Built:
    """Compile ``src`` unless this source and these flags were built before;
    returns where the library is."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    path = os.path.join(BUILD_DIR, f"{stem}_{digest.hexdigest()[:16]}.so")
    log_path = path[:-3] + ".log"
    if os.path.exists(path):
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        return Built(path, log, False)
    nvcc = _nvcc(src)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, path)
    return Built(path, log, True)


_LOADED: Dict[str, object] = {}


def load(src: str, declare: Callable[[object], None]):
    """The ``ctypes.CDLL`` of ``src``, built if needed, with ``declare(lib)``
    run once to set every entry point's ``argtypes`` and ``restype``."""
    if src not in _LOADED:
        import ctypes

        lib = ctypes.CDLL(build(src).path)
        declare(lib)
        _LOADED[src] = lib
    return _LOADED[src]
