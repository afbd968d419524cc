"""Build and load the port's hand-written CUDA kernels and its native host
library.

Each CUDA source under ``csrc/`` is compiled by one ``nvcc`` call for
sm_90a into a shared library with a plain C interface, in ``_build/``
(git-ignored), named by a hash of the source and the flags, so a later
process reuses it. The C++ data loader (``csrc/dataloader.cc``) is built the
same way by one ``g++`` call (:func:`build_host`). :func:`load` opens a
library through ``ctypes`` at first use; nothing is built or loaded when a
module is imported.
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
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")


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


def _compile(src: str, compiler: Callable[[str], str], flags, libs=(),
             build_dir: str = None) -> Built:
    """Compile ``src`` with ``flags`` (then ``libs``) unless this source and
    these flags were built before; returns where the library is."""
    build_dir = build_dir or BUILD_DIR
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join((*flags, *libs)).encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    path = os.path.join(build_dir, f"{stem}_{digest.hexdigest()[:16]}.so")
    log_path = path[:-3] + ".log"
    if os.path.exists(path):
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        return Built(path, log, False)
    exe = compiler(src)
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [exe, *flags, "-o", tmp, src, *libs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        name = os.path.basename(exe)
        raise RuntimeError(f"{name} failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, path)
    return Built(path, log, True)


def build(src: str) -> Built:
    """Compile the CUDA source ``src`` with ``nvcc`` (once)."""
    return _compile(src, _nvcc, NVCC_FLAGS)


def _cxx(src: str) -> str:
    for name in (os.environ.get("CXX"), "g++", "c++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError(f"no C++ compiler (g++) on PATH to build {src}")


def build_host(src: str, libs=(), build_dir: str = None) -> Built:
    """Compile the C++ source ``src`` into a host shared library with
    ``g++`` (once), linking ``libs``."""
    return _compile(src, _cxx, CXX_FLAGS, libs, build_dir)


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
