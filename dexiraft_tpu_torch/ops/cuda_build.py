"""Build and load the port's hand-written CUDA kernels.

Each kernel library is compiled from the package's ``csrc/`` sources by one
``nvcc`` call into a shared library with a plain C interface, and loaded
with ctypes. No source includes a PyTorch header, so a build takes
seconds. The build happens at first use, never at import (this module
only computes paths until ``load_library`` is called), into
``dexiraft_tpu_torch/_build/``, keyed by a hash of the sources and flags
so an edited source is rebuilt.

Build flags: ``-gencode=arch=compute_90a,code=sm_90a -O3`` (Hopper; the
``a`` target is the one that exposes wgmma and setmaxnreg).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, nvcc on PATH, or
    /usr/local/cuda/bin/nvcc. Raises if none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found (looked at $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def library_path(name: str, sources: Sequence[str]) -> str:
    """Where the library built from ``sources`` (names under csrc/) lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(set(sources) | set(_headers())):
        with open(os.path.join(CSRC_DIR, src), "rb") as f:
            h.update(src.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def _headers():
    return [f for f in os.listdir(CSRC_DIR) if f.endswith((".h", ".cuh"))]


def build_library(name: str, sources: Sequence[str]) -> str:
    """Compile ``sources`` into the keyed shared library if it is not built
    yet; returns its path. Raises with nvcc's output when the build fails."""
    out = library_path(name, sources)
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp,
           *[os.path.join(CSRC_DIR, s) for s in sources]]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {name} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(build_library(name, sources))
    return lib
