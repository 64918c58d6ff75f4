"""Build and load the port's hand-written CUDA kernels.

Each kernel library is compiled from the package's ``csrc/`` sources by one
``nvcc`` call into a shared library with a plain C interface, and loaded
with ctypes; ``build_libraries`` starts the calls of several libraries
together. No source includes a PyTorch header, so a build takes
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
from typing import Dict, Mapping, Sequence

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


def build_libraries(libraries: Mapping[str, Sequence[str]]) -> Dict[str, str]:
    """Compile each library (name -> sources under csrc/) that is not built
    yet, one ``nvcc`` process per library, all started together; returns
    name -> path. Raises with nvcc's output when a build fails (after
    every started build has ended)."""
    paths = {name: library_path(name, srcs) for name, srcs in libraries.items()}
    todo = [name for name, out in paths.items() if not os.path.isfile(out)]
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    started = []
    try:
        for name in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp,
                   *[os.path.join(CSRC_DIR, s) for s in libraries[name]]]
            started.append((name, tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failures = []
        for name, tmp, cmd, proc in started:
            log = proc.communicate()[0]
            if proc.returncode != 0:
                failures.append(f"nvcc failed building {name} (exit "
                                f"{proc.returncode}):\n{' '.join(cmd)}\n{log}")
            else:
                os.replace(tmp, paths[name])
        if failures:
            raise RuntimeError("\n".join(failures))
    finally:
        for _, tmp, _, proc in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return paths


def build_library(name: str, sources: Sequence[str]) -> str:
    """Compile ``sources`` into the keyed shared library if it is not built
    yet; returns its path. Raises with nvcc's output when the build fails."""
    return build_libraries({name: sources})[name]


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(build_library(name, sources))
    return lib
