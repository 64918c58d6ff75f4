"""ctypes bridge to the native decode library (native/dexiraft_native.cpp).

The port's counterpart of ``dexiraft_tpu/data/native.py``, over the same
shared C++ source. Builds the shared object on first use with g++ into
the port's own build directory (``dexiraft_tpu_torch/_build/native/``,
never the JAX package's ``native/build/``), falls back to the
pure-Python codecs when the toolchain or library is unavailable, and
honors DEXIRAFT_NO_NATIVE=1. Batch decodes release the GIL for the whole
call — C++ threads do the file I/O. This is host decoding: nothing here
touches the card.
"""

from __future__ import annotations

import ctypes
import os
import os.path as osp
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_PKG_DIR = osp.dirname(osp.dirname(osp.abspath(__file__)))
_SRC = osp.join(osp.dirname(_PKG_DIR), "native", "dexiraft_native.cpp")
_SO = osp.join(_PKG_DIR, "_build", "native", "libdexiraft_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[str]:
    if not osp.exists(_SRC):
        return None
    os.makedirs(osp.dirname(_SO), exist_ok=True)
    if (osp.exists(_SO)
            and os.stat(_SO).st_mtime >= os.stat(_SRC).st_mtime):
        return _SO
    # compile to a private temp path, then atomically publish: concurrent
    # processes must never dlopen a half-written ELF
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-std=c++17",
           _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    return _SO


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it on first call; None if unavailable."""
    global _lib, _tried
    if os.environ.get("DEXIRAFT_NO_NATIVE") == "1":
        return None
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.drn_read_flo.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                     ctypes.c_int64, i32p, i32p]
        lib.drn_read_ppm.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                     ctypes.c_int64, i32p, i32p]
        lib.drn_read_flo_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
        lib.drn_read_ppm_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
        for fn in (lib.drn_read_flo, lib.drn_read_ppm,
                   lib.drn_read_flo_batch, lib.drn_read_ppm_batch):
            fn.restype = ctypes.c_int32
        _lib = lib
        return _lib


def read_flo_native(path) -> Optional[np.ndarray]:
    """(H, W, 2) float32, or None when the native path is unavailable OR
    declines the file (caller falls through to the Python codec, which
    owns the descriptive errors). One open, one call: the buffer is sized
    from the file length (payload = size - 12-byte header)."""
    lib = get_lib()
    if lib is None:
        return None
    try:
        n = (os.stat(path).st_size - 12) // 4
    except OSError:
        return None
    if n <= 0:
        return None
    flat = np.empty(n, np.float32)
    w = ctypes.c_int32()
    h = ctypes.c_int32()
    rc = lib.drn_read_flo(os.fspath(path).encode(),
                          flat.ctypes.data_as(ctypes.c_void_p), n,
                          ctypes.byref(w), ctypes.byref(h))
    if rc != 0 or int(h.value) * int(w.value) * 2 != n:
        return None
    return flat.reshape(int(h.value), int(w.value), 2)


def read_ppm_native(path) -> Optional[np.ndarray]:
    """(H, W, 3) uint8, or None when unavailable or declined (e.g. ASCII
    P3 or 16-bit PPMs go back to the Python codec). Buffer bounded by
    file size."""
    lib = get_lib()
    if lib is None:
        return None
    try:
        cap = os.stat(path).st_size  # >= payload (header is extra slack)
    except OSError:
        return None
    flat = np.empty(cap, np.uint8)
    w = ctypes.c_int32()
    h = ctypes.c_int32()
    rc = lib.drn_read_ppm(os.fspath(path).encode(),
                          flat.ctypes.data_as(ctypes.c_void_p), cap,
                          ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    n = int(h.value) * int(w.value) * 3
    if n > cap:
        return None
    return flat[:n].reshape(int(h.value), int(w.value), 3)


def _paths_array(paths: Sequence[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [os.fspath(p).encode() for p in paths]
    return arr


def read_flo_batch(paths: Sequence[str], height: int, width: int,
                   nthreads: int = 8) -> Optional[np.ndarray]:
    """(N, H, W, 2) float32 in one GIL-free call; None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((len(paths), height, width, 2), np.float32)
    rc = lib.drn_read_flo_batch(_paths_array(paths), len(paths),
                                out.ctypes.data_as(ctypes.c_void_p),
                                width, height, nthreads)
    if rc != 0:
        raise IOError(f"native batch decode failed ({rc})")
    return out


def read_ppm_batch(paths: Sequence[str], height: int, width: int,
                   nthreads: int = 8) -> Optional[np.ndarray]:
    """(N, H, W, 3) uint8 in one GIL-free call; None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((len(paths), height, width, 3), np.uint8)
    rc = lib.drn_read_ppm_batch(_paths_array(paths), len(paths),
                                out.ctypes.data_as(ctypes.c_void_p),
                                width, height, nthreads)
    if rc != 0:
        raise IOError(f"native batch decode failed ({rc})")
    return out
