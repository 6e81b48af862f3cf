"""ctypes binding of the C++ frame loader ``native/frame_loader.cpp``
(port of ``seervideoldm_tpu/data/native.py``): threaded JPEG decode,
PIL-compatible triangle-filter resize, center crop and [-1, 1]
normalisation, off the interpreter lock.

The library is built at first use (never at import) with ``g++`` from the
repository's source into ``seervideoldm_tpu_torch/_build/``, named by a
hash of the source, the flags (``native/Makefile``'s, so it decodes bit
for bit as the JAX package's build does) and the host's instruction set
(a library built for another machine is never loaded); the build writes a
temporary file and renames it, and a lock keeps the loader's threads from
building twice.  Without ``g++`` or ``libjpeg`` the build fails, and
``decode_frames`` returns None: the caller decodes with PIL, and that is
said once on stderr.  This is host code, not a device kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import sys
import threading
from typing import Optional, Sequence

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
SOURCE = os.path.join(_ROOT, "native", "frame_loader.cpp")
BUILD_DIR = os.path.join(_ROOT, "seervideoldm_tpu_torch", "_build")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared")
LIBS = ("-ljpeg", "-lpthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None   # why the library is unavailable, once known


def _host_key() -> bytes:
    """The machine's instruction set (``-march=native`` builds for it):
    the first processor's flags in ``/proc/cpuinfo``, else the platform."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line.encode()
    except OSError:
        pass
    return platform.platform().encode()


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode() + _host_key())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libframeloader-{h.hexdigest()[:12]}.so")


def _build(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *CXX_FLAGS, SOURCE, "-o", tmp, *LIBS],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ exit {proc.returncode}: "
                           f"{proc.stderr.strip()[-400:]}")
    os.replace(tmp, out)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            path = _lib_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
        except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
            _error = str(exc) or type(exc).__name__
            print(f"native frame loader unavailable ({_error}); decoding "
                  "frames with PIL", file=sys.stderr, flush=True)
            return None
        lib.decode_frames.restype = ctypes.c_int
        lib.decode_frames.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def unavailable_reason() -> Optional[str]:
    """Why the library could not be built or loaded (None if it was)."""
    _load()
    return _error


def decode_frames(paths: Sequence[str], resolution: int,
                  n_threads: int = 8) -> Optional[np.ndarray]:
    """JPEG frames -> (n, res, res, 3) float32 in [-1, 1]; None when the
    library is unavailable or a frame fails to decode (the caller then
    decodes with PIL)."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, resolution, resolution, 3), dtype=np.float32)
    names = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    ok = lib.decode_frames(names, n, resolution,
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                           n_threads)
    return out if ok == n else None
