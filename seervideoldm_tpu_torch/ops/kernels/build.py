"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds, not minutes).  Builds happen at
first use, from the sources in the checkout only, into
``seervideoldm_tpu_torch/_build/`` (listed in ``.gitignore``); a library is
named by a hash of its sources and flags, so an edited source rebuilds.
``build_all`` starts one ``nvcc`` per source at once.

Nothing here falls back: a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
SOURCES = ("flash_attention", "swat_attention", "geglu_ff", "softmax_calib")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "from source on a machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in sorted(os.listdir(CSRC)):
        if fname == f"{name}.cu" or fname.endswith(".cuh"):
            with open(os.path.join(CSRC, fname), "rb") as f:
                h.update(fname.encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _start(name: str) -> tuple[subprocess.Popen, str, str]:
    out = _lib_path(name)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every listed source that has no current library, all nvcc
    processes at once.  Returns ``{name: ptxas report}`` for the sources it
    compiled; raises RuntimeError with the compiler output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = [n for n in names if not os.path.exists(_lib_path(n))]
    procs = {n: _start(n) for n in todo}
    reports, errors = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed."""
    with _LOCK:
        if name not in _LIBS:
            build_all((name,))
            lib = ctypes.CDLL(_lib_path(name))
            lib.svl_error_string.argtypes = [ctypes.c_int]
            lib.svl_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return _LIBS[name]


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a non-zero return of a kernel's C entry point."""
    if code == -1:
        raise ValueError(f"{what}: shape not covered by the CUDA kernel")
    if code == -2:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled refused a map "
                           f"(CUresult {lib.svl_map_status()})")
    if code != 0:
        msg = lib.svl_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({code}: {msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
