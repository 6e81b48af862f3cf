"""K10: the on-chip softmax calibration (CUDA C++, ``csrc/softmax_calib.cu``).

Replaces ``tools/floor_budget.py::softmax_s_per_elem`` (its Pallas body,
:122-131): ``reps`` passes of an fp32 row softmax over data that stays in
fast memory, then the row sums.  The floor budgets
(``tools/floor_budget.py``, ``tools/floor_budget_train.py``) price every
attention site's softmax with its seconds per element, the cost the port's
attention kernels pay per score on top of their matmuls.

On the H100 the kernel is MUFU-bound (one ``ex2`` per element per pass);
one warp keeps a row in registers for every pass and touches HBM only to
load ``x`` once and to store the sums (see the source note).  The
calibration shape fills the card in one wave: ``calibration_rows`` = SMs
x 8 rows per CTA x 2 resident CTAs (2112 on a 132-SM H100 SXM), 2048
columns.

The wrapper runs the plain version for CPU tensors and the kernel for CUDA
tensors; there is no other path.
"""
from __future__ import annotations

import ctypes
import time

import torch

from . import build

ROWS_PER_CTA, CTAS_PER_SM = 8, 2
CALIB_COLS = 2048             # csrc/softmax_calib.cu: SMC_COLS, 64 per lane
CALIB_REPS = (2048, 8192)     # the JAX tool's two points


def softmax_calib_plain(x: torch.Tensor, reps: int, return_s: bool = False):
    """The Pallas body as torch ops: (rows, cols) fp32 -> (rows, 1) fp32,
    and the final s (rows, cols) when ``return_s``."""
    s = x.float()
    for _ in range(reps):
        m = s.amax(dim=1, keepdim=True)
        e = torch.exp(s - m)
        l = e.sum(dim=1, keepdim=True)
        s = e / torch.where(l == 0.0, torch.ones_like(l), l) + 1e-6
    sums = s.sum(dim=1, keepdim=True)
    return (sums, s) if return_s else sums


def softmax_calib(x: torch.Tensor, reps: int, return_s: bool = False):
    """(rows, cols) fp32 -> (rows, 1) fp32 row sums after ``reps`` passes,
    and the final s (rows, cols) when ``return_s``.  The row sums are
    1 + cols * 1e-6 after any normalising pass, so a check of the work
    compares s."""
    if x.device.type == "cpu":
        return softmax_calib_plain(x, reps, return_s)
    if x.device.type != "cuda":
        raise ValueError(f"softmax_calib: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"softmax_calib: kernel takes 2-D fp32, got "
                         f"{x.dtype} {tuple(x.shape)}")
    rows, cols = x.shape
    if cols != CALIB_COLS or reps < 0:
        raise ValueError(f"softmax_calib: cols {cols} not covered "
                         f"(the kernel takes {CALIB_COLS}) or reps {reps} < 0")
    x = x.contiguous()
    out = torch.empty(rows, 1, dtype=torch.float32, device=x.device)
    s = torch.empty_like(x) if return_s else None
    lib = build.load("softmax_calib")
    fn = lib.svl_softmax_calib
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(build.ptr(x), build.ptr(out), None if s is None else build.ptr(s),
              rows, int(reps), build.stream_of(x))
    build.check(lib, code, "softmax_calib")
    softmax_calib.launches += 1
    return (out, s) if return_s else out


softmax_calib.launches = 0


def calibration_rows(device) -> int:
    """Rows that give every SM two resident 8-row CTAs: 2112 on 132 SMs."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return 132 * ROWS_PER_CTA * CTAS_PER_SM
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms * ROWS_PER_CTA * CTAS_PER_SM


def softmax_s_per_elem(device="cuda", reps=CALIB_REPS,
                       iters: int = 3) -> float:
    """Seconds per element of one softmax pass at the calibration shape,
    from the two-point delta of ``reps`` (the fixed launch and load cost
    cancels), median of ``iters``.  Not clamped: a non-positive delta
    stays visible to the caller.

    On a CUDA device the kernel is timed with CUDA events; on the CPU the
    plain version with the host clock, which prices the CPU path only and
    is no device number."""
    dev = torch.device(device)
    rows = calibration_rows(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(rows, CALIB_COLS, generator=gen, device=dev)

    def timed(n: int) -> float:
        softmax_calib(x, n)                       # warm (and build)
        times = []
        for _ in range(iters):
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                softmax_calib(x, n)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                softmax_calib(x, n)
                times.append(time.perf_counter() - t0)
        return sorted(times)[len(times) // 2]

    lo, hi = reps
    return (timed(hi) - timed(lo)) / ((hi - lo) * rows * CALIB_COLS)
