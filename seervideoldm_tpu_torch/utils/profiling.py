"""Tracing and profiling hooks (port of ``seervideoldm_tpu/utils/profiling.py``).

Usage::

    with trace("outputs/trace"):          # torch.profiler, CPU + CUDA
        run_steps()

    timer = StepTimer()
    for batch in loader:
        with timer:
            train_step(state, batch)
    print(timer.summary())

- ``trace``: ``torch.profiler`` over the region (CUDA activities when a card
  is visible); the Chrome trace and the kernel table go to ``log_dir``;
- ``annotate``: a named region in the profiler timeline
  (``record_function``) and, on a card, an NVTX range;
- ``kernel_ms``: the CUDA kernel time of one call, summed from a profiler
  trace (what the floor budgets report beside the wall time);
- ``StepTimer``: wall-clock regions that end only when every visible CUDA
  device has finished the region's work;
- ``enable_nan_checks`` / ``disable_nan_checks``: forward hooks that raise
  on the first non-finite module output, naming the module, and autograd's
  anomaly mode for the backward.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch
import torch.nn as nn


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the region into ``log_dir``: ``trace.json`` (Chrome trace)
    and ``kernels.txt`` (the ``key_averages`` table)."""
    from torch.profiler import profile

    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    sort = "cuda_time_total" if torch.cuda.is_available() else "cpu_time_total"
    with open(os.path.join(log_dir, "kernels.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=80))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region visible in the profiler timeline (and to NVTX tools)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def kernel_ms(call) -> Optional[float]:
    """CUDA kernel time of ``call()`` in ms: the device self time of every
    CUDA event of a profiler trace around it, summed.  None without a card
    (there is no device time to read)."""
    if not torch.cuda.is_available():
        return None
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            total += getattr(evt, "self_device_time_total",
                             getattr(evt, "self_cuda_time_total", 0.0))
    return total / 1e3


def synchronize_all() -> None:
    """Wait for every visible CUDA device (a no-op without one)."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


class StepTimer:
    """Wall-clock step timer with percentile summary.

    The exit of each region synchronizes every visible CUDA device, so a
    region is timed to the end of the work it enqueued (kernels launch
    asynchronously), on every card of a multi-device step."""

    def __init__(self, skip_first: int = 1):
        self.times: list[float] = []
        self.skip_first = skip_first
        self._t0: Optional[float] = None

    def __enter__(self) -> "StepTimer":
        synchronize_all()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        synchronize_all()
        self.times.append(time.perf_counter() - self._t0)

    def summary(self) -> dict:
        times = np.asarray(self.times[self.skip_first:] or self.times)
        return {
            "steps": len(self.times),
            "mean_s": float(times.mean()),
            "p50_s": float(np.percentile(times, 50)),
            "p95_s": float(np.percentile(times, 95)),
        }


class NanChecks:
    """What ``enable_nan_checks`` installed: the hook handles and the
    anomaly mode to restore."""

    def __init__(self, handles, anomaly_before: bool):
        self.handles, self.anomaly_before = handles, anomaly_before


def _finite(out) -> bool:
    if isinstance(out, torch.Tensor):
        return not out.is_floating_point() or bool(torch.isfinite(out).all())
    if isinstance(out, (tuple, list)):
        return all(_finite(o) for o in out)
    if isinstance(out, dict):
        return all(_finite(o) for o in out.values())
    return True


def enable_nan_checks(model: nn.Module) -> NanChecks:
    """Debug mode (slow; dev only): raise on the first non-finite output of
    any submodule of ``model``, naming it, and turn on autograd's anomaly
    detection so a NaN in the backward names the forward op that made it."""
    def hook_for(name: str):
        def hook(module, inputs, output):
            if not _finite(output):
                raise FloatingPointError(
                    f"non-finite output from {name or 'the model'} "
                    f"({type(module).__name__})")
        return hook

    handles = [m.register_forward_hook(hook_for(n))
               for n, m in model.named_modules()]
    before = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(True)
    return NanChecks(handles, before)


def disable_nan_checks(checks: NanChecks) -> None:
    for h in checks.handles:
        h.remove()
    torch.autograd.set_detect_anomaly(checks.anomaly_before)
