"""What the per-layer metric readers (``metrics/<name>.py``) share: each
takes the run's record (the driver's counters and timings, and with
``--trace 1`` the probe's CUDA-event times and the profiled unit's trace
summary) and returns a number, or None when the record holds nothing it
can read."""
from __future__ import annotations

import statistics

from .roofline import PEAK_FLOPS


def mfu(record: dict):
    """Model FLOPs of the work completed in the window over the window
    times the bf16 peak, in %."""
    if not record.get("flops") or not record.get("window_s"):
        return None
    return 100.0 * record["flops"] / (record["window_s"] * PEAK_FLOPS)


def roofline(record: dict, kind: str):
    """The sum of the ``kind`` sites' roofline bounds over the device time
    of the kernels launched inside their spans, in %.  A kind the
    profiled unit never reached fails the run: it never reads 0."""
    trace = record.get("trace")
    if trace is None:
        return None
    bound = trace["site_bound_s"].get(kind, 0.0)
    spent = trace["site_device_s"].get(kind, 0.0)
    if bound <= 0.0 or spent <= 0.0:
        raise RuntimeError(f"no {kind} site was found in the profiled unit "
                           f"(bound {bound} s, device {spent} s)")
    return 100.0 * bound / spent


def device_idle(record: dict):
    trace = record.get("trace")
    if trace is None:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def mean_ms(record: dict, key: str):
    values = record.get(key)
    return statistics.fmean(values) if values else None


def outside_unet_share(record: dict):
    """The share of the pipeline calls' device-timeline time outside their
    UNet calls (CLIP, FSText, VAE, the DDIM arithmetic, the copy-out), in
    %."""
    calls = record.get("pipelines_ms")
    if not calls:
        return None
    total = sum(c[0] for c in calls)
    return 100.0 * (1.0 - sum(c[1] for c in calls) / total)
