"""What the readers of the program's own spans and counters share.

They read the port's tracer (``seervideoldm_tpu_torch.utils.profiling``:
``spans()``, ``counters()``) in process once the run is over, not the
run's record.  Detailed spans exist only while a profiler records, so in
a ``--trace 1`` run they are the profiled unit's; the always-on
pipeline-call records are read without the process's first (each
cell's warm-up) and without those a profiler recorded.  A program
without the tracer, or a run that recorded nothing a reader reads, gives
None."""
from __future__ import annotations

import statistics

PIPELINE_CALLS = ("pipe.generate", "pipe.rollout", "pipe.edit")


def spans(name=None) -> list:
    try:
        from seervideoldm_tpu_torch.utils import profiling

        read = profiling.spans
    except (ImportError, AttributeError):
        return []
    return read(name)


def pipeline_calls() -> list:
    """The run's always-on pipeline-call records but the first and the
    profiled ones."""
    calls = sorted((s for s in spans() if s["name"] in PIPELINE_CALLS
                    and s["counts"] is not None), key=lambda s: s["seq"])
    return [c for c in calls[1:] if not c["counts"].get("profiled")]


def count_share(numerator: tuple, denominator: tuple):
    """100 x the summed counts whose names start with one of
    ``numerator`` over those starting with one of ``denominator``, over
    the pipeline calls read; None when the denominator is 0."""
    num = den = 0
    for call in pipeline_calls():
        for key, n in call["counts"].items():
            num += n if key.startswith(numerator) else 0
            den += n if key.startswith(denominator) else 0
    return 100.0 * num / den if den else None


def backward_ms(kind=None):
    """Device ms per micro-step of the profiled training step: the mean
    ``train.backward`` (``kind`` None), or the summed ``site.<kind>.bwd``
    spans over the number of ``train.backward`` spans."""
    steps = [s["device_ms"] for s in spans("train.backward")
             if s["device_ms"] is not None]
    if not steps:
        return None
    if kind is None:
        return statistics.fmean(steps)
    sites = [s["device_ms"] for s in spans(f"site.{kind}.bwd")
             if s["device_ms"] is not None]
    return sum(sites) / len(steps) if sites else None


def median_ms(name: str):
    """The median host ms of the spans called ``name``."""
    found = spans(name)
    return (statistics.median((s["end"] - s["start"]) / 1e6 for s in found)
            if found else None)
