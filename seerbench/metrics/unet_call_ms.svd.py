"""unet_call_ms.svd: mean device ms (CUDA events) of the program's ``unet.call`` spans in the profiled pipeline call."""
import statistics

from seerbench import program_spans


def read(record):
    ms = [s["device_ms"] for s in program_spans.spans("unet.call")
          if s["device_ms"] is not None]
    return statistics.fmean(ms) if ms else None
