"""device_idle.train: share of the profiled unit with no device operation running, %."""
from seerbench import readings


def read(record):
    return readings.device_idle(record)
