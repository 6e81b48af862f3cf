"""mfu.serve: model FLOPs of the work completed over the window at 989 TFLOP/s, %."""
from seerbench import readings


def read(record):
    return readings.mfu(record)
