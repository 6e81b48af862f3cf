"""ff_roofline.sample: the FeedForward (K3-K5) sites' roofline bound over their kernels' device time, %."""
from seerbench import readings


def read(record):
    return readings.roofline(record, "ff")
