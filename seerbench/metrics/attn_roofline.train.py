"""attn_roofline.train: the CrossAttention and WindowTemporalAttention sites' roofline bound over their kernels' device time, %."""
from seerbench import readings


def read(record):
    return readings.roofline(record, "attn")
