"""outside_unet_share.sample: share of pipeline-call time outside the UNet calls, %."""
from seerbench import readings


def read(record):
    return readings.outside_unet_share(record)
