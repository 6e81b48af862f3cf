"""resnet_roofline.sample: the ResnetBlock3D sites' roofline bound over their kernels' device time, %."""
from seerbench import readings


def read(record):
    return readings.roofline(record, "resnet")
