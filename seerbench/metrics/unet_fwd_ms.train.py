"""unet_fwd_ms.train: CUDA-event ms per UNet forward (the forward of a micro-step) in the window."""
from seerbench import readings


def read(record):
    return readings.mean_ms(record, "unet_ms")
