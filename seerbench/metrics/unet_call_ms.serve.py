"""unet_call_ms.serve: CUDA-event ms per UNet forward in the window."""
from seerbench import readings


def read(record):
    return readings.mean_ms(record, "unet_ms")
