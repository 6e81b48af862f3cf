"""optimizer_ms.train: CUDA-event ms per optimizer update (the sync micro-step's clip and AdamW)."""
from seerbench import readings


def read(record):
    return readings.mean_ms(record, "optimizer_ms")
