"""unet_bwd_ms.train: CUDA-event ms of the program's ``train.backward`` span (the autograd call of FSText and the UNet), mean per micro-step of the profiled step."""
from seerbench import program_spans


def read(record):
    return program_spans.backward_ms()
