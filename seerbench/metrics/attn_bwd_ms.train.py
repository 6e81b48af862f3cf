"""attn_bwd_ms.train: CUDA-event ms of the program's ``site.attn.bwd`` spans (the attn sites' backward) summed, per micro-step of the profiled step."""
from seerbench import program_spans


def read(record):
    return program_spans.backward_ms("attn")
