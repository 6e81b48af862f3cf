"""vae_decode_share.svd: device ms of the program's ``pipe.vae_decode`` spans over its ``pipe.svd_call`` spans (the whole pipeline call), in %."""
from seerbench import program_spans


def read(record):
    calls = sum(s["device_ms"] or 0.0 for s in program_spans.spans("pipe.svd_call"))
    decode = sum(s["device_ms"] or 0.0 for s in program_spans.spans("pipe.vae_decode"))
    return 100.0 * decode / calls if calls and decode else None
