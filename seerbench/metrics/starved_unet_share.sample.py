"""starved_unet_share.sample: UNet dispatches whose previous call had finished on the card when the host reached them (``unet.starved``), over those checked (``unet.checked``), in %, over the run's pipeline calls."""
from seerbench import program_spans


def read(record):
    return program_spans.count_share(("unet.starved",), ("unet.checked",))
