"""temporal_share.svd: device ms of the program's ``site.temporal_resnet``, ``site.temporal_block`` and ``site.blend`` spans inside the UNet calls over the ``unet.call`` spans' device ms, in %."""
from seerbench import program_spans

KINDS = ("site.temporal_resnet", "site.temporal_block", "site.blend")


def read(record):
    calls = {s["seq"]: s for s in program_spans.spans("unet.call")}
    total = sum(s["device_ms"] or 0.0 for s in calls.values())
    if not total:
        return None
    every = {s["seq"]: s for s in program_spans.spans()}

    def in_unet(span):
        parent = span["parent"]
        while parent is not None and parent not in calls:
            parent = every[parent]["parent"] if parent in every else None
        return parent is not None

    inside = sum(s["device_ms"] or 0.0 for name in KINDS
                 for s in program_spans.spans(name) if in_unet(s))
    return 100.0 * inside / total if inside else None
