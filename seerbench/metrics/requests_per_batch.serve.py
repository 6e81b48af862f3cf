"""requests_per_batch.serve: requests the batcher took over the batches it formed in the window."""
from seerbench import readings


def read(record):
    c = record.get("counters") or {}
    return c["requests"] / c["batches"] if c.get("batches") else None
