"""queue_wait_ms.serve: median ms from a request's submission to the start of the pipeline call that carried it."""
import statistics


def read(record):
    waits = record.get("queue_wait_s")
    return 1000.0 * statistics.median(waits) if waits else None
