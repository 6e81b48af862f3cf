"""request_queue_ms.serve: median host ms of the program's ``serve.queue`` spans, a request's submission to the start of its batch's handler call."""
from seerbench import program_spans


def read(record):
    return program_spans.median_ms("serve.queue")
