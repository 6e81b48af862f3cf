"""pab_reuse_share.serve: PAB site evaluations reused from the cache over all PAB site evaluations (``pab.reused.*`` / ``pab.*``), in %, over the run's pipeline calls."""
from seerbench import program_spans


def read(record):
    return program_spans.count_share(("pab.reused.",),
                                     ("pab.reused.", "pab.computed."))
