from .batcher import DynamicBatcher
from .server import GenerationService, GenRequest, make_server

__all__ = ["DynamicBatcher", "GenerationService", "GenRequest", "make_server"]
