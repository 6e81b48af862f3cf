"""Input pipeline of the port: datasets, loader and transforms."""
from .datasets import build_dataset  # noqa: F401
from .loader import DataLoader  # noqa: F401
