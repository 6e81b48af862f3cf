"""Saved sites for ``remat: "save_attn"`` (the JAX package's
``save_only_these_names("attn_out", "ff_out")`` policy,
``seervideoldm_tpu/models/unet3d.py:146-152``).

Under ``save_attn`` every top-level SeerUNet block runs under
non-reentrant ``torch.utils.checkpoint`` with ``context_fn =
save_attn_contexts``.  The first forward records, in order, the output of
every named site the block runs: each attention core (the K1 / K2 / K6
kernels with the log-sum-exp their backward kernels read, or the plain
attention) and each feed-forward (the K3 / K4 / K5 kernels or the plain
FF).  The recompute in the backward replays those records in the same
order instead of computing the sites again, so no forward attention or
GEGLU kernel launches twice, while everything around the sites -- norms,
the projections to q, k and v, the FF input -- is recomputed and the
sites' autograd nodes save the recomputed inputs beside the kept outputs.

A site calls ``saved_site(compute)`` where it computes: in the forward of
its ``autograd.Function`` when a gradient is needed (so its backward still
reaches the inputs), on its plain forward path otherwise.  Outside a
``save_attn`` block ``saved_site`` just computes.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterator, Optional

import torch

_LOCAL = threading.local()   # the store of the block running in this thread


class SiteStore:
    """The site outputs of one checkpointed block: appended by the first
    forward, read back in order by each recompute."""

    def __init__(self):
        self.saved: list[tuple] = []
        self.cursor: Optional[int] = None   # None while recording

    def next(self) -> tuple:
        if self.cursor is None or self.cursor >= len(self.saved):
            raise RuntimeError(
                "save_attn: the recompute reached more sites than the "
                f"forward recorded ({len(self.saved)}): the block's control "
                "flow differs between the two passes")
        out = self.saved[self.cursor]
        self.cursor += 1
        return tuple(None if t is None else t.detach() for t in out)


@contextlib.contextmanager
def _using(store: SiteStore, replay: bool) -> Iterator[None]:
    previous = getattr(_LOCAL, "store", None)
    if replay:
        store.cursor = 0
    _LOCAL.store = store
    try:
        yield
    finally:
        _LOCAL.store = previous


def save_attn_contexts():
    """``context_fn`` of ``torch.utils.checkpoint``: (record, replay)
    contexts over one fresh store."""
    store = SiteStore()
    return _using(store, replay=False), _using(store, replay=True)


def saved_site(compute: Callable[[], tuple]) -> tuple:
    """``compute()`` (a tuple of tensors or None), recorded in the running
    ``save_attn`` block's forward and replayed in its recompute."""
    store: Optional[SiteStore] = getattr(_LOCAL, "store", None)
    if store is None:
        return compute()
    if store.cursor is not None:
        return store.next()
    out = compute()
    store.saved.append(tuple(None if t is None else t.detach() for t in out))
    return out


def needs_grad(*tensors) -> bool:
    """Autograd will ask the site for a gradient."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)
