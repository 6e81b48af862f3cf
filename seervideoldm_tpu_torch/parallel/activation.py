"""The registered mesh the model code consults, and the one "gather the
frames over ``seq``, split batch*heads over the ranks, run the kernel,
return each rank its frames" step (port of ``set_activation_mesh`` /
``get_activation_mesh`` / ``maybe_shard_batched`` of
``seervideoldm_tpu/ops/pallas/__init__.py``).

Process-global by design, as in the JAX package: the entry points build one
model stack per process and register the mesh once (``pipelines/loading``);
``set_activation_mesh(None)`` clears it.  Only axes of size > 1 count.

Under a ``data`` axis each rank simply holds its own batch: the kernels run
on the local batch and nothing in the forward communicates.  Under ``seq``
each rank holds a contiguous range of the frames (``FrameShard``); the
temporal attention is the one op that needs every frame, and it either
rotates K/V around the ring (``ops/ring.py``) or takes ``seq_kernel_step``.
Under ``model`` each rank holds its slice of the heads and of the
feed-forward's hidden units (``parallel/sharding.py``); the kernels run on
the local heads and each row-parallel projection closes with one
all-reduce over ``model_group()``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from .collectives import all_gather_cat, group_rank, group_size, redistribute
from .mesh import Mesh, frame_counts

_MESH: Optional[Mesh] = None


def set_activation_mesh(mesh: Optional[Mesh]) -> None:
    """Register ``mesh`` (or clear it with None).  A mesh whose axes all
    have one rank registers as None."""
    global _MESH
    _MESH = mesh if mesh is not None and mesh.size > 1 else None


def get_activation_mesh() -> Optional[Mesh]:
    return _MESH


def seq_group():
    """The ``seq`` process group through this rank, or None when no
    multi-rank ``seq`` axis is registered."""
    return _MESH.group("seq") if _MESH is not None else None


def model_group():
    """The ``model`` process group through this rank, or None when no
    multi-rank ``model`` axis is registered.  The GEGLU kernels' gates
    decline under it, as the JAX package's decline under any mesh."""
    return _MESH.group("model") if _MESH is not None else None


@dataclass(frozen=True)
class FrameShard:
    """This rank's contiguous frames of a video split over ``seq``:
    ``counts[i]`` frames on seq rank i, this rank is ``index``."""

    counts: tuple
    index: int
    group: object

    @property
    def total(self) -> int:
        return sum(self.counts)

    @property
    def start(self) -> int:
        return sum(self.counts[:self.index])

    @property
    def stop(self) -> int:
        return self.start + self.counts[self.index]

    @property
    def even(self) -> bool:
        return len(set(self.counts)) == 1


def frame_shard(total: int) -> Optional[FrameShard]:
    """The shard of a ``total``-frame video for this rank under the
    registered ``seq`` axis, or None when frames are not split."""
    group = seq_group()
    if group is None:
        return None
    return FrameShard(tuple(frame_counts(total, group_size(group))),
                      group_rank(group), group)


def seq_kernel_step(fn: Callable, arrays, shard: FrameShard,
                    replicated=()) -> Optional[torch.Tensor]:
    """``fn(*arrays, *replicated)`` on whole videos: each of ``arrays`` is
    this rank's frames ``(bh, f_local, ...)``; the ranks trade pieces so
    that each holds ``bh / S`` whole videos (every frame), run ``fn`` there
    and trade back, so the result is this rank's frames of every
    batch*head.  ``replicated`` (rotary tables) pass whole.  Returns None
    when bh does not divide over the ``seq`` ranks: the caller then takes
    its plain path, as ``maybe_shard_batched`` returns None."""
    n = len(shard.counts)
    bh = arrays[0].shape[0]
    if bh % n or any(a.shape[0] != bh for a in arrays):
        return None
    per = [bh // n] * n
    stacked = torch.stack(arrays)                   # (k, bh, f_local, ...)
    whole = redistribute(stacked, shard.group, 1, per, 2, shard.counts)
    out = fn(*whole.unbind(0), *replicated)         # (bh / S, F, ...)
    return redistribute(out, shard.group, 1, shard.counts, 0, per)


def frame_local(fn: Callable, *videos: torch.Tensor) -> torch.Tensor:
    """``fn(*videos)`` with the frames (axis 1) split over the ``seq``
    ranks: each rank runs its share and the results are joined again (a
    frame-local op such as the VAE).  One call on every frame when no
    ``seq`` axis is registered or there are fewer frames than ranks."""
    group = seq_group()
    f = videos[0].shape[1]
    if group is None or f < group_size(group):
        return fn(*videos)
    shard = frame_shard(f)
    part = fn(*(v[:, shard.start:shard.stop] for v in videos))
    return gather_frames(part, shard)


def gather_frames(x: torch.Tensor, shard: FrameShard,
                  dim: int = 1) -> torch.Tensor:
    """Every frame of ``x`` on every rank (differentiable)."""
    return all_gather_cat(x, shard.group, dim, shard.counts)


def local_frames(x: torch.Tensor, shard: Optional[FrameShard],
                 dim: int = 1) -> torch.Tensor:
    """This rank's frames of a whole video ``x``."""
    if shard is None:
        return x
    return x.narrow(dim, shard.start, shard.counts[shard.index])
