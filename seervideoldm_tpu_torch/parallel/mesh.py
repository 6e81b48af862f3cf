"""A mesh of ranks with one process group per axis (port of
``seervideoldm_tpu/parallel/mesh.py`` for the ``data`` and ``seq`` axes).

``create_mesh({"data": D, "seq": S})`` lays the world's ranks out as a
row-major (D, S) grid, ``seq`` fastest: rank = d * S + s.  Each axis has one
process group per line of the grid (built by every rank, in the same order,
as ``new_group`` requires).  ``None`` puts every rank on ``data``, as the
JAX entry does.  A ``model`` axis, an unknown axis or a shape that is not
the world size raises.

The JAX package shards global arrays over the mesh; the port hands each
rank its own slice instead: ``frame_range`` is this rank's frames (the
counterpart of ``video_sharding``), ``batch_slice`` its slice of a global
batch (``global_batch_array``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch.distributed as dist

AXES = ("data", "seq")


def frame_counts(total: int, parts: int) -> list[int]:
    """Contiguous split of ``total`` frames over ``parts`` ranks: the first
    ``total % parts`` ranks hold one frame more."""
    if total < parts:
        raise ValueError(f"{total} frames cannot be split over {parts} "
                         "sequence ranks")
    base, extra = divmod(total, parts)
    return [base + (i < extra) for i in range(parts)]


@dataclass
class Mesh:
    shape: dict                      # {"data": D, "seq": S}
    coords: dict                     # {"data": d, "seq": s}
    groups: dict = field(default_factory=dict)   # axis -> ProcessGroup

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["seq"]

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        """The process group of ``axis`` through this rank (None when the
        axis has one rank)."""
        return self.groups.get(axis)

    def frame_range(self, total: int) -> tuple[int, int]:
        """This rank's frames [start, stop) of a ``total``-frame video."""
        counts = frame_counts(total, self.shape["seq"])
        s = self.coords["seq"]
        start = sum(counts[:s])
        return start, start + counts[s]

    def batch_slice(self, global_batch: int) -> slice:
        """This rank's slice of a global batch split over ``data``."""
        d, n = self.coords["data"], self.shape["data"]
        if global_batch % n:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over data={n}")
        per = global_batch // n
        return slice(d * per, (d + 1) * per)


def create_mesh(shape: Optional[dict] = None) -> Mesh:
    """The mesh over every rank of the default group (one rank when no group
    is running).  Every rank must call this, with the same shape."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    shape = dict(shape or {"data": world})
    for axis, n in shape.items():
        if axis == "model":
            raise ValueError("mesh axis 'model' (tensor parallelism) is not "
                             "ported yet; use 'data' and 'seq'")
        if axis not in AXES:
            raise ValueError(f"unknown mesh axis {axis!r} (supported: {AXES})")
        if int(n) < 1:
            raise ValueError(f"mesh axis {axis}={n} must be >= 1")
    full = {a: int(shape.get(a, 1)) for a in AXES}
    size = full["data"] * full["seq"]
    if size != world:
        raise ValueError(f"mesh {shape} spans {size} ranks but the world has "
                         f"{world}")
    n_data, n_seq = full["data"], full["seq"]
    mesh = Mesh(shape=full, coords={"data": rank // n_seq, "seq": rank % n_seq})
    if world > 1:
        lines = {"seq": [[d * n_seq + s for s in range(n_seq)]
                         for d in range(n_data)],
                 "data": [[d * n_seq + s for d in range(n_data)]
                          for s in range(n_seq)]}
        for axis in AXES:
            for ranks in lines[axis]:
                # every rank creates every group, in one order
                group = dist.new_group(ranks) if len(ranks) > 1 else None
                if rank in ranks and group is not None:
                    mesh.groups[axis] = group
    return mesh
