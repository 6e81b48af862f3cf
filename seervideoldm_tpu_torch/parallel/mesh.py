"""A mesh of ranks with one process group per axis (port of
``seervideoldm_tpu/parallel/mesh.py`` for the ``data``, ``model`` and
``seq`` axes).

``create_mesh({"data": D, "model": M, "seq": S})`` lays the world's ranks
out as one row-major (D, M, S) grid, ``seq`` fastest: rank = (d * M + m) *
S + s.  Each axis has one process group per line of the grid, and under a
``model`` axis of more than one rank each model index has one more group,
``replicas``: its D * S ranks, over which a training step reduces (built
by every rank, in the same order, as ``new_group`` requires).  ``None``
puts every rank on ``data``, as the JAX entry does.  An unknown axis or a
shape that is not the world size raises.

The JAX package shards global arrays over the mesh; the port hands each
rank its own slice instead: ``frame_range`` is this rank's frames (the
counterpart of ``video_sharding``), ``batch_slice`` its slice of a global
batch (``global_batch_array``).  Both key on ``data`` and ``seq`` only, so
the ranks of one ``model`` group see the same batch and frames; they hold
slices of the weights instead (``parallel/sharding.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch.distributed as dist

AXES = ("data", "model", "seq")


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
    shape: dict                      # {"data": D, "model": M, "seq": S}
    coords: dict                     # {"data": d, "model": m, "seq": s}
    groups: dict = field(default_factory=dict)   # axis -> ProcessGroup

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"] * self.shape["seq"]

    @property
    def replicas(self) -> int:
        """The ranks that hold this rank's slice of the weights (every
        data and seq rank of its model index)."""
        return self.shape["data"] * self.shape["seq"]

    def replica_group(self):
        """The process group of those ranks: the world's (None) without a
        ``model`` axis, else the ``replicas`` group through this rank.
        Ask only when ``replicas > 1``: a group of None means the world."""
        if self.shape["model"] == 1:
            return None
        return self.groups.get("replicas")

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
        if axis not in AXES:
            raise ValueError(f"unknown mesh axis {axis!r} (supported: {AXES})")
        if int(n) < 1:
            raise ValueError(f"mesh axis {axis}={n} must be >= 1")
    full = {a: int(shape.get(a, 1)) for a in AXES}
    n_data, n_model, n_seq = full["data"], full["model"], full["seq"]
    size = n_data * n_model * n_seq
    if size != world:
        raise ValueError(f"mesh {shape} spans {size} ranks but the world has "
                         f"{world}")
    mesh = Mesh(shape=full, coords={"data": rank // (n_model * n_seq),
                                    "model": rank // n_seq % n_model,
                                    "seq": rank % n_seq})
    if world > 1:
        at = lambda d, m, s: (d * n_model + m) * n_seq + s  # noqa: E731
        D, M, S = range(n_data), range(n_model), range(n_seq)
        lines = {"data": [[at(d, m, s) for d in D] for m in M for s in S],
                 "model": [[at(d, m, s) for m in M] for d in D for s in S],
                 "seq": [[at(d, m, s) for s in S] for d in D for m in M]}
        if n_model > 1:
            lines["replicas"] = [[at(d, m, s) for d in D for s in S]
                                 for m in M]
        for axis, axis_lines in lines.items():
            for ranks in axis_lines:
                # every rank creates every group, in one order
                group = dist.new_group(ranks) if len(ranks) > 1 else None
                if rank in ranks and group is not None:
                    mesh.groups[axis] = group
    return mesh


def describe(mesh: Mesh) -> str:
    """One line naming the layout and this rank's place in it."""
    return (f"mesh (data, model, seq) = ({mesh.shape['data']}, "
            f"{mesh.shape['model']}, {mesh.shape['seq']}), rank = (d * M + "
            f"m) * S + s; this rank d={mesh.coords['data']} "
            f"m={mesh.coords['model']} s={mesh.coords['seq']}")
