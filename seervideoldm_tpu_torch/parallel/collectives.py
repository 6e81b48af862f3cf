"""The collectives of the parallel path, on any backend (the port's
counterpart of the collectives GSPMD and ``shard_map`` insert in the JAX
package).

NCCL moves CUDA tensors itself.  Gloo does not take CUDA tensors for
send / recv, all_gather or all_to_all, so on a gloo group a CUDA tensor is
staged through a pinned host buffer: copied out, moved by gloo, copied
back.  Compute stays on the card; only the transport is host memory.
Tensors that only move (gathers, all-to-all, ring shifts) travel as raw
bytes, so every dtype goes through every backend; sums are taken in the
tensor's own dtype (the port reduces fp32 only).

A ``group`` of None means the default (world) group.  Every function is a
no-op on a group of one rank.  ``stats`` counts, per operation, the calls
and the bytes this rank sent (``{op: [calls, bytes]}``; ``reset_stats``
clears it): what a run paid in collectives, staged or not.

Differentiable forms (``autograd.Function``), for collectives inside the
model:

- ``all_reduce_sum``: y = sum over ranks of x on every rank; the backward
  is the same sum of the output gradients (every rank's loss depends on y);
- ``redistribute``: split along one dim, send piece j to rank j, join the
  received pieces along another dim; the backward is the reverse
  redistribution;
- ``all_gather_cat``: every rank's x joined along a dim, sizes may differ
  by rank; the backward sums the gradient over ranks and keeps this rank's
  slice.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist


stats: dict = {}


def reset_stats() -> None:
    stats.clear()


def _count(op: str, t: torch.Tensor) -> None:
    entry = stats.setdefault(op, [0, 0])
    entry[0] += 1
    entry[1] += t.numel() * t.element_size()


def group_size(group) -> int:
    if not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def group_rank(group) -> int:
    if not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def staged(group, t: torch.Tensor) -> bool:
    """True when ``t`` must travel through host memory on ``group``."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(t.shape, dtype=t.dtype, device="cpu", pin_memory=True)
    buf.copy_(t)
    return buf


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum of ``t`` over the ranks of ``group``."""
    if group_size(group) == 1:
        return t
    _count("all_reduce", t)
    if staged(group, t):
        buf = _host(t)
        dist.all_reduce(buf, group=group)
        t.copy_(buf)
    else:
        dist.all_reduce(t, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """In place: every rank of ``group`` gets the tensor of group rank
    ``src``."""
    if group_size(group) == 1:
        return t
    peer = dist.get_global_rank(group, src) if group is not None else src
    _count("broadcast", t)
    if staged(group, t):
        buf = _host(t)
        dist.broadcast(buf, peer, group=group)
        t.copy_(buf)
    else:
        dist.broadcast(t, peer, group=group)
    return t


def all_to_all(sends: Sequence[torch.Tensor], recv_shapes, dtype,
               group=None) -> list[torch.Tensor]:
    """Rank i's ``sends[j]`` arrives as rank j's result ``[i]``, of shape
    ``recv_shapes[i]``; any shapes, one dtype."""
    n = group_size(group)
    me = group_rank(group)
    device = sends[me].device
    if n == 1:
        return [sends[0].clone()]
    itemsize = torch.empty((), dtype=dtype).element_size()
    send_bytes = [s.numel() * itemsize for s in sends]
    recv_bytes = [math.prod(s) * itemsize for s in recv_shapes]
    flat = torch.cat([_bytes(s) for s in sends])
    _count("all_to_all", flat)
    out = torch.empty(sum(recv_bytes), dtype=torch.uint8, device=device)
    if staged(group, flat):
        host_out = torch.empty(out.shape, dtype=torch.uint8, pin_memory=True)
        dist.all_to_all_single(host_out, _host(flat), recv_bytes, send_bytes,
                               group=group)
        out.copy_(host_out)
    else:
        dist.all_to_all_single(out, flat, recv_bytes, send_bytes, group=group)
    pieces = out.split(recv_bytes)
    return [p.view(dtype).reshape(shape)
            for p, shape in zip(pieces, recv_shapes)]


def all_gather(t: torch.Tensor, group=None) -> list[torch.Tensor]:
    """Every rank's ``t`` (one shape on all ranks), in group-rank order."""
    n = group_size(group)
    if n == 1:
        return [t]
    return all_to_all([t] * n, [tuple(t.shape)] * n, t.dtype, group)


def ring_shift(t: torch.Tensor, group) -> torch.Tensor:
    """Send ``t`` to the next rank of ``group`` and return what the previous
    rank sent (one shape on all ranks)."""
    n = group_size(group)
    if n == 1:
        return t
    me = group_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    src = _bytes(t)
    _count("ring_shift", src)
    if staged(group, src):
        send, recv = _host(src), torch.empty_like(src, device="cpu",
                                                  pin_memory=True)
    else:
        send, recv = src, torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, send, nxt, group),
           dist.P2POp(dist.irecv, recv, prv, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(t.device).view(t.dtype).reshape(t.shape)


# ----------------------------------------------------- differentiable forms

class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


def _redistribute(x, group, split_dim, split_sizes, cat_dim, cat_sizes):
    me = group_rank(group)
    sends = [p.contiguous() for p in x.split(list(split_sizes), split_dim)]
    shapes = []
    for size in cat_sizes:
        shape = list(x.shape)
        shape[split_dim] = split_sizes[me]
        shape[cat_dim] = size
        shapes.append(tuple(shape))
    return torch.cat(all_to_all(sends, shapes, x.dtype, group), dim=cat_dim)


class _Redistribute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, split_sizes, cat_dim, cat_sizes):
        ctx.args = (group, split_dim, split_sizes, cat_dim, cat_sizes)
        return _redistribute(x, group, split_dim, split_sizes, cat_dim,
                             cat_sizes)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, split_sizes, cat_dim, cat_sizes = ctx.args
        return (_redistribute(g, group, cat_dim, cat_sizes, split_dim,
                              split_sizes), None, None, None, None, None)


def redistribute(x: torch.Tensor, group, split_dim: int,
                 split_sizes: Sequence[int], cat_dim: int,
                 cat_sizes: Sequence[int]) -> torch.Tensor:
    """Split ``x`` along ``split_dim`` into ``split_sizes`` (one piece per
    rank), send piece j to rank j, and join what arrives along ``cat_dim``;
    ``cat_sizes[i]`` is rank i's size of ``cat_dim``.  The result has this
    rank's ``split_sizes`` entry along ``split_dim`` and ``sum(cat_sizes)``
    along ``cat_dim``."""
    if group_size(group) == 1:
        return x
    return _Redistribute.apply(x, group, split_dim, tuple(split_sizes),
                               cat_dim, tuple(cat_sizes))


class _AllGatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, sizes):
        ctx.group, ctx.dim, ctx.sizes = group, dim, sizes
        shapes = []
        for size in sizes:
            shape = list(x.shape)
            shape[dim] = size
            shapes.append(tuple(shape))
        n = len(sizes)
        parts = all_to_all([x.contiguous()] * n, shapes, x.dtype, group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        total = all_reduce_(g.contiguous().clone(), ctx.group)
        me = group_rank(ctx.group)
        start = sum(ctx.sizes[:me])
        return total.narrow(ctx.dim, start, ctx.sizes[me]), None, None, None


def all_gather_cat(x: torch.Tensor, group, dim: int,
                   sizes: Sequence[int]) -> torch.Tensor:
    """Every rank's ``x`` joined along ``dim`` in rank order; ``sizes[i]``
    is rank i's size of ``dim``."""
    if group_size(group) == 1:
        return x
    return _AllGatherCat.apply(x, group, dim, tuple(sizes))
