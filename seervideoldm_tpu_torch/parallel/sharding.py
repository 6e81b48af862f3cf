"""The sharded layouts of ``seervideoldm_tpu/parallel/sharding.py``: ZeRO-1
and FSDP over the ``data`` axis (``zero1_state_sharding``,
``fsdp_param_sharding`` / ``fsdp_state_sharding``), and tensor parallelism
over the ``model`` axis (``tensor_parallel_rules``, ``infer_param_sharding``
and, for ``shard_params``, ``shard_tensor_parallel``; the last section of
this file).  The two combine: beside a ``model`` axis the plan is built
over each rank's tensor-parallel slices (``shard_training`` after
``shard_tensor_parallel``), its groups reduce-scattered and gathered over
the ``data`` line of the rank's model index, as the JAX package keeps the
TP layout of the parameters under ``zero1_state_sharding`` and lets
``fsdp_state_sharding`` shard them further.

ZeRO-1 and FSDP are beyond the reference and leave the training math as it is:
the same losses and updates as the replicated data-parallel run.  The
train entry picks the mode as the JAX entry does (``decide_mode``):
``zero1`` or ``fsdp`` need a ``data`` axis of more than one rank and are
otherwise ignored with a printed line; ``fsdp`` subsumes ``zero1``.

- ``zero1`` (Rajbhandari et al. 2020, stage 1): the parameters -- fp32
  masters and compute-dtype copies -- stay replicated; the Adam moments,
  the accumulation buffer and the EMA are sharded.  Per micro-step the
  gradients' all-reduce becomes a ``reduce_scatter`` (the same bytes sent,
  each rank keeps its shard of the data-mean); per optimizer step one
  ``all_gather`` of the updated master shards rebuilds the replicated
  masters and compute copies.  Per rank: moments, accumulator and EMA at
  1/N (plus padding).
- ``fsdp`` (ZeRO-3): the parameters are sharded as well -- every weight of
  the UNet, FSText, the VAE and CLIP, trainable or frozen, as its
  compute-dtype shard, and the trainable masters as fp32 shards.  The
  gathering units are the modules that declare ``fsdp_unit = True`` (the
  resnets, samplers, transformers and their blocks, the attentions, the
  model roots for what is left; a weight belongs to its nearest enclosing
  unit).  A unit holds one byte shard per rank, every (dtype, trainable)
  bucket of its weights end to end, gathers it with one ``all_gather``
  when it is called and frees it when it returns; a weight that autograd
  keeps for the backward is saved as a reference and gathered again when
  the backward reads it, and a ``remat`` recompute gathers again through
  the same hooks.  The gradient of a trainable bucket leaves through one
  ``reduce_scatter`` (``_GatherUnit``'s backward).  Per micro-step: one
  all-gather per unit call in the forward, about one more per unit with
  saved weights in the backward, one reduce-scatter per trainable bucket.
  Per rank: every parameter, master, moment, accumulator and EMA at 1/N
  (plus padding), and one gathered unit at a time plus the weights a
  backward node is reading.

Layout (``FlatLayout``): the leaves of a group laid end to end in one flat
buffer, each starting on a ``ALIGN`` (256) element boundary, the buffer
zero-padded to a multiple of N * 256 and split into N equal shards.  The
JAX rule shards each leaf's largest ``data``-divisible dimension and
replicates the rest; the flat layout holds at most the same bytes per rank
plus the padding (under 256 elements a leaf, and the tail).  The 256 is
the 8-bit moments' block (``optim8bit.BLOCK``): a shard holds whole
blocks that never straddle two leaves, so every int8 code and scale equals
the unsharded run's; it is also 512 bytes or more, so a gathered weight is
a contiguous view with a fresh allocation's alignment (the TMA maps of the
GEGLU kernels need 16 bytes).

The optimizer runs over the groups' master shards (``ShardPlan.masters``,
keyed by group); Adam, the accumulation and the EMA are elementwise and
run shard-local; the global-norm clip all-reduces the shards' sums of
squares (its last bits may differ from the unsharded order of summation).
A checkpoint streams: each group, and each unit's weights, is gathered to
rank 0 alone (``gather_flat``), moved to the host at once and cut into the
unsharded names there (``to_names``, ``module_weights``,
``optimizer_state``), so a save adds at most one group on the card; a
resume lays each group out on the host and keeps this rank's shard
(``load_names``), on any world size.  Under LoRA the adapters stay
replicated in both modes (they are a few MB), their moments and EMA
sharded; under ``fsdp`` each unit applies the adapters' delta to its
gathered weights.

Beside a ``model`` axis: each flat group lays this rank's parts of split
tensors first (``FlatLayout.split_end``), so the clip's norm takes two
partial sums of squares per shard -- the split ones summed over ``data``
and then over ``model``, the replicated ones over ``data`` only
(``ShardPlan.global_norm``); a save joins each group's or unit's leaves
over the model ranks after gathering its shards (``ShardPlan._join``), and
a restore cuts the slices before the shards.
"""
from __future__ import annotations

import contextlib
import math
import re
from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from .collectives import (all_gather, all_gather_flat, all_reduce_,
                          gather_flat, group_rank, reduce_scatter,
                          to_transport)

ALIGN = 256
GROUP_ELEMENTS = 1 << 24    # a replicated group's leaves, before padding
MODES = ("zero1", "fsdp")


def decide_mode(zero1: bool, fsdp: bool, n_data: int):
    """``(mode or None, notes)``: the JAX entry's decision and the lines it
    prints."""
    multi = n_data > 1
    use_fsdp = bool(fsdp) and multi
    use_zero1 = bool(zero1) and multi and not use_fsdp
    notes = []
    if fsdp and not multi:
        notes.append("fsdp: ignored — mesh has no multi-device 'data' axis")
    if zero1 and not multi:
        notes.append("zero1: ignored — mesh has no multi-device 'data' axis")
    if zero1 and use_fsdp:
        notes.append("zero1: subsumed by fsdp (ZeRO-3 already shards the "
                     "moments)")
    return ("fsdp" if use_fsdp else "zero1" if use_zero1 else None), notes


class FlatLayout:
    """Leaves ``names`` of ``shapes`` in one flat buffer split into ``n``
    shards; this rank holds shard ``rank``.  Under a ``model`` axis the
    leaves in ``split`` (this rank's parts of split tensors) come first and
    end at ``split_end``."""

    def __init__(self, names, shapes, n: int, rank: int, split=()):
        self.names = list(names)
        self.shapes = [tuple(s) for s in shapes]
        self.numels = [math.prod(s) for s in self.shapes]
        self.offsets, end = [], 0
        self.split_end = 0
        for name, numel in zip(self.names, self.numels):
            self.offsets.append(end)
            end += -(-numel // ALIGN) * ALIGN
            if name in split:
                if self.split_end != self.offsets[-1]:
                    raise ValueError(f"split leaf {name} after a whole one")
                self.split_end = end
        unit = n * ALIGN
        self.total = max(unit, -(-end // unit) * unit)
        self.shard_numel = self.total // n
        self.n, self.rank = n, rank
        self.lo = rank * self.shard_numel

    def split_count(self) -> int:
        """How many of this rank's shard's elements lie in split leaves
        (they come first)."""
        return min(max(self.split_end - self.lo, 0), self.shard_numel)

    def views(self, flat: torch.Tensor) -> list:
        """The leaves as views of a whole flat buffer."""
        return [flat[o:o + k].view(s)
                for o, k, s in zip(self.offsets, self.numels, self.shapes)]

    def flatten(self, tensors, dtype=None, device=None) -> torch.Tensor:
        """The whole zero-padded flat buffer of ``tensors``."""
        dtype = dtype or tensors[0].dtype
        flat = torch.zeros(self.total, dtype=dtype,
                           device=device or tensors[0].device)
        with torch.no_grad():
            for view, t in zip(self.views(flat), tensors):
                view.copy_(t)
        return flat

    def local(self, flat: torch.Tensor) -> torch.Tensor:
        return flat[self.lo:self.lo + self.shard_numel]

    def blocks(self, i: int) -> tuple[int, int]:
        """(first block, blocks) of leaf ``i`` in ``ALIGN`` blocks."""
        return self.offsets[i] // ALIGN, -(-self.numels[i] // ALIGN)


# ------------------------------------------------------------------ FSDP

class _Packed:
    """A saved weight view, kept as where it lies in its bucket's buffer."""

    __slots__ = ("bucket", "size", "stride", "offset")

    def __init__(self, bucket, t):
        self.bucket = bucket
        self.size, self.stride = t.size(), t.stride()
        self.offset = t.storage_offset()


class _Bucket:
    """The weights of one dtype and one trainability within a unit: a
    ``FlatLayout``, this rank's compute-dtype shard (a view of the unit's
    byte shard at ``lo:hi``) and, when it trains, the master shard its
    gradient reaches (the compute shard itself when the dtypes agree),
    under the optimizer's group ``key``."""

    def __init__(self, unit, layout, slots, dtype, lo, hi, key):
        self.unit, self.layout, self.slots = unit, layout, slots
        self.dtype, self.lo, self.hi, self.key = dtype, lo, hi, key
        self.shard = None
        self.anchor = None
        self.full = None


class _GatherUnit(torch.autograd.Function):
    """Forward: the unit's buckets whole, from one all-gather of every
    rank's byte shard.  Backward: each trainable bucket's gradient in fp32,
    summed over the ranks and divided by the ``data`` size (summed over
    ``seq`` too), reaches this rank's master shard -- the data-mean the
    replicated run all-reduces."""

    @staticmethod
    def forward(ctx, unit, *anchors):
        ctx.unit = unit
        fulls = unit.gather()
        ctx.mark_non_differentiable(*[f for b, f in zip(unit.buckets, fulls)
                                      if b.anchor is None])
        return tuple(fulls)

    @staticmethod
    def backward(ctx, *grads):
        plan = ctx.unit.plan
        out = []
        for b, g in zip(ctx.unit.buckets, grads):
            if b.anchor is None:
                continue
            shard = reduce_scatter(g.float(), plan.group)
            shard /= plan.n
            if plan.seq_group is not None:
                all_reduce_(shard, plan.seq_group)
            out.append(shard)
        return (None, *out)


class _Unit:
    """The weights of one unit module: its buckets, one byte shard per
    rank holding every bucket's shard end to end, so that one all-gather
    brings the whole unit."""

    def __init__(self, plan, module: nn.Module, name: str):
        self.plan, self.module, self.name = plan, module, name
        self.slots = []     # (owner, attr, full name, Parameter)
        self.buckets: list[_Bucket] = []
        self.shard = None   # uint8, this rank's bytes of every bucket

    def split(self, whole: torch.Tensor) -> list:
        """Every bucket's whole buffer from the ranks' byte shards joined
        in rank order (views when the unit has one bucket)."""
        if len(self.buckets) == 1:
            return [whole.view(self.buckets[0].dtype)]
        rows = whole.view(self.plan.n, -1)
        return [rows[:, b.lo:b.hi].contiguous().view(-1).view(b.dtype)
                for b in self.buckets]

    def gather(self) -> list:
        return self.split(all_gather_flat(self.shard, self.plan.group))

    def open(self, lora: bool) -> None:
        plan = self.plan
        anchors = [b.anchor for b in self.buckets if b.anchor is not None]
        if anchors and torch.is_grad_enabled():
            fulls = _GatherUnit.apply(self, *anchors)
        else:
            fulls = self.gather()
        for b, full in zip(self.buckets, fulls):
            b.full = full
            plan.live[full.untyped_storage().data_ptr()] = b
            for (owner, attr, name, _), view in zip(
                    b.slots, b.layout.views(full)):
                if lora and name in plan.lora_map:
                    a, lb = plan.lora_map[name]
                    delta = plan.lora_scale * (a.float() @ lb.float())
                    view = (view.float() + delta.t()).to(view.dtype)
                owner._parameters[attr] = view

    def close(self) -> None:
        for b in self.buckets:
            if b.full is not None:
                self.plan.live.pop(b.full.untyped_storage().data_ptr(), None)
                b.full = None
            for owner, attr, _, param in b.slots:
                owner._parameters[attr] = param


class ShardPlan:
    """The sharded training state of one rank: the optimizer's groups
    (``layouts``, ``masters`` keyed by group), and under ``fsdp`` the
    units that hold every module weight as a shard."""

    def __init__(self, mode: str, mesh):
        if mode not in MODES:
            raise ValueError(f"unknown sharding mode {mode!r}")
        self.mode = mode
        self.group = mesh.group("data")
        self.n, self.rank = mesh.axis_size("data"), mesh.axis_index("data")
        self.seq_group = mesh.group("seq")
        # the data x seq ranks of this model index: the loss pair's sum
        self.replica_group = mesh.replica_group()
        self.tp: Optional[TensorParallel] = None
        self.split: set = set()      # this rank's parts of split tensors
        self.layouts: dict = {}      # group -> FlatLayout
        self.masters: dict = {}      # group -> master shard
        self.buffers: dict = {}      # replicated group -> whole buffer
        self.replicated: list = []   # groups whose gradients arrive whole
        self.units: list[_Unit] = []
        self.bucket_of: dict = {}    # unit group -> its trainable _Bucket
        self.live: dict = {}         # storage pointer -> open _Bucket
        self.lora_map: dict = {}
        self.lora_scale = 0.0
        self._cache: dict = {}       # the last unit's buckets gathered again
        self.training = False

    # ------------------------------------------------------------ build
    def _add_replicated(self, names, models) -> None:
        """Masters that stay whole on every rank (all of them under zero1,
        the LoRA adapters under fsdp), grouped in order by dtype into flat
        groups of at most ``GROUP_ELEMENTS``.  Each master (and a module
        parameter that is its own master) becomes a view of its group's
        flat buffer, and this rank's shard is a view of that buffer too:
        the optimizer updates it in place, ``after_step`` gathers the rest
        into it."""
        masters = models.masters
        params = {p.data_ptr(): p for p in models.named_trainable().values()}
        by_dtype: dict = {}
        for name in names:
            by_dtype.setdefault(masters[name].dtype, []).append(name)
        for group in by_dtype.values():
            chunk, size = [], 0
            for name in self._split_first(group) + [None]:
                numel = masters[name].numel() if name else 0
                if chunk and (name is None or size + numel > GROUP_ELEMENTS):
                    key = f"replicated{len(self.replicated)}"
                    layout = FlatLayout(chunk, [masters[n].shape
                                                for n in chunk],
                                        self.n, self.rank, self.split)
                    flat = layout.flatten([masters[n] for n in chunk])
                    for n, view in zip(chunk, layout.views(flat)):
                        param = params.get(masters[n].data_ptr())
                        if param is not None:
                            param.data = view
                        masters[n].data = view
                    self.layouts[key] = layout
                    self.buffers[key] = flat
                    self.masters[key] = layout.local(flat)
                    self.replicated.append(key)
                    chunk, size = [], 0
                if name:
                    chunk.append(name)
                    size += numel

    def _add_units(self, models) -> set:
        """Every weight of the four models into its unit's shards; the
        modules keep empty placeholders.  Returns the trainable names the
        units took."""
        masters = models.masters
        taken = set()
        for key in ("unet", "fstext", "vae", "clip"):
            root = getattr(models, key)
            units: dict = {}
            # the modules that gather their own weights when called
            # declare it (``fsdp_unit = True`` on the class); a weight
            # belongs to its nearest enclosing unit
            paths = {mname for mname, m in root.named_modules()
                     if getattr(m, "fsdp_unit", False)}
            for mname, m in root.named_modules():
                for attr, p in m.named_parameters(recurse=False):
                    path = mname
                    while path and path not in paths:
                        path = path.rpartition(".")[0]
                    if path not in paths:
                        # no enclosing unit: the owning module is one
                        path = mname
                        paths.add(path)
                    unit = units.get(path)
                    if unit is None:
                        unit = units[path] = _Unit(
                            self, root.get_submodule(path),
                            f"{key}.{path}" if path else key)
                    full = f"{key}.{mname}.{attr}" if mname else f"{key}.{attr}"
                    unit.slots.append((m, attr, full, p))
            for unit in units.values():
                self._shard_unit(unit, masters, taken)
                unit.module.register_forward_pre_hook(self._pre(unit))
                unit.module.register_forward_hook(self._post(unit))
                self.units.append(unit)
        return taken

    def _shard_unit(self, unit: _Unit, masters: dict, taken: set) -> None:
        """The unit's weights into buckets by (dtype, trainable), each
        bucket's shard laid end to end in the unit's byte shard."""
        by_kind: dict = {}
        for slot in unit.slots:
            by_kind.setdefault((slot[3].dtype, slot[2] in masters),
                               []).append(slot)
        parts, lo = [], 0
        for (dtype, trains), slots in by_kind.items():
            slots = sorted(slots, key=lambda sl: sl[2] not in self.split)
            names = [sl[2] for sl in slots]
            layout = FlatLayout(names, [sl[3].shape for sl in slots], self.n,
                                self.rank, self.split)
            part = layout.local(layout.flatten(
                [sl[3].detach() for sl in slots])).view(torch.uint8)
            key = (f"{unit.name}:{str(dtype).split('.')[-1]}" if trains
                   else None)
            b = _Bucket(unit, layout, slots, dtype, lo, lo + part.numel(),
                        key)
            lo = b.hi
            parts.append(part)
            unit.buckets.append(b)
            if trains:
                self.layouts[key] = layout
                self.bucket_of[key] = b
                taken.update(names)
        unit.shard = torch.cat(parts)
        for b in unit.buckets:
            b.shard = unit.shard[b.lo:b.hi].view(b.dtype)
            if b.key is None:
                continue
            if all(masters[sl[2]].data_ptr() == sl[3].data_ptr()
                   for sl in b.slots):
                b.anchor = b.shard       # the parameters are the masters
            else:
                b.anchor = b.layout.local(b.layout.flatten(
                    [masters[sl[2]] for sl in b.slots])).clone()
            b.anchor.requires_grad_(True)
            self.masters[b.key] = b.anchor
        for _, _, _, p in unit.slots:
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)

    def _split_first(self, names: list) -> list:
        """``names`` with this rank's parts of split tensors first (the
        norm's two partial sums are then two slices of a shard)."""
        return sorted(names, key=lambda n: n not in self.split)

    def _pre(self, unit):
        def hook(module, args):
            unit.open(lora=self.training and bool(self.lora_map))
        return hook

    def _post(self, unit):
        def hook(module, args, out):
            unit.close()
        return hook

    # ------------------------------------------------------- training
    @contextlib.contextmanager
    def training_pass(self):
        """Around a training forward and its backward: LoRA deltas applied
        at each unit's gather (a remat recompute included), every weight
        view autograd saves kept as a reference that the backward gathers
        again; afterwards the regathered buffer is dropped."""
        self.training = True
        try:
            with torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                          self._unpack):
                yield
        finally:
            self.training = False
            self.release()

    def _pack(self, t):
        try:
            b = self.live.get(t.untyped_storage().data_ptr())
        except (RuntimeError, NotImplementedError):
            return t
        if b is None or b.full is None or t.dtype != b.full.dtype:
            return t
        return _Packed(b, t)

    def _unpack(self, p):
        if not isinstance(p, _Packed):
            return p
        unit = p.bucket.unit
        fulls = self._cache.get(unit)
        if fulls is None:
            # one unit at a time, chosen by the order the backward reads
            # them -- the same on every rank, so the gathers pair up
            self._cache.clear()
            fulls = self._cache[unit] = dict(zip(unit.buckets,
                                                 unit.gather()))
        return fulls[p.bucket].as_strided(p.size, p.stride, p.offset)

    def release(self) -> None:
        """After a backward: drop the regathered buffers and close any unit
        a stopped recompute left open."""
        self._cache.clear()
        for unit in self.units:
            unit.close()
        self.live.clear()

    def grad_targets(self, models) -> tuple[list, list]:
        """``(names, tensors)`` autograd differentiates: the replicated
        groups' tensors by name, then the fsdp units' master shards by
        group."""
        named = models.named_trainable()
        names = [n for g in self.replicated for n in self.layouts[g].names]
        tensors = [named[n] for n in names]
        groups = list(self.bucket_of)
        return names + groups, tensors + [self.masters[g] for g in groups]

    def reduce_grads(self, grads: dict) -> dict:
        """``{group: gradient shard}``: the replicated groups' whole fp32
        gradients reduce-scattered (data-mean, summed over seq); the units'
        shards as their backward left them."""
        out = {}
        for g in self.replicated:
            layout = self.layouts[g]
            flat = layout.flatten([grads[n] for n in layout.names],
                                  dtype=torch.float32)
            shard = reduce_scatter(flat, self.group)
            shard /= self.n
            if self.seq_group is not None:
                all_reduce_(shard, self.seq_group)
            out[g] = shard
        for g in self.bucket_of:
            out[g] = grads[g]
        return out

    def global_norm(self, tensors) -> torch.Tensor:
        """The global norm of the sharded gradient (``tensors`` in the
        order of ``masters``): the shards' sums of squares, all-reduced
        over ``data``.  Under a ``model`` axis the squares of split leaves
        (each group's first elements) are summed over ``data`` and then
        over ``model``, those of replicated leaves over ``data`` only: the
        norm of one rank's gradient."""
        if self.tp is None:
            total = _sum_squares(tensors).reshape(1)
            all_reduce_(total, self.group)
            return total[0].sqrt()
        counts = [self.layouts[g].split_count() for g in self.masters]
        parts = torch.stack([
            _sum_squares([t[:k] for t, k in zip(tensors, counts)]),
            _sum_squares([t[k:] for t, k in zip(tensors, counts)])])
        all_reduce_(parts, self.group)
        all_reduce_(parts[:1], self.tp.group)
        return parts.sum().sqrt()

    @torch.no_grad()
    def after_step(self, models) -> None:
        """After an optimizer step: the replicated masters gathered whole
        (and, under zero1, the compute copies refreshed); the units'
        compute shards from their master shards."""
        for g in self.replicated:
            self.buffers[g].copy_(all_gather_flat(self.masters[g],
                                                  self.group))
        for b in self.bucket_of.values():
            if b.anchor is not b.shard:
                b.shard.copy_(b.anchor)
        if self.mode == "zero1":
            from ..training.trainer import sync_compute_copies

            sync_compute_copies(models)

    # ---------------------------------------------------- checkpoints
    # A checkpoint streams: one group or one unit at a time is gathered to
    # rank 0 of ``data`` only, moved to the host at once and cut into
    # leaves there, so no rank ever holds more of the unsharded state on
    # the card than the largest group.  Under a ``model`` axis a second
    # stage joins those leaves' parts over the model ranks of the writing
    # line (``TensorParallel.gather_dict``) on the host, group by group.
    # Every rank calls these in the same order; the ones that do not write
    # get None.

    def _whole(self, shard: torch.Tensor):
        return gather_flat(shard.detach(), self.group, device="cpu")

    def _join(self, part: Optional[dict]):
        """The second stage: ``part`` (by name, on data rank 0) with its
        split tensors joined over ``model``."""
        return part if self.tp is None else self.tp.gather_dict(part)

    def _writes(self) -> bool:
        """True on the rank the two stages leave the whole state on."""
        return self.rank == 0 and (self.tp is None or (
            self.tp.writes() and self.tp.rank == 0))

    def to_names(self, shards: dict):
        """``{group: shard}`` -> ``{name: whole tensor}`` on the host of
        the writing rank, None elsewhere."""
        out = {}
        for g, shard in shards.items():
            full = self._whole(shard)
            part = None if full is None else dict(zip(
                self.layouts[g].names,
                (v.clone() for v in self.layouts[g].views(full))))
            out.update(self._join(part) or {})
        return out if self._writes() else None

    def module_weights(self):
        """Every unit's weights ``{"<model>.<name>": whole tensor}`` (fsdp;
        under zero1 the modules hold them whole) on the host of the
        writing rank, None elsewhere."""
        out = {}
        for unit in self.units:
            whole = self._whole(unit.shard)
            part = None
            if whole is not None:
                part = {}
                for b, full in zip(unit.buckets, unit.split(whole)):
                    part.update(zip((sl[2] for sl in b.slots),
                                    (v.clone() for v in
                                     b.layout.views(full))))
            out.update(self._join(part) or {})
        return out if self._writes() else None

    def load_names(self, shards: dict, whole: dict) -> None:
        """``{name: whole tensor}`` into this rank's ``{group: shard}``
        (each group laid out on the host, its shard copied over)."""
        with torch.no_grad():
            for g, shard in shards.items():
                layout = self.layouts[g]
                flat = layout.flatten([whole[n] for n in layout.names],
                                      dtype=shard.dtype, device="cpu")
                shard.copy_(layout.local(flat))

    def optimizer_state(self, optimizer):
        """The optimizer's state dict by parameter name, as an unsharded
        optimizer writes it, on the host of rank 0; None elsewhere."""
        state = optimizer.state_dict()
        out = {"count": state["count"], "mini_step": state["mini_step"],
               "acc": (self.to_names(state["acc"])
                       if state["acc"] is not None else None)}
        for key in ("mu", "nu"):
            if is_quantized(state[key]):
                out[key] = self._q_to_names(state[key], key == "mu")
            else:
                out[key] = self.to_names(state[key])
        return out if self._writes() else None

    def _q_to_names(self, qs: dict, signed: bool) -> dict:
        out = {}
        for g, q in qs.items():
            layout = self.layouts[g]
            codes, scales = self._whole(q["codes"]), self._whole(q["scales"])
            part = None
            if codes is not None:
                codes, scales = codes.view(-1, ALIGN), scales.view(-1, 1)
                part = {}
                for i, name in enumerate(layout.names):
                    b0, nb = layout.blocks(i)
                    part[name] = {"codes": codes[b0:b0 + nb].clone(),
                                  "scales": scales[b0:b0 + nb].clone()}
            if self.tp is not None:
                part = self.tp.gather_q(part, dict(zip(layout.names,
                                                       layout.shapes)),
                                        signed)
            out.update(part or {})
        return out

    def load_optimizer_state(self, optimizer, saved: dict) -> None:
        """An unsharded optimizer state dict into the sharded optimizer."""
        state = optimizer.state_dict()
        local = {"count": saved["count"], "mini_step": saved["mini_step"],
                 "acc": None}
        if state["acc"] is not None and saved.get("acc") is not None:
            self.load_names(state["acc"], saved["acc"])
        for key in ("mu", "nu"):
            if is_quantized(state[key]):
                # a block no leaf owns keeps the zero moment's code
                local[key] = self._q_from_names(state[key], saved[key],
                                                -128 if key == "nu" else 0)
            else:
                self.load_names(state[key], saved[key])
                local[key] = state[key]
        optimizer.load_state_dict(local)

    def _q_from_names(self, qs: dict, saved: dict, fill: int) -> dict:
        out = {}
        for g, q in qs.items():
            layout = self.layouts[g]
            blocks = layout.total // ALIGN
            codes = torch.full((blocks, ALIGN), fill, dtype=torch.int8)
            scales = torch.zeros(blocks, 1)
            for i, name in enumerate(layout.names):
                b0, nb = layout.blocks(i)
                codes[b0:b0 + nb] = saved[name]["codes"]
                scales[b0:b0 + nb] = saved[name]["scales"]
            lo, per = self.rank * (blocks // self.n), blocks // self.n
            out[g] = {"codes": codes[lo:lo + per].to(q["codes"].device),
                      "scales": scales[lo:lo + per].to(q["scales"].device)}
        return out

    # ------------------------------------------------------- accounting
    def largest_unit_bytes(self) -> int:
        """Bytes of the largest unit's weights gathered whole (fsdp)."""
        return max((unit.shard.numel() * self.n for unit in self.units),
                   default=0)

    def replicated_tensors(self, models) -> list:
        """The trainable tensors every rank holds whole (the replicas'
        check after each step)."""
        return [models.masters[n] for g in self.replicated
                for n in self.layouts[g].names]


def shard_training(models, mode: str, mesh, lora_scale: float = 0.0
                   ) -> ShardPlan:
    """Shard ``models`` (built for training, cut to this rank's slices
    under a ``model`` axis, ``trainable_masters`` taken, LoRA enabled if it
    is on) for ``mode`` over ``mesh``'s ``data`` axis; the plan is also
    ``models.sharding``.  Under fsdp the modules keep empty placeholders
    and ``models.masters`` only the replicated masters."""
    plan = ShardPlan(mode, mesh)
    plan.tp = models.tensor_parallel
    if plan.tp is not None:
        plan.split = set(plan.tp.splits)
    masters = models.masters
    taken = set()
    if mode == "fsdp":
        if models.lora:
            plan.lora_scale = float(lora_scale)
            for key, a in models.lora.items():
                if key.endswith(".lora_a"):
                    stem = key[:-len("lora_a")]
                    plan.lora_map["unet." + stem + "weight"] = (
                        a, models.lora[stem + "lora_b"])
        taken = plan._add_units(models)
    plan._add_replicated([n for n in masters if n not in taken], models)
    models.masters = {n: t for n, t in masters.items() if n not in taken}
    models.sharding = plan
    return plan


def _sum_squares(tensors) -> torch.Tensor:
    """The sum of squares of every element of ``tensors``, fp32."""
    sq = torch.stack([n.float() for n in torch._foreach_norm(tensors)])
    return (sq * sq).sum()


def param_bytes(models) -> int:
    """Bytes this rank holds of parameters and masters (the modules'
    weights, the fp32 masters, the fsdp shards), each storage once."""
    seen, total = set(), 0

    def add(t):
        nonlocal total
        if t is None or t.numel() == 0:
            return
        key = t.untyped_storage().data_ptr()
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()

    for m in models.modules():
        for p in m.parameters():
            add(p)
    for t in (models.masters or {}).values():
        add(t)
    plan = getattr(models, "sharding", None)
    if plan is not None:
        for unit in plan.units:
            add(unit.shard)
            for b in unit.buckets:
                add(b.anchor)
        for t in plan.masters.values():
            add(t)
    return total


# ------------------------------------------------------ tensor parallelism
#
# The Megatron pattern (Shoeybi et al. 2019) over the ``model`` axis: the
# Q/K/V and feed-forward up-projections split their output features
# ("column": weight rows and bias), the output and down-projections their
# input features ("row": weight columns; the bias stays whole and is added
# once after the sum).  Each rank then holds its slice of the heads and of
# the hidden units; the model code runs the attention kernels on the local
# heads and closes each row-parallel projection with one all-reduce
# (``collectives.row_parallel_linear``), with ``copy_to_model`` at the input
# of each column group.  The JAX package expresses the same split as
# ``PartitionSpec``s and lets GSPMD insert the all-reduce.
#
# A split falls on a unit: the modules that declare ``tp_group`` (the
# attentions, the feed-forwards, CLIP's attention and MLP).  A unit splits
# when every weight of it that the rules match divides over the ``model``
# ranks and, for an attention, so do its heads; otherwise it stays
# replicated, as the JAX rule replicates a weight whose features do not
# divide (a split has to fall on head boundaries here, where the JAX
# package's GSPMD may split inside a head).  The VAE's ``query`` / ``key``
# / ``value`` match no rule and stay replicated, as in JAX.


class Split(NamedTuple):
    """How a tensor is cut over the ``model`` ranks: ``dim`` the axis cut,
    ``halves`` the blocks of that axis each rank takes its part of (2 for
    the GEGLU projection, whose rows are [hidden | gate])."""

    dim: int
    halves: int = 1


COLUMN = Split(0)
ROW = Split(1)
# the fused [hidden | gate] rows of GEGLU: each rank keeps its slice of the
# hidden rows AND its slice of the gate rows (a contiguous cut would give
# one rank every hidden row and the other every gate row), so the product
# hidden * gelu(gate) is local -- the JAX package's Megatron GEGLU
GEGLU_COLUMN = Split(0, 2)


PREFIX_LORA = "lora."    # the adapters' names among the masters


def is_quantized(moment: Optional[dict]) -> bool:
    """True for an 8-bit moment's ``{name: {"codes", "scales"}}``."""
    return isinstance(next(iter((moment or {}).values()), None), dict)


def _map_optimizer(state: dict, tensors, quantized) -> dict:
    """``state`` (an optimizer state dict) with ``tensors(dict)`` applied
    to its by-name tensor dicts and ``quantized(dict, signed)`` to 8-bit
    moments."""
    out = dict(state)
    out["acc"] = tensors(state.get("acc"))
    for key in ("mu", "nu"):
        out[key] = (quantized(state[key], key == "mu")
                    if is_quantized(state[key]) else tensors(state[key]))
    return out


def tensor_parallel_rules() -> list[tuple[str, Split]]:
    """(regex over ``"<model>.<parameter>"`` names, split) -- first match
    wins.  The JAX table over the port's names: its ``P(None, "model")`` on
    an (in, out) kernel is ``COLUMN`` of a torch (out, in) weight, its
    ``P("model", None)`` is ``ROW``."""
    return [
        # attention: heads (output features) of q/k/v; input of out-proj
        (r".*\.(to_q|to_k|to_v)\.weight$", COLUMN),
        (r".*\.to_out\.0\.weight$", ROW),
        (r".*\.(q_proj|k_proj|v_proj)\.weight$", COLUMN),
        (r".*\.out_proj\.weight$", ROW),
        # feed-forward: GEGLU up-proj out features, down-proj in features
        (r".*\.ff\.net\.0\.proj\.weight$", GEGLU_COLUMN),
        (r".*\.ff\.net\.2\.weight$", ROW),
        (r".*\.fc1\.weight$", COLUMN),
        (r".*\.fc2\.weight$", ROW),
    ]


def _compiled(rules=None) -> list:
    return [(re.compile(p), s) for p, s in (rules or tensor_parallel_rules())]


def _rule(name: str, rules) -> Optional[Split]:
    for pattern, split in rules:
        if pattern.match(name):
            return split
    return None


def _tp_units(models):
    """``(qualified name, unit)`` of every tensor-parallel unit of the four
    models, in module order."""
    for key in ("unet", "fstext", "vae", "clip"):
        for name, module in getattr(models, key).named_modules():
            if hasattr(module, "tp_group"):
                yield f"{key}.{name}", module


def _unit_splits(prefix: str, unit: nn.Module, m: int, rules) -> dict:
    """``{parameter name: Split}`` of ``unit`` at ``m`` ranks, or {} when
    it stays replicated."""
    splits = {}
    for sub, lin in unit.named_modules():
        if not isinstance(lin, nn.Linear):
            continue
        stem = f"{prefix}.{sub}."
        split = _rule(stem + "weight", rules)
        if split is None:
            continue
        size = lin.weight.shape[split.dim]
        if size % (m * split.halves):
            return {}
        splits[stem + "weight"] = split
        if lin.bias is not None and split.dim == 0:
            splits[stem + "bias"] = split
    heads = getattr(unit, "heads", None)
    if heads is not None and heads % m:
        return {}
    return splits


def infer_param_sharding(models, m: int, rules=None) -> dict:
    """``{"<model>.<parameter>": Split}`` of every weight that splits over
    ``m`` model ranks; a name not in it is replicated."""
    rules = _compiled(rules)
    splits = {}
    if m > 1:
        for prefix, unit in _tp_units(models):
            splits.update(_unit_splits(prefix, unit, m, rules))
    return splits


def tp_slice(whole: torch.Tensor, split: Split, m: int,
             rank: int) -> torch.Tensor:
    """Rank ``rank``'s part of ``whole`` (a new contiguous tensor)."""
    blocks = whole.chunk(split.halves, dim=split.dim)
    return torch.cat([b.chunk(m, dim=split.dim)[rank] for b in blocks],
                     dim=split.dim)


def tp_join(parts: list, split: Split) -> torch.Tensor:
    """The whole tensor from every rank's part, in rank order."""
    blocks = [p.chunk(split.halves, dim=split.dim) for p in parts]
    return torch.cat([torch.cat([b[i] for b in blocks], dim=split.dim)
                      for i in range(split.halves)], dim=split.dim)


class TensorParallel:
    """The model-axis layout of a set of models (``models.tensor_parallel``):
    which tensors are split, this rank's place, and the moves between whole
    tensors and this rank's parts (checkpoints, finetuned weights, the
    clip's global norm)."""

    def __init__(self, mesh, splits: dict):
        self.mesh = mesh
        self.group = mesh.group("model")
        self.m = mesh.axis_size("model")
        self.rank = mesh.axis_index("model")
        self.splits = splits
        # trainable tensors held whole on every model rank whose gradient
        # there is a partial sum (LoRA's factor that a split leaves whole)
        self.partial: set = set()

    def whole_shape(self, name: str, shape) -> tuple:
        """The whole tensor's shape from this rank's part's."""
        shape = list(shape)
        split = self.splits.get(name)
        if split is not None:
            shape[split.dim] *= self.m
        return tuple(shape)

    def add_lora(self, lora: dict) -> dict:
        """This rank's parts of whole adapters (``{"<path>.lora_a" |
        ".lora_b": tensor}``, drawn as one rank draws them), registered
        under their ``"lora.<key>"`` names.  ``W + s (A @ B)^T`` with W
        (out, in), A (in, r), B (r, out): under a column split of W (its
        rows) B keeps its columns of ``out`` and A stays whole; under a row
        split A keeps its rows of ``in`` and B stays whole.  The whole
        factor sees only this rank's slice of the product, so its gradient
        is a partial sum over the model ranks (``partial``,
        ``sum_partial``)."""
        out = {}
        for key, t in lora.items():
            a_side = key.endswith(".lora_a")
            stem = key[:-len("lora_a")]
            split = self.splits.get("unet." + stem + "weight")
            name = PREFIX_LORA + key
            part = None
            if split is not None:
                if split.halves != 1:
                    raise ValueError(f"LoRA on a split of halves: {key}")
                # A (in, r) keeps its rows under a row split, B (r, out)
                # its columns under a column split
                part = ((Split(0) if a_side else None) if split.dim == 1
                        else (None if a_side else Split(1)))
                if part is None:
                    self.partial.add(name)
            if part is None:
                out[key] = t
                continue
            self.splits[name] = part
            with torch.no_grad():
                local = tp_slice(t.detach(), part, self.m, self.rank)
            out[key] = local.requires_grad_(t.requires_grad)
        return out

    def sum_partial(self, grads: dict) -> None:
        """In place: the gradients of ``partial`` tensors summed over the
        model ranks (one all-reduce); every model rank then holds the
        whole factor's gradient, as a replicated tensor's."""
        names = [n for n in grads if n in self.partial]
        if not names:
            return
        flat = torch.cat([grads[n].reshape(-1) for n in names])
        all_reduce_(flat, self.group)
        for n, part in zip(names, flat.split([grads[n].numel()
                                              for n in names])):
            grads[n] = part.view_as(grads[n])

    def keeps_blocks(self, name: str, shape) -> bool:
        """True when the 8-bit moments' blocks of 256 over this rank's
        part (local ``shape``) of ``name`` are blocks of the whole leaf:
        the part's contiguous runs in the whole leaf (a column split's one
        run, or one a half; a row split's one a row) are whole multiples of
        256.  Then the part's codes and scales are the whole leaf's."""
        split = self.splits.get(name)
        if split is None:
            return True
        run = shape[split.dim] // split.halves * math.prod(
            shape[split.dim + 1:])
        return run % ALIGN == 0

    def local(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's part of the tensor ``name`` (itself when it is not
        split)."""
        split = self.splits.get(name)
        if split is None:
            return whole
        return tp_slice(whole, split, self.m, self.rank)

    def whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor ``name`` from every model rank's part, on
        every rank (each rank of the model group calls it)."""
        split = self.splits.get(name)
        if split is None:
            return t
        return tp_join(all_gather(t.contiguous(), self.group), split)

    def local_dict(self, tensors: Optional[dict], prefix: str = ""):
        """``local`` of every entry; keys are ``prefix + key``'s names."""
        if tensors is None:
            return None
        return {k: self.local(prefix + k, t) for k, t in tensors.items()}

    def writes(self) -> bool:
        """True on the model line of the writing rank (global rank 0): its
        ranks take part in ``gather_dict``."""
        return (self.mesh.axis_index("data") == 0
                and self.mesh.axis_index("seq") == 0)

    def gather_dict(self, tensors: Optional[dict], prefix: str = ""):
        """Every entry whole, on the CPU of model rank 0 of the writing
        line (the first rank); None on the other ranks.  The split entries
        move in one ``gather_flat`` per dtype.  Every rank calls it."""
        if tensors is None or not self.writes():
            return None
        return self._join({k: (t, self.splits.get(prefix + k))
                           for k, t in tensors.items()})

    def _join(self, entries: dict):
        """``{key: (part, Split or None)}`` -> ``{key: whole}`` on the CPU
        of model rank 0 (None elsewhere): a None split's part as it is, the
        others gathered, one ``gather_flat`` per dtype."""
        out = {k: t.detach().cpu() for k, (t, split) in entries.items()
               if split is None}
        by_dtype: dict = {}
        for k, (t, split) in entries.items():
            if split is not None:
                by_dtype.setdefault(t.dtype, []).append(k)
        for dtype in sorted(by_dtype, key=str):
            keys = by_dtype[dtype]
            flat = torch.cat([entries[k][0].detach().reshape(-1)
                              for k in keys])
            whole = gather_flat(to_transport(flat, self.group), self.group,
                                dst=0, device="cpu")
            if whole is None:
                continue
            ranks = whole.chunk(self.m)
            offset = 0
            for k in keys:
                t, split = entries[k]
                parts = [r[offset:offset + t.numel()].view(t.shape)
                         for r in ranks]
                offset += t.numel()
                out[k] = tp_join(parts, split)
        return out if group_rank(self.group) == 0 else None

    def gather_q(self, qs: Optional[dict], shapes: dict, signed: bool):
        """``gather_dict`` of one 8-bit moment (``{name: {"codes",
        "scales"}}`` in blocks of this rank's parts, ``shapes`` their local
        shapes): the whole leaves' codes and scales, as a single rank
        keeps them, on the CPU of model rank 0.  A part whose blocks are
        the whole leaf's (``keeps_blocks``) joins its codes and scales
        (bit for bit); any other split part is dequantized, joined in fp32
        and quantized again in the whole leaf's blocks (``signed``: the
        first moment's map, else the second's), which moves a value by at
        most half a code step of its whole-leaf block."""
        from ..training import optim8bit as q8

        if qs is None or not self.writes():
            return None
        entries = {}
        for name, q in qs.items():
            codes, scales = q["codes"].cpu(), q["scales"].cpu()
            split, shape = self.splits.get(name), shapes[name]
            if split is None:
                entries[name] = ({"codes": codes, "scales": scales}, None)
            elif self.keeps_blocks(name, shape):
                entries[name + "#codes"] = (codes.reshape(shape), split)
                entries[name + "#scales"] = (
                    scales.expand(-1, ALIGN).reshape(shape), split)
            else:
                deq = q8.dequantize_signed if signed else q8.dequantize_sqrt
                entries[name + "#values"] = (deq(q8.Q(codes, scales), shape),
                                             split)
        plain = {k: v for k, v in entries.items() if v[1] is not None}
        joined = self._join(plain)
        if joined is None:
            return None
        out = {k: v for k, (v, split) in entries.items() if split is None}
        quant = q8.quantize_signed if signed else q8.quantize_sqrt
        for name in qs:
            if name + "#codes" in joined:
                out[name] = {"codes": q8.blocked(joined[name + "#codes"]),
                             "scales": q8.blocked(
                                 joined[name + "#scales"])[:, :1].clone()}
            elif name + "#values" in joined:
                codes, scales = quant(joined[name + "#values"])
                out[name] = {"codes": codes, "scales": scales}
        return out

    def local_q(self, qs: Optional[dict], shapes: dict, signed: bool):
        """The reverse of ``gather_q`` on every rank: this rank's parts'
        codes and scales of whole leaves' (local ``shapes``); a part that
        does not keep the whole leaf's blocks is dequantized whole, cut and
        quantized again in its own blocks."""
        from ..training import optim8bit as q8

        if qs is None:
            return None
        out = {}
        quant = q8.quantize_signed if signed else q8.quantize_sqrt
        deq = q8.dequantize_signed if signed else q8.dequantize_sqrt
        for name, q in qs.items():
            split = self.splits.get(name)
            if split is None:
                out[name] = q
                continue
            whole = self.whole_shape(name, shapes[name])
            cut = lambda t: tp_slice(t, split, self.m, self.rank)  # noqa: E731
            if self.keeps_blocks(name, shapes[name]):
                scales = q["scales"].expand(-1, ALIGN).reshape(whole)
                out[name] = {"codes": q8.blocked(cut(q["codes"].reshape(
                                 whole))),
                             "scales": q8.blocked(cut(scales))[:, :1].clone()}
            else:
                codes, scales = quant(cut(deq(q8.Q(q["codes"], q["scales"]),
                                              whole)))
                out[name] = {"codes": codes, "scales": scales}
        return out

    def gather_optimizer(self, state: dict, shapes: dict):
        """``Optimizer.state_dict`` of this rank's parts, whole (the
        moments, 8-bit or not, and the accumulator) on the CPU of model
        rank 0 of the writing line."""
        return _map_optimizer(state, self.gather_dict,
                              lambda qs, signed: self.gather_q(qs, shapes,
                                                               signed))

    def local_optimizer(self, saved: dict, shapes: dict) -> dict:
        """A whole optimizer state dict cut to this rank's parts."""
        return _map_optimizer(saved, self.local_dict,
                              lambda qs, signed: self.local_q(qs, shapes,
                                                              signed))

    def module_weights(self, models) -> Optional[dict]:
        """``{"<model>.<name>": whole tensor}`` of every split weight of
        the UNet and FSText (what a checkpoint's weight files take from
        the modules), on the writing rank; None elsewhere."""
        named = {f"{key}.{n}": p for key, mod in
                 models.trainable_modules().items()
                 for n, p in mod.named_parameters() if f"{key}.{n}" in
                 self.splits}
        return self.gather_dict(named)

    def global_norm_fn(self, names: list):
        """The clip's global norm over tensors in ``names``' order: a split
        tensor's squares summed over the ``model`` ranks, a replicated
        one's counted once."""
        split = torch.tensor([n in self.splits for n in names])

        def norm(tensors) -> torch.Tensor:
            sq = torch.stack(torch._foreach_norm(tensors)).float() ** 2
            mask = split.to(sq.device)
            parts = torch.stack([sq[mask].sum(), sq[~mask].sum()])
            all_reduce_(parts[:1], self.group)
            return parts.sum().sqrt()

        return norm


def shard_tensor_parallel(models, mesh) -> Optional[TensorParallel]:
    """Cut ``models`` (built, loaded and equal on every rank) to this
    rank's slices over ``mesh``'s ``model`` axis, in place: each split
    Linear keeps its rows (column) or columns (row) and its features
    count, each split attention its local head count, each unit its
    ``model`` group; the masters are cut alike.  The layout is also
    ``models.tensor_parallel``.  None (and nothing changes) without a
    ``model`` axis of more than one rank."""
    m = mesh.axis_size("model") if mesh is not None else 1
    if m == 1:
        return None
    tp = TensorParallel(mesh, {})
    masters = models.masters or {}
    rules = _compiled()
    for prefix, unit in _tp_units(models):
        mine = _unit_splits(prefix, unit, m, rules)
        if not mine:
            continue
        tp.splits.update(mine)
        unit.tp_group = tp.group
        if getattr(unit, "heads", None) is not None:
            unit.heads //= m
        for sub, lin in unit.named_modules():
            if not isinstance(lin, nn.Linear):
                continue
            stem = f"{prefix}.{sub}."
            for pname in ("weight", "bias"):
                name = stem + pname
                if name not in mine:
                    continue
                p = getattr(lin, pname)
                master = masters.get(name)
                shared = (master is not None
                          and master.data_ptr() == p.data_ptr())
                p.data = tp.local(name, p.data)
                if shared:
                    masters[name] = p.data
                elif master is not None:
                    masters[name] = tp.local(name, master)
            lin.out_features, lin.in_features = lin.weight.shape
    models.tensor_parallel = tp
    return tp
