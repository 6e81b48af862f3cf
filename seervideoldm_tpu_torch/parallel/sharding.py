"""ZeRO-1 and FSDP over the ``data`` axis (port of the first two parts of
``seervideoldm_tpu/parallel/sharding.py``: ``zero1_state_sharding`` and
``fsdp_param_sharding`` / ``fsdp_state_sharding``; the tensor-parallel
``model`` rules are not ported).

Both modes are beyond the reference and leave the training math as it is:
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
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn

from .collectives import (all_gather_flat, all_reduce_, gather_flat,
                          reduce_scatter)

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
    shards; this rank holds shard ``rank``."""

    def __init__(self, names, shapes, n: int, rank: int):
        self.names = list(names)
        self.shapes = [tuple(s) for s in shapes]
        self.numels = [math.prod(s) for s in self.shapes]
        self.offsets, end = [], 0
        for numel in self.numels:
            self.offsets.append(end)
            end += -(-numel // ALIGN) * ALIGN
        unit = n * ALIGN
        self.total = max(unit, -(-end // unit) * unit)
        self.shard_numel = self.total // n
        self.n, self.rank = n, rank
        self.lo = rank * self.shard_numel

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
            for name in group + [None]:
                numel = masters[name].numel() if name else 0
                if chunk and (name is None or size + numel > GROUP_ELEMENTS):
                    key = f"replicated{len(self.replicated)}"
                    layout = FlatLayout(chunk, [masters[n].shape
                                                for n in chunk],
                                        self.n, self.rank)
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
            names = [sl[2] for sl in slots]
            layout = FlatLayout(names, [sl[3].shape for sl in slots], self.n,
                                self.rank)
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
        """The global norm of the sharded gradient: the shards' sums of
        squares, all-reduced over ``data``."""
        sq = torch.stack([n.float() for n in torch._foreach_norm(tensors)])
        total = (sq * sq).sum().reshape(1)
        all_reduce_(total, self.group)
        return total[0].sqrt()

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
    # the card than the largest group.  Every rank of ``data`` calls these
    # in the same order; the other ranks get None.

    def _whole(self, shard: torch.Tensor):
        return gather_flat(shard.detach(), self.group, device="cpu")

    def to_names(self, shards: dict):
        """``{group: shard}`` -> ``{name: whole tensor}`` on the host of
        rank 0, None elsewhere."""
        out = {}
        for g, shard in shards.items():
            full = self._whole(shard)
            if full is not None:
                out.update(zip(self.layouts[g].names,
                               (v.clone() for v in
                                self.layouts[g].views(full))))
        return out if self.rank == 0 else None

    def module_weights(self):
        """Every unit's weights ``{"<model>.<name>": whole tensor}`` (fsdp;
        under zero1 the modules hold them whole) on the host of rank 0,
        None elsewhere."""
        out = {}
        for unit in self.units:
            whole = self._whole(unit.shard)
            if whole is None:
                continue
            for b, full in zip(unit.buckets, unit.split(whole)):
                out.update(zip((sl[2] for sl in b.slots),
                               (v.clone() for v in b.layout.views(full))))
        return out if self.rank == 0 else None

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
            first = next(iter(state[key].values()), None)
            if isinstance(first, dict):
                out[key] = self._q_to_names(state[key])
            else:
                out[key] = self.to_names(state[key])
        return out if self.rank == 0 else None

    def _q_to_names(self, qs: dict) -> dict:
        out = {}
        for g, q in qs.items():
            codes, scales = self._whole(q["codes"]), self._whole(q["scales"])
            if codes is None:
                continue
            codes, scales = codes.view(-1, ALIGN), scales.view(-1, 1)
            for i, name in enumerate(self.layouts[g].names):
                b0, nb = self.layouts[g].blocks(i)
                out[name] = {"codes": codes[b0:b0 + nb].clone(),
                             "scales": scales[b0:b0 + nb].clone()}
        return out

    def load_optimizer_state(self, optimizer, saved: dict) -> None:
        """An unsharded optimizer state dict into the sharded optimizer."""
        state = optimizer.state_dict()
        local = {"count": saved["count"], "mini_step": saved["mini_step"],
                 "acc": None}
        if state["acc"] is not None and saved.get("acc") is not None:
            self.load_names(state["acc"], saved["acc"])
        for key in ("mu", "nu"):
            first = next(iter(state[key].values()), None)
            if isinstance(first, dict):
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
    """Shard ``models`` (built for training, ``trainable_masters`` taken,
    LoRA enabled if it is on) for ``mode`` over ``mesh``'s ``data`` axis;
    the plan is also ``models.sharding``.  Under fsdp the modules keep
    empty placeholders and ``models.masters`` only the replicated
    masters."""
    plan = ShardPlan(mode, mesh)
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
