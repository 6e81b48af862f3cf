"""Rank functions for the multi-process CPU tests of tensor parallelism
over the ``model`` axis (``tests/test_torch_tensor_parallel.py``,
``tests/test_torch_tensor_parallel_train.py``).

Started by ``seervideoldm_tpu_torch.parallel.launch.run`` on the gloo
backend; this module imports torch and the port only.  Weights and inputs
arrive as numpy arrays (the JAX package's parameter trees, carried by
``io/convert.py``); each rank builds the four models whole, cuts its
slices (``parallel.sharding.shard_tensor_parallel``) and takes its rows of
the batch (``data``) and its frames (``seq``).  Results come back whole:
joined over ``seq`` and ``data``, split tensors joined over ``model``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from seervideoldm_tpu_torch.io.convert import load_jax_params
from seervideoldm_tpu_torch.parallel.activation import (frame_shard,
                                                        set_activation_mesh)
from seervideoldm_tpu_torch.parallel.collectives import (all_gather,
                                                         all_gather_cat)
from seervideoldm_tpu_torch.parallel.mesh import create_mesh
from seervideoldm_tpu_torch.parallel.sharding import shard_tensor_parallel


def _t(a):
    return torch.from_numpy(np.array(a))


def build(sizes, jparams, trainable_scope=None, remat=False):
    """The four models at ``sizes``' widths in fp32 on the CPU, with the
    JAX package's weights."""
    from seervideoldm_tpu_torch.models.clip_text import CLIPTextConfig
    from seervideoldm_tpu_torch.models.unet3d import SeerUNetConfig
    from seervideoldm_tpu_torch.models.vae import VAEConfig
    from seervideoldm_tpu_torch.pipelines.text_video import SeerModels
    from seervideoldm_tpu_torch.training import trainer

    models = SeerModels.initialize(
        num_frames=sizes["frames"], unet_config=SeerUNetConfig(**sizes["unet"]),
        vae_config=VAEConfig(**sizes["vae"]),
        clip_config=CLIPTextConfig(**sizes["clip"]),
        fstext_kwargs=sizes["fstext"], dtype=torch.float32, device="cpu",
        trainable_scope=trainable_scope, remat=remat)
    for key in ("unet", "fstext", "vae", "clip"):
        load_jax_params(getattr(models, key), jparams[key])
    if trainable_scope is not None:
        with torch.no_grad():
            named = models.named_trainable()
            for name, master in models.masters.items():
                master.copy_(named[name])
        trainer.trainable_masters(models)
    return models


def whole(tp, name, t):
    """The whole tensor ``name`` (every rank of the model group calls
    it)."""
    return t if tp is None else tp.whole(name, t)


def _rows(x, mesh):
    """Every data rank's rows of ``x`` joined (axis 0)."""
    data = mesh.group("data")
    if data is None:
        return x
    return all_gather_cat(x.contiguous(), data, 0,
                          [x.shape[0]] * mesh.axis_size("data"))


def _frames(x, f):
    shard = frame_shard(f)
    if shard is None:
        return x
    return all_gather_cat(x.contiguous(), shard.group, 1, shard.counts)


def forward_cases(rank, sizes, jparams, inputs, cases):
    """One UNet call, one CLIP encode and one FSText call on this rank's
    rows and frames under each case's mesh; under ``maps`` also the UNet's
    cross-attention maps (``collect_attn``).  Returns the whole outputs,
    and what the split left on this rank."""
    from seervideoldm_tpu_torch.parallel.sharding import param_bytes

    out = {}
    for name, case in cases.items():
        mesh = create_mesh(case["mesh"])
        set_activation_mesh(mesh)
        models = build(sizes, jparams)
        tp = shard_tensor_parallel(models, mesh)
        x, ctx = _t(inputs["x"]), _t(inputs["ctx"])
        ts = torch.as_tensor(inputs["ts"])
        rows = mesh.batch_slice(x.shape[0])
        f = x.shape[1]
        lo, hi = mesh.frame_range(f)
        maps = {} if case.get("maps") else None
        models.unet.collect_attn = maps is not None
        with torch.no_grad():
            y = models.unet(x[rows, lo:hi], ts[rows], ctx[rows, lo:hi],
                            cond_frame=inputs["cond_frame"], num_frames=f,
                            attn_maps=maps)
            ids, mask = _t(inputs["ids"]), _t(inputs["mask"])
            clip = models.clip(ids[rows], mask[rows])
            fs = models.fstext(_t(inputs["emb"])[rows])
        row = {"unet": _rows(_frames(y, f), mesh).numpy(),
               "clip": _rows(clip, mesh).numpy(),
               "fstext": _rows(fs, mesh).numpy(),
               "splits": sorted(tp.splits),
               "heads": {n: m.heads for n, m in
                         models.unet.named_modules() if hasattr(m, "tp_group")
                         and hasattr(m, "heads")},
               "param_bytes": param_bytes(models)}
        if maps is not None:
            row["maps"] = {k: v.numpy() for k, v in maps.items()}
        out[name] = row
        set_activation_mesh(None)
    return out if rank == 0 else None


def sample_case(rank, sizes, jparams, sent, shape):
    """``SeerPipeline.sample_latents`` (DDIM, 4 steps, CFG 7.5) under
    ``shape``; every rank's latents."""
    from seervideoldm_tpu_torch.pipelines.text_video import SeerPipeline

    mesh = create_mesh(shape)
    set_activation_mesh(mesh)
    models = build(sizes, jparams)
    shard_tensor_parallel(models, mesh)
    pipe = SeerPipeline(models)
    with torch.no_grad():
        context = pipe.fstext(_t(sent["clip_emb"]))
        got = pipe.sample_latents(_t(sent["x_T"]), _t(sent["x0_emb"]),
                                  context, _t(sent["uncond"]), ddim_steps=4,
                                  guidance_scale=7.5)
    set_activation_mesh(None)
    return got.numpy()


def train_cases(rank, sizes, jparams, batch, cases):
    """One micro-step's ``loss_and_grads`` under each case's mesh on this
    rank's rows, then one optimizer step through the tensor-parallel norm.
    Returns the loss, the whole gradients, the norm the clip saw and every
    rank's masters checksum (compared within each model index)."""
    from seervideoldm_tpu_torch.parallel.distributed import \
        assert_replicas_equal
    from seervideoldm_tpu_torch.training import optim, trainer

    out = {}
    for name, case in cases.items():
        mesh = create_mesh(case["mesh"])
        set_activation_mesh(mesh)
        models = build(sizes, jparams, trainable_scope="reference",
                       remat=case.get("remat", False))
        tp = shard_tensor_parallel(models, mesh)
        rows = mesh.batch_slice(batch["latents"].shape[0])
        step = trainer.make_train_step(models, cond_frames=sizes["cond"],
                                       text_loss=True)
        local = {k: _t(v)[rows] for k, v in batch.items()}
        names = list(models.masters)
        loss, mse, grads = step.loss_and_grads(
            names, local, _t(case["noise"])[rows],
            torch.as_tensor(case["ts"])[rows])
        opt, _ = optim.build_optimizer(
            models.masters, 1e-3, warmup_steps=0, total_steps=10,
            norm_fn=tp.global_norm_fn(names))
        _, gnorm = opt.update(grads)
        checksum = (assert_replicas_equal(opt.params,
                                          group=mesh.replica_group())
                    if mesh.replicas > 1 else
                    float(sum(t.sum(dtype=torch.float64)
                              for t in opt.params)))
        out[name] = {"loss": float(loss), "mse": float(mse),
                     "norm": float(gnorm),
                     "grads": {n: whole(tp, n, g).numpy()
                               for n, g in grads.items()},
                     "checksum": checksum, "coords": dict(mesh.coords),
                     "local_split": {n: tuple(grads[n].shape)
                                     for n in names if n in tp.splits}}
        set_activation_mesh(None)
    if rank != 0:
        return {name: {k: r[k] for k in ("checksum", "coords")}
                for name, r in out.items()}
    return out


def knob_cases(rank, sizes, jparams, sent, cases, shape):
    """``SeerPipeline.sample_latents`` (5 steps, CFG 7.5) with each case's
    sampling knobs under ``shape`` (None: one rank, no mesh); ``pab`` is a
    (spatial, cross, temporal) range triple, ``unet`` fields of the UNet
    config (ToMe, FreeU).  The latents every rank holds, from rank 0."""
    import dataclasses

    from seervideoldm_tpu_torch.diffusion.pab import PABConfig
    from seervideoldm_tpu_torch.pipelines.text_video import SeerPipeline

    mesh = create_mesh(shape) if shape else None
    set_activation_mesh(mesh)
    models = build(sizes, jparams)
    shard_tensor_parallel(models, mesh)
    base = models.unet.config
    pipe = SeerPipeline(models)
    out = {}
    for name, case in cases.items():
        kw = dict(case)
        models.unet.config = dataclasses.replace(base, **kw.pop("unet", {}))
        if "pab" in kw:
            kw["pab_config"] = PABConfig(*kw.pop("pab"))
        with torch.no_grad():
            out[name] = pipe.sample_latents(
                _t(sent["x_T"]), _t(sent["x0"]), _t(sent["ctx"]),
                _t(sent["unc"]), ddim_steps=5, guidance_scale=7.5,
                **kw).numpy()
    set_activation_mesh(None)
    return out if rank == 0 else None


def _train(models, sizes, batch, draws, steps, mesh=None):
    """``steps`` micro-steps (accumulation 1, EMA 0.9, lr 1e-3) on this
    rank's rows; returns the state."""
    from seervideoldm_tpu_torch.training import optim, trainer

    names = list(models.masters)
    tp = models.tensor_parallel
    opt, _ = optim.build_optimizer(
        models.masters, 1e-3, warmup_steps=0, total_steps=10, eps=1e-6,
        norm_fn=tp.global_norm_fn(names) if tp is not None else None)
    state = trainer.TrainState.create(opt, ema=True)
    step = trainer.make_train_step(models, cond_frames=sizes["cond"],
                                   ema_decay=0.9)
    rows = (mesh.batch_slice(batch["latents"].shape[0]) if mesh is not None
            else slice(None))
    local = {k: _t(v)[rows] for k, v in batch.items()}
    for draw in draws[:steps]:
        step(state, local, noise=_t(draw["noise"])[rows],
             timesteps=torch.as_tensor(draw["ts"])[rows])
    return state


def checkpoint_case(rank, sizes, jparams, batch, draws, root, shape):
    """Two optimizer steps saved by one rank alone (no mesh) and under
    ``shape``; then a resume under ``shape`` from the split save.  Returns
    the restored state whole, and the state before the save."""
    from seervideoldm_tpu_torch.io.checkpoint import CheckpointManager
    from seervideoldm_tpu_torch.parallel.distributed import barrier_sync

    if rank == 0:
        single = build(sizes, jparams, trainable_scope="reference")
        state = _train(single, sizes, batch, draws, 2)
        CheckpointManager(os.path.join(root, "single")).save(2, state, single)
    barrier_sync()
    mesh = create_mesh(shape)
    set_activation_mesh(mesh)
    models = build(sizes, jparams, trainable_scope="reference")
    tp = shard_tensor_parallel(models, mesh)
    state = _train(models, sizes, batch, draws, 2, mesh)
    ckpt = CheckpointManager(os.path.join(root, "split"))
    ckpt.save(2, state, models)
    barrier_sync()

    def state_whole(st):
        opt = st.optimizer.state_dict()
        return {"masters": {n: whole(tp, n, t).numpy()
                            for n, t in st.masters.items()},
                "ema": {n: whole(tp, n, t).numpy()
                        for n, t in st.ema.items()},
                "mu": {n: whole(tp, n, t).numpy()
                       for n, t in opt["mu"].items()},
                "count": opt["count"], "step": st.step}

    before = state_whole(state)
    fresh = build(sizes, jparams, trainable_scope="reference")
    tp = shard_tensor_parallel(fresh, mesh)
    resumed = _train(fresh, sizes, batch, draws, 0, mesh)
    ckpt.restore(2, resumed, fresh)
    named = fresh.named_trainable()
    # the modules compute with the restored masters' slices
    synced = all(torch.equal(named[n], t) for n, t in resumed.masters.items())
    after = state_whole(resumed)
    set_activation_mesh(None)
    return {"before": before, "after": after, "synced": synced,
            "n_split": len(tp.splits)} if rank == 0 else None


def layout_case(rank):
    """This rank's coordinates under ``{model: 2, seq: 2}``, its model
    group's and its replica group's ranks, and its frames of 5."""
    mesh = create_mesh({"model": 2, "seq": 2})
    me = torch.tensor([rank])
    return {"coords": dict(mesh.coords),
            "model_peers": [int(t) for t in all_gather(me,
                                                       mesh.group("model"))],
            "replica_peers": [int(t) for t in all_gather(
                me, mesh.replica_group())],
            "frames": mesh.frame_range(5)}


# ------------------------------------- strategies beside the model axis

def _by_name(d):
    """Nested dicts of tensors as nested dicts of numpy arrays."""
    if isinstance(d, dict):
        return {k: _by_name(v) for k, v in d.items()}
    return d.detach().cpu().numpy().copy() if torch.is_tensor(d) else d


def strategy_run(sizes, jparams, batch, draws, case, mesh):
    """One training run of ``case`` on this rank under ``mesh`` (None: one
    rank alone): the reference scope from the JAX weights, then the
    ``model`` cut, LoRA (``case["lora"]``: whole adapters by port key, cut
    with their projections), the sharded state the JAX entry's decision
    gives for ``zero1`` / ``fsdp``, AdamW (lr, eps, accumulation 2, EMA
    0.9, 8-bit with ``use_8bit``), a restore (``(dir, step)``), then
    ``steps`` micro-steps on this rank's rows with the draws after the
    restored step; checkpoints at ``save`` (``{step: dir}``).  Returns the
    losses, the clip's norms, the first micro-step's gradients joined
    (``grads``), the adapters as drawn (joined) and the bytes this rank
    holds."""
    from seervideoldm_tpu_torch.io.checkpoint import CheckpointManager
    from seervideoldm_tpu_torch.parallel.distributed import barrier_sync
    from seervideoldm_tpu_torch.parallel.sharding import (decide_mode,
                                                          param_bytes,
                                                          shard_training)
    from seervideoldm_tpu_torch.training import lora, optim, trainer

    models = build(sizes, jparams, trainable_scope="reference")
    set_activation_mesh(mesh)
    tp = shard_tensor_parallel(models, mesh) if mesh is not None else None
    out = {}
    scale = 0.0
    if case.get("lora"):
        rank = next(iter(case["lora"].values())).shape[-1]
        lora.enable_lora(models, rank, torch.Generator().manual_seed(7))
        out["lora_draw"] = {k: whole(tp, lora.PREFIX + k,
                                     t.detach()).numpy().copy()
                            for k, t in models.lora.items()}
        with torch.no_grad():
            for k, t in models.lora.items():
                src = _t(case["lora"][k])
                t.copy_(tp.local(lora.PREFIX + k, src) if tp else src)
        trainer.trainable_masters(models)
        scale = case.get("lora_scale", 0.5)
    n_data = mesh.axis_size("data") if mesh is not None else 1
    mode, _ = decide_mode(case.get("zero1", False), case.get("fsdp", False),
                          n_data)
    plan = shard_training(models, mode, mesh, scale) if mode else None
    params = plan.masters if plan is not None else models.masters
    norm_fn = (plan.global_norm if plan is not None
               else tp.global_norm_fn(list(params)) if tp is not None
               else None)
    opt, _ = optim.build_optimizer(
        params, case["lr"], warmup_steps=0, total_steps=10,
        accumulation_steps=2, eps=case["eps"],
        max_grad_norm=case.get("max_grad_norm", 0.3),
        use_8bit=case.get("use_8bit", False), norm_fn=norm_fn)
    state = trainer.TrainState.create(opt, ema=True)
    step = trainer.make_train_step(models, cond_frames=sizes["cond"],
                                   ema_decay=0.9, lora_scale=scale)
    first = 0
    if case.get("restore"):
        root, saved_step = case["restore"]
        CheckpointManager(root, lora_scale=scale).restore(saved_step, state,
                                                          models)
        first = 2 * saved_step
    rows = (mesh.batch_slice(batch["latents"].shape[0]) if mesh is not None
            else slice(None))
    local = {k: _t(v)[rows] for k, v in batch.items()}

    def draw(d):
        return _t(d["noise"])[rows], torch.as_tensor(d["ts"])[rows]

    if case.get("grads"):
        _, _, g = step.loss_and_grads(opt.names, local, *draw(draws[first]))
        if plan is not None:
            g = plan.to_names(g)
        elif tp is not None:
            g = {n: tp.whole(n, t) for n, t in g.items()}
        out["grads"] = None if g is None else _by_name(g)
    def save(root, at):
        # every rank under a sharded or split state, else rank 0
        if (mesh is None or plan is not None or tp is not None
                or torch.distributed.get_rank() == 0):
            CheckpointManager(root, lora_scale=scale).save(at, state, models)
        if mesh is not None:
            barrier_sync()

    losses, norms = [], []
    for i, d in enumerate(draws[first:first + case.get("steps", 4)]):
        noise, ts = draw(d)
        m = step(state, local, noise=noise, timesteps=ts)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        micro = first + i + 1
        if micro % 2 == 0 and micro // 2 in case.get("save", {}):
            save(case["save"][micro // 2], micro // 2)
    for at, root in case.get("resave", {}).items():
        save(root, at)      # the restored state written again, as it is
    out.update(losses=losses, grad_norms=norms, mode=mode,
               coords=dict(mesh.coords) if mesh is not None else {},
               state_bytes=opt.state_bytes() + opt.acc_bytes() + sum(
                   t.numel() * t.element_size() for t in state.ema.values()),
               moment_bytes=opt.state_bytes(),
               param_bytes=param_bytes(models),
               master_bytes=sum(t.numel() * t.element_size()
                                for t in opt.params),
               largest_unit_bytes=(plan.largest_unit_bytes()
                                   if plan is not None else 0),
               trainable_local=sum(t.numel() for t in opt.params),
               split_names={n: tuple(sp) for n, sp in (
                   tp.splits.items() if tp is not None else ())},
               partial_names=sorted(tp.partial) if tp is not None else [])
    if tp is not None and plan is None:
        out["keeps_blocks"] = {n: tp.keeps_blocks(n, t.shape)
                               for n, t in models.masters.items()}
    if case.get("keep_local"):
        # this rank's 8-bit moments (or moments) as they lie
        out["local_state"] = _by_name(opt.state_dict())
        out["local_shapes"] = {n: tuple(t.shape)
                               for n, t in models.masters.items()}
    if plan is not None:
        # this rank's share of the padding beyond an even split
        pad = 0.0
        for g, layout in plan.layouts.items():
            size = plan.masters[g].element_size()
            pad += (layout.total - sum(layout.numels)) / plan.n * size
        out["pad_bytes"] = pad
    set_activation_mesh(None)
    return out


def strategy_cases(rank, sizes, jparams, batch, draws, cases):
    """Every case of ``cases`` in order, each under its ``mesh`` (a shape
    over every rank, or None: rank 0 alone while the others wait).
    Returns ``{case: [every rank's numbers]}`` on rank 0."""
    from seervideoldm_tpu_torch.parallel.distributed import barrier_sync

    out = {}
    for name, case in cases.items():
        if case["mesh"] is None:
            row = (strategy_run(sizes, jparams, batch, draws, case, None)
                   if rank == 0 else None)
            barrier_sync()
        else:
            row = strategy_run(sizes, jparams, batch, draws, case,
                               create_mesh(case["mesh"]))
        out[name] = row
    rows = _gather_objects(out)
    return ({name: [r[name] for r in rows] for name in cases}
            if rank == 0 else None)


def _gather_objects(obj):
    """Every rank's ``obj``, in rank order, on every rank."""
    world = torch.distributed.get_world_size()
    got = [None] * world
    torch.distributed.all_gather_object(got, obj)
    return got


def entry_runs(rank, raws):
    """The ``train`` entry on this rank for each config of ``raws`` in
    turn, its printed lines captured."""
    import contextlib
    import io

    from seervideoldm_tpu_torch.train import train

    out = []
    for raw in raws:
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            summary = train(dict(raw), device="cpu")
        out.append({"stdout": text.getvalue(), "summary": summary})
    return out
