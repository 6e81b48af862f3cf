"""Rank functions for the multi-process CPU tests of ZeRO-1 and FSDP
(``tests/test_torch_sharding.py``, ``tests/test_torch_sharding_jax.py``).

Started by ``seervideoldm_tpu_torch.parallel.launch.run`` on the gloo
backend; this module imports torch and the port only.  Weights, the
prepared batch and every micro-step's noise and timesteps arrive as numpy
arrays; each rank trains on its rows of the global batch.
"""
from __future__ import annotations

import numpy as np
import torch

from seervideoldm_tpu_torch.io.convert import load_jax_params
from seervideoldm_tpu_torch.ops.kernels import launch_counters
from seervideoldm_tpu_torch.parallel.activation import set_activation_mesh
from seervideoldm_tpu_torch.parallel.mesh import create_mesh


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(d):
    """Nested dicts of tensors as nested dicts of numpy arrays."""
    if isinstance(d, dict):
        return {k: _np(v) for k, v in d.items()}
    if not torch.is_tensor(d):
        return d
    d = d.detach().cpu()
    return (d.float() if d.dtype == torch.bfloat16 else d).numpy()


def build(sizes, jparams, remat=False, lora_rank=0):
    """The four models at ``sizes``' widths (on ``sizes["device"]``, the
    CPU by default, in bf16 on the card), built for training."""
    from seervideoldm_tpu_torch.models.clip_text import CLIPTextConfig
    from seervideoldm_tpu_torch.models.unet3d import SeerUNetConfig
    from seervideoldm_tpu_torch.models.vae import VAEConfig
    from seervideoldm_tpu_torch.pipelines.text_video import SeerModels
    from seervideoldm_tpu_torch.training import lora, trainer

    device = sizes.get("device", "cpu")
    models = SeerModels.initialize(
        num_frames=sizes["frames"], unet_config=SeerUNetConfig(**sizes["unet"]),
        vae_config=VAEConfig(**sizes["vae"]),
        clip_config=CLIPTextConfig(**sizes["clip"]),
        fstext_kwargs=sizes["fstext"], device=device,
        dtype=torch.bfloat16 if device == "cuda" else torch.float32,
        trainable_scope="reference", remat=remat)
    if jparams is not None:
        for key in ("unet", "fstext", "vae", "clip"):
            load_jax_params(getattr(models, key), jparams[key])
    else:
        # the port's seeded init, every proj_out made non-zero so that
        # the temporal sites and the adapters get gradients
        gen = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for name, p in models.unet.named_parameters():
                if ".proj_out." in name:
                    p.copy_(torch.randn(p.shape, generator=gen).to(p.device)
                            * 0.1)
            named = models.named_trainable()
            for name, t in models.masters.items():
                if ".proj_out." in name:
                    t.copy_(named[name])
    trainer.trainable_masters(models)
    trainer.sync_compute_copies(models)
    scale = 0.0
    if lora_rank:
        lora.enable_lora(models, lora_rank, torch.Generator().manual_seed(7))
        scale = lora.lora_scale(lora_rank, None)
    return models, scale


def run_case(sizes, jparams, batch, draws, case, mesh):
    """One training run of ``case`` on this rank; returns the numbers the
    tests compare (whole tensors by name on every rank)."""
    from seervideoldm_tpu_torch.io.checkpoint import CheckpointManager
    from seervideoldm_tpu_torch.parallel.sharding import (param_bytes,
                                                          shard_training)
    from seervideoldm_tpu_torch.training import optim, trainer

    models, scale = build(sizes, jparams, case.get("remat", False),
                          case.get("lora_rank", 0))
    set_activation_mesh(mesh)
    plan = None
    if case.get("mode"):
        plan = shard_training(models, case["mode"], mesh, scale)
    params = plan.masters if plan is not None else models.masters
    opt, _ = optim.build_optimizer(
        params, case["lr"], warmup_steps=case.get("warmup", 1),
        total_steps=10, accumulation_steps=case.get("accum", 1),
        eps=case.get("eps", 1e-8),
        max_grad_norm=case.get("max_grad_norm", 0.3),
        use_8bit=case.get("use_8bit", False),
        norm_fn=plan.global_norm if plan is not None else None)
    ema = case.get("ema", 0.0)
    state = trainer.TrainState.create(opt, ema=ema > 0)
    step = trainer.make_train_step(models, cond_frames=sizes["cond"],
                                   ema_decay=ema, lora_scale=scale)
    first = 0
    if case.get("resume"):
        # (output_dir, step): that checkpoint, then the draws after it
        root, first = case["resume"]
        CheckpointManager(root).restore(first, state, models)
    rows = mesh.batch_slice(batch["latents"].shape[0])
    dev = models.unet.conv_in.weight.device
    dtype = models.unet.conv_in.weight.dtype
    local = {k: _t(v)[rows].to(dev, dtype) for k, v in batch.items()}

    def draw(d):
        return _t(d["noise"])[rows].to(dev), _t(d["ts"])[rows].to(dev)

    out = {"losses": [], "grad_norms": []}
    if case.get("grads"):
        _, _, g = step.loss_and_grads(opt.names, local, *draw(draws[0]))
        # by name, on rank 0 (None on the others under a plan)
        out["grads"] = _np(plan.to_names(g) if plan is not None else g)
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    for d in draws[first:first + case["steps"]]:
        noise, ts = draw(d)
        m = step(state, local, noise=noise, timesteps=ts)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
    out["launches"] = {name: fn.launches for name, fn in counters.items()}
    if plan is not None:
        out["masters"] = _np(plan.to_names(state.masters))
        out["ema"] = _np(plan.to_names(state.ema)) if state.ema else None
        out["optimizer"] = plan.optimizer_state(opt)
        out["groups"] = {
            g: {"shard_bytes": int(t.numel() * t.element_size()),
                "shapes": layout.shapes, "itemsize": t.element_size()}
            for g, layout in plan.layouts.items()
            for t in (plan.masters[g],)}
        out["moment_bytes"] = opt.state_bytes()
        out["acc_bytes"] = opt.acc_bytes()
        # what this rank holds beyond an even split: its share of the
        # units' padding, in the shard's and a separate master's dtype
        out["pad_bytes"] = 0
        for unit in plan.units:
            for b in unit.buckets:
                size = b.shard.element_size()
                if b.anchor is not None and b.anchor is not b.shard:
                    size += b.anchor.element_size()
                pad = b.layout.total - sum(b.layout.numels)
                out["pad_bytes"] += pad / plan.n * size
    else:
        out["masters"] = _np(state.masters)
        out["ema"] = _np(state.ema) if state.ema else None
        out["optimizer"] = opt.state_dict()
        out["moment_bytes"] = opt.state_bytes()
    out["optimizer"] = _np(out["optimizer"])
    out["param_bytes"] = param_bytes(models)
    if case.get("save_dir"):
        from seervideoldm_tpu_torch.parallel.distributed import (
            barrier_sync, is_main_process)

        ckpt = CheckpointManager(case["save_dir"], lora_scale=scale)
        if plan is not None or is_main_process():
            ckpt.save(first + case["steps"], state, models)
        barrier_sync()
    set_activation_mesh(None)
    return out


def sharded_cases(rank, sizes, jparams, batch, draws, cases):
    """Every case of ``cases`` under ``{"data": world}``; rank 0 returns
    its numbers, the other ranks their byte counts only."""
    world = torch.distributed.get_world_size()
    mesh = create_mesh({"data": world})
    out = {}
    for name, case in cases.items():
        out[name] = run_case(sizes, jparams, batch, draws, case, mesh)
    if rank != 0:
        return {name: {k: r[k] for k in ("param_bytes", "moment_bytes",
                                         "pad_bytes") if k in r}
                for name, r in out.items()}
    return out


def entry_run(rank, raw):
    """The train entry on this rank, its printed lines captured."""
    import contextlib
    import io

    from seervideoldm_tpu_torch.train import train

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        summary = train(dict(raw), device="cpu")
    return {"stdout": out.getvalue(), "summary": summary}


_HARMLESS = ("dtype", "device", "is_cuda", "requires_grad")


def placeholder_reads(rank, sizes, jparams, batch, draws):
    """Under fsdp, one training micro-step (forward and backward), a VAE
    encode and decode and a CLIP call, each op watched by a
    ``TorchFunctionMode``: the ops that took one of the empty placeholders
    a unit leaves in its modules while it is closed -- a weight read
    outside its unit.  Returns the ops' names and the loss."""
    from torch.overrides import TorchFunctionMode
    from torch.utils._pytree import tree_leaves

    from seervideoldm_tpu_torch.parallel.sharding import shard_training
    from seervideoldm_tpu_torch.training import trainer

    mesh = create_mesh({"data": torch.distributed.get_world_size()})
    models, _ = build(sizes, jparams)
    set_activation_mesh(mesh)
    plan = shard_training(models, "fsdp", mesh)
    held = {id(sl[3]) for unit in plan.units for sl in unit.slots}
    reads = []

    class Watch(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = getattr(getattr(func, "__self__", None), "__name__", "")
            if name not in _HARMLESS and any(
                    id(t) in held for t in tree_leaves((args, kwargs))):
                reads.append(getattr(func, "__name__", str(func)))
            return func(*args, **kwargs)

    rows = mesh.batch_slice(batch["latents"].shape[0])
    local = {k: _t(v)[rows] for k, v in batch.items()}
    step = trainer.make_train_step(models, cond_frames=sizes["cond"])
    names, _ = plan.grad_targets(models)
    with Watch():
        loss, _, _ = step.loss_and_grads(
            names, local, _t(draws[0]["noise"])[rows],
            _t(draws[0]["ts"])[rows])
        with torch.no_grad():
            video = torch.zeros(1, 16, 16, 3)
            latents = models.vae.encode(video)
            models.vae.decode(latents)
            models.clip(torch.ones(1, 8, dtype=torch.long))
    set_activation_mesh(None)
    return {"reads": reads, "loss": float(loss), "units": len(plan.units)}
