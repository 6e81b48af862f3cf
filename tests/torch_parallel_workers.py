"""Rank functions for the multi-process CPU tests of the port's parallel
layer (``tests/test_torch_parallel.py``, ``tests/test_torch_ring.py``) and
of the sampling knobs under ``seq`` (``tests/test_torch_samplers.py``).

Started by ``seervideoldm_tpu_torch.parallel.launch.run`` in fresh spawned
processes on the gloo backend, so this module imports torch and the port
only: the JAX references are computed in the test process and the inputs
and weights arrive as numpy arrays.  Every function returns numpy arrays
(or plain Python values) keyed by case.
"""
from __future__ import annotations

import numpy as np
import torch

from seervideoldm_tpu_torch.io.convert import load_jax_params
from seervideoldm_tpu_torch.parallel.activation import (frame_shard,
                                                        set_activation_mesh)
from seervideoldm_tpu_torch.parallel.collectives import all_gather_cat
from seervideoldm_tpu_torch.parallel.mesh import create_mesh


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _gather_frames(x, shard, dim=1):
    if shard is None:
        return x
    return all_gather_cat(x.contiguous(), shard.group, dim, shard.counts)


def ring_cases(rank, cases):
    """``ring_window_attention`` on this rank's frames, forward and the
    gradients of ``sum(out * g)``; returns every rank's frames joined."""
    from seervideoldm_tpu_torch.ops.ring import ring_window_attention

    world = torch.distributed.get_world_size()
    mesh = create_mesh({"seq": world})
    set_activation_mesh(mesh)
    out = {}
    for name, case in cases.items():
        shard = frame_shard(case["q"].shape[1])
        q, k, v, g = (_t(case[key])[:, shard.start:shard.stop]
                      for key in ("q", "k", "v", "g"))
        for t in (q, k, v):
            t.requires_grad_(True)
        o = ring_window_attention(q, k, v, case["scale"], case["causal"],
                                  case["ws"], shard)
        dq, dk, dv = torch.autograd.grad(o, (q, k, v), g)
        out[name] = {key: _gather_frames(t.detach(), shard).numpy()
                     for key, t in (("out", o), ("dq", dq), ("dk", dk),
                                    ("dv", dv))}
    set_activation_mesh(None)
    return out if rank == 0 else None


def layer_cases(rank, cases):
    """GroupNorm and WindowTemporalAttention on this rank's frames under a
    ``{"seq": world}`` mesh: forward, the input gradient of
    ``sum(out * g)`` and the parameter gradients (summed over the ranks,
    as the trainer reduces them)."""
    from seervideoldm_tpu_torch.ops.attention import WindowTemporalAttention
    from seervideoldm_tpu_torch.ops.norms import GroupNorm
    from seervideoldm_tpu_torch.ops.ring import set_ring_enabled
    from seervideoldm_tpu_torch.parallel.collectives import all_reduce_

    world = torch.distributed.get_world_size()
    mesh = create_mesh({"seq": world})
    set_activation_mesh(mesh)
    out = {}
    for name, case in cases.items():
        set_ring_enabled(case.get("ring", True))
        if case["layer"] == "group_norm":
            mod = GroupNorm(*case["args"])
        else:
            mod = WindowTemporalAttention(*case["args"])
        load_jax_params(mod, case["params"])
        x_all = _t(case["x"])
        shard = frame_shard(x_all.shape[1])
        x = x_all[:, shard.start:shard.stop].clone().requires_grad_(True)
        if case["layer"] == "group_norm":
            y = mod(x)
        else:
            y = mod(x, frames=shard)
        g = _t(case["g"])[:, shard.start:shard.stop]
        params = [p for _, p in mod.named_parameters()]
        grads = torch.autograd.grad(y, [x] + params, g)
        pgrads = {n: all_reduce_(gp.clone()).numpy()
                  for (n, _), gp in zip(mod.named_parameters(), grads[1:])}
        out[name] = {"out": _gather_frames(y.detach(), shard).numpy(),
                     "dx": _gather_frames(grads[0], shard).numpy(),
                     "params": pgrads}
    set_ring_enabled(True)
    set_activation_mesh(None)
    return out if rank == 0 else None


def fail_on_rank(rank, bad):
    if rank == bad:
        raise ValueError("boom")
    return rank


def ring_and_layer_cases(rank, ring, layers):
    """``ring_cases`` and ``layer_cases`` in one launch."""
    return ring_cases(rank, ring), layer_cases(rank, layers)


def _spy_branches():
    """Count the temporal attention's calls of each branch (on the CPU the
    kernels' wrappers run their plain versions and count no launches)."""
    from seervideoldm_tpu_torch.ops import attention

    calls = {}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return wrapped

    for name in ("swat_attention_tables", "swat_attention",
                 "ring_window_attention", "gather_frames"):
        setattr(attention, name, spy(name, getattr(attention, name)))
    return calls


def unet_cases(rank, unet_kwargs, jparams, cases):
    """The tiny SeerUNet on this rank's batch rows and frames under each
    case's mesh; returns the whole output, joined over ``seq`` and
    ``data``, and the temporal attention's calls of each branch; also every
    rank's id through ``gather_across_hosts``."""
    from seervideoldm_tpu_torch.models.unet3d import SeerUNet, SeerUNetConfig
    from seervideoldm_tpu_torch.ops.ring import set_ring_enabled
    from seervideoldm_tpu_torch.parallel.distributed import (
        barrier_sync, gather_across_hosts)

    unet = load_jax_params(SeerUNet(SeerUNetConfig(**unet_kwargs)).eval(),
                           jparams)
    calls = _spy_branches()
    out = {}
    for name, case in cases.items():
        calls.clear()
        mesh = create_mesh(case["mesh"])
        set_activation_mesh(mesh)
        set_ring_enabled(case.get("ring", True))
        x, ctx = _t(case["x"]), _t(case["ctx"])
        ts = torch.as_tensor(case["ts"])
        rows = mesh.batch_slice(x.shape[0])
        f = x.shape[1]
        lo, hi = mesh.frame_range(f)
        with torch.no_grad():
            y = unet(x[rows, lo:hi], ts[rows], ctx[rows, lo:hi],
                     cond_frame=case["cond_frame"], num_frames=f)
        y = _gather_frames(y, frame_shard(f))
        data = mesh.group("data")
        if data is not None:
            y = all_gather_cat(y.contiguous(), data, 0,
                               [y.shape[0]] * mesh.axis_size("data"))
        out[name] = {"out": y.numpy(), "calls": dict(calls)}
    set_ring_enabled(True)
    set_activation_mesh(None)
    out["ranks"] = gather_across_hosts(np.array([[rank, rank * 10]]))
    barrier_sync()
    return out if rank == 0 else None


def train_cases(rank, sizes, jparams, batch, cases):
    """One micro-step's ``loss_and_grads`` of the port's trainer under each
    case's mesh, on this rank's rows of the global batch (the noise and
    timesteps handed in); returns the reduced loss, mse and gradients, and
    every rank's masters checksum after an optimizer step."""
    from seervideoldm_tpu_torch.models.clip_text import CLIPTextConfig
    from seervideoldm_tpu_torch.models.unet3d import SeerUNetConfig
    from seervideoldm_tpu_torch.models.vae import VAEConfig
    from seervideoldm_tpu_torch.parallel.distributed import \
        assert_replicas_equal
    from seervideoldm_tpu_torch.pipelines.text_video import SeerModels
    from seervideoldm_tpu_torch.training import optim, trainer

    out = {}
    for name, case in cases.items():
        models = SeerModels.initialize(
            num_frames=sizes["frames"],
            unet_config=SeerUNetConfig(**sizes["unet"]),
            vae_config=VAEConfig(**sizes["vae"]),
            clip_config=CLIPTextConfig(**sizes["clip"]),
            fstext_kwargs=sizes["fstext"], dtype=torch.float32, device="cpu",
            trainable_scope="reference")
        for key in ("unet", "fstext", "vae", "clip"):
            load_jax_params(getattr(models, key), jparams[key])
        trainer.trainable_masters(models)
        mesh = create_mesh(case["mesh"])
        set_activation_mesh(mesh)
        rows = mesh.batch_slice(batch["latents"].shape[0])
        step = trainer.make_train_step(models, cond_frames=sizes["cond"],
                                       text_loss=case["text_loss"])
        local = {k: _t(v)[rows] for k, v in batch.items()}
        names = list(models.masters)
        loss, mse, grads = step.loss_and_grads(
            names, local, _t(case["noise"])[rows],
            torch.as_tensor(case["ts"])[rows])
        opt, _ = optim.build_optimizer(models.masters, 1e-3,
                                       warmup_steps=0, total_steps=10)
        opt.update(grads)
        checksum = assert_replicas_equal(opt.params)
        out[name] = {"loss": float(loss), "mse": float(mse),
                     "grads": {n: g.numpy() for n, g in grads.items()},
                     "checksum": checksum}
        set_activation_mesh(None)
    if rank != 0:
        return {name: {"checksum": r["checksum"]} for name, r in out.items()}
    return out


def knob_cases(rank, unet_kwargs, jparams, sent, cases, mesh_shape):
    """``SeerPipeline.sample_latents`` (5 steps, CFG 7.5) with each case's
    sampling knobs on the tiny SeerUNet, under ``mesh_shape`` (None: one
    rank); ``pab`` is a (spatial, cross, temporal) range triple.  Returns
    the whole latents, which every rank holds, from rank 0."""
    from types import SimpleNamespace

    from seervideoldm_tpu_torch.diffusion.pab import PABConfig
    from seervideoldm_tpu_torch.models.unet3d import SeerUNet, SeerUNetConfig
    from seervideoldm_tpu_torch.pipelines.text_video import SeerPipeline

    unet = load_jax_params(SeerUNet(SeerUNetConfig(**unet_kwargs)).eval(),
                           jparams)
    set_activation_mesh(create_mesh(mesh_shape))
    pipe = SeerPipeline(SimpleNamespace(unet=unet))
    out = {}
    for name, case in cases.items():
        kw = dict(case)
        if "pab" in kw:
            kw["pab_config"] = PABConfig(*kw.pop("pab"))
        with torch.no_grad():
            out[name] = pipe.sample_latents(
                _t(sent["x_T"]), _t(sent["x0"]), _t(sent["ctx"]),
                _t(sent["unc"]), ddim_steps=5, guidance_scale=7.5,
                **kw).numpy()
    set_activation_mesh(None)
    return out if rank == 0 else None
