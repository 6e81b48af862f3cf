"""The train step (port of ``seervideoldm_tpu/training/trainer.py``).

One micro-step follows the reference hot loop:

1. FSText decomposes the (precomputed, frozen) CLIP embedding;
2. the clean cond-frame latents are concatenated in front of the noised
   future-frame latents;
3. the UNet predicts eps with ``cond_frame = cond_frames`` (training-only
   behaviour: the temporal FF residual skips the cond frames);
4. the cond frames are sliced off the prediction; fp32 squared error
   against the noise (or, for ``prediction_type="v_prediction"``, the
   velocity ``get_velocity``), optional FSText ``text_loss`` and
   min-SNR-gamma;
5. ``Optimizer.update``: running-mean accumulation, global-norm clip,
   AdamW, at the sync micro-step; then the EMA.

VAE and CLIP encoding is a separate ``prepare`` function under
``no_grad``: those models are frozen.

Spans (``utils/profiling.py``, detailed tier): ``train.prepare``,
``train.forward`` (the loss), ``train.backward`` (the ``torch.autograd``
call, the parent of the sites' backward spans), ``train.optimizer``
(``Optimizer.update``), each with CUDA events, and ``train.sync`` (the
compute copies and the EMA after a sync step); ``train.optimizer``'s id
``micro`` is the state's micro-step count.

Under a registered mesh (``parallel.activation``): each ``data`` rank holds
its own batch, and the trainable gradients are averaged over ``data``.
Under ``seq`` every rank of a replica holds the whole batch and noise, the
VAE encodes frame-local, and the UNet runs on this rank's frames; each
rank's loss is its share of the global eps-MSE sum over the global count
(the FSText ``text_loss``, computed whole on every rank, enters with a
1 / S share), so the shares' gradients, summed over ``seq``, are those of
the global mean the JAX step computes.  Gradients are reduced before the
clip sees their global norm, so every rank takes the same AdamW step.

Under ``model`` each rank holds its slices of the split weights
(``models.tensor_parallel``) and their masters; the ranks of one model
group compute one loss, and the reduce runs over the ``data`` x ``seq``
ranks of this rank's model index only (``Mesh.replica_group``): a split
gradient is this rank's slice, a replicated one the same on every model
rank.  A LoRA factor that a split leaves whole sees only this rank's slice
of its product, so its gradient is summed over the model ranks
(``TensorParallel.sum_partial``).  The clip's norm counts each once
(``TensorParallel.global_norm_fn``, or ``ShardPlan.global_norm`` under a
sharded state).

Parameters and dtypes: frozen weights are in the compute dtype.  Each
trainable parameter has an fp32 master that the optimizer updates; the
module computes with its compute-dtype copy, refreshed from the master
after every optimizer step, and the master's gradient is the copy's
gradient cast to fp32 -- what a flax ``Dense(dtype=bf16,
param_dtype=fp32)`` gives.  For an fp32 parameter (the CPU path, and the
norm layers everywhere) master and copy are one tensor; so are they for
every parameter under ``param_dtype`` bf16, where the master is bf16 and
the optimizer takes its gradient in bf16, as flax and optax do.

LoRA (``training/lora.py``): the whole UNet is frozen, the trainable set
is FSText plus the adapters, and the UNet computes with the adapted
weights inside ``lora_applied``.

Under ``zero1`` / ``fsdp`` (``models.sharding``, ``parallel/sharding.py``)
the optimizer's names are the plan's groups and its parameters their
master shards: the gradients arrive as data-mean shards, the EMA runs on
the shards, and after a sync step ``ShardPlan.after_step`` rebuilds what
the modules compute with.  Beside a ``model`` axis the shards are of this
rank's slices, and the loss pair is reduced over the replica group as
above.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..diffusion.ddpm import add_noise, get_velocity, min_snr_weight
from ..diffusion.schedules import DiffusionSchedule
from ..models.vae import VAE_SCALE
from ..parallel.activation import (frame_local, frame_shard,
                                   get_activation_mesh)
from ..parallel.collectives import all_reduce_
from ..pipelines.text_video import SeerModels
from ..utils import profiling
from .lora import lora_applied
from .optim import Optimizer


@dataclass
class TrainState:
    """What a resume needs: the micro-step count, the fp32 masters (shared
    with ``optimizer.params``), the optimizer and, when EMA is on, the
    averaged masters."""

    step: int
    masters: dict
    optimizer: Optimizer
    ema: Optional[dict] = None

    @staticmethod
    def create(optimizer: Optimizer, ema: bool = False) -> "TrainState":
        masters = dict(zip(optimizer.names, optimizer.params))
        return TrainState(
            step=0, masters=masters, optimizer=optimizer,
            ema={n: t.detach().clone() for n, t in masters.items()}
            if ema else None)


def trainable_masters(models: SeerModels) -> dict:
    """The masters the optimizer is built over.  A parameter that has its
    master's dtype already IS its master (one tensor, so an update needs no
    copy back): fp32 norm layers and LoRA adapters, and every parameter
    under ``param_dtype`` bf16."""
    if models.masters is None:
        raise ValueError("models were built for sampling: pass "
                         "trainable_scope to SeerModels.initialize")
    named = models.named_trainable()
    for name, master in models.masters.items():
        if named[name].dtype == master.dtype:
            models.masters[name] = named[name].data
    return models.masters


def sync_compute_copies(models: SeerModels) -> None:
    """Refresh the modules' compute-dtype copies from their masters."""
    named = models.named_trainable()
    with torch.no_grad():
        for name, master in models.masters.items():
            if named[name].data_ptr() != master.data_ptr():
                named[name].copy_(master)


def prepare_batch_fn(models: SeerModels, sample_posterior: bool = True,
                     vae_scale: float = VAE_SCALE) -> Callable:
    """The frozen-encoder pass: ``prepare(video, input_ids, attention_mask,
    cond_frames, generator=None, noise=None)`` -> dict with ``latents_x0``
    (cond frames), ``latents`` (future frames) and ``clip_emb``.

    video (b, f, h, w, 3) in [-1, 1].  ``sample_posterior=False`` encodes
    the posterior mean; otherwise the draw uses ``noise`` (shaped like the
    latents, for tests that share it with the JAX package) or comes from
    ``generator``."""
    dev = models.unet.conv_in.weight.device
    dtype = models.unet.conv_in.weight.dtype
    vcfg = models.vae.config
    down = 2 ** (len(vcfg.block_out_channels) - 1)

    @torch.no_grad()
    @profiling.span("train.prepare", events=True)
    def prepare(video, input_ids, attention_mask, cond_frames: int,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> dict:
        video = torch.as_tensor(video, device=dev)
        b, f, h, w, c = video.shape
        clip_emb = models.clip(
            torch.as_tensor(input_ids, device=dev, dtype=torch.long),
            torch.as_tensor(attention_mask, device=dev, dtype=torch.long))
        if sample_posterior and noise is None:
            noise = torch.randn(b * f, h // down, w // down,
                                vcfg.latent_channels, generator=generator,
                                device=dev)
        elif not sample_posterior:
            noise = None
        lat = (h // down, w // down, vcfg.latent_channels)

        def encode(v, *draw):
            fl = v.shape[1]
            z = models.vae.encode(v.reshape(b * fl, h, w, c).to(dtype),
                                  draw[0].reshape(b * fl, *lat) if draw
                                  else None) * vae_scale
            return z.reshape(b, fl, *z.shape[1:])

        if noise is None:
            z = frame_local(encode, video)
        else:
            noise = torch.as_tensor(noise, device=dev).reshape(b, f, *lat)
            z = frame_local(encode, video, noise)
        return {"latents_x0": z[:, :cond_frames], "latents": z[:, cond_frames:],
                "clip_emb": clip_emb}

    return prepare


def make_train_step(models: SeerModels,
                    schedule: Optional[DiffusionSchedule] = None,
                    cond_frames: int = 2, prediction_type: str = "epsilon",
                    text_loss: bool = False, ema_decay: float = 0.0,
                    snr_gamma: float = 0.0, lora_scale: float = 0.0) -> Callable:
    """``train_step(state, batch, generator=None, noise=None,
    timesteps=None) -> metrics`` (``loss``, ``grad_norm``, ``mse`` as
    scalar tensors on the device; ``did_sync`` a bool).  The state is
    updated in place.  Noise and timesteps come from ``generator`` unless
    they are handed in.  ``train_step.loss_and_grads(names, batch, noise,
    timesteps)`` is the differentiated part alone: ``(loss, mse, {name:
    fp32 gradient})``.

    ``lora_scale`` > 0: ``models.lora`` holds the adapters
    (``lora.enable_lora``); the UNet computes with ``W + lora_scale * (A @
    B)^T`` on the adapted projections, forward and backward, and the
    gradients reach A and B (and FSText), never the frozen UNet."""
    if prediction_type not in ("epsilon", "v_prediction"):
        raise ValueError(f"unknown prediction type {prediction_type!r}")
    if lora_scale > 0.0 and not models.lora:
        raise ValueError("lora_scale > 0 but the models carry no adapters "
                         "(build them with training.lora.enable_lora)")
    train_schedule = schedule or DiffusionSchedule.sd15_train_schedule()
    dev = models.unet.conv_in.weight.device
    acp = torch.as_tensor(train_schedule.alphas_cumprod, device=dev)
    num_timesteps = train_schedule.num_timesteps
    unet, fstext = models.unet, models.fstext

    def loss_fn(batch, noise, timesteps):
        """(loss, mse) of this rank: the whole values without ``seq``,
        this rank's shares of them under it."""
        context = fstext(batch["clip_emb"])
        loss_text = 0.0
        if text_loss:
            # FSText init objective: the frame-mean of FSText's per-frame
            # outputs should reproduce the CLIP embedding
            loss_text = ((context.mean(dim=1) - batch["clip_emb"]) ** 2).mean()
        latents = batch["latents"]
        noisy = add_noise(acp, latents, noise, timesteps)
        target = (noise if prediction_type == "epsilon"
                  else get_velocity(acp, latents, noise, timesteps))
        x_in = torch.cat([batch["latents_x0"], noisy], dim=1)
        shard = frame_shard(x_in.shape[1])
        if shard is not None:
            return _shard_loss(x_in, target, timesteps, context, loss_text,
                               shard)
        pred = unet(x_in, timesteps, context, cond_frame=cond_frames)
        pred = pred[:, cond_frames:]
        se = (pred.float() - target.float()) ** 2
        mse = se.mean()
        if snr_gamma > 0.0:
            # min-SNR-gamma: per-sample MSE weighted by the clamped SNR; the
            # `mse` metric stays the raw MSE
            w = min_snr_weight(acp, timesteps, snr_gamma, prediction_type)
            loss = (w * se.reshape(se.shape[0], -1).mean(dim=1)).mean()
        else:
            loss = mse
        return loss + loss_text, mse

    def _shard_loss(x_in, target, timesteps, context, loss_text, shard):
        """This rank's frames through the UNet; the squared error of its
        future frames against ``target`` summed, over the global counts."""
        lo, hi = shard.start, shard.stop
        pred = unet(x_in[:, lo:hi], timesteps, context[:, lo:hi],
                    cond_frame=cond_frames, num_frames=shard.total)
        first = max(lo, cond_frames)
        pred = pred[:, first - lo:]
        mine = target[:, first - cond_frames:hi - cond_frames]
        se = (pred.float() - mine.float()) ** 2
        b = target.shape[0]
        per_sample = se.reshape(b, -1).sum(dim=1) / target[0].numel()
        mse = per_sample.mean()
        if snr_gamma > 0.0:
            w = min_snr_weight(acp, timesteps, snr_gamma, prediction_type)
            loss = (w * per_sample).mean()
        else:
            loss = mse
        return loss + loss_text / len(shard.counts), mse

    def _differentiate(params, batch, noise, timesteps):
        """The loss pair and its gradients with respect to ``params``."""
        with profiling.span("train.forward", events=True):
            loss, mse = loss_fn(batch, noise, timesteps)
        with profiling.span("train.backward", events=True, autograd=True):
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss, mse, grads

    def loss_and_grads(names, batch, noise, timesteps):
        """``(loss, mse, {name: fp32 gradient})``: under a mesh the global
        values, the gradients reduced over every rank; under a sharded
        state ``{group: gradient shard}``, whatever ``names``."""
        if models.sharding is not None:
            return _sharded_loss_and_grads(models.sharding, batch, noise,
                                           timesteps)
        named = models.named_trainable()
        params = [named[n] for n in names]
        adapted = (lora_applied(unet, models.lora, lora_scale)
                   if lora_scale > 0.0 else contextlib.nullcontext())
        # the adapted weights stay in place through the backward, where a
        # remat block recomputes its forward
        with torch.enable_grad(), adapted:
            loss, mse, grads = _differentiate(params, batch, noise,
                                              timesteps)
        # the master's gradient is the compute copy's, cast to fp32; a
        # parameter the loss does not reach gets zeros
        grads = [torch.zeros_like(p, dtype=torch.float32) if g is None
                 else g.float() for p, g in zip(params, grads)]
        loss, mse = loss.detach(), mse.detach()
        mesh = get_activation_mesh()
        if mesh is not None:
            loss, mse, grads = _reduce(mesh, loss, mse, grads)
        grads = dict(zip(names, grads))
        if models.tensor_parallel is not None:
            models.tensor_parallel.sum_partial(grads)
        return loss, mse, grads

    def _sharded_loss_and_grads(plan, batch, noise, timesteps):
        """The sharded state's gradients: the replicated parameters'
        gradients whole, reduce-scattered by the plan; under fsdp the units'
        master shards take theirs in the backward."""
        names, params = plan.grad_targets(models)
        adapted = (lora_applied(unet, models.lora, lora_scale)
                   if lora_scale > 0.0 and plan.mode == "zero1"
                   else contextlib.nullcontext())
        with torch.enable_grad(), adapted, plan.training_pass():
            loss, mse, grads = _differentiate(params, batch, noise,
                                              timesteps)
        grads = {n: torch.zeros_like(p, dtype=torch.float32) if g is None
                 else g.float() for n, p, g in zip(names, params, grads)}
        # summed over the data x seq ranks of this model index (the ranks
        # of one model group hold one loss), a mean over data
        pair = torch.stack([loss.detach().float(), mse.detach().float()])
        all_reduce_(pair, plan.replica_group)
        pair /= plan.n
        if models.tensor_parallel is not None:
            models.tensor_parallel.sum_partial(grads)
        return pair[0], pair[1], plan.reduce_grads(grads)

    def _reduce(mesh, loss, mse, grads):
        """Sum over ``seq`` (the shares) and mean over ``data`` (the
        replicas): one all-reduce of a flat buffer over the ``data`` x
        ``seq`` ranks of this rank's model index (every rank without a
        ``model`` axis)."""
        flat = torch.cat([loss.reshape(1).float(), mse.reshape(1).float()]
                         + [g.reshape(-1) for g in grads])
        if mesh.replicas > 1:
            all_reduce_(flat, mesh.replica_group())
        flat /= mesh.axis_size("data")
        sizes = [1, 1] + [g.numel() for g in grads]
        loss, mse, *parts = flat.split(sizes)
        return (loss[0], mse[0],
                [p.view_as(g) for p, g in zip(parts, grads)])

    def train_step(state: TrainState, batch: dict,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None,
                   timesteps: Optional[torch.Tensor] = None) -> dict:
        if ema_decay > 0.0 and state.ema is None:
            raise ValueError("ema_decay > 0 requires TrainState.create(..., "
                             "ema=True)")
        latents = batch["latents"]
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator,
                                device=dev, dtype=torch.float32)
        noise = torch.as_tensor(noise, device=dev).to(latents.dtype)
        if timesteps is None:
            timesteps = torch.randint(0, num_timesteps, (latents.shape[0],),
                                      generator=generator, device=dev)
        timesteps = torch.as_tensor(timesteps, device=dev).long()

        loss, mse, grads = loss_and_grads(state.optimizer.names, batch, noise,
                                          timesteps)
        with profiling.span("train.optimizer", events=True, micro=state.step):
            did_sync, gnorm = state.optimizer.update(grads)
        state.step += 1
        if did_sync:
            with profiling.span("train.sync"):
                if models.sharding is not None:
                    models.sharding.after_step(models)
                else:
                    sync_compute_copies(models)
                if ema_decay > 0.0:
                    # LitEma warmup; advances only when the weights changed
                    n = state.optimizer.count
                    d = min(ema_decay, (1.0 + n) / (10.0 + n))
                    with torch.no_grad():
                        ema = [state.ema[k] for k in state.optimizer.names]
                        torch._foreach_mul_(ema, d)
                        torch._foreach_add_(ema, state.optimizer.params,
                                            alpha=1.0 - d)
        return {"loss": loss, "grad_norm": gnorm, "mse": mse,
                "did_sync": did_sync}

    train_step.loss_and_grads = loss_and_grads
    return train_step
