"""Plain fp32 training: the eps-MSE loss on the future frames, the running
mean over accumulated micro-steps, the global-norm clip and AdamW, as the
port's ``training/trainer.py`` and ``training/optim.py`` define them
(optax semantics: bias-corrected moments, eps outside the root, decoupled
weight decay added before the learning-rate scaling; the first update
uses the schedule at the optimizer's count)."""
from __future__ import annotations

import math

import numpy as np
import torch

from .sampling import sd15_train_alphas_cumprod, vae_encode


def trainable_names(models) -> list:
    """The reference recipe's trainable set: the UNet's temporal sites and
    all of FSText."""
    return ([f"unet.{n}" for n, _ in models.unet.named_parameters()
             if "temporal_attentions" in n]
            + [f"fstext.{n}" for n, _ in models.fstext.named_parameters()])


def named_params(models) -> dict:
    return {**{f"unet.{n}": p for n, p in models.unet.named_parameters()},
            **{f"fstext.{n}": p for n, p in models.fstext.named_parameters()}}


def cosine_lr(count: int, lr: float, warmup: int, total: int) -> float:
    """Linear warm-up from 0, then a half cosine to 0 over the rest."""
    if count < warmup:
        return lr * (1.0 - (1.0 - count / warmup)) if warmup > 0 else lr
    decay = max(total, warmup + 1) - warmup
    c = min(count - warmup, decay)
    return lr * 0.5 * (1 + math.cos(math.pi * c / decay))


def _bias_correction(decay: float, count: int) -> float:
    f32 = torch.float32
    return float(1 - torch.tensor(decay, dtype=f32)
                 ** torch.tensor(float(count), dtype=f32))


def micro_step_grads(models, batch: dict, cond_frames: int, params: list):
    """(loss, [fp32 gradient per param]) of one micro-batch; the loss is
    the mean squared error over the whole batch, computed one row at a
    time (the rows' means averaged) so that the activations of one row are
    alive at once."""
    acp = torch.as_tensor(sd15_train_alphas_cumprod(),
                          device=batch["video"].device)
    with torch.no_grad():
        clip_emb = models.clip(batch["input_ids"], batch["attention_mask"])
        z = vae_encode(models.vae, batch["video"], batch["post_noise"])
    x0, lat = z[:, :cond_frames], z[:, cond_frames:]
    b = lat.shape[0]
    grads = [torch.zeros_like(p) for p in params]
    total = 0.0
    for r in range(b):
        t = batch["timesteps"][r:r + 1].long()
        a = acp[t].reshape(1, 1, 1, 1, 1)
        noise = batch["noise"][r:r + 1]
        noisy = torch.sqrt(a) * lat[r:r + 1] + torch.sqrt(1.0 - a) * noise
        with torch.enable_grad():
            context = models.fstext(clip_emb[r:r + 1])
            pred = models.unet(torch.cat([x0[r:r + 1], noisy], dim=1), t,
                               context, cond_frame=cond_frames)
            loss = ((pred[:, cond_frames:] - noise) ** 2).mean() / b
            g = torch.autograd.grad(loss, params, allow_unused=True)
        for acc, gi in zip(grads, g):
            if gi is not None:
                acc += gi
        total += loss.item()
    return total, grads


class AdamW:
    """MultiSteps(clip_by_global_norm -> adamw) over ``params``."""

    def __init__(self, params: list, lr: float, warmup: int, total: int,
                 count: int, betas=(0.9, 0.999), weight_decay=1e-2, eps=1e-8,
                 max_grad_norm=0.3):
        self.params, self.lr, self.warmup, self.total = params, lr, warmup, total
        self.count, self.b1, self.b2 = count, betas[0], betas[1]
        self.wd, self.eps, self.max_norm = weight_decay, eps, max_grad_norm
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads: list) -> list:
        """One update from the mean gradient; returns the clipped
        gradient per leaf, as the moments take it."""
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        factor = 1.0 if float(norm) < self.max_norm else self.max_norm / float(norm)
        g = [gi * factor for gi in grads]
        lr = cosine_lr(self.count, self.lr, self.warmup, self.total)
        self.count += 1
        c1 = _bias_correction(self.b1, self.count)
        c2 = _bias_correction(self.b2, self.count)
        for p, gi, mu, nu in zip(self.params, g, self.mu, self.nu):
            mu.mul_(self.b1).add_(gi, alpha=1 - self.b1)
            nu.mul_(self.b2).addcmul_(gi, gi, value=1 - self.b2)
            upd = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            p.add_(upd + self.wd * p, alpha=-lr)
        return g


def train(models, micro_batches: list, accumulation: int, cond_frames: int,
          opt_kwargs: dict, steps: int) -> dict:
    """``steps`` optimizer steps over ``micro_batches`` (accumulation per
    step).  Returns the micro-step losses, each leaf's first clipped mean
    gradient norm, and each leaf's change norm after the last step."""
    names = trainable_names(models)
    named = named_params(models)
    params = [named[n] for n in names]
    for p in params:
        p.requires_grad_(True)
    start = [p.detach().clone() for p in params]
    opt = AdamW(params, **opt_kwargs)
    losses, first_grad = [], None
    for s in range(steps):
        mean = None
        for k in range(accumulation):
            loss, g = micro_step_grads(models, micro_batches[s * accumulation + k],
                                       cond_frames, params)
            losses.append(loss)
            mean = g if mean is None else [m + (gi - m) / (k + 1)
                                           for m, gi in zip(mean, g)]
        clipped = opt.step(mean)
        if first_grad is None:
            first_grad = [float(torch.linalg.vector_norm(g)) for g in clipped]
    change = [float(torch.linalg.vector_norm(p.detach() - s0))
              for p, s0 in zip(params, start)]
    return {"names": names, "losses": np.asarray(losses),
            "first_grad": np.asarray(first_grad), "change": np.asarray(change)}
