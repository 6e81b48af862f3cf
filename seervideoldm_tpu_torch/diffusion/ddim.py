"""DDIM video sampler (port of ``seervideoldm_tpu/diffusion/ddim.py``: the
batched-CFG epsilon path and ``ddim_sample_loop``; a Python loop takes the
place of ``lax.scan``).

Reference semantics kept: the clean conditioning-frame latents ``x0_emb``
are concatenated on the frame axis before every UNet call and their
predicted noise is sliced off; classifier-free guidance batches
``[uncond; cond]`` through one UNet call; the update is
``x_prev = sqrt(a_prev) * pred_x0 + sqrt(1 - a_prev - sigma^2) * e_t`` in
fp32, cast back to the latents' dtype.  Layout ``(b, f, h, w, c)``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from .schedules import DDIMTables

UNetApply = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
# unet_apply(x (b, f, h, w, c), timesteps (b,) int, context (b, f, l, d)) -> eps


def make_eps_fn(unet_apply: UNetApply, context: torch.Tensor,
                x0_emb: Optional[torch.Tensor],
                uncond_context: Optional[torch.Tensor],
                guidance_scale: float) -> Callable:
    """``eps(img, t) -> e_t`` (fp32, future frames only)."""
    b = context.shape[0]
    use_cfg = uncond_context is not None and guidance_scale != 1.0
    cond_f = 0 if x0_emb is None else x0_emb.shape[1]
    if use_cfg:
        if uncond_context.shape != context.shape:
            raise ValueError("batched CFG needs uncond_context shaped like "
                             f"context; got {tuple(uncond_context.shape)} vs "
                             f"{tuple(context.shape)}")
        ctx_in = torch.cat([uncond_context, context], dim=0)

    def eps(img: torch.Tensor, t: int) -> torch.Tensor:
        x_cat = img if x0_emb is None else torch.cat([x0_emb, img], dim=1)
        ts = torch.full((b,), int(t), dtype=torch.int32, device=img.device)
        if not use_cfg:
            e_t = unet_apply(x_cat, ts, context)[:, cond_f:]
        else:
            e_all = unet_apply(torch.cat([x_cat, x_cat]), torch.cat([ts, ts]),
                               ctx_in)[:, cond_f:]
            e_uncond, e_cond = e_all.chunk(2, dim=0)
            e_t = e_uncond + guidance_scale * (e_cond - e_uncond)
        return e_t.float()

    return eps


def ddim_sample_loop(unet_apply: UNetApply, x_T: torch.Tensor,
                     tables: DDIMTables, context: torch.Tensor,
                     x0_emb: Optional[torch.Tensor] = None,
                     uncond_context: Optional[torch.Tensor] = None,
                     guidance_scale: float = 1.0) -> torch.Tensor:
    """The full DDIM reverse process (eta = 0); returns the final latents.
    ``tables`` are reverse-ordered, as ``DiffusionSchedule.ddim_tables``
    makes them."""
    eps_fn = make_eps_fn(unet_apply, context, x0_emb, uncond_context,
                         guidance_scale)
    img = x_T
    for i, t in enumerate(tables.timesteps.tolist()):
        a_t = float(tables.alphas[i])
        a_prev = float(tables.alphas_prev[i])
        sigma = float(tables.sigmas[i])
        sqrt_1m = float(tables.sqrt_one_minus_alphas[i])
        e_t = eps_fn(img, t)
        img32 = img.float()
        pred_x0 = (img32 - sqrt_1m * e_t) / math.sqrt(a_t)
        dir_xt = math.sqrt(max(1.0 - a_prev - sigma ** 2, 0.0)) * e_t
        img = (math.sqrt(a_prev) * pred_x0 + dir_xt).to(x_T.dtype)
    return img
