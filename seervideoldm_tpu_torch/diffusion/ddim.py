"""DDIM video sampler (port of ``seervideoldm_tpu/diffusion/ddim.py``; a
Python loop takes the place of ``lax.scan``).

Reference semantics kept: the clean conditioning-frame latents ``x0_emb``
are concatenated on the frame axis before every UNet call and their
predicted noise is sliced off; classifier-free guidance batches
``[uncond; cond]`` through one UNet call when the two contexts have the
same trailing shape and takes two calls otherwise; the update is
``x_prev = sqrt(a_prev) * pred_x0 + sqrt(1 - a_prev - sigma^2) * e_t
+ sigma * temperature * noise`` in fp32, cast back to the latents' dtype.
Layout ``(b, f, h, w, c)``.

The per-step scalars are numpy float32, as the JAX package's fp32 tables
compute them (a zero-terminal-SNR grid has an exact 0 there).  The knobs
of the JAX package: ``guidance_interval`` (CFG only for ``lo <= t <=
hi``, a batch-b call outside), ``guidance_rescale`` (``combine_cfg``),
``prediction_type="v_prediction"``, and Pyramid Attention Broadcast
(``pab=(modes, mode_idx)`` from ``diffusion/pab.py``): the UNet takes each
step's flags and one cache dict made for the sampling call.

Under ``seq`` each rank holds its frames of the video; ``group`` (the seq
process group) makes ``guidance_rescale``'s std that of the whole clip.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..parallel.collectives import all_reduce_
from .pab import mode_to_flags
from .schedules import DDIMTables

UNetApply = Callable[..., torch.Tensor]
# unet_apply(x (b, f, h, w, c), timesteps (b,) int, context (b, f, l, d),
#            pab=None, pab_cache=None) -> eps; the PAB keywords only when
#            the sampler runs PAB


def _clip_std(e_cond: torch.Tensor, e_t: torch.Tensor, group):
    """Population std over every non-batch axis of each, fp32, keepdims;
    under ``group`` the std of the whole clip across the ranks (two
    all-reduces: the sums and counts, then the squared deviations)."""
    axes = tuple(range(1, e_t.dim()))
    if group is None:
        return (torch.std(e_cond, dim=axes, keepdim=True, correction=0),
                torch.std(e_t, dim=axes, keepdim=True, correction=0))
    both = torch.stack([e_cond, e_t])                      # (2, b, ...)
    dims = tuple(range(2, both.dim()))
    count = torch.full((2, both.shape[1]), float(both[0, 0].numel()),
                       device=both.device)
    sums = all_reduce_(torch.stack([both.sum(dim=dims), count]), group)
    mean = (sums[0] / sums[1]).reshape(sums[0].shape + (1,) * len(dims))
    sq = all_reduce_(((both - mean) ** 2).sum(dim=dims), group)
    std = torch.sqrt(sq / sums[1]).reshape(mean.shape)
    return std[0], std[1]


def make_eps_fn(unet_apply: UNetApply, context: torch.Tensor,
                x0_emb: Optional[torch.Tensor],
                uncond_context: Optional[torch.Tensor],
                guidance_scale: float,
                guidance_interval: Optional[tuple] = None,
                guidance_rescale: float = 0.0,
                pab_cache: Optional[dict] = None,
                group=None) -> Callable:
    """``eps(img, t, pab_flags=None) -> e_t`` (fp32, future frames only).
    With ``pab_cache`` (a dict, one per sampling call) every call passes
    its step's ``pab_flags`` and the cache to the UNet."""
    b = context.shape[0]
    use_cfg = uncond_context is not None and guidance_scale != 1.0
    cond_f = 0 if x0_emb is None else x0_emb.shape[1]
    unequal_cfg = use_cfg and uncond_context.shape[1:] != context.shape[1:]
    if pab_cache is not None:
        if unequal_cfg:
            raise ValueError("PAB requires the batched CFG path; expand "
                             "uncond_context to match context's shape")
        if guidance_interval is not None:
            raise ValueError("PAB and guidance_interval cannot be combined: "
                             "the interval's single-batch branch conflicts "
                             "with the CFG-batched PAB cache")
    if use_cfg and not unequal_cfg:
        ctx_in = torch.cat([uncond_context, context], dim=0)

    def combine_cfg(e_uncond, e_cond):
        """CFG, then optionally the std rescale (diffusers
        ``rescale_noise_cfg``): the guided output's per-sample std taken
        back to the cond branch's, blended by ``guidance_rescale``."""
        e_t = e_uncond + guidance_scale * (e_cond - e_uncond)
        if guidance_rescale == 0.0:
            return e_t
        e_t32 = e_t.float()
        std_pos, std_cfg = _clip_std(e_cond.float(), e_t32, group)
        rescaled = e_t32 * (std_pos / torch.clamp(std_cfg, min=1e-12))
        out = guidance_rescale * rescaled + (1.0 - guidance_rescale) * e_t32
        return out.to(e_t.dtype)

    def call(x, ts, ctx, flags):
        if pab_cache is None:
            return unet_apply(x, ts, ctx)[:, cond_f:]
        return unet_apply(x, ts, ctx, pab=flags, pab_cache=pab_cache)[:, cond_f:]

    def eps(img: torch.Tensor, t: int, pab_flags: Optional[dict] = None):
        x_cat = img if x0_emb is None else torch.cat([x0_emb, img], dim=1)
        ts = torch.full((b,), int(t), dtype=torch.int32, device=img.device)
        in_window = (guidance_interval is None
                     or guidance_interval[0] <= t <= guidance_interval[1])
        if not use_cfg or not in_window:
            e_t = call(x_cat, ts, context, pab_flags)
        elif unequal_cfg:
            e_t = combine_cfg(call(x_cat, ts, uncond_context, pab_flags),
                              call(x_cat, ts, context, pab_flags))
        else:
            e_all = call(torch.cat([x_cat, x_cat]), torch.cat([ts, ts]),
                         ctx_in, pab_flags)
            e_t = combine_cfg(*e_all.chunk(2, dim=0))
        return e_t.float()

    return eps


def check_prediction(tables: DDIMTables, prediction_type: str) -> None:
    if prediction_type not in ("epsilon", "v_prediction"):
        raise ValueError(f"unknown prediction type {prediction_type!r}")
    if prediction_type == "epsilon" and float(np.min(tables.alphas)) == 0.0:
        raise ValueError("epsilon prediction is undefined at SNR 0 (pred_x0 "
                         "divides by sqrt(alpha)=0); a zero-terminal-SNR "
                         "schedule requires prediction_type='v_prediction'")


def pab_steps(pab: Optional[tuple], num_steps: int):
    """Each step's PAB flags (None without PAB) and a fresh cache."""
    if pab is None:
        return [None] * num_steps, None
    modes, mode_idx = pab
    if len(mode_idx) != num_steps:
        raise ValueError(f"PAB schedule has {len(mode_idx)} steps but the "
                         f"sampler runs {num_steps}; build it with "
                         "build_pab_schedule(num_steps, ...)")
    return [mode_to_flags(modes[int(i)]) for i in mode_idx], {}


def ddim_sample_loop(unet_apply: UNetApply, x_T: torch.Tensor,
                     tables: DDIMTables, context: torch.Tensor,
                     x0_emb: Optional[torch.Tensor] = None,
                     uncond_context: Optional[torch.Tensor] = None,
                     guidance_scale: float = 1.0,
                     eta_generator: Optional[torch.Generator] = None,
                     temperature: float = 1.0,
                     guidance_interval: Optional[tuple] = None,
                     prediction_type: str = "epsilon",
                     pab: Optional[tuple] = None,
                     guidance_rescale: float = 0.0,
                     group=None) -> torch.Tensor:
    """The full DDIM reverse process over reverse-ordered ``tables``
    (index 0 = highest t); returns the final latents.  ``eta_generator``
    draws the ``sigma`` noise (tables built with eta > 0).
    ``prediction_type="v_prediction"`` reads the model output as
    ``v = sqrt(a) eps - sqrt(1 - a) x0``: ``e_t = sqrt(a) v + sqrt(1 - a)
    x_t`` and ``pred_x0 = sqrt(a) x_t - sqrt(1 - a) v`` (finite at a = 0).
    ``pab=(modes, mode_idx)``: one mode index per step."""
    check_prediction(tables, prediction_type)
    flags, cache = pab_steps(pab, len(tables.timesteps))
    eps_fn = make_eps_fn(unet_apply, context, x0_emb, uncond_context,
                         guidance_scale, guidance_interval, guidance_rescale,
                         cache, group)
    img = x_T
    for i, t in enumerate(tables.timesteps.tolist()):
        a_t, a_prev = tables.alphas[i], tables.alphas_prev[i]
        sigma, sqrt_1m = tables.sigmas[i], tables.sqrt_one_minus_alphas[i]
        e_t = eps_fn(img, t, flags[i])
        img32 = img.float()
        sqrt_a = float(np.sqrt(a_t))
        if prediction_type == "v_prediction":
            v_t = e_t
            e_t = sqrt_a * v_t + float(sqrt_1m) * img32
            pred_x0 = sqrt_a * img32 - float(sqrt_1m) * v_t
        else:
            pred_x0 = (img32 - float(sqrt_1m) * e_t) / sqrt_a
        c_dir = np.sqrt(np.maximum(np.float32(1.0) - a_prev - sigma ** 2,
                                   np.float32(0.0)))
        x_prev = float(np.sqrt(a_prev)) * pred_x0 + float(c_dir) * e_t
        if eta_generator is not None:
            noise = torch.randn(img.shape, generator=eta_generator,
                                device=img.device, dtype=torch.float32)
            x_prev = x_prev + float(sigma * np.float32(temperature)) * noise
        img = x_prev.to(x_T.dtype)
    return img


def stochastic_encode(tables: DDIMTables, x0: torch.Tensor, step_index,
                      noise: torch.Tensor) -> torch.Tensor:
    """Jump-forward encode to DDIM step ``step_index`` of the
    forward-ordered grid (low noise at 0): ``sqrt(a) x0 + sqrt(1 - a)
    noise`` in fp32.  The index is clamped to the grid, so ``len(tables)``
    (strength 1) encodes at the noisiest step."""
    alphas_fwd = torch.as_tensor(tables.alphas[::-1].copy(), device=x0.device)
    idx = torch.as_tensor(step_index, device=x0.device).clamp(
        0, len(alphas_fwd) - 1)
    a = alphas_fwd[idx]
    a = a.reshape(a.shape + (1,) * (x0.dim() - a.dim()))
    return torch.sqrt(a) * x0.float() + torch.sqrt(1.0 - a) * noise.float()


def ddim_decode_loop(unet_apply: UNetApply, x_latent: torch.Tensor,
                     tables: DDIMTables, context: torch.Tensor, t_start: int,
                     uncond_context: Optional[torch.Tensor] = None,
                     guidance_scale: float = 1.0, **kwargs) -> torch.Tensor:
    """Decode from an intermediate step: the last ``t_start`` reverse
    steps of the grid; the other keywords go to ``ddim_sample_loop``."""
    return ddim_sample_loop(unet_apply, x_latent, tables.tail(t_start),
                            context, uncond_context=uncond_context,
                            guidance_scale=guidance_scale, **kwargs)
