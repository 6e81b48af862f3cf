"""Euler sampling with EDM preconditioning, as Stable Video Diffusion
samples (diffusers ``EulerDiscreteScheduler`` under SVD-XT's
``scheduler_config.json``: v-prediction, Karras sigmas, continuous
timesteps; sgm's ``EulerEDMSampler`` with ``s_churn`` 0).

- ``karras_sigmas``: ``n`` sigmas from ``sigma_max`` down to ``sigma_min``
  with ``rho`` 7 (Karras et al., arXiv 2206.00364, eq. 5), then 0;
- ``c_noise``: the UNet's timestep, ``ln(sigma) / 4``;
- ``init_noise_sigma``: ``sqrt(sigma_max^2 + 1)`` (the "leading" spacing
  of the config), x_T = n x that;
- one step: the UNet sees ``x / sqrt(sigma^2 + 1)``; with the prediction
  ``v``, ``x0 = -sigma / sqrt(sigma^2 + 1) v + x / (sigma^2 + 1)`` and
  ``x <- x + (x - x0) / sigma (sigma_next - sigma)``.

Classifier-free guidance is one UNet call on ``[uncond; cond]`` with a
per-frame scale (SVD's ``linspace(min, max, frames)``).  The state stays
fp32; each UNet call takes it in the model's dtype.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..utils import profiling


def karras_sigmas(n: int, sigma_min: float = 0.002, sigma_max: float = 700.0,
                  rho: float = 7.0) -> torch.Tensor:
    """(n + 1,) fp32: the Karras schedule (fp64, then rounded), then 0."""
    ramp = np.linspace(0.0, 1.0, n)
    lo, hi = sigma_min ** (1.0 / rho), sigma_max ** (1.0 / rho)
    sigmas = (hi + ramp * (lo - hi)) ** rho
    return torch.from_numpy(np.append(sigmas, 0.0).astype(np.float32))


def c_noise(sigma: float) -> float:
    return 0.25 * math.log(sigma)


def init_noise_sigma(sigma_max: float) -> float:
    return math.sqrt(sigma_max ** 2 + 1.0)


def euler_edm_sample_loop(unet: Callable, x: torch.Tensor,
                          image_latents: torch.Tensor, context: torch.Tensor,
                          added_time_ids: torch.Tensor, sigmas: torch.Tensor,
                          guidance: torch.Tensor, dtype: torch.dtype
                          ) -> torch.Tensor:
    """x (b, f, h, w, c) fp32, already x_T; ``image_latents``, ``context``
    and ``added_time_ids`` with 2 b rows ``[uncond; cond]``; ``guidance``
    broadcastable to x (the per-frame scale).  Returns the final x."""
    meter = profiling.unet_meter(x.device)
    steps = sigmas.tolist()
    for i in range(len(steps) - 1):
        sigma, nxt = steps[i], steps[i + 1]
        with profiling.span("euler.step", events=True, step=i):
            scaled = x / math.sqrt(sigma * sigma + 1.0)
            inp = torch.cat([torch.cat([scaled, scaled]).to(dtype),
                             image_latents.to(dtype)], dim=-1)
            with meter:
                v = unet(inp, c_noise(sigma), context, added_time_ids)
            v_uncond, v_cond = v.float().chunk(2)
            v = v_uncond + guidance * (v_cond - v_uncond)
            x0 = v * (-sigma / math.sqrt(sigma * sigma + 1.0)) + x / (
                sigma * sigma + 1.0)
            x = x + (x - x0) / sigma * (nxt - sigma)
    return x
