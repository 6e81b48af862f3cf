"""DPM-Solver++(2M) video sampler (port of
``seervideoldm_tpu/diffusion/dpm_solver.py``).

A multistep solver of the probability-flow ODE in data-prediction form
(Lu et al., arXiv 2211.01095): with ``alpha_t = sqrt(a_t)``, ``sigma_t =
sqrt(1 - a_t)`` and ``lam_t = log(alpha_t / sigma_t)``, the step from t to
the less noisy s is

    x_s = (sigma_s / sigma_t) x_t - alpha_s (e^{-h} - 1) D,  h = lam_s - lam_t,

``D = x0_t`` at first order (exactly DDIM with eta 0) and ``x0_t + (x0_t -
x0_prev) / (2 r)``, ``r = h_prev / h``, at second order.  The first step,
the last under ``lower_order_final`` and degenerate steps (``h == 0`` from
a repeated timestep of the ``quad`` grid, or ``h_prev <= 0``) take first
order.  Scalars are numpy float32 as in the JAX package's fp32 tables: at
a zero-terminal-SNR first step ``lam(0) = -inf``, ``h = inf`` and
``expm1(-h) = -1``.  Conditioning, CFG, the guidance knobs and PAB are
``diffusion.ddim.make_eps_fn``'s.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .ddim import UNetApply, check_prediction, make_eps_fn, pab_steps
from .schedules import DDIMTables


def _lam(a: np.float32) -> np.float32:
    """log-SNR from ᾱ, fp32 (-inf at 0)."""
    with np.errstate(divide="ignore"):
        return np.float32(0.5) * (np.log(a) - np.log1p(-a))


def dpm_solver_sample_loop(unet_apply: UNetApply, x_T: torch.Tensor,
                           tables: DDIMTables, context: torch.Tensor,
                           x0_emb: Optional[torch.Tensor] = None,
                           uncond_context: Optional[torch.Tensor] = None,
                           guidance_scale: float = 1.0, order: int = 2,
                           lower_order_final: bool = True,
                           guidance_interval: Optional[tuple] = None,
                           prediction_type: str = "epsilon",
                           pab: Optional[tuple] = None,
                           guidance_rescale: float = 0.0,
                           group=None) -> torch.Tensor:
    """DPM-Solver++ over the DDIM sampler's reverse-ordered ``tables``;
    returns the final latents.  ``order`` 1 or 2 (2M)."""
    if order not in (1, 2):
        raise ValueError(f"order must be 1 or 2, got {order}")
    check_prediction(tables, prediction_type)
    num_steps = len(tables.timesteps)
    flags, cache = pab_steps(pab, num_steps)
    eps_fn = make_eps_fn(unet_apply, context, x0_emb, uncond_context,
                         guidance_scale, guidance_interval, guidance_rescale,
                         cache, group)
    img = x_T
    x0_prev, h_prev = None, np.float32(1.0)
    for i, t in enumerate(tables.timesteps.tolist()):
        a_t, a_prev = tables.alphas[i], tables.alphas_prev[i]
        e_t = eps_fn(img, t, flags[i])
        img32 = img.float()
        alpha_t, sigma_t = np.sqrt(a_t), np.sqrt(np.float32(1.0) - a_t)
        alpha_s, sigma_s = np.sqrt(a_prev), np.sqrt(np.float32(1.0) - a_prev)
        if prediction_type == "v_prediction":
            x0 = float(alpha_t) * img32 - float(sigma_t) * e_t
        else:
            x0 = (img32 - float(sigma_t) * e_t) / float(alpha_t)
        h = _lam(a_prev) - _lam(a_t)
        d = x0
        if order == 2:
            degenerate = h == 0.0 or h_prev <= 0.0
            first = (i == 0 or degenerate
                     or (lower_order_final and i == num_steps - 1))
            if not first:
                r = h_prev / h
                d = x0 + (x0 - x0_prev) / float(np.float32(2.0) * r)
        with np.errstate(over="ignore"):
            c_img = sigma_s / sigma_t
            c_d = alpha_s * np.expm1(-h)
        img = (float(c_img) * img32 - float(c_d) * d).to(x_T.dtype)
        x0_prev, h_prev = x0, h
    return img
