"""DDPM training-time noise ops (port of
``seervideoldm_tpu/diffusion/ddpm.py``; diffusers ``DDPMScheduler``
semantics).

Pure functions over a precomputed ``alphas_cumprod`` table (a 1-D tensor on
the latents' device).  The schedule math runs in fp32 whatever the latents'
dtype; results are cast back to it.
"""
from __future__ import annotations

import torch


def _extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-sample schedule values, broadcastable over the trailing dims."""
    out = table[t.long()]
    return out.reshape(out.shape + (1,) * (ndim - 1))


def add_noise(alphas_cumprod: torch.Tensor, latents: torch.Tensor,
              noise: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
    """x_t = sqrt(acp_t) x_0 + sqrt(1 - acp_t) eps."""
    acp = alphas_cumprod.float()
    sqrt_a = _extract(torch.sqrt(acp), timesteps, latents.dim())
    sqrt_1ma = _extract(torch.sqrt(1.0 - acp), timesteps, latents.dim())
    return (sqrt_a * latents.float() + sqrt_1ma * noise.float()).to(
        latents.dtype)


def min_snr_weight(alphas_cumprod: torch.Tensor, timesteps: torch.Tensor,
                   gamma: float, prediction_type: str = "epsilon"
                   ) -> torch.Tensor:
    """Per-sample min-SNR-gamma loss weights (arXiv 2303.09556), fp32:
    ``min(SNR, gamma) / SNR`` for epsilon prediction (written division-last
    so SNR -> 0 gives 1) and ``min(SNR, gamma) / (SNR + 1)`` for
    v-prediction, with SNR_t = acp_t / (1 - acp_t)."""
    acp = alphas_cumprod.float()
    snr = (acp / (1.0 - acp))[timesteps.long()]
    if prediction_type == "epsilon":
        return torch.clamp(float(gamma) / snr, max=1.0)
    if prediction_type == "v_prediction":
        return torch.clamp(snr, max=float(gamma)) / (snr + 1.0)
    raise ValueError(f"unknown prediction type {prediction_type}")


def get_velocity(alphas_cumprod: torch.Tensor, sample: torch.Tensor,
                 noise: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
    """v = sqrt(acp_t) eps - sqrt(1 - acp_t) x_0 (the v-prediction target)."""
    acp = alphas_cumprod.float()
    sqrt_a = _extract(torch.sqrt(acp), timesteps, sample.dim())
    sqrt_1ma = _extract(torch.sqrt(1.0 - acp), timesteps, sample.dim())
    return (sqrt_a * noise.float() - sqrt_1ma * sample.float()).to(
        sample.dtype)
