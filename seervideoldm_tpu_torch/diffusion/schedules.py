"""Noise schedules and DDIM tables (the port's copy of
``seervideoldm_tpu/diffusion/schedules.py`` without the zero-SNR rescale).

The reference's quirks are kept: "linear" is sqrt-space linear, the
sampler's schedule is linear_start 1e-4 -> linear_end 2e-2 over 1000 steps,
the training noise uses SD-1.5's own 0.00085 -> 0.012 (so the two differ,
as in the reference), and the uniform DDIM grid carries the +1 offset.  Tables are computed in
float64 numpy and exposed as float32.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

DEFAULT_LINEAR_START = 1e-4
DEFAULT_LINEAR_END = 2e-2
SD15_BETA_START = 0.00085
SD15_BETA_END = 0.012


def make_beta_schedule(n_timestep: int,
                       linear_start: float = DEFAULT_LINEAR_START,
                       linear_end: float = DEFAULT_LINEAR_END) -> np.ndarray:
    """The reference's "linear" schedule (sqrt-space linear), float64."""
    return np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep,
                       dtype=np.float64) ** 2


def make_ddim_timesteps(num_ddim_timesteps: int,
                        num_ddpm_timesteps: int) -> np.ndarray:
    """Uniform DDIM subsequence with the reference's +1 offset."""
    c = num_ddpm_timesteps // num_ddim_timesteps
    return np.asarray(list(range(0, num_ddpm_timesteps, c))) + 1


def make_ddim_sampling_parameters(alphacums: np.ndarray,
                                  ddim_timesteps: np.ndarray, eta: float):
    """Per-step (sigma, alpha, alpha_prev), DDIM eq. 12."""
    alphas = alphacums[ddim_timesteps]
    alphas_prev = np.asarray([alphacums[0]]
                             + alphacums[ddim_timesteps[:-1]].tolist())
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas)
                           * (1 - alphas / alphas_prev))
    return sigmas, alphas, alphas_prev


@dataclass(frozen=True)
class DDIMTables:
    """Per-step tables, index 0 = first sampler iteration (highest t)."""

    timesteps: np.ndarray
    alphas: np.ndarray
    alphas_prev: np.ndarray
    sigmas: np.ndarray
    sqrt_one_minus_alphas: np.ndarray


@dataclass(frozen=True)
class DiffusionSchedule:
    betas: np.ndarray
    alphas_cumprod: np.ndarray

    @staticmethod
    def create(num_timesteps: int = 1000,
               linear_start: float = DEFAULT_LINEAR_START,
               linear_end: float = DEFAULT_LINEAR_END) -> "DiffusionSchedule":
        betas = make_beta_schedule(num_timesteps, linear_start, linear_end)
        alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
        return DiffusionSchedule(betas=betas.astype(np.float32),
                                 alphas_cumprod=alphas_cumprod.astype(np.float32))

    @staticmethod
    def sd15_train_schedule(num_timesteps: int = 1000) -> "DiffusionSchedule":
        """The SD-1.5 DDPMScheduler schedule used for the training noise
        (scaled_linear 0.00085 -> 0.012)."""
        return DiffusionSchedule.create(num_timesteps, SD15_BETA_START,
                                        SD15_BETA_END)

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    def ddim_tables(self, num_steps: int, eta: float = 0.0) -> DDIMTables:
        ts = make_ddim_timesteps(num_steps, self.betas.shape[0])
        sigmas, alphas, alphas_prev = make_ddim_sampling_parameters(
            self.alphas_cumprod.astype(np.float64), ts, eta)
        rev = slice(None, None, -1)
        return DDIMTables(
            timesteps=ts[rev].astype(np.int32),
            alphas=alphas[rev].astype(np.float32),
            alphas_prev=alphas_prev[rev].astype(np.float32),
            sigmas=sigmas[rev].astype(np.float32),
            sqrt_one_minus_alphas=np.sqrt(1.0 - alphas)[rev].astype(np.float32),
        )
