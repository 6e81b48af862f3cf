"""Noise schedules and DDIM tables (the port's copy of
``seervideoldm_tpu/diffusion/schedules.py``).

The reference's quirks are kept: "linear" is sqrt-space linear, the
sampler's schedule is linear_start 1e-4 -> linear_end 2e-2 over 1000 steps,
the training noise uses SD-1.5's own 0.00085 -> 0.012 (so the two differ,
as in the reference), and the uniform DDIM grid carries the +1 offset.
``trailing`` anchors the grid at T - 1 and ``rescale_zero_terminal_snr``
makes the last ᾱ exactly 0 (the zero-terminal-SNR recipe).  Tables are
computed in float64 numpy and exposed as float32.
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


def make_ddim_timesteps(discr_method: str, num_ddim_timesteps: int,
                        num_ddpm_timesteps: int) -> np.ndarray:
    """Ascending DDIM subsequence: ``uniform`` and ``quad`` with the
    reference's +1 offset (``quad`` repeats timesteps at small step
    counts), ``trailing`` from exactly S integer indices ending at T - 1."""
    if discr_method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        ts = np.asarray(list(range(0, num_ddpm_timesteps, c)))
    elif discr_method == "quad":
        ts = (np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8),
                          num_ddim_timesteps) ** 2).astype(int)
    elif discr_method == "trailing":
        s = num_ddim_timesteps
        ts = np.round(np.arange(1, s + 1) * (num_ddpm_timesteps / s))
        return ts.astype(np.int64) - 1
    else:
        raise NotImplementedError(f"unknown ddim discretization: "
                                  f"{discr_method}")
    return ts + 1


def make_ddim_sampling_parameters(alphacums: np.ndarray,
                                  ddim_timesteps: np.ndarray, eta: float):
    """Per-step (sigma, alpha, alpha_prev), DDIM eq. 12."""
    alphas = alphacums[ddim_timesteps]
    alphas_prev = np.asarray([alphacums[0]]
                             + alphacums[ddim_timesteps[:-1]].tolist())
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas)
                           * (1 - alphas / alphas_prev))
    return sigmas, alphas, alphas_prev


def rescale_zero_terminal_snr(alphas_cumprod: np.ndarray) -> np.ndarray:
    """Shift and scale sqrt(ᾱ) so the last entry is 0 and the first is
    unchanged (Lin et al. 2024, Algorithm 1); float64."""
    sqrt_acp = np.sqrt(alphas_cumprod.astype(np.float64))
    first, last = sqrt_acp[0], sqrt_acp[-1]
    sqrt_acp = (sqrt_acp - last) * first / (first - last)
    return sqrt_acp ** 2


@dataclass(frozen=True)
class DDIMTables:
    """Per-step tables, index 0 = first sampler iteration (highest t)."""

    timesteps: np.ndarray
    alphas: np.ndarray
    alphas_prev: np.ndarray
    sigmas: np.ndarray
    sqrt_one_minus_alphas: np.ndarray

    def tail(self, n: int) -> "DDIMTables":
        """The last ``n`` steps (the lowest-noise end of the grid)."""
        k = len(self.timesteps) - n
        return DDIMTables(self.timesteps[k:], self.alphas[k:],
                          self.alphas_prev[k:], self.sigmas[k:],
                          self.sqrt_one_minus_alphas[k:])


@dataclass(frozen=True)
class DiffusionSchedule:
    betas: np.ndarray
    alphas_cumprod: np.ndarray

    @staticmethod
    def create(num_timesteps: int = 1000,
               linear_start: float = DEFAULT_LINEAR_START,
               linear_end: float = DEFAULT_LINEAR_END,
               rescale_zero_snr: bool = False) -> "DiffusionSchedule":
        betas = make_beta_schedule(num_timesteps, linear_start, linear_end)
        alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
        if rescale_zero_snr:
            alphas_cumprod = rescale_zero_terminal_snr(alphas_cumprod)
            # betas back-derived from the rescaled table (terminal beta 1)
            prev = np.append(1.0, alphas_cumprod[:-1])
            with np.errstate(divide="ignore", invalid="ignore"):
                betas = 1.0 - np.where(prev > 0, alphas_cumprod / prev, 0.0)
        return DiffusionSchedule(betas=betas.astype(np.float32),
                                 alphas_cumprod=alphas_cumprod.astype(np.float32))

    @staticmethod
    def sd15_train_schedule(num_timesteps: int = 1000,
                            rescale_zero_snr: bool = False
                            ) -> "DiffusionSchedule":
        """The SD-1.5 DDPMScheduler schedule used for the training noise
        (scaled_linear 0.00085 -> 0.012)."""
        return DiffusionSchedule.create(num_timesteps, SD15_BETA_START,
                                        SD15_BETA_END, rescale_zero_snr)

    @property
    def has_zero_terminal_snr(self) -> bool:
        return float(self.alphas_cumprod[-1]) == 0.0

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    def ddim_tables(self, num_steps: int, eta: float = 0.0,
                    discr_method: str = "uniform") -> DDIMTables:
        ts = make_ddim_timesteps(discr_method, num_steps, self.num_timesteps)
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
