"""Normalisation layers with fp32 statistics (port of
``seervideoldm_tpu/ops/norms.py``).

Channels-last inputs; the input is cast to fp32, normalised, the fp32
affine applied, and the result cast back to the input dtype.  Parameters
stay fp32 whatever the compute dtype (``utils/device.py::cast_for_compute``
skips them).  Parameter names are torch's (``weight``, ``bias``), so the
reference checkpoints load as they are.

Under a registered ``seq`` axis a video tensor ``(b, f, h, w, c)`` holds
only this rank's frames, while GroupNorm's statistics span every frame: the
per-channel moments ``s1 = sum x`` and ``s2 = sum x^2`` are summed over the
``seq`` ranks (a differentiable all-reduce) before mean and variance, as
GSPMD inserts for the JAX layer, with the JAX layer's formulas.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..parallel.activation import seq_group
from ..parallel.collectives import all_reduce_sum


class GroupNorm(nn.Module):
    """GroupNorm over the last axis of a channels-last tensor, fp32
    statistics; torch ``nn.GroupNorm(num_groups, C)`` semantics."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"channels {num_channels} % groups {num_groups} != 0")
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, g = x.shape[0], x.shape[-1], self.num_groups
        x32 = x.float()
        group = seq_group() if x.dim() == 5 else None
        if group is None:
            flat = x32.reshape(b, -1, g, c // g)
            var, mean = torch.var_mean(flat, dim=(1, 3), unbiased=False)
        else:
            mean, var = self._sharded_moments(x32, group)
        rstd = torch.rsqrt(var + self.eps)
        scale = rstd.repeat_interleave(c // g, dim=-1) * self.weight.float()
        shift = self.bias.float() - mean.repeat_interleave(c // g, dim=-1) * scale
        shape = (b,) + (1,) * (x.dim() - 2) + (c,)
        return (x32 * scale.reshape(shape) + shift.reshape(shape)).to(x.dtype)

    def _sharded_moments(self, x32: torch.Tensor, group):
        """(mean, var), each (b, g), of a video whose frames are split over
        ``group``: the (b, c) moments and the element count all-reduced."""
        b, c, g = x32.shape[0], x32.shape[-1], self.num_groups
        flat = x32.reshape(b, -1, c)
        count = torch.full((b, c), float(flat.shape[1]), device=x32.device)
        moments = torch.stack([flat.sum(dim=1), (flat * flat).sum(dim=1),
                               count])
        s1, s2, n = all_reduce_sum(moments, group).reshape(3, b, g, c // g
                                                           ).sum(-1).unbind(0)
        mean = s1 / n
        return mean, torch.clamp(s2 / n - mean * mean, min=0.0)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, fp32 statistics, eps 1e-5."""

    def __init__(self, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var, mean = torch.var_mean(x32, dim=-1, keepdim=True, unbiased=False)
        out = (x32 - mean) / torch.sqrt(var + self.eps)
        return (out * self.weight.float() + self.bias.float()).to(x.dtype)
