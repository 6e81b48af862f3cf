"""Normalisation layers with fp32 statistics (port of
``seervideoldm_tpu/ops/norms.py``).

Channels-last inputs; the input is cast to fp32, normalised, the fp32
affine applied, and the result cast back to the input dtype.  Parameters
stay fp32 whatever the compute dtype (``utils/device.py::cast_for_compute``
skips them).  Parameter names are torch's (``weight``, ``bias``), so the
reference checkpoints load as they are.
"""
from __future__ import annotations

import torch
import torch.nn as nn


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
        flat = x32.reshape(b, -1, g, c // g)
        var, mean = torch.var_mean(flat, dim=(1, 3), unbiased=False)  # (b, g)
        rstd = torch.rsqrt(var + self.eps)
        scale = rstd.repeat_interleave(c // g, dim=-1) * self.weight.float()
        shift = self.bias.float() - mean.repeat_interleave(c // g, dim=-1) * scale
        shape = (b,) + (1,) * (x.dim() - 2) + (c,)
        return (x32 * scale.reshape(shape) + shift.reshape(shape)).to(x.dtype)


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
