"""Normalisation layers with fp32 statistics (port of
``seervideoldm_tpu/ops/norms.py``).

Channels-last inputs; the input is cast to fp32, normalised, the fp32
affine applied, and the result cast back to the input dtype.  Parameters
stay fp32 whatever the compute dtype (``utils/device.py::cast_for_compute``
skips them).  Parameter names are torch's (``weight``, ``bias``), so the
reference checkpoints load as they are.

GroupNorm is two halves, ``group_norm_moments_plain`` (per-(b, group) mean
and rstd) and ``group_norm_apply_plain`` (the affine, the cast, an optional
SiLU); ``group_norm_silu(norm, x)`` is ``F.silu(norm(x))`` in one call.  On
a CUDA tensor both run as K11 (``ops/kernels/group_norm.py``, two kernels,
bit for bit the plain rounding points); on a CPU tensor the plain halves.
Under autograd on the card ``GroupNormFn`` runs K11 forward and recomputes
the plain halves in its backward.

Under a registered ``seq`` axis a video tensor ``(b, f, h, w, c)`` holds
only this rank's frames, while GroupNorm's statistics span every frame: the
per-channel moments ``s1 = sum x`` and ``s2 = sum x^2`` are summed over the
``seq`` ranks (a differentiable all-reduce) before mean and variance, as
GSPMD inserts for the JAX layer, with the JAX layer's formulas; the apply
half then runs as K11's apply kernel on the card.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.activation import seq_group
from ..parallel.collectives import all_reduce_sum
from .kernels import group_norm as K
from .remat import needs_grad


def _acc(t: torch.Tensor) -> torch.Tensor:
    """t in fp32, or wider where it is wider (fp64 in gradient checks)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def group_norm_moments_plain(x: torch.Tensor, groups: int, eps: float,
                             group=None) -> tuple:
    """(mean, rstd), each (b, groups) fp32, of a channels-last ``x``: over
    all of ``x`` but its first and last axes and ``c / groups`` channels;
    over ``group``'s ranks too when given (``_sharded_moments``)."""
    b, c = x.shape[0], x.shape[-1]
    x32 = _acc(x)
    if group is None:
        flat = x32.reshape(b, -1, groups, c // groups)
        var, mean = torch.var_mean(flat, dim=(1, 3), unbiased=False)
    else:
        mean, var = _sharded_moments(x32, groups, group)
    return mean, torch.rsqrt(var + eps)


def group_norm_apply_plain(x: torch.Tensor, mean: torch.Tensor,
                           rstd: torch.Tensor, weight: torch.Tensor,
                           bias: torch.Tensor, silu: bool = False
                           ) -> torch.Tensor:
    """x normalised by (mean, rstd) (b, groups), the fp32 affine, cast to
    x's dtype, then SiLU when ``silu``."""
    b, c, g = x.shape[0], x.shape[-1], mean.shape[-1]
    scale = rstd.repeat_interleave(c // g, dim=-1) * _acc(weight)
    shift = _acc(bias) - mean.repeat_interleave(c // g, dim=-1) * scale
    shape = (b,) + (1,) * (x.dim() - 2) + (c,)
    y = (_acc(x) * scale.reshape(shape) + shift.reshape(shape)).to(x.dtype)
    return F.silu(y) if silu else y


def _sharded_moments(x32: torch.Tensor, groups: int, group):
    """(mean, var), each (b, g), of a video whose frames are split over
    ``group``: the (b, c) moments and the element count all-reduced."""
    b, c = x32.shape[0], x32.shape[-1]
    flat = x32.reshape(b, -1, c)
    count = torch.full((b, c), float(flat.shape[1]), dtype=x32.dtype,
                       device=x32.device)
    moments = torch.stack([flat.sum(dim=1), (flat * flat).sum(dim=1), count])
    s1, s2, n = all_reduce_sum(moments, group).reshape(
        3, b, groups, c // groups).sum(-1).unbind(0)
    mean = s1 / n
    return mean, torch.clamp(s2 / n - mean * mean, min=0.0)


class GroupNormFn(torch.autograd.Function):
    """K11's forward (the plain halves for CPU tensors) with a plain-PyTorch
    backward by recomputation from the saved input.  ``mean`` / ``rstd``:
    the moments from the caller (the ``seq`` all-reduce, differentiable
    outside this function), or None for K11's own."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, rstd, groups, eps, silu):
        ctx.conf = (groups, eps, silu)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        if x.device.type != "cpu":
            moments = None if mean is None else (mean, rstd)
            return K.group_norm(x, groups, eps, weight, bias, silu, moments)
        if mean is None:
            mean, rstd = group_norm_moments_plain(x, groups, eps)
        return group_norm_apply_plain(x, mean, rstd, weight, bias, silu)

    @staticmethod
    def backward(ctx, g):
        groups, eps, silu = ctx.conf
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            x, weight, bias, mean, rstd = (
                None if t is None else t.detach().requires_grad_(keep)
                for t, keep in zip(ctx.saved_tensors, need))
            wanted = [t for t, keep in zip((x, weight, bias, mean, rstd), need)
                      if keep]
            if mean is None:
                mean, rstd = group_norm_moments_plain(x, groups, eps)
            out = group_norm_apply_plain(x, mean, rstd, weight, bias, silu)
            grads = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(grads) if keep else None for keep in need),
                None, None, None)


def _group_norm(norm: "GroupNorm", x: torch.Tensor, silu: bool
                ) -> torch.Tensor:
    g, eps, w, b = norm.num_groups, norm.eps, norm.weight, norm.bias
    group = seq_group() if x.dim() == 5 else None
    if x.device.type == "cpu":
        mean, rstd = group_norm_moments_plain(x, g, eps, group)
        return group_norm_apply_plain(x, mean, rstd, w, b, silu)
    mean = rstd = None
    if group is not None:
        mean, rstd = group_norm_moments_plain(x, g, eps, group)
    if needs_grad(x, w, b, mean, rstd):
        return GroupNormFn.apply(x, w, b, mean, rstd, g, eps, silu)
    moments = None if mean is None else (mean, rstd)
    # K11 on the card; on another device the wrapper raises
    return K.group_norm(x, g, eps, w, b, silu, moments)


def group_norm_silu(norm: "GroupNorm", x: torch.Tensor) -> torch.Tensor:
    """``F.silu(norm(x))`` in one call: on the card one K11 call with the
    SiLU in its apply kernel."""
    return _group_norm(norm, x, silu=True)


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
        return _group_norm(self, x, silu=False)


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
