"""3D (per-frame 2D) ResNet blocks and spatial resampling (port of
``seervideoldm_tpu/models/resnet3d.py``).

fp32 GroupNorm islands, SiLU, the time embedding added per channel, a 1x1
shortcut on a channel change; nearest 2x upsample and stride-2 downsample,
spatial only.  Layout ``(b, f, h, w, c)``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import InflatedConv
from ..ops.norms import GroupNorm, group_norm_silu
from ..utils import profiling


class Upsample3D(nn.Module):
    """Nearest 2x spatial upsample + 3x3 conv."""

    # an FSDP unit: gathers its weights whole per call (parallel/sharding.py)
    fsdp_unit = True

    def __init__(self, channels: int, out_channels: Optional[int] = None):
        super().__init__()
        self.conv = InflatedConv(channels, out_channels or channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return self.conv(x)


class Downsample3D(nn.Module):
    """Stride-2 spatial 3x3 conv."""

    # an FSDP unit: gathers its weights whole per call (parallel/sharding.py)
    fsdp_unit = True

    def __init__(self, channels: int, out_channels: Optional[int] = None,
                 padding: int = 1):
        super().__init__()
        self.padding = padding
        self.conv = InflatedConv(channels, out_channels or channels, 3, stride=2,
                                 padding=padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == 0:
            # reference pads (left 0, right 1, top 0, bottom 1)
            x = F.pad(x, (0, 0, 0, 1, 0, 1))
        return self.conv(x)


class ResnetBlock3D(nn.Module):
    """GN(fp32) -> SiLU -> conv -> +temb -> GN -> SiLU -> conv (+shortcut)."""

    # an FSDP unit: gathers its weights whole per call (parallel/sharding.py)
    fsdp_unit = True

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 temb_channels: Optional[int] = 512, groups: int = 32,
                 eps: float = 1e-6):
        super().__init__()
        out_ch = out_channels or in_channels
        self.norm1 = GroupNorm(groups, in_channels, eps)
        self.conv1 = InflatedConv(in_channels, out_ch, 3, padding=1)
        self.time_emb_proj = (nn.Linear(temb_channels, out_ch)
                              if temb_channels else None)
        self.norm2 = GroupNorm(groups, out_ch, eps)
        self.conv2 = InflatedConv(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = (InflatedConv(in_channels, out_ch, 1)
                              if in_channels != out_ch else None)

    @profiling.site("resnet")
    def forward(self, x: torch.Tensor,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(group_norm_silu(self.norm1, x))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None, None, :]
        h = self.conv2(group_norm_silu(self.norm2, h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h
