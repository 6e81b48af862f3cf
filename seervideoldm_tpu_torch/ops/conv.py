"""Inflated (per-frame 2D) convolution, channels-last (port of
``seervideoldm_tpu/ops/conv.py``).

Video tensors stay ``(b, f, h, w, c)``; frames fold into the batch and the
conv runs on a channels-last view (``permute`` only, so cuDNN sees NHWC
memory and no copy is made).  The module is an ``nn.Conv2d``, so its
parameters carry the reference names and OIHW layout.
"""
from __future__ import annotations

import torch
import torch.nn as nn


def conv2d_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """(n, h, w, c_in) -> (n, h', w', c_out) through ``conv``."""
    y = conv._conv_forward(x.permute(0, 3, 1, 2), conv.weight, conv.bias)
    return y.permute(0, 2, 3, 1)


class InflatedConv(nn.Conv2d):
    """2D conv applied per frame over ``(b, f, h, w, c)``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, f = x.shape[:2]
        y = conv2d_nhwc(self, x.reshape(b * f, *x.shape[2:]))
        return y.reshape(b, f, *y.shape[1:])


class TemporalConv(nn.Conv3d):
    """A Conv3d whose kernel spans frames only (``(k, 1, 1)``, padding
    ``(k // 2, 0, 0)``: Stable Video Diffusion's temporal convs) over
    ``(b, f, h, w, c)``.  The conv runs on the ``(b, c, f, h, w)`` view of
    the channels-last tensor (``permute`` only: cuDNN sees NDHWC memory),
    and its parameters carry the diffusers names and OIDHW layout."""

    def __init__(self, in_channels: int, out_channels: int, frames: int = 3):
        super().__init__(in_channels, out_channels, (frames, 1, 1),
                         padding=(frames // 2, 0, 0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._conv_forward(x.permute(0, 4, 1, 2, 3), self.weight, self.bias)
        return y.permute(0, 2, 3, 4, 1)
