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
