"""Inception-v1 I3D (Kinetics-400), the FVD embedding network (port of
``seervideoldm_tpu/evaluation/i3d.py``; reference ``utils/models/i3d.py``),
inference only, on NCDHW videos in [-1, 1].

- TF-SAME padding everywhere: PyTorch has no SAME mode for strided convs
  and pools, so each dim is padded explicitly by ``max((ceil(n / s) - 1)
  * s + k - n, 0)``, the low side taking ``total // 2`` (odd totals pad
  asymmetrically); convs pad with zeros, max pools with -inf;
- BatchNorm in eval mode, ``(x - mean) * rsqrt(var + 1e-5) * scale +
  bias``;
- head: a (2, 7, 7) VALID average pool, the 1x1x1 ``logits`` conv with
  bias, a spatial squeeze and a mean over time -> (b, 400).

Parameters keep the reference torch I3D's names (``Mixed_3b.b1a.conv3d.
weight``, ``Conv3d_1a_7x7.bn.running_mean``, ...), so ``load_i3d_params``
is a shape-checked strict load of ``i3d_pretrained_400.pt``.  It runs in
fp32 (TF32 off, ``utils/device.py::set_numerics``), as the JAX package
runs it.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def same_pads(shape: Sequence[int], kernel: Sequence[int],
              stride: Sequence[int]) -> list[int]:
    """``F.pad`` amounts (last dim first) for TF-SAME over the trailing
    ``len(kernel)`` dims of ``shape``."""
    pads = []
    for n, k, s in zip(reversed(shape[-len(kernel):]), reversed(kernel),
                       reversed(stride)):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return pads


def max_pool_same(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    x = F.pad(x, same_pads(x.shape, kernel, stride), value=float("-inf"))
    return F.max_pool3d(x, kernel, stride)


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm3d under the torch names (``weight``, ``bias``,
    ``running_mean``, ``running_var``)."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        shape = (1, -1, 1, 1, 1)
        scale = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x - self.running_mean.view(shape)) * scale.view(shape)
                + self.bias.view(shape))


class Unit3D(nn.Module):
    """conv3d (TF-SAME) + eval-mode BN + ReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel=(1, 1, 1), stride=(1, 1, 1), use_batch_norm=True,
                 use_bias=False, activation=True):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.activation = activation
        self.conv3d = nn.Conv3d(in_channels, out_channels, self.kernel,
                                self.stride, bias=use_bias)
        self.bn = BatchNorm(out_channels) if use_batch_norm else None

    def forward(self, x):
        x = self.conv3d(F.pad(x, same_pads(x.shape, self.kernel, self.stride)))
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.activation else x


class InceptionModule(nn.Module):
    def __init__(self, in_channels: int, oc: Sequence[int]):
        """``oc``: [b0, b1a, b1b, b2a, b2b, b3b] output channels."""
        super().__init__()
        self.b0 = Unit3D(in_channels, oc[0])
        self.b1a = Unit3D(in_channels, oc[1])
        self.b1b = Unit3D(oc[1], oc[2], (3, 3, 3))
        self.b2a = Unit3D(in_channels, oc[3])
        self.b2b = Unit3D(oc[3], oc[4], (3, 3, 3))
        self.b3b = Unit3D(in_channels, oc[5])
        self.out_channels = oc[0] + oc[2] + oc[4] + oc[5]

    def forward(self, x):
        b3 = self.b3b(max_pool_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)),
                          self.b2b(self.b2a(x)), b3], dim=1)


_MIXED = (("Mixed_3b", (64, 96, 128, 16, 32, 32)),
          ("Mixed_3c", (128, 128, 192, 32, 96, 64)),
          ("Mixed_4b", (192, 96, 208, 16, 48, 64)),
          ("Mixed_4c", (160, 112, 224, 24, 64, 64)),
          ("Mixed_4d", (128, 128, 256, 24, 64, 64)),
          ("Mixed_4e", (112, 144, 288, 32, 64, 64)),
          ("Mixed_4f", (256, 160, 320, 32, 128, 128)),
          ("Mixed_5b", (256, 160, 320, 32, 128, 128)),
          ("Mixed_5c", (384, 192, 384, 48, 128, 128)))


class InceptionI3d(nn.Module):
    def __init__(self, num_classes: int = 400):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        c = 192
        for name, oc in _MIXED:
            setattr(self, name, InceptionModule(c, oc))
            c = getattr(self, name).out_channels
        self.logits = Unit3D(c, num_classes, use_batch_norm=False,
                             use_bias=True, activation=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (b, 3, t, 224, 224) in [-1, 1] -> (b, num_classes) logits."""
        x = self.Conv3d_1a_7x7(x)
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))  # MaxPool3d_2a_3x3
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))  # MaxPool3d_3a_3x3
        for name, _ in _MIXED:
            if name == "Mixed_4b":
                x = max_pool_same(x, (3, 3, 3), (2, 2, 2))  # MaxPool3d_4a_3x3
            elif name == "Mixed_5b":
                x = max_pool_same(x, (2, 2, 2), (2, 2, 2))  # MaxPool3d_5a_2x2
            x = getattr(self, name)(x)
        x = F.avg_pool3d(x, (2, 7, 7), stride=1)
        x = self.logits(x)
        return x.squeeze(4).squeeze(3).mean(dim=2)


def load_i3d_params(path: str, i3d: InceptionI3d) -> InceptionI3d:
    """Strictly load the reference's ``i3d_pretrained_400.pt`` (its
    ``num_batches_tracked`` counters are not used); raises on a missing,
    misshapen or unknown key."""
    from ..io.state_dict import load_state_dict

    sd = {k: v for k, v in load_state_dict(path).items()
          if not k.endswith("num_batches_tracked")}
    own = i3d.state_dict()
    missing = [k for k in own if k not in sd]
    unknown = [k for k in sd if k not in own]
    bad_shape = [f"{k}: {list(own[k].shape)} != {list(v.shape)}"
                 for k, v in sd.items()
                 if k in own and own[k].shape != v.shape]
    if missing or unknown or bad_shape:
        raise ValueError(f"i3d conversion: {len(missing)} missing "
                         f"{missing[:5]}, {len(unknown)} unknown "
                         f"{unknown[:5]}, shape mismatches {bad_shape[:5]}")
    i3d.load_state_dict(sd, strict=True)
    return i3d
