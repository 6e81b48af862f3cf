"""C3D UCF-101 classifier, the video Inception Score network (port of
``seervideoldm_tpu/evaluation/c3d.py``; reference chainer
``utils/models/c3d.py``), inference only.

- the pre-pass: RGB -> BGR swap x 128 on inputs in [-1, 1], each frame
  resized to 112 x 112 by ``align_corners=True`` bilinear (chainer
  ``F.resize_images``), then ``+ mean_bias`` (``128 - mean``, the UCF-101
  mean image cropped to 112);
- conv1a(64) pool(1, 2, 2) conv2a(128) pool conv3a/b(256) pool conv4a/b
  (512) pool conv5a/b(512) pool -> fc6(4096) fc7(4096) fc8(101); the max
  pools use chainer's ``cover_all`` (ceil) sizes, padded at the end with
  -inf as the JAX package does;
- the flatten before ``fc6`` is (C, T, H, W)-major, which NCDHW gives.

Parameter names and layouts are chainer's (``conv1a.weight`` (out, in,
t, h, w), ``fc6.weight`` (out, in)), so ``load_c3d_params`` copies the
``.npz`` arrays as they are.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

_CONVS = (("conv1a", 3, 64), ("conv2a", 64, 128), ("conv3a", 128, 256),
          ("conv3b", 256, 256), ("conv4a", 256, 512), ("conv4b", 512, 512),
          ("conv5a", 512, 512), ("conv5b", 512, 512))
# the pool after each of these convs, (t, h, w) kernel = stride
_POOLS = {"conv1a": (1, 2, 2), "conv2a": (2, 2, 2), "conv3b": (2, 2, 2),
          "conv4b": (2, 2, 2), "conv5b": (2, 2, 2)}


def max_pool_cover_all(x: torch.Tensor, kernel) -> torch.Tensor:
    """Max pool over (t, h, w) of NCDHW with stride = kernel and chainer
    ``cover_all`` output sizes ``ceil((n - k) / s) + 1``."""
    pads = []
    for n, k in zip(reversed(x.shape[2:]), reversed(kernel)):
        out = -(-max(n - k, 0) // k) + 1
        pads += [0, max((out - 1) * k + k - n, 0)]
    return F.max_pool3d(F.pad(x, pads, value=float("-inf")), kernel, kernel)


class C3D(nn.Module):
    """(b, 16, h, w, 3) in [-1, 1] RGB -> (b, 101) fc8 logits."""

    def __init__(self, num_outputs: int = 101):
        super().__init__()
        for name, cin, cout in _CONVS:
            setattr(self, name, nn.Conv3d(cin, cout, 3, padding=1))
        self.fc6 = nn.Linear(512 * 1 * 4 * 4, 4096)
        self.fc7 = nn.Linear(4096, 4096)
        self.fc8 = nn.Linear(4096, num_outputs)
        self.register_buffer("mean_bias", torch.zeros(3, 16, 112, 112))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        if t != 16:
            # the reference's chainer mean image is 16 frames
            # (c3d.py:69 Bias(shape=(3, 16, 112, 112)))
            raise ValueError(
                f"C3D inception score requires 16-frame clips, got {t} "
                "(reference chainer C3D mean-image is 16-frame; run IS on "
                "16-frame recipes like bridge/epickitchens, or set "
                "is_cast_frames)")
        x = x.flip(-1).reshape(b * t, h, w, c).permute(0, 3, 1, 2) * 128.0
        x = F.interpolate(x, size=(112, 112), mode="bilinear",
                          align_corners=True)
        x = x.reshape(b, t, c, 112, 112).transpose(1, 2) + self.mean_bias
        for name, _, _ in _CONVS:
            x = F.relu(getattr(self, name)(x))
            if name in _POOLS:
                x = max_pool_cover_all(x, _POOLS[name])
        x = F.relu(self.fc6(x.reshape(b, -1)))
        x = F.relu(self.fc7(x))
        return self.fc8(x)


def load_c3d_params(npz_path: str, mean_path: str, c3d: C3D) -> C3D:
    """``conv3d_deepnetA_ucf.npz`` (chainer) and ``mean2.npz`` (the mean
    image (3, 16, 120, 120), cropped to [8:120]) into ``c3d``, strictly."""
    data = np.load(npz_path)
    sd = {}
    for name in [n for n, _, _ in _CONVS] + ["fc6", "fc7", "fc8"]:
        sd[f"{name}.weight"] = torch.from_numpy(np.asarray(data[f"{name}/W"]))
        sd[f"{name}.bias"] = torch.from_numpy(np.asarray(data[f"{name}/b"]))
    mean = np.load(mean_path)["mean"][:, :, 8:8 + 112, 8:8 + 112]
    sd["mean_bias"] = torch.from_numpy(
        np.ascontiguousarray(128.0 - mean, dtype=np.float32))
    c3d.load_state_dict(sd, strict=True)
    return c3d
