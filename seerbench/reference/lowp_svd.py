"""The control for Stable Video Diffusion: ``lowp.Fp8Mode``'s rounding of
both operands of every matmul, linear layer and 2-D convolution to float8
e4m3, extended to the 3-D convolutions of the temporal layers
(``F.conv3d``), the product taken in fp32; the rest stays fp32."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .lowp import _OPS, Fp8Mode, to_fp8

OPS = _OPS | {F.conv3d, torch.conv3d}


class Fp8ModeSVD(Fp8Mode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in OPS:
            args = tuple(to_fp8(a) if i < 2 and isinstance(a, torch.Tensor)
                         and a.is_floating_point() else a
                         for i, a in enumerate(args))
        return func(*args, **kwargs)
