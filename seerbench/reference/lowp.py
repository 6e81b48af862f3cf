"""The control: the reference computed one precision below the
configuration's bf16, in fp8.  Inside ``Fp8Mode`` both operands of every
matmul, linear layer and convolution are rounded to float8 e4m3 (one
scale per tensor, its absolute maximum over e4m3's largest value 448),
the product then taken in fp32; biases, norms, softmax and the rest stay
fp32.  A comparison that cannot tell this from the program's bf16 path
cannot tell a lower-precision program either."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0
_OPS = {F.linear, F.conv2d, torch.conv2d, torch.matmul, torch.bmm,
        torch.Tensor.matmul, torch.Tensor.__matmul__}


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 at a per-tensor scale, back in x's dtype; the
    gradient passes straight through (autograd's own backward products
    stay fp32)."""
    with torch.no_grad():
        scale = x.abs().amax().clamp_min(1e-30) / E4M3_MAX
        q = (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach() if x.requires_grad else q


class Fp8Mode(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _OPS:
            args = tuple(to_fp8(a) if i < 2 and isinstance(a, torch.Tensor)
                         and a.is_floating_point() else a
                         for i, a in enumerate(args))
        return func(*args, **kwargs)
