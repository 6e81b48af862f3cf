"""Device choice, numerics policy and compute-dtype casting for the port.

Entry points run on CUDA unless the caller asks for the CPU: on a host
without a GPU, ``resolve_device(None)`` raises instead of carrying on
silently on the CPU.

Numerics policy (``set_numerics``), stated once for every entry point:
fp32 matmuls and convolutions run in full fp32 (TF32 off for both cuBLAS
and cuDNN), and bf16 GEMMs reduce in fp32 (cuBLAS's reduced-precision
bf16 reduction off) -- the JAX package's ``preferred_element_type=f32``
contract.  The model computes in bf16 with fp32 statistics, softmax and
accumulation, as the JAX package does.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.norms import GroupNorm, LayerNorm

DTYPES = {"float32": torch.float32, "fp32": torch.float32, "no": torch.float32,
          "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
          "fp16": torch.bfloat16}  # fp16 configs run as bf16, like the JAX package


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def set_numerics() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def cast_for_compute(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every parameter and buffer to ``dtype`` except the norm layers'
    (fp32 statistics and affine, as the JAX package keeps them) and the
    rotary ``freqs`` buffers (fp32 phases)."""
    for sub in module.modules():
        if isinstance(sub, (GroupNorm, LayerNorm)):
            continue
        for name, p in sub.named_parameters(recurse=False):
            p.data = p.data.to(dtype)
        for name, b in sub.named_buffers(recurse=False):
            if name != "freqs":
                sub._buffers[name] = b.to(dtype)
    return module
