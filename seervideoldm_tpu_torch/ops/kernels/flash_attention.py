"""K2: fused flash attention (CUDA C++, ``csrc/flash_attention.cu``).

Replaces ``seervideoldm_tpu/ops/pallas/flash_attention.py::flash_attention``
(forward; the single-shot and streamed TPU forms alike).  On the H100 the
kernel is tensor-core bound at the main-path shape; it streams K/V in
64-key tiles through shared memory with an online softmax, because 227 KB
cannot hold the whole K/V row the TPU kept in VMEM (see the source note).

The wrapper runs the plain version for CPU tensors and the kernel for CUDA
tensors; there is no other path.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

NEG_INF = torch.finfo(torch.float32).min


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, causal: bool = False) -> torch.Tensor:
    """The einsum branch of ``dot_product_attention``: fp32 logits and
    softmax, probabilities cast to v's dtype for the product."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        n, m = logits.shape[-2:]
        keep = torch.ones(n, m, dtype=torch.bool, device=q.device).tril(m - n)
        logits = logits.masked_fill(~keep, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, causal: bool = False) -> torch.Tensor:
    """softmax(q k^T * scale) v.  q: (..., n, d), k/v: (..., m, d); leading
    dims fold.  Causal = top-left tril (key <= query)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    n, d = q.shape[-2:]
    m = k.shape[-2]
    if causal and n != m:
        raise ValueError("flash_attention: causal needs n == m")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: kernel takes bf16, got {q.dtype}")
    if d % 8 or d > 160:
        raise ValueError(f"flash_attention: head dim {d} not covered "
                         "(multiple of 8, at most 160)")
    lead = q.shape[:-2]
    qf = q.reshape(-1, n, d).contiguous()
    kf = k.reshape(-1, m, d).contiguous()
    vf = v.reshape(-1, m, d).contiguous()
    out = torch.empty_like(qf)
    lib = build.load("flash_attention")
    fn = lib.svl_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(build.ptr(qf), build.ptr(kf), build.ptr(vf), build.ptr(out),
              qf.shape[0], n, m, d, float(scale), int(causal),
              build.stream_of(qf))
    build.check(lib, code, "flash_attention")
    flash_attention.launches += 1
    return out.reshape(*lead, n, d)


flash_attention.launches = 0
