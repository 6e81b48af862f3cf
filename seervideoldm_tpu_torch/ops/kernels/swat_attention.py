"""K1: fused SWAT windowed causal attention with rotary tables (CUDA C++,
``csrc/swat_attention.cu``).

Replaces ``seervideoldm_tpu/ops/pallas/swat_attention.py::
swat_attention_tables`` (forward ``_swat_forward_tab``, body
``_kernel_tab``).  On the H100 the kernel is tensor-core bound at the main
path's shape; one CTA owns one query frame of one window and streams the
visible key frames with an online softmax, because the window's 2.4 MB fp32
score matrix the TPU kept in VMEM does not fit in shared memory (see the
source note).

The wrapper runs the plain version for CPU tensors and the kernel for CUDA
tensors; there is no other path.
"""
from __future__ import annotations

import ctypes

import torch

from ..rotary import rotate_half
from ..windows import window_partition, window_reverse
from . import build
from .flash_attention import flash_attention_plain


def rotate_tables(t: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor) -> torch.Tensor:
    """fp32 ``t * cos + rotate_half(t) * sin`` over interleaved pairs
    (rotate_half(t)[2i] = -t[2i+1], rotate_half(t)[2i+1] = t[2i]), cast back
    to t's dtype."""
    t32 = t.float()
    return (t32 * cos + rotate_half(t32) * sin).to(t.dtype)


def swat_attention_tables_plain(q, k, v, cos, sin, scale: float,
                                causal: bool, ws: int) -> torch.Tensor:
    """``_unfused_reference_tab``: rotate, window-partition, masked fp32
    softmax attention, window-reverse."""
    _, f, h, w, _ = q.shape
    qr, kr = rotate_tables(q, cos, sin), rotate_tables(k, cos, sin)
    qw, kw, vw = (window_partition(t, ws) for t in (qr, kr, v))
    ow = flash_attention_plain(qw, kw, vw, scale, causal)
    return window_reverse(ow, ws, f, h, w)


def swat_attention_tables(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          cos: torch.Tensor, sin: torch.Tensor, scale: float,
                          causal: bool, ws: int) -> torch.Tensor:
    """q/k/v: (B, f, h, w, d) UN-rotated; cos/sin fp32 (f, h, w, d) from
    ``ops.rotary.rotary_tables``.  Returns (B, f, h, w, d)."""
    _, f, h, w, d = q.shape
    if h % ws or w % ws:
        raise ValueError(f"SWAT kernel needs h % ws == 0 and w % ws == 0; "
                         f"got h={h}, w={w}, ws={ws}")
    if q.device.type == "cpu":
        return swat_attention_tables_plain(q, k, v, cos, sin, scale, causal, ws)
    if q.device.type != "cuda":
        raise ValueError(f"swat_attention_tables: unsupported device {q.device}")
    if ws != 8:
        raise ValueError(f"swat_attention_tables: kernel covers ws = 8, got {ws}")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"swat_attention_tables: kernel takes bf16, got {q.dtype}")
    if cos.dtype != torch.float32 or sin.dtype != torch.float32:
        raise ValueError("swat_attention_tables: tables must be fp32")
    if d % 8 or d > 160:
        raise ValueError(f"swat_attention_tables: head dim {d} not covered "
                         "(multiple of 8, at most 160)")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    cos, sin = cos.contiguous(), sin.contiguous()
    out = torch.empty_like(q)
    lib = build.load("swat_attention")
    fn = lib.svl_swat_attention_tab_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(cos),
              build.ptr(sin), build.ptr(out), q.shape[0], f, h, w, d, ws,
              float(scale), int(causal), build.stream_of(q))
    build.check(lib, code, "swat_attention_tables")
    swat_attention_tables.launches += 1
    return out


swat_attention_tables.launches = 0
