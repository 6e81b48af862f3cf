"""Rotary position embedding, rotary-embedding-torch 0.1.5 convention (port
of ``seervideoldm_tpu/ops/rotary.py``).

``inv_freq[j] = theta^(-2j/rot_dim)``; each per-position phase appears
twice adjacently and ``rotate_half`` acts on interleaved pairs
``(x0, x1) -> (-x1, x0)``; lanes >= rot_dim pass through (cos = 1,
sin = 0).  Phases are fp32.  In the SWAT temporal attention the positions
are the f-major full-resolution flattening ``frame*h*w + row*w + col``,
taken before windowing.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def inv_freq(rot_dim: int, theta: float = 10000.0,
             device=None) -> torch.Tensor:
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / rot_dim))


def rotary_freqs(positions: torch.Tensor, rot_dim: int,
                 theta: float = 10000.0) -> torch.Tensor:
    """fp32 phases, shape ``positions.shape + (rot_dim,)``, each frequency
    twice adjacently."""
    freqs = positions.float()[..., None] * inv_freq(rot_dim, theta,
                                                    positions.device)
    return freqs.repeat_interleave(2, dim=-1)


def _pad_tables(cos: torch.Tensor, sin: torch.Tensor, d: int):
    rot_dim = cos.shape[-1]
    if d > rot_dim:
        cos = F.pad(cos, (0, d - rot_dim), value=1.0)
        sin = F.pad(sin, (0, d - rot_dim), value=0.0)
    return cos, sin


def rotary_tables(f: int, h: int, w: int, d: int, rot_dim: int,
                  theta: float = 10000.0, device=None):
    """fp32 (f, h, w, d) cos/sin tables for positions
    ``frame*h*w + row*w + col``, pass-through lanes folded in."""
    pos = torch.arange(f * h * w, dtype=torch.float32,
                       device=device).reshape(f, h, w)
    freqs = rotary_freqs(pos, rot_dim, theta)
    return _pad_tables(torch.cos(freqs), torch.sin(freqs), d)


def rotate_half(t: torch.Tensor) -> torch.Tensor:
    """Interleaved pairs: out[2i] = -t[2i+1], out[2i+1] = t[2i]."""
    pairs = t.unflatten(-1, (-1, 2))
    return torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)


def apply_rotary(t: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Rotate the first ``rot_dim`` channels of ``t`` (..., seq, head_dim)
    in fp32; ``freqs`` broadcasts to ``t.shape[:-1] + (rot_dim,)``."""
    cos, sin = _pad_tables(torch.cos(freqs), torch.sin(freqs), t.shape[-1])
    t32 = t.float()
    return (t32 * cos + rotate_half(t32) * sin).to(t.dtype)
