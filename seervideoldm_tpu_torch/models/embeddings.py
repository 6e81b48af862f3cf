"""Timestep embeddings (port of ``seervideoldm_tpu/models/embeddings.py``;
diffusers ``Timesteps`` / ``TimestepEmbedding`` semantics)."""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """(b,) -> (b, dim) fp32 sinusoidal embedding; the frequency table is
    computed in fp64 and rounded to fp32, as the JAX package does."""
    half = dim // 2
    exponent = -math.log(max_period) * np.arange(half, dtype=np.float64)
    exponent = exponent / (half - downscale_freq_shift)
    freqs = torch.from_numpy(np.exp(exponent).astype(np.float32)).to(timesteps.device)
    emb = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """linear_1 -> silu -> linear_2 (diffusers parameter names);
    ``out_dim`` (default ``time_embed_dim``) is linear_2's width."""

    def __init__(self, in_dim: int, time_embed_dim: int,
                 out_dim: Optional[int] = None):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, out_dim or time_embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(sample)))
