"""FSText, the frame-sequential text decomposer (port of
``seervideoldm_tpu/models/fstext.py``).

One CLIP embedding ``(b, l, 768)`` -> per-frame sub-instruction embeddings
``(b, num_frames, l, 768)``: a learnable query plus a learned pos-embed
(nearest-resized along frames when the frame count differs from the
checkpoint's 16), ``num_layers`` x [per-frame token self-attention + cross-
attention of all f*l tokens to the CLIP context + FF; causal rotary
self-attention across frames per token + FF], final LayerNorm.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..ops.attention import CrossAttention
from ..ops.norms import LayerNorm
from .transformer3d import FeedForward

MAX_LENGTH = 1024


class BasicLinearTransformerBlock3D(nn.Module):
    def __init__(self, dim: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None, temporal: bool = False):
        super().__init__()
        self.temporal = temporal
        self.attn1 = CrossAttention(dim, heads=n_heads, dim_head=d_head,
                                    temporal=temporal, causal=temporal)
        self.norm1 = LayerNorm(dim)
        if not temporal:
            self.attn2 = CrossAttention(dim, context_dim, heads=n_heads,
                                        dim_head=d_head)
            self.norm2 = LayerNorm(dim)
        self.ff = FeedForward(dim)
        self.norm3 = LayerNorm(dim)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, f, l, c = x.shape
        if self.temporal:
            # frames are the sequence, per token position
            x = x.transpose(1, 2).reshape(b * l, f, c)
            x = self.attn1(self.norm1(x)) + x
            x = self.ff(self.norm3(x)) + x
            return x.reshape(b, l, f, c).transpose(1, 2)
        x = x.reshape(b * f, l, c)
        x = self.attn1(self.norm1(x)) + x
        if context is not None:
            x = x.reshape(b, f * l, c)
            x = self.attn2(self.norm2(x), context=context) + x
        x = self.ff(self.norm3(x)) + x
        return x.reshape(b, f, l, c)


class LinearTransformer3D(nn.Module):
    """[spatial + cross (context), temporal causal] blocks."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.transformer_blocks = nn.ModuleList([
            BasicLinearTransformerBlock3D(in_channels, n_heads, d_head,
                                          context_dim, temporal=False),
            BasicLinearTransformerBlock3D(in_channels, n_heads, d_head,
                                          temporal=True)])

    def forward(self, x, context=None):
        x = self.transformer_blocks[0](x, context)
        return self.transformer_blocks[1](x)


def nearest_resize_frames(pos_embed: torch.Tensor, num_frames: int) -> torch.Tensor:
    """torch ``F.interpolate(mode='nearest')`` along the frame axis:
    index floor(i * F0 / num_frames)."""
    f0 = pos_embed.shape[1]
    idx = torch.floor(torch.arange(num_frames, dtype=torch.float64)
                      * (f0 / num_frames)).long().to(pos_embed.device)
    return pos_embed.index_select(1, idx)


class FSTextTransformer(nn.Module):
    def __init__(self, num_frames: int = 16, pos_embed_frames: int = 16,
                 in_channels: int = 768, out_channels: int = 768,
                 n_heads: int = 8, num_layers: int = 8,
                 cross_attention_dim: int = 768):
        super().__init__()
        self.num_frames, self.pos_embed_frames = num_frames, pos_embed_frames
        self.out_channels = out_channels
        d_head = out_channels // n_heads
        self.learnable_query = nn.Parameter(torch.zeros(1, 1, 1, out_channels))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, pos_embed_frames, MAX_LENGTH, out_channels))
        self.trf_blocks = nn.ModuleList([
            LinearTransformer3D(in_channels, n_heads, d_head, cross_attention_dim)
            for _ in range(num_layers)])
        self.norm = LayerNorm(out_channels)

    def forward(self, context: torch.Tensor) -> torch.Tensor:
        """context (b, l, c) CLIP embedding -> (b, num_frames, l, c)."""
        b, l, _ = context.shape
        dtype = self.learnable_query.dtype
        pe = self.pos_embed[:, :, :l]
        if self.pos_embed_frames != self.num_frames:
            pe = nearest_resize_frames(pe, self.num_frames)
        x = self.learnable_query.expand(b, self.num_frames, l, -1) + pe
        context = context.to(dtype)
        for block in self.trf_blocks:
            x = block(x, context)
        return self.norm(x)
