"""Plain fp32 layers of the SeerUNet, FSText and the VAE: norms, convs,
rotary positions, windows, attention, the GEGLU feed-forward and the
resnet and transformer sites.

A frozen copy of the port's math (``ops/`` and ``models/`` of the PyTorch
package) with every kernel, mesh and remat path taken out: one plain
PyTorch path per op, computed in the dtype of its inputs (fp32 here).
Module and parameter names are the port's, so the port's state dict loads
strictly.

Reference parity notes kept on purpose (they are the reference's
behaviour, which the port reproduces):

- rotary positions of the temporal sites are ``frame*h*w + row*w + col``
  of the full-resolution f-major flattening, taken before windowing
  (``WindowTemporalAttention``);
- rotary pairs are interleaved (``rotate_half``) over the first
  ``min(32, d_head)`` channels;
- causality is lower-triangular over the f-major flattened window tokens
  (xformers' ``LowerTriangularMask``, the only path the reference runs);
- ``cond_frame`` (the temporal FF residual skipping the cond frames) is
  active only in training;
- the reference zero-initialises every ``proj_out``; the benchmark's
  weights do not (``weights.py``), so that every site reaches the output.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

NEG_INF = torch.finfo(torch.float32).min
# score elements per attention chunk: bounds the reference's peak memory
# at 512 px (24 frames x 8 heads x 4096^2 scores would be 13 GB at once)
ATTN_CHUNK_ELEMS = 1 << 28

# PAB flag names (diffusion/pab.py)
SPATIAL, CROSS, TEMPORAL = "spatial", "cross", "temporal"


# ----------------------------------------------------------------- norms

class GroupNorm(nn.Module):
    """GroupNorm over the last axis of a channels-last tensor."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        b, c, g = x.shape[0], x.shape[-1], self.num_groups
        flat = x.reshape(b, -1, g, c // g)
        var, mean = torch.var_mean(flat, dim=(1, 3), unbiased=False,
                                   keepdim=True)
        y = ((flat - mean) / torch.sqrt(var + self.eps)).reshape(x.shape)
        return y * self.weight + self.bias


class LayerNorm(nn.Module):
    def __init__(self, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        var, mean = torch.var_mean(x, dim=-1, keepdim=True, unbiased=False)
        return (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias


# ----------------------------------------------------------------- convs

def conv2d_nhwc(conv: nn.Conv2d, x):
    y = conv._conv_forward(x.permute(0, 3, 1, 2), conv.weight, conv.bias)
    return y.permute(0, 2, 3, 1)


class Conv(nn.Conv2d):
    """nn.Conv2d over channels-last (n, h, w, c)."""

    def forward(self, x):
        return conv2d_nhwc(self, x)


class InflatedConv(nn.Conv2d):
    """2D conv per frame over (b, f, h, w, c)."""

    def forward(self, x):
        b, f = x.shape[:2]
        y = conv2d_nhwc(self, x.reshape(b * f, *x.shape[2:]))
        return y.reshape(b, f, *y.shape[1:])


# --------------------------------------------------------------- rotary

def inv_freq(rot_dim: int, theta: float = 10000.0, device=None):
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / rot_dim))


def rotary_freqs(positions, rot_dim: int):
    freqs = positions.float()[..., None] * inv_freq(rot_dim,
                                                    device=positions.device)
    return freqs.repeat_interleave(2, dim=-1)


def rotate_half(t):
    pairs = t.unflatten(-1, (-1, 2))
    return torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)


def apply_rotary(t, freqs):
    """Rotate the first rot_dim channels of t (..., n, d)."""
    rot = freqs.shape[-1]
    cos, sin = torch.cos(freqs), torch.sin(freqs)
    head, tail = t[..., :rot], t[..., rot:]
    head = head * cos + rotate_half(head) * sin
    return torch.cat([head, tail], dim=-1)


class RotaryEmbedding(nn.Module):
    """Holds the persistent ``freqs`` buffer of the reference checkpoints."""

    def __init__(self, rot_dim: int):
        super().__init__()
        self.rot_dim = rot_dim
        self.register_buffer("freqs", inv_freq(rot_dim))


# --------------------------------------------------------------- windows

def select_window_size(h: int) -> Optional[int]:
    if h <= 4:
        return None
    return 8 if (h // 8) >= 4 else 4


def window_partition(x, ws: int):
    """(B, F, H, W, C) -> (nW*B, F*ws*ws, C), window-grid-major."""
    b, f, h, w, c = x.shape
    x = x.reshape(b, f, h // ws, ws, w // ws, ws, c)
    return x.permute(2, 4, 0, 1, 3, 5, 6).reshape(-1, f * ws * ws, c)


def window_reverse(windows, ws: int, f: int, h: int, w: int):
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(h // ws, w // ws, b, f, ws, ws, c)
    return x.permute(2, 3, 0, 4, 1, 5, 6).reshape(b, f, h, w, c)


# ------------------------------------------------------------- attention

def attention(q, k, v, scale: float, causal: bool = False):
    """softmax(q k^T scale) v over (..., n, d) x (..., m, d); ``causal`` is
    the reference's tril(m - n) mask.  Computed in chunks of the leading
    axes so that the scores of one chunk stay under ATTN_CHUNK_ELEMS."""
    lead, n, d = q.shape[:-2], q.shape[-2], q.shape[-1]
    m = k.shape[-2]
    q2, k2, v2 = (t.reshape(-1, t.shape[-2], t.shape[-1]) for t in (q, k, v))
    step = max(1, ATTN_CHUNK_ELEMS // (n * m))
    mask = (torch.ones(n, m, dtype=torch.bool, device=q.device).tril(m - n)
            if causal else None)
    outs = []
    for i in range(0, q2.shape[0], step):
        s = torch.matmul(q2[i:i + step], k2[i:i + step].transpose(-1, -2))
        s = s * scale
        if mask is not None:
            s = s.masked_fill(~mask, NEG_INF)
        outs.append(torch.matmul(torch.softmax(s, dim=-1), v2[i:i + step]))
    return torch.cat(outs).reshape(*lead, n, v.shape[-1])


def split_heads(x, heads: int):
    b, n, hd = x.shape
    return x.reshape(b, n, heads, hd // heads).transpose(1, 2)


def merge_heads(x):
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def _out_proj(inner: int, query_dim: int) -> nn.ModuleList:
    return nn.ModuleList([nn.Linear(inner, query_dim), nn.Identity()])


class CrossAttention(nn.Module):
    """Multi-head (cross-)attention; ``temporal`` rotates q / k over the
    sequence (FSText's frame axis)."""

    def __init__(self, query_dim: int, cross_attention_dim: Optional[int] = None,
                 heads: int = 8, dim_head: int = 64, bias: bool = False,
                 temporal: bool = False, causal: bool = False):
        super().__init__()
        inner = heads * dim_head
        ctx_dim = cross_attention_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.temporal, self.causal = temporal, causal
        self.to_q = nn.Linear(query_dim, inner, bias=bias)
        self.to_k = nn.Linear(ctx_dim, inner, bias=bias)
        self.to_v = nn.Linear(ctx_dim, inner, bias=bias)
        self.to_out = _out_proj(inner, query_dim)
        if temporal:
            self.rotary_emb = RotaryEmbedding(min(32, dim_head))

    def forward(self, x, context=None):
        ctx = x if context is None else context
        q = split_heads(self.to_q(x), self.heads)
        k = split_heads(self.to_k(ctx), self.heads)
        v = split_heads(self.to_v(ctx), self.heads)
        if self.temporal:
            freqs = rotary_freqs(torch.arange(q.shape[2], device=x.device),
                                 self.rotary_emb.rot_dim)
            q, k = apply_rotary(q, freqs), apply_rotary(k, freqs)
        out = attention(q, k, v, self.dim_head ** -0.5,
                        causal=self.temporal and self.causal)
        return self.to_out[0](merge_heads(out))


class WindowTemporalAttention(nn.Module):
    """SWAT: windowed causal spatio-temporal self-attention over
    (b, f, h, w, c) with rotary positions of the f-major flattening."""

    def __init__(self, query_dim: int, heads: int = 8, dim_head: int = 64,
                 bias: bool = False, causal: bool = True):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.causal = heads, dim_head, causal
        self.to_q = nn.Linear(query_dim, inner, bias=bias)
        self.to_k = nn.Linear(query_dim, inner, bias=bias)
        self.to_v = nn.Linear(query_dim, inner, bias=bias)
        self.to_out = _out_proj(inner, query_dim)
        self.rotary_emb = RotaryEmbedding(min(32, dim_head))

    def forward(self, x):
        b, f, h, w, c = x.shape
        n, heads, d = f * h * w, self.heads, self.dim_head
        t = x.reshape(b, n, c)
        q, k, v = (split_heads(lin(t), heads)
                   for lin in (self.to_q, self.to_k, self.to_v))
        # positions of the whole flattened video, before windowing
        freqs = rotary_freqs(torch.arange(n, device=x.device),
                             self.rotary_emb.rot_dim)
        q, k = apply_rotary(q, freqs), apply_rotary(k, freqs)
        ws = select_window_size(h)
        scale = d ** -0.5
        bh = b * heads
        if ws is None:
            out = attention(q, k, v, scale, causal=self.causal)
        else:
            grid = lambda t: t.reshape(bh, f, h, w, d)  # noqa: E731
            qw, kw, vw = (window_partition(grid(t), ws) for t in (q, k, v))
            ow = attention(qw, kw, vw, scale, causal=self.causal)
            out = window_reverse(ow, ws, f, h, w)
        out = self.to_out[0](merge_heads(out.reshape(b, heads, n, d)))
        return out.reshape(b, f, h, w, c)


# ------------------------------------------------------------ feed-forward

class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)  # rows [hidden | gate]

    def forward(self, x):
        hidden, gate = self.proj(x).chunk(2, dim=-1)
        return hidden * F.gelu(gate, approximate="none")


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Identity(),
                                  nn.Linear(inner, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


# ----------------------------------------------------------------- resnets

class Upsample3D(nn.Module):
    def __init__(self, channels: int, out_channels: Optional[int] = None):
        super().__init__()
        self.conv = InflatedConv(channels, out_channels or channels, 3, padding=1)

    def forward(self, x):
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return self.conv(x)


class Downsample3D(nn.Module):
    def __init__(self, channels: int, out_channels: Optional[int] = None,
                 padding: int = 1):
        super().__init__()
        self.padding = padding
        self.conv = InflatedConv(channels, out_channels or channels, 3,
                                 stride=2, padding=padding)

    def forward(self, x):
        if self.padding == 0:
            x = F.pad(x, (0, 0, 0, 1, 0, 1))
        return self.conv(x)


class ResnetBlock3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 temb_channels: Optional[int] = 512, groups: int = 32,
                 eps: float = 1e-6):
        super().__init__()
        out_ch = out_channels or in_channels
        self.norm1 = GroupNorm(groups, in_channels, eps)
        self.conv1 = InflatedConv(in_channels, out_ch, 3, padding=1)
        self.time_emb_proj = (nn.Linear(temb_channels, out_ch)
                              if temb_channels else None)
        self.norm2 = GroupNorm(groups, out_ch, eps)
        self.conv2 = InflatedConv(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = (InflatedConv(in_channels, out_ch, 1)
                              if in_channels != out_ch else None)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None, None, :]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


# ------------------------------------------------------ transformer sites

def pab_residual(pab, key: str, kind: str, compute_fn):
    """Pyramid Attention Broadcast: a site's attention delta reused from
    the sampling call's cache when this step's flag says so."""
    flags, cache = pab
    if flags[kind]:
        return cache[key]
    delta = compute_fn()
    cache[key] = delta
    return delta


class BasicTextTransformerBlock3D(nn.Module):
    """Per-frame self-attention + per-frame cross-attention + FF."""

    def __init__(self, dim: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads=n_heads, dim_head=d_head)
        self.attn2 = CrossAttention(dim, context_dim, heads=n_heads,
                                    dim_head=d_head)
        self.ff = FeedForward(dim)
        self.norm1, self.norm2, self.norm3 = (LayerNorm(dim), LayerNorm(dim),
                                              LayerNorm(dim))
        self.site = ""

    def forward(self, x, context=None, pab=None):
        b, f, h, w, c = x.shape
        x = x.reshape(b * f, h * w, c)
        x_self = x
        self_attn = lambda: self.attn1(self.norm1(x_self))  # noqa: E731
        x = (self_attn() if pab is None else
             pab_residual(pab, f"{self.site}.attn1", SPATIAL, self_attn)) + x
        if context is not None:
            ctx = context.reshape(b * f, -1, context.shape[-1])
            x_cross = x
            cross = lambda: self.attn2(self.norm2(x_cross), context=ctx)  # noqa: E731
            x = (cross() if pab is None else
                 pab_residual(pab, f"{self.site}.attn2", CROSS, cross)) + x
        x = self.ff(self.norm3(x)) + x
        return x.reshape(b, f, h, w, c)


class BasicTransformerBlock3D(nn.Module):
    """Temporal block: SWAT attention, then the FF, whose residual skips
    the first ``cond_frame`` frames (training calls with the cond frames,
    sampling with 0)."""

    def __init__(self, dim: int, n_heads: int, d_head: int, causal: bool = True,
                 cond_frame: int = 0):
        super().__init__()
        self.cond_frame = cond_frame
        self.attn1 = WindowTemporalAttention(dim, heads=n_heads,
                                             dim_head=d_head, causal=causal)
        self.ff = FeedForward(dim)
        self.norm1, self.norm3 = LayerNorm(dim), LayerNorm(dim)
        self.site = ""

    def forward(self, x, cond_frame: int = 0, pab=None):
        b, f, h, w, c = x.shape
        delta = lambda: self.attn1(self.norm1(x)).reshape(b, f * h * w, c)  # noqa: E731
        d = (delta() if pab is None else
             pab_residual(pab, f"{self.site}.attn1", TEMPORAL, delta))
        x = d + x.reshape(b, f * h * w, c)
        cf = cond_frame * h * w
        tail = x[:, cf:]
        x = torch.cat([x[:, :cf], self.ff(self.norm3(tail)) + tail], dim=1)
        return x.reshape(b, f, h, w, c)


class SpatialTransformer3D(nn.Module):
    """GroupNorm -> 1x1 proj_in -> block -> 1x1 proj_out + residual."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None, temporal: bool = False,
                 text_frame_condition: bool = False, causal: bool = False,
                 cond_frame: int = 0, norm_num_groups: int = 32):
        super().__init__()
        inner = n_heads * d_head
        self.text_frame_condition = text_frame_condition
        self.norm = GroupNorm(norm_num_groups, in_channels, eps=1e-6)
        self.proj_in = InflatedConv(in_channels, inner, 1)
        if text_frame_condition:
            block = BasicTextTransformerBlock3D(inner, n_heads, d_head,
                                                context_dim)
        else:
            block = BasicTransformerBlock3D(inner, n_heads, d_head, causal,
                                            cond_frame)
        self.transformer_blocks = nn.ModuleList([block])
        self.proj_out = InflatedConv(inner, in_channels, 1)

    def forward(self, x, context=None, cond_frame: int = 0, pab=None):
        x_in = x
        x = self.proj_in(self.norm(x))
        block = self.transformer_blocks[0]
        if self.text_frame_condition:
            x = block(x, context=context, pab=pab)
        else:
            x = block(x, cond_frame=cond_frame, pab=pab)
        return self.proj_out(x) + x_in


# ------------------------------------------------------------ time embedding

def timestep_embedding(timesteps, dim: int, flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       max_period: float = 10000.0):
    """(b,) -> (b, dim) sinusoidal embedding, the frequency table in fp64
    rounded to fp32."""
    half = dim // 2
    exponent = -math.log(max_period) * np.arange(half, dtype=np.float64)
    exponent = exponent / (half - downscale_freq_shift)
    freqs = torch.from_numpy(np.exp(exponent).astype(np.float32)).to(
        timesteps.device)
    emb = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, sample):
        return self.linear_2(F.silu(self.linear_1(sample)))
