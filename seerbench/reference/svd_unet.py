"""Plain fp32 reference of Stable Video Diffusion's spatio-temporal UNet
(diffusers ``UNetSpatioTemporalConditionModel``; Blattmann et al., arXiv
2311.15127; sgm ``video_attention.py`` / ``video_model.py``), written from
the published description in diffusers' layout: frames folded into the
batch, channels first ``(b f, c, h, w)``; the temporal layers see
``(b, c, f, h, w)``.  Module names are diffusers', so the released state
dict (and the benchmark's seeded one) loads strictly.  Every op is a plain
``torch.nn`` layer computed in the dtype of its inputs (fp32 here);
attention is computed in chunks of rows (``layers.attention``), so that
the 9216-token self-attention of the 576 x 1024 latents fits.

Choices the description leaves open, taken as the configuration file
says (``assumed``): the GroupNorm epsilon of each block kind (diffusers'
block classes fix them: 1e-6 in the cross-attention down and every up
block, 1e-5 in the plain down block, the mid block and ``conv_norm_out``,
1e-6 in each transformer site's ``norm``).  The image-only indicator is
all zero when sampling video, so every "learned_with_images" blend reads
``sigmoid(mix_factor)``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import attention, timestep_embedding


@dataclass(frozen=True)
class SVDUNetConfig:
    in_channels: int = 8
    out_channels: int = 4
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    num_attention_heads: Sequence[int] = (5, 10, 20, 20)
    cross_attention_dim: int = 1024
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 768
    norm_num_groups: int = 32


# GroupNorm epsilons per block kind (``assumed.group_norm_eps`` in the
# configuration file)
DOWN_EPS = 1e-5
CROSS_DOWN_EPS = 1e-6
MID_EPS = 1e-5
UP_EPS = 1e-6
CROSS_UP_EPS = 1e-6
TRANSFORMER_EPS = 1e-6
OUT_EPS = 1e-5


class TimestepEmbedding(nn.Module):
    def __init__(self, cin: int, hidden: int, out: Optional[int] = None):
        super().__init__()
        self.linear_1 = nn.Linear(cin, hidden)
        self.linear_2 = nn.Linear(hidden, out or hidden)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, temb: Optional[int], eps: float,
                 groups: int = 32):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb, cout) if temb else None
        self.norm2 = nn.GroupNorm(groups, cout, eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x), inplace=True))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h), inplace=True))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class TemporalResnetBlock(nn.Module):
    """(b, c, f, h, w): GroupNorm over (c / g, f, h, w) per clip, Conv3d
    (3, 1, 1) with padding (1, 0, 0)."""

    def __init__(self, ch: int, temb: Optional[int], eps: float,
                 groups: int = 32):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, ch, eps)
        self.conv1 = nn.Conv3d(ch, ch, (3, 1, 1), padding=(1, 0, 0))
        self.time_emb_proj = nn.Linear(temb, ch) if temb else None
        self.norm2 = nn.GroupNorm(groups, ch, eps)
        self.conv2 = nn.Conv3d(ch, ch, (3, 1, 1), padding=(1, 0, 0))

    def forward(self, x, temb=None):
        """temb (b, f, d), or None."""
        h = self.conv1(F.silu(self.norm1(x), inplace=True))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb)).permute(0, 2, 1)[
                :, :, :, None, None]
        h = self.conv2(F.silu(self.norm2(h), inplace=True))
        return x + h


class AlphaBlender(nn.Module):
    def __init__(self, alpha: float, switch: bool):
        super().__init__()
        self.switch = switch
        self.mix_factor = nn.Parameter(torch.tensor([alpha]))

    def forward(self, x_spatial, x_temporal):
        a = torch.sigmoid(self.mix_factor)
        if self.switch:
            a = 1.0 - a
        return a * x_spatial + (1.0 - a) * x_temporal


class SpatioTemporalResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, temb: Optional[int], eps: float,
                 temporal_eps: Optional[float] = None, groups: int = 32,
                 alpha: float = 0.5):
        super().__init__()
        self.spatial_res_block = ResnetBlock2D(cin, cout, temb, eps, groups)
        self.temporal_res_block = TemporalResnetBlock(
            cout, temb, eps if temporal_eps is None else temporal_eps, groups)
        self.time_mixer = AlphaBlender(alpha, switch=True)

    def forward(self, x, temb, frames: int):
        """x (b f, c, h, w); temb (b f, d) or None."""
        hs = self.spatial_res_block(x, temb)
        bf, c, h, w = hs.shape
        hs = hs.reshape(bf // frames, frames, c, h, w).permute(0, 2, 1, 3, 4)
        t = None if temb is None else temb.reshape(bf // frames, frames, -1)
        out = self.time_mixer(hs, self.temporal_res_block(hs, t))
        return out.permute(0, 2, 1, 3, 4).reshape(bf, c, h, w)


class Attention(nn.Module):
    def __init__(self, dim: int, ctx_dim: Optional[int], heads: int,
                 d_head: int, bias: bool = False):
        super().__init__()
        inner = heads * d_head
        self.heads, self.d_head = heads, d_head
        self.to_q = nn.Linear(dim, inner, bias=bias)
        self.to_k = nn.Linear(ctx_dim or dim, inner, bias=bias)
        self.to_v = nn.Linear(ctx_dim or dim, inner, bias=bias)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim), nn.Identity()])

    def forward(self, x, context=None):
        ctx = x if context is None else context
        split = lambda t: t.reshape(t.shape[0], t.shape[1], self.heads,  # noqa: E731
                                    self.d_head).transpose(1, 2)
        out = attention(split(self.to_q(x)), split(self.to_k(ctx)),
                        split(self.to_v(ctx)), self.d_head ** -0.5)
        b, h, n, d = out.shape
        return self.to_out[0](out.transpose(1, 2).reshape(b, n, h * d))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        hidden, gate = self.proj(x).chunk(2, dim=-1)
        return hidden * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, d_head: int, ctx_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, None, heads, d_head)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, ctx_dim, heads, d_head)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class TemporalBasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, d_head: int, ctx_dim: int):
        super().__init__()
        self.norm_in = nn.LayerNorm(dim)
        self.ff_in = FeedForward(dim)
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, None, heads, d_head)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, ctx_dim, heads, d_head)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, frames: int, context):
        """x (b f, s, c) -> per spatial position over the frames;
        context (b s, l, d)."""
        bf, s, c = x.shape
        b = bf // frames
        z = x.reshape(b, frames, s, c).permute(0, 2, 1, 3).reshape(b * s, frames, c)
        z = self.ff_in(self.norm_in(z)) + z
        z = self.attn1(self.norm1(z)) + z
        z = self.attn2(self.norm2(z), context) + z
        z = self.ff(self.norm3(z)) + z
        return z.reshape(b, s, frames, c).permute(0, 2, 1, 3).reshape(bf, s, c)


class TransformerSpatioTemporalModel(nn.Module):
    def __init__(self, heads: int, d_head: int, cin: int, ctx_dim: int,
                 groups: int):
        super().__init__()
        inner = heads * d_head
        self.norm = nn.GroupNorm(groups, cin, TRANSFORMER_EPS)
        self.proj_in = nn.Linear(cin, inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, d_head, ctx_dim)])
        self.temporal_transformer_blocks = nn.ModuleList(
            [TemporalBasicTransformerBlock(inner, heads, d_head, ctx_dim)])
        self.time_pos_embed = TimestepEmbedding(cin, cin * 4, cin)
        self.time_mixer = AlphaBlender(0.5, switch=False)
        self.proj_out = nn.Linear(inner, cin)

    def forward(self, x, context, frames: int):
        """x (b f, c, h, w); context (b f, l, d), each clip's tokens
        repeated over its frames."""
        bf, c, h, w = x.shape
        b = bf // frames
        # the temporal block's context: each clip's first-frame tokens,
        # repeated over its spatial positions (sgm's "b ... -> (b n) ...")
        first = context.reshape(b, frames, *context.shape[1:])[:, 0]
        time_ctx = first[:, None].expand(b, h * w, *first.shape[1:]).reshape(
            b * h * w, *first.shape[1:])
        hs = self.norm(x).permute(0, 2, 3, 1).reshape(bf, h * w, c)
        hs = self.proj_in(hs)
        pos = torch.arange(frames, device=x.device).repeat(b)
        emb = self.time_pos_embed(timestep_embedding(pos, c))[:, None]
        hs = self.transformer_blocks[0](hs, context)
        ht = self.temporal_transformer_blocks[0](hs + emb, frames, time_ctx)
        hs = self.proj_out(self.time_mixer(hs, ht))
        return hs.reshape(bf, h, w, c).permute(0, 3, 1, 2) + x


class Downsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class DownBlock(nn.Module):
    def __init__(self, cin, cout, temb, layers, heads, ctx_dim, down, groups):
        super().__init__()
        eps = CROSS_DOWN_EPS if heads else DOWN_EPS
        self.resnets = nn.ModuleList([
            SpatioTemporalResBlock(cin if j == 0 else cout, cout, temb, eps,
                                   groups=groups) for j in range(layers)])
        self.attentions = nn.ModuleList([
            TransformerSpatioTemporalModel(heads, cout // heads, cout, ctx_dim,
                                           groups)
            for _ in range(layers)]) if heads else None
        self.downsamplers = nn.ModuleList([Downsample2D(cout)]) if down else None

    def forward(self, x, temb, context, frames):
        states = ()
        for j, resnet in enumerate(self.resnets):
            x = resnet(x, temb, frames)
            if self.attentions is not None:
                x = self.attentions[j](x, context, frames)
            states += (x,)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            states += (x,)
        return x, states


class UpBlock(nn.Module):
    def __init__(self, cin, prev, cout, temb, layers, heads, ctx_dim, up,
                 groups):
        super().__init__()
        eps = CROSS_UP_EPS if heads else UP_EPS
        self.resnets = nn.ModuleList([
            SpatioTemporalResBlock((prev if j == 0 else cout)
                                   + (cin if j == layers - 1 else cout),
                                   cout, temb, eps, groups=groups)
            for j in range(layers)])
        self.attentions = nn.ModuleList([
            TransformerSpatioTemporalModel(heads, cout // heads, cout, ctx_dim,
                                           groups)
            for _ in range(layers)]) if heads else None
        self.upsamplers = nn.ModuleList([Upsample2D(cout)]) if up else None

    def forward(self, x, states, temb, context, frames):
        for j, resnet in enumerate(self.resnets):
            x = torch.cat([x, states[-1]], dim=1)
            states = states[:-1]
            x = resnet(x, temb, frames)
            if self.attentions is not None:
                x = self.attentions[j](x, context, frames)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class MidBlock(nn.Module):
    def __init__(self, ch, temb, heads, ctx_dim, groups):
        super().__init__()
        self.resnets = nn.ModuleList([
            SpatioTemporalResBlock(ch, ch, temb, MID_EPS, groups=groups)
            for _ in range(2)])
        self.attentions = nn.ModuleList([
            TransformerSpatioTemporalModel(heads, ch // heads, ch, ctx_dim,
                                           groups)])

    def forward(self, x, temb, context, frames):
        x = self.resnets[0](x, temb, frames)
        x = self.attentions[0](x, context, frames)
        return self.resnets[1](x, temb, frames)


class UNetSpatioTemporalConditionModel(nn.Module):
    def __init__(self, cfg: SVDUNetConfig = SVDUNetConfig()):
        super().__init__()
        self.cfg = cfg
        boc, heads = tuple(cfg.block_out_channels), tuple(cfg.num_attention_heads)
        g, ctx, L = cfg.norm_num_groups, cfg.cross_attention_dim, cfg.layers_per_block
        temb = boc[0] * 4
        self.conv_in = nn.Conv2d(cfg.in_channels, boc[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(boc[0], temb)
        self.add_embedding = TimestepEmbedding(
            cfg.projection_class_embeddings_input_dim, temb)
        self.down_blocks = nn.ModuleList()
        out = boc[0]
        for i, ch in enumerate(boc):
            cin, out = out, ch
            last = i == len(boc) - 1
            self.down_blocks.append(DownBlock(
                cin, out, temb, L, None if last else heads[i], ctx, not last,
                g))
        self.mid_block = MidBlock(boc[-1], temb, heads[-1], ctx, g)
        rev, rheads = boc[::-1], heads[::-1]
        self.up_blocks = nn.ModuleList()
        out = rev[0]
        for i in range(len(rev)):
            prev, out = out, rev[i]
            self.up_blocks.append(UpBlock(
                rev[min(i + 1, len(rev) - 1)], prev, out, temb, L + 1,
                None if i == 0 else rheads[i], ctx, i != len(rev) - 1, g))
        self.conv_norm_out = nn.GroupNorm(g, boc[0], OUT_EPS)
        self.conv_out = nn.Conv2d(boc[0], cfg.out_channels, 3, padding=1)

    def forward(self, sample, timestep: float, context, added_time_ids):
        """sample (b, f, c, h, w); context (b, l, d); added_time_ids (b, 3).
        Returns (b, f, out_channels, h, w)."""
        b, frames = sample.shape[:2]
        t = torch.full((b,), float(timestep), device=sample.device)
        emb = self.time_embedding(timestep_embedding(
            t, self.cfg.block_out_channels[0]))
        ids = timestep_embedding(added_time_ids.reshape(-1),
                                 self.cfg.addition_time_embed_dim)
        emb = emb + self.add_embedding(ids.reshape(b, -1))
        emb = emb.repeat_interleave(frames, dim=0)
        context = context.repeat_interleave(frames, dim=0)
        x = self.conv_in(sample.flatten(0, 1))
        states = (x,)
        for block in self.down_blocks:
            x, res = block(x, emb, context, frames)
            states += res
        x = self.mid_block(x, emb, context, frames)
        for block in self.up_blocks:
            n = len(block.resnets)
            x = block(x, states[-n:], emb, context, frames)
            states = states[:-n]
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.reshape(b, frames, *x.shape[1:])
