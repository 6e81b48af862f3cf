"""Plain fp32 SeerUNet: SD-1.5's UNet inflated to video, a text site
(per-frame self + cross attention) and a temporal site (SWAT) after every
resnet of the attention levels.  A frozen copy of the port's
``models/unet3d.py`` and ``models/unet_blocks.py`` without remat, meshes,
ToMe, FreeU or attention maps; parameter names are the port's."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (Downsample3D, GroupNorm, InflatedConv, ResnetBlock3D,
                     SpatialTransformer3D, TimestepEmbedding, Upsample3D,
                     timestep_embedding)


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    cross_attention_dim: int = 768
    attention_head_dim: int = 8  # the head COUNT, as SD-1.5 uses the key


def _site_pair(ch, heads, cross_dim, groups):
    text = SpatialTransformer3D(ch, heads, ch // heads, context_dim=cross_dim,
                                text_frame_condition=True,
                                norm_num_groups=groups)
    temporal = SpatialTransformer3D(ch, heads, ch // heads, temporal=True,
                                    causal=True, norm_num_groups=groups)
    return text, temporal


class CrossAttnDownBlock3D(nn.Module):
    def __init__(self, cin, cout, temb, layers, groups, eps, heads, cross_dim,
                 add_downsample=True):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()
        self.temporal_attentions = nn.ModuleList()
        for i in range(layers):
            self.resnets.append(ResnetBlock3D(cin if i == 0 else cout, cout,
                                              temb, groups, eps))
            text, temporal = _site_pair(cout, heads, cross_dim, groups)
            self.attentions.append(text)
            self.temporal_attentions.append(temporal)
        self.downsamplers = nn.ModuleList(
            [Downsample3D(cout, cout, 1)] if add_downsample else [])

    def forward(self, x, temb, ctx, cond_frame, pab):
        states = ()
        for resnet, text, temporal in zip(self.resnets, self.attentions,
                                          self.temporal_attentions):
            x = resnet(x, temb)
            x = text(x, context=ctx, pab=pab)
            x = temporal(x, cond_frame=cond_frame, pab=pab)
            states += (x,)
        for down in self.downsamplers:
            x = down(x)
            states += (x,)
        return x, states


class DownBlock3D(nn.Module):
    def __init__(self, cin, cout, temb, layers, groups, eps):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock3D(cin if i == 0 else cout, cout, temb, groups, eps)
            for i in range(layers)])
        self.downsamplers = nn.ModuleList([])

    def forward(self, x, temb):
        states = ()
        for resnet in self.resnets:
            x = resnet(x, temb)
            states += (x,)
        return x, states


class UNetMidBlock3DCrossAttn(nn.Module):
    def __init__(self, ch, temb, groups, eps, heads, cross_dim):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock3D(ch, ch, temb, groups, eps)
                                      for _ in range(2)])
        text, temporal = _site_pair(ch, heads, cross_dim, groups)
        self.attentions = nn.ModuleList([text])
        self.temporal_attentions = nn.ModuleList([temporal])

    def forward(self, x, temb, ctx, cond_frame, pab):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, context=ctx, pab=pab)
        x = self.temporal_attentions[0](x, cond_frame=cond_frame, pab=pab)
        return self.resnets[1](x, temb)


class CrossAttnUpBlock3D(nn.Module):
    def __init__(self, cin, cout, prev, temb, layers, groups, eps, heads,
                 cross_dim, add_upsample):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()
        self.temporal_attentions = nn.ModuleList()
        for i in range(layers):
            skip = cin if i == layers - 1 else cout
            res_in = prev if i == 0 else cout
            self.resnets.append(ResnetBlock3D(res_in + skip, cout, temb,
                                              groups, eps))
            text, temporal = _site_pair(cout, heads, cross_dim, groups)
            self.attentions.append(text)
            self.temporal_attentions.append(temporal)
        self.upsamplers = nn.ModuleList(
            [Upsample3D(cout, cout)] if add_upsample else [])

    def forward(self, x, res_states, temb, ctx, cond_frame, pab):
        for resnet, text, temporal in zip(self.resnets, self.attentions,
                                          self.temporal_attentions):
            x = torch.cat([x, res_states[-1]], dim=-1)
            res_states = res_states[:-1]
            x = resnet(x, temb)
            x = text(x, context=ctx, pab=pab)
            x = temporal(x, cond_frame=cond_frame, pab=pab)
        for up in self.upsamplers:
            x = up(x)
        return x


class UpBlock3D(nn.Module):
    def __init__(self, cin, prev, cout, temb, layers, groups, eps,
                 add_upsample):
        super().__init__()
        self.resnets = nn.ModuleList()
        for i in range(layers):
            skip = cin if i == layers - 1 else cout
            res_in = prev if i == 0 else cout
            self.resnets.append(ResnetBlock3D(res_in + skip, cout, temb,
                                              groups, eps))
        self.upsamplers = nn.ModuleList(
            [Upsample3D(cout, cout)] if add_upsample else [])

    def forward(self, x, res_states, temb):
        for resnet in self.resnets:
            x = torch.cat([x, res_states[-1]], dim=-1)
            res_states = res_states[:-1]
            x = resnet(x, temb)
        for up in self.upsamplers:
            x = up(x)
        return x


class SeerUNet(nn.Module):
    def __init__(self, config: UNetConfig = UNetConfig()):
        super().__init__()
        cfg = self.config = config
        boc = tuple(cfg.block_out_channels)
        temb, n = boc[0] * 4, len(boc)
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        heads, cross = cfg.attention_head_dim, cfg.cross_attention_dim
        L = cfg.layers_per_block
        self.conv_in = InflatedConv(cfg.in_channels, boc[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(boc[0], temb)
        self.down_blocks = nn.ModuleList()
        out_ch = boc[0]
        for i in range(n):
            in_ch, out_ch = out_ch, boc[i]
            if i < n - 1:
                self.down_blocks.append(CrossAttnDownBlock3D(
                    in_ch, out_ch, temb, L, g, eps, heads, cross))
            else:
                self.down_blocks.append(DownBlock3D(in_ch, out_ch, temb, L,
                                                    g, eps))
        self.mid_block = UNetMidBlock3DCrossAttn(boc[-1], temb, g, eps, heads,
                                                 cross)
        self.up_blocks = nn.ModuleList()
        rev = list(reversed(boc))
        out_ch = rev[0]
        for i in range(n):
            prev, out_ch = out_ch, rev[i]
            in_ch = rev[min(i + 1, n - 1)]
            if i == 0:
                self.up_blocks.append(UpBlock3D(in_ch, prev, out_ch, temb,
                                                L + 1, g, eps, i < n - 1))
            else:
                self.up_blocks.append(CrossAttnUpBlock3D(
                    in_ch, out_ch, prev, temb, L + 1, g, eps, heads, cross,
                    i < n - 1))
        self.conv_norm_out = GroupNorm(g, boc[0], eps)
        self.conv_out = InflatedConv(boc[0], cfg.out_channels, 3, padding=1)
        for name, m in self.named_modules():
            if hasattr(m, "site"):
                m.site = name

    def forward(self, sample, timesteps, context, cond_frame: int = 0,
                pab=None):
        """sample (b, f, h, w, 4); timesteps (b,); context (b, f, l, d);
        ``pab`` = (this step's flags, the sampling call's cache)."""
        t_emb = timestep_embedding(timesteps, self.config.block_out_channels[0])
        emb = self.time_embedding(t_emb.to(sample.dtype))
        sample = self.conv_in(sample)
        res_states = (sample,)
        for block in self.down_blocks:
            if isinstance(block, CrossAttnDownBlock3D):
                sample, states = block(sample, emb, context, cond_frame, pab)
            else:
                sample, states = block(sample, emb)
            res_states += states
        sample = self.mid_block(sample, emb, context, cond_frame, pab)
        for block in self.up_blocks:
            k = len(block.resnets)
            states, res_states = res_states[-k:], res_states[:-k]
            if isinstance(block, CrossAttnUpBlock3D):
                sample = block(sample, states, emb, context, cond_frame, pab)
            else:
                sample = block(sample, states, emb)
        return self.conv_out(F.silu(self.conv_norm_out(sample)))
