"""Plain fp32 SD-1.5 VAE (AutoencoderKL), channels-last: a frozen copy of
the port's ``models/vae.py``; parameter names are the port's (diffusers')."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv, GroupNorm

VAE_SCALE = 0.18215


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Sequence[int] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32


class ResnetBlock2D(nn.Module):
    def __init__(self, cin, cout, groups=32, eps=1e-6):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, eps)
        self.conv1 = Conv(cin, cout, 3, padding=1)
        self.norm2 = GroupNorm(groups, cout, eps)
        self.conv2 = Conv(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttentionBlock2D(nn.Module):
    """Single-head spatial self-attention."""

    def __init__(self, channels, groups=32):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, 1e-6)
        self.query = nn.Linear(channels, channels)
        self.key = nn.Linear(channels, channels)
        self.value = nn.Linear(channels, channels)
        self.proj_attn = nn.Linear(channels, channels)

    def forward(self, x):
        b, h, w, c = x.shape
        t = self.group_norm(x).reshape(b, h * w, c)
        q, k, v = self.query(t), self.key(t), self.value(t)
        scale = c ** -0.25
        probs = torch.softmax(torch.matmul(q * scale, (k * scale).transpose(-1, -2)),
                              dim=-1)
        out = self.proj_attn(torch.matmul(probs, v))
        return out.reshape(b, h, w, c) + x


class _Sampler(nn.Module):
    def __init__(self, channels, stride, padding):
        super().__init__()
        self.conv = Conv(channels, channels, 3, stride=stride, padding=padding)


class _Block(nn.Module):
    def __init__(self, cin, cout, layers, groups, sampler):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(cin if j == 0 else cout,
                                                    cout, groups)
                                      for j in range(layers)])
        if sampler == "down":
            self.downsamplers = nn.ModuleList([_Sampler(cout, 2, 0)])
        elif sampler == "up":
            self.upsamplers = nn.ModuleList([_Sampler(cout, 1, 1)])
        self.sampler = sampler

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if self.sampler == "down":
            x = self.downsamplers[0].conv(F.pad(x, (0, 0, 0, 1, 0, 1)))
        elif self.sampler == "up":
            x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            x = self.upsamplers[0].conv(x)
        return x


class _MidBlock(nn.Module):
    def __init__(self, ch, groups):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(ch, ch, groups)
                                      for _ in range(2)])
        self.attentions = nn.ModuleList([AttentionBlock2D(ch, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        boc, g = tuple(cfg.block_out_channels), cfg.norm_num_groups
        self.conv_in = Conv(cfg.in_channels, boc[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        out_ch = boc[0]
        for i, ch in enumerate(boc):
            in_ch, out_ch = out_ch, ch
            self.down_blocks.append(_Block(in_ch, out_ch, cfg.layers_per_block,
                                           g, "down" if i != len(boc) - 1
                                           else None))
        self.mid_block = _MidBlock(out_ch, g)
        self.conv_norm_out = GroupNorm(g, out_ch, 1e-6)
        self.conv_out = Conv(out_ch, 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        boc, g = tuple(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        self.conv_in = Conv(cfg.latent_channels, boc[0], 3, padding=1)
        self.mid_block = _MidBlock(boc[0], g)
        self.up_blocks = nn.ModuleList()
        out_ch = boc[0]
        for i, ch in enumerate(boc):
            in_ch, out_ch = out_ch, ch
            self.up_blocks.append(_Block(in_ch, out_ch,
                                         cfg.layers_per_block + 1, g,
                                         "up" if i != len(boc) - 1 else None))
        self.conv_norm_out = GroupNorm(g, out_ch, 1e-6)
        self.conv_out = Conv(out_ch, cfg.out_channels, 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = Conv(2 * config.latent_channels,
                               2 * config.latent_channels, 1)
        self.post_quant_conv = Conv(config.latent_channels,
                                    config.latent_channels, 1)

    def encode(self, x, noise):
        """(b, h, w, 3) -> posterior draw mean + std * noise."""
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=-1)
        return mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))
