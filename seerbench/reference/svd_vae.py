"""Plain fp32 reference of Stable Video Diffusion's autoencoder (diffusers
``AutoencoderKLTemporalDecoder``), channels first as diffusers lays it
out: SD's encoder and ``quant_conv`` (the posterior mean is taken and not
scaled), and the temporal decoder (no ``post_quant_conv``; every frame of
a clip in one call; ``SpatioTemporalResBlock`` with "learned" blends and
the switch, spatial GroupNorm epsilon 1e-6, temporal 1e-5; a final
``time_conv_out`` Conv3d (3, 1, 1)).  Names are diffusers' (the mid
attentions' ``to_q`` / ``to_k`` / ``to_v`` / ``to_out.0``).  The mid
attentions run in chunks of frames (``layers.attention``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import attention
from .svd_unet import ResnetBlock2D, SpatioTemporalResBlock

# the temporal decoder's GroupNorm epsilons (``assumed.group_norm_eps``)
SPATIAL_EPS, TEMPORAL_EPS = 1e-6, 1e-5


@dataclass(frozen=True)
class SVDVAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Sequence[int] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32


class VAEAttention(nn.Module):
    """Single-head self-attention over a frame's h w tokens, GroupNorm
    first, biased projections, residual."""

    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, ch, 1e-6)
        self.to_q, self.to_k = nn.Linear(ch, ch), nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch), nn.Identity()])

    def forward(self, x):
        n, c, h, w = x.shape
        t = self.group_norm(x).reshape(n, c, h * w).transpose(1, 2)
        out = attention(self.to_q(t)[:, None], self.to_k(t)[:, None],
                        self.to_v(t)[:, None], c ** -0.5)[:, 0]
        return self.to_out[0](out).transpose(1, 2).reshape(n, c, h, w) + x


class Sampler(nn.Module):
    def __init__(self, ch: int, stride: int, padding: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=stride, padding=padding)


class DownEncoderBlock(nn.Module):
    def __init__(self, cin, cout, layers, groups, down):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(cin if j == 0 else cout,
                                                    cout, None, 1e-6, groups)
                                      for j in range(layers)])
        self.downsamplers = nn.ModuleList([Sampler(cout, 2, 0)]) if down else None

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0].conv(F.pad(x, (0, 1, 0, 1)))
        return x


class EncoderMid(nn.Module):
    def __init__(self, ch, groups):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(ch, ch, None, 1e-6, groups)
                                      for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(ch, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class Encoder(nn.Module):
    def __init__(self, cfg: SVDVAEConfig):
        super().__init__()
        boc, g = tuple(cfg.block_out_channels), cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, boc[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        out = boc[0]
        for i, ch in enumerate(boc):
            cin, out = out, ch
            self.down_blocks.append(DownEncoderBlock(
                cin, out, cfg.layers_per_block, g, i != len(boc) - 1))
        self.mid_block = EncoderMid(out, g)
        self.conv_norm_out = nn.GroupNorm(g, out, 1e-6)
        self.conv_out = nn.Conv2d(out, 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


def _resnet(cin, cout, groups):
    return SpatioTemporalResBlock(cin, cout, None, SPATIAL_EPS, TEMPORAL_EPS,
                                  groups, 0.0)


class DecoderMid(nn.Module):
    def __init__(self, ch, layers, groups):
        super().__init__()
        self.resnets = nn.ModuleList([_resnet(ch, ch, groups)
                                      for _ in range(layers)])
        self.attentions = nn.ModuleList([VAEAttention(ch, groups)])

    def forward(self, x, frames):
        x = self.resnets[0](x, None, frames)
        x = self.attentions[0](x)
        for r in self.resnets[1:]:
            x = r(x, None, frames)
        return x


class DecoderUp(nn.Module):
    def __init__(self, cin, cout, layers, groups, up):
        super().__init__()
        self.resnets = nn.ModuleList([_resnet(cin if j == 0 else cout, cout,
                                              groups) for j in range(layers)])
        self.upsamplers = nn.ModuleList([Sampler(cout, 1, 1)]) if up else None

    def forward(self, x, frames):
        for r in self.resnets:
            x = r(x, None, frames)
        if self.upsamplers is not None:
            x = self.upsamplers[0].conv(
                F.interpolate(x, scale_factor=2.0, mode="nearest"))
        return x


class TemporalDecoder(nn.Module):
    def __init__(self, cfg: SVDVAEConfig):
        super().__init__()
        boc, g = tuple(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.latent_channels, boc[0], 3, padding=1)
        self.mid_block = DecoderMid(boc[0], cfg.layers_per_block, g)
        self.up_blocks = nn.ModuleList()
        out = boc[0]
        for i, ch in enumerate(boc):
            cin, out = out, ch
            self.up_blocks.append(DecoderUp(cin, out, cfg.layers_per_block + 1,
                                            g, i != len(boc) - 1))
        self.conv_norm_out = nn.GroupNorm(g, out, 1e-6)
        self.conv_out = nn.Conv2d(out, cfg.out_channels, 3, padding=1)
        self.time_conv_out = nn.Conv3d(cfg.out_channels, cfg.out_channels,
                                       (3, 1, 1), padding=(1, 0, 0))

    def forward(self, z, frames: int):
        """z (b f, 4, h, w) -> (b f, 3, 8 h, 8 w)."""
        x = self.mid_block(self.conv_in(z), frames)
        for block in self.up_blocks:
            x = block(x, frames)
        x = self.conv_out(F.silu(self.conv_norm_out(x), inplace=True))
        bf, c, h, w = x.shape
        x = x.reshape(bf // frames, frames, c, h, w).permute(0, 2, 1, 3, 4)
        x = self.time_conv_out(x)
        return x.permute(0, 2, 1, 3, 4).reshape(bf, c, h, w)


class AutoencoderKLTemporalDecoder(nn.Module):
    def __init__(self, cfg: SVDVAEConfig = SVDVAEConfig()):
        super().__init__()
        self.encoder = Encoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels,
                                    2 * cfg.latent_channels, 1)
        self.decoder = TemporalDecoder(cfg)

    def encode_mean(self, x):
        """(n, 3, h, w) -> the posterior mean (n, 4, h/8, w/8)."""
        return self.quant_conv(self.encoder(x)).chunk(2, dim=1)[0]
