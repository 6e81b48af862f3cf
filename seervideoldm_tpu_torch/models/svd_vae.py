"""Stable Video Diffusion's autoencoder (diffusers
``AutoencoderKLTemporalDecoder``): SD's encoder and ``quant_conv``
(``models/vae.py``), and a temporal decoder.

- ``encode``: the posterior mean (SVD conditions on ``mode()``, and does
  not scale it by 0.18215); images ``(n, h, w, 3)``.
- ``decode``: latents ``(b, f, h/8, w/8, 4)`` -> ``(b, f, h, w, 3)``, all
  frames of a clip in one call (there is no ``post_quant_conv``):
  ``conv_in`` 4 -> 512; a mid block (``SpatioTemporalResBlock``, the
  single-head attention of ``models/vae.py``, ``SpatioTemporalResBlock``);
  four up blocks of three ``SpatioTemporalResBlock`` (512, 512, 256, 128),
  each but the last ending in nearest 2x + conv; per-frame GroupNorm ->
  SiLU -> ``conv_out`` -> ``time_conv_out``, a (3, 1, 1) conv mixing
  neighbouring frames.  The resnet blends are "learned" with the switch
  (``(1 - s) hs + s ht``); spatial GroupNorm epsilon 1e-6, temporal 1e-5.

The mid attention is single-head at d = 512 over h w tokens a frame
(9216 at 576 x 1024), above K2's head dim: it runs the plain VAE
attention one frame at a time, so that one frame's fp32 logits are
alive at once (25 frames' would be ~8.5 GB).  Names are diffusers' except
the two mid attentions, which keep the classic ``query`` / ``key`` /
``value`` / ``proj_attn`` of ``models/vae.py``; ``io/pretrained.py``
maps the released names onto them.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.conv import InflatedConv, TemporalConv
from ..ops.norms import frame_group_norm
from .resnet3d import Upsample3D
from .svd_unet import SpatioTemporalResBlock
from .vae import AttentionBlock2D, Conv, Encoder, GroupNorm, VAEConfig

SPATIAL_EPS, TEMPORAL_EPS = 1e-6, 1e-5


def _resnet(cin: int, cout: int, groups: int) -> SpatioTemporalResBlock:
    return SpatioTemporalResBlock(cin, cout, None, SPATIAL_EPS, TEMPORAL_EPS,
                                  groups, alpha=0.0)


class MidBlockTemporalDecoder(nn.Module):
    def __init__(self, ch: int, layers: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([_resnet(ch, ch, groups)
                                      for _ in range(layers)])
        self.attentions = nn.ModuleList([AttentionBlock2D(ch, groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        attn = self.attentions[0]
        b, f = x.shape[:2]
        frames = x.reshape(b * f, *x.shape[2:])
        x = torch.cat([attn(frames[i:i + 1]) for i in range(b * f)])
        x = x.reshape(b, f, *x.shape[1:])
        for resnet in self.resnets[1:]:
            x = resnet(x)
        return x


class UpBlockTemporalDecoder(nn.Module):
    def __init__(self, cin: int, cout: int, layers: int, groups: int,
                 upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList([_resnet(cin if j == 0 else cout, cout,
                                              groups) for j in range(layers)])
        if upsample:
            self.upsamplers = nn.ModuleList([Upsample3D(cout, cout)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


class TemporalDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        boc, g = tuple(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        self.conv_in = InflatedConv(cfg.latent_channels, boc[0], 3, padding=1)
        self.mid_block = MidBlockTemporalDecoder(boc[0], cfg.layers_per_block, g)
        self.up_blocks = nn.ModuleList()
        out_ch = boc[0]
        for i, ch in enumerate(boc):
            in_ch, out_ch = out_ch, ch
            self.up_blocks.append(UpBlockTemporalDecoder(
                in_ch, out_ch, cfg.layers_per_block + 1, g, i != len(boc) - 1))
        self.conv_norm_out = GroupNorm(g, out_ch, 1e-6)
        self.conv_out = InflatedConv(out_ch, cfg.out_channels, 3, padding=1)
        self.time_conv_out = TemporalConv(cfg.out_channels, cfg.out_channels)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        x = self.conv_out(frame_group_norm(self.conv_norm_out, x, silu=True))
        return self.time_conv_out(x)


class AutoencoderKLTemporalDecoder(nn.Module):
    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.quant_conv = Conv(2 * config.latent_channels,
                               2 * config.latent_channels, 1)
        self.decoder = TemporalDecoder(config)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(n, h, w, 3) in [-1, 1] -> the posterior mean (n, h/8, w/8, 4)."""
        return self.quant_conv(self.encoder(x)).chunk(2, dim=-1)[0]

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(b, f, h', w', 4) unscaled latents -> (b, f, h, w, 3)."""
        return self.decoder(z)
