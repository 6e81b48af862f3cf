"""AutoencoderKL, the SD-1.5 VAE (port of ``seervideoldm_tpu/models/vae.py``).

Per-image 2D encode/decode, channels-last: images ``(b, h, w, 3)``, latents
``(b, h/8, w/8, 4)``; callers apply the 0.18215 latent scale.  Module names
follow the diffusers state dict (``encoder.down_blocks.0.resnets.0.conv1``,
``decoder.mid_block.attentions.0.query`` ...).  The mid-block attention is
plain PyTorch: the JAX package leaves it to XLA, so it has no kernel.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import conv2d_nhwc
from ..ops.norms import GroupNorm

VAE_SCALE = 0.18215


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Sequence[int] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32


SD15_VAE_CONFIG = VAEConfig()


class Conv(nn.Conv2d):
    """nn.Conv2d over channels-last ``(n, h, w, c)``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_nhwc(self, x)


class ResnetBlock2D(nn.Module):
    """GN(fp32) -> silu -> conv -> GN -> silu -> conv (+1x1 shortcut)."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 32,
                 eps: float = 1e-6):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, eps)
        self.conv1 = Conv(in_channels, out_channels, 3, padding=1)
        self.norm2 = GroupNorm(groups, out_channels, eps)
        self.conv2 = Conv(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (Conv(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttentionBlock2D(nn.Module):
    """Single-head spatial self-attention (diffusers VAE AttentionBlock)."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, 1e-6)
        self.query = nn.Linear(channels, channels)
        self.key = nn.Linear(channels, channels)
        self.value = nn.Linear(channels, channels)
        self.proj_attn = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        t = self.group_norm(x).reshape(b, h * w, c)
        q, k, v = self.query(t), self.key(t), self.value(t)
        scale = c ** -0.25
        logits = torch.matmul((q * scale).float(),
                              (k * scale).float().transpose(-1, -2))
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = self.proj_attn(torch.matmul(probs, v))
        return out.reshape(b, h, w, c) + x


class _Sampler(nn.Module):
    """Holds a resampling conv under the diffusers ``...samplers.0.conv``
    name."""

    def __init__(self, channels: int, stride: int, padding: int):
        super().__init__()
        self.conv = Conv(channels, channels, 3, stride=stride, padding=padding)


class _Block(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, layers: int, groups: int,
                 sampler: Optional[str]):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch, groups)
            for j in range(layers)])
        if sampler == "down":
            self.downsamplers = nn.ModuleList([_Sampler(out_ch, 2, 0)])
        elif sampler == "up":
            self.upsamplers = nn.ModuleList([_Sampler(out_ch, 1, 1)])
        self.sampler = sampler

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        if self.sampler == "down":
            # diffusers Downsample2D pad=0: asymmetric (0, 1) pad, stride 2
            x = self.downsamplers[0].conv(F.pad(x, (0, 0, 0, 1, 0, 1)))
        elif self.sampler == "up":
            x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            x = self.upsamplers[0].conv(x)
        return x


class _MidBlock(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(ch, ch, groups)
                                      for _ in range(2)])
        self.attentions = nn.ModuleList([AttentionBlock2D(ch, groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        boc, g = tuple(cfg.block_out_channels), cfg.norm_num_groups
        self.conv_in = Conv(cfg.in_channels, boc[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        out_ch = boc[0]
        for i, ch in enumerate(boc):
            in_ch, out_ch = out_ch, ch
            self.down_blocks.append(_Block(
                in_ch, out_ch, cfg.layers_per_block, g,
                "down" if i != len(boc) - 1 else None))
        self.mid_block = _MidBlock(out_ch, g)
        self.conv_norm_out = GroupNorm(g, out_ch, 1e-6)
        self.conv_out = Conv(out_ch, 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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
            self.up_blocks.append(_Block(
                in_ch, out_ch, cfg.layers_per_block + 1, g,
                "up" if i != len(boc) - 1 else None))
        self.conv_norm_out = GroupNorm(g, out_ch, 1e-6)
        self.conv_out = Conv(out_ch, cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
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

    def encode_moments(self, x: torch.Tensor):
        """(b, h, w, 3) -> (mean, logvar), each (b, h/8, w/8, 4)."""
        moments = self.quant_conv(self.encoder(x))
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, x: torch.Tensor,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Posterior sample ``mean + std * noise``, or the mean when
        ``noise`` is None.  The noise is an argument so that a test can feed
        the same draw to the JAX package."""
        mean, logvar = self.encode_moments(x)
        if noise is None:
            return mean
        return mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))
