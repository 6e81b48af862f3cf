"""Stable Video Diffusion's spatio-temporal UNet (diffusers
``UNetSpatioTemporalConditionModel``; Blattmann et al., arXiv 2311.15127;
Stability-AI/generative-models ``sgm/modules/video_attention.py`` and
``sgm/modules/diffusionmodules/video_model.py``).

Layout ``(b, f, h, w, c)`` as the SeerUNet's; ``b`` is clips x 2 under
classifier-free guidance.  Module and parameter names are diffusers', so
the released ``unet/diffusion_pytorch_model.safetensors`` loads strictly.

- ``SpatioTemporalResBlock``: the spatial ``ResnetBlock3D`` with
  per-frame GroupNorm statistics (``frame_norm``), then
  ``TemporalResnetBlock`` (GroupNorm over every frame of a clip, (3, 1, 1)
  convs, ``ops/conv.TemporalConv``), joined by an ``AlphaBlender``:
  ``(1 - s) hs + s ht`` with ``s = sigmoid(mix_factor)`` (diffusers'
  ``switch_spatial_to_temporal_mix``; the image-only indicator is all zero
  when sampling video, so "learned_with_images" is "learned").
- ``TransformerSpatioTemporalModel``: per-frame GroupNorm, linear
  ``proj_in``; ``BasicTransformerBlock`` per frame (self-attention,
  cross-attention to the clip's one image token, GEGLU FF);
  ``TemporalBasicTransformerBlock`` per spatial position over the frames
  (``ff_in``, full self-attention, cross-attention to the clip's
  first-frame token, FF) on the spatial output plus a frame-position MLP
  (``time_pos_embed``); blended ``s x_spatial + (1 - s) x_temporal``;
  linear ``proj_out`` + the site's input.
- Time conditioning: ``time_embedding(Timesteps(320)(c_noise))`` plus
  ``add_embedding`` of the added time ids ``[fps - 1, motion bucket,
  noise augmentation]`` (``Timesteps(256)`` each), one vector per clip.

Every op goes through the port's dispatch: GroupNorm (+ SiLU) through K11,
the attentions through ``CrossAttention`` (K2 where both sequences are at
least 512 tokens: the spatial self-attention of levels 0-2), the FFs
through ``ln_ff_residual`` / ``FeedForward`` (K3 at c = 320, K5 at 640);
the rest is plain PyTorch.  Detailed spans with CUDA events:
``site.temporal_resnet``, ``site.temporal_block``, ``site.blend`` and each
attention as ``site.attn.<kind>`` (``spatial_self``, ``spatial_cross``,
``temporal_self``, ``temporal_cross``) with its shape as ids.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import CrossAttention
from ..ops.conv import InflatedConv, TemporalConv
from ..ops.norms import (GroupNorm, LayerNorm, frame_group_norm,
                         group_norm_silu)
from ..utils import profiling
from . import transformer3d
from .embeddings import TimestepEmbedding, timestep_embedding
from .resnet3d import Downsample3D, ResnetBlock3D, Upsample3D
from .transformer3d import FeedForward


@dataclass(frozen=True)
class SVDUNetConfig:
    """SVD-XT's ``unet/config.json``."""
    in_channels: int = 8
    out_channels: int = 4
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    num_attention_heads: Sequence[int] = (5, 10, 20, 20)
    cross_attention_dim: int = 1024
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 768
    norm_num_groups: int = 32


# GroupNorm epsilons per block kind: not in ``unet/config.json``, diffusers
# fixes them in its block classes.
DOWN_EPS = 1e-5         # DownBlockSpatioTemporal's resnets
CROSS_DOWN_EPS = 1e-6   # CrossAttnDownBlockSpatioTemporal's
MID_EPS = 1e-5          # UNetMidBlockSpatioTemporal's
UP_EPS = 1e-6           # UpBlockSpatioTemporal's
CROSS_UP_EPS = 1e-6     # CrossAttnUpBlockSpatioTemporal's
TRANSFORMER_EPS = 1e-6  # TransformerSpatioTemporalModel.norm
OUT_EPS = 1e-5          # conv_norm_out


def attend(attn: CrossAttention, kind: str, x: torch.Tensor,
           context: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``attn(x, context)`` inside a ``site.attn.<kind>`` span (CUDA
    events; its shape as ids: rows, n, m, c, cc, heads, d)."""
    ctx = x if context is None else context
    with profiling.span(f"site.attn.{kind}", events=True, rows=x.shape[0],
                        n=x.shape[1], m=ctx.shape[1], c=x.shape[2],
                        cc=ctx.shape[2], heads=attn.heads, d=attn.dim_head):
        return attn(x, context=context)


class AlphaBlender(nn.Module):
    """``s x_spatial + (1 - s) x_temporal`` with ``s = sigmoid(mix_factor)``,
    or ``s = 1 - sigmoid(mix_factor)`` with ``switch`` (diffusers'
    ``switch_spatial_to_temporal_mix``); one lerp."""

    def __init__(self, alpha: float = 0.5, switch: bool = False):
        super().__init__()
        self.switch = switch
        self.mix_factor = nn.Parameter(torch.tensor([float(alpha)]))

    def forward(self, spatial: torch.Tensor,
                temporal: torch.Tensor) -> torch.Tensor:
        with profiling.span("site.blend", events=True):
            s = torch.sigmoid(self.mix_factor.float())
            if self.switch:
                s = 1.0 - s
            return torch.lerp(temporal, spatial, s.to(spatial.dtype))


class TemporalResnetBlock(nn.Module):
    """GN over the clip's frames -> SiLU -> (3, 1, 1) conv -> + temb -> GN
    -> SiLU -> (3, 1, 1) conv, + the input."""

    # an FSDP unit: gathers its weights whole per call (parallel/sharding.py)
    fsdp_unit = True

    def __init__(self, channels: int, temb_channels: Optional[int],
                 groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.norm1 = GroupNorm(groups, channels, eps)
        self.conv1 = TemporalConv(channels, channels)
        self.time_emb_proj = (nn.Linear(temb_channels, channels)
                              if temb_channels else None)
        self.norm2 = GroupNorm(groups, channels, eps)
        self.conv2 = TemporalConv(channels, channels)

    def forward(self, x: torch.Tensor,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        with profiling.span("site.temporal_resnet", events=True):
            h = self.conv1(group_norm_silu(self.norm1, x))
            if self.time_emb_proj is not None and temb is not None:
                h = h + self.time_emb_proj(F.silu(temb))[:, None, None, None, :]
            h = self.conv2(group_norm_silu(self.norm2, h))
            return x + h


class SpatioTemporalResBlock(nn.Module):
    """Spatial resnet (per-frame statistics), temporal resnet, blend."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int], eps: float,
                 temporal_eps: Optional[float] = None, groups: int = 32,
                 alpha: float = 0.5):
        super().__init__()
        self.spatial_res_block = ResnetBlock3D(in_channels, out_channels,
                                               temb_channels, groups, eps,
                                               frame_norm=True)
        self.temporal_res_block = TemporalResnetBlock(
            out_channels, temb_channels, groups,
            eps if temporal_eps is None else temporal_eps)
        self.time_mixer = AlphaBlender(alpha, switch=True)

    def forward(self, x: torch.Tensor,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        hs = self.spatial_res_block(x, temb)
        return self.time_mixer(hs, self.temporal_res_block(hs, temb))


class BasicTransformerBlock(nn.Module):
    """Per-frame self-attention, cross-attention to the clip's image
    token, GEGLU FF, each pre-LN with a residual; tokens (b f, h w, c)."""

    # an FSDP unit: gathers its weights whole per call (parallel/sharding.py)
    fsdp_unit = True

    def __init__(self, dim: int, heads: int, d_head: int, context_dim: int):
        super().__init__()
        self.norm1, self.norm2, self.norm3 = (LayerNorm(dim), LayerNorm(dim),
                                              LayerNorm(dim))
        self.attn1 = CrossAttention(dim, heads=heads, dim_head=d_head)
        self.attn2 = CrossAttention(dim, context_dim, heads=heads,
                                    dim_head=d_head)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = attend(self.attn1, "spatial_self", self.norm1(x)) + x
        x = attend(self.attn2, "spatial_cross", self.norm2(x), context) + x
        return transformer3d.ln_ff_residual(self.norm3, self.ff, x)


class TemporalBasicTransformerBlock(nn.Module):
    """Per spatial position over the frames: ``ff_in`` (residual), full
    self-attention, cross-attention to the clip's first-frame token, FF;
    tokens (b h w, f, c)."""

    # an FSDP unit: gathers its weights whole per call (parallel/sharding.py)
    fsdp_unit = True

    def __init__(self, dim: int, heads: int, d_head: int, context_dim: int):
        super().__init__()
        self.norm_in = LayerNorm(dim)
        self.ff_in = FeedForward(dim)
        self.norm1 = LayerNorm(dim)
        self.attn1 = CrossAttention(dim, heads=heads, dim_head=d_head)
        self.norm2 = LayerNorm(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads=heads,
                                    dim_head=d_head)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        """x (b, f, h, w, c); context (b, l, d): each spatial position of
        clip i attends to clip i's tokens."""
        b, f, hh, ww, c = x.shape
        z = x.reshape(b, f, hh * ww, c).transpose(1, 2).reshape(b * hh * ww, f, c)
        z = transformer3d.ln_ff_residual(self.norm_in, self.ff_in, z)
        z = attend(self.attn1, "temporal_self", self.norm1(z)) + z
        ctx = context[:, None].expand(b, hh * ww, *context.shape[1:])
        z = attend(self.attn2, "temporal_cross", self.norm2(z),
                   ctx.reshape(b * hh * ww, *context.shape[1:])) + z
        z = transformer3d.ln_ff_residual(self.norm3, self.ff, z)
        return z.reshape(b, hh * ww, f, c).transpose(1, 2).reshape(x.shape)


class TransformerSpatioTemporalModel(nn.Module):
    """A transformer site: spatial block, temporal block, blend."""

    def __init__(self, heads: int, d_head: int, in_channels: int,
                 context_dim: int, groups: int = 32):
        super().__init__()
        inner = heads * d_head
        self.norm = GroupNorm(groups, in_channels, TRANSFORMER_EPS)
        self.proj_in = nn.Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, d_head, context_dim)])
        self.temporal_transformer_blocks = nn.ModuleList(
            [TemporalBasicTransformerBlock(inner, heads, d_head, context_dim)])
        self.time_pos_embed = TimestepEmbedding(in_channels, in_channels * 4,
                                                out_dim=in_channels)
        self.time_mixer = AlphaBlender(0.5)
        self.proj_out = nn.Linear(inner, in_channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        """x (b, f, h, w, c); context (b, l, d), the clip's image tokens."""
        b, f, hh, ww, c = x.shape
        h = self.proj_in(frame_group_norm(self.norm, x))
        inner = h.shape[-1]
        frame_ctx = context[:, None].expand(b, f, *context.shape[1:])
        s = self.transformer_blocks[0](
            h.reshape(b * f, hh * ww, inner),
            frame_ctx.reshape(b * f, *context.shape[1:])).reshape(h.shape)
        with profiling.span("site.temporal_block", events=True):
            frames = torch.arange(f, device=x.device)
            pos = self.time_pos_embed(
                timestep_embedding(frames, c).to(s.dtype))
            t = self.temporal_transformer_blocks[0](
                s + pos[None, :, None, None, :], context)
        return self.proj_out(self.time_mixer(s, t)) + x


class DownBlockSpatioTemporal(nn.Module):
    """``layers`` resnets, each followed by a transformer site when
    ``heads`` is given (CrossAttnDownBlockSpatioTemporal); a stride-2
    conv unless the last level."""

    def __init__(self, cin: int, cout: int, temb: int, layers: int,
                 heads: Optional[int], context_dim: int, downsample: bool,
                 groups: int = 32):
        super().__init__()
        eps = CROSS_DOWN_EPS if heads else DOWN_EPS
        self.resnets = nn.ModuleList([
            SpatioTemporalResBlock(cin if j == 0 else cout, cout, temb, eps,
                                   groups=groups) for j in range(layers)])
        if heads:
            self.attentions = nn.ModuleList([
                TransformerSpatioTemporalModel(heads, cout // heads, cout,
                                               context_dim, groups)
                for _ in range(layers)])
        if downsample:
            self.downsamplers = nn.ModuleList([Downsample3D(cout, cout, 1)])

    def forward(self, x, temb, context):
        states = ()
        attns = getattr(self, "attentions", [None] * len(self.resnets))
        for resnet, attn in zip(self.resnets, attns):
            x = resnet(x, temb)
            if attn is not None:
                x = attn(x, context)
            states += (x,)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
            states += (x,)
        return x, states


class UpBlockSpatioTemporal(nn.Module):
    """``layers`` resnets on the backbone joined with a skip on channels,
    each followed by a transformer site when ``heads`` is given
    (CrossAttnUpBlockSpatioTemporal); nearest 2x + conv unless the last
    level."""

    def __init__(self, cin: int, prev: int, cout: int, temb: int, layers: int,
                 heads: Optional[int], context_dim: int, upsample: bool,
                 groups: int = 32):
        super().__init__()
        eps = CROSS_UP_EPS if heads else UP_EPS
        self.resnets = nn.ModuleList()
        for j in range(layers):
            skip = cin if j == layers - 1 else cout
            res_in = prev if j == 0 else cout
            self.resnets.append(SpatioTemporalResBlock(res_in + skip, cout,
                                                       temb, eps,
                                                       groups=groups))
        if heads:
            self.attentions = nn.ModuleList([
                TransformerSpatioTemporalModel(heads, cout // heads, cout,
                                               context_dim, groups)
                for _ in range(layers)])
        if upsample:
            self.upsamplers = nn.ModuleList([Upsample3D(cout, cout)])

    def forward(self, x, res_states, temb, context):
        attns = getattr(self, "attentions", [None] * len(self.resnets))
        for resnet, attn in zip(self.resnets, attns):
            x = torch.cat([x, res_states[-1]], dim=-1)
            res_states = res_states[:-1]
            x = resnet(x, temb)
            if attn is not None:
                x = attn(x, context)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


class UNetMidBlockSpatioTemporal(nn.Module):
    def __init__(self, ch: int, temb: int, heads: int, context_dim: int,
                 groups: int = 32):
        super().__init__()
        self.resnets = nn.ModuleList([
            SpatioTemporalResBlock(ch, ch, temb, MID_EPS, groups=groups)
            for _ in range(2)])
        self.attentions = nn.ModuleList([
            TransformerSpatioTemporalModel(heads, ch // heads, ch, context_dim,
                                           groups)])

    def forward(self, x, temb, context):
        x = self.resnets[0](x, temb)
        return self.resnets[1](self.attentions[0](x, context), temb)


class UNetSpatioTemporalConditionModel(nn.Module):
    def __init__(self, config: SVDUNetConfig = SVDUNetConfig()):
        super().__init__()
        self.config = cfg = config
        boc, heads = tuple(cfg.block_out_channels), tuple(cfg.num_attention_heads)
        g, ctx, L = cfg.norm_num_groups, cfg.cross_attention_dim, cfg.layers_per_block
        temb = boc[0] * 4
        self.conv_in = InflatedConv(cfg.in_channels, boc[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(boc[0], temb)
        self.add_embedding = TimestepEmbedding(
            cfg.projection_class_embeddings_input_dim, temb)
        self.down_blocks = nn.ModuleList()
        out_ch = boc[0]
        for i, ch in enumerate(boc):
            in_ch, out_ch = out_ch, ch
            last = i == len(boc) - 1
            self.down_blocks.append(DownBlockSpatioTemporal(
                in_ch, out_ch, temb, L, None if last else heads[i], ctx,
                not last, g))
        self.mid_block = UNetMidBlockSpatioTemporal(boc[-1], temb, heads[-1],
                                                    ctx, g)
        rev, rev_heads = boc[::-1], heads[::-1]
        self.up_blocks = nn.ModuleList()
        out_ch = rev[0]
        for i in range(len(rev)):
            prev, out_ch = out_ch, rev[i]
            cin = rev[min(i + 1, len(rev) - 1)]
            first = i == 0
            self.up_blocks.append(UpBlockSpatioTemporal(
                cin, prev, out_ch, temb, L + 1,
                None if first else rev_heads[i], ctx, i != len(rev) - 1, g))
        self.conv_norm_out = GroupNorm(g, boc[0], OUT_EPS)
        self.conv_out = InflatedConv(boc[0], cfg.out_channels, 3, padding=1)

    def forward(self, sample: torch.Tensor, timestep, context: torch.Tensor,
                added_time_ids: torch.Tensor) -> torch.Tensor:
        """sample (b, f, h, w, in_channels); ``timestep`` the continuous
        c_noise, a number or (b,); context (b, l, cross_attention_dim);
        added_time_ids (b, 3).  Returns (b, f, h, w, out_channels)."""
        b = sample.shape[0]
        dtype = self.conv_in.weight.dtype
        t = torch.as_tensor(timestep, device=sample.device,
                            dtype=torch.float32).reshape(-1).expand(b)
        emb = self.time_embedding(
            timestep_embedding(t, self.conv_in.out_channels).to(dtype))
        ids = timestep_embedding(added_time_ids.reshape(-1),
                                 self.config.addition_time_embed_dim)
        emb = emb + self.add_embedding(ids.reshape(b, -1).to(dtype))
        context = context.to(dtype)
        x = self.conv_in(sample.to(dtype))
        states = (x,)
        for block in self.down_blocks:
            x, res = block(x, emb, context)
            states += res
        x = self.mid_block(x, emb, context)
        for block in self.up_blocks:
            n = len(block.resnets)
            x = block(x, states[-n:], emb, context)
            states = states[:-n]
        return self.conv_out(frame_group_norm(self.conv_norm_out, x,
                                              silu=True))
