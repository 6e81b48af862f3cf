"""Down / mid / up blocks of the SeerUNet (port of
``seervideoldm_tpu/models/unet_blocks.py``).

Each cross-attention layer runs ResnetBlock3D -> SpatialTransformer3D
(per-frame spatial + text cross-attention) -> SpatialTransformer3D
(temporal, causal).  Skip connections concatenate on the channel axis
(last here).  ``cond_frame`` and ``frames`` (this rank's ``FrameShard``
under ``seq``) are arguments of each attention block's ``forward``, handed
down to its temporal sites; so are the sampling knobs ``pab`` and
``tome`` (``transformer3d.py``).  An up block's ``freeu = (b, s)`` applies
FreeU (``ops/freeu.py``) before each skip concat.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.freeu import apply_freeu
from .resnet3d import Downsample3D, ResnetBlock3D, Upsample3D
from .transformer3d import SpatialTransformer3D


def _site_pair(ch: int, heads: int, cross_dim: int, groups: int,
               causal: bool):
    text = SpatialTransformer3D(ch, heads, ch // heads, context_dim=cross_dim,
                                text_frame_condition=True,
                                norm_num_groups=groups)
    temporal = SpatialTransformer3D(ch, heads, ch // heads, temporal=True,
                                    causal=causal, norm_num_groups=groups)
    return text, temporal


def _skip_concat(x, res, freeu):
    """Backbone and skip joined on channels, FreeU applied first."""
    if freeu is not None:
        x, res = apply_freeu(x, res, *freeu)
    return torch.cat([x, res], dim=-1)


class CrossAttnDownBlock3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 num_layers: int = 2, resnet_eps: float = 1e-6,
                 resnet_groups: int = 32, attn_num_head_channels: int = 8,
                 cross_attention_dim: int = 768, downsample_padding: int = 1,
                 add_downsample: bool = True, causal: bool = True):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()
        self.temporal_attentions = nn.ModuleList()
        for i in range(num_layers):
            self.resnets.append(ResnetBlock3D(
                in_channels if i == 0 else out_channels, out_channels,
                temb_channels, resnet_groups, resnet_eps))
            text, temporal = _site_pair(out_channels, attn_num_head_channels,
                                        cross_attention_dim, resnet_groups,
                                        causal)
            self.attentions.append(text)
            self.temporal_attentions.append(temporal)
        self.downsamplers = nn.ModuleList(
            [Downsample3D(out_channels, out_channels, downsample_padding)]
            if add_downsample else [])

    def forward(self, x, temb=None, encoder_hidden_states=None,
                cond_frame: int = 0, frames=None, pab=None, tome=None):
        states = ()
        for resnet, text, temporal in zip(self.resnets, self.attentions,
                                          self.temporal_attentions):
            x = resnet(x, temb)
            x = text(x, context=encoder_hidden_states, pab=pab, tome=tome)
            x = temporal(x, cond_frame=cond_frame, frames=frames, pab=pab)
            states += (x,)
        for down in self.downsamplers:
            x = down(x)
            states += (x,)
        return x, states


class DownBlock3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 num_layers: int = 2, resnet_eps: float = 1e-6,
                 resnet_groups: int = 32, downsample_padding: int = 1,
                 add_downsample: bool = True):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock3D(in_channels if i == 0 else out_channels, out_channels,
                          temb_channels, resnet_groups, resnet_eps)
            for i in range(num_layers)])
        self.downsamplers = nn.ModuleList(
            [Downsample3D(out_channels, out_channels, downsample_padding)]
            if add_downsample else [])

    def forward(self, x, temb=None):
        states = ()
        for resnet in self.resnets:
            x = resnet(x, temb)
            states += (x,)
        for down in self.downsamplers:
            x = down(x)
            states += (x,)
        return x, states


class UNetMidBlock3DCrossAttn(nn.Module):
    def __init__(self, in_channels: int, temb_channels: int, num_layers: int = 1,
                 resnet_eps: float = 1e-6, resnet_groups: int = 32,
                 attn_num_head_channels: int = 8, cross_attention_dim: int = 768,
                 causal: bool = True):
        super().__init__()
        res = lambda: ResnetBlock3D(in_channels, in_channels, temb_channels,  # noqa: E731
                                    resnet_groups, resnet_eps)
        self.resnets = nn.ModuleList([res() for _ in range(num_layers + 1)])
        self.attentions = nn.ModuleList()
        self.temporal_attentions = nn.ModuleList()
        for _ in range(num_layers):
            text, temporal = _site_pair(in_channels, attn_num_head_channels,
                                        cross_attention_dim, resnet_groups,
                                        causal)
            self.attentions.append(text)
            self.temporal_attentions.append(temporal)

    def forward(self, x, temb=None, encoder_hidden_states=None,
                cond_frame: int = 0, frames=None, pab=None, tome=None):
        x = self.resnets[0](x, temb)
        for text, temporal, resnet in zip(self.attentions,
                                          self.temporal_attentions,
                                          self.resnets[1:]):
            x = text(x, context=encoder_hidden_states, pab=pab, tome=tome)
            x = temporal(x, cond_frame=cond_frame, frames=frames, pab=pab)
            x = resnet(x, temb)
        return x


class CrossAttnUpBlock3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 prev_output_channel: int, temb_channels: int,
                 num_layers: int = 3, resnet_eps: float = 1e-6,
                 resnet_groups: int = 32, attn_num_head_channels: int = 8,
                 cross_attention_dim: int = 768, add_upsample: bool = True,
                 causal: bool = True):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()
        self.temporal_attentions = nn.ModuleList()
        for i in range(num_layers):
            skip = in_channels if i == num_layers - 1 else out_channels
            res_in = prev_output_channel if i == 0 else out_channels
            self.resnets.append(ResnetBlock3D(res_in + skip, out_channels,
                                              temb_channels, resnet_groups,
                                              resnet_eps))
            text, temporal = _site_pair(out_channels, attn_num_head_channels,
                                        cross_attention_dim, resnet_groups,
                                        causal)
            self.attentions.append(text)
            self.temporal_attentions.append(temporal)
        self.upsamplers = nn.ModuleList(
            [Upsample3D(out_channels, out_channels)] if add_upsample else [])

    def forward(self, x, res_states, temb=None, encoder_hidden_states=None,
                cond_frame: int = 0, frames=None, pab=None, tome=None,
                freeu=None):
        for resnet, text, temporal in zip(self.resnets, self.attentions,
                                          self.temporal_attentions):
            x = _skip_concat(x, res_states[-1], freeu)
            res_states = res_states[:-1]
            x = resnet(x, temb)
            x = text(x, context=encoder_hidden_states, pab=pab, tome=tome)
            x = temporal(x, cond_frame=cond_frame, frames=frames, pab=pab)
        for up in self.upsamplers:
            x = up(x)
        return x


class UpBlock3D(nn.Module):
    def __init__(self, in_channels: int, prev_output_channel: int,
                 out_channels: int, temb_channels: int, num_layers: int = 3,
                 resnet_eps: float = 1e-6, resnet_groups: int = 32,
                 add_upsample: bool = True):
        super().__init__()
        self.resnets = nn.ModuleList()
        for i in range(num_layers):
            skip = in_channels if i == num_layers - 1 else out_channels
            res_in = prev_output_channel if i == 0 else out_channels
            self.resnets.append(ResnetBlock3D(res_in + skip, out_channels,
                                              temb_channels, resnet_groups,
                                              resnet_eps))
        self.upsamplers = nn.ModuleList(
            [Upsample3D(out_channels, out_channels)] if add_upsample else [])

    def forward(self, x, res_states, temb=None, freeu=None):
        for resnet in self.resnets:
            x = _skip_concat(x, res_states[-1], freeu)
            res_states = res_states[:-1]
            x = resnet(x, temb)
        for up in self.upsamplers:
            x = up(x)
        return x
