"""SeerUNet: the SD-1.5 UNet inflated to video with causal temporal
attention (port of ``seervideoldm_tpu/models/unet3d.py``).

down = 3 x CrossAttnDownBlock3D + DownBlock3D, mid =
UNetMidBlock3DCrossAttn, up = UpBlock3D + 3 x CrossAttnUpBlock3D;
timestep -> sinusoidal (flip_sin_to_cos) -> MLP; conv_in -> down -> mid ->
up -> fp32 GroupNorm + SiLU + conv_out.  ``sample`` is ``(b, f, h, w, 4)``.

``cond_frame`` is an argument of ``forward``: training calls with the number
of conditioning frames, sampling with 0, on the same weights.  ``remat``
(``False``, ``True`` / ``"block"`` or ``"save_attn"``) recomputes each
top-level block in the backward instead of keeping its activations
(``torch.utils.checkpoint``, non-reentrant), as the JAX ``SeerUNet.remat``;
under ``"save_attn"`` the recompute replays the outputs of the attention
cores and feed-forwards that the forward kept (``ops/remat.py``), so no
forward attention or GEGLU kernel runs twice.  It is an attribute read at
call time: one built model serves every policy.

Sampling knobs: ``tome_ratio`` / ``tome_min_tokens`` / ``tome_sd`` (Token
Merging at the spatial self-attention) and ``freeu`` ((b1, b2, s1, s2) at
the two deepest up stages) are config fields read at every call, so
replacing ``unet.config`` switches them on the same weights;
``forward(..., pab=flags, pab_cache=cache)`` runs a Pyramid Attention
Broadcast step (``diffusion/pab.py``; refused under remat).  The
reference's memory knobs: the config's ``attention_slice`` (the text
sites attend in head chunks; a sliced site runs no K2) and the module's
``collect_attn`` (as the JAX ``SeerUNet.collect_attn``, a constructor
argument and an attribute read at call time): each text block's
cross-attention ``attn2`` records its fp32 logits into ``forward``'s
``attn_maps`` dict under the site's qualified name,
``down_blocks.0.attentions.0.transformer_blocks.0.attn2`` and so on --
the JAX package's ``intermediates`` entries.

Under a registered ``seq`` axis the UNet takes and returns this rank's
frames of a ``num_frames``-frame video (``parallel.activation``): convs,
the VAE-side layers and the per-frame attention are frame-local, GroupNorm
sums its moments over the ranks, and the temporal sites see the global
frame positions.  The per-frame text context is split with the frames.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..ops.conv import InflatedConv
from ..ops.norms import GroupNorm, group_norm_silu
from ..ops.remat import save_attn_contexts
from ..parallel.activation import frame_shard, seq_group
from .embeddings import TimestepEmbedding, timestep_embedding
from .unet_blocks import (CrossAttnDownBlock3D, CrossAttnUpBlock3D, DownBlock3D,
                          UNetMidBlock3DCrossAttn, UpBlock3D)


@dataclass(frozen=True)
class SeerUNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    center_input_sample: bool = False
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    downsample_padding: int = 1
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    cross_attention_dim: int = 768
    attention_head_dim: int = 8
    # the reference's set_attention_slice(slice_size): the text sites'
    # attention in head chunks of this size (ops/attention.py); None = off
    attention_slice: Optional[int] = None
    # Token Merging (ops/tome.py): merge tome_ratio of the spatial tokens
    # around the self-attention of blocks with >= tome_min_tokens; 0 = off
    tome_ratio: float = 0.0
    tome_min_tokens: int = 1024
    tome_sd: int = 2
    # FreeU (ops/freeu.py): (b1, b2, s1, s2); None = off
    freeu: Optional[Sequence[float]] = None


SEER_UNET_SD15_CONFIG = SeerUNetConfig()
REMAT_POLICIES = (False, True, "block", "save_attn")


class SeerUNet(nn.Module):
    # an FSDP unit: gathers its weights whole per call (parallel/sharding.py)
    fsdp_unit = True

    def __init__(self, config: SeerUNetConfig = SeerUNetConfig(),
                 cond_frame: int = 0, remat: Union[bool, str] = False,
                 collect_attn: bool = False):
        super().__init__()
        if remat not in REMAT_POLICIES:
            raise ValueError(f"remat must be one of {REMAT_POLICIES}, got "
                             f"{remat!r}")
        cfg = self.config = config
        self.cond_frame, self.remat = cond_frame, remat
        self.collect_attn = collect_attn
        boc = tuple(cfg.block_out_channels)
        temb = boc[0] * 4
        n = len(boc)
        self.conv_in = InflatedConv(cfg.in_channels, boc[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(boc[0], temb)
        common = dict(resnet_eps=cfg.norm_eps, resnet_groups=cfg.norm_num_groups)
        attn = dict(attn_num_head_channels=cfg.attention_head_dim,
                    cross_attention_dim=cfg.cross_attention_dim, causal=True)

        self.down_blocks = nn.ModuleList()
        out_ch = boc[0]
        for i in range(n):
            in_ch, out_ch = out_ch, boc[i]
            if i < n - 1:
                self.down_blocks.append(CrossAttnDownBlock3D(
                    in_ch, out_ch, temb, cfg.layers_per_block,
                    downsample_padding=cfg.downsample_padding, **common, **attn))
            else:
                self.down_blocks.append(DownBlock3D(
                    in_ch, out_ch, temb, cfg.layers_per_block,
                    downsample_padding=cfg.downsample_padding,
                    add_downsample=False, **common))

        self.mid_block = UNetMidBlock3DCrossAttn(boc[-1], temb, **common, **attn)

        self.up_blocks = nn.ModuleList()
        rev = list(reversed(boc))
        out_ch = rev[0]
        for i in range(n):
            prev, out_ch = out_ch, rev[i]
            in_ch = rev[min(i + 1, n - 1)]
            kw = dict(num_layers=cfg.layers_per_block + 1,
                      add_upsample=i < n - 1, **common)
            if i == 0:
                self.up_blocks.append(UpBlock3D(in_ch, prev, out_ch, temb, **kw))
            else:
                self.up_blocks.append(CrossAttnUpBlock3D(in_ch, out_ch, prev,
                                                         temb, **kw, **attn))

        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, boc[0], cfg.norm_eps)
        self.conv_out = InflatedConv(boc[0], cfg.out_channels, 3, padding=1)
        for name, m in self.named_modules():
            if hasattr(m, "site"):
                m.site = name

    def _block(self, block, *args, **kwargs):
        """One top-level block; under ``remat`` with gradients on, its
        activations are recomputed in the backward (``save_attn``: all but
        the kept site outputs)."""
        if self.remat and torch.is_grad_enabled():
            if self.remat == "save_attn":
                kwargs["context_fn"] = save_attn_contexts
            return checkpoint(block, *args, use_reentrant=False, **kwargs)
        return block(*args, **kwargs)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor,
                cond_frame: Optional[int] = None,
                num_frames: Optional[int] = None,
                pab: Optional[dict] = None,
                pab_cache: Optional[dict] = None,
                attn_maps: Optional[dict] = None) -> torch.Tensor:
        """sample (b, f, h, w, 4); timesteps (b,) or scalar; context
        (b, f, l, d) FSText embeddings; ``cond_frame``: the first frames
        whose temporal FF residual is skipped (None: the constructor's).
        Under ``seq``, sample and context hold this rank's frames of a
        ``num_frames``-frame video (required there).  ``pab``: this step's
        PAB flags (``diffusion.pab.mode_to_flags``), with the sampling
        call's ``pab_cache`` dict.  ``attn_maps``: the dict the
        cross-attention logits go into under ``collect_attn``."""
        cfg = self.config
        cf = self.cond_frame if cond_frame is None else int(cond_frame)
        if pab is not None:
            if self.remat:
                raise ValueError("PAB is a sampling-time feature; build the "
                                 "UNet with remat=False")
            if pab_cache is None:
                raise ValueError("PAB flags need the sampling call's "
                                 "pab_cache dict")
            pab = (pab, pab_cache)
        frames = None
        if seq_group() is not None:
            if num_frames is None:
                raise ValueError("under a 'seq' mesh the UNet takes this "
                                 "rank's frames: pass num_frames, the frame "
                                 "count of the whole video")
            frames = frame_shard(int(num_frames))
            if frames.counts[frames.index] != sample.shape[1]:
                raise ValueError(
                    f"this rank holds frames {frames.start}..{frames.stop} "
                    f"of {num_frames}, but the sample has {sample.shape[1]}")
        tome = ((float(cfg.tome_ratio), int(cfg.tome_min_tokens),
                 int(cfg.tome_sd)) if cfg.tome_ratio > 0.0 else None)
        knobs = dict(cond_frame=cf, frames=frames, pab=pab, tome=tome,
                     attention_slice=cfg.attention_slice,
                     attn_maps=((attn_maps if attn_maps is not None else {})
                                if self.collect_attn else None))
        dtype = self.conv_in.weight.dtype
        if cfg.center_input_sample:
            sample = 2 * sample - 1.0
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        t_emb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                                   cfg.flip_sin_to_cos, cfg.freq_shift)
        emb = self.time_embedding(t_emb.to(dtype))
        sample = self.conv_in(sample.to(dtype))
        context = context.to(dtype)

        res_states = (sample,)
        for block in self.down_blocks:
            if isinstance(block, CrossAttnDownBlock3D):
                sample, states = self._block(block, sample, emb, context,
                                             **knobs)
            else:
                sample, states = self._block(block, sample, emb)
            res_states += states

        sample = self._block(self.mid_block, sample, emb, context, **knobs)

        for i, block in enumerate(self.up_blocks):
            k = len(block.resnets)
            states, res_states = res_states[-k:], res_states[:-k]
            # FreeU at the two deepest up stages: (b1, s1), then (b2, s2)
            freeu = None
            if cfg.freeu is not None and i < 2:
                freeu = (float(cfg.freeu[i]), float(cfg.freeu[i + 2]))
            if isinstance(block, CrossAttnUpBlock3D):
                sample = self._block(block, sample, states, emb, context,
                                     freeu=freeu, **knobs)
            else:
                sample = self._block(block, sample, states, emb, freeu=freeu)

        sample = group_norm_silu(self.conv_norm_out, sample)
        return self.conv_out(sample)
