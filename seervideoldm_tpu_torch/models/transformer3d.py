"""Spatial, temporal and text transformer blocks of the SeerUNet (port of
``seervideoldm_tpu/models/transformer3d.py``).

- ``FeedForward``: GEGLU(dim -> 4 dim) -> Linear(4 dim -> dim), names
  ``ff.net.0.proj`` / ``ff.net.2``; the fused GEGLU kernel (K5) where the
  JAX site gate admits the shape, else the same chain as one plain site
  (``ops/kernels/geglu_ff.feed_forward``; every FF output, fused or not, is
  the JAX package's ``ff_out``, kept under ``remat: save_attn``);
- ``ln_ff_residual``: ``x + ff(norm3(x))`` with the LN-fused kernel (K3) at
  c <= 320;
- ``BasicTextTransformerBlock3D``: per-frame spatial self-attention (flash
  kernel K2 at seq >= 512) + per-frame cross-attention to that frame's
  FSText sub-instruction;
- ``BasicTransformerBlock3D`` (temporal): SWAT windowed causal attention
  (K1), then the FF, whose residual skips the first ``cond_frame`` frames;
- ``SpatialTransformer3D``: fp32 GroupNorm -> 1x1 proj_in -> block ->
  zero-initialised 1x1 proj_out + residual; at the last temporal block with
  ``cond_frame == 0`` and c <= 320 the whole tail runs as one kernel (K4).

Sampling knobs, arguments of each ``forward`` (``SeerUNet.forward`` reads
them from its config or its caller at every call):

- ``pab = (flags, cache)``: Pyramid Attention Broadcast at three sites,
  the text block's spatial ``attn1`` and cross ``attn2`` and the temporal
  block's ``attn1`` (``pab_residual``; the temporal block caches the
  attention delta only, its FF tail, K4's fused ``proj_out`` included,
  still runs).  The cache is a dict keyed by the site's qualified module
  name (``site``, set by ``SeerUNet``), made for one sampling call;
- ``tome = (ratio, min_tokens, sd)``: Token Merging around the spatial
  self-attention where ``h * w >= min_tokens`` (``ops/tome.py``); the
  attention gate sees the merged length;
- ``attention_slice``: the text block's ``attn1`` and ``attn2`` attend in
  head chunks of that size (``ops/attention.sliced_attention``);
- ``attn_maps``: a dict the text block's cross-attention ``attn2``
  records its logits into (``collect_attn``), as in the JAX package, where
  only ``attn2`` takes ``collect_attn``.

``cond_frame`` is an argument of each ``forward`` (training calls with the
number of conditioning frames, sampling with 0, on the same weights); the
constructor value is only the default for a call that passes none.  It
counts global frames: under ``seq`` (``frames``, this rank's
``FrameShard``) each rank skips the residual of its own share of them,
``clamp(cond_frame - first_frame, 0, f_local)``.

Under a ``model`` axis (``parallel.sharding.shard_tensor_parallel``) the
attentions hold their slice of the heads and the FF its slice of the
hidden units: ``ff.net.0.proj`` keeps its slice of the hidden rows and of
the gate rows (the JAX package's Megatron GEGLU), ``ff.net.2`` runs
row-parallel, and the GEGLU kernels (K3, K4, K5) are not launched -- the
JAX package's gates decline under any mesh, and the plain two-matmul form
is its path there.  The PAB cache holds the summed (replicated) residual.

Layout ``(b, f, h, w, c)``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..diffusion.pab import CROSS, SPATIAL, TEMPORAL
from ..ops.attention import CrossAttention, WindowTemporalAttention
from ..ops.conv import InflatedConv
from ..ops.kernels.geglu_ff import (feed_forward, geglu_ff, geglu_ff_supported,
                                    ln_geglu_ff, ln_geglu_ff_preferred,
                                    ln_geglu_ff_proj)
from ..ops.norms import GroupNorm, LayerNorm
from ..ops.tome import bipartite_soft_matching_2d
from ..parallel.activation import FrameShard, model_group
from ..parallel.collectives import copy_to_model, row_parallel_linear
from ..utils import profiling


def pab_residual(pab, key: str, kind: str, compute_fn) -> torch.Tensor:
    """An attention's residual delta under PAB: reused from the cache when
    this step's flag for ``kind`` says so, else computed and stored."""
    flags, cache = pab
    if flags[kind]:
        profiling.count(f"pab.reused.{kind}")
        if key not in cache:
            raise ValueError(
                f"PAB cache read before it was written ({key}): the first "
                "sampler step must use the all-compute mode so every "
                "attention site stores its delta before any step reuses it")
        return cache[key]
    profiling.count(f"pab.computed.{kind}")
    delta = compute_fn()
    cache[key] = delta
    return delta


class GEGLU(nn.Module):
    """hidden * gelu(gate) of one projection whose rows are [hidden |
    gate]; split over ``model``, this rank's rows of each half."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)  # rows [hidden | gate]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hidden, gate = self.proj(x).chunk(2, dim=-1)
        return hidden * F.gelu(gate, approximate="none")


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        # reference net = [GEGLU, Dropout, Linear]
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Identity(),
                                  nn.Linear(inner, dim)])
        self.tp_group = None  # the model group once split (parallel/sharding)

    def weights(self):
        """(w1, b1, w2, b2) in torch Linear layout, as the kernels take."""
        return (self.net[0].proj.weight, self.net[0].proj.bias,
                self.net[2].weight, self.net[2].bias)

    @profiling.site("ff")
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_group is not None:
            hidden = self.net[0](copy_to_model(x, self.tp_group))
            return row_parallel_linear(hidden, self.net[2].weight,
                                       self.net[2].bias, self.tp_group)
        lead, c = x.shape[:-1], x.shape[-1]
        n = x.numel() // c
        inner = self.net[2].in_features
        if model_group() is None and geglu_ff_supported(n, c, inner, x):
            return geglu_ff(x.reshape(n, c), *self.weights()).reshape(*lead, c)
        return feed_forward(x, *self.weights())


@profiling.site("ff")
def ln_ff_residual(norm: LayerNorm, ff: FeedForward,
                   x: torch.Tensor) -> torch.Tensor:
    """``x + ff(norm(x))``; LN prologue and residual epilogue fused into the
    GEGLU kernel where the JAX gate prefers it."""
    lead, c = x.shape[:-1], x.shape[-1]
    n = x.numel() // c
    if (model_group() is None
            and ln_geglu_ff_preferred(n, c, ff.net[2].in_features, x)):
        out = ln_geglu_ff(x.reshape(n, c), norm.weight, norm.bias, *ff.weights())
        return out.reshape(*lead, c)
    return ff(norm(x)) + x


@profiling.site("ff")
def ln_ff_proj_residual(norm: LayerNorm, ff: FeedForward, x: torch.Tensor,
                        proj_out: InflatedConv, res: torch.Tensor) -> torch.Tensor:
    """``res + proj_out(x + ff(norm(x)))`` as one kernel (the caller has
    checked the gate); x and res token-flattened (b, n, c)."""
    lead, c = x.shape[:-1], x.shape[-1]
    n = x.numel() // c
    w3 = proj_out.weight.reshape(proj_out.out_channels, c)
    out = ln_geglu_ff_proj(x.reshape(n, c), norm.weight, norm.bias,
                           *ff.weights(), w3, proj_out.bias, res.reshape(n, c))
    return out.reshape(*lead, c)


class BasicTextTransformerBlock3D(nn.Module):
    """Per-frame self-attention + per-frame cross-attention to the FSText
    sub-instructions + FF."""

    # an FSDP unit: gathers its weights whole per call (parallel/sharding.py)
    fsdp_unit = True

    def __init__(self, dim: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads=n_heads, dim_head=d_head)
        self.attn2 = CrossAttention(dim, context_dim, heads=n_heads,
                                    dim_head=d_head)
        self.ff = FeedForward(dim)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.norm3 = LayerNorm(dim)
        self.site = ""  # qualified name, the PAB cache's key

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None, pab=None,
                tome=None, attention_slice: Optional[int] = None,
                attn_maps: Optional[dict] = None) -> torch.Tensor:
        """x (b, f, h, w, c); context (b, f, l, d)."""
        b, f, h, w, c = x.shape
        x = x.reshape(b * f, h * w, c)
        sliced = dict(attention_slice=attention_slice)

        def self_attn(xin):
            xn = self.norm1(xin)
            if tome is None or h * w < tome[1]:
                return self.attn1(xn, **sliced)
            # matched on the block input (pre-norm), as ToMeSD does
            merge, unmerge = bipartite_soft_matching_2d(
                xin, h, w, int(tome[0] * h * w), sd=tome[2])
            if merge is None:
                return self.attn1(xn, **sliced)
            return unmerge(self.attn1(merge(xn), **sliced))

        if pab is None:
            x = self_attn(x) + x
        else:
            x_self = x
            x = pab_residual(pab, f"{self.site}.attn1", SPATIAL,
                             lambda: self_attn(x_self)) + x
        if context is not None:
            ctx = context.reshape(b * f, -1, context.shape[-1])
            cross = dict(context=ctx, attn_maps=attn_maps, **sliced)
            if pab is None:
                x = self.attn2(self.norm2(x), **cross) + x
            else:
                x_cross = x
                x = pab_residual(
                    pab, f"{self.site}.attn2", CROSS,
                    lambda: self.attn2(self.norm2(x_cross), **cross)) + x
        x = ln_ff_residual(self.norm3, self.ff, x)
        return x.reshape(b, f, h, w, c)


class BasicTransformerBlock3D(nn.Module):
    """Temporal block: SWAT windowed causal attention, then the FF skipping
    the first ``cond_frame`` frames' residual."""

    # an FSDP unit: gathers its weights whole per call (parallel/sharding.py)
    fsdp_unit = True

    def __init__(self, dim: int, n_heads: int, d_head: int, causal: bool = True,
                 cond_frame: int = 0):
        super().__init__()
        self.cond_frame = cond_frame
        self.attn1 = WindowTemporalAttention(dim, heads=n_heads, dim_head=d_head,
                                             causal=causal)
        self.ff = FeedForward(dim)
        self.norm1 = LayerNorm(dim)
        self.norm3 = LayerNorm(dim)
        self.site = ""  # qualified name, the PAB cache's key

    def forward(self, x: torch.Tensor, fuse_out=None,
                cond_frame: Optional[int] = None,
                frames: Optional[FrameShard] = None, pab=None) -> torch.Tensor:
        """``fuse_out = (proj_out, res)``: run the site tail in the FF
        kernel; the return value is then the site's final output."""
        b, f, h, w, c = x.shape

        def delta():
            return self.attn1(self.norm1(x), frames=frames).reshape(
                b, f * h * w, c)

        if pab is not None:
            delta_t = pab_residual(pab, f"{self.site}.attn1", TEMPORAL, delta)
        else:
            delta_t = delta()
        x = delta_t + x.reshape(b, f * h * w, c)
        if cond_frame is None:
            cond_frame = self.cond_frame
        if frames is not None:
            cond_frame = min(max(cond_frame - frames.start, 0), f)
        cf = cond_frame * h * w
        if cf > 0:
            # cond-frame tokens bypass the FF residual (reference
            # attention.py:241-246)
            x = torch.cat([x[:, :cf], ln_ff_residual(self.norm3, self.ff,
                                                     x[:, cf:])], dim=1)
        elif fuse_out is not None:
            proj_out, res = fuse_out
            x = ln_ff_proj_residual(self.norm3, self.ff, x, proj_out,
                                    res.reshape(b, f * h * w, c))
        else:
            x = ln_ff_residual(self.norm3, self.ff, x)
        return x.reshape(b, f, h, w, c)


class SpatialTransformer3D(nn.Module):
    """GroupNorm -> 1x1 proj_in -> transformer block -> zero-init 1x1
    proj_out + residual."""

    # an FSDP unit: gathers its weights whole per call (parallel/sharding.py)
    fsdp_unit = True

    def __init__(self, in_channels: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None, temporal: bool = False,
                 text_frame_condition: bool = False, causal: bool = False,
                 cond_frame: int = 0, norm_num_groups: int = 32):
        super().__init__()
        inner = n_heads * d_head
        self.temporal, self.cond_frame = temporal, cond_frame
        self.text_frame_condition = text_frame_condition
        self.norm = GroupNorm(norm_num_groups, in_channels, eps=1e-6)
        self.proj_in = InflatedConv(in_channels, inner, 1)
        if text_frame_condition:
            block = BasicTextTransformerBlock3D(inner, n_heads, d_head,
                                                context_dim)
        elif temporal:
            block = BasicTransformerBlock3D(inner, n_heads, d_head, causal,
                                            cond_frame)
        else:
            raise ValueError("the live SeerUNet builds text or temporal sites")
        self.transformer_blocks = nn.ModuleList([block])
        self.proj_out = InflatedConv(inner, in_channels, 1)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                cond_frame: Optional[int] = None,
                frames: Optional[FrameShard] = None, pab=None,
                tome=None, attention_slice: Optional[int] = None,
                attn_maps: Optional[dict] = None) -> torch.Tensor:
        b, f, h, w, c = x.shape
        x_in = x
        x = self.proj_in(self.norm(x))
        block = self.transformer_blocks[0]
        if self.text_frame_condition:
            x = block(x, context=context, pab=pab, tome=tome,
                      attention_slice=attention_slice, attn_maps=attn_maps)
        else:
            if cond_frame is None:
                cond_frame = self.cond_frame
            inner = x.shape[-1]
            if (cond_frame == 0 and c == inner and model_group() is None
                    and ln_geglu_ff_preferred(b * f * h * w, inner, inner * 4, x)):
                # proj_out + the outer residual ride the FF kernel (K4)
                return block(x, fuse_out=(self.proj_out, x_in), cond_frame=0,
                             frames=frames, pab=pab)
            x = block(x, cond_frame=cond_frame, frames=frames, pab=pab)
        return self.proj_out(x) + x_in
