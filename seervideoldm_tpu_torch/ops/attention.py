"""Attention ops and modules (port of ``seervideoldm_tpu/ops/attention.py``).

- ``dot_product_attention``: fp32 logits and softmax; the fused flash kernel
  (K2) where both sequence lengths are >= 512 and no explicit mask is given
  (rectangular causal stays on the einsum path), exactly the JAX gate.
  Every attention core without an explicit mask, kernel or einsum, is a
  site that ``remat: save_attn`` keeps with what its backward reads
  (``ops/remat.py``; the JAX package's ``attn_out``).
- ``sliced_attention``: the reference's ``set_attention_slice`` path,
  heads in chunks of ``slice_size`` through the plain attention (never
  the K2 kernel, as the JAX package's chunks run ``use_flash=False``);
- ``CrossAttention``: reference ``to_q/to_k/to_v/to_out.0`` projections;
  ``temporal=True`` applies rotary (rot_dim = min(32, dim_head)) to q/k.
  Per call: ``attention_slice`` (sliced attention where no mask is
  given) and ``attn_maps`` (the reference's ``return_attn``: the fp32
  logits, causal-masked where that applies, recorded under the site's
  qualified name -- the JAX package sows them into ``intermediates`` --
  and the attention computed from them on the einsum path).
- ``WindowTemporalAttention``: SWAT windowed causal spatio-temporal
  self-attention with the fused Q/K/V matmul.  Paths, in the JAX order:
  the table kernel (K1) when ws >= 8, the window tiles h and w exactly and
  the ring is not in use; else rotary pre-rotation at the global
  positions, then the ring over ``seq`` (``ops/ring.py``), then the
  pre-rotated kernel (K6) under ``seq``, then full-frame (h <= 4) or a
  windowed einsum.  Under ``seq`` the kernels run through
  ``parallel.activation.seq_kernel_step`` and the einsum paths on the
  gathered frames.

Under a ``model`` axis (``tp_group`` set by
``parallel.sharding.shard_tensor_parallel``) both attention modules hold
their slice of the heads: ``heads`` is the local count, q/k/v the column
slices, and ``to_out.0`` runs row-parallel (``row_parallel_linear``: fp32
partials, one all-reduce, the bias once).  Attention maps are gathered
over the heads, so a map equals a single rank's.

Layout: tokens ``(b, n, c)``; heads ``(b, H, n, d)``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .kernels.flash_attention import flash_attention, plain_attention
from ..parallel.activation import (FrameShard, gather_frames, local_frames,
                                   seq_kernel_step)
from ..parallel.collectives import (all_gather_cat, copy_to_model,
                                    group_size, row_parallel_linear)
from .kernels.swat_attention import swat_attention, swat_attention_tables
from .ring import ring_attention_applicable, ring_window_attention
from .rotary import apply_rotary, inv_freq, rotary_freqs, rotary_tables
from .windows import select_window_size, window_partition, window_reverse

NEG_INF = torch.finfo(torch.float32).min


def causal_mask(n: int, m: int, device=None) -> torch.Tensor:
    """Boolean (n, m) mask, True = attend: the reference's ``tril(m - n)``."""
    return torch.ones(n, m, dtype=torch.bool, device=device).tril(m - n)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, mask: Optional[torch.Tensor] = None,
                          causal: bool = False) -> torch.Tensor:
    """q (..., n, d), k/v (..., m, d); ``mask`` broadcastable to
    (..., n, m), True = attend.  ``causal`` applies the tril(m - n) mask
    only when no explicit ``mask`` is given, as in the JAX package."""
    n, m = q.shape[-2], k.shape[-2]
    if mask is None and n >= 512 and m >= 512 and (not causal or n == m):
        return flash_attention(q, k, v, scale, causal)
    if mask is None:
        return plain_attention(q, k, v, scale, causal)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def sliced_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, slice_size: int,
                     causal: bool = False) -> torch.Tensor:
    """Attention in ``slice_size`` chunks of the head axis (q/k/v (b, h,
    n|m, d), ``slice_size`` divides h: the local heads under a ``model``
    axis), each through the plain attention (a saved site under ``remat:
    save_attn``)."""
    h = q.shape[1]
    if h % slice_size:
        raise ValueError(f"slice_size {slice_size} must divide heads {h} "
                         "(this rank's heads under a 'model' axis)")
    return torch.cat([plain_attention(q[:, i:i + slice_size],
                                      k[:, i:i + slice_size],
                                      v[:, i:i + slice_size], scale, causal)
                      for i in range(0, h, slice_size)], dim=1)


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(b, n, H*d) -> (b, H, n, d)."""
    b, n, hd = x.shape
    return x.reshape(b, n, heads, hd // heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(b, H, n, d) -> (b, n, H*d)."""
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


class RotaryEmbedding(nn.Module):
    """Holds rotary-embedding-torch 0.1.5's persistent ``freqs`` buffer, so
    the reference checkpoints' ``rotary_emb.freqs`` keys load strictly.  The
    phases themselves come from the same formula in ``ops/rotary.py``."""

    def __init__(self, rot_dim: int):
        super().__init__()
        self.rot_dim = rot_dim
        self.register_buffer("freqs", inv_freq(rot_dim))


def _out_proj(inner: int, query_dim: int) -> nn.ModuleList:
    # reference to_out = [Linear, Dropout]; only index 0 holds parameters
    return nn.ModuleList([nn.Linear(inner, query_dim), nn.Identity()])


def project_out(lin: nn.Linear, x: torch.Tensor, group) -> torch.Tensor:
    """``lin(x)``; row-parallel over ``group`` when the unit is split."""
    if group is None:
        return lin(x)
    return row_parallel_linear(x, lin.weight, lin.bias, group)


class CrossAttention(nn.Module):
    """Multi-head (cross-)attention; self-attention when ``context`` is
    None."""

    # an FSDP unit: gathers its weights whole per call (parallel/sharding.py)
    fsdp_unit = True

    def __init__(self, query_dim: int, cross_attention_dim: Optional[int] = None,
                 heads: int = 8, dim_head: int = 64, bias: bool = False,
                 temporal: bool = False, causal: bool = False):
        super().__init__()
        inner = heads * dim_head
        ctx_dim = cross_attention_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.temporal, self.causal = temporal, causal
        self.tp_group = None  # the model group once split (parallel/sharding)
        self.to_q = nn.Linear(query_dim, inner, bias=bias)
        self.to_k = nn.Linear(ctx_dim, inner, bias=bias)
        self.to_v = nn.Linear(ctx_dim, inner, bias=bias)
        self.to_out = _out_proj(inner, query_dim)
        if temporal:
            self.rotary_emb = RotaryEmbedding(min(32, dim_head))
        self.site = ""  # qualified name, the key of its attention maps

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                attention_slice: Optional[int] = None,
                attn_maps: Optional[dict] = None) -> torch.Tensor:
        group = self.tp_group
        x = copy_to_model(x, group)
        ctx = x if context is None else copy_to_model(context, group)
        q = split_heads(self.to_q(x), self.heads)
        k = split_heads(self.to_k(ctx), self.heads)
        v = split_heads(self.to_v(ctx), self.heads)
        if self.temporal:
            # temporal sites are self-attention: q and k share positions
            freqs = rotary_freqs(torch.arange(q.shape[2], device=x.device),
                                 self.rotary_emb.rot_dim)
            q, k = apply_rotary(q, freqs), apply_rotary(k, freqs)
        scale = self.dim_head ** -0.5
        causal = self.temporal and self.causal
        if attn_maps is not None:
            logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
            if causal:
                logits = logits.masked_fill(
                    ~causal_mask(q.shape[2], k.shape[2], x.device), NEG_INF)
            attn_maps[self.site] = (logits if group is None else
                                    all_gather_cat(logits, group, 1,
                                                   [self.heads]
                                                   * group_size(group)))
            out = torch.matmul(torch.softmax(logits, dim=-1).to(v.dtype), v)
        elif attention_slice:
            out = sliced_attention(q, k, v, scale, int(attention_slice),
                                   causal)
        else:
            out = dot_product_attention(q, k, v, scale, causal=causal)
        return project_out(self.to_out[0], merge_heads(out), group)


class WindowTemporalAttention(nn.Module):
    """SWAT windowed causal spatio-temporal self-attention over
    ``(b, f, h, w, c)``: q/k/v over the f-major flattened video, rotary with
    positions ``frame*h*w + row*w + col`` (before windowing), ws x ws
    windows across all frames (full-frame when h <= 4), causal over the
    f-major window tokens.

    ``frames``: under ``seq`` the input holds this rank's frames of a
    longer video (``FrameShard``); positions and causality are those of the
    global frames."""

    # an FSDP unit (parallel/sharding.py): the forward reads its q/k/v
    # projections' weights itself
    fsdp_unit = True

    def __init__(self, query_dim: int, heads: int = 8, dim_head: int = 64,
                 bias: bool = False, causal: bool = True):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.causal = causal
        self.tp_group = None  # the model group once split (parallel/sharding)
        self.to_q = nn.Linear(query_dim, inner, bias=bias)
        self.to_k = nn.Linear(query_dim, inner, bias=bias)
        self.to_v = nn.Linear(query_dim, inner, bias=bias)
        self.to_out = _out_proj(inner, query_dim)
        self.rotary_emb = RotaryEmbedding(min(32, dim_head))

    def forward(self, x: torch.Tensor,
                frames: Optional[FrameShard] = None) -> torch.Tensor:
        b, f, h, w, c = x.shape
        n, heads, d = f * h * w, self.heads, self.dim_head
        # Q/K/V as one matmul against the concatenated weights: the hidden
        # states are read once.  (Under a mesh the JAX layer switches to
        # three Dense layers so the weights can shard over 'model'; here
        # each is this rank's slice under 'model', and the fused form is
        # the same math.)
        group = self.tp_group
        x = copy_to_model(x, group)
        lin = (self.to_q, self.to_k, self.to_v)
        weight = torch.cat([m.weight for m in lin])
        bias = (torch.cat([m.bias for m in lin])
                if self.to_q.bias is not None else None)
        qkv = F.linear(x.reshape(b, n, c), weight, bias)
        q, k, v = (split_heads(t, heads) for t in qkv.chunk(3, dim=-1))

        rot_dim = self.rotary_emb.rot_dim
        ws = select_window_size(h)
        scale = d ** -0.5
        total = f if frames is None else frames.total
        start = 0 if frames is None else frames.start
        bh = b * heads
        grid5 = lambda t: t.reshape(bh, f, h, w, d)  # noqa: E731
        tiles = ws is not None and ws >= 8 and h % ws == 0 and w % ws == 0
        out = None
        if tiles and not ring_attention_applicable(frames):
            cos, sin = rotary_tables(total, h, w, d, rot_dim, device=x.device)
            fn = lambda qs, ks, vs, cs, sn: swat_attention_tables(  # noqa: E731
                qs, ks, vs, cs, sn, scale, self.causal, ws)
            if frames is None:
                out = fn(grid5(q), grid5(k), grid5(v), cos, sin)
            else:
                out = seq_kernel_step(fn, (grid5(q), grid5(k), grid5(v)),
                                      frames, replicated=(cos, sin))
        if out is None:
            # pre-rotation at the global positions of this rank's tokens
            pos = torch.arange(start * h * w, (start + f) * h * w,
                               device=x.device)
            freqs = rotary_freqs(pos, rot_dim)
            q, k = apply_rotary(q, freqs), apply_rotary(k, freqs)
            if ring_attention_applicable(frames):
                out = ring_window_attention(grid5(q), grid5(k), grid5(v),
                                            scale, self.causal, ws, frames)
        if out is None and tiles and frames is not None:
            fn = lambda qs, ks, vs: swat_attention(  # noqa: E731
                qs, ks, vs, scale, self.causal, ws, 0)
            out = seq_kernel_step(fn, (grid5(q), grid5(k), grid5(v)), frames)
        if out is None:
            if frames is not None:
                q, k, v = (gather_frames(t.reshape(b, heads, f, h * w, d),
                                         frames, dim=2).reshape(
                               b, heads, total * h * w, d) for t in (q, k, v))
            if ws is None:
                out = dot_product_attention(q, k, v, scale, causal=self.causal)
                out = out.reshape(bh, total, h, w, d)
            else:
                grid = lambda t: t.reshape(bh, total, h, w, d)  # noqa: E731
                qw, kw, vw = (window_partition(grid(t), ws) for t in (q, k, v))
                ow = dot_product_attention(qw, kw, vw, scale, causal=self.causal)
                out = window_reverse(ow, ws, total, h, w)
            out = local_frames(out, frames)
        out = project_out(self.to_out[0],
                          merge_heads(out.reshape(b, heads, n, d)), group)
        return out.reshape(b, f, h, w, c)
