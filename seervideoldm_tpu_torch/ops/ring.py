"""Ring attention over the frame (``seq``) axis for the SWAT temporal
attention (port of ``seervideoldm_tpu/ops/ring.py``).

Each rank keeps its contiguous frame range resident and the K/V window
blocks travel around the ``seq`` ranks by point-to-point sends
(``collectives.ring_shift``); each step's partial attention is merged with
the online (flash) softmax recurrence.  Peak memory per rank is one block,
not the whole sequence.

Causality decomposes exactly over the ring because window tokens are
f-major and rank r owns global window-token range [r * t, (r + 1) * t): a
block from rank ``src`` is fully visible when src < me, lower-triangular
when src == me and fully masked when src > me.  The masked blocks add
exactly nothing (the JAX body adds ``finfo.min`` to their logits), so they
are passed on without being computed.

The block products are plain ``torch.matmul`` in fp32, as the JAX package
leaves them to XLA's einsum with fp32 accumulation.  The backward is
written by hand (``_RingAttentionFn``): it recomputes each step's
probabilities from the forward's saved log-sum-exp, as ``jax.checkpoint``
rematerialises the scan body, and dK / dV travel on around the ring with
their K / V block until they reach the rank that owns it.  Autograd does
not flow through point-to-point sends, hence the ``autograd.Function``.

The ``ring_attention`` config key (``set_ring_enabled``) turns the ring off
for the gather-based paths.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..parallel.activation import FrameShard
from ..parallel.collectives import group_rank, group_size, ring_shift
from .windows import window_partition, window_reverse

_DISABLE = False


def set_ring_enabled(enabled: bool) -> None:
    """Honour the ``ring_attention`` config key: False forces the
    gather-based paths under sequence parallelism."""
    global _DISABLE
    _DISABLE = not enabled


def ring_attention_applicable(shard: Optional[FrameShard]) -> bool:
    """Enabled, and the frames are split over a multi-rank ``seq`` axis."""
    return not _DISABLE and shard is not None


def _visible(src: int, me: int, causal: bool) -> bool:
    return not causal or src <= me


def _scores(q32, k, scale, causal, diagonal):
    s = torch.matmul(q32, k.float().transpose(-1, -2)) * scale
    if causal and diagonal:
        t = s.shape[-1]
        keep = torch.ones(t, t, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return s


def _ring_forward(qw, kw, vw, scale, causal, group):
    n, me = group_size(group), group_rank(group)
    q32 = qw.float()
    m = torch.full(qw.shape[:-1], float("-inf"), device=qw.device)
    l = torch.zeros(qw.shape[:-1], device=qw.device)
    o = torch.zeros(qw.shape, device=qw.device)
    kv = torch.stack([kw, vw])
    for r in range(n):
        src = (me - r) % n
        if _visible(src, me, causal):
            kr, vr = kv.unbind(0)
            s = _scores(q32, kr, scale, causal, src == me)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            o = o * alpha[..., None] + torch.matmul(p.to(vr.dtype).float(),
                                                    vr.float())
            m = m_new
        if r < n - 1:
            kv = ring_shift(kv, group)
    out = (o / l[..., None]).to(qw.dtype)
    return out, m + torch.log(l)


def _ring_backward(qw, kw, vw, out, lse, g, scale, causal, group):
    n, me = group_size(group), group_rank(group)
    q32, g32 = qw.float(), g.float()
    delta = (g32 * out.float()).sum(dim=-1, keepdim=True)
    dq = torch.zeros_like(q32)
    # the travelling block: its k, v and the dk, dv gathered so far
    kv = torch.stack([kw, vw])
    dkv = torch.zeros(kv.shape, dtype=torch.float32, device=kw.device)
    for r in range(n):
        src = (me - r) % n
        if _visible(src, me, causal):
            kr, vr = kv.unbind(0)
            p = torch.exp(_scores(q32, kr, scale, causal, src == me)
                          - lse[..., None])
            dkv[1] += torch.matmul(p.transpose(-1, -2), g32)
            dp = torch.matmul(g32, vr.float().transpose(-1, -2))
            ds = p * (dp - delta) * scale
            dq += torch.matmul(ds, kr.float())
            dkv[0] += torch.matmul(ds.transpose(-1, -2), q32)
        if r < n - 1:
            kv = ring_shift(kv, group)
        dkv = ring_shift(dkv, group)   # n shifts: home to the block's owner
    return dq.to(qw.dtype), dkv[0].to(kw.dtype), dkv[1].to(vw.dtype)


class _RingAttentionFn(torch.autograd.Function):
    """Online-softmax ring attention over already-windowed local tokens:
    qw/kw/vw (W, t, d), this rank's window blocks of a contiguous frame
    range; (W, t, d) in qw's dtype."""

    @staticmethod
    def forward(ctx, qw, kw, vw, scale, causal, group):
        out, lse = _ring_forward(qw, kw, vw, scale, causal, group)
        ctx.scale, ctx.causal, ctx.group = scale, causal, group
        ctx.save_for_backward(qw, kw, vw, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        qw, kw, vw, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(qw, kw, vw, out, lse, g.contiguous(),
                                    ctx.scale, ctx.causal, ctx.group)
        return dq, dk, dv, None, None, None


def ring_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, causal: bool, ws: Optional[int],
                          shard: Optional[FrameShard]
                          ) -> Optional[torch.Tensor]:
    """Frame-sharded SWAT attention.  q/k/v: (bh, f_local, h, w, d), rotary
    applied at the global positions.  ``ws`` None is full-frame attention
    (one window of f * h * w tokens).  Returns (bh, f_local, h, w, d), or
    None when the ring is off, the frames are not split or not split
    evenly, or the windows do not tile (h, w): the caller then takes a
    gather-based path."""
    if not ring_attention_applicable(shard) or not shard.even:
        return None
    bh, fl, h, w, d = q.shape
    if ws is not None and (h % ws or w % ws):
        return None
    if ws is None:
        towin = lambda x: x.reshape(bh, fl * h * w, d)  # noqa: E731
        fromwin = lambda x: x.reshape(bh, fl, h, w, d)  # noqa: E731
    else:
        towin = lambda x: window_partition(x, ws)  # noqa: E731
        fromwin = lambda x: window_reverse(x, ws, fl, h, w)  # noqa: E731
    out = _RingAttentionFn.apply(towin(q), towin(k), towin(v), float(scale),
                                 bool(causal), shard.group)
    return fromwin(out)
