"""K2 and K8: fused flash attention and its backward (CUDA C++,
``csrc/flash_attention.cu``).

Replaces ``seervideoldm_tpu/ops/pallas/flash_attention.py``:
``flash_attention`` (forward; the single-shot and streamed TPU forms
alike) and ``_flash_backward`` (with ``_bwd_einsum`` beyond kv = 4096).  On
the H100 both are tensor-core bound at the main-path shapes.  The forward
streams K/V in 64-key tiles through shared memory with an online softmax,
because 227 KB cannot hold the whole K/V row the TPU kept in VMEM; when a
gradient is needed it also writes the rows' log-sum-exp, so the backward
recomputes the probabilities exactly, tile by tile, in two kernels without
atomics (see the source notes).

The wrapper runs the plain version for CPU tensors and the kernels for
CUDA tensors; there is no other path.  Where a gradient is needed both go
through ``FlashAttentionFn`` (on CPU tensors its explicit plain forward and
backward), so that the CPU path has the CUDA path's autograd structure and
``remat: save_attn`` (``ops/remat.py``) keeps the forward's output and lse
on either.
"""
from __future__ import annotations

import ctypes

import torch

from ..remat import needs_grad, saved_site
from . import build

NEG_INF = torch.finfo(torch.float32).min
BWD_MAX_D = 80  # csrc/attn_bwd_core.cuh


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """fp32 arithmetic, fp64 for fp64 inputs (gradient checks)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, causal: bool = False) -> torch.Tensor:
    """The einsum branch of ``dot_product_attention``: fp32 logits and
    softmax, probabilities cast to v's dtype for the product."""
    acc = _acc_dtype(q)
    logits = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    if causal:
        n, m = logits.shape[-2:]
        keep = torch.ones(n, m, dtype=torch.bool, device=q.device).tril(m - n)
        logits = logits.masked_fill(~keep, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def attention_bwd_f32(q, k, v, g, scale: float, causal: bool):
    """dq, dk, dv of softmax(q k^T * scale) v by recomputation, as explicit
    formulas in fp32 (``_bwd_einsum``; causal = top-left tril, key <=
    query).  Outputs stay fp32."""
    acc = _acc_dtype(q)
    q32, k32, v32, g32 = (t.to(acc) for t in (q, k, v, g))
    logits = torch.matmul(q32, k32.transpose(-1, -2)) * scale
    if causal:
        n, m = logits.shape[-2:]
        keep = torch.ones(n, m, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), g32)
    dp = torch.matmul(g32, v32.transpose(-1, -2))
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    return (torch.matmul(ds, k32), torch.matmul(ds.transpose(-1, -2), q32), dv)


def flash_attention_bwd_plain(q, k, v, g, scale: float, causal: bool = False):
    """``_bwd_einsum``: (dq, dk, dv) cast to the inputs' dtypes."""
    dq, dk, dv = attention_bwd_f32(q, k, v, g, scale, causal)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_cuda(q, k, v, causal: bool, what: str):
    n, d = q.shape[-2:]
    m = k.shape[-2]
    if causal and n != m:
        raise ValueError(f"{what}: causal needs n == m")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what}: kernel takes bf16, got {q.dtype}")
    if d % 8 or d > 160:
        raise ValueError(f"{what}: head dim {d} not covered "
                         "(multiple of 8, at most 160)")
    return n, m, d


def _launch_fwd(qf, kf, vf, scale: float, causal: bool, want_lse: bool):
    """The K2 launch on folded contiguous (B, n, d) / (B, m, d) bf16 CUDA
    tensors.  Returns (out, lse or None); lse (B, n) fp32, log2 domain."""
    batch, n, d = qf.shape
    m = kf.shape[1]
    out = torch.empty_like(qf)
    lse = (torch.empty(batch, n, dtype=torch.float32, device=qf.device)
           if want_lse else None)
    lib = build.load("flash_attention")
    fn = lib.svl_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(build.ptr(qf), build.ptr(kf), build.ptr(vf), build.ptr(out),
              build.ptr(lse) if want_lse else None, batch, n, m, d,
              float(scale), int(causal), build.stream_of(qf))
    build.check(lib, code, "flash_attention")
    flash_attention.launches += 1
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, g, scale: float,
                        causal: bool = False, need=(True, True, True)):
    """K8 on CUDA tensors: q/out/g (B, n, d), k/v (B, m, d) bf16, ``lse``
    (B, n) fp32 as the forward wrote it.  Returns (dq, dk, dv); an entry is
    None where ``need`` is false and its kernel could be skipped."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    n, m, d = _check_cuda(q, k, v, causal, "flash_attention_bwd")
    if d > BWD_MAX_D:
        raise ValueError(f"flash_attention_bwd: head dim {d} not covered by "
                         f"the backward kernel (at most {BWD_MAX_D})")
    q, k, v, out, g = (t.contiguous() for t in (q, k, v, out, g))
    batch = q.shape[0]
    need_kv = need[1] or need[2]
    dq = torch.empty_like(q) if need[0] else None
    dk = torch.empty_like(k) if need_kv else None
    dv = torch.empty_like(v) if need_kv else None
    delta = torch.empty(batch, n, dtype=torch.float32, device=q.device)
    lib = build.load("flash_attention")
    fn = lib.svl_flash_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    opt = lambda t: build.ptr(t) if t is not None else None  # noqa: E731
    code = fn(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out),
              build.ptr(g), build.ptr(lse.contiguous()), build.ptr(delta),
              opt(dq), opt(dk), opt(dv), batch, n, m, d, float(scale),
              int(causal), build.stream_of(q))
    build.check(lib, code, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """softmax(q k^T * scale) v on folded (B, n, d) / (B, m, d) tensors.
    With ``kernel`` (default: on CUDA tensors) the K2 forward and the K8
    backward, saving q, k, v, out and lse; otherwise the plain forward and
    its explicit backward, saving q, k, v.  The forward's outputs are a
    saved site under ``remat: save_attn`` (``ops/remat.py``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, kernel=None):
        ctx.scale, ctx.causal = float(scale), bool(causal)
        ctx.kernel = q.device.type == "cuda" if kernel is None else kernel
        if ctx.kernel:
            out, lse = saved_site(lambda: _launch_fwd(q, k, v, scale, causal,
                                                      want_lse=True))
            ctx.save_for_backward(q, k, v, out, lse)
        else:
            if causal and q.shape[-2] != k.shape[-2]:
                raise ValueError("flash_attention: causal needs n == m")
            out, = saved_site(lambda: (flash_attention_plain(q, k, v, scale,
                                                             causal),))
            ctx.save_for_backward(q, k, v)
        return out

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:3]
        if ctx.kernel:
            q, k, v, out, lse = ctx.saved_tensors
            dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g, ctx.scale,
                                             ctx.causal, need)
        else:
            q, k, v = ctx.saved_tensors
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, g, ctx.scale,
                                                   ctx.causal)
        grads = [t if keep else None for t, keep in zip((dq, dk, dv), need)]
        return (*grads, None, None, None)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, causal: bool = False) -> torch.Tensor:
    """``flash_attention_plain`` as an attention site, on any device:
    through ``FlashAttentionFn``'s plain branch when a gradient is needed,
    a saved site either way.  (A causal n != m call keeps plain autograd:
    the explicit backward covers the top-left mask only.)"""
    if needs_grad(q, k, v):
        if causal and q.shape[-2] != k.shape[-2]:
            return flash_attention_plain(q, k, v, scale, causal)
        return FlashAttentionFn.apply(q, k, v, scale, causal, False)
    return saved_site(lambda: (flash_attention_plain(q, k, v, scale,
                                                     causal),))[0]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, causal: bool = False) -> torch.Tensor:
    """softmax(q k^T * scale) v.  q: (..., n, d), k/v: (..., m, d); leading
    dims fold.  Causal = top-left tril (key <= query)."""
    if q.device.type == "cpu":
        return plain_attention(q, k, v, scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    n, m, d = _check_cuda(q, k, v, causal, "flash_attention")
    lead = q.shape[:-2]
    qf = q.reshape(-1, n, d).contiguous()
    kf = k.reshape(-1, m, d).contiguous()
    vf = v.reshape(-1, m, d).contiguous()
    if needs_grad(qf, kf, vf):
        if d > BWD_MAX_D:
            raise ValueError(f"flash_attention: head dim {d} has no backward "
                             f"kernel (at most {BWD_MAX_D})")
        out = FlashAttentionFn.apply(qf, kf, vf, scale, causal)
    else:
        out, = saved_site(lambda: _launch_fwd(qf, kf, vf, scale, causal,
                                              want_lse=False)[:1])
    return out.reshape(*lead, n, d)


flash_attention.launches = 0
flash_attention_bwd.launches = 0
