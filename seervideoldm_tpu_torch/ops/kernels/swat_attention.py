"""K1, K6, K7 and K9: fused SWAT windowed causal attention and its backward
(CUDA C++, ``csrc/swat_attention.cu``).

Replaces ``seervideoldm_tpu/ops/pallas/swat_attention.py``:
``swat_attention_tables`` (K1: forward ``_swat_forward_tab``, body
``_kernel_tab``), ``_swat_backward_tab`` (K7: body ``_bwd_kernel_tab``),
``swat_attention`` (K6: ``_swat_forward``, body ``_kernel``; q/k arrive
pre-rotated with ``rot_dim`` 0, the production call of the sequence-parallel
path, or are rotated in the kernel from fp32 trig with ``rot_dim`` > 0) and
``_swat_backward`` (K9: body ``_bwd_kernel``).  K6/K9 are the K1/K7 kernels
with another source of the rotation.  The window's 2.4 MB fp32 score
matrix the TPU kept in VMEM does not fit in shared memory, so the forward
(a Hopper kernel, wgmma fed by a TMA ring, ``csrc/attn_fwd_hopper.cuh``)
gives a CTA a few query frames of one window and streams the window's key
frames past them once, each loaded once per CTA (K1 rotates q and k in one
pass before it, K6 with ``rot_dim`` > 0 in shared memory); ``plan``
picks the consumer warpgroups per CTA, each holding one query frame;
``cta_tiles`` (in ``flash_attention.py``) is the kernel's map from a CTA
to its frames.
When a gradient is needed the forward also writes the rows' log-sum-exp,
so the backward recomputes the probabilities exactly in two Hopper
kernels without atomics (``csrc/attn_bwd_hopper.cuh``; a consumer
warpgroup owns one frame of a window, ``swat_bwd_plan``), after one pass
that rotates q and k as the forward did (tables, or trig for K9), and
de-rotates dq and dk with the adjoint in the store (see the source
notes).

The wrapper runs the plain version for CPU tensors and the kernels for
CUDA tensors; there is no other path.  Where a gradient is needed both go
through ``SwatAttentionTablesFn`` / ``SwatAttentionFn`` (on CPU tensors
their explicit plain forward and backward), so that ``remat: save_attn``
(``ops/remat.py``) keeps the forward's output and lse on either device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..rotary import inv_freq, rotary_tables, rotate_half
from ..windows import window_partition, window_reverse
from ..remat import needs_grad, saved_site
from . import build
from .flash_attention import (BWD_MAX_D, FWD_MAX_D, _acc_dtype,
                              attention_bwd_f32, bwd_plan, choose_cwg,
                              flash_attention_plain)

WS = 8  # the window side the kernels take


def covers(f: int, h: int, w: int, d: int, ws: int) -> bool:
    """Whether the K1 / K6 forward kernel takes the shape: ws 8, h and w
    whole windows, d a multiple of 8 up to 160."""
    return (ws == WS and f > 0 and h > 0 and w > 0 and h % ws == 0
            and w % ws == 0 and 0 < d <= FWD_MAX_D and d % 8 == 0)


@functools.lru_cache(maxsize=None)
def plan(batch: int, f: int, h: int, w: int, d: int) -> dict:
    """The K1 / K6 launch for one covered shape: ``cwg`` consumer
    warpgroups per CTA, each one query frame of the window
    (``flash_attention.choose_cwg``), ``ctas`` = batch x windows x ceil(f /
    cwg)."""
    windows = (h // WS) * (w // WS)
    ctas = lambda c: batch * windows * -(-f // c)  # noqa: E731
    cwg = choose_cwg(d, ctas)
    return {"cwg": cwg, "ctas": ctas(cwg), "tiles": f, "windows": windows}


def swat_bwd_plan(batch: int, f: int, h: int, w: int, d: int,
                  causal: bool = True) -> dict:
    """The K7 / K9 backward's launches: ``flash_attention.bwd_plan`` with
    one unit per (window, batch*head) and one tile per frame."""
    return bwd_plan(batch * (h // WS) * (w // WS), f, f, d, causal)


_LIB = None


def _lib():
    """The loaded ``csrc/swat_attention.cu`` library, its C signatures set
    once."""
    global _LIB
    if _LIB is None:
        lib = build.load("swat_attention")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.svl_swat_attention_tab_fwd.argtypes = [ptr] * 9 + [i32] * 6 + [
            f32, i32, i32, ptr]
        lib.svl_swat_attention_tab_bwd.argtypes = [ptr] * 13 + [i32] * 6 + [
            f32, i32, i32, i32, ptr]
        lib.svl_swat_attention_fwd.argtypes = [ptr] * 6 + [i32] * 7 + [
            f32, i32, i32, ptr]
        lib.svl_swat_attention_bwd.argtypes = [ptr] * 12 + [i32] * 7 + [
            f32, i32, i32, i32, ptr]
        for fn in (lib.svl_swat_attention_tab_fwd,
                   lib.svl_swat_attention_tab_bwd,
                   lib.svl_swat_attention_fwd, lib.svl_swat_attention_bwd):
            fn.restype = i32
        _LIB = lib
    return _LIB


def _opt(t):
    return None if t is None else t.data_ptr()


def rotate_tables(t: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor) -> torch.Tensor:
    """fp32 ``t * cos + rotate_half(t) * sin`` over interleaved pairs
    (rotate_half(t)[2i] = -t[2i+1], rotate_half(t)[2i+1] = t[2i]), cast back
    to t's dtype."""
    t32 = t.to(_acc_dtype(t))
    return (t32 * cos + rotate_half(t32) * sin).to(t.dtype)


def swat_attention_tables_plain(q, k, v, cos, sin, scale: float,
                                causal: bool, ws: int) -> torch.Tensor:
    """``_unfused_reference_tab``: rotate, window-partition, masked fp32
    softmax attention, window-reverse."""
    _, f, h, w, _ = q.shape
    qr, kr = rotate_tables(q, cos, sin), rotate_tables(k, cos, sin)
    qw, kw, vw = (window_partition(t, ws) for t in (qr, kr, v))
    ow = flash_attention_plain(qw, kw, vw, scale, causal)
    return window_reverse(ow, ws, f, h, w)


def swat_attention_tables_bwd_plain(q, k, v, cos, sin, g, scale: float,
                                    causal: bool, ws: int):
    """The vjp of ``_unfused_reference_tab`` as explicit formulas: rotate q
    and k, window-partition, the fp32 attention backward per window,
    window-reverse, then de-rotate dq and dk with the adjoint
    ``t * cos - rotate_half(t) * sin`` (the tables are pair-constant).
    Returns (dq, dk, dv) in the inputs' dtypes; the tables get no
    gradient."""
    _, f, h, w, _ = q.shape
    qr, kr = rotate_tables(q, cos, sin), rotate_tables(k, cos, sin)
    qw, kw, vw, gw = (window_partition(t, ws) for t in (qr, kr, v, g))
    dqw, dkw, dvw = attention_bwd_f32(qw, kw, vw, gw, scale, causal)
    dq, dk, dv = (window_reverse(t, ws, f, h, w) for t in (dqw, dkw, dvw))
    derotate = lambda t: t * cos - rotate_half(t) * sin  # noqa: E731
    return (derotate(dq).to(q.dtype), derotate(dk).to(k.dtype),
            dv.to(v.dtype))


def _check_cuda(q, k, v, cos, sin, ws: int, what: str) -> None:
    d = q.shape[-1]
    if ws != WS:
        raise ValueError(f"{what}: kernel covers ws = {WS}, got {ws}")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what}: kernel takes bf16, got {q.dtype}")
    if cos.dtype != torch.float32 or sin.dtype != torch.float32:
        raise ValueError(f"{what}: tables must be fp32")
    if cos.data_ptr() % 16 or sin.data_ptr() % 16:
        raise ValueError(f"{what}: tables must be 16-byte aligned")
    if d % 8 or d > FWD_MAX_D:
        raise ValueError(f"{what}: head dim {d} not covered "
                         f"(multiple of 8, at most {FWD_MAX_D})")


def _launch_fwd(q, k, v, cos, sin, scale: float, causal: bool, ws: int,
                want_lse: bool, cwg: int = None):
    """The K1 launch on contiguous CUDA tensors (a rotation pass, then the
    attention), ``cwg`` from ``plan`` unless given.  Returns (out, lse or
    None); lse (B, f, h, w) fp32, log2 domain."""
    batch, f, h, w, d = q.shape
    if cwg is None:
        cwg = plan(batch, f, h, w, d)["cwg"]
    out = torch.empty_like(q)
    qr, kr = torch.empty_like(q), torch.empty_like(k)  # the rotated q, k
    lse = (torch.empty(batch, f, h, w, dtype=torch.float32, device=q.device)
           if want_lse else None)
    lib = _lib()
    code = lib.svl_swat_attention_tab_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), qr.data_ptr(), kr.data_ptr(), out.data_ptr(),
        _opt(lse), batch, f, h, w, d, ws, float(scale), int(causal), cwg,
        build.stream_of(q))
    build.check(lib, code, "swat_attention_tables")
    swat_attention_tables.launches += 1
    return out, lse


def _bwd_buffers(q, k, v, need, rotated: bool):
    """dq, dk, dv (None where not needed), delta, and the rotated q and k
    (scratch; None when the kernel takes q and k as they are)."""
    batch, f, h, w, _ = q.shape
    need_kv = need[1] or need[2]
    dq = torch.empty_like(q) if need[0] else None
    dk = torch.empty_like(k) if need_kv else None
    dv = torch.empty_like(v) if need_kv else None
    delta = torch.empty(batch, f, h, w, dtype=torch.float32, device=q.device)
    qr, kr = ((torch.empty_like(q), torch.empty_like(k)) if rotated
              else (None, None))
    return dq, dk, dv, delta, qr, kr


def _bwd_cwg(q, causal: bool, cwg) -> tuple:
    """(cwg dq, cwg dk/dv): ``swat_bwd_plan``'s unless given."""
    if cwg is not None:
        return tuple(cwg)
    p = swat_bwd_plan(*q.shape, causal)
    return p["dq"]["cwg"], p["dkv"]["cwg"]


def swat_attention_tables_bwd(q, k, v, cos, sin, lse, g, scale: float,
                              causal: bool, ws: int,
                              need=(True, True, True)):
    """K7 on CUDA tensors: q/k/v/g (B, f, h, w, d) bf16 (q, k UN-rotated),
    ``lse`` (B, f, h, w) fp32 as the forward wrote it.
    Returns (dq, dk, dv); an entry is None where ``need`` is false and its
    kernel could be skipped."""
    if q.device.type != "cuda":
        raise ValueError(
            f"swat_attention_tables_bwd: unsupported device {q.device}")
    _check_cuda(q, k, v, cos, sin, ws, "swat_attention_tables_bwd")
    d = q.shape[-1]
    if d > BWD_MAX_D:
        raise ValueError(f"swat_attention_tables_bwd: head dim {d} not "
                         f"covered by the backward kernel (at most {BWD_MAX_D})")
    q, k, v, g, cos, sin, lse = (t.contiguous()
                                 for t in (q, k, v, g, cos, sin, lse))
    return _launch_tab_bwd(q, k, v, cos, sin, lse, g, scale, causal, ws,
                           need)


def _launch_tab_bwd(q, k, v, cos, sin, lse, g, scale: float, causal: bool,
                    ws: int, need, cwg: tuple = None):
    """The K7 launches on contiguous checked CUDA tensors, ``cwg`` (dq,
    dk/dv) from ``swat_bwd_plan`` unless given."""
    batch, f, h, w, d = q.shape
    dq, dk, dv, delta, qr, kr = _bwd_buffers(q, k, v, need, True)
    lib = _lib()
    code = lib.svl_swat_attention_tab_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), g.data_ptr(), lse.data_ptr(), qr.data_ptr(),
        kr.data_ptr(), delta.data_ptr(), _opt(dq), _opt(dk), _opt(dv), batch,
        f, h, w, d, ws, float(scale), int(causal),
        *_bwd_cwg(q, causal, cwg), build.stream_of(q))
    build.check(lib, code, "swat_attention_tables_bwd")
    swat_attention_tables_bwd.launches += 1
    return dq, dk, dv


class SwatAttentionTablesFn(torch.autograd.Function):
    """K1 forward with the K7 backward on CUDA tensors, saving q, k, v, the
    tables and lse; on CPU tensors the plain forward and its explicit
    backward, saving q, k, v and the tables.  cos/sin, scale, causal and
    ws get no gradient.  The forward's outputs are a saved site under
    ``remat: save_attn`` (``ops/remat.py``)."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, scale, causal, ws):
        ctx.scale, ctx.causal, ctx.ws = float(scale), bool(causal), int(ws)
        if q.device.type == "cuda":
            out, lse = saved_site(lambda: _launch_fwd(
                q, k, v, cos, sin, scale, causal, ws, want_lse=True))
            ctx.save_for_backward(q, k, v, cos, sin, lse)
        else:
            out, = saved_site(lambda: (swat_attention_tables_plain(
                q, k, v, cos, sin, scale, causal, ws),))
            ctx.save_for_backward(q, k, v, cos, sin)
        return out

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:3]
        if g.device.type == "cuda":
            q, k, v, cos, sin, lse = ctx.saved_tensors
            dq, dk, dv = swat_attention_tables_bwd(
                q, k, v, cos, sin, lse, g, ctx.scale, ctx.causal, ctx.ws, need)
        else:
            q, k, v, cos, sin = ctx.saved_tensors
            dq, dk, dv = swat_attention_tables_bwd_plain(
                q, k, v, cos, sin, g, ctx.scale, ctx.causal, ctx.ws)
        grads = [t if keep else None for t, keep in zip((dq, dk, dv), need)]
        return (*grads, None, None, None, None, None)


def swat_attention_tables(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          cos: torch.Tensor, sin: torch.Tensor, scale: float,
                          causal: bool, ws: int) -> torch.Tensor:
    """q/k/v: (B, f, h, w, d) UN-rotated; cos/sin fp32 (f, h, w, d) from
    ``ops.rotary.rotary_tables``.  Returns (B, f, h, w, d)."""
    _, f, h, w, d = q.shape
    if h % ws or w % ws:
        raise ValueError(f"SWAT kernel needs h % ws == 0 and w % ws == 0; "
                         f"got h={h}, w={w}, ws={ws}")
    if q.device.type == "cpu":
        if needs_grad(q, k, v):
            return SwatAttentionTablesFn.apply(q, k, v, cos, sin, scale,
                                               causal, ws)
        return saved_site(lambda: (swat_attention_tables_plain(
            q, k, v, cos, sin, scale, causal, ws),))[0]
    if q.device.type != "cuda":
        raise ValueError(f"swat_attention_tables: unsupported device {q.device}")
    _check_cuda(q, k, v, cos, sin, ws, "swat_attention_tables")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    cos, sin = cos.contiguous(), sin.contiguous()
    if needs_grad(q, k, v):
        if d > BWD_MAX_D:
            raise ValueError(f"swat_attention_tables: head dim {d} has no "
                             f"backward kernel (at most {BWD_MAX_D})")
        return SwatAttentionTablesFn.apply(q, k, v, cos, sin, scale, causal, ws)
    return saved_site(lambda: _launch_fwd(q, k, v, cos, sin, scale, causal, ws,
                                          want_lse=False)[:1])[0]


swat_attention_tables.launches = 0
swat_attention_tables_bwd.launches = 0


# ------------------------------------------------------------- K6 and K9

def _check_window_divisible(shape, ws: int) -> None:
    """The kernels tile (h, w) into exact ws-windows; a remainder would be
    left unwritten, so a non-divisible shape is refused."""
    _, _, h, w, _ = shape
    if h % ws or w % ws:
        raise ValueError(f"SWAT kernel needs h % ws == 0 and w % ws == 0; "
                         f"got h={h}, w={w}, ws={ws}")


def _bwd_strip_width(w: int, ws: int):
    """The JAX backward's gate: the widest strip <= 16 that is a whole
    number of windows and divides w (None: its plain fallback runs).  Every
    w the forward accepts at ws 8 has one."""
    for sw in range(min(16, w), 0, -1):
        if sw % ws == 0 and w % sw == 0:
            return sw
    return None


def _trig_tables(q, rot_dim: int):
    _, f, h, w, d = q.shape
    return rotary_tables(f, h, w, d, rot_dim, device=q.device)


def swat_attention_plain(q, k, v, scale: float, causal: bool, ws: int,
                         rot_dim: int) -> torch.Tensor:
    """``_unfused_reference``: rotate q and k at positions ``frame*h*w +
    row*w + col`` of the (f, h, w) volume when ``rot_dim`` > 0 (the tables
    are exactly ``apply_rotary``'s trig), window-partition, masked fp32
    softmax attention, window-reverse."""
    if rot_dim:
        cos, sin = _trig_tables(q, rot_dim)
        return swat_attention_tables_plain(q, k, v, cos, sin, scale, causal,
                                           ws)
    _, f, h, w, _ = q.shape
    qw, kw, vw = (window_partition(t, ws) for t in (q, k, v))
    ow = flash_attention_plain(qw, kw, vw, scale, causal)
    return window_reverse(ow, ws, f, h, w)


def swat_attention_bwd_plain(q, k, v, g, scale: float, causal: bool, ws: int,
                             rot_dim: int):
    """The vjp of ``swat_attention_plain`` as explicit formulas; with
    ``rot_dim`` 0 dq and dk are the gradients of the rotated inputs (the
    caller's autograd through its pre-rotation supplies the adjoint)."""
    if rot_dim:
        cos, sin = _trig_tables(q, rot_dim)
        return swat_attention_tables_bwd_plain(q, k, v, cos, sin, g, scale,
                                               causal, ws)
    _, f, h, w, _ = q.shape
    qw, kw, vw, gw = (window_partition(t, ws) for t in (q, k, v, g))
    dqw, dkw, dvw = attention_bwd_f32(qw, kw, vw, gw, scale, causal)
    return tuple(window_reverse(t, ws, f, h, w).to(ref.dtype)
                 for t, ref in zip((dqw, dkw, dvw), (q, k, v)))


def _check_cuda_k6(q, k, v, ws: int, rot_dim: int, what: str) -> None:
    d = q.shape[-1]
    if ws != WS:
        raise ValueError(f"{what}: kernel covers ws = {WS}, got {ws}")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what}: kernel takes bf16, got {q.dtype}")
    if d % 8 or d > FWD_MAX_D:
        raise ValueError(f"{what}: head dim {d} not covered "
                         f"(multiple of 8, at most {FWD_MAX_D})")
    if rot_dim < 0 or rot_dim > d or rot_dim % 2:
        raise ValueError(f"{what}: rot_dim {rot_dim} must be even and in "
                         f"[0, {d}]")


def _freqs(q, rot_dim: int):
    """The rot_dim / 2 fp32 frequencies the kernel's trig takes (None for
    rot_dim 0)."""
    return inv_freq(rot_dim, device=q.device) if rot_dim else None


def _launch_swat_fwd(q, k, v, scale: float, causal: bool, ws: int,
                     rot_dim: int, want_lse: bool, cwg: int = None):
    """The K6 launch on contiguous CUDA tensors, ``cwg`` from ``plan``
    unless given.  Returns (out, lse or None); lse (B, f, h, w) fp32, log2
    domain."""
    batch, f, h, w, d = q.shape
    if cwg is None:
        cwg = plan(batch, f, h, w, d)["cwg"]
    out = torch.empty_like(q)
    lse = (torch.empty(batch, f, h, w, dtype=torch.float32, device=q.device)
           if want_lse else None)
    freqs = _freqs(q, rot_dim)
    lib = _lib()
    code = lib.svl_swat_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _opt(freqs), out.data_ptr(),
        _opt(lse), batch, f, h, w, d, ws, rot_dim, float(scale), int(causal),
        cwg, build.stream_of(q))
    build.check(lib, code, "swat_attention")
    swat_attention.launches += 1
    return out, lse


def swat_attention_bwd(q, k, v, lse, g, scale: float, causal: bool, ws: int,
                       rot_dim: int, need=(True, True, True)):
    """K9 on CUDA tensors: q/k/v/g (B, f, h, w, d) bf16 as the forward took
    them, ``lse`` (B, f, h, w) fp32 as it wrote it.  Returns (dq, dk,
    dv); an entry is None where ``need`` is false and its kernel could be
    skipped."""
    if q.device.type != "cuda":
        raise ValueError(f"swat_attention_bwd: unsupported device {q.device}")
    _check_cuda_k6(q, k, v, ws, rot_dim, "swat_attention_bwd")
    batch, f, h, w, d = q.shape
    if d > BWD_MAX_D:
        raise ValueError(f"swat_attention_bwd: head dim {d} not covered by "
                         f"the backward kernel (at most {BWD_MAX_D})")
    if _bwd_strip_width(w, ws) is None:
        raise ValueError(f"swat_attention_bwd: w={w} has no strip of whole "
                         f"{ws}-windows")
    q, k, v, g, lse = (t.contiguous() for t in (q, k, v, g, lse))
    return _launch_swat_bwd(q, k, v, lse, g, scale, causal, ws, rot_dim,
                            need)


def _launch_swat_bwd(q, k, v, lse, g, scale: float, causal: bool, ws: int,
                     rot_dim: int, need, cwg: tuple = None):
    """The K9 launches on contiguous checked CUDA tensors, ``cwg`` as
    ``_launch_tab_bwd``'s."""
    batch, f, h, w, d = q.shape
    dq, dk, dv, delta, qr, kr = _bwd_buffers(q, k, v, need, rot_dim > 0)
    freqs = _freqs(q, rot_dim)
    lib = _lib()
    code = lib.svl_swat_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _opt(freqs), g.data_ptr(),
        lse.data_ptr(), _opt(qr), _opt(kr), delta.data_ptr(), _opt(dq),
        _opt(dk), _opt(dv), batch, f, h, w, d, ws, rot_dim, float(scale),
        int(causal), *_bwd_cwg(q, causal, cwg), build.stream_of(q))
    build.check(lib, code, "swat_attention_bwd")
    swat_attention_bwd.launches += 1
    return dq, dk, dv


class SwatAttentionFn(torch.autograd.Function):
    """K6 forward with the K9 backward on CUDA tensors, saving q, k, v and
    lse; on CPU tensors the plain forward and its explicit backward,
    saving q, k, v.  scale, causal, ws and rot_dim get no gradient.  The
    forward's outputs are a saved site under ``remat: save_attn``."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, ws, rot_dim):
        ctx.args = (float(scale), bool(causal), int(ws), int(rot_dim))
        if q.device.type == "cuda":
            out, lse = saved_site(lambda: _launch_swat_fwd(
                q, k, v, scale, causal, ws, rot_dim, want_lse=True))
            ctx.save_for_backward(q, k, v, lse)
        else:
            out, = saved_site(lambda: (swat_attention_plain(
                q, k, v, scale, causal, ws, rot_dim),))
            ctx.save_for_backward(q, k, v)
        return out

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:3]
        if g.device.type == "cuda":
            q, k, v, lse = ctx.saved_tensors
            dq, dk, dv = swat_attention_bwd(q, k, v, lse, g, *ctx.args,
                                            need=need)
        else:
            q, k, v = ctx.saved_tensors
            dq, dk, dv = swat_attention_bwd_plain(q, k, v, g, *ctx.args)
        grads = [t if keep else None for t, keep in zip((dq, dk, dv), need)]
        return (*grads, None, None, None, None)


def swat_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float, causal: bool, ws: int,
                   rot_dim: int = 0) -> torch.Tensor:
    """q/k/v: (B, f, h, w, d); ``rot_dim`` 0: q and k arrive rotated;
    ``rot_dim`` > 0: the kernel rotates their first ``rot_dim`` lanes at
    positions ``frame*h*w + row*w + col``.  Returns (B, f, h, w, d)."""
    _check_window_divisible(q.shape, ws)
    if q.device.type == "cpu":
        if needs_grad(q, k, v):
            return SwatAttentionFn.apply(q, k, v, scale, causal, ws, rot_dim)
        return saved_site(lambda: (swat_attention_plain(
            q, k, v, scale, causal, ws, rot_dim),))[0]
    if q.device.type != "cuda":
        raise ValueError(f"swat_attention: unsupported device {q.device}")
    _check_cuda_k6(q, k, v, ws, rot_dim, "swat_attention")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if needs_grad(q, k, v):
        if q.shape[-1] > BWD_MAX_D:
            raise ValueError(f"swat_attention: head dim {q.shape[-1]} has no "
                             f"backward kernel (at most {BWD_MAX_D})")
        return SwatAttentionFn.apply(q, k, v, scale, causal, ws, rot_dim)
    return saved_site(lambda: _launch_swat_fwd(q, k, v, scale, causal, ws,
                                               rot_dim, want_lse=False)[:1])[0]


swat_attention.launches = 0
swat_attention_bwd.launches = 0
