"""K11: GroupNorm (+ SiLU) over a channels-last tensor (CUDA C++,
``csrc/group_norm.cu``).

Replaces no TPU kernel: the JAX package leaves GroupNorm to XLA, which
fused its fp32 chain on the TPU.  The port's plain chain
(``ops/norms.py::group_norm_moments_plain`` then
``group_norm_apply_plain``) is about 13 eager kernels a norm and ~36
bytes of HBM traffic an element; the UNet runs 77 GroupNorms a call.  K11
is two launches, a moments kernel (per-(b, group) mean and rstd in fp32)
and an apply kernel (the fp32 affine, the rounding to the input dtype and
the optional SiLU), 2 x itemsize bytes an element once L2 serves the
second read (see the source note).

The input ``(b, ..., c)`` is viewed as ``(b, n, c)``: a video's statistics
span its frames, an image's its pixels.  ``plan`` picks the launch shape
both kernels share; ``group_norm`` is the entry point, for CUDA tensors
only (``ops/norms.py`` runs the plain chain on the CPU and raises
elsewhere).  Each kernel counts its launches where it is launched:
``group_norm.launches`` the apply kernel's, one a norm call, and
``group_norm_moments.launches`` the moments kernel's, one a norm call
unless the caller brings the moments; ``group_norm.sharded`` counts the
calls whose moments the caller brought (the sequence-parallel all-reduce).
``check_against_plain`` and ``check_gradients_against_plain`` hold K11 to
its plain halves on the card, with the limits below (the card tests and
``chip_smoke.py`` both call them).
"""
from __future__ import annotations

import ctypes

import torch

from . import build

VEC = 8                  # csrc/group_norm.cu: channels a thread owns
MAX_THREADS = 512        # a CTA's threads at most: rpi x c / VEC
CTAS_PER_SM = 2          # __launch_bounds__(MAX_THREADS, 2): one wave
MIN_ROWS_PER_THREAD = 4  # fewer CTAs where a thread would walk fewer rows
# K11 against fp64 and its plain halves: the moments (fp32 Welford and
# Chan merges against fp64), and beside one bf16 ulp a floor on the whole
# path's outputs, absolute and a few fp32 ulps of the affine's shift
# (mean x rstd x w), for the elements near 0 where a ~1e-7 relative
# difference in the statistics is more than one bf16 ulp of the output
MOMENTS_RTOL = 1e-5
ABS_FLOOR, SHIFT_RTOL = 1e-6, 1e-6

_SMS: dict[int, int] = {}
_TICKETS: dict[tuple, torch.Tensor] = {}
_LIB = None


def plan(b: int, n: int, c: int, sms: int = 132) -> tuple[int, int]:
    """(rpi, ctas_per_b): ``rpi`` row slices of ``c / VEC`` threads a CTA
    (at most ``MAX_THREADS``), and CTAs per batch element, ~``CTAS_PER_SM``
    x ``sms`` in all (the whole card at b = 2), each a contiguous range of
    at least ``MIN_ROWS_PER_THREAD`` rows of every slice where the rows
    allow, none empty."""
    chunks = c // VEC
    rpi = max(1, MAX_THREADS // chunks)
    per_b = max(1, -(-CTAS_PER_SM * sms // b))
    per_b = min(per_b, max(1, n // (rpi * MIN_ROWS_PER_THREAD)))
    rows = -(-n // per_b)
    return rpi, -(-n // rows)


def check(x: torch.Tensor, groups: int) -> None:
    """Raise ValueError on a tensor the kernels do not take."""
    if x.dtype != torch.bfloat16:
        # the port computes in bf16 on the card
        raise ValueError(f"group_norm: kernel takes bf16, got {x.dtype}")
    if x.dim() < 2 or x.numel() == 0:
        raise ValueError(f"group_norm: kernel takes (b, ..., c), got "
                         f"{tuple(x.shape)}")
    b, c = x.shape[0], x.shape[-1]
    if c % VEC or c // VEC > MAX_THREADS or c % groups or b > 65535:
        raise ValueError(f"group_norm: {tuple(x.shape)} with {groups} groups "
                         f"not covered (c % {VEC} == 0, c <= "
                         f"{VEC * MAX_THREADS}, c % groups == 0, b <= 65535)")


def _lib():
    """The loaded ``csrc/group_norm.cu`` library, its C signatures set
    once (the wrapper's host time is on the sampling path: 77 calls a UNet
    call)."""
    global _LIB
    if _LIB is None:
        lib = build.load("group_norm")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.svl_group_norm_moments.argtypes = (
            [ptr] + [i32] * 6 + [ctypes.c_float] + [ptr] * 5)
        lib.svl_group_norm_moments.restype = i32
        lib.svl_group_norm_apply.argtypes = (
            [ptr] * 2 + [i32] * 6 + [ptr] * 4 + [i32, ptr])
        lib.svl_group_norm_apply.restype = i32
        _LIB = lib
    return _LIB


def _prepare(x: torch.Tensor, groups: int) -> tuple:
    """x as the kernels read it (contiguous, 16-byte aligned), the launch
    shape (b, n, c, rpi, per_b) and the current stream's handle; raises on
    what the kernels do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"group_norm: unsupported device {x.device}")
    check(x, groups)
    b, c = x.shape[0], x.shape[-1]
    n = x.numel() // (b * c)
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    dev = x.get_device()
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    return (x, b, n, c, *plan(b, n, c, _SMS[dev]), stream)


def _moments(prepared: tuple, groups: int, eps: float) -> torch.Tensor:
    """The moments kernel: a fp32 buffer whose first ``2 b groups`` values
    are mean and rstd, each (b, groups); the rest is its partials."""
    x, b, n, c, rpi, per_b, stream = prepared
    bg = b * groups
    buf = torch.empty(bg * (2 + 3 * per_b), dtype=torch.float32,
                      device=x.device)
    base = buf.data_ptr()
    key = (x.get_device(), stream)
    ticket = _TICKETS.get(key)
    if ticket is None or ticket.numel() < b:
        # zero between calls: the last CTA of each batch element resets its
        # own counter for the next call on this stream
        ticket = _TICKETS[key] = torch.zeros(max(b, 64), dtype=torch.int32,
                                             device=x.device)
    lib = _lib()
    code = lib.svl_group_norm_moments(
        x.data_ptr(), b, n, c, groups, rpi, per_b, eps, base + 8 * bg,
        ticket.data_ptr(), base, base + 4 * bg, stream)
    build.check(lib, code, "group_norm moments")
    group_norm_moments.launches += 1
    return buf


def group_norm_moments(x: torch.Tensor, groups: int, eps: float):
    """The moments kernel alone: (mean, rstd), each (b, groups) fp32."""
    b = x.shape[0]
    buf = _moments(_prepare(x, groups), groups, eps)
    return buf[:b * groups].view(b, groups), buf[b * groups:2 * b * groups
                                                 ].view(b, groups)


def _f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as contiguous fp32, itself when it already is (no dispatch)."""
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return t.detach().float().contiguous()


def group_norm(x: torch.Tensor, groups: int, eps: float, weight: torch.Tensor,
               bias: torch.Tensor, silu: bool = False, moments=None
               ) -> torch.Tensor:
    """(b, ..., c) CUDA tensor -> the same shape and dtype: GroupNorm with
    the fp32 affine ``weight``, ``bias`` (c), then SiLU when ``silu``.
    ``moments``: (mean, rstd), each (b, groups) fp32, from the caller (the
    sequence-parallel all-reduce), else the moments kernel computes them."""
    prepared = _prepare(x, groups)
    x, b, n, c, rpi, per_b, stream = prepared
    if moments is None:
        buf = _moments(prepared, groups, eps)
        mean_ptr = buf.data_ptr()
        rstd_ptr = mean_ptr + 4 * b * groups
    else:
        mean, rstd = (_f32(t) for t in moments)
        if mean.shape != (b, groups) or rstd.shape != (b, groups):
            raise ValueError(f"group_norm: moments shaped {tuple(mean.shape)}"
                             f", {tuple(rstd.shape)}, expected ({b}, {groups})")
        mean_ptr, rstd_ptr = mean.data_ptr(), rstd.data_ptr()
        group_norm.sharded += 1
    w, bb = _f32(weight), _f32(bias)
    y = torch.empty_like(x)
    lib = _lib()
    code = lib.svl_group_norm_apply(
        x.data_ptr(), y.data_ptr(), b, n, c, groups, rpi, per_b, mean_ptr,
        rstd_ptr, w.data_ptr(), bb.data_ptr(), int(silu), stream)
    build.check(lib, code, "group_norm apply")
    group_norm.launches += 1
    return y


group_norm.launches = 0
group_norm.sharded = 0
group_norm_moments.launches = 0


# ------------------------------------------------ the check on the card

def _bf16_key(t: torch.Tensor) -> torch.Tensor:
    """bf16 ``t``'s bit patterns as int32 in the order of the number line
    (+0 and -0 coincide)."""
    i = t.contiguous().view(torch.int16).to(torch.int32)
    return torch.where(i < 0, -(i & 0x7FFF), i)


def _bf16_step(t: torch.Tensor, steps: int) -> torch.Tensor:
    """bf16 ``t`` moved ``steps`` ulps up the number line."""
    k = _bf16_key(t) + steps
    return torch.where(k < 0, -k - 32768, k).to(torch.int16).view(
        torch.bfloat16)


def check_against_plain(x: torch.Tensor, groups: int, eps: float,
                        weight: torch.Tensor, bias: torch.Tensor,
                        silu: bool) -> dict:
    """K11 beside its plain halves on a bf16 CUDA ``x``: (1) the moments
    kernel's mean and rstd against fp64 (the mean relative to the group's
    |mean| plus standard deviation, rstd relative), within MOMENTS_RTOL;
    (2) the apply kernel against the plain apply on the kernel's own
    moments, bit for bit; (3) the whole kernel against the whole plain
    chain, each output equal to the plain one computed from a normalised
    value at most one bf16 ulp away (SiLU then applied), or within
    ABS_FLOOR + SHIFT_RTOL x |shift|: where |mean| is many standard
    deviations, the fp32 affine x * scale + shift cancels and a ~1e-7
    change of the statistics is many ulps of an output near 0.  Returns
    the readings and ``checks_ok``."""
    import torch.nn.functional as F

    from .. import norms

    with torch.no_grad():
        x = x.detach()
        b, c = x.shape[0], x.shape[-1]
        mean, rstd = group_norm_moments(x, groups, eps)
        flat = x.double().reshape(b, -1, groups, c // groups)
        var64, mean64 = torch.var_mean(flat, dim=(1, 3), unbiased=False)
        rstd64 = torch.rsqrt(var64 + eps)
        mean_err = float(((mean.double() - mean64).abs()
                          / (mean64.abs() + var64.sqrt())).max())
        rstd_err = float(((rstd.double() - rstd64).abs() / rstd64).max())
        shared = group_norm(x, groups, eps, weight, bias, silu, (mean, rstd))
        exact = norms.group_norm_apply_plain(x, mean, rstd, weight, bias, silu)
        apply_ulps = int((_bf16_key(shared) - _bf16_key(exact)).abs().max())
        got = group_norm(x, groups, eps, weight, bias, silu)
        m, r = norms.group_norm_moments_plain(x, groups, eps)
        y = norms.group_norm_apply_plain(x, m, r, weight, bias)
        cands = [_bf16_step(y, s) for s in (0, -1, 1)]
        if silu:
            cands = [F.silu(t) for t in cands]
        shift = (m * r).repeat_interleave(c // groups, dim=-1) * weight
        floor = ABS_FLOOR + SHIFT_RTOL * shift.abs().reshape(
            (b,) + (1,) * (x.dim() - 2) + (c,))
        ok = (got - cands[0]).float().abs() <= floor
        for t in cands:
            ok |= got == t
        outside = int((~ok).sum())
    return dict(moments_mean_rel_err=mean_err, moments_rstd_rel_err=rstd_err,
                apply_ulps_on_kernel_moments=apply_ulps,
                outside_one_ulp=outside,
                checks_ok=(mean_err <= MOMENTS_RTOL and rstd_err <= MOMENTS_RTOL
                           and apply_ulps == 0 and outside == 0
                           and got.dtype == x.dtype and got.shape == x.shape))


def check_gradients_against_plain(norm, x: torch.Tensor, grad: torch.Tensor,
                                  silu: bool) -> dict:
    """A ``GroupNorm`` module's call as the training path makes it
    (``group_norm_silu(norm, x)`` or ``norm(x)`` under autograd, on an
    ``x`` that needs a gradient) against autograd through the plain
    halves: its result comes from ``GroupNormFn``, and the gradients of x
    and of the affine that needs one equal the plain ones bit for bit
    (``GroupNormFn.backward`` recomputes the plain halves).  Returns the
    readings and ``checks_ok``."""
    from .. import norms

    params = [t for t in (norm.weight, norm.bias) if t.requires_grad]
    leaf = x.detach().requires_grad_()
    with torch.enable_grad():
        out = (norms.group_norm_silu(norm, leaf) if silu else norm(leaf))
        node = type(out.grad_fn).__name__
        got = torch.autograd.grad(out, [leaf] + params, grad)
        xr = x.detach().requires_grad_()
        pr = [t.detach().requires_grad_() for t in params]
        w, b = (pr.pop(0) if t.requires_grad else t.detach()
                for t in (norm.weight, norm.bias))
        mean, rstd = norms.group_norm_moments_plain(xr, norm.num_groups,
                                                    norm.eps)
        want = norms.group_norm_apply_plain(xr, mean, rstd, w, b, silu)
        leaves = [xr] + [t for t in (w, b) if t.requires_grad]
        want = torch.autograd.grad(want, leaves, grad)
    unequal = [i for i, (g, h) in enumerate(zip(got, want))
               if not torch.equal(g, h)]
    return dict(grad_node=node, grads_unequal=len(unequal),
                grad_max_abs_err=max(float((g.float() - h.float()).abs().max())
                                     for g, h in zip(got, want)),
                checks_ok=node == "GroupNormFnBackward" and not unequal)
