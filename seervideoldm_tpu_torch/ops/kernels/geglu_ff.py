"""K3 / K4 / K5: the GEGLU feed-forward (CUDA C++, ``csrc/geglu_ff.cu``).

Replaces ``seervideoldm_tpu/ops/pallas/geglu_ff.py``:

- K5 ``geglu_ff``: (h * gelu(g)) W2 + b2 with [h; g] = x W1 + b1;
- K3 ``ln_geglu_ff``: x + FF(LN(x));
- K4 ``ln_geglu_ff_proj``: res + proj_out(x + FF(LN(x))), the whole
  transformer-site tail.

On the H100 each is two GEMM kernels (wgmma fed by a TMA ring; see the
source note), launched back to back on the current stream: the up kernel
writes ``a = bf16(h * gelu(g))`` (n, inner), with the LayerNorm of modes 1
and 2 as its prologue, and the down kernel reads it back and applies the
epilogue of the mode (+ b2, + x, and for K4 the proj_out tail).  The split
keeps the TPU kernels' bf16 rounding points: ``a`` is rounded to bf16 there
too.  ``geglu_up_plain`` / ``geglu_down_plain`` are the two halves' plain
versions (their composition is the plain version of each mode, bit for
bit), ``geglu_up`` / ``geglu_down`` run one half alone (the card checks
hold each against its plain version), and ``plan`` picks the column tiles
per shape.  One call of a public wrapper is one launch in its counter,
although it makes two CUDA launches: the counters count site calls, as the
per-step launch counts of the main paths expect.

Weights are taken in torch Linear layout, ``(out, in)``: ``w1`` (2 * inner,
c) with rows [hidden | gate], ``w2`` (c, inner), ``w3`` (c, c).  The
wrappers run the plain versions for CPU tensors and the kernels for CUDA
tensors; there is no other path, and a CUDA shape the kernels do not cover
(``covers``) raises.  ``feed_forward`` is the FF site of the shapes no
kernel takes (the plain chain on either device).

Backward: the JAX package computes the GEGLU gradients outside any Pallas
kernel (an XLA chain rule that recomputes the intermediates from the saved
inputs, ``_bwd`` / ``_ln_bwd`` / ``_ln_proj_bwd``).  ``GegluFn`` does the
same in plain PyTorch: it saves the inputs only, re-runs the plain version
under autograd in ``backward``, and asks for the gradients of just those
inputs that need one, so a frozen site pays for no weight-gradient GEMM.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..remat import needs_grad, saved_site
from . import build

LN_EPS = 1e-5  # ops/norms.LayerNorm default (torch parity)
# Site gates, the JAX package's (geglu_ff.py:42-63, 203-213): the weights
# must fit the per-kernel budget (c = 1280 stays plain), token counts tile
# by 256, and only c <= 320 takes the LN-fused forms.
W_BUDGET_BYTES = 12 * 1024 * 1024
LN_FUSE_MAX_C = 320
# What the CUDA kernels cover (csrc/geglu_ff.cu): 128-token tiles, 64-wide
# k chunks; c <= 704 for mode 0 (the weight budget's widest c), <= 320 for
# the LN modes (the A panel kept in shared memory).
TILE_M, TILE_K, KERNEL_MAX_C = 128, 64, 704
DOWN_TILES = (64, 128, 320)   # column tiles of the down kernel, modes 0, 1
SMS = 132                     # H100 SXM streaming multiprocessors
UP_FIXED, UP_FIXED_LN = 0.6, 1.35   # an up CTA's fixed cost, in tiles (plan)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x, approximate="none")


def geglu_ff_plain(x, w1, b1, w2, b2):
    """``_reference`` with the rounding points of the TPU kernel's
    ``_ff_core``: matmuls in x's dtype with fp32 accumulation, bias adds in
    x's dtype, ``a = h * gelu(g)`` in fp32 (exact erf) rounded once."""
    inner = w2.shape[1]
    pre = torch.matmul(x, w1.t()).to(x.dtype) + b1.to(x.dtype)
    h, g = pre[..., :inner], pre[..., inner:]
    a = (h.float() * _gelu(g.float())).to(x.dtype)
    return torch.matmul(a, w2.t()).to(x.dtype) + b2.to(x.dtype)


def _layer_norm(x, gamma, beta):
    """The LayerNorm of the TPU kernels' prologue, ``cen * rsqrt(var +
    eps)``, with the rounding points the CUDA up kernel keeps: the mean and
    the centred variance summed in fp64 (exact for bf16 inputs, so the
    order of the sums does not matter) and rounded once to fp32; then in
    fp32, each step correctly rounded, cen = x - mean, rsd = 1 / sqrt(var +
    eps), ((cen * rsd) * gamma) + beta, one rounding to x's dtype."""
    x32 = x.float()
    c = x.shape[-1]
    mean = (x32.double().sum(dim=-1, keepdim=True) / c).float()
    cen = x32 - mean
    var = ((cen.double() * cen.double()).sum(dim=-1, keepdim=True)
           / c).float()
    rsd = torch.sqrt(var + LN_EPS).reciprocal()
    return (cen * rsd * gamma.float() + beta.float()).to(x.dtype)


def ln_geglu_ff_plain(x, gamma, beta, w1, b1, w2, b2):
    """``_ln_reference``: fp32 LayerNorm island -> GEGLU FF -> residual."""
    return geglu_ff_plain(_layer_norm(x, gamma, beta), w1, b1, w2, b2) + x


def ln_geglu_ff_proj_plain(x, gamma, beta, w1, b1, w2, b2, w3, b3, res):
    """``_ln_proj_reference``: LN/FF/residual, then the 1x1 proj_out
    (fp32 accumulate, bf16 bias add) and the outer residual."""
    y = ln_geglu_ff_plain(x, gamma, beta, w1, b1, w2, b2)
    z = torch.matmul(y.float(), w3.to(y.dtype).float().t()).to(x.dtype)
    return (z + b3.to(x.dtype)) + res


def geglu_up_plain(x, gamma, beta, w1, b1, ln):
    """The up kernel's plain version: ``a = bf16(h * gelu(g))`` with
    ``[h; g] = P(x) W1 + b1``, P the LayerNorm if ``ln`` else the identity;
    the rounding points of ``geglu_ff_plain``."""
    if ln:
        x = _layer_norm(x, gamma, beta)
    inner = w1.shape[0] // 2
    pre = torch.matmul(x, w1.t()).to(x.dtype) + b1.to(x.dtype)
    h, g = pre[..., :inner], pre[..., inner:]
    return (h.float() * _gelu(g.float())).to(x.dtype)


def geglu_down_plain(a, w2, b2, x, w3, b3, res, mode):
    """The down kernel's plain version: ``bf16(a W2) + b2``; mode 1 adds
    ``x``; mode 2 adds ``x`` and applies the proj_out tail (fp32
    accumulate, bf16 bias add, + ``res``)."""
    out = torch.matmul(a, w2.t()).to(a.dtype) + b2.to(a.dtype)
    if mode == 0:
        return out
    y = out + x
    if mode == 1:
        return y
    z = torch.matmul(y.float(), w3.to(y.dtype).float().t()).to(x.dtype)
    return (z + b3.to(x.dtype)) + res


def covers(mode: int, n: int, c: int, inner: int) -> bool:
    """Whether the CUDA kernels of ``mode`` take (n, c, inner): n a
    multiple of 128, c and inner of 64, c <= 704 (mode 0) or 320."""
    max_c = KERNEL_MAX_C if mode == 0 else LN_FUSE_MAX_C
    return (n > 0 and n % TILE_M == 0 and 0 < c <= max_c and c % 64 == 0
            and inner > 0 and inner % TILE_K == 0)


@functools.lru_cache(maxsize=None)
def plan(n: int, c: int, inner: int, mode: int) -> dict:
    """Column tiles of the two kernels for one covered shape.  Up: tiles
    of 128 columns of ``a`` (64 when inner % 128 != 0); a CTA takes ``t``
    neighbouring tiles of one row block, the divisor of the tile count with
    the least ceil(CTAs / SMs) * (t + f): waves times a CTA's time in tiles
    plus its fixed cost f, the ring's first fill and the epilogue (0.6 of a
    tile), and for the LN modes the LayerNorm of its rows (1.35), which it
    then pays once for all its tiles (f fitted to the sweep of every t at
    the main-path shapes on an H100, PERF.md).  Down: whole rows (c) for
    mode 2; else the widest tile of ``DOWN_TILES`` dividing c that still
    gives every SM a CTA, or the narrowest if none does (the sweep's best
    or within 6 % of it at every main-path shape, PERF.md)."""
    up = 128 if inner % 128 == 0 else 64
    rows, cols = n // TILE_M, inner // up
    fixed = UP_FIXED_LN if mode else UP_FIXED
    tiles = min((t for t in range(1, cols + 1) if cols % t == 0),
                key=lambda t: -(-rows * (cols // t) // SMS) * (t + fixed))
    fits = [bn for bn in DOWN_TILES if c % bn == 0]
    full = [bn for bn in fits if rows * (c // bn) >= SMS]
    down = c if mode == 2 else max(full) if full else min(fits)
    return {"up_bn": up, "up_tiles": tiles, "down_bn": down,
            "up_ctas": rows * (cols // tiles), "down_ctas": rows * (c // down)}


def geglu_ff_supported(n: int, c: int, inner: int, x: torch.Tensor) -> bool:
    """The site gate of ``geglu_ff.py::geglu_ff_supported``: bf16 (any
    dtype for a CPU tensor, which takes the plain version), inner % 256 ==
    0, n % 256 == 0, weights within the budget."""
    if x.device.type != "cpu" and x.dtype != torch.bfloat16:
        return False
    if inner % 256 or n % 256:
        return False
    return (c * 2 * inner + inner * c) * 2 <= W_BUDGET_BYTES


def ln_geglu_ff_preferred(n: int, c: int, inner: int, x: torch.Tensor) -> bool:
    """LN-fused forms only at c <= 320 (the JAX measured channel gate)."""
    return c <= LN_FUSE_MAX_C and geglu_ff_supported(n, c, inner, x)


def feed_forward_plain(x, w1, b1, w2, b2):
    """The FeedForward modules' own chain (``models/transformer3d.py``
    GEGLU + Linear): Linear -> hidden * gelu(gate) (exact erf) -> Linear,
    in x's dtype; the FF site where no kernel takes the shape."""
    hidden, gate = torch.nn.functional.linear(x, w1, b1).chunk(2, dim=-1)
    return torch.nn.functional.linear(hidden * _gelu(gate), w2, b2)


_PLAIN = {0: lambda x, gamma, beta, w1, b1, w2, b2, w3, b3, res:
          geglu_ff_plain(x, w1, b1, w2, b2),
          1: lambda x, gamma, beta, w1, b1, w2, b2, w3, b3, res:
          ln_geglu_ff_plain(x, gamma, beta, w1, b1, w2, b2),
          2: ln_geglu_ff_proj_plain,
          3: lambda x, gamma, beta, w1, b1, w2, b2, w3, b3, res:
          feed_forward_plain(x, w1, b1, w2, b2)}
_NAMES = {0: "geglu_ff", 1: "ln_geglu_ff", 2: "ln_geglu_ff_proj",
          3: "feed_forward"}
KERNEL_MODES = (0, 1, 2)   # mode 3 is the plain chain on every device


_LIB = None


def _lib():
    """The loaded ``csrc/geglu_ff.cu`` library, its C signatures set once."""
    global _LIB
    if _LIB is None:
        lib = build.load("geglu_ff")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.svl_geglu_up.argtypes = [ptr] * 6 + [i32] * 3 + [
            ctypes.c_float, i32, i32, i32, ptr]
        lib.svl_geglu_up.restype = i32
        lib.svl_geglu_down.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
        lib.svl_geglu_down.restype = i32
        _LIB = lib
    return _LIB


def _as(t, dtype):
    """``t`` as a contiguous ``dtype`` tensor, itself when it already is
    one (no dispatch: the wrappers' host time is on the sampling path)."""
    if t is None or (t.dtype == dtype and t.is_contiguous()):
        return t
    return t.detach().to(dtype).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(what: str, mode: int, x, n: int, c: int, inner: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{what}: kernel takes bf16, got {x.dtype}")
    if not covers(mode, n, c, inner):
        raise ValueError(f"{what}: shape n={n} c={c} inner={inner} not "
                         "covered (n % 128, c % 64, inner % 64 == 0; c <= "
                         f"{KERNEL_MAX_C if mode == 0 else LN_FUSE_MAX_C})")


def _up_launch(what, x, gamma, beta, w1, b1, ln: bool, bn: int, tiles: int,
               stream):
    n, c = x.shape
    inner = w1.shape[0] // 2
    bf, f32 = torch.bfloat16, torch.float32
    x, gamma, beta = _as(x, bf), _as(gamma, f32), _as(beta, f32)
    w1, b1 = _as(w1, bf), _as(b1, bf)
    a = torch.empty(n, inner, dtype=bf, device=x.device)
    lib = _lib()
    code = lib.svl_geglu_up(x.data_ptr(), _ptr(gamma), _ptr(beta),
                            w1.data_ptr(), b1.data_ptr(), a.data_ptr(), n, c,
                            inner, LN_EPS, int(ln), bn, tiles, stream)
    build.check(lib, code, what)
    return a


def _down_launch(what, a, w2, b2, x, w3, b3, res, mode: int, bn: int,
                 stream):
    n, inner = a.shape
    c = w2.shape[0]
    bf = torch.bfloat16
    a, w2, b2, x = _as(a, bf), _as(w2, bf), _as(b2, bf), _as(x, bf)
    w3, b3, res = _as(w3, bf), _as(b3, bf), _as(res, bf)
    out = torch.empty(n, c, dtype=bf, device=a.device)
    lib = _lib()
    code = lib.svl_geglu_down(a.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                              _ptr(x), _ptr(w3), _ptr(b3), _ptr(res),
                              out.data_ptr(), n, c, inner, mode, bn, stream)
    build.check(lib, code, what)
    return out


def _launch(mode: int, x, gamma, beta, w1, b1, w2, b2, w3, b3, res):
    what = _NAMES[mode]
    n, c = x.shape
    inner = w2.shape[1]
    _check(what, mode, x, n, c, inner)
    p = plan(n, c, inner, mode)
    stream = build.stream_of(x)
    a = _up_launch(what, x, gamma, beta, w1, b1, mode > 0, p["up_bn"],
                   p["up_tiles"], stream)
    out = _down_launch(what, a, w2, b2, x, w3, b3, res, mode, p["down_bn"],
                       stream)
    _WRAPPERS[mode].launches += 1
    return out


def geglu_up(x, gamma, beta, w1, b1, ln: bool):
    """The up kernel alone (its plain version for a CPU tensor): ``a``
    (n, inner).  Not a site: it counts no launch."""
    if x.device.type == "cpu":
        return geglu_up_plain(x, gamma, beta, w1, b1, ln)
    n, c = x.shape
    inner = w1.shape[0] // 2
    _check("geglu_up", int(ln), x, n, c, inner)
    p = plan(n, c, inner, int(ln))
    return _up_launch("geglu_up", x, gamma, beta, w1, b1, ln, p["up_bn"],
                      p["up_tiles"], build.stream_of(x))


def geglu_down(a, w2, b2, x, w3, b3, res, mode: int):
    """The down kernel alone (its plain version for a CPU tensor): (n, c)
    from ``a``.  Not a site: it counts no launch."""
    if a.device.type == "cpu":
        return geglu_down_plain(a, w2, b2, x, w3, b3, res, mode)
    n, inner = a.shape
    c = w2.shape[0]
    _check("geglu_down", mode, a, n, c, inner)
    return _down_launch("geglu_down", a, w2, b2, x, w3, b3, res, mode,
                        plan(n, c, inner, mode)["down_bn"],
                        build.stream_of(a))


def _compute(mode: int, *tensors):
    """The kernel for CUDA tensors in a kernel mode, else the plain
    version."""
    if tensors[0].device.type == "cuda" and mode in KERNEL_MODES:
        return _launch(mode, *tensors)
    return _PLAIN[mode](*tensors)


class GegluFn(torch.autograd.Function):
    """The kernel's forward (the plain version for CPU tensors and for the
    plain chain, mode 3) with a plain-PyTorch backward by recomputation
    from the saved inputs.  The forward's output is a saved site under
    ``remat: save_attn`` (``ops/remat.py``)."""

    @staticmethod
    def forward(ctx, mode, *tensors):
        ctx.mode = mode
        ctx.save_for_backward(*tensors)
        return saved_site(lambda: (_compute(mode, *tensors),))[0]

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(keep)
                      for t, keep in zip(ctx.saved_tensors, need)]
            out = _PLAIN[ctx.mode](*inputs)
            wanted = [t for t, keep in zip(inputs, need) if keep]
            grads = iter(torch.autograd.grad(out, wanted, g))
        return (None, *(next(grads) if keep else None for keep in need))


def _run(mode: int, *tensors):
    """One FF site: through ``GegluFn`` when a gradient is needed, a saved
    site either way."""
    if mode in KERNEL_MODES and tensors[0].device.type not in ("cpu",
                                                              "cuda"):
        raise ValueError(f"{_NAMES[mode]}: unsupported device "
                         f"{tensors[0].device}")
    if needs_grad(*tensors):
        return GegluFn.apply(mode, *tensors)
    return saved_site(lambda: (_compute(mode, *tensors),))[0]


def geglu_ff(x, w1, b1, w2, b2):
    """(n, c) -> (n, c): (h * gelu(g)) W2 + b2, [h; g] = x W1 + b1."""
    return _run(0, x, None, None, w1, b1, w2, b2, None, None, None)


def ln_geglu_ff(x, gamma, beta, w1, b1, w2, b2):
    """(n, c) -> (n, c): x + FF(LN(x)); gamma/beta the LayerNorm affine."""
    return _run(1, x, gamma, beta, w1, b1, w2, b2, None, None, None)


def ln_geglu_ff_proj(x, gamma, beta, w1, b1, w2, b2, w3, b3, res):
    """(n, c) -> (n, c): res + (y W3 + b3), y = x + FF(LN(x)); w3 the
    site's 1x1 proj_out as (c_out, c_in), res the outer residual."""
    return _run(2, x, gamma, beta, w1, b1, w2, b2, w3, b3, res)


def feed_forward(x, w1, b1, w2, b2):
    """(..., c) -> (..., c): the plain FF chain as a site (the shapes no
    kernel takes)."""
    return _run(3, x, None, None, w1, b1, w2, b2, None, None, None)


_WRAPPERS = {0: geglu_ff, 1: ln_geglu_ff, 2: ln_geglu_ff_proj}
geglu_ff.launches = 0
ln_geglu_ff.launches = 0
ln_geglu_ff_proj.launches = 0
