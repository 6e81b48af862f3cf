"""K3 / K4 / K5: fused GEGLU feed-forward (CUDA C++, ``csrc/geglu_ff.cu``).

Replaces ``seervideoldm_tpu/ops/pallas/geglu_ff.py``:

- K5 ``geglu_ff``: (h * gelu(g)) W2 + b2 with [h; g] = x W1 + b1;
- K3 ``ln_geglu_ff``: x + FF(LN(x));
- K4 ``ln_geglu_ff_proj``: res + proj_out(x + FF(LN(x))), the whole
  transformer-site tail.

One kernel body with a compile-time mode covers all three, keeping the
TPU kernels' bf16 rounding points.  On the H100 it is tensor-core bound;
the weights the TPU kept resident in VMEM stream from L2 through shared
memory in 64-wide inner chunks (see the source note).

Weights are taken in torch Linear layout, ``(out, in)``: ``w1`` (2 * inner,
c) with rows [hidden | gate], ``w2`` (c, inner), ``w3`` (c, c).  The
wrappers run the plain versions for CPU tensors and the kernel for CUDA
tensors; there is no other path.  ``feed_forward`` is the FF site of the
shapes no kernel takes (the plain chain on either device).

Backward: the JAX package computes the GEGLU gradients outside any Pallas
kernel (an XLA chain rule that recomputes the intermediates from the saved
inputs, ``_bwd`` / ``_ln_bwd`` / ``_ln_proj_bwd``).  ``GegluFn`` does the
same in plain PyTorch: it saves the inputs only, re-runs the plain version
under autograd in ``backward``, and asks for the gradients of just those
inputs that need one, so a frozen site pays for no weight-gradient GEMM.
"""
from __future__ import annotations

import ctypes

import torch

from ..remat import needs_grad, saved_site
from . import build

LN_EPS = 1e-5  # ops/norms.LayerNorm default (torch parity)
# Site gates, the JAX package's (geglu_ff.py:42-63, 203-213): the weights
# must fit the per-kernel budget (c = 1280 stays plain), token counts tile
# by 256, and only c <= 320 takes the LN-fused forms.
W_BUDGET_BYTES = 12 * 1024 * 1024
LN_FUSE_MAX_C = 320


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
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    ln = (x32 - mean) / torch.sqrt(var + LN_EPS)
    return (ln * gamma.float() + beta.float()).to(x.dtype)


def ln_geglu_ff_plain(x, gamma, beta, w1, b1, w2, b2):
    """``_ln_reference``: fp32 LayerNorm island -> GEGLU FF -> residual."""
    return geglu_ff_plain(_layer_norm(x, gamma, beta), w1, b1, w2, b2) + x


def ln_geglu_ff_proj_plain(x, gamma, beta, w1, b1, w2, b2, w3, b3, res):
    """``_ln_proj_reference``: LN/FF/residual, then the 1x1 proj_out
    (fp32 accumulate, bf16 bias add) and the outer residual."""
    y = ln_geglu_ff_plain(x, gamma, beta, w1, b1, w2, b2)
    z = torch.matmul(y.float(), w3.to(y.dtype).float().t()).to(x.dtype)
    return (z + b3.to(x.dtype)) + res


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


def _launch(mode: int, x, gamma, beta, w1, b1, w2, b2, w3, b3, res):
    what = _NAMES[mode]
    n, c = x.shape
    inner = w2.shape[1]
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{what}: kernel takes bf16, got {x.dtype}")
    max_c = 704 if mode == 0 else LN_FUSE_MAX_C
    if c % 64 or c > max_c or n % 32 or inner % 64:
        raise ValueError(f"{what}: shape n={n} c={c} inner={inner} not covered")
    bf = lambda t: t.detach().to(torch.bfloat16).contiguous()  # noqa: E731
    f32 = lambda t: t.detach().to(torch.float32).contiguous()  # noqa: E731
    x = x.contiguous()
    args = [x, f32(gamma) if gamma is not None else None,
            f32(beta) if beta is not None else None, bf(w1), bf(b1), bf(w2),
            bf(b2), bf(w3) if w3 is not None else None,
            bf(b3) if b3 is not None else None,
            res.contiguous() if res is not None else None]
    out = torch.empty_like(x)
    lib = build.load("geglu_ff")
    fn = lib.svl_geglu_ff_fwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptrs = [build.ptr(a) if a is not None else None for a in args]
    code = fn(*ptrs, build.ptr(out), n, c, inner, LN_EPS, mode,
              build.stream_of(x))
    build.check(lib, code, what)
    _WRAPPERS[mode].launches += 1
    return out


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
