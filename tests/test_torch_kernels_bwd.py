"""The backward of the port's kernel-holding modules against the JAX
package, on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version, so these pin
the arithmetic the backward CUDA kernels (K7, K8) are held to on the card
(``chip_smoke.py`` compares kernel and plain backward there):

- K8: ``flash_attention_bwd_plain`` vs ``_flash_backward`` (the Pallas
  kernel, interpret mode) and vs ``_bwd_einsum``;
- K7: ``swat_attention_tables_bwd_plain`` vs ``_swat_backward_tab``
  (interpret mode, including a multi-group causal case) and vs
  ``jax.vjp(_unfused_reference_tab)``;
- the explicit plain backwards equal ``torch.autograd.grad`` of the plain
  forwards, and both ``autograd.Function``s pass ``gradcheck`` in fp64;
- K3 / K4 / K5: ``GegluFn`` gradients vs ``jax.grad`` of ``ln_geglu_ff`` /
  ``ln_geglu_ff_proj`` / ``geglu_ff`` (their custom-vjp chain rules), with
  frozen inputs skipped.

fp32 inputs made from a seed with numpy; tolerances are stated per test.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seervideoldm_tpu.ops.rotary import rotary_tables as jax_rotary_tables
from seervideoldm_tpu_torch.ops.kernels import flash_attention as tfa
from seervideoldm_tpu_torch.ops.kernels import geglu_ff as tgg
from seervideoldm_tpu_torch.ops.kernels import swat_attention as tsw
from seervideoldm_tpu_torch.ops.rotary import rotary_tables

jswat = importlib.import_module("seervideoldm_tpu.ops.pallas.swat_attention")
jfa = importlib.import_module("seervideoldm_tpu.ops.pallas.flash_attention")
jgg = importlib.import_module("seervideoldm_tpu.ops.pallas.geglu_ff")

torch.set_num_threads(1)


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jswat, "_INTERPRET", True)
    monkeypatch.setattr(jfa, "_INTERPRET", True)


# ------------------------------------------------------------------ K8

FLASH_CASES = [((2, 512, 40), (2, 512, 40), False),
               ((2, 512, 40), (2, 512, 40), True),
               ((2, 200, 40), (2, 136, 40), False)]


@pytest.mark.parametrize("qs,ks,causal", FLASH_CASES)
def test_flash_bwd_plain_matches_jax_kernel(interpret, qs, ks, causal):
    """vs the Pallas backward in interpret mode: atol 5e-5 (fp32, the
    kernel's blockwise sums)."""
    q, k, v, g = _rand(qs, 0), _rand(ks, 1), _rand(ks, 2), _rand(qs, 3)
    scale = qs[-1] ** -0.5
    want = jfa._flash_backward(*(jnp.asarray(a) for a in (q, k, v, g)),
                               scale, causal)
    got = tfa.flash_attention_bwd_plain(_t(q), _t(k), _t(v), _t(g), scale,
                                        causal)
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5,
                                   err_msg=name)


@pytest.mark.parametrize("qs,ks,causal", FLASH_CASES)
def test_flash_bwd_plain_matches_jax_einsum(qs, ks, causal):
    q, k, v, g = _rand(qs, 4), _rand(ks, 5), _rand(ks, 6), _rand(qs, 7)
    scale = qs[-1] ** -0.5
    want = jfa._bwd_einsum(scale, causal,
                           tuple(jnp.asarray(a) for a in (q, k, v)),
                           jnp.asarray(g))
    got = tfa.flash_attention_bwd_plain(_t(q), _t(k), _t(v), _t(g), scale,
                                        causal)
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_plain_equals_autograd_of_plain_forward(causal):
    q, k, v = (_t(_rand((3, 96, 24), s)).requires_grad_() for s in (8, 9, 10))
    g = _t(_rand((3, 96, 24), 11))
    out = tfa.flash_attention_plain(q, k, v, 0.2, causal)
    want = torch.autograd.grad(out, (q, k, v), g)
    got = tfa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), g,
                                        0.2, causal)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-6)


@pytest.mark.parametrize("causal,m", [(False, 24), (True, 40), (False, 40)])
def test_flash_function_gradcheck(causal, m):
    """The ``autograd.Function`` of the CUDA path, driven on the CPU in
    fp64: saved tensors, ``needs_input_grad`` and the None returns."""
    mk = lambda n, s: torch.from_numpy(  # noqa: E731
        np.random.RandomState(s).randn(2, n, 8)).requires_grad_()
    q, k, v = mk(40, 0), mk(m, 1), mk(m, 2)
    fn = lambda a, b, c: tfa.FlashAttentionFn.apply(a, b, c, 0.3, causal)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (q, k, v))
    # an input that needs no gradient gets none
    out = tfa.FlashAttentionFn.apply(q, k.detach(), v, 0.3, causal)
    dq, dv = torch.autograd.grad(out.sum(), (q, v))
    assert dq.shape == q.shape and dv.shape == v.shape
    with pytest.raises(ValueError, match="causal needs n == m"):
        tfa.FlashAttentionFn.apply(q, mk(24, 3), mk(24, 4), 0.3, True)


# ------------------------------------------------------------------ K7

SWAT_CASES = [((2, 3, 8, 8, 40), 8, True), ((1, 2, 16, 16, 16), 8, True),
              ((2, 2, 8, 8, 32), 4, True), ((1, 2, 8, 8, 16), 8, False)]


def _swat_inputs(shape, seed):
    _, f, h, w, d = shape
    q, k, v, g = (_rand(shape, seed + i) for i in range(4))
    jtabs = jax_rotary_tables(f, h, w, d, min(32, d))
    tabs = rotary_tables(f, h, w, d, min(32, d))
    return q, k, v, g, jtabs, tabs


def _check_swat(got, want, atol):
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("shape,ws,causal", SWAT_CASES)
def test_swat_bwd_plain_matches_jax_kernel(interpret, shape, ws, causal):
    """vs the Pallas table backward in interpret mode: atol 1e-4 (fp32;
    the kernel recomputes the softmax per causal frame group)."""
    q, k, v, g, jtabs, tabs = _swat_inputs(shape, 20)
    scale = shape[-1] ** -0.5
    want = jswat._swat_backward_tab(*(jnp.asarray(a) for a in (q, k, v)),
                                    *jtabs, jnp.asarray(g), scale, causal, ws)
    got = tsw.swat_attention_tables_bwd_plain(_t(q), _t(k), _t(v), *tabs,
                                              _t(g), scale, causal, ws)
    _check_swat(got, want, 1e-4)


def test_swat_bwd_plain_matches_jax_kernel_multigroup(interpret, monkeypatch):
    """f = 9 frames at ws 4 with ``_GROUP_ROWS`` pinned to 128 forces several
    causal frame groups (prefix dk/dv accumulation) in the Pallas backward."""
    monkeypatch.setattr(jswat, "_GROUP_ROWS", 128)
    shape, ws = (1, 9, 4, 8, 16), 4
    q, k, v, g, jtabs, tabs = _swat_inputs(shape, 30)
    want = jswat._swat_backward_tab(*(jnp.asarray(a) for a in (q, k, v)),
                                    *jtabs, jnp.asarray(g), 0.25, True, ws)
    got = tsw.swat_attention_tables_bwd_plain(_t(q), _t(k), _t(v), *tabs,
                                              _t(g), 0.25, True, ws)
    _check_swat(got, want, 1e-4)


@pytest.mark.parametrize("shape,ws,causal", SWAT_CASES)
def test_swat_bwd_plain_matches_jax_vjp_of_reference(shape, ws, causal):
    q, k, v, g, jtabs, tabs = _swat_inputs(shape, 40)
    scale = shape[-1] ** -0.5
    _, vjp = jax.vjp(
        lambda a, b, c: jswat._unfused_reference_tab(a, b, c, *jtabs, scale,
                                                     causal, ws),
        *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g))
    got = tsw.swat_attention_tables_bwd_plain(_t(q), _t(k), _t(v), *tabs,
                                              _t(g), scale, causal, ws)
    _check_swat(got, want, 5e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_swat_bwd_plain_equals_autograd_of_plain_forward(causal):
    shape = (2, 3, 8, 8, 16)
    q, k, v = (_t(_rand(shape, s)).requires_grad_() for s in (50, 51, 52))
    g = _t(_rand(shape, 53))
    cos, sin = rotary_tables(3, 8, 8, 16, 8)
    out = tsw.swat_attention_tables_plain(q, k, v, cos, sin, 0.25, causal, 4)
    want = torch.autograd.grad(out, (q, k, v), g)
    got = tsw.swat_attention_tables_bwd_plain(
        q.detach(), k.detach(), v.detach(), cos, sin, g, 0.25, causal, 4)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_swat_function_gradcheck(causal):
    shape = (1, 2, 4, 4, 8)
    q, k, v = (torch.from_numpy(np.random.RandomState(s).randn(*shape))
               .requires_grad_() for s in (60, 61, 62))
    cos, sin = (t.double() for t in rotary_tables(2, 4, 4, 8, 4))
    fn = lambda a, b, c: tsw.SwatAttentionTablesFn.apply(  # noqa: E731
        a, b, c, cos, sin, 0.35, causal, 4)
    assert torch.autograd.gradcheck(fn, (q, k, v))
    out = tsw.SwatAttentionTablesFn.apply(q.detach(), k, v, cos, sin, 0.35,
                                          causal, 4)
    dk, dv = torch.autograd.grad(out.sum(), (k, v))
    assert dk.shape == dv.shape == torch.Size(shape)


# --------------------------------------------------------------- K3-K5

def _ff_args(n, c, seed):
    inner = 4 * c
    return dict(
        x=_rand((n, c), seed), gamma=1.0 + _rand((c,), seed + 1, 0.1),
        beta=_rand((c,), seed + 2, 0.1),
        w1=_rand((c, 2 * inner), seed + 3, c ** -0.5),  # JAX (in, out)
        b1=_rand((2 * inner,), seed + 4, 0.1),
        w2=_rand((inner, c), seed + 5, inner ** -0.5),
        b2=_rand((c,), seed + 6, 0.1), w3=_rand((c, c), seed + 7, c ** -0.5),
        b3=_rand((c,), seed + 8, 0.1), res=_rand((n, c), seed + 9))


GEGLU_MODES = {
    0: ("geglu_ff", ("x", "w1", "b1", "w2", "b2")),
    1: ("ln_geglu_ff", ("x", "gamma", "beta", "w1", "b1", "w2", "b2")),
    2: ("ln_geglu_ff_proj", ("x", "gamma", "beta", "w1", "b1", "w2", "b2",
                             "w3", "b3", "res")),
}
ORDER = ("x", "gamma", "beta", "w1", "b1", "w2", "b2", "w3", "b3", "res")
TRANSPOSED = ("w1", "w2", "w3")  # JAX (in, out) <-> torch Linear (out, in)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_geglu_function_gradients_match_jax(mode):
    """``GegluFn`` (recomputation through the plain version) vs ``jax.grad``
    of the JAX function, whose custom vjp is the package's chain rule:
    rtol 2e-4, atol 2e-5 (the JAX tests' own tolerance for that chain)."""
    fname, keys = GEGLU_MODES[mode]
    a = _ff_args(64, 16, 70 + mode)
    jfn = getattr(jgg, fname)
    want = jax.grad(lambda *xs: jnp.sum(jnp.sin(jfn(*xs))),
                    argnums=tuple(range(len(keys))))(
        *(jnp.asarray(a[k]) for k in keys))
    tens = {k: (_t(a[k]).t().contiguous() if k in TRANSPOSED else _t(a[k]))
            .requires_grad_() for k in keys}
    out = tgg.GegluFn.apply(mode, *(tens.get(k) for k in ORDER))
    got = torch.autograd.grad(torch.sin(out).sum(), [tens[k] for k in keys])
    for k, gt, gj in zip(keys, got, want):
        gj = np.asarray(gj).T if k in TRANSPOSED else np.asarray(gj)
        np.testing.assert_allclose(gt.numpy(), gj, rtol=2e-4, atol=2e-5,
                                   err_msg=k)


def test_geglu_function_skips_frozen_inputs():
    """A frozen site (weights without ``requires_grad``) still passes the
    gradient to x, equal to the all-trainable case, and asks autograd for
    nothing else."""
    a = _ff_args(64, 16, 90)
    mk = lambda k, grad: (_t(a[k]).t().contiguous() if k in TRANSPOSED  # noqa: E731
                          else _t(a[k])).requires_grad_(grad)
    keys = GEGLU_MODES[1][1]
    full = {k: mk(k, True) for k in keys}
    frozen = {k: mk(k, k == "x") for k in keys}
    g = _t(_rand((64, 16), 91))
    dx_full = torch.autograd.grad(
        tgg.GegluFn.apply(1, *(full.get(k) for k in ORDER)), full["x"], g)[0]
    out = tgg.GegluFn.apply(1, *(frozen.get(k) for k in ORDER))
    out.backward(g)
    assert torch.equal(frozen["x"].grad, dx_full)
    assert all(frozen[k].grad is None for k in keys if k != "x")


def test_cpu_wrappers_stay_differentiable():
    """On CPU tensors the wrappers call the plain versions directly and
    autograd differentiates them: the result carries a ``grad_fn``."""
    q = _t(_rand((1, 2, 512, 8), 95)).requires_grad_()
    assert tfa.flash_attention(q, q, q, 0.3).grad_fn is not None
    x = _t(_rand((1, 2, 8, 8, 8), 96)).requires_grad_()
    cos, sin = rotary_tables(2, 8, 8, 8, 8)
    assert tsw.swat_attention_tables(x, x, x, cos, sin, 0.3, True,
                                     8).grad_fn is not None
    a = _ff_args(256, 16, 97)
    xin = _t(a["x"]).requires_grad_()
    out = tgg.geglu_ff(xin, _t(a["w1"]).t(), _t(a["b1"]), _t(a["w2"]).t(),
                       _t(a["b2"]))
    assert out.grad_fn is not None
