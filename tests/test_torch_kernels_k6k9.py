"""K6 and K9 of the port (``ops/kernels/swat_attention.py``:
``swat_attention`` and ``swat_attention_bwd``, CUDA in
``csrc/swat_attention.cu``) through their plain versions on the CPU,
against the JAX package.

- ``swat_attention_plain`` vs ``_unfused_reference`` and
  ``swat_attention_bwd_plain`` vs its vjp, ``rot_dim`` 0 (q/k arrive
  rotated; dq and dk leave un-derotated) and 16 (rotation and its adjoint
  inside), causal and not: 2e-5 absolute (fp32, summation order);
- the wrapper and its ``autograd.Function`` on CPU tensors vs the Pallas
  kernel and its fused backward in interpret mode (``_INTERPRET``, as
  ``tests/test_swat_kernel.py`` runs them): same bound;
- the wrapper refuses what the kernel does not cover.

The CUDA launches themselves are held against these plain versions by the
``cuda``-marked cases of ``tests/test_torch_cuda.py`` and by
``chip_smoke.py``.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seervideoldm_tpu_torch.ops.kernels import swat_attention as K

jswat = importlib.import_module("seervideoldm_tpu.ops.pallas.swat_attention")

torch.set_num_threads(1)

SHAPE = (2, 3, 16, 16, 16)   # (B*H, f, h, w, d): 4 windows of 3 * 64 tokens
WS = 8


def _inputs(seed, shape=SHAPE):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(4)]


def _t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


@pytest.mark.parametrize("rot_dim", [0, 16])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_unfused_reference_and_vjp(rot_dim, causal):
    q, k, v, g = _inputs(1 + rot_dim + causal)
    scale = SHAPE[-1] ** -0.5
    fn = lambda q, k, v: jswat._unfused_reference(  # noqa: E731
        q, k, v, scale, causal, WS, rot_dim)
    want, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    got = K.swat_attention_plain(_t(q), _t(k), _t(v), scale, causal, WS,
                                 rot_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    grads = K.swat_attention_bwd_plain(_t(q), _t(k), _t(v), _t(g), scale,
                                       causal, WS, rot_dim)
    for name, got_g, want_g in zip("qkv", grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                                   atol=2e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("rot_dim", [0, 16])
def test_wrapper_and_function_match_pallas_interpret(monkeypatch, rot_dim):
    """The Pallas forward (``_swat_forward``) and fused backward
    (``_swat_backward``) in interpret mode vs the port's wrapper (forward)
    and ``SwatAttentionFn`` (its explicit backward on CPU tensors)."""
    monkeypatch.setattr(jswat, "_INTERPRET", True)
    shape = (1, 2, 16, 16, 16)
    q, k, v, g = _inputs(7 + rot_dim, shape)
    scale = shape[-1] ** -0.5
    fn = lambda q, k, v: jswat.swat_attention(  # noqa: E731
        q, k, v, scale, True, WS, rot_dim)
    want, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    got = K.swat_attention(_t(q), _t(k), _t(v), scale, True, WS, rot_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    tq, tk, tv = (_t(a, grad=True) for a in (q, k, v))
    out = K.SwatAttentionFn.apply(tq, tk, tv, scale, True, WS, rot_dim)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=2e-5)
    grads = torch.autograd.grad(out, (tq, tk, tv), _t(g))
    for name, got_g, want_g in zip("qkv", grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                                   atol=2e-5, err_msg=f"d{name}")


def test_autograd_through_the_wrapper_matches_the_function():
    q, k, v, g = _inputs(3)
    scale = SHAPE[-1] ** -0.5
    a = [_t(x, grad=True) for x in (q, k, v)]
    b = [_t(x, grad=True) for x in (q, k, v)]
    ga = torch.autograd.grad(K.swat_attention(*a, scale, True, WS, 16), a,
                             _t(g))
    gb = torch.autograd.grad(K.SwatAttentionFn.apply(*b, scale, True, WS, 16),
                             b, _t(g))
    for x, y in zip(ga, gb):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=2e-5)


def test_refuses_uncovered_shapes():
    q = torch.zeros(1, 2, 12, 16, 8)
    with pytest.raises(ValueError, match="h % ws == 0"):
        K.swat_attention(q, q, q, 1.0, True, WS, 0)
    with pytest.raises(ValueError, match="rot_dim"):
        K._check_cuda_k6(*(torch.zeros(1, 2, 16, 16, 8, dtype=torch.bfloat16)
                           for _ in range(3)), WS, 3, "swat_attention")
    with pytest.raises(ValueError, match="unsupported device"):
        K.swat_attention_bwd(q, q, q, q, q, q, 1.0, True, WS, 0)
    assert K._bwd_strip_width(24, 8) == 8 and K._bwd_strip_width(32, 8) == 16


def test_launch_counters_start_at_zero_on_the_cpu():
    q, k, v, _ = _inputs(5)
    before = (K.swat_attention.launches, K.swat_attention_bwd.launches)
    K.swat_attention(_t(q), _t(k), _t(v), 0.25, True, WS, 0)
    # the CPU path runs the plain version and counts no launch
    assert (K.swat_attention.launches, K.swat_attention_bwd.launches) == before
