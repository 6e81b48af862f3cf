"""The port's kernel-holding modules (``seervideoldm_tpu_torch/ops/kernels``)
against the JAX package's Pallas kernels and references, on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version, so these pin
the arithmetic the CUDA kernels are held to on the card (``chip_smoke.py``
compares kernel and plain version there):

- K1 ``swat_attention_tables`` vs the JAX table kernel in interpret mode;
- K2 ``flash_attention`` vs the JAX flash kernel in interpret mode at
  n = m = 512, causal and not;
- K3-K5 vs ``_ln_reference`` / ``_ln_proj_reference`` / ``_reference`` and
  the JAX ``FeedForward``, ``_ln_ff_residual`` and site-tail chains with
  the fused branch forced, as ``tests/test_geglu_ff.py`` runs them.

fp32 inputs made from a seed with numpy; tolerances are stated per test
(fp32 summation-order differences only).  A CUDA-tensor wrapper never
falls back to the plain version: ``test_cuda_wrapper_raises_off_card``.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seervideoldm_tpu.ops.rotary import rotary_tables as jax_rotary_tables
from seervideoldm_tpu_torch.io.convert import load_jax_params
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


# ------------------------------------------------------------------ K1

@pytest.mark.parametrize("shape,ws,causal", [
    ((2, 3, 8, 8, 40), 8, True),
    ((1, 2, 16, 16, 16), 8, True),
    ((2, 2, 8, 8, 32), 4, True),
    ((1, 2, 8, 8, 16), 8, False),
])
def test_swat_tables_matches_jax_kernel(interpret, shape, ws, causal):
    _, f, h, w, d = shape
    q, k, v = (_rand(shape, s) for s in (0, 1, 2))
    jcos, jsin = jax_rotary_tables(f, h, w, d, min(32, d))
    want = np.asarray(jswat.swat_attention_tables(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcos, jsin,
        d ** -0.5, causal, ws))
    cos, sin = rotary_tables(f, h, w, d, min(32, d))
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)
    got = tsw.swat_attention_tables(_t(q), _t(k), _t(v), cos, sin,
                                    d ** -0.5, causal, ws)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)


def test_swat_tables_rejects_untiled_window():
    q = torch.zeros(1, 2, 12, 12, 8)
    cos, sin = rotary_tables(2, 12, 12, 8, 8)
    with pytest.raises(ValueError, match="h % ws"):
        tsw.swat_attention_tables(q, q, q, cos, sin, 1.0, True, 8)


# ------------------------------------------------------------------ K2

@pytest.mark.parametrize("causal", [False, True])
def test_flash_matches_jax_kernel(interpret, causal):
    q, k, v = (_rand((1, 2, 512, 40), s) for s in (3, 4, 5))
    want = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), 40 ** -0.5, causal))
    got = tfa.flash_attention(_t(q), _t(k), _t(v), 40 ** -0.5, causal)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


# --------------------------------------------------------------- K3-K5

def _ff_args(n, c, seed, proj=False):
    inner = 4 * c
    x = _rand((n, c), seed)
    gamma = 1.0 + _rand((c,), seed + 1, 0.1)
    beta = _rand((c,), seed + 2, 0.1)
    w1 = _rand((c, 2 * inner), seed + 3, c ** -0.5)   # JAX (in, out)
    b1 = _rand((2 * inner,), seed + 4, 0.1)
    w2 = _rand((inner, c), seed + 5, inner ** -0.5)
    b2 = _rand((c,), seed + 6, 0.1)
    out = dict(x=x, gamma=gamma, beta=beta, w1=w1, b1=b1, w2=w2, b2=b2)
    if proj:
        out.update(w3=_rand((c, c), seed + 7, c ** -0.5),
                   b3=_rand((c,), seed + 8, 0.1), res=_rand((n, c), seed + 9))
    return out


def _torch_w(a):
    """JAX (in, out) weights -> torch Linear (out, in)."""
    return _t(a["w1"]).t(), _t(a["b1"]), _t(a["w2"]).t(), _t(a["b2"])


def test_geglu_ff_matches_jax_reference():
    a = _ff_args(256, 64, 10)
    want = np.asarray(jgg._reference(*(jnp.asarray(a[k]) for k in
                                       ("x", "w1", "b1", "w2", "b2"))))
    got = tgg.geglu_ff(_t(a["x"]), *_torch_w(a))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)


def test_ln_geglu_ff_matches_jax_reference():
    a = _ff_args(256, 64, 20)
    want = np.asarray(jgg._ln_reference(*(jnp.asarray(a[k]) for k in (
        "x", "gamma", "beta", "w1", "b1", "w2", "b2"))))
    got = tgg.ln_geglu_ff(_t(a["x"]), _t(a["gamma"]), _t(a["beta"]),
                          *_torch_w(a))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)


def test_ln_geglu_ff_proj_matches_jax_reference():
    a = _ff_args(256, 64, 30, proj=True)
    want = np.asarray(jgg._ln_proj_reference(*(jnp.asarray(a[k]) for k in (
        "x", "gamma", "beta", "w1", "b1", "w2", "b2", "w3", "b3", "res"))))
    got = tgg.ln_geglu_ff_proj(_t(a["x"]), _t(a["gamma"]), _t(a["beta"]),
                               *_torch_w(a), _t(a["w3"]).t(), _t(a["b3"]),
                               _t(a["res"]))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)


def test_site_gates_match_jax():
    """The JAX site gates on the main path's 256 px shapes: c = 320 sites
    take the LN-fused forms, c = 640 the plain fused FF, c = 1280 stays
    plain (weight budget), and token counts must tile by 256."""
    x = torch.empty(1, dtype=torch.bfloat16, device="meta")
    assert tgg.ln_geglu_ff_preferred(24576, 320, 1280, x)
    assert not tgg.ln_geglu_ff_preferred(6144, 640, 2560, x)
    assert tgg.geglu_ff_supported(6144, 640, 2560, x)
    assert not tgg.geglu_ff_supported(1536, 1280, 5120, x)
    assert not tgg.geglu_ff_supported(24576 - 32, 320, 1280, x)
    assert not tgg.geglu_ff_supported(24576, 320, 1280, x.float())


def _force_jax_fused(monkeypatch):
    monkeypatch.setattr(jgg, "geglu_ff_supported", lambda *a, **k: True)
    monkeypatch.setattr(jgg, "ln_geglu_ff_proj_preferred", lambda *a, **k: True)
    monkeypatch.setattr(jgg, "geglu_ff", jgg._reference)
    monkeypatch.setattr(jgg, "ln_geglu_ff", jgg._ln_reference)
    monkeypatch.setattr(jgg, "ln_geglu_ff_proj", jgg._ln_proj_reference)


def test_feedforward_module_matches_jax(monkeypatch):
    from seervideoldm_tpu.models import transformer3d as jt3d
    from seervideoldm_tpu_torch.models.transformer3d import FeedForward

    _force_jax_fused(monkeypatch)
    x = _rand((2, 128, 64), 40)
    jff = jt3d.FeedForward(64)
    params = jff.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = np.asarray(jff.apply({"params": params}, jnp.asarray(x)))
    ff = load_jax_params(FeedForward(64), params)
    with torch.no_grad():
        got = ff(_t(x))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)


@pytest.mark.parametrize("cond_frame", [0, 1])
def test_temporal_site_chain_matches_jax(monkeypatch, cond_frame):
    """SpatialTransformer3D, temporal: the K4 site tail at cond_frame = 0,
    the K3 FF residual over the non-cond frames at cond_frame = 1, each
    with a non-zero proj_out so the tail's matmul counts."""
    import flax.traverse_util as tu

    from seervideoldm_tpu.models import transformer3d as jt3d
    from seervideoldm_tpu_torch.models.transformer3d import SpatialTransformer3D

    _force_jax_fused(monkeypatch)
    dim, heads, dh = 64, 4, 16
    x = _rand((1, 2, 16, 16, dim), 50)  # 512 tokens, 256 past one frame
    jst = jt3d.SpatialTransformer3D(in_channels=dim, n_heads=heads, d_head=dh,
                                    temporal=True, causal=True,
                                    cond_frame=cond_frame, norm_num_groups=8)
    params = jst.init(jax.random.PRNGKey(5), jnp.asarray(x))["params"]
    flat = tu.flatten_dict(jax.tree_util.tree_map(np.asarray, params))
    flat[("proj_out", "conv", "kernel")] = _rand((1, 1, dim, dim), 51, 0.2)
    params = tu.unflatten_dict(flat)
    want = np.asarray(jst.apply({"params": params}, jnp.asarray(x)))
    st = load_jax_params(SpatialTransformer3D(
        dim, heads, dh, temporal=True, causal=True, cond_frame=cond_frame,
        norm_num_groups=8), params)
    with torch.no_grad():
        got = st(_t(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_cuda_wrapper_raises_off_card():
    """A tensor that is not on the CPU never takes the plain version: off
    the card the wrapper raises instead of computing."""
    q = torch.empty(1, 2, 512, 40, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention(q, q, q, 0.1)
    x = torch.empty(256, 64, dtype=torch.bfloat16, device="meta")
    w1 = torch.empty(512, 64, dtype=torch.bfloat16, device="meta")
    w2 = torch.empty(64, 256, dtype=torch.bfloat16, device="meta")
    b = torch.empty(512, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tgg.geglu_ff(x, w1, b, w2, b[:64])
    # nor do the backward wrappers, or a forward that has to save for one
    lse = torch.empty(2, 512, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention_bwd(q[0], q[0], q[0], q[0], lse, q[0], 0.1)
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention(q.clone().requires_grad_(), q, q, 0.1)
    v5 = torch.empty(1, 2, 8, 8, 40, dtype=torch.bfloat16, device="meta")
    tab = torch.empty(2, 8, 8, 40, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tsw.swat_attention_tables(v5, v5, v5, tab, tab, 0.1, True, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        tsw.swat_attention_tables_bwd(v5, v5, v5, tab, tab, v5, tab[None, ..., 0],
                                      v5, 0.1, True, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        tgg.ln_geglu_ff(x.clone().requires_grad_(), b[:64].float(),
                        b[:64].float(), w1, b, w2, b[:64])
