"""The port's ops and small model modules against the JAX package, on the
CPU in fp32: rotary, windows, norms, the inflated conv, attention (the
einsum branch, CrossAttention, WindowTemporalAttention on its table-kernel,
windowed-einsum and full-frame paths), timestep embeddings and the 3D
ResNet blocks.  Inputs are made from a seed with numpy; the JAX weights are
carried across by ``io/convert.py``.  Tolerances are stated per test.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seervideoldm_tpu.models import embeddings as jemb
from seervideoldm_tpu.models import resnet3d as jres
from seervideoldm_tpu.ops import attention as jattn
from seervideoldm_tpu.ops import conv as jconv
from seervideoldm_tpu.ops import norms as jnorms
from seervideoldm_tpu.ops import rotary as jrot
from seervideoldm_tpu.ops import windows as jwin
from seervideoldm_tpu_torch.io.convert import load_jax_params
from seervideoldm_tpu_torch.models import embeddings as temb
from seervideoldm_tpu_torch.models import resnet3d as tres
from seervideoldm_tpu_torch.ops import attention as tattn
from seervideoldm_tpu_torch.ops import conv as tconv
from seervideoldm_tpu_torch.ops import norms as tnorms
from seervideoldm_tpu_torch.ops import rotary as trot
from seervideoldm_tpu_torch.ops import windows as twin

jswat = importlib.import_module("seervideoldm_tpu.ops.pallas.swat_attention")

torch.set_num_threads(1)


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _parity(jmod, tmod, *inputs, atol, init_inputs=None, **call_kw):
    """Init ``jmod`` from a fixed key, carry its params into ``tmod``, run
    both on the numpy ``inputs`` and compare."""
    jin = [jnp.asarray(x) for x in inputs]
    params = jmod.init(jax.random.PRNGKey(0), *jin, **call_kw)["params"]
    want = np.asarray(jmod.apply({"params": params}, *jin, **call_kw))
    load_jax_params(tmod, jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        got = tmod(*(_t(x) for x in inputs), **call_kw)
    np.testing.assert_allclose(got.numpy(), want, atol=atol)


# ---------------------------------------------------------------- rotary

def test_rotary_freqs_and_tables_match():
    pos = np.arange(37)
    np.testing.assert_allclose(
        trot.rotary_freqs(torch.arange(37), 16).numpy(),
        np.asarray(jrot.rotary_freqs(jnp.asarray(pos), 16)), rtol=1e-6)
    for a, b in zip(trot.rotary_tables(3, 4, 8, 40, 32),
                    jrot.rotary_tables(3, 4, 8, 40, 32)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("d", [8, 40])
def test_apply_rotary_matches(d):
    t = _rand((2, 3, 24, d), 0)
    rot = min(32, d)
    want = jrot.apply_rotary(jnp.asarray(t), jrot.rotary_freqs(jnp.arange(24), rot))
    got = trot.apply_rotary(_t(t), trot.rotary_freqs(torch.arange(24), rot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# --------------------------------------------------------------- windows

@pytest.mark.parametrize("h", [4, 8, 16, 32, 64])
def test_select_window_size_matches(h):
    assert twin.select_window_size(h) == jwin.select_window_size(h)


@pytest.mark.parametrize("ws", [4, 8])
def test_window_partition_roundtrip_matches(ws):
    x = _rand((2, 3, 16, 8, 5), 1)
    want = np.asarray(jwin.window_partition(jnp.asarray(x), ws))
    got = twin.window_partition(_t(x), ws)
    np.testing.assert_array_equal(got.numpy(), want)
    back = twin.window_reverse(got, ws, 3, 16, 8)
    np.testing.assert_array_equal(back.numpy(), x)


# ------------------------------------------------------------ norms, conv

def test_group_norm_matches():
    x = _rand((2, 3, 4, 4, 32), 2, 3.0) + 1.5
    _parity(jnorms.GroupNorm(8, eps=1e-6), tnorms.GroupNorm(8, 32, 1e-6), x,
            atol=1e-5)


def test_layer_norm_matches():
    x = _rand((2, 7, 24), 3, 2.0) - 0.5
    _parity(jnorms.LayerNorm(), tnorms.LayerNorm(24), x, atol=1e-5)


@pytest.mark.parametrize("k,stride", [(3, 1), (1, 1), (3, 2)])
def test_inflated_conv_matches(k, stride):
    x = _rand((2, 3, 8, 8, 6), 4)
    _parity(jconv.InflatedConv(10, (k, k), strides=(stride, stride),
                               padding=k // 2),
            tconv.InflatedConv(6, 10, k, stride=stride, padding=k // 2), x,
            atol=1e-5)


# ------------------------------------------------------------- attention

@pytest.mark.parametrize("causal,with_mask", [(False, False), (True, False),
                                              (True, True)])
def test_dot_product_attention_einsum_branch(causal, with_mask):
    q, k, v = (_rand((2, 2, 24, 16), s) for s in (5, 6, 7))
    mask = np.random.RandomState(8).rand(2, 1, 24, 24) > 0.3 if with_mask else None
    mask_j = None if mask is None else jnp.asarray(mask)
    mask_t = None if mask is None else torch.from_numpy(mask)
    want = jattn.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), 0.25, mask=mask_j,
                                       causal=causal)
    got = tattn.dot_product_attention(_t(q), _t(k), _t(v), 0.25, mask=mask_t,
                                      causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_causal_mask_matches():
    for n, m in ((5, 5), (3, 7)):
        np.testing.assert_array_equal(tattn.causal_mask(n, m).numpy(),
                                      np.asarray(jattn.causal_mask(n, m)))


@pytest.mark.parametrize("kind", ["self", "cross", "temporal"])
def test_cross_attention_matches(kind):
    x = _rand((2, 12, 32), 9)
    if kind == "cross":
        ctx = _rand((2, 7, 24), 10)
        _parity(jattn.CrossAttention(32, cross_attention_dim=24, heads=4,
                                     dim_head=8),
                tattn.CrossAttention(32, 24, heads=4, dim_head=8), x, ctx,
                atol=2e-5)
        return
    temporal = kind == "temporal"
    _parity(jattn.CrossAttention(32, heads=4, dim_head=8, temporal=temporal,
                                 causal=temporal),
            tattn.CrossAttention(32, heads=4, dim_head=8, temporal=temporal,
                                 causal=temporal), x, atol=2e-5)


@pytest.mark.parametrize("h", [32, 16, 4])
def test_window_temporal_attention_matches(monkeypatch, h):
    """h = 32: ws 8, the table kernel (K1; JAX in interpret mode); h = 16:
    ws 4, pre-rotation + windowed einsum; h = 4: full frame."""
    monkeypatch.setattr(jswat, "_INTERPRET", True)
    x = _rand((1, 2, h, h, 16), 11)
    _parity(jattn.WindowTemporalAttention(16, heads=2, dim_head=8),
            tattn.WindowTemporalAttention(16, heads=2, dim_head=8), x,
            atol=2e-5)


# ------------------------------------------------------ embeddings, resnet

def test_timestep_embedding_matches():
    ts = np.array([0, 1, 321, 999])
    for dim, flip in ((32, True), (33, False)):
        want = jemb.timestep_embedding(jnp.asarray(ts), dim, flip)
        got = temb.timestep_embedding(torch.from_numpy(ts), dim, flip)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_timestep_mlp_matches():
    x = _rand((3, 16), 12)
    _parity(jemb.TimestepEmbedding(32), temb.TimestepEmbedding(16, 32), x,
            atol=1e-5)


@pytest.mark.parametrize("cin,cout", [(16, 16), (16, 32)])
def test_resnet_block_matches(cin, cout):
    x, t = _rand((2, 3, 8, 8, cin), 13), _rand((2, 24), 14)
    _parity(jres.ResnetBlock3D(cin, cout, temb_channels=24, groups=8),
            tres.ResnetBlock3D(cin, cout, 24, groups=8), x, t, atol=2e-5)


@pytest.mark.parametrize("which", ["up", "down", "down_pad0"])
def test_resample_matches(which):
    x = _rand((1, 2, 8, 8, 16), 15)
    if which == "up":
        _parity(jres.Upsample3D(16), tres.Upsample3D(16), x, atol=1e-5)
    else:
        pad = 0 if which == "down_pad0" else 1
        _parity(jres.Downsample3D(16, padding=pad),
                tres.Downsample3D(16, padding=pad), x, atol=1e-5)
