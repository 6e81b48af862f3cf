"""The reference's UNet memory knobs in the port against the JAX package, on
the CPU in fp32: ``attention_slice`` (``set_attention_slice``) and
``collect_attn`` (``return_attn``).

The tiny SeerUNet of ``tests/test_models.py::test_attention_slice_matches_unsliced``
on 32 x 32 latents (1024 tokens at the first level, where the unsliced
spatial self-attention takes the K2 path), weights from a numpy seed
carried with ``io/convert.py``:

- sliced equals unsliced in the port (atol 2e-5, the JAX test's bound),
  the port's sliced UNet equals the JAX sliced UNet at 2e-5, and a sliced
  site never reaches ``flash_attention`` (K2) where the unsliced one does;
- with ``collect_attn`` every cross-attention site's fp32 logits equal the
  JAX ``intermediates`` entry of the same site (by its path) within 1e-5
  absolute and relative (the deepest sites' logits reach |5| after the
  whole down path in fp32), the
  set of sites is the same, and the output still equals the plain UNet's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seervideoldm_tpu.models.unet3d import SeerUNet as JSeerUNet
from seervideoldm_tpu.models.unet3d import SeerUNetConfig as JUNetConfig
from seervideoldm_tpu_torch.io.convert import load_jax_params, normalize_path
from seervideoldm_tpu_torch.models.unet3d import SeerUNet, SeerUNetConfig
from seervideoldm_tpu_torch.ops import attention

from test_torch_parallel import _seeded_init

TINY = dict(block_out_channels=(32, 64), layers_per_block=1,
            norm_num_groups=8, cross_attention_dim=32, attention_head_dim=4)
F = 2


@pytest.fixture(scope="module")
def case():
    torch.set_num_threads(1)
    model = JSeerUNet(config=JUNetConfig(**TINY))
    jparams = _seeded_init(model, 0, jnp.zeros((1, 1, 8, 8, 4)),
                           jnp.zeros((1,), jnp.int32),
                           jnp.zeros((1, 1, 77, 32)), 0)
    rng = np.random.RandomState(1)
    x = rng.randn(1, F, 32, 32, 4).astype(np.float32)
    ctx = rng.randn(1, F, 77, 32).astype(np.float32)
    ts = np.array([500], np.int32)
    return dict(jparams=jparams, x=x, ctx=ctx, ts=ts)


def _jax(case, collect=False, **cfg):
    model = JSeerUNet(config=JUNetConfig(**TINY, **cfg), collect_attn=collect)
    params = {"params": jax.tree_util.tree_map(jnp.asarray, case["jparams"])}
    args = (jnp.asarray(case["x"]), jnp.asarray(case["ts"]),
            jnp.asarray(case["ctx"]), 0)
    if collect:
        out, state = model.apply(params, *args, mutable=["intermediates"])
        return np.asarray(out), state["intermediates"]
    return np.asarray(model.apply(params, *args))


def _port(case, attn_maps=None, collect=False, **cfg):
    unet = load_jax_params(SeerUNet(SeerUNetConfig(**TINY, **cfg),
                                    collect_attn=collect).eval(),
                           case["jparams"])
    with torch.no_grad():
        return unet(torch.from_numpy(case["x"]), torch.from_numpy(case["ts"]),
                    torch.from_numpy(case["ctx"]), cond_frame=0,
                    attn_maps=attn_maps).numpy()


def _count_flash(monkeypatch):
    calls = []
    real = attention.flash_attention
    monkeypatch.setattr(attention, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def test_attention_slice_matches_unsliced_and_jax(case, monkeypatch):
    calls = _count_flash(monkeypatch)
    plain = _port(case)
    assert calls, "the unsliced first level should take the K2 path"
    calls.clear()
    sliced = _port(case, attention_slice=2)
    assert not calls, "a sliced site reached flash_attention (K2)"
    np.testing.assert_allclose(sliced, plain, atol=2e-5)
    np.testing.assert_allclose(sliced, _jax(case, attention_slice=2),
                               atol=2e-5)


def test_sliced_attention_refuses_a_slice_that_does_not_divide_heads():
    q = torch.zeros(1, 4, 8, 2)
    with pytest.raises(ValueError, match="must divide heads"):
        attention.sliced_attention(q, q, q, 1.0, 3)


def test_collect_attn_maps_match_jax_intermediates(case):
    want_out, inter = _jax(case, collect=True)
    maps: dict = {}
    out = _port(case, attn_maps=maps, collect=True)
    np.testing.assert_allclose(out, want_out, atol=2e-5)
    np.testing.assert_allclose(out, _port(case), atol=2e-5)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(inter)[0]:
        keys = [p.key for p in path if hasattr(p, "key")]
        assert keys[-1] == "attn"
        want[tuple(keys[:-1])] = np.asarray(leaf)
    got = {tuple(normalize_path(site)): v.numpy() for site, v in maps.items()}
    assert set(got) == set(want) and all(k[-1] == "attn2" for k in got)
    for site, logits in got.items():
        assert logits.dtype == np.float32
        np.testing.assert_allclose(logits, want[site], atol=1e-5, rtol=1e-5,
                                   err_msg=str(site))


def test_config_fields_carry_from_the_jax_config():
    jcfg = JUNetConfig(**TINY, attention_slice=2)
    cfg = SeerUNetConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items()})
    assert cfg.attention_slice == 2
    assert SeerUNet(SeerUNetConfig(**TINY)).collect_attn is False
