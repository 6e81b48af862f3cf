"""The port's models and sampler against the JAX package on one set of
weights: those of ``tests/test_golden_latents.py::build_case`` (tiny
SeerUNet 32/64, FSText, VAE, CLIP; fp32), carried across by
``io/convert.py``.

- the slice: the port's DDIM sampler reproduces
  ``tests/fixtures/golden_latents.npz['ddim']`` (rtol 1e-3, atol 1e-4);
- FSText, CLIP text, VAE encode (posterior noise fed from numpy) and
  decode, each against its JAX module (the SeerUNet is held to the JAX
  package through the golden latents, its blocks in test_torch_ops.py
  and test_torch_kernels.py);
- the weight carry agrees with the JAX package's own exporter
  (``io/export.py::flax_to_torch``) key for key.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seervideoldm_tpu_torch.io.convert import jax_to_state_dict, load_jax_params
from seervideoldm_tpu_torch.models.clip_text import CLIPTextConfig
from seervideoldm_tpu_torch.models.unet3d import SeerUNetConfig
from seervideoldm_tpu_torch.models.vae import VAEConfig
from seervideoldm_tpu_torch.pipelines.text_video import SeerModels, SeerPipeline

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                      "golden_latents.npz")
UNET_CFG = SeerUNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                          norm_num_groups=8, cross_attention_dim=32,
                          attention_head_dim=4)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


VAE_CFG = VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                    norm_num_groups=8)
CLIP_CFG = CLIPTextConfig(vocab_size=100, hidden_size=32, intermediate_size=64,
                          num_hidden_layers=2, num_attention_heads=4,
                          max_position_embeddings=16)


def _jax_models():
    """The JAX modules and parameters of ``build_case`` (its configs, key
    and init calls), each ``init`` run under ``jax.jit``: the same values
    as the eager calls, compiled once instead of op by op."""
    from seervideoldm_tpu.models import clip_text, fstext, unet3d, vae

    def cfg(cls, ours):
        return cls(**{k: getattr(ours, k) for k in ours.__dataclass_fields__})

    f32 = dict(dtype=jnp.float32, param_dtype=jnp.float32)
    mods = dict(
        unet=unet3d.SeerUNet(config=cfg(unet3d.SeerUNetConfig, UNET_CFG), **f32),
        fstext=fstext.FSTextTransformer(num_frames=4, in_channels=32,
                                        out_channels=32, cross_attention_dim=32,
                                        n_heads=4, num_layers=1, **f32),
        vae=vae.AutoencoderKL(config=cfg(vae.VAEConfig, VAE_CFG), **f32),
        clip=clip_text.CLIPTextModel(config=cfg(clip_text.CLIPTextConfig,
                                                CLIP_CFG), **f32))
    dummies = dict(
        unet=(jnp.zeros((1, 4, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
              jnp.zeros((1, 4, 16, 32)), 0),
        fstext=(jnp.zeros((1, 16, 32)),), vae=(jnp.zeros((1, 16, 16, 3)),),
        clip=(jnp.zeros((1, 16), jnp.int32),))
    keys = dict(zip(("unet", "fstext", "vae", "clip"),
                    jax.random.split(jax.random.PRNGKey(7), 4)))
    params = {k: jax.jit(lambda key, m=m, d=dummies[k]: m.init(key, *d)["params"])(
        keys[k]) for k, m in mods.items()}
    return mods, params


@pytest.fixture(scope="module")
def case():
    mods, jparams = _jax_models()
    params = {k: jax.tree_util.tree_map(np.asarray, v) for k, v in jparams.items()}
    models = SeerModels.initialize(
        num_frames=4, unet_config=UNET_CFG, vae_config=VAE_CFG,
        clip_config=CLIP_CFG, fstext_kwargs=dict(n_heads=4, num_layers=1),
        dtype=torch.float32, device="cpu")
    for k in params:
        load_jax_params(getattr(models, k), params[k])
    return dict(jmods=mods, jparams=jparams, params=params, models=models,
                pipe=SeerPipeline(models))


def test_ddim_reproduces_golden_latents(case):
    """The same inputs as ``build_case`` (RandomState(3) draws) through the
    port's FSText + DDIM with batched CFG."""
    rng = np.random.RandomState(3)
    x_T = _t(rng.randn(2, 3, 8, 8, 4))
    x0_emb = _t(rng.randn(2, 1, 8, 8, 4))
    clip_emb = _t(rng.randn(2, 16, 32))
    pipe = case["pipe"]
    context = pipe.fstext(clip_emb)
    uncond = clip_emb[:, None].expand(2, 4, 16, 32)
    got = pipe.sample_latents(x_T, x0_emb, context, uncond, ddim_steps=4,
                              guidance_scale=7.5)
    want = np.load(GOLDEN)["ddim"]
    assert got.shape == want.shape == (2, 3, 8, 8, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)


def test_fstext_matches_jax(case):
    emb = np.random.RandomState(5).randn(1, 16, 32).astype(np.float32)
    m, p = case["jmods"]["fstext"], case["jparams"]["fstext"]
    want = np.asarray(jax.jit(lambda e: m.apply({"params": p}, e))(emb))
    got = case["pipe"].fstext(_t(emb))
    assert got.shape == (1, 4, 16, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_clip_text_matches_jax(case):
    rng = np.random.RandomState(6)
    ids = rng.randint(0, 100, size=(2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[0, 9:] = 0
    m, p = case["jmods"]["clip"], case["jparams"]["clip"]
    want = np.asarray(jax.jit(lambda i, k: m.apply({"params": p}, i, k))(
        ids, mask))
    got = case["pipe"].encode_text(ids, mask)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_vae_encode_decode_match_jax(case):
    rng = np.random.RandomState(7)
    video = rng.uniform(-1, 1, (1, 2, 32, 32, 3)).astype(np.float32)
    noise = rng.randn(1, 2, 16, 16, 4).astype(np.float32)
    vae, vp = case["jmods"]["vae"], {"params": case["jparams"]["vae"]}
    mean, logvar = jax.jit(lambda x: vae.apply(vp, x, method=vae.encode_moments))(
        video.reshape(2, 32, 32, 3))
    z = (np.asarray(mean) + np.exp(0.5 * np.asarray(logvar))
         * noise.reshape(2, 16, 16, 4)) * 0.18215
    pipe = case["pipe"]
    got_z = pipe.vae_encode_video(_t(video), _t(noise))
    np.testing.assert_allclose(got_z.numpy(), z.reshape(1, 2, 16, 16, 4),
                               atol=2e-5)
    want_x = jax.jit(lambda z: vae.apply(vp, z, method=vae.decode))(z / 0.18215)
    want_x = np.clip((np.asarray(want_x) + 1.0) / 2.0, 0.0, 1.0)
    got_x = pipe.vae_decode_video(_t(z.reshape(1, 2, 16, 16, 4)))
    np.testing.assert_allclose(got_x.numpy(), want_x.reshape(1, 2, 32, 32, 3),
                               atol=2e-5)


@pytest.mark.parametrize("name", ["unet", "fstext"])
def test_carry_agrees_with_jax_exporter(case, name):
    """``io/convert.py`` and ``seervideoldm_tpu/io/export.py::flax_to_torch``
    give the same tensors under every key of the port's state dict."""
    from seervideoldm_tpu.io.export import flax_to_torch

    model = getattr(case["models"], name)
    manifest = {k: list(v.shape) for k, v in model.state_dict().items()}
    want, missing, unused = flax_to_torch(case["params"][name], manifest)
    assert not missing and not unused
    got = jax_to_state_dict(case["params"][name], model)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
