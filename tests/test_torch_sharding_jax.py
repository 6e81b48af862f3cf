"""The port's ZeRO-1 and FSDP training (``parallel/sharding.py``) on 2 gloo
CPU ranks against the JAX package's ``zero1_state_sharding`` and
``fsdp_state_sharding`` training on a 2-device ``data`` mesh.

The JAX runs are built as ``tests/test_zero1.py`` and
``tests/test_fsdp.py`` build them: tiny SeerUNet, a global batch of 2 from
the JAX prepare function, AdamW with one warmup step, accumulation 2, EMA
0.9, with every ``proj_out`` seeded non-zero so that the temporal sites
get gradients.  3 optimizer steps (6 micro-steps): the first runs at the
warmup's lr(0) = 0, the next two move the masters and the EMA.  Their
weights, batch and every micro-step's noise and timesteps go to the port's
ranks as numpy arrays (``io/convert.py`` carries the parameters).  Losses
within rtol 2e-5, masters and EMA within atol 2e-6 (the bounds of those
tests), and most of them moved; the Adam moments within 1e-4 relative +
2e-5 of the moment's largest entry (after the bound of
``tests/test_torch_training.py``).

Those JAX tests compare JAX with JAX and take lr 1e-2 and eps 1e-8.
Across the two packages Adam turns each element's gradient into an update
of about +-lr whatever its size, so an element whose gradient lies near
the two packages' rounding noise (some FSText weights' gradients are
1e-11 here, zero in exact arithmetic) moves by a different fraction of lr
in each.  So this comparison takes the recipe of the port-vs-JAX
optimizer test in ``tests/test_torch_training.py``: lr 1e-3, eps 1e-6
(which damps gradients below 1e-6); the masters move by about 2e-3 and
agree to about 1e-6.

The port's state is still sharded after the steps: every group's shard
holds at most the JAX rule's per-device bytes of its leaves plus the
padding.
"""
import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seervideoldm_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from seervideoldm_tpu.models.unet3d import SeerUNetConfig as JUNetConfig
from seervideoldm_tpu.models.vae import VAEConfig as JVAEConfig
from seervideoldm_tpu.parallel.mesh import (batch_sharding, create_mesh,
                                            shard_global)
from seervideoldm_tpu.parallel.sharding import (_largest_divisible_spec,
                                                fsdp_param_sharding,
                                                fsdp_state_sharding,
                                                zero1_state_sharding)
from seervideoldm_tpu.pipelines.text_video import SeerModels as JSeerModels
from seervideoldm_tpu.training import optim as joptim
from seervideoldm_tpu.training import trainer as jtrainer
from seervideoldm_tpu_torch.parallel import launch
from seervideoldm_tpu_torch.parallel.sharding import ALIGN

import torch_sharding_workers as workers

TIMEOUT = 300
UNET = dict(block_out_channels=(32, 64), layers_per_block=1,
            norm_num_groups=8, cross_attention_dim=32, attention_head_dim=4)
VAE = dict(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=8)
CLIP = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=16)
FSTEXT = dict(n_heads=4, num_layers=1)
FRAMES, COND, MICRO = 4, 1, 6
SIZES = dict(frames=FRAMES, cond=COND, unet=UNET, vae=VAE, clip=CLIP,
             fstext=FSTEXT)
OPT = dict(lr=1e-3, eps=1e-6, warmup=1, accum=2, ema=0.9, steps=MICRO)


def _jax_run(mode):
    """The JAX sharded training of ``tests/test_zero1.py`` /
    ``tests/test_fsdp.py``; returns its losses, params, EMA and the inputs
    the port needs."""
    mesh = create_mesh({"data": 2})
    models = JSeerModels.initialize(
        jax.random.PRNGKey(0), num_frames=FRAMES,
        unet_config=JUNetConfig(**UNET), vae_config=JVAEConfig(**VAE),
        clip_config=JCLIPConfig(**CLIP), fstext_kwargs=FSTEXT,
        dtype=jnp.float32, latent_size=8)
    # every proj_out seeded non-zero (zero-initialised, it leaves every
    # weight upstream of it inside a temporal site without a gradient)
    rng = np.random.RandomState(11)
    flat = tu.flatten_dict(jax.tree_util.tree_map(np.asarray,
                                                  models.unet_params))
    for path, val in flat.items():
        if "proj_out" in path:
            flat[path] = (rng.randn(*val.shape) * 0.1).astype(np.float32)
    models.unet_params = jax.tree_util.tree_map(jnp.asarray,
                                                tu.unflatten_dict(flat))
    # copied before the steps, which donate the state's buffers
    jparams = {k: jax.tree_util.tree_map(np.array, getattr(models,
                                                           f"{k}_params"))
               for k in ("unet", "fstext", "vae", "clip")}
    params = {"unet": models.unet_params, "fstext": models.fstext_params}
    trainable, frozen = jtrainer.partition_params(
        params, joptim.trainable_mask(params))
    tx, _ = joptim.build_optimizer(trainable, OPT["lr"], eps=OPT["eps"],
                                   warmup_steps=OPT["warmup"], total_steps=10,
                                   accumulation_steps=OPT["accum"],
                                   partitioned=True)
    state = jtrainer.TrainState.create(trainable, tx, ema=True)
    if mode == "zero1":
        sh = zero1_state_sharding(state, mesh)
    else:
        sh = fsdp_state_sharding(state, mesh)
        frozen = shard_global(mesh, frozen, fsdp_param_sharding(frozen, mesh))
    state = shard_global(mesh, state, sh)
    step = jtrainer.make_train_step(models, tx, cond_frames=COND,
                                    frozen_params=frozen, ema_decay=OPT["ema"],
                                    state_sharding=sh)
    prepare = jtrainer.prepare_batch_fn(models)
    video = jnp.asarray(np.random.RandomState(0).randn(2, FRAMES, 16, 16, 3),
                        jnp.float32)
    ids = jnp.ones((2, 16), jnp.int32)
    mask = jnp.ones((2, 16), jnp.int32)
    batch = prepare(video, ids, mask, jax.random.PRNGKey(1), cond_frames=COND)
    host_batch = {k: np.asarray(v) for k, v in batch.items()}
    batch = {k: jax.device_put(v, batch_sharding(mesh, v.ndim))
             for k, v in batch.items()}
    key = jax.random.PRNGKey(2)
    draws, losses = [], []
    for micro in range(MICRO):
        k_noise, k_t = jax.random.split(jax.random.fold_in(key, micro))
        draws.append({"noise": np.asarray(jax.random.normal(
            k_noise, host_batch["latents"].shape, dtype=jnp.float32)),
            "ts": np.asarray(jax.random.randint(k_t, (2,), 0, 1000))})
        state, metrics = step(state, batch, key)
        losses.append(float(metrics["loss"]))
    adam = _adam_state(state.opt_state)
    return dict(losses=losses, jparams=jparams, batch=host_batch, draws=draws,
                params=jax.tree_util.tree_map(np.asarray, state.params),
                ema=jax.tree_util.tree_map(np.asarray, state.ema_params),
                mu=jax.tree_util.tree_map(np.asarray, adam.mu),
                nu=jax.tree_util.tree_map(np.asarray, adam.nu))


def _adam_state(node):
    """The optax ``ScaleByAdamState`` inside a (nested) optimizer state."""
    if hasattr(node, "mu") and hasattr(node, "nu"):
        return node
    children = (node.values() if isinstance(node, dict)
                else node if isinstance(node, (tuple, list))
                else getattr(node, "__dict__", {}).values())
    for child in children:
        found = _adam_state(child)
        if found is not None:
            return found
    return None


@pytest.fixture(scope="module")
def runs():
    jax_runs = {mode: _jax_run(mode) for mode in ("zero1", "fsdp")}
    first = jax_runs["zero1"]
    cases = {mode: dict(OPT, mode=mode) for mode in jax_runs}
    port = launch.run(workers.sharded_cases, 2,
                      args=(SIZES, first["jparams"], first["batch"],
                            first["draws"], cases),
                      device="cpu", timeout=TIMEOUT, threads=1)[0]
    return jax_runs, port


@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_sharded_training_matches_jax(runs, mode):
    from seervideoldm_tpu_torch.io.convert import jax_subtree_to_named

    jax_runs, port = runs
    want, got = jax_runs[mode], port[mode]
    # both JAX runs start from one init and batch, as the port's do
    np.testing.assert_array_equal(want["batch"]["latents"],
                                  jax_runs["zero1"]["batch"]["latents"])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-5)
    modules = workers.build(SIZES, want["jparams"])[0].trainable_modules()
    params = jax_subtree_to_named(want["params"], modules)
    ema = jax_subtree_to_named(want["ema"], modules)
    assert set(params) == set(got["masters"]) == set(got["ema"])
    init = jax_subtree_to_named(
        {"unet": want["jparams"]["unet"], "fstext": want["jparams"]["fstext"]},
        modules)
    for tree in (params, ema):
        moved = [n for n in tree
                 if not np.array_equal(tree[n].numpy(), init[n].numpy())]
        assert len(moved) > 0.9 * len(params), "the weights did not move"
    for name in params:
        np.testing.assert_allclose(got["masters"][name], params[name].numpy(),
                                   atol=2e-6, err_msg=name)
        np.testing.assert_allclose(got["ema"][name], ema[name].numpy(),
                                   atol=2e-6, err_msg=name)
    nonzero = 0
    for key in ("mu", "nu"):
        moments = jax_subtree_to_named(want[key], modules)
        assert set(moments) == set(got["optimizer"][key])
        # a gradient that is zero in exact arithmetic is rounding noise in
        # both packages: the bound scales with the moment's largest entry
        top = max(float(w.abs().max()) for w in moments.values())
        for name, w in moments.items():
            w = w.numpy()
            np.testing.assert_allclose(got["optimizer"][key][name], w,
                                       rtol=1e-4, atol=2e-5 * top,
                                       err_msg=f"{key} {name}")
            nonzero += float(np.abs(w).max()) > 1e-6 * top
    assert nonzero > len(params)  # of 2 * len(params) moment tensors


@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_state_stays_sharded_within_the_jax_rule(runs, mode):
    """Each group's shard: at most the per-device bytes of its leaves under
    the JAX rule (``_largest_divisible_spec`` on the 2-device mesh), plus
    the padding (under ALIGN elements a leaf, and the tail of the
    buffer)."""
    mesh = create_mesh({"data": 2})
    got = runs[1][mode]
    assert got["groups"]
    for g, row in got["groups"].items():
        rule = 0
        for shape in row["shapes"]:
            spec = _largest_divisible_spec(mesh, shape)
            rule += int(np.prod(shape)) // (2 if "data" in tuple(spec) else 1)
        pad = (len(row["shapes"]) + 1) * ALIGN
        assert row["shard_bytes"] <= (rule + pad) * row["itemsize"], (g, row)
