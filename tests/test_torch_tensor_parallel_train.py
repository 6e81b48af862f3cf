"""Sampling and training under the ``model`` axis against the JAX package
(the second half of ``tests/test_torch_tensor_parallel.py``; rank
functions in ``tests/torch_tp_workers.py``, gloo CPU ranks, fp32):

- a 4-step DDIM loop with batched CFG under ``{model: 2}`` reproduces the
  JAX package's golden latents (``tests/fixtures/golden_latents.npz``,
  rtol 1e-3, atol 1e-4, as ``test_ddim_reproduces_golden_latents``), on
  every rank;
- one train step under ``{model: 2}`` and ``{data: 2, model: 2}``
  against the JAX package's step under the same mesh (``shard_params``,
  ``optax.trace(0)`` capturing the gradients): the loss within atol 1e-5,
  the gradients joined over the model ranks within the bounds of
  ``test_train_step_under_mesh_matches_jax``, and the norm the clip sees
  (split gradients' squares summed over the model ranks, replicated ones
  counted once) equal to the single-rank norm of the JAX gradients; the
  masters agree within each model index after the step; under ``remat``
  (``block`` and ``save_attn``, whose recompute runs the all-reduces
  again) the gradients equal the run without it;
- a save under ``{model: 2}`` holds the keys, shapes and values of a
  single-rank save after the same two optimizer steps, and a resume from
  it restores every rank's slices.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seervideoldm_tpu.parallel.mesh import batch_sharding
from seervideoldm_tpu.pipelines.text_video import SeerModels as JSeerModels
from seervideoldm_tpu.training import optim as joptim
from seervideoldm_tpu.training import trainer as jtrainer
from seervideoldm_tpu_torch.io.checkpoint import (FSTEXT_FILE, STATE_FILE,
                                                  UNET_FILE)
from seervideoldm_tpu_torch.io.convert import jax_subtree_to_named
from seervideoldm_tpu_torch.parallel import launch
from seervideoldm_tpu_torch.training.optim import global_norm

import torch_tp_workers as workers
from test_torch_models import GOLDEN, _jax_models
from test_torch_tensor_parallel import (COND, FRAMES, SIZES, TIMEOUT,
                                        seeded_params, under_mesh)

TRAIN_MESHES = {"model2": {"model": 2}, "data2-model2": {"data": 2,
                                                          "model": 2}}
REMATS = ("block", "save_attn")


def test_ddim_loop_under_model_axis_reproduces_golden_latents():
    """The inputs of ``test_ddim_reproduces_golden_latents`` (its
    RandomState(3) draws and weights)."""
    jparams = {k: jax.tree_util.tree_map(np.asarray, v)
               for k, v in _jax_models()[1].items()}
    rng = np.random.RandomState(3)
    x_T = rng.randn(2, 3, 8, 8, 4).astype(np.float32)
    x0_emb = rng.randn(2, 1, 8, 8, 4).astype(np.float32)
    clip_emb = rng.randn(2, 16, 32).astype(np.float32)
    sent = dict(x_T=x_T, x0_emb=x0_emb, clip_emb=clip_emb,
                uncond=np.broadcast_to(clip_emb[:, None], (2, 4, 16, 32)))
    got = launch.run(workers.sample_case, 2,
                     args=(SIZES, jparams, sent, {"model": 2}), device="cpu",
                     timeout=TIMEOUT, threads=1)
    want = np.load(GOLDEN)["ddim"]
    for latents in got:
        assert latents.shape == want.shape == (2, 3, 8, 8, 4)
        np.testing.assert_allclose(latents, want, rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(got[0], got[1])


def _jax_step(mods, jparams, jbatch, shape):
    """The JAX train step's metrics and gradients under ``shape``."""
    def run(mesh, unet_p, fs_p, vae_p, clip_p):
        jm = JSeerModels(*mods.values(), unet_p, fs_p, vae_p, clip_p)
        params = {"unet": unet_p, "fstext": fs_p}
        trainable, frozen = jtrainer.partition_params(
            params, joptim.trainable_mask(params, "reference"))
        tx = optax.trace(decay=0.0)
        state = jtrainer.TrainState.create(
            jax.tree_util.tree_map(jnp.copy, trainable), tx)
        step = jtrainer.make_train_step(jm, tx, cond_frames=COND,
                                        frozen_params=frozen, text_loss=True)
        # the batch over 'data' where the mesh has it, else replicated
        batch = {k: (jax.device_put(v, batch_sharding(mesh, v.ndim))
                     if "data" in mesh.axis_names else jnp.asarray(v))
                 for k, v in jbatch.items()}
        state, metrics = step(state, batch, jax.random.PRNGKey(4))
        return ({k: float(v) for k, v in metrics.items()},
                jax.tree_util.tree_map(np.asarray, state.opt_state.trace))

    return under_mesh(shape, run, *(jparams[k] for k in
                                    ("unet", "fstext", "vae", "clip")))


@pytest.fixture(scope="module")
def train_runs():
    mods, jparams = seeded_params()
    rng = np.random.RandomState(11)
    b, res = 2, 16
    video = rng.uniform(-1, 1, (b, FRAMES, res, res, 3)).astype(np.float32)
    ids = rng.randint(0, 100, (b, 16)).astype(np.int32)
    mask = np.ones((b, 16), np.int32)
    jm = JSeerModels(*mods.values(), *(
        jax.tree_util.tree_map(jnp.asarray, jparams[k]) for k in mods))
    jbatch = jtrainer.prepare_batch_fn(jm, sample_posterior=False)(
        jnp.asarray(video), jnp.asarray(ids), jnp.asarray(mask),
        jax.random.PRNGKey(3), cond_frames=COND)
    jbatch = {k: np.asarray(v) for k, v in jbatch.items()}
    want = {name: _jax_step(mods, jparams, jbatch, shape)
            for name, shape in TRAIN_MESHES.items()}
    # the step's draws, as the JAX step takes them from its key
    key = jax.random.PRNGKey(4)
    k_noise, k_t = jax.random.split(jax.random.fold_in(key, 0))
    noise = np.asarray(jax.random.normal(k_noise, jbatch["latents"].shape,
                                         dtype=jnp.float32))
    ts = np.asarray(jax.random.randint(k_t, (b,), 0, 1000))
    got = {}
    for name, shape in TRAIN_MESHES.items():
        n = int(np.prod(list(shape.values())))
        cases = {name: dict(mesh=shape, noise=noise, ts=ts)}
        if name == "model2":
            cases.update({f"model2-{r}": dict(mesh=shape, noise=noise, ts=ts,
                                              remat=r)
                          for r in REMATS})
        ranks = launch.run(workers.train_cases, n,
                           args=(SIZES, jparams, jbatch, cases),
                           device="cpu", timeout=TIMEOUT, threads=1)
        got[name] = ranks
        for r in REMATS if name == "model2" else ():
            got[f"model2-{r}"] = ranks[0][f"model2-{r}"]
    return dict(want=want, got=got, jparams=jparams, batch=jbatch)


@pytest.mark.parametrize("name", list(TRAIN_MESHES))
def test_train_step_under_model_axis_matches_jax(train_runs, name):
    metrics, jgrads = train_runs["want"][name]
    ranks = train_runs["got"][name]
    got = ranks[0][name]
    np.testing.assert_allclose(got["loss"], metrics["loss"], atol=1e-5)
    np.testing.assert_allclose(got["mse"], metrics["mse"], atol=1e-5)
    assert abs(got["loss"] - got["mse"]) > 1e-4   # text_loss is in
    modules = workers.build(SIZES, train_runs["jparams"]).trainable_modules()
    want = jax_subtree_to_named(jgrads, modules)
    assert set(want) == set(got["grads"])
    nonzero = 0
    for n, g in got["grads"].items():
        w = want[n].numpy()
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, atol=2e-5 * scale, rtol=1e-4,
                                   err_msg=n)
        nonzero += bool(np.abs(w).max() > 1e-6)
    assert nonzero > 0.9 * len(want)
    # this rank held half of each split gradient
    assert got["local_split"]
    for n, shape in got["local_split"].items():
        assert np.prod(shape) * 2 == want[n].numel(), n
    # the norm the clip saw is the single-rank norm
    single = float(global_norm([want[n] for n in sorted(want)]))
    np.testing.assert_allclose(got["norm"], single, rtol=1e-5)
    # the masters after the step agree within each model index
    by_model = {}
    for r in ranks:
        by_model.setdefault(r[name]["coords"]["model"], set()).add(
            r[name]["checksum"])
    assert len(by_model) == 2 and all(len(s) == 1 for s in by_model.values())


@pytest.mark.parametrize("remat", REMATS)
def test_remat_under_model_axis_keeps_the_gradients(train_runs, remat):
    want = train_runs["got"]["model2"][0]["model2"]
    got = train_runs["got"][f"model2-{remat}"]
    assert got["loss"] == want["loss"]
    for n, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][n], g, rtol=1e-6, atol=1e-7,
                                   err_msg=n)


@pytest.fixture(scope="module")
def checkpoint_run(train_runs, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tp_ckpt"))
    batch = train_runs["batch"]
    draws = [dict(noise=np.random.RandomState(30 + i).randn(
        *batch["latents"].shape).astype(np.float32),
        ts=np.array([100 + 300 * i, 800])) for i in range(2)]
    got = launch.run(workers.checkpoint_case, 2,
                     args=(SIZES, train_runs["jparams"], batch, draws, root,
                           {"model": 2}),
                     device="cpu", timeout=TIMEOUT, threads=1)[0]
    return dict(root=root, got=got)


@pytest.mark.parametrize("fname", [UNET_FILE, FSTEXT_FILE, STATE_FILE])
def test_split_save_equals_single_rank_save(checkpoint_run, fname):
    root = checkpoint_run["root"]
    load = lambda d: torch.load(  # noqa: E731
        os.path.join(root, d, "learned_sdunet-steps-2", fname),
        map_location="cpu")
    single, split = load("single"), load("split")
    if fname == STATE_FILE:
        assert single["step"] == split["step"] == 2
        flat = lambda s: {f"{k}/{n}": t for k in ("masters", "ema")  # noqa: E731
                          for n, t in s[k].items()} | {
            f"{k}/{n}": t for k in ("mu", "nu")
            for n, t in s["optimizer"][k].items()}
        single, split = flat(single), flat(split)
    assert sorted(single) == sorted(split)
    for k in single:
        assert single[k].shape == split[k].shape, k
        a, b = single[k].numpy(), split[k].numpy()
        top = max(1e-12, float(np.abs(a).max()))
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=max(2e-6, 2e-5 * top)
                                   if k.startswith(("mu/", "nu/")) else 2e-6,
                                   err_msg=k)


def test_resume_under_model_axis_restores_the_slices(checkpoint_run):
    got = checkpoint_run["got"]
    before, after = got["before"], got["after"]
    assert got["n_split"] > 0 and got["synced"]
    assert after["step"] == before["step"] == 2
    assert after["count"] == before["count"] == 2
    for key in ("masters", "ema", "mu"):
        assert sorted(after[key]) == sorted(before[key])
        for n, t in before[key].items():
            np.testing.assert_array_equal(after[key][n], t, err_msg=n)
