"""The port's parallel layer (``seervideoldm_tpu_torch/parallel/``, the
mesh-aware UNet and trainer) against the JAX package on one device, on the
CPU.

Multi-rank cases run 2 or 4 gloo ranks through ``parallel.launch.run``
(spawned processes, a ``file://`` rendezvous in a fresh temporary
directory, a timeout); the rank functions are in
``tests/torch_parallel_workers.py``.  Inputs and weights are made from a
numpy seed (JAX init carried with ``io/convert.py``).

- config: ``data`` / ``seq`` meshes and ``ring_attention`` are accepted;
  the ``model`` axis, ``zero1`` and ``fsdp`` are each refused by name;
- mesh: the rank layout, frame ranges and batch slices, and the refusals of
  ``create_mesh``; a failing rank fails the launch;
- the tiny SeerUNet (the widths of ``tests/test_sequence_parallel.py``,
  32 x 32 latents so the first level has ws 8 windows) under ``{seq: 2}``
  at f = 4 (the ring), f = 5 (frames do not split evenly: the pre-rotated
  kernel branch K6, through its plain version on the CPU) and f = 4 with
  the ring off (the table kernel K1 over gathered frames), under
  ``{data: 2}``, and under ``{data: 2, seq: 2}`` on 4 ranks (f = 4 and
  f = 5), vs the JAX ``SeerUNet``: atol 2e-5, rtol 1e-5 (the bound of
  ``tests/test_sequence_parallel.py``), and the branch each case took;
- one train step (``text_loss`` on) under ``{data: 2}`` and ``{seq: 2}``
  vs the JAX trainer on the same global batch, noise and timesteps: loss
  and mse within 1e-5, every trainable gradient within 1e-4 relative +
  2e-5 of the tensor's largest entry (the bounds of
  ``tests/test_torch_training.py``); after one optimizer step the masters'
  checksums agree on every rank.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seervideoldm_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from seervideoldm_tpu.models.clip_text import CLIPTextModel as JCLIP
from seervideoldm_tpu.models.fstext import FSTextTransformer as JFSText
from seervideoldm_tpu.models.unet3d import SeerUNet as JSeerUNet
from seervideoldm_tpu.models.unet3d import SeerUNetConfig as JUNetConfig
from seervideoldm_tpu.models.vae import AutoencoderKL as JVAE
from seervideoldm_tpu.models.vae import VAEConfig as JVAEConfig
from seervideoldm_tpu.pipelines.text_video import SeerModels as JSeerModels
from seervideoldm_tpu.training import optim as joptim
from seervideoldm_tpu.training import trainer as jtrainer
from seervideoldm_tpu_torch.config import config_from_dict
from seervideoldm_tpu_torch.io.convert import jax_subtree_to_named
from seervideoldm_tpu_torch.models.clip_text import CLIPTextConfig
from seervideoldm_tpu_torch.models.unet3d import SeerUNetConfig
from seervideoldm_tpu_torch.models.vae import VAEConfig
from seervideoldm_tpu_torch.parallel import launch
from seervideoldm_tpu_torch.parallel.activation import FrameShard
from seervideoldm_tpu_torch.parallel.mesh import create_mesh, frame_counts
from seervideoldm_tpu_torch.pipelines.text_video import SeerModels

import torch_parallel_workers as workers

TIMEOUT = 240
TINY = dict(block_out_channels=(32, 64), layers_per_block=1,
            norm_num_groups=8, cross_attention_dim=32, attention_head_dim=4)


# ---------------------------------------------------------------- config

def test_config_accepts_data_and_seq_meshes():
    cfg = config_from_dict({"mesh_shape": {"data": 2, "seq": 2},
                            "ring_attention": False})
    assert cfg.mesh_shape == {"data": 2, "seq": 2}
    assert cfg.ring_attention is False
    assert config_from_dict({}).ring_attention is True


@pytest.mark.parametrize("raw,name", [
    ({"mesh_shape": {"data": 2, "model": 2}}, "'model'"),
    ({"zero1": True}, "zero1"),
    ({"fsdp": True}, "fsdp")])
def test_config_refuses_each_unported_strategy_by_name(raw, name):
    with pytest.raises(ValueError, match=name):
        config_from_dict(raw)


def test_config_refuses_unknown_mesh_axis():
    with pytest.raises(ValueError, match="'pipe'"):
        config_from_dict({"mesh_shape": {"pipe": 2}})


# ------------------------------------------------------------------ mesh

def test_single_process_mesh_and_refusals():
    mesh = create_mesh(None)
    assert mesh.shape == {"data": 1, "seq": 1} and mesh.size == 1
    assert mesh.frame_range(5) == (0, 5)
    assert mesh.batch_slice(3) == slice(0, 3)
    with pytest.raises(ValueError, match="'model'"):
        create_mesh({"data": 1, "model": 1})
    with pytest.raises(ValueError, match="spans 2 ranks"):
        create_mesh({"data": 2})


def test_frame_counts_and_shards():
    assert frame_counts(12, 2) == [6, 6]
    assert frame_counts(11, 2) == [6, 5]
    assert frame_counts(5, 4) == [2, 1, 1, 1]
    with pytest.raises(ValueError, match="cannot be split"):
        frame_counts(1, 2)
    shard = FrameShard((2, 1, 1, 1), 2, None)
    assert (shard.total, shard.start, shard.stop, shard.even) == (5, 3, 4,
                                                                  False)


def test_launch_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="(?s)rank 1:.*boom"):
        launch.run(workers.fail_on_rank, 2, args=(1,), device="cpu",
                   timeout=TIMEOUT, threads=1)


# --------------------------------------------------------------- weights

def _seeded_init(module, seed, *inputs):
    """Parameters for ``module`` shaped as its init makes them, filled from
    a numpy seed (tracing the init only: running it costs a minute on the
    CPU).  Kernels N(0, 1 / fan_in), norm scales 1 + N(0, 0.1), biases and
    the rest N(0, 0.05)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *inputs))["params"]
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = str(path[-1].key)
        r = rng.randn(*leaf.shape).astype(np.float32)
        if name == "kernel":
            return r * np.float32(np.prod(leaf.shape[:-1]) ** -0.5)
        if name == "scale":
            return 1.0 + 0.1 * r
        return 0.05 * r

    return jax.tree_util.tree_map_with_path(fill, shapes)


# ------------------------------------------------------------------ UNet

UNET_TWO = {
    "seq2-f4-ring": dict(mesh={"seq": 2}, f=4, cond_frame=0,
                         branch="ring_window_attention"),
    "seq2-f5-k6": dict(mesh={"seq": 2}, f=5, cond_frame=2,
                       branch="swat_attention"),
    "seq2-f4-ring-off-k1": dict(mesh={"seq": 2}, f=4, cond_frame=2,
                                ring=False, branch="swat_attention_tables"),
    "data2-f4": dict(mesh={"data": 2}, f=4, cond_frame=2,
                     branch="swat_attention_tables"),
}
UNET_FOUR = {
    "data2-seq2-f4": dict(mesh={"data": 2, "seq": 2}, f=4, cond_frame=2,
                          branch="ring_window_attention"),
    "data2-seq2-f5": dict(mesh={"data": 2, "seq": 2}, f=5, cond_frame=0,
                          branch="swat_attention"),
}


def _unet_inputs(f, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, f, 32, 32, 4).astype(np.float32)
    ctx = rng.randn(2, f, 77, 32).astype(np.float32)
    ts = np.array([500, 731], np.int32)
    return x, ctx, ts


@pytest.fixture(scope="module")
def unet_runs():
    """The JAX SeerUNet's outputs, and the port's under each mesh."""
    model = JSeerUNet(config=JUNetConfig(**TINY))
    # every proj_out non-zero, so each temporal site reaches the output
    jparams = _seeded_init(model, 0, jnp.zeros((1, 1, 8, 8, 4)),
                           jnp.zeros((1,), jnp.int32),
                           jnp.zeros((1, 1, 77, 32)), 0)
    params = jax.tree_util.tree_map(jnp.asarray, jparams)
    apply = jax.jit(lambda p, x, t, c, cf: model.apply({"params": p}, x, t,
                                                       c, cf),
                    static_argnums=(4,))
    runs, wants = {}, {}
    for cases, n in ((UNET_TWO, 2), (UNET_FOUR, 4)):
        sent = {}
        for name, c in cases.items():
            x, ctx, ts = _unet_inputs(c["f"], c["f"])
            sent[name] = dict(mesh=c["mesh"], x=x, ctx=ctx, ts=ts,
                              cond_frame=c["cond_frame"],
                              ring=c.get("ring", True))
            key = (c["f"], c["cond_frame"])
            if key not in wants:
                wants[key] = np.asarray(apply(
                    params, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
                    c["cond_frame"]))
            runs[name] = {"want": wants[key]}
        got = launch.run(workers.unet_cases, n, args=(TINY, jparams, sent),
                         device="cpu", timeout=TIMEOUT, threads=1)[0]
        for name in cases:
            runs[name].update(got[name])
        runs[f"ranks{n}"] = got["ranks"]
    return runs


@pytest.mark.parametrize("name", list(UNET_TWO) + list(UNET_FOUR))
def test_unet_under_mesh_matches_jax(unet_runs, name):
    run = unet_runs[name]
    case = {**UNET_TWO, **UNET_FOUR}[name]
    np.testing.assert_allclose(run["out"], run["want"], atol=2e-5, rtol=1e-5)
    # the first level (32 x 32, ws 8) took the branch the case is about
    assert run["calls"].get(case["branch"], 0) > 0, run["calls"]


@pytest.mark.parametrize("n", [2, 4])
def test_gather_across_hosts_joins_ranks_in_order(unet_runs, n):
    want = np.stack([np.arange(n), 10 * np.arange(n)], axis=1)
    np.testing.assert_array_equal(unet_runs[f"ranks{n}"], want)


# ----------------------------------------------------------------- train

UNET_T = dict(block_out_channels=(32, 64), layers_per_block=1,
              norm_num_groups=8, cross_attention_dim=32, attention_head_dim=4)
VAE = dict(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=8)
CLIP = dict(vocab_size=100, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=16)
FSTEXT = dict(n_heads=4, num_layers=1)
FRAMES, COND = 4, 2
TRAIN_MESHES = {"data2": {"data": 2}, "seq2": {"seq": 2}}


@pytest.fixture(scope="module")
def train_runs():
    """One JAX train step (``optax.trace(0)`` captures its gradients) on a
    global batch of 2, and the port's ``loss_and_grads`` on the same batch,
    noise and timesteps under each mesh."""
    kw = dict(dtype=jnp.float32, param_dtype=jnp.float32)
    unet_cfg = JUNetConfig(**UNET_T)
    mods = dict(
        unet=JSeerUNet(config=unet_cfg, **kw),
        fstext=JFSText(num_frames=FRAMES, in_channels=32, out_channels=32,
                       cross_attention_dim=32, **FSTEXT, **kw),
        vae=JVAE(config=JVAEConfig(**VAE), **kw),
        clip=JCLIP(config=JCLIPConfig(**CLIP), **kw))
    seq = CLIP["max_position_embeddings"]
    inputs = dict(
        unet=(jnp.zeros((1, FRAMES, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
              jnp.zeros((1, FRAMES, seq, 32)), 0),
        fstext=(jnp.zeros((1, seq, 32)),), vae=(jnp.zeros((1, 16, 16, 3)),),
        clip=(jnp.zeros((1, seq), jnp.int32),))
    jparams = {k: _seeded_init(m, i, *inputs[k])
               for i, (k, m) in enumerate(mods.items())}
    jm = JSeerModels(*mods.values(), *(
        jax.tree_util.tree_map(jnp.asarray, jparams[k]) for k in mods))
    rng = np.random.RandomState(11)
    b, res = 2, 16
    video = rng.uniform(-1, 1, (b, FRAMES, res, res, 3)).astype(np.float32)
    ids = rng.randint(0, 100, (b, 16)).astype(np.int32)
    mask = np.ones((b, 16), np.int32)
    jbatch = jtrainer.prepare_batch_fn(jm, sample_posterior=False)(
        jnp.asarray(video), jnp.asarray(ids), jnp.asarray(mask),
        jax.random.PRNGKey(3), cond_frames=COND)
    params = {"unet": jm.unet_params, "fstext": jm.fstext_params}
    trainable, frozen = jtrainer.partition_params(
        params, joptim.trainable_mask(params, "reference"))
    tx = optax.trace(decay=0.0)
    state = jtrainer.TrainState.create(
        jax.tree_util.tree_map(jnp.copy, trainable), tx)
    step = jtrainer.make_train_step(jm, tx, cond_frames=COND,
                                    frozen_params=frozen, text_loss=True)
    key = jax.random.PRNGKey(4)
    state, jmetrics = step(state, jbatch, key)
    k_noise, k_t = jax.random.split(jax.random.fold_in(key, 0))
    noise = np.asarray(jax.random.normal(
        k_noise, jbatch["latents"].shape, dtype=jnp.float32))
    ts = np.asarray(jax.random.randint(k_t, (b,), 0, 1000))
    jgrads = jax.tree_util.tree_map(np.asarray, state.opt_state.trace)

    sizes = dict(frames=FRAMES, cond=COND, unet=UNET_T, vae=VAE, clip=CLIP,
                 fstext=FSTEXT)
    batch = {k: np.asarray(v) for k, v in jbatch.items()}
    cases = {name: dict(mesh=mesh, noise=noise, ts=ts, text_loss=True)
             for name, mesh in TRAIN_MESHES.items()}
    got = launch.run(workers.train_cases, 2,
                     args=(sizes, jparams, batch, cases), device="cpu",
                     timeout=TIMEOUT, threads=1)
    return dict(jmetrics=jmetrics, jgrads=jgrads, got=got)


@pytest.mark.parametrize("name", list(TRAIN_MESHES))
def test_train_step_under_mesh_matches_jax(train_runs, name):
    got = train_runs["got"][0][name]
    jm = train_runs["jmetrics"]
    np.testing.assert_allclose(got["loss"], float(jm["loss"]), atol=1e-5)
    np.testing.assert_allclose(got["mse"], float(jm["mse"]), atol=1e-5)
    assert abs(got["loss"] - got["mse"]) > 1e-4   # text_loss is in
    modules = SeerModels.initialize(
        num_frames=FRAMES, unet_config=SeerUNetConfig(**UNET_T),
        vae_config=VAEConfig(**VAE), clip_config=CLIPTextConfig(**CLIP),
        fstext_kwargs=FSTEXT, device="cpu",
        dtype=torch.float32).trainable_modules()
    want = jax_subtree_to_named(train_runs["jgrads"], modules)
    assert set(want) == set(got["grads"])
    nonzero = 0
    for n, g in got["grads"].items():
        w = want[n].numpy()
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, atol=2e-5 * scale, rtol=1e-4,
                                   err_msg=n)
        nonzero += bool(np.abs(w).max() > 1e-6)
    assert nonzero > 0.9 * len(want)
    sums = [r[name]["checksum"] for r in train_runs["got"]]
    assert all(s == sums[0] for s in sums), sums

