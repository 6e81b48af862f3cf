"""Tensor parallelism over the ``model`` axis (``parallel/sharding.py``'s
last section) against the JAX package under the same mesh: the JAX models
placed by ``shard_params`` with the activation mesh registered, as
``__graft_entry__.py`` and ``tests/test_tp_no_remat.py`` build them; the
port on 2 or 4 gloo CPU ranks through ``parallel.launch`` (rank functions
in ``tests/torch_tp_workers.py``), each rank holding its slices.

- the rule table: each port weight's split against ``infer_param_sharding``
  for the converted JAX path at M = 2, on models with a CLIP of one head,
  whose attention weights divide over 2 ranks but whose heads do not: the
  JAX rule shards them, the port replicates them (a split falls on head
  boundaries);
- one UNet call, a CLIP encode and an FSText call under ``{model: 2}``,
  ``{data: 2, model: 2}`` and ``{model: 2, seq: 2}``, at atol 2e-5, rtol
  1e-5 (the bound of ``test_unet_under_mesh_matches_jax``);
- the cross-attention maps under ``{model: 2}`` (gathered over the heads)
  against a single rank's;
- the sampling knobs, which need no code of their own under ``model``
  (PAB caches the summed residual, ToMe and FreeU act on replicated
  tokens): 5-step loops under ``{model: 2}`` against one rank, rtol 1e-3
  (the bound of ``test_knobs_under_seq_match_one_rank``);
- the config and mesh accept ``model``, and ``zero1``, ``fsdp``, LoRA and
  8-bit beside it; serving and eval refuse any mesh.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seervideoldm_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from seervideoldm_tpu.models.clip_text import CLIPTextModel as JCLIP
from seervideoldm_tpu.models.fstext import FSTextTransformer as JFSText
from seervideoldm_tpu.models.unet3d import SeerUNet as JSeerUNet
from seervideoldm_tpu.models.unet3d import SeerUNetConfig as JUNetConfig
from seervideoldm_tpu.models.vae import AutoencoderKL as JVAE
from seervideoldm_tpu.models.vae import VAEConfig as JVAEConfig
from seervideoldm_tpu.ops.pallas import set_activation_mesh as jset_mesh
from seervideoldm_tpu.parallel.mesh import create_mesh as jcreate_mesh
from seervideoldm_tpu.parallel.mesh import video_sharding
from seervideoldm_tpu.parallel.sharding import (infer_param_sharding as
                                                jinfer_param_sharding,
                                                shard_params)
from seervideoldm_tpu_torch.config import config_from_dict
from seervideoldm_tpu_torch.io.convert import jax_subtree_to_named
from seervideoldm_tpu_torch.parallel import launch
from seervideoldm_tpu_torch.parallel.sharding import infer_param_sharding

import torch_tp_workers as workers
from test_torch_parallel import _seeded_init

TIMEOUT = 300
UNET = dict(block_out_channels=(32, 64), layers_per_block=1,
            norm_num_groups=8, cross_attention_dim=32, attention_head_dim=4)
VAE = dict(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=8)
CLIP = dict(vocab_size=100, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=16)
FSTEXT = dict(n_heads=4, num_layers=1)
FRAMES, COND = 4, 2
SIZES = dict(frames=FRAMES, cond=COND, unet=UNET, vae=VAE, clip=CLIP,
             fstext=FSTEXT)
MESHES_TWO = {"model2": {"model": 2}}
MESHES_FOUR = {"data2-model2": {"data": 2, "model": 2},
               "model2-seq2": {"model": 2, "seq": 2}}


def jax_modules(sizes=SIZES):
    """The JAX package's four modules at ``sizes`` (fp32) and the dummy
    inputs their init takes."""
    kw = dict(dtype=jnp.float32, param_dtype=jnp.float32)
    f, clip = sizes["frames"], sizes["clip"]
    ctx = sizes["unet"]["cross_attention_dim"]
    seq = clip["max_position_embeddings"]
    mods = dict(
        unet=JSeerUNet(config=JUNetConfig(**sizes["unet"]), **kw),
        fstext=JFSText(num_frames=f, in_channels=ctx, out_channels=ctx,
                       cross_attention_dim=ctx, **sizes["fstext"], **kw),
        vae=JVAE(config=JVAEConfig(**sizes["vae"]), **kw),
        clip=JCLIP(config=JCLIPConfig(**clip), **kw))
    inputs = dict(
        unet=(jnp.zeros((1, f, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
              jnp.zeros((1, f, seq, ctx)), 0),
        fstext=(jnp.zeros((1, seq, ctx)),), vae=(jnp.zeros((1, 16, 16, 3)),),
        clip=(jnp.zeros((1, seq), jnp.int32),))
    return mods, inputs


def seeded_params(sizes=SIZES):
    """The modules and numpy-seeded parameters for each (every
    ``proj_out`` non-zero)."""
    mods, inputs = jax_modules(sizes)
    return mods, {k: _seeded_init(m, i, *inputs[k])
                  for i, (k, m) in enumerate(mods.items())}


def under_mesh(shape, fn, *trees):
    """``fn(*trees)`` with ``trees`` placed by ``shard_params`` and the
    activation mesh registered (None: one device, nothing registered)."""
    if shape is None:
        return fn(*(jax.tree_util.tree_map(jnp.asarray, t) for t in trees))
    mesh = jcreate_mesh(shape)
    jset_mesh(mesh)
    try:
        return fn(mesh, *(shard_params(jax.tree_util.tree_map(jnp.asarray, t),
                                       mesh) for t in trees))
    finally:
        jset_mesh(None)


def _inputs():
    rng = np.random.RandomState(21)
    seq = CLIP["max_position_embeddings"]
    mask = np.ones((2, seq), np.int32)
    mask[0, 9:] = 0
    return dict(x=rng.randn(2, FRAMES, 32, 32, 4).astype(np.float32),
                ctx=rng.randn(2, FRAMES, seq, 32).astype(np.float32),
                ts=np.array([500, 731], np.int32), cond_frame=COND,
                ids=rng.randint(0, 100, (2, seq)).astype(np.int32),
                mask=mask, emb=rng.randn(2, seq, 32).astype(np.float32))


def _jax_forward(mods, jparams, inputs, shape):
    """The JAX package's UNet, CLIP and FSText outputs under ``shape``."""
    def run(mesh, unet_p, clip_p, fs_p):
        unet = mods["unet"]
        if mesh.shape.get("seq", 1) > 1:
            unet = unet.clone(activation_sharding=video_sharding(mesh))
        cf = inputs["cond_frame"]
        y = jax.jit(lambda p, x, t, c: unet.apply({"params": p}, x, t, c, cf))(
            unet_p, inputs["x"], inputs["ts"], inputs["ctx"])
        clip = jax.jit(lambda p, i, m: mods["clip"].apply({"params": p}, i, m))(
            clip_p, inputs["ids"], inputs["mask"])
        fs = jax.jit(lambda p, e: mods["fstext"].apply({"params": p}, e))(
            fs_p, inputs["emb"])
        return {k: np.asarray(v) for k, v in
                (("unet", y), ("clip", clip), ("fstext", fs))}

    return under_mesh(shape, run, jparams["unet"], jparams["clip"],
                      jparams["fstext"])


@pytest.fixture(scope="module")
def forward_runs():
    mods, jparams = seeded_params()
    inputs = _inputs()
    want = {name: _jax_forward(mods, jparams, inputs, shape)
            for name, shape in {**MESHES_TWO, **MESHES_FOUR}.items()}
    got = {}
    for meshes, n in ((MESHES_TWO, 2), (MESHES_FOUR, 4)):
        cases = {name: dict(mesh=shape, maps=n == 2)
                 for name, shape in meshes.items()}
        got.update(launch.run(workers.forward_cases, n,
                              args=(SIZES, jparams, inputs, cases),
                              device="cpu", timeout=TIMEOUT, threads=1)[0])
    return dict(want=want, got=got, jparams=jparams, inputs=inputs)


@pytest.mark.parametrize("name", list(MESHES_TWO) + list(MESHES_FOUR))
@pytest.mark.parametrize("part", ["unet", "clip", "fstext"])
def test_forward_under_model_axis_matches_jax(forward_runs, name, part):
    got = forward_runs["got"][name][part]
    want = forward_runs["want"][name][part]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("name", list(MESHES_TWO) + list(MESHES_FOUR))
def test_each_rank_holds_its_slices(forward_runs, name):
    """Every attention of the UNet runs 2 of its 4 heads; the split
    weights are those the rules name, and this rank's parameter bytes are
    the replicated weights plus half the split ones."""
    got = forward_runs["got"][name]
    assert set(got["heads"].values()) == {2}, got["heads"]
    models = workers.build(SIZES, forward_runs["jparams"])
    splits = infer_param_sharding(models, 2)
    assert got["splits"] == sorted(splits)
    whole = {f"{k}.{n}": p for k, m in zip(("unet", "fstext", "vae", "clip"),
                                            models.modules())
             for n, p in m.named_parameters()}
    split_bytes = sum(whole[n].numel() * 4 for n in splits)
    total = sum(p.numel() * 4 for p in whole.values())
    assert got["param_bytes"] == total - split_bytes // 2


def test_attention_maps_under_model_axis_equal_one_rank(forward_runs):
    models = workers.build(SIZES, forward_runs["jparams"])
    models.unet.collect_attn = True
    inputs, maps = forward_runs["inputs"], {}
    with torch.no_grad():
        models.unet(torch.from_numpy(inputs["x"]),
                    torch.from_numpy(inputs["ts"]),
                    torch.from_numpy(inputs["ctx"]),
                    cond_frame=inputs["cond_frame"], attn_maps=maps)
    got = forward_runs["got"]["model2"]["maps"]
    assert maps and set(got) == set(maps)
    for site, want in maps.items():
        assert got[site].shape == tuple(want.shape)      # every head
        np.testing.assert_allclose(got[site], want.numpy(), atol=2e-5,
                                   rtol=1e-5, err_msg=site)


KNOB_CASES = {
    "pab": dict(sampler="ddim", pab=(2, 3, 2)),
    "dpmpp_rescale": dict(sampler="dpm++", guidance_rescale=0.7),
    "tome_freeu": dict(sampler="ddim", unet=dict(
        tome_ratio=0.5, tome_min_tokens=256, freeu=(1.5, 1.6, 0.9, 0.2))),
}


@pytest.fixture(scope="module")
def knob_runs():
    jparams = seeded_params()[1]
    rng = np.random.RandomState(23)
    sent = dict(x_T=rng.randn(1, 2, 16, 16, 4).astype(np.float32),
                x0=rng.randn(1, 2, 16, 16, 4).astype(np.float32),
                ctx=rng.randn(1, FRAMES, 16, 32).astype(np.float32),
                unc=rng.randn(1, FRAMES, 16, 32).astype(np.float32))
    return [launch.run(workers.knob_cases, n,
                       args=(SIZES, jparams, sent, KNOB_CASES, shape),
                       device="cpu", timeout=TIMEOUT, threads=1)[0]
            for n, shape in ((1, None), (2, {"model": 2}))]


@pytest.mark.parametrize("name", list(KNOB_CASES))
def test_knobs_under_model_axis_match_one_rank(knob_runs, name):
    one, two = knob_runs
    assert np.abs(one[name]).max() > 0
    np.testing.assert_allclose(two[name], one[name], rtol=1e-3, atol=1e-4)


# ----------------------------------------------------------- rule table

CODES = {(): 0, (None, "model"): 1, ("model", None): 2}


def test_rule_table_matches_jax_infer_param_sharding():
    """Codes 0 (replicated), 1 (output features split, JAX ``P(None,
    'model')``, the port's dim 0) and 2 (input features, ``P('model',
    None)``, dim 1), per weight.  The CLIP here has one head: its
    attention weights divide over 2 ranks, so the JAX rule shards them,
    but its one head does not, so the port replicates that attention
    whole.  Biases: the JAX rules shard kernels only (GSPMD splits a
    column bias's use itself); the port cuts a column weight's bias with
    it and keeps a row weight's whole."""
    sizes = dict(SIZES, clip=dict(CLIP, num_attention_heads=1))
    mods, inputs = jax_modules(sizes)
    mesh = jcreate_mesh({"model": 2})
    codes = {}
    for i, (key, m) in enumerate(mods.items()):
        shapes = jax.eval_shape(lambda m=m, k=key: m.init(
            jax.random.PRNGKey(0), *inputs[k]))["params"]
        specs = jinfer_param_sharding(shapes, mesh)
        codes[key] = jax.tree_util.tree_map(
            lambda s, leaf: np.full(leaf.shape,
                                    CODES[tuple(s.spec)], np.float32),
            specs, shapes)
    models = workers.build(sizes, seeded_params(sizes)[1])
    want = jax_subtree_to_named(codes, dict(zip(
        ("unet", "fstext", "vae", "clip"), models.modules())))
    splits = infer_param_sharding(models, 2)
    port = {n: 0 if n not in splits else 1 + splits[n].dim for n in want}
    jax_code = {n: int(t.flatten()[0]) for n, t in want.items()}
    clip_attn = {n for n in want if n.startswith("clip.")
                 and ".self_attn." in n and n.endswith(".weight")}
    assert len(clip_attn) == 8 and all(jax_code[n] for n in clip_attn)
    weights = [n for n in want if n.endswith(".weight")]
    for n in weights:
        expect = 0 if n in clip_attn else jax_code[n]
        assert port[n] == expect, (n, port[n], jax_code[n])
    assert sum(bool(port[n]) for n in weights) >= 40
    for n in want:
        if n.endswith(".bias"):
            stem = n[:-len("bias")] + "weight"
            assert port[n] == (1 if port.get(stem) == 1 else 0), n
    # the VAE's attention (query / key / value) matches no rule
    assert not any(n.startswith("vae.") for n in splits)
    # the GEGLU projection keeps its slice of both halves
    geglu = [n for n in splits if n.endswith("ff.net.0.proj.weight")]
    assert geglu and all(splits[n].halves == 2 for n in geglu)


# ------------------------------------------------------ config and mesh

def test_config_accepts_model_axis():
    cfg = config_from_dict({"mesh_shape": {"data": 2, "model": 2}})
    assert cfg.mesh_shape == {"data": 2, "model": 2}


@pytest.mark.parametrize("raw,name", [
    ({"zero1": True}, "zero1"), ({"fsdp": True}, "fsdp"),
    ({"lora_rank": 4}, "lora_rank"), ({"use_8bit_adam": True},
                                      "use_8bit_adam")])
def test_config_accepts_each_strategy_beside_model_axis(raw, name):
    """Every training strategy the JAX entry places on any mesh is taken
    beside a ``model`` axis of more than one rank (the train entry runs
    them: ``tests/test_torch_tensor_parallel_strategies.py``); the JAX
    entry's own checks still hold (LoRA with the reference scope only)."""
    for shape in ({"data": 2, "model": 2}, {"model": 2},
                  {"data": 2, "model": 1}):
        cfg = config_from_dict({"mesh_shape": shape, **raw})
        assert cfg.get(name) == raw[name] and cfg.mesh_shape == shape
    if name == "lora_rank":
        with pytest.raises(ValueError, match="trainable_scope"):
            config_from_dict({"mesh_shape": {"data": 2, "model": 2}, **raw,
                              "trainable_scope": "all"})


@pytest.mark.parametrize("entry", ["serve", "eval"])
def test_serving_and_eval_refuse_a_model_mesh(entry, tmp_path):
    import yaml

    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.dump({"mesh_shape": {"model": 2},
                               "output_dir": str(tmp_path)}))
    if entry == "serve":
        from seervideoldm_tpu_torch.serve import main
    else:
        from seervideoldm_tpu_torch.eval import main
    with pytest.raises(ValueError, match="mesh_shape"):
        main(["--config", str(path), "--device", "cpu"])


def test_mesh_layout_on_two_and_four_ranks():
    got = launch.run(workers.layout_case, 4, device="cpu", timeout=TIMEOUT,
                     threads=1)
    # rank = (d * M + m) * S + s
    assert [r["coords"] for r in got] == [
        {"data": 0, "model": 0, "seq": 0}, {"data": 0, "model": 0, "seq": 1},
        {"data": 0, "model": 1, "seq": 0}, {"data": 0, "model": 1, "seq": 1}]
    # the model group joins ranks 0, 2 and 1, 3; the replicas of model
    # index m are its seq ranks
    assert [r["model_peers"] for r in got] == [[0, 2], [1, 3], [0, 2], [1, 3]]
    assert [r["replica_peers"] for r in got] == [[0, 1], [0, 1], [2, 3],
                                                 [2, 3]]
    assert all(r["frames"] == ((0, 3), (3, 5))[r["coords"]["seq"]]
               for r in got)

