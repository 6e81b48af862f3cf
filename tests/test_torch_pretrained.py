"""The port's pretrained-weight path (``io/state_dict.py``,
``io/pretrained.py``, ``pipelines/loading.py::load_pretrained``) on the
CPU:

- the ``.safetensors`` reader against files the ``safetensors`` package
  writes (F32, F16, BF16, I64, with ``__metadata__``), bit for bit, and the
  port's writer read back by the package; ``.bin`` through ``torch.load``;
- a toy diffusers directory written from seeded numpy tensors (the VAE
  under diffusers' newer attention names, ``position_ids`` in the text
  encoder, the 2D UNet keys only in fp16, an FSText ``.bin``) read by the
  JAX ``load_models`` and the port's: every loaded tensor equals the JAX
  one through ``io/convert.py``'s mapping, the port's fresh set is the
  temporal attentions, and with JAX's fresh temporal weights carried
  across one SeerUNet call, one VAE encode + decode and one CLIP call
  agree within 1e-5 relative L2 in fp32;
- at full width on meta tensors, the manifests' SD-1.5 key sets map onto
  the port's modules and leave exactly ``seer_unet - sd15_unet_2d`` (320
  keys) fresh;
- ``fstext_init_ckpt`` under ``trainable_scope="reference"`` moves the
  FSText masters; on 2 gloo ranks seeded differently every rank ends with
  the file's values and rank 0's fresh ones;
- a named directory or file that is missing raises.
"""
import json
import os

import jax
import numpy as np
import pytest
import safetensors.torch
import torch
import yaml

from seervideoldm_tpu_torch.config import config_from_dict
from seervideoldm_tpu_torch.io.convert import jax_to_state_dict
from seervideoldm_tpu_torch.io.pretrained import (NEWER_VAE_NAMES,
                                                  convert_clip_text,
                                                  convert_seer_unet, convert_vae)
from seervideoldm_tpu_torch.io.state_dict import (load_state_dict,
                                                  read_safetensors,
                                                  write_safetensors)
from seervideoldm_tpu_torch.models.clip_text import CLIPTextModel
from seervideoldm_tpu_torch.models.unet3d import SeerUNet
from seervideoldm_tpu_torch.models.vae import AutoencoderKL
from seervideoldm_tpu_torch.pipelines.loading import load_models

from test_torch_train_entry import TINY_OVERRIDES

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFESTS = os.path.join(ROOT, "seervideoldm_tpu", "io",
                         "reference_manifests.json")
TOY = dict(num_frames=4, resolution=32, mixed_precision="no", seed=0,
           model_overrides=TINY_OVERRIDES)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ------------------------------------------------------------------ reader

@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16, torch.int64])
def test_safetensors_reader_matches_package(tmp_path, dtype):
    g = torch.Generator().manual_seed(1)
    make = ((lambda s: torch.randint(-2 ** 40, 2 ** 40, s, generator=g))
            if dtype == torch.int64 else
            (lambda s: torch.randn(s, generator=g).to(dtype)))
    tensors = {"a.weight": make((3, 5)), "b": make((7,)), "c.scalar": make(()),
               "d.empty": make((0, 4)), "e.block": make((2, 3, 4))}
    path = str(tmp_path / "t.safetensors")
    safetensors.torch.save_file(tensors, path, metadata={"format": "pt"})
    got = read_safetensors(path)
    assert sorted(got) == sorted(tensors)
    for k, want in tensors.items():
        assert got[k].dtype == dtype and got[k].shape == want.shape
        assert torch.equal(got[k].view(-1).view(torch.uint8)
                           if got[k].numel() else got[k],
                           want.view(-1).view(torch.uint8)
                           if want.numel() else want), k
    assert load_state_dict(path).keys() == got.keys()


def test_safetensors_writer_is_read_by_package(tmp_path):
    g = torch.Generator().manual_seed(2)
    tensors = {"x": torch.randn(4, 3, generator=g),
               "y": torch.randn(5, generator=g).to(torch.bfloat16),
               "z": torch.randn(2, 2, generator=g).half(),
               "ids": torch.arange(77)[None]}
    path = str(tmp_path / "w.safetensors")
    n = write_safetensors(tensors, path, metadata={"format": "pt"})
    assert n == os.path.getsize(path)
    back = safetensors.torch.load_file(path)
    for k, want in tensors.items():
        assert back[k].dtype == want.dtype and torch.equal(back[k], want), k
    for k, want in read_safetensors(path).items():
        assert torch.equal(want, tensors[k]), k


def test_reader_refuses_offsets_outside_the_file(tmp_path):
    path = str(tmp_path / "bad.safetensors")
    write_safetensors({"x": torch.zeros(4)}, path)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 4)
    with pytest.raises(ValueError, match="offsets"):
        read_safetensors(path)


def test_bin_files_load_with_and_without_a_state_dict_wrapper(tmp_path):
    sd = {"w": torch.randn(3, 2), "n": torch.tensor(7)}
    torch.save(sd, tmp_path / "a.bin")
    torch.save({"state_dict": sd}, tmp_path / "b.pt")
    for name in ("a.bin", "b.pt"):
        got = load_state_dict(str(tmp_path / name))
        assert got.keys() == sd.keys()
        assert all(torch.equal(got[k], sd[k]) for k in sd)


# ------------------------------------------------- a toy diffusers directory

def _random_sd(module: torch.nn.Module, seed: int, skip=lambda k: False):
    """Seeded numpy values under ``module``'s keys (norm weights near 1)."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in module.state_dict().items():
        if skip(k):
            continue
        a = rng.randn(*v.shape).astype(np.float32) * 0.2
        if k.endswith("weight") and v.ndim == 1:
            a += 1.0
        out[k] = torch.from_numpy(a)
    return out


def _newer_vae_names(sd: dict) -> dict:
    out = {}
    for k, v in sd.items():
        for new, old in NEWER_VAE_NAMES.items():
            k = k.replace(f"mid_block.attentions.0.{old}.",
                          f"mid_block.attentions.0.{new}.")
        out[k] = v
    return out


def write_toy_dir(root: str, models) -> dict:
    """A diffusers-layout directory for ``models``' widths and an FSText
    ``.bin``; returns the source tensors by module (port names)."""
    src = {"vae": _random_sd(models.vae, 11),
           "clip": _random_sd(models.clip, 12),
           "unet": _random_sd(models.unet, 13, skip=lambda k: (
               "temporal_attentions" in k or k.endswith("rotary_emb.freqs"))),
           "fstext": _random_sd(models.fstext, 14)}
    src["unet"] = {k: v.half() for k, v in src["unet"].items()}
    for d in ("vae", "text_encoder", "unet"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    torch.save(_newer_vae_names(src["vae"]),
               os.path.join(root, "vae", "diffusion_pytorch_model.bin"))
    n = src["clip"]["text_model.embeddings.position_embedding.weight"].shape[0]
    safetensors.torch.save_file(
        {**src["clip"], "text_model.embeddings.position_ids":
         torch.arange(n)[None]},
        os.path.join(root, "text_encoder", "model.safetensors"))
    safetensors.torch.save_file(
        src["unet"], os.path.join(root, "unet",
                                  "diffusion_pytorch_model.safetensors"),
        metadata={"format": "pt"})
    torch.save(src["fstext"], os.path.join(root, "fstext.bin"))
    return src


def _toy_raw(root: str, **over) -> dict:
    return dict(TOY, pretrained_model_name_or_path=root,
                fstext_init_ckpt=os.path.join(root, "fstext.bin"), **over)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sd15"))
    shell, _ = load_models(config_from_dict(TOY), "cpu")
    src = write_toy_dir(root, shell)
    raw = _toy_raw(root)
    models, _ = load_models(config_from_dict(raw), "cpu")

    from seervideoldm_tpu.config import load_config as jax_load_config
    from seervideoldm_tpu.pipelines.loading import load_models as jax_load_models

    path = os.path.join(root, "toy.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    jmodels, _ = jax_load_models(jax_load_config(path), jax.random.PRNGKey(3))
    return dict(root=root, src=src, models=models, jax=jmodels)


def test_loaded_tensors_equal_the_jax_load(toy):
    """VAE, CLIP and FSText whole, SeerUNet outside its temporal
    attentions: the port's loaded tensors equal the JAX package's through
    ``io/convert.py``'s mapping, and the file's values cast to fp32."""
    jm = toy["jax"]
    for key, params in (("vae", jm.vae_params), ("clip", jm.clip_params),
                        ("fstext", jm.fstext_params),
                        ("unet", jm.unet_params)):
        module = getattr(toy["models"], key)
        want = jax_to_state_dict(jax.tree_util.tree_map(np.asarray, params),
                                 module)
        got = module.state_dict()
        src = toy["src"][key]
        for k in src:
            if not k.endswith("rotary_emb.freqs"):  # recomputed, not read
                assert torch.equal(got[k], src[k].float()), (key, k)
            assert torch.equal(got[k], want[k]), (key, k)
        if key != "unet":
            assert set(src) == set(got), key


def test_fresh_set_is_the_temporal_attentions(toy):
    unet = toy["models"].unet
    src = toy["src"]["unet"]
    fresh = [k for k in unet.state_dict() if k not in src]
    assert fresh and all("temporal_attentions" in k for k in fresh)
    assert set(fresh) == {k for k in unet.state_dict()
                          if "temporal_attentions" in k}
    # a second load of the same file reports the same fresh set
    assert sorted(convert_seer_unet(src, unet)) == sorted(fresh)


def test_unet_vae_clip_calls_match_jax(toy):
    """One SeerUNet call (proj_out of the temporal sites made non-zero in
    both packages first), one VAE encode + decode and one CLIP call on the
    loaded weights, fp32, against the JAX package on its loaded weights:
    relative L2 <= 1e-5."""
    jm, models = toy["jax"], toy["models"]
    jparams = jax.tree_util.tree_map(np.asarray, jm.unet_params)
    rng = np.random.RandomState(5)
    _perturb_temporal_proj_out(jparams, rng)
    models.unet.load_state_dict(
        {k: v for k, v in jax_to_state_dict(jparams, models.unet).items()
         if "temporal_attentions" in k}, strict=False)

    x = rng.randn(2, 4, 4, 4, 4).astype(np.float32)
    t = np.array([981, 500], np.int32)
    ctx = rng.randn(2, 4, 77, 32).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, *a: jm.unet.apply({"params": p}, *a, 1))(
        jparams, x, t, ctx))
    with torch.no_grad():
        got = models.unet(torch.from_numpy(x), torch.from_numpy(t),
                          torch.from_numpy(ctx), cond_frame=1).numpy()
    assert _rel(got, want) <= 1e-5

    video = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    vp = {"params": jm.vae_params}
    mean, _ = jax.jit(lambda v: jm.vae.apply(vp, v, method=jm.vae.encode_moments))(
        video)
    dec = jax.jit(lambda z: jm.vae.apply(vp, z, method=jm.vae.decode))(mean)
    with torch.no_grad():
        got_mean = models.vae.encode(torch.from_numpy(video), None)
        got_dec = models.vae.decode(got_mean)
    assert _rel(got_mean.numpy(), mean) <= 1e-5
    assert _rel(got_dec.numpy(), dec) <= 1e-5

    ids = rng.randint(0, 49408, (2, 77)).astype(np.int32)
    mask = np.ones((2, 77), np.int32)
    mask[1, 20:] = 0
    want = jax.jit(lambda i, m: jm.clip.apply({"params": jm.clip_params}, i, m))(
        ids, mask)
    with torch.no_grad():
        got = models.clip(torch.from_numpy(ids), torch.from_numpy(mask))
    assert _rel(got.numpy(), want) <= 1e-5


def _perturb_temporal_proj_out(tree, rng, state=None):
    """Non-zero values for every leaf under a ``proj_out`` of a temporal
    attention in a JAX parameter tree (numpy, in place)."""
    state = state or (False, False)
    for k, v in tree.items():
        inside = state[0] or k.startswith("temporal_attentions")
        proj = state[1] or (inside and k == "proj_out")
        if isinstance(v, dict):
            _perturb_temporal_proj_out(v, rng, (inside, proj))
        elif proj:
            tree[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)


def test_unet_perturbation_reaches_temporal_proj_out(toy):
    """The perturbation above changes every temporal ``proj_out`` tensor
    of the carried weights, so the UNet check sees the temporal sites."""
    jparams = jax.tree_util.tree_map(np.asarray, toy["jax"].unet_params)
    _perturb_temporal_proj_out(jparams, np.random.RandomState(0))
    sd = jax_to_state_dict(jparams, toy["models"].unet)
    keys = [k for k in sd if "temporal_attentions" in k and ".proj_out." in k]
    assert keys and all(float(sd[k].abs().sum()) > 0 for k in keys)


# ------------------------------------------------------ full width, meta

def _manifest():
    with open(MANIFESTS) as f:
        return json.load(f)


def _meta_sd(shapes: dict) -> dict:
    return {k: torch.empty(v, device="meta") for k, v in shapes.items()}


def test_full_width_sd15_keys_map_onto_the_port():
    """The manifests' SD-1.5 VAE (under the newer attention names), CLIP
    text (with ``position_ids``) and 2D UNet key sets load onto the port's
    full-width modules on meta tensors; the fresh set is exactly
    ``seer_unet - sd15_unet_2d``."""
    man = _manifest()
    with torch.device("meta"):
        vae, clip, unet = AutoencoderKL(), CLIPTextModel(), SeerUNet()
    vae_sd = _newer_vae_names(_meta_sd(man["sd15_vae"]))
    assert any(".to_q." in k for k in vae_sd)
    assert convert_vae(vae_sd, vae) == []
    clip_sd = _meta_sd(man["sd15_clip_text"])
    clip_sd["text_model.embeddings.position_ids"] = torch.empty(
        1, 77, dtype=torch.long, device="meta")
    assert convert_clip_text(clip_sd, clip) == []
    fresh = convert_seer_unet(_meta_sd(man["sd15_unet_2d"]), unet)
    want = set(man["seer_unet"]) - set(man["sd15_unet_2d"])
    assert len(want) == 320 and set(fresh) == want
    assert any(k.endswith("rotary_emb.freqs") for k in fresh)


def test_misnamed_or_misshapen_keys_raise():
    man = _manifest()
    with torch.device("meta"):
        vae, unet = AutoencoderKL(), SeerUNet()
    sd = _meta_sd(man["sd15_vae"])
    sd["decoder.conv_in.weight"] = torch.empty(3, 3, device="meta")
    with pytest.raises(ValueError, match="decoder.conv_in.weight"):
        convert_vae(sd, vae)
    sd = _meta_sd(man["sd15_unet_2d"])
    sd.pop("conv_in.weight")  # a spatial tensor may not stay fresh
    with pytest.raises(ValueError, match="outside the temporal"):
        convert_seer_unet(sd, unet)
    sd = _meta_sd(man["sd15_unet_2d"])
    sd["down_blocks.0.bogus.weight"] = torch.empty(1, device="meta")
    with pytest.raises(ValueError, match="no such tensor"):
        convert_seer_unet(sd, unet)


# ------------------------------------------------------ masters and ranks

def test_fstext_init_moves_the_fstext_masters(toy):
    """Under ``trainable_scope="reference"`` the FSText masters take the
    file's values (fp32), the compute copies their rounding, and the
    temporal-attention masters keep the seeded init."""
    raw = _toy_raw(toy["root"], seed=5)
    models, _ = load_models(config_from_dict(raw), "cpu",
                            trainable_scope="reference")
    seeded, _ = load_models(config_from_dict(dict(TOY, seed=5)), "cpu",
                            trainable_scope="reference")
    src = toy["src"]["fstext"]
    fst = [n for n in models.masters if n.startswith("fstext.")]
    assert fst and len(fst) == len(
        [k for k in src if not k.endswith("rotary_emb.freqs")])
    for n in fst:
        assert torch.equal(models.masters[n], src[n.partition(".")[2]]), n
        assert not torch.equal(seeded.masters[n], models.masters[n]), n
    for n in models.masters:
        if n.startswith("unet."):
            assert torch.equal(models.masters[n], seeded.masters[n]), n


def pretrained_ranks(rank, raw):
    """Rank function (a spawned gloo rank): ``load_models`` with the
    pretrained files, seeded by rank (20 + rank), built for training;
    this rank's state dicts and masters as numpy."""
    models, _ = load_models(config_from_dict(dict(raw, seed=20 + rank)),
                            "cpu", trainable_scope="reference")
    out = {key: {k: v.float().numpy() for k, v in m.state_dict().items()}
           for key, m in (("vae", models.vae), ("clip", models.clip),
                          ("unet", models.unet), ("fstext", models.fstext))}
    out["masters"] = {n: t.numpy() for n, t in models.masters.items()}
    return out


def test_two_ranks_load_before_the_broadcast(toy):
    """2 gloo ranks with different seeds: both end with the files' values
    and rank 0's fresh temporal weights (the broadcast runs after the
    loads), and equal FSText masters."""
    from seervideoldm_tpu_torch.parallel import launch

    raw = _toy_raw(toy["root"])
    got = launch.run(pretrained_ranks, 2, args=(raw,), device="cpu",
                     backend="gloo", timeout=300, threads=1)
    rank0, _ = load_models(config_from_dict(dict(raw, seed=20)), "cpu")
    for out in got:
        for key, src in toy["src"].items():
            for k, v in src.items():
                if not k.endswith("rotary_emb.freqs"):  # recomputed
                    np.testing.assert_array_equal(
                        out[key][k], v.float().numpy(), err_msg=f"{key} {k}")
        for k, v in rank0.unet.state_dict().items():
            if "temporal_attentions" in k:
                np.testing.assert_array_equal(out["unet"][k], v.numpy(),
                                              err_msg=k)
        for n, v in got[0]["masters"].items():
            np.testing.assert_array_equal(out["masters"][n], v, err_msg=n)


# ---------------------------------------------------------------- errors

@pytest.mark.parametrize("what", ["root", "vae", "text_encoder", "unet",
                                  "fstext"])
def test_a_named_but_missing_path_raises(toy, tmp_path, what):
    """JAX skips a missing directory or file; the port raises naming it."""
    import shutil

    root = str(tmp_path / "sd15")
    shutil.copytree(toy["root"], root)
    raw = _toy_raw(root)
    if what == "root":
        raw["pretrained_model_name_or_path"] = root + "_typo"
    elif what == "fstext":
        raw["fstext_init_ckpt"] = root + "/nope.bin"
    else:
        shutil.rmtree(os.path.join(root, what))
    with pytest.raises(FileNotFoundError, match="typo|nope|" + what):
        load_models(config_from_dict(raw), "cpu")


def test_config_takes_the_pretrained_keys():
    cfg = config_from_dict({"pretrained_model_name_or_path": "/models/sd15",
                            "fstext_init_ckpt": "fstext.bin"})
    assert cfg.pretrained_model_name_or_path == "/models/sd15"
    assert cfg.fstext_init_ckpt == "fstext.bin"
