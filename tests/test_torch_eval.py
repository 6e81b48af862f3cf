"""The port's evaluation path (``seervideoldm_tpu_torch/evaluation``, the
``eval`` entry) against the JAX package on the CPU, fp32, same inputs from
numpy seeds and the same weights through files both loaders read:

- ``preprocess_videos`` at 256 -> 224, 64 -> 224, (32, 48) -> (224, 336)
  and (120, 160) -> (224, 299) crops: <= 1e-6; ``frechet_distance`` and
  ``polynomial_mmd``: 1e-10 relative; the loud error below 9 frames;
- I3D at full width, batch 1, 224 px, 9 frames (odd: asymmetric SAME
  pads) and 10 (even), from a ``.pt`` in the reference's names: logits
  <= 1e-4 relative L2; the strict loader's errors;
- C3D on 16 frames at 32 x 40 (resized to 112) from a chainer ``.npz`` +
  ``mean2.npz``: <= 1e-4; the cover-all pool against ``ceil_mode``; the
  16-frame contract;
- the Inception Score on the same classifier outputs, with enough batches
  and with fewer batches than splits;
- CLIPSIM: ``preprocess_frames`` against JAX's cubic resize (<= 1e-5); a
  toy CLIP from a synthesized HF ``CLIPModel`` state dict through both
  packages' converters and ``make_clip_sim_fn``: <= 1e-5 relative;
- the ``eval`` entry at toy width on the CPU (``--device cpu``) on a
  synthetic Something-Something-v2 val tree: it reaches the ``Final``
  lines, the small-valset flush fires both independent branches, and the
  clips it scored give the JAX ``FVDEvaluator`` (same I3D file) the same
  FVD and KVD to 1e-6 relative; ``configs/eval.yaml`` parses unchanged.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from seervideoldm_tpu_torch.evaluation import c3d as tc3d
from seervideoldm_tpu_torch.evaluation import clip_sim as tclip
from seervideoldm_tpu_torch.evaluation import fvd as tfvd
from seervideoldm_tpu_torch.evaluation import i3d as ti3d
from seervideoldm_tpu_torch.evaluation.inception_score import inception_score

from test_torch_train_entry import TINY_OVERRIDES, _make_sthv2

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ------------------------------------------------------------------- FVD

@pytest.mark.parametrize("h,w", [(256, 256), (64, 64), (32, 48), (120, 160)])
def test_preprocess_videos_matches_jax(h, w):
    from seervideoldm_tpu.evaluation.fvd import preprocess_videos

    vids = np.random.RandomState(h + w).randint(0, 256, (2, 3, h, w, 3),
                                                dtype=np.uint8)
    want = preprocess_videos(vids)
    got = tfvd.preprocess_videos(vids).numpy()
    assert got.shape == want.shape == (2, 3, 224, 224, 3)
    assert float(np.abs(got - want).max()) <= 1e-6


def test_frechet_distance_and_mmd_match_jax():
    from seervideoldm_tpu.evaluation import fvd as jfvd

    rng = np.random.RandomState(3)
    x = rng.randn(40, 24) * 2.0
    y = rng.randn(36, 24) + 0.5
    for fn in ("frechet_distance", "polynomial_mmd"):
        want = getattr(jfvd, fn)(x, y)
        got = getattr(tfvd, fn)(x, y)
        assert abs(got - want) <= 1e-10 * abs(want), fn
    assert abs(tfvd.frechet_distance(x, x)) < 1e-8


def test_fvd_refuses_fewer_than_nine_frames():
    ev = tfvd.FVDEvaluator(ti3d.InceptionI3d())
    with pytest.raises(ValueError, match=">= 9 frames"):
        ev.embed(np.zeros((1, 8, 16, 16, 3), np.uint8))


# ------------------------------------------------------------------- I3D

def write_i3d_pt(path: str, seed: int = 1234) -> dict:
    """Seeded weights under the reference I3D's names (with its
    ``num_batches_tracked`` counters): He-scaled kernels (sqrt(2 / fan-in))
    and small biases, so the 22-layer ReLU stack keeps different clips'
    embeddings apart.  At 1 / sqrt(fan-in) every clip's embedding is the
    same vector within 3 %, and FVD / KVD then cancel most of their
    digits."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in ti3d.InceptionI3d().state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("running_var"):
            a = rng.rand(*shape) * 0.5 + 0.5
        elif k.endswith("running_mean") or k.endswith("bias"):
            a = rng.randn(*shape) * 0.1
        elif k.endswith("bn.weight"):
            a = rng.rand(*shape) * 0.5 + 0.75
        else:
            a = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        sd[k] = torch.from_numpy(a.astype(np.float32))
        if k.endswith("running_var"):
            sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(0)
    torch.save(sd, path)
    return sd


@pytest.fixture(scope="module")
def i3d_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("i3d") / "i3d_pretrained_400.pt")
    write_i3d_pt(path)
    return path


def _jax_i3d(path, t):
    from seervideoldm_tpu.evaluation.i3d import InceptionI3d, load_i3d_params

    model = InceptionI3d()
    template = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, t, 224, 224, 3)))["params"]
    return model, load_i3d_params(path, template)


@pytest.mark.parametrize("t", [9, 10])
def test_i3d_logits_match_jax(i3d_file, t):
    model, params = _jax_i3d(i3d_file, t)
    video = np.random.RandomState(t).uniform(
        -1, 1, (1, t, 224, 224, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, v: model.apply({"params": p}, v))(
        params, video))
    i3d = ti3d.load_i3d_params(i3d_file, ti3d.InceptionI3d().eval())
    with torch.no_grad():
        got = i3d(torch.from_numpy(video).permute(0, 4, 1, 2, 3)).numpy()
    assert got.shape == want.shape == (1, 400)
    assert float(np.abs(want).max()) > 1e-3
    assert _rel(got, want) <= 1e-4


def test_i3d_loader_raises_on_missing_or_misshapen_keys(tmp_path, i3d_file):
    sd = torch.load(i3d_file)
    bad = dict(sd)
    bad.pop("Mixed_4c.b1b.conv3d.weight")
    torch.save(bad, tmp_path / "missing.pt")
    with pytest.raises(ValueError, match="1 missing"):
        ti3d.load_i3d_params(str(tmp_path / "missing.pt"), ti3d.InceptionI3d())
    bad = dict(sd)
    bad["logits.conv3d.bias"] = torch.zeros(401)
    torch.save(bad, tmp_path / "shape.pt")
    with pytest.raises(ValueError, match="logits.conv3d.bias"):
        ti3d.load_i3d_params(str(tmp_path / "shape.pt"), ti3d.InceptionI3d())


@pytest.mark.parametrize("n,k,s", [(9, 7, 2), (10, 7, 2), (5, 3, 2),
                                   (56, 3, 2), (4, 2, 2), (7, 3, 1)])
def test_same_pads_match_tf_same(n, k, s):
    """The pad totals and their low / high split against
    ``lax.padtype_to_pads`` (the SAME rule of the JAX modules)."""
    want = jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0]
    assert tuple(ti3d.same_pads((n,), (k,), (s,))) == tuple(want)


# ------------------------------------------------------------------- C3D

def write_c3d_npz(npz_path: str, mean_path: str, seed: int = 0) -> None:
    """Chainer-layout C3D weights (``name/W`` (out, in, t, h, w), ``name/b``)
    and a UCF-101 mean image (3, 16, 120, 120), seeded."""
    rng = np.random.RandomState(seed)
    data = {}
    for name, cin, cout in tc3d._CONVS:
        data[f"{name}/W"] = (rng.randn(cout, cin, 3, 3, 3)
                             / np.sqrt(cin * 27)).astype(np.float32)
        data[f"{name}/b"] = (rng.randn(cout) * 0.05).astype(np.float32)
    for name, fin, fout in (("fc6", 8192, 4096), ("fc7", 4096, 4096),
                            ("fc8", 4096, 101)):
        data[f"{name}/W"] = (rng.randn(fout, fin) / np.sqrt(fin)).astype(np.float32)
        data[f"{name}/b"] = (rng.randn(fout) * 0.05).astype(np.float32)
    np.savez(npz_path, **data)
    np.savez(mean_path, mean=rng.uniform(80, 140, (3, 16, 120, 120)))


@pytest.fixture(scope="module")
def c3d_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("c3d")
    paths = (str(d / "conv3d_deepnetA_ucf.npz"), str(d / "mean2.npz"))
    write_c3d_npz(*paths)
    return paths


def test_c3d_logits_match_jax(c3d_files):
    from seervideoldm_tpu.evaluation.c3d import C3D, load_c3d_params

    x = np.random.RandomState(4).uniform(-1, 1, (1, 16, 32, 40, 3)).astype(
        np.float32)
    model = C3D()
    params = load_c3d_params(*c3d_files, None)
    want = np.asarray(jax.jit(lambda p, v: model.apply({"params": p}, v))(
        params, x))
    c3d = tc3d.load_c3d_params(*c3d_files, tc3d.C3D().eval())
    with torch.no_grad():
        got = c3d(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 101)
    assert _rel(got, want) <= 1e-4
    with pytest.raises(ValueError, match="16-frame"):
        c3d(torch.zeros(1, 12, 32, 40, 3))


@pytest.mark.parametrize("shape,k", [((16, 112, 112), (1, 2, 2)),
                                     ((16, 56, 56), (2, 2, 2)),
                                     ((4, 14, 14), (2, 2, 2)),
                                     ((2, 7, 7), (2, 2, 2)),
                                     ((3, 5, 9), (2, 2, 2))])
def test_cover_all_pool_equals_ceil_mode(shape, k):
    x = torch.randn(1, 2, *shape, generator=torch.Generator().manual_seed(0))
    want = torch.nn.functional.max_pool3d(x, k, k, ceil_mode=True)
    assert torch.equal(tc3d.max_pool_cover_all(x, k), want)


# ------------------------------------------------------ inception score

@pytest.mark.parametrize("n,batch", [(60, 5), (12, 4)])
def test_inception_score_matches_jax(n, batch):
    """60 clips in 12 batches (>= 10 splits) and 12 clips in 3 batches
    (fewer batches than splits: the reference splits over batches)."""
    from seervideoldm_tpu.evaluation.inception_score import inception_score as jis

    rng = np.random.RandomState(n)
    w = rng.randn(6, 101)
    classify = lambda v: v.reshape(len(v), -1)[:, :6] @ w  # noqa: E731
    samples = rng.randn(n, 2, 3).astype(np.float32)
    got = inception_score(classify, samples, batchsize=batch)
    want = jis(classify, samples, batchsize=batch)
    assert got[0] == want[0] and got[1] == want[1]
    assert len(got[2]) == len(want[2]) == n // batch


# ------------------------------------------------------------- CLIPSIM

@pytest.mark.parametrize("h,w", [(256, 256), (64, 64), (32, 48), (120, 160)])
def test_clip_preprocess_matches_jax_cubic(h, w):
    from seervideoldm_tpu.evaluation.clip_sim import preprocess_frames

    frames = np.random.RandomState(h * w).rand(2, h, w, 3).astype(np.float32)
    want = np.asarray(preprocess_frames(jnp.asarray(frames), 224))
    got = tclip.preprocess_frames(torch.from_numpy(frames), 224)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    # in the resized image's [0, 1] units (the normalisation divides by
    # the CLIP std, ~0.27, in both)
    err = np.abs(got - want) * np.asarray(tclip.CLIP_IMAGE_STD)
    assert float(err.max()) <= 1e-5


TOY_VISION = dict(image_size=28, patch_size=14, hidden_size=24,
                  intermediate_size=48, num_hidden_layers=2,
                  num_attention_heads=2, projection_dim=16)
TOY_TEXT = dict(vocab_size=64, hidden_size=20, intermediate_size=40,
                num_hidden_layers=2, num_attention_heads=2,
                max_position_embeddings=12)


def clip_model_state_dict(vision, text, proj, seed=0) -> dict:
    """An HF ``CLIPModel`` state dict for the port's modules' widths:
    every tensor seeded, plus ``position_ids`` and ``logit_scale``."""
    rng = np.random.RandomState(seed)
    sd = {}
    for module in (vision, text, proj):
        for k, v in module.state_dict().items():
            a = rng.randn(*v.shape) * 0.2
            if k.endswith("weight") and v.ndim == 1:
                a += 1.0
            sd[k] = torch.from_numpy(a.astype(np.float32))
    for tower in ("vision_model", "text_model"):
        n = sd[f"{tower}.embeddings.position_embedding.weight"].shape[0]
        sd[f"{tower}.embeddings.position_ids"] = torch.arange(n)[None]
    sd["logit_scale"] = torch.tensor(2.6592)
    return sd


def test_clip_sim_fn_matches_jax():
    from seervideoldm_tpu.evaluation import clip_sim as jclip
    from seervideoldm_tpu.io import convert as jconv
    from seervideoldm_tpu.models.clip_text import CLIPTextConfig as JText
    from seervideoldm_tpu.models.clip_text import CLIPTextModel as JTextModel

    from seervideoldm_tpu_torch.io.pretrained import (convert_clip_projections,
                                                      convert_clip_text,
                                                      convert_clip_vision)
    from seervideoldm_tpu_torch.models.clip_text import (CLIPTextConfig,
                                                         CLIPTextModel)

    vcfg = tclip.CLIPVisionConfig(**TOY_VISION)
    vision = tclip.CLIPVisionModel(vcfg).eval()
    text = CLIPTextModel(CLIPTextConfig(**TOY_TEXT)).eval()
    proj = tclip.CLIPProjections(24, 20, 16)
    sd = clip_model_state_dict(vision, text, proj)
    convert_clip_vision(sd, vision)
    convert_clip_text({k: v for k, v in sd.items()
                       if k.startswith("text_model.")}, text)
    convert_clip_projections(sd, proj)

    jv = jclip.CLIPVisionModel(jclip.CLIPVisionConfig(**TOY_VISION))
    jt = JTextModel(JText(**TOY_TEXT))
    jp = jclip.CLIPProjections(projection_dim=16)
    key = jax.random.PRNGKey(0)
    npsd = {k: v.numpy() for k, v in sd.items()}
    vp = jconv.convert_clip_vision(npsd, jv.init(key, jnp.zeros((1, 28, 28, 3)))["params"])
    tp = jconv.convert_clip_text(
        {k: v for k, v in npsd.items() if k.startswith("text_model.")},
        jt.init(key, jnp.zeros((1, 12), jnp.int32))["params"])
    pp = jconv.convert_clip_projections(
        npsd, jp.init(key, jnp.zeros((1, 24)), jnp.zeros((1, 20)))["params"])

    rng = np.random.RandomState(2)
    videos = rng.rand(2, 3, 16, 16, 3).astype(np.float32)
    ids = rng.randint(1, 62, (2, 12)).astype(np.int32)
    ids[0, 7], ids[1, -1] = 63, 63  # the EOS, the highest id
    mask = np.ones_like(ids)
    mask[0, 8:] = 0
    want = np.asarray(jclip.make_clip_sim_fn(jv, jt, jp, vp, tp, pp)(
        jnp.asarray(videos), jnp.asarray(ids), jnp.asarray(mask)))
    got = tclip.make_clip_sim_fn(vision, text, proj)(
        torch.from_numpy(videos), ids, mask)
    assert got.shape == want.shape == (2,)
    assert _rel(got, want) <= 1e-5


# ------------------------------------------------------------ the entry

def test_eval_yaml_parses_with_the_jax_values():
    from seervideoldm_tpu.config import load_config as jax_load

    from seervideoldm_tpu_torch.config import load_config

    path = os.path.join(ROOT, "configs", "eval.yaml")
    got, want = load_config(path), jax_load(path)
    for key in ("compute_fvd", "MAX_FVD_BATCH", "compute_is", "MAX_IS_BATCH",
                "is_cast_frames", "i3d_ckpt", "c3d_ckpt", "compute_clip_sim",
                "clip_sim_ckpt", "val_batch_size", "ddim_steps", "num_frames"):
        assert got.get(key) == want.get(key), key
    assert got.c3d_mean_path is None


@pytest.fixture(scope="module")
def entry_run(tmp_path_factory, i3d_file, c3d_files):
    """The eval entry on 4 toy clips of 10 frames (cond 1), 2 a batch,
    every scorer on, the FVD bucket never filled (the last-batch flush
    fires both branches); the videos handed to ``FVDEvaluator.update``
    recorded."""
    from seervideoldm_tpu_torch import eval as entry

    tmp = tmp_path_factory.mktemp("eval")
    data = str(tmp / "data")
    _make_sthv2(data, n_clips=4, n_frames=10)
    over = dict(TINY_OVERRIDES, clip_sim={"vision": TOY_VISION, "text": dict(
        TOY_TEXT, vocab_size=49408, max_position_embeddings=77)})
    cfg = {"output_dir": str(tmp / "out"), "data_dir": data,
           "dataset": "sthv2", "resolution": 16, "cond_frames": 1,
           "num_frames": 10, "val_batch_size": 2, "ddim_steps": 2,
           "scale": 7.5, "compute_fvd": True, "MAX_FVD_BATCH": 32,
           "compute_is": True, "MAX_IS_BATCH": 100, "is_cast_frames": True,
           "compute_clip_sim": True, "i3d_ckpt": i3d_file,
           "c3d_ckpt": c3d_files[0], "num_workers": 2,
           "mixed_precision": "no", "seed": 0, "model_overrides": over}
    path = str(tmp / "eval.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    seen = []
    update = tfvd.FVDEvaluator.update

    def recording(self, fake, real):
        seen.append((fake, real))
        return update(self, fake, real)

    tfvd.FVDEvaluator.update = recording
    import contextlib
    import io

    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            result = entry.main(["--config", path, "--device", "cpu"])
    finally:
        tfvd.FVDEvaluator.update = update
    return dict(result=result, stdout=out.getvalue(), seen=seen, path=path)


def test_eval_entry_reaches_the_final_lines(entry_run):
    out, res = entry_run["stdout"], entry_run["result"]
    m = re.search(r"Final FVD ([^,]+), KVD (\S+)", out)
    assert m, out
    assert np.isfinite(float(m.group(1))) and np.isfinite(float(m.group(2)))
    assert re.search(r"Final IS \S+ \+- \S+", out), out
    assert re.search(r"Final CLIPSIM \S+", out), out
    # both independent branches flushed once, at the last batch
    assert len(re.findall(r"\[4 clips\] FVD", out)) == 1
    assert len(re.findall(r"^IS ", out, re.MULTILINE)) == 1
    assert res["clips"] == 4 and np.isfinite(res["is_mean"])
    assert np.isfinite(res["clip_sim"])
    assert set(res["seconds"]) == {"sample", "fvd", "is", "clip_sim"}


def test_eval_entry_fvd_matches_jax_evaluator(entry_run, i3d_file):
    """The clips the entry scored, through the JAX ``FVDEvaluator`` with
    the same I3D file: the same FVD and KVD to 1e-6 relative."""
    from seervideoldm_tpu.evaluation.fvd import FVDEvaluator

    (fake, real), = entry_run["seen"]
    assert fake.shape == real.shape == (4, 10, 16, 16, 3)
    assert fake.dtype == np.uint8
    model, params = _jax_i3d(i3d_file, 10)
    want = FVDEvaluator(model, params).update(fake, real)
    res = entry_run["result"]
    assert abs(res["fvd"] - want["fvd"]) <= 1e-6 * abs(want["fvd"])
    assert abs(res["kvd"] - want["kvd"]) <= 1e-6 * abs(want["kvd"])


def eval_ranks(rank, argv):
    """Rank function (a spawned gloo rank): the eval entry on the CPU."""
    from seervideoldm_tpu_torch import eval as entry

    return entry.main(argv + ["--device", "cpu"])


def test_eval_entry_on_two_ranks(entry_run):
    """2 gloo ranks, one clip a batch: each rank samples its shard of the
    split (clips 0, 2 and 1, 3), the clips are gathered before the buckets
    (``MAX_FVD_BATCH`` 2 flushes at each gathered batch), and both ranks
    end with the same metrics over all 4 clips."""
    from seervideoldm_tpu_torch.parallel import launch

    argv = ["--config", entry_run["path"], "--set", "val_batch_size=1",
            "--set", "MAX_FVD_BATCH=2"]
    got = launch.run(eval_ranks, 2, args=(argv,), device="cpu",
                     backend="gloo", timeout=600, threads=1)
    keys = ("fvd", "kvd", "is_mean", "is_std", "clip_sim", "clips")
    assert [got[0][k] for k in keys] == [got[1][k] for k in keys]
    assert got[0]["clips"] == 4
    assert all(np.isfinite(got[0][k]) for k in keys)
