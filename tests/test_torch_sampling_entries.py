"""The port's rollout, editing and entry points with the sampling knobs, on
the CPU.

- ``generate_rollout`` against the JAX samplers chained chunk by chunk on
  the ``build_case`` weights (JAX VAE, CLIP, FSText and ``ddim_sample_loop``
  fed the port's posterior and x_T draws, which come from one generator
  in chunk order): both chaining rules (f2 >= f1: the last f1 latents;
  f2 < f1: the last f1 of the previous window and the chunk), decoded
  frames at rtol 1e-3, atol 1e-4; chunk 0 equals ``generate`` on the same
  generator state bit for bit;
- ``edit`` against JAX's ``stochastic_encode`` + ``ddim_decode_loop`` on
  the same posterior and re-noising noise (1e-4); strength 0 decodes the
  input's latents;
- CPU drives of ``python -m seervideoldm_tpu_torch.inference`` (a
  synthetic Something-Something-v2 val tree), ``.edit`` (a GIF the test
  writes), ``.inference_img`` with ``--set total_frames=7`` ("|"-separated
  per-chunk prompts) and ``--set sampler=dpm++``, and ``.train`` under the
  zero-terminal-SNR recipe;
- one v-prediction train step on the zero-SNR SD-1.5 schedule against the
  JAX trainer (loss 1e-5, gradients 1e-4 rel + 2e-5 of the tensor's max,
  as ``test_torch_training.py``).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from seervideoldm_tpu.diffusion import ddim as jddim
from seervideoldm_tpu.diffusion.schedules import DiffusionSchedule as JSchedule

from test_torch_models import case  # noqa: F401
from test_torch_train_entry import TINY_OVERRIDES, _make_sthv2, _run
from test_torch_training import slice_case, step_vs_jax  # noqa: F401

torch.set_num_threads(1)
SCALE = 0.18215


def _jax_parts(case):  # noqa: F811
    jm, jp = case["jmods"], case["jparams"]
    vae = {"params": jp["vae"]}

    def encode(video, noise):
        b, f = video.shape[:2]
        mean, logvar = jm["vae"].apply(vae, jnp.asarray(
            video.reshape(b * f, *video.shape[2:])),
            method=jm["vae"].encode_moments)
        z = (np.asarray(mean) + np.exp(0.5 * np.asarray(logvar))
             * noise.reshape(b * f, *noise.shape[2:])) * SCALE
        return z.reshape(b, f, *z.shape[1:])

    def decode(z):
        b, f = z.shape[:2]
        x = jm["vae"].apply(vae, jnp.asarray(z.reshape(b * f, *z.shape[2:]))
                            / SCALE, method=jm["vae"].decode)
        return np.clip((np.asarray(x).reshape(b, f, *x.shape[1:]) + 1) / 2,
                       0, 1)

    def text(ids, mask):
        emb = jm["clip"].apply({"params": jp["clip"]}, jnp.asarray(ids),
                               jnp.asarray(mask))
        return emb, jm["fstext"].apply({"params": jp["fstext"]}, emb)

    def unet(x, t, c, cf):
        return jm["unet"].apply({"params": jp["unet"]}, x, t, c, cf)

    return encode, decode, text, unet


def _tokens(seed, n=1):
    rng = np.random.RandomState(seed)
    toks = []
    for _ in range(n):
        ids = rng.randint(0, 100, (1, 16)).astype(np.int32)
        mask = np.ones((1, 16), np.int32)
        mask[:, 10:] = 0
        toks.append({"input_ids": ids, "attention_mask": mask})
    return toks


@pytest.mark.parametrize("f1,total,n_prompts", [(1, 7, 3), (3, 2, 1)])
def test_rollout_matches_chained_jax_chunks(case, f1, total,  # noqa: F811
                                            n_prompts):
    pipe = case["pipe"]
    rng = np.random.RandomState(30 + f1)
    cond = rng.uniform(-1, 1, (1, f1, 16, 16, 3)).astype(np.float32)
    toks, unc = _tokens(f1, n_prompts), _tokens(99)[0]
    f2 = 4 - f1
    n_chunks = -(-total // f2)
    gen = torch.Generator().manual_seed(5)
    got = pipe.generate_rollout(cond, toks, unc["input_ids"],
                                unc["attention_mask"], num_frames=4,
                                total_frames=total, generator=gen,
                                ddim_steps=4, guidance_scale=7.5)
    assert got.shape == (1, total, 16, 16, 3)
    # the port's draws, in its order: posterior noise, then each chunk's x_T
    g = torch.Generator().manual_seed(5)
    post = torch.randn((1, f1, 8, 8, 4), generator=g).numpy()
    x_Ts = [torch.randn((1, f2, 8, 8, 4), generator=g).numpy()
            for _ in range(n_chunks)]
    encode, decode, text, unet = _jax_parts(case)
    x0_emb = encode(cond, post)
    u_emb, _ = text(unc["input_ids"], unc["attention_mask"])
    tables = JSchedule.create(1000).ddim_tables(4)
    chunks = []
    for c in range(n_chunks):
        tok = toks[c % len(toks)]
        _, ctx = text(tok["input_ids"], tok["attention_mask"])
        uncond = jnp.broadcast_to(u_emb[:, None], (1, 4, *u_emb.shape[1:]))
        lat = np.asarray(jddim.ddim_sample_loop(
            unet, jnp.asarray(x_Ts[c]), tables, ctx, jnp.asarray(x0_emb),
            uncond, 7.5, 0))
        chunks.append(lat)
        x0_emb = (lat[:, -f1:] if f2 >= f1
                  else np.concatenate([x0_emb, lat], axis=1)[:, -f1:])
    want = decode(np.concatenate(chunks, axis=1)[:, :total])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)
    if n_prompts == 1:
        first = pipe.generate(cond, toks[0]["input_ids"],
                              toks[0]["attention_mask"], unc["input_ids"],
                              unc["attention_mask"], num_frames=4,
                              generator=torch.Generator().manual_seed(5),
                              ddim_steps=4, guidance_scale=7.5)
        assert torch.equal(first, got[:, :f2])


@pytest.mark.parametrize("strength", [0.0, 0.5, 1.0])
def test_edit_matches_jax_encode_decode(case, strength):  # noqa: F811
    pipe = case["pipe"]
    video = np.random.RandomState(40).uniform(
        -1, 1, (1, 4, 16, 16, 3)).astype(np.float32)
    tok, unc = _tokens(41)[0], _tokens(99)[0]
    got = pipe.edit(video, tok["input_ids"], tok["attention_mask"],
                    unc["input_ids"], unc["attention_mask"], cond_frames=1,
                    edit_strength=strength,
                    generator=torch.Generator().manual_seed(6), ddim_steps=6,
                    guidance_scale=7.5)
    g = torch.Generator().manual_seed(6)
    post = torch.randn((1, 4, 8, 8, 4), generator=g).numpy()
    noise = torch.randn((1, 3, 8, 8, 4), generator=g).numpy()
    encode, decode, text, unet = _jax_parts(case)
    latents = encode(video, post)
    tables = JSchedule.create(1000).ddim_tables(6)
    t_enc = int(round(strength * len(tables.timesteps)))
    if t_enc == 0:
        want = decode(latents[:, 1:])
    else:
        _, ctx = text(tok["input_ids"], tok["attention_mask"])
        u_emb, _ = text(unc["input_ids"], unc["attention_mask"])
        uncond = jnp.broadcast_to(u_emb[:, None], (1, 4, *u_emb.shape[1:]))
        x = jddim.stochastic_encode(tables, jnp.asarray(latents[:, 1:]),
                                    jnp.asarray(t_enc), jnp.asarray(noise))
        want = decode(np.asarray(jddim.ddim_decode_loop(
            unet, x, tables, ctx, t_enc, uncond, 7.5,
            x0_emb=jnp.asarray(latents[:, :1]), cond_frame=0)))
    assert got.shape == (1, 3, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------- CPU drives

def _cfg(tmp_path, **over):
    cfg = {"output_dir": str(tmp_path / "out"), "resolution": 16,
           "cond_frames": 1, "num_frames": 4, "ddim_steps": 4, "scale": 7.5,
           "seed": 0, "mixed_precision": "no", "num_workers": 1,
           "model_overrides": TINY_OVERRIDES}
    cfg.update(over)
    path = str(tmp_path / f"cfg_{len(os.listdir(tmp_path))}.yaml")
    with open(path, "w") as f:
        yaml.dump(cfg, f)
    return cfg, path


def _gif_frames(path):
    with Image.open(path) as img:
        return img.n_frames


def test_inference_entry_writes_every_sample(tmp_path):
    data = str(tmp_path / "data")
    _make_sthv2(data, n_clips=4, n_frames=5)
    cfg, path = _cfg(tmp_path, data_dir=data, dataset="sthv2",
                     val_batch_size=2, num_samples=2, sample_iter=1,
                     sampler="dpm++", guidance_rescale=0.5)
    _run("inference", path, "--device", "cpu")
    out = cfg["output_dir"]
    for n in (0, 1):
        for kind in ("sample", "recon", "gt"):
            assert os.path.exists(os.path.join(out, f"{kind}-{n}.gif")), (kind, n)
        with Image.open(os.path.join(out, f"grid-{n}.png")) as img:
            assert img.size[0] > 0
    # batch 2 tiled as n_rows 2 x 1, 3 future frames
    with Image.open(os.path.join(out, "sample-0.gif")) as img:
        assert img.size == (16, 32) and img.n_frames == 3


def test_edit_entry_on_a_gif(tmp_path):
    rng = np.random.RandomState(50)
    frames = [Image.fromarray(rng.randint(0, 255, (20, 20, 3), np.uint8))
              for _ in range(5)]
    gif = str(tmp_path / "clip.gif")
    frames[0].save(gif, save_all=True, append_images=frames[1:], duration=100,
                   optimize=True)
    cfg, path = _cfg(tmp_path)
    proc = _run("edit", path, "--device", "cpu", "--video_path", gif,
                "--input_text_prompts", "do it again", "--edit_strength",
                "0.5")
    out = os.path.join(cfg["output_dir"], "sample-0.gif")
    assert out in proc.stdout and _gif_frames(out) == 4


@pytest.mark.parametrize("extra,frames", [
    (["--set", "total_frames=7", "--input_text_prompts", "a | b | c"], 8),
    (["--set", "sampler=dpm++", "--set", "timestep_spacing=trailing"], 4),
])
def test_inference_img_with_knobs(tmp_path, extra, frames):
    img = str(tmp_path / "in.png")
    Image.fromarray(np.random.RandomState(60).randint(
        0, 255, (24, 30, 3), np.uint8)).save(img)
    cfg, path = _cfg(tmp_path)
    _run("inference_img", path, "--device", "cpu", "--image_path", img, *extra)
    assert _gif_frames(os.path.join(cfg["output_dir"], "sample-0.gif")) == frames


def test_train_entry_zero_snr_recipe(tmp_path):
    data = str(tmp_path / "data")
    _make_sthv2(data)
    cfg, path = _cfg(tmp_path, data_dir=data, dataset="sthv2",
                     train_batch_size=2, gradient_accumulation_steps=1,
                     learning_rate=1e-3, scale_lr=False, lr_warmup_steps=1,
                     max_train_steps=2, save_steps=2,
                     prediction_type="v_prediction", rescale_zero_snr=True,
                     timestep_spacing="trailing")
    _run("train", path, "--device", "cpu")
    assert os.path.isdir(os.path.join(cfg["output_dir"],
                                      "learned_sdunet-steps-2"))


def test_v_prediction_zero_snr_train_step_matches_jax(slice_case):  # noqa: F811
    step_vs_jax(slice_case, prediction_type="v_prediction",
                rescale_zero_snr=True)
