"""The port's entry point and full-scale structure, on the CPU.

- ``python -m seervideoldm_tpu_torch.inference_img`` at the verify recipe's
  toy config with ``--device cpu`` writes a GIF of cond + predicted frames;
- the port's own copies of the tokenizers, the image preprocessing and the
  config reader against the JAX package's (exact);
- at full SD-1.5 width on the meta device: the port's state-dict keys and
  shapes equal the reference manifests (SeerUNet 1006 keys, FSText 276,
  SD-1.5 VAE 248, CLIP ViT-L/14 text 196), and one SeerUNet call at the
  main path's 256 px / 12 frame / CFG-batch-2 shapes reaches the kernel
  wrappers 5 / 5 / 5 / 5 / 10 times (K1 / K2 / K3 / K4 / K5).
"""
import json
import os

import numpy as np
import pytest
import torch

from seervideoldm_tpu_torch.models.clip_text import CLIPTextModel
from seervideoldm_tpu_torch.models.fstext import FSTextTransformer
from seervideoldm_tpu_torch.models.unet3d import SeerUNet
from seervideoldm_tpu_torch.models.vae import AutoencoderKL
from seervideoldm_tpu_torch.utils.device import cast_for_compute

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFESTS = os.path.join(ROOT, "seervideoldm_tpu", "io",
                         "reference_manifests.json")

TOY = {
    "resolution": 32, "cond_frames": 2, "num_frames": 6, "ddim_steps": 4,
    "scale": 7.5, "seed": 0, "mixed_precision": "no",
    "model_overrides": {
        "unet": {"block_out_channels": [32, 64], "layers_per_block": 1,
                 "norm_num_groups": 8, "cross_attention_dim": 32,
                 "attention_head_dim": 4},
        "vae": {"block_out_channels": [16, 32], "layers_per_block": 1,
                "norm_num_groups": 8},
        "clip": {"vocab_size": 49408, "hidden_size": 32,
                 "intermediate_size": 64, "num_hidden_layers": 2,
                 "num_attention_heads": 4, "max_position_embeddings": 77},
        "fstext": {"n_heads": 4, "num_layers": 1}},
}


def test_inference_img_cpu_drive_writes_gif(tmp_path):
    yaml = pytest.importorskip("yaml")
    from PIL import Image

    from seervideoldm_tpu_torch import inference_img

    img = np.random.RandomState(0).randint(0, 255, (40, 48, 3), dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "in.png")
    cfg = dict(TOY, output_dir=str(tmp_path / "out"))
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    path = inference_img.main([
        "--config", str(tmp_path / "cfg.yaml"), "--image_path",
        str(tmp_path / "in.png"), "--input_text_prompts", "push the block left",
        "--device", "cpu"])
    with Image.open(path) as gif:
        assert gif.size == (32, 32)
        assert gif.n_frames >= 2


def test_generate_video_api_shapes_and_range():
    from seervideoldm_tpu_torch.inference_img import build_pipeline, generate_video

    pipe, tok, cfg = build_pipeline(TOY, device="cpu")
    img = np.random.RandomState(1).randint(0, 255, (32, 32, 3), dtype=np.uint8)
    samples, cond = generate_video(pipe, tok, cfg, img, "a prompt")
    assert samples.shape == (1, 4, 32, 32, 3)
    assert cond.shape == (1, 2, 32, 32, 3)
    assert torch.isfinite(samples).all()
    assert samples.min() >= 0.0 and samples.max() <= 1.0


def _write_bpe_vocab(path):
    """A tiny vocab and merge list exercising BPE merges and the specials
    (the synthetic case of tests/test_data.py)."""
    vocab = {}
    for ch in "abcdehlorw ":
        vocab[ch] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    for tok in ["he", "ll", "hell", "o</w>", "hello</w>", "wo", "wor",
                "world</w>", "<|startoftext|>", "<|endoftext|>"]:
        vocab[tok] = len(vocab)
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("o", "</w>"),
              ("hell", "o</w>"), ("w", "o"), ("wo", "r"), ("wor", "ld</w>"),
              ("l", "d</w>")]
    (path / "vocab.json").write_text(json.dumps(vocab))
    (path / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(" ".join(m) for m in merges))


@pytest.mark.parametrize("kind", ["clip", "debug"])
def test_tokenizers_match_jax(tmp_path, kind):
    from seervideoldm_tpu.utils import tokenizer as jtok
    from seervideoldm_tpu_torch.utils import tokenizer as ttok

    if kind == "clip":
        _write_bpe_vocab(tmp_path)
        want_tok = jtok.CLIPTokenizer.from_dir(str(tmp_path), max_length=8)
        got_tok = ttok.CLIPTokenizer.from_dir(str(tmp_path), max_length=8)
    else:
        want_tok = jtok.DebugTokenizer(vocab_size=100, max_length=8)
        got_tok = ttok.DebugTokenizer(vocab_size=100, max_length=8)
    texts = ["hello world", "HELLO  world hello world hello world hello", "",
             "we well"]
    want, got = want_tok(texts), got_tok(texts)
    for key in ("input_ids", "attention_mask"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_image_to_model_input_matches_jax():
    from PIL import Image

    from seervideoldm_tpu.data.transforms import image_to_model_input as jax_img
    from seervideoldm_tpu_torch.data.transforms import image_to_model_input

    img = Image.fromarray(np.random.RandomState(2).randint(
        0, 255, (48, 64, 3), dtype=np.uint8))
    np.testing.assert_array_equal(image_to_model_input(img, 32),
                                  jax_img(img, 32))


def test_config_reads_shipped_yaml_like_jax():
    """The shipped inference config loads with the JAX package's values
    (unknown keys kept as extras); so does ``configs/serve.yaml``, which
    turns PAB on, with the JAX ``load_config``'s ``pab*`` fields and
    ``PABConfig``."""
    from seervideoldm_tpu.config import load_config as jax_load
    from seervideoldm_tpu_torch.config import Config, load_config

    path = os.path.join(ROOT, "configs", "inference_base.yaml")
    got, want = load_config(path), jax_load(path)
    for name in Config.__dataclass_fields__:
        if name != "extras":
            assert getattr(got, name) == want.get(name), name
    assert got.get("num_samples") == want.get("num_samples") == 4
    from seervideoldm_tpu.config import pab_config_from as jax_pab
    from seervideoldm_tpu_torch.config import pab_config_from

    serve = os.path.join(ROOT, "configs", "serve.yaml")
    got, want = load_config(serve), jax_load(serve)
    assert got.pab is True
    for name in ("pab", "pab_spatial_range", "pab_cross_range",
                 "pab_temporal_range", "pab_window"):
        assert getattr(got, name) == want.get(name), name
    assert vars(pab_config_from(got)) == vars(jax_pab(want))


def _meta(cls):
    with torch.device("meta"):
        return cls()


@pytest.mark.parametrize("name,cls", [
    ("seer_unet", SeerUNet), ("fstext", FSTextTransformer),
    ("sd15_vae", AutoencoderKL), ("sd15_clip_text", CLIPTextModel)])
def test_full_scale_keys_match_reference_manifest(name, cls):
    with open(MANIFESTS) as f:
        manifest = json.load(f)[name]
    got = {k: list(v.shape) for k, v in _meta(cls).state_dict().items()}
    assert sorted(got) == sorted(manifest)
    assert got == manifest


def test_full_width_unet_call_reaches_every_kernel(monkeypatch):
    """One full-width SeerUNet call on meta tensors, with each kernel
    wrapper replaced by a counting stand-in that returns an empty output:
    the site gates send the main path's shapes to the kernels the expected
    number of times."""
    from seervideoldm_tpu_torch.models import transformer3d
    from seervideoldm_tpu_torch.ops import attention
    from seervideoldm_tpu_torch.ops.kernels import group_norm

    calls = {}

    def counting(name):
        def fake(x, *args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return torch.empty_like(x)
        return fake

    for name in ("swat_attention_tables", "flash_attention"):
        monkeypatch.setattr(attention, name, counting(name))
    for name in ("ln_geglu_ff", "ln_geglu_ff_proj", "geglu_ff"):
        monkeypatch.setattr(transformer3d, name, counting(name))
    monkeypatch.setattr(group_norm, "group_norm", counting("group_norm"))
    unet = cast_for_compute(_meta(SeerUNet), torch.bfloat16)
    with torch.device("meta"):
        x = torch.empty(2, 12, 32, 32, 4, dtype=torch.bfloat16)
        ctx = torch.empty(2, 12, 77, 768, dtype=torch.bfloat16)
        out = unet(x, torch.zeros(2, dtype=torch.int32), ctx)
    assert out.shape == (2, 12, 32, 32, 4)
    assert calls == {"swat_attention_tables": 5, "flash_attention": 5,
                     "ln_geglu_ff": 5, "ln_geglu_ff_proj": 5, "geglu_ff": 10,
                     "group_norm": 77}
