"""Single image + prompt -> predicted video clip, on the GPU (port of the
root ``inference_img.py``).

    python -m seervideoldm_tpu_torch.inference_img --config <yaml> \\
        --image_path img.png --input_text_prompts "push the cup left"

Takes the JAX entry point's YAML keys, ``model_overrides`` included.  The
image is replicated to ``cond_frames``, VAE-encoded, and the sampler
(``sampler``: ddim or dpm++, with the JAX package's sampling knobs through
``sampling_kwargs_from``) predicts the remaining frames with
classifier-free guidance; with ``total_frames`` the window rolls forward
until that many future frames exist, and a prompt split by "|" gives one
instruction per chunk.  The cond frames and the prediction are written as
``<output_dir>/sample-0.gif``.  Runs on CUDA; ``--device cpu`` runs the
plain PyTorch path instead.

Several ranks under torchrun (``--nproc_per_node N``) take ``mesh_shape``
({"data": D, "model": M, "seq": S}; null = every rank on ``data``) and
``ring_attention``: ``seq`` splits the latent frames (the temporal
attention rotates K/V around a ring, or gathers them when
``ring_attention: false`` or the frames do not split evenly), ``data`` the
prompt batch, ``model`` the attention heads and feed-forward hidden units
of every model (tensor parallelism); rank 0 writes the GIF.

``generate_video`` is the same path as a Python API (a config dict or
``Config``, a numpy image), with no GIF written.
"""
from __future__ import annotations

import sys
from typing import Optional, Union

import torch

from .config import (Config, config_from_dict, parse_args,
                     sampler_schedule_from, sampling_kwargs_from)
from .data.transforms import image_to_model_input
from .pipelines.loading import (load_finetuned, load_models,
                                resolve_finetuned_dir)
from .pipelines.text_video import SeerPipeline
from .parallel.distributed import initialize_distributed, is_main_process
from .parallel.mesh import create_mesh
from .utils.device import set_numerics
from .utils.viz import save_visualization_onegif


def build_pipeline(cfg: Union[Config, dict], device=None,
                   mesh: bool = True):
    """``(SeerPipeline, tokenizer, cfg)`` for a config on ``device``.
    ``mesh=False`` registers no mesh: each rank samples its own batches
    (the eval entry's per-rank shard of the split)."""
    if isinstance(cfg, dict):
        cfg = config_from_dict(cfg)
    dev = initialize_distributed(device)
    set_numerics()
    models, tokenizer = load_models(
        cfg, dev, mesh=create_mesh(cfg.mesh_shape) if mesh else None)
    ckpt_dir = resolve_finetuned_dir(cfg)
    if ckpt_dir:
        load_finetuned(models, ckpt_dir)
    pipe = SeerPipeline(models, schedule=sampler_schedule_from(cfg),
                        vae_scale=float(cfg.vae_scale))
    return pipe, tokenizer, cfg


def generate_video(pipe: SeerPipeline, tokenizer, cfg: Config, image,
                   prompt: str):
    """``image``: a PIL image or (h, w, 3) uint8 array.  Returns (samples
    (1, num_frames - cond_frames, res, res, 3) in [0, 1], or
    (1, total_frames, ...) under ``total_frames``, cond frames
    (1, cond_frames, res, res, 3) in [-1, 1])."""
    frame = torch.from_numpy(image_to_model_input(image, int(cfg.resolution)))
    cond = frame[None, None].repeat(1, int(cfg.cond_frames), 1, 1, 1)
    prompt = prompt or ""
    tok_uc = tokenizer([""])
    gen = torch.Generator(device=pipe.device).manual_seed(int(cfg.seed))
    kw = dict(num_frames=int(cfg.num_frames), generator=gen,
              ddim_steps=int(cfg.ddim_steps), guidance_scale=float(cfg.scale),
              **sampling_kwargs_from(cfg))
    if cfg.total_frames:
        # "|"-separated segments are chained per-chunk instructions
        prompts_tok = [tokenizer([p.strip()]) for p in prompt.split("|")]
        samples = pipe.generate_rollout(
            cond, prompts_tok, tok_uc["input_ids"], tok_uc["attention_mask"],
            total_frames=int(cfg.total_frames), **kw)
    else:
        tok = tokenizer([prompt])
        samples = pipe.generate(
            cond, tok["input_ids"], tok["attention_mask"],
            tok_uc["input_ids"], tok_uc["attention_mask"], **kw)
    return samples, cond


def main(argv: Optional[list[str]] = None, device=None) -> Optional[str]:
    """Command-line entry; returns the GIF's path (None on the ranks that
    write nothing)."""
    cfg = parse_args("Seer single-image inference (PyTorch / CUDA port)",
                     extra_flags={"image_path": None,
                                  "input_text_prompts": None,
                                  "device": None}, argv=argv)
    if not cfg.image_path:
        raise SystemExit("error: --image_path (or the image_path config key) "
                         "is required")
    pipe, tokenizer, cfg = build_pipeline(cfg, device or cfg.get("device"))
    from PIL import Image

    with Image.open(cfg.image_path) as img:
        samples, cond = generate_video(pipe, tokenizer, cfg, img,
                                       cfg.input_text_prompts or "")
    if not is_main_process():
        return None
    path = save_visualization_onegif(samples.cpu().numpy(),
                                     ((cond + 1.0) / 2.0).numpy(),
                                     cfg.output_dir, 0)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main(sys.argv[1:])
