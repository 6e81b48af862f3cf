"""Video + new prompt -> SDEdit-style edited video, on the GPU (port of
the root ``edit.py``).

    python -m seervideoldm_tpu_torch.edit --config <yaml> \\
        --video_path clip.gif --input_text_prompts "pour the water instead" \\
        --edit_strength 0.6

The clip's future-frame latents are re-noised to ``edit_strength`` of the
DDIM grid and denoised under the new instruction, the first
``cond_frames`` frames kept clean as conditioning
(``SeerPipeline.edit``).  ``--video_path`` is an animated GIF or a
directory of frame images (sorted); its first ``num_frames`` frames are
used.  Writes ``<output_dir>/sample-0.gif``.  Runs on CUDA; ``--device
cpu`` runs the plain PyTorch path.
"""
from __future__ import annotations

import glob
import os
import sys
from typing import Optional

import numpy as np
import torch

from .config import parse_args
from .data.transforms import image_to_model_input
from .inference_img import build_pipeline
from .parallel.distributed import is_main_process
from .utils.viz import save_visualization_onegif


def load_video_frames(path: str, resolution: int, num_frames: int) -> np.ndarray:
    """``num_frames`` frames of a GIF or a frame directory, (num_frames,
    resolution, resolution, 3) in [-1, 1].  An optimised GIF stores delta
    frames (only the changed region, with disposal methods), so each frame
    is composited onto the running canvas before it is converted."""
    from PIL import Image, ImageSequence

    frames = []
    if os.path.isdir(path):
        files = sorted(f for f in glob.glob(os.path.join(path, "*"))
                       if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp",
                                              ".webp")))
        for f in files[:num_frames]:
            with Image.open(f) as img:
                frames.append(image_to_model_input(img, resolution))
    else:
        with Image.open(path) as img:
            canvas = None
            for frame in ImageSequence.Iterator(img):
                rgba = frame.convert("RGBA")
                if canvas is None:
                    canvas = rgba
                else:
                    canvas = canvas.copy()
                    canvas.paste(rgba, (0, 0), rgba)
                frames.append(image_to_model_input(canvas.convert("RGB"),
                                                   resolution))
                if len(frames) >= num_frames:
                    break
    if len(frames) < num_frames:
        raise SystemExit(f"error: {path} has only {len(frames)} frames; "
                         f"num_frames={num_frames} required")
    return np.stack(frames)


def edit_video(pipe, tokenizer, cfg, video: np.ndarray, prompt: str,
               strength: float) -> torch.Tensor:
    """``video`` (f, h, w, 3) in [-1, 1] -> edited future frames
    (1, f - cond_frames, h, w, 3) in [0, 1]; the noise from a generator
    seeded by ``seed``."""
    tok, tok_uc = tokenizer([prompt or ""]), tokenizer([""])
    gen = torch.Generator(device=pipe.device).manual_seed(int(cfg.seed))
    return pipe.edit(
        video[None], tok["input_ids"], tok["attention_mask"],
        tok_uc["input_ids"], tok_uc["attention_mask"],
        cond_frames=int(cfg.cond_frames), edit_strength=float(strength),
        generator=gen, ddim_steps=int(cfg.ddim_steps),
        guidance_scale=float(cfg.scale), prediction_type=cfg.prediction_type,
        timestep_spacing=cfg.timestep_spacing,
        guidance_rescale=float(cfg.guidance_rescale))


def main(argv: Optional[list[str]] = None, device=None) -> Optional[str]:
    """Command-line entry; returns the GIF's path (None on the ranks that
    write nothing)."""
    cfg = parse_args("Seer SDEdit-style video editing (PyTorch / CUDA port)",
                     extra_flags={"video_path": None,
                                  "input_text_prompts": None,
                                  "edit_strength": "0.6", "device": None},
                     argv=argv)
    if not cfg.get("video_path"):
        raise SystemExit("error: --video_path (or the video_path config key) "
                         "is required")
    pipe, tokenizer, cfg = build_pipeline(cfg, device or cfg.get("device"))
    video = load_video_frames(cfg.get("video_path"), int(cfg.resolution),
                              int(cfg.num_frames))
    samples = edit_video(pipe, tokenizer, cfg, video,
                         cfg.input_text_prompts or "",
                         float(cfg.get("edit_strength")))
    if not is_main_process():
        return None
    cond01 = (video[None, :int(cfg.cond_frames)] + 1.0) / 2.0
    path = save_visualization_onegif(samples.float().cpu().numpy(), cond01,
                                     cfg.output_dir, 0)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main(sys.argv[1:])
