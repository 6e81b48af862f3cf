"""Animated-GIF writer (the port's copy of the single-clip path of
``seervideoldm_tpu/utils/viz.py``).  Pillow is imported only when a GIF is
written."""
from __future__ import annotations

import io
import os

import numpy as np


def _to_uint8(video: np.ndarray) -> np.ndarray:
    """(f, h, w, c) float [0, 1] -> uint8."""
    return (np.clip(video, 0.0, 1.0) * 255).astype(np.uint8)


def gif_bytes(video: np.ndarray, duration: int = 120, loop: int = 0) -> bytes:
    """(f, h, w, 3) float [0, 1] -> GIF file contents."""
    from PIL import Image

    buf = io.BytesIO()
    frames = [Image.fromarray(f) for f in _to_uint8(video)]
    frames[0].save(buf, format="GIF", save_all=True, append_images=frames[1:],
                   duration=duration, loop=loop, optimize=True)
    return buf.getvalue()


def save_visualization_onegif(samples: np.ndarray, cond: np.ndarray,
                              results_folder: str, global_step: int) -> str:
    """Cond frames then samples, both (b, f, h, w, 3) in [0, 1], of batch
    element 0 as ``sample-<step>.gif``; returns the path."""
    os.makedirs(results_folder, exist_ok=True)
    full = np.concatenate([cond, samples], axis=1)
    path = os.path.join(results_folder, f"sample-{global_step}.gif")
    with open(path, "wb") as f:
        f.write(gif_bytes(full[0]))
    return path
