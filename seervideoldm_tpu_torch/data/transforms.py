"""Frame loading and video preprocessing (the port's copy of
``seervideoldm_tpu/data/transforms.py``).

``image_to_model_input``: resize the shorter side to ``resolution``
(bilinear), center-crop, scale to [-1, 1].  A PIL image goes through PIL
exactly as in the JAX package; a numpy ``(h, w, 3)`` uint8 array (the path
for hosts without Pillow) is resized with PyTorch's antialiased bilinear
filter, which approximates PIL's, and is used as it is when it already has
the target size.

``cast_num_frames``: trilinear temporal resample (align_corners=False) when
the clip is longer than ``num_frames``, zero-pad when shorter, as the
reference data path does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _crop_box(w: int, h: int, resolution: int):
    scale = resolution / min(w, h)
    new_w, new_h = round(w * scale), round(h * scale)
    left, top = (new_w - resolution) // 2, (new_h - resolution) // 2
    return new_w, new_h, left, top


def image_to_model_input(img, resolution: int) -> np.ndarray:
    """PIL image or (h, w, 3) uint8 array -> (res, res, 3) float32 in
    [-1, 1]."""
    if isinstance(img, np.ndarray):
        arr = img.astype(np.float32)
        h, w = arr.shape[:2]
        if (h, w) != (resolution, resolution):
            new_w, new_h, left, top = _crop_box(w, h, resolution)
            t = torch.from_numpy(arr).permute(2, 0, 1)[None]
            t = F.interpolate(t, size=(new_h, new_w), mode="bilinear",
                              align_corners=False, antialias=True)
            t = t[..., top:top + resolution, left:left + resolution]
            arr = t[0].permute(1, 2, 0).clamp(0, 255).round().numpy()
        return arr / 255.0 * 2.0 - 1.0
    from PIL import Image

    img = img.convert("RGB")
    new_w, new_h, left, top = _crop_box(*img.size, resolution)
    img = img.resize((new_w, new_h), Image.BILINEAR)
    img = img.crop((left, top, left + resolution, top + resolution))
    return np.asarray(img, dtype=np.float32) / 255.0 * 2.0 - 1.0


def load_frame(path: str, resolution: int) -> np.ndarray:
    """Load one frame -> (h, w, 3) float32 in [-1, 1]."""
    from PIL import Image

    with Image.open(path) as img:
        return image_to_model_input(img, resolution)


def _linear_resample(video: np.ndarray, frames: int) -> np.ndarray:
    """Temporal linear interpolation with torch trilinear
    align_corners=False semantics, (f, h, w, c) -> (frames, h, w, c)."""
    f = video.shape[0]
    # source coordinate of output i: (i + 0.5) * f / frames - 0.5, clamped
    src = (np.arange(frames, dtype=np.float64) + 0.5) * (f / frames) - 0.5
    src = np.clip(src, 0.0, f - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, f - 1)
    w_hi = (src - lo).astype(np.float32).reshape(-1, 1, 1, 1)
    return video[lo] * (1.0 - w_hi) + video[hi] * w_hi


def resample_frames(video: np.ndarray, frames: int) -> np.ndarray:
    """Temporal linear resample in both directions (interpolates when
    growing, where ``cast_num_frames`` zero-pads)."""
    return _linear_resample(video, frames) if video.shape[0] != frames else video


def cast_num_frames(video: np.ndarray, frames: int) -> np.ndarray:
    """(f, h, w, c) -> (frames, h, w, c): trilinear shrink or zero-pad."""
    f = video.shape[0]
    if f == frames:
        return video
    if f > frames:
        return _linear_resample(video, frames)
    pad = np.zeros((frames - f, *video.shape[1:]), dtype=video.dtype)
    return np.concatenate([video, pad], axis=0)
