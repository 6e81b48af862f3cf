"""Image preprocessing (the port's copy of
``seervideoldm_tpu/data/transforms.py::image_to_model_input``).

Resize the shorter side to ``resolution`` (bilinear), center-crop, scale to
[-1, 1].  A PIL image goes through PIL exactly as in the JAX package; a
numpy ``(h, w, 3)`` uint8 array (the path for hosts without Pillow) is
resized with PyTorch's antialiased bilinear filter, which approximates
PIL's, and is used as it is when it already has the target size.
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
