"""GIF and PNG-grid writers (the port's copy of
``seervideoldm_tpu/utils/viz.py``).  Pillow is imported only when a file is
written."""
from __future__ import annotations

import io
import os
from typing import Optional

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


def video_to_gif(video: np.ndarray, path: str, duration: int = 120,
                 loop: int = 0) -> None:
    """(f, h, w, 3) float [0, 1] -> a GIF file."""
    with open(path, "wb") as f:
        f.write(gif_bytes(video, duration=duration, loop=loop))


def _pad(img: np.ndarray, pad: int = 2, value: float = 0.0) -> np.ndarray:
    return np.pad(img, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                  constant_values=value)


def make_grid(videos: np.ndarray, nrow: int = 8) -> np.ndarray:
    """(n, h, w, c) -> tiled grid image (H, W, c), torchvision-like."""
    n, h, w, c = videos.shape
    ncol = min(nrow, n)
    nrows = (n + ncol - 1) // ncol
    grid = np.zeros((nrows * h, ncol * w, c), dtype=videos.dtype)
    for i in range(n):
        r, col = divmod(i, ncol)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = videos[i]
    return grid


def save_visualization(samples: np.ndarray, recon: Optional[np.ndarray],
                       gt: Optional[np.ndarray], cond: Optional[np.ndarray],
                       results_folder: str, global_step: int,
                       num_sample_rows: int = 2) -> None:
    """Per-row GIFs (``sample`` / ``recon`` / ``gt``-<step>.gif) and one PNG
    frame grid (``grid-<step>.png``).  samples / recon / gt (b, f, h, w, 3)
    in [0, 1]; cond (b, f1, h, w, 3).  A GIF tiles the batch as
    ``num_sample_rows`` rows (one row when the batch does not divide); a
    grid panel per batch element is [cond frames | green bar | sample,
    recon, gt strips | red bar], grey padding between panels."""
    from PIL import Image

    os.makedirs(results_folder, exist_ok=True)
    rows = [("sample", samples)]
    if recon is not None:
        rows.append(("recon", recon))
    if gt is not None:
        rows.append(("gt", gt))

    def tile(vid: np.ndarray) -> np.ndarray:
        b, f, h, w, c = vid.shape
        i = (num_sample_rows if num_sample_rows and b % num_sample_rows == 0
             else 1)
        j = b // i
        return (vid.reshape(i, j, f, h, w, c).transpose(2, 0, 3, 1, 4, 5)
                .reshape(f, i * h, j * w, c))

    for name, vid in rows:
        video_to_gif(tile(vid), os.path.join(results_folder,
                                             f"{name}-{global_step}.gif"))

    def strip(frames: np.ndarray) -> np.ndarray:
        """(f, h, w, 3) -> (h + 4, f * (w + 4), 3), a 2 px border a frame."""
        return np.concatenate(list(_pad(frames)), axis=1)

    panels = []
    for b in range(samples.shape[0]):
        stack = np.concatenate([strip(vid[b]) for _, vid in rows], axis=0)
        parts = []
        if cond is not None:
            green = np.zeros((stack.shape[0], 4, 3), dtype=stack.dtype)
            green[:, :, 1] = 1.0
            parts += [np.tile(strip(cond[b]), (len(rows), 1, 1)), green]
        red = np.zeros((stack.shape[0], 4, 3), dtype=stack.dtype)
        red[:, :, 0] = 1.0
        parts += [stack, red]
        panels.append(np.pad(np.concatenate(parts, axis=1),
                             ((3, 3), (3, 3), (0, 0)), constant_values=0.5))
    grid = np.concatenate(panels, axis=0)
    Image.fromarray(_to_uint8(grid[None])[0]).save(
        os.path.join(results_folder, f"grid-{global_step}.png"))


def save_visualization_onegif(samples: np.ndarray, cond: np.ndarray,
                              results_folder: str, global_step: int) -> str:
    """Cond frames then samples, both (b, f, h, w, 3) in [0, 1], of batch
    element 0 as ``sample-<step>.gif``; returns the path."""
    os.makedirs(results_folder, exist_ok=True)
    full = np.concatenate([cond, samples], axis=1)
    path = os.path.join(results_folder, f"sample-{global_step}.gif")
    video_to_gif(full[0], path)
    return path
