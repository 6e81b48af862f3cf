"""FVD / KVD, VideoGPT protocol (port of
``seervideoldm_tpu/evaluation/fvd.py``; reference ``utils/fvd.py``).

- ``preprocess_videos``: uint8 (b, t, h, w, c) -> the shorter side scaled
  to 224 (bilinear, ``align_corners=False``, no antialiasing, the other
  side rounded up), centre-cropped, mapped to [-1, 1];
- I3D logits in micro-batches of 16, on the I3D's device;
- FVD: the Frechet distance with a symmetric-eigh matrix square root,
  KVD: the unbiased polynomial-kernel MMD (sklearn's defaults), both in
  float64 numpy;
- ``FVDEvaluator``: cumulative FVD/KVD over growing embedding stacks
  (reference ``utils/compute_fvd.py:28-45``).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def preprocess_videos(videos, resolution: int = 224,
                      device=None) -> torch.Tensor:
    """uint8 (b, t, h, w, c) (numpy or tensor) -> float32 (b, t, res, res,
    c) in [-1, 1] on ``device`` (default: the input's, the CPU for
    numpy)."""
    x = torch.as_tensor(videos, device=device).float() / 255.0
    b, t, h, w, c = x.shape
    scale = resolution / min(h, w)
    target = ((resolution, math.ceil(w * scale)) if h < w
              else (math.ceil(h * scale), resolution))
    x = x.reshape(b * t, h, w, c).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=target, mode="bilinear", align_corners=False,
                      antialias=False)
    h0, w0 = (target[0] - resolution) // 2, (target[1] - resolution) // 2
    x = x[:, :, h0:h0 + resolution, w0:w0 + resolution]
    x = x.permute(0, 2, 3, 1).reshape(b, t, resolution, resolution, c)
    return (x - 0.5) * 2.0


def _sym_sqrt(mat: np.ndarray, eps: float = 1e-10) -> np.ndarray:
    """Symmetric PSD square root by eigendecomposition; eigenvalues below
    ``eps`` count as 0."""
    vals, vecs = np.linalg.eigh(mat.astype(np.float64))
    vals = np.where(vals < eps, 0.0, np.sqrt(np.maximum(vals, 0.0)))
    return (vecs * vals) @ vecs.T


def frechet_distance(x1: np.ndarray, x2: np.ndarray) -> float:
    """FVD between two embedding stacks (n, d)."""
    x1 = np.asarray(x1, dtype=np.float64).reshape(len(x1), -1)
    x2 = np.asarray(x2, dtype=np.float64).reshape(len(x2), -1)
    m1, m2 = x1.mean(axis=0), x2.mean(axis=0)
    s1 = np.atleast_2d(np.cov(x1, rowvar=False))
    s2 = np.atleast_2d(np.cov(x2, rowvar=False))
    sqrt_s1 = _sym_sqrt(s1)
    sqrt_prod = _sym_sqrt(sqrt_s1 @ s2 @ sqrt_s1)
    trace = np.trace(s1 + s2) - 2.0 * np.trace(sqrt_prod)
    return float(trace + np.sum((m1 - m2) ** 2))


def _polynomial_kernel(x: np.ndarray, y: Optional[np.ndarray] = None,
                       degree: int = 3, gamma: Optional[float] = None,
                       coef0: float = 1.0) -> np.ndarray:
    """sklearn ``polynomial_kernel`` defaults (degree 3, gamma 1/d,
    coef0 1)."""
    y = x if y is None else y
    gamma = gamma if gamma is not None else 1.0 / x.shape[1]
    return (gamma * (x @ y.T) + coef0) ** degree


def polynomial_mmd(x: np.ndarray, y: np.ndarray) -> float:
    """KVD: unbiased polynomial-kernel MMD."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    m, n = x.shape[0], y.shape[0]
    k_xx = _polynomial_kernel(x)
    k_yy = _polynomial_kernel(y)
    k_xy = _polynomial_kernel(x, y)
    sum_xx = (k_xx.sum() - np.trace(k_xx)) / (m * (m - 1))
    sum_yy = (k_yy.sum() - np.trace(k_yy)) / (n * (n - 1))
    return float(sum_xx + sum_yy - 2 * k_xy.sum() / (m * n))


class FVDEvaluator:
    """Cumulative FVD/KVD: each ``update`` appends a bucket's I3D
    embeddings and recomputes both metrics on the whole stacks."""

    def __init__(self, i3d: torch.nn.Module, micro_batch: int = 16):
        self.i3d = i3d
        self.micro_batch = micro_batch
        self.fake: list[np.ndarray] = []
        self.real: list[np.ndarray] = []

    @torch.no_grad()
    def embed(self, videos_uint8) -> np.ndarray:
        """uint8 (b, t, h, w, c) -> (b, 400) I3D logits (float32)."""
        if videos_uint8.shape[1] < 9:
            # three stride-2 temporal halvings, then a VALID (2, 7, 7)
            # average pool: below 9 frames its output is empty
            raise ValueError(
                f"FVD's I3D needs >= 9 frames, got {videos_uint8.shape[1]} "
                "(the reference protocol uses 16)")
        device = next(self.i3d.parameters()).device
        chunks = []
        for i in range(0, len(videos_uint8), self.micro_batch):
            x = preprocess_videos(videos_uint8[i:i + self.micro_batch],
                                  device=device)
            chunks.append(self.i3d(x.permute(0, 4, 1, 2, 3)).cpu().numpy())
        return np.concatenate(chunks, axis=0)

    def update(self, fake_uint8, real_uint8) -> dict:
        self.fake.append(self.embed(fake_uint8))
        self.real.append(self.embed(real_uint8))
        fake = np.concatenate(self.fake, axis=0)
        real = np.concatenate(self.real, axis=0)
        return {"fvd": frechet_distance(fake, real),
                "kvd": polynomial_mmd(fake, real), "n": len(fake)}
