"""SWAT spatio-temporal window partitioning (port of
``seervideoldm_tpu/ops/windows.py``).

``window_partition`` maps ``(B, F, H, W, C)`` to ``(nW*B, F*ws*ws, C)``;
each window's tokens are f-major and the window-grid index is major
relative to the batch (the reference's ``permute(2, 4, 0, 1, 3, 5, 6)``).
"""
from __future__ import annotations

from typing import Optional

import torch

MAX_WIN_SIZE = 8
MAX_RATIO = 4
MIN_WIN_SIZE = 4


def select_window_size(h: int) -> Optional[int]:
    """None means full-frame (no windowing)."""
    if h <= MIN_WIN_SIZE:
        return None
    return MAX_WIN_SIZE if (h // MAX_WIN_SIZE) >= MAX_RATIO else MIN_WIN_SIZE


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, F, H, W, C) -> (nW*B, F*ws*ws, C), window-grid-major."""
    b, f, h, w, c = x.shape
    x = x.reshape(b, f, h // ws, ws, w // ws, ws, c)
    return x.permute(2, 4, 0, 1, 3, 5, 6).reshape(-1, f * ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, f: int, h: int,
                   w: int) -> torch.Tensor:
    """(nW*B, F*ws*ws, C) -> (B, F, H, W, C)."""
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(h // ws, w // ws, b, f, ws, ws, c)
    return x.permute(2, 3, 0, 4, 1, 5, 6).reshape(b, f, h, w, c)
