"""Pyramid Attention Broadcast (PAB; Zhao et al. 2024, arXiv 2408.12588):
the port's copy of ``seervideoldm_tpu/diffusion/pab.py`` (numpy only).

Attention outputs change slowly between adjacent sampler steps in the
middle of the trajectory, at a rate that differs by attention type:
spatial fastest, temporal slower, text cross-attention slowest.  PAB
computes each type's residual delta every ``range`` steps and reuses the
cached delta in between.

The schedule works on sampler step indices (0 = highest timestep) and is
built in Python: a deduplicated tuple of step modes (which types reuse
their cache) and each step's mode.  The sampler hands each step's flags
(``mode_to_flags``) and one cache dict, made for that sampling call, to
the UNet (``models/transformer3d.py::pab_residual``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

# True = reuse the cached delta this step; False = compute and store it
SPATIAL = "spatial"    # per-frame spatial self-attention (text block attn1)
CROSS = "cross"        # per-frame text cross-attention (text block attn2)
TEMPORAL = "temporal"  # SWAT windowed causal temporal attention

COMPUTE_ALL: Tuple[bool, bool, bool] = (False, False, False)


@dataclass(frozen=True)
class PABConfig:
    """Broadcast ranges per attention type and the trajectory window.

    ``*_range = n``: inside the window, compute that attention every n-th
    step and reuse its delta for the n - 1 steps between; 1 never reuses.
    ``window = (lo, hi)``: fractions of the step count outside of which
    every attention is computed."""

    spatial_range: int = 2
    cross_range: int = 6
    temporal_range: int = 4
    window: Tuple[float, float] = (0.1, 0.9)

    def __post_init__(self):
        for name in ("spatial_range", "cross_range", "temporal_range"):
            v = getattr(self, name)
            if not (isinstance(v, int) and v >= 1):
                raise ValueError(f"pab {name} must be an int >= 1, got {v!r}")
        lo, hi = self.window
        if not 0.0 <= lo <= hi <= 1.0:
            raise ValueError("pab window must satisfy 0 <= lo <= hi <= 1, "
                             f"got {self.window}")

    @property
    def enabled(self) -> bool:
        return max(self.spatial_range, self.cross_range,
                   self.temporal_range) > 1


def build_pab_schedule(num_steps: int, config: PABConfig
                       ) -> Tuple[Tuple[Tuple[bool, bool, bool], ...],
                                  np.ndarray]:
    """``(modes, mode_idx)``: the deduplicated step modes, each a
    ``(spatial_cached, cross_cached, temporal_cached)`` triple with
    ``modes[0]`` the all-compute mode (step 0 has nothing to reuse), and
    each step's index into them (int32, ``(num_steps,)``).  Inside the
    window a type is computed at the window's first step and every
    ``range`` steps after it; outside it everything is computed."""
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    lo_frac, hi_frac = config.window
    w_lo = int(np.ceil(lo_frac * num_steps))
    w_hi = int(np.floor(hi_frac * num_steps))  # exclusive
    ranges = (config.spatial_range, config.cross_range, config.temporal_range)
    step_flags = []
    for i in range(num_steps):
        if i == 0 or not w_lo <= i < w_hi:
            step_flags.append(COMPUTE_ALL)
        else:
            step_flags.append(tuple((i - w_lo) % r != 0 for r in ranges))
    modes = [COMPUTE_ALL]
    for flags in step_flags:
        if flags not in modes:
            modes.append(flags)
    mode_idx = np.asarray([modes.index(f) for f in step_flags], dtype=np.int32)
    return tuple(modes), mode_idx


def mode_to_flags(mode: Tuple[bool, bool, bool]) -> dict:
    """A mode triple as the flag dict the UNet takes."""
    return {SPATIAL: mode[0], CROSS: mode[1], TEMPORAL: mode[2]}
