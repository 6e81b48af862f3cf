"""Plain fp32 sampling: the DDIM tables, Pyramid Attention Broadcast's
schedule, DDIM with classifier-free guidance batched as [uncond; cond] and
the clean cond latents re-concatenated at every step, and the whole
image + prompt -> video path.  Frozen copies of the port's
``diffusion/schedules.py``, ``diffusion/pab.py``, ``diffusion/ddim.py``
and ``pipelines/text_video.py`` (one chunk, DDIM, eta 0).

Reference parity notes kept on purpose:

- the DDIM grid is ``range(0, 1000, 1000 // steps) + 1`` (the reference's
  +1 offset), so 30 uniform steps make 31 UNet calls;
- sampling uses the reference's default linear schedule (1e-4 -> 2e-2 in
  sqrt space) while training noises with SD-1.5's scaled-linear one
  (0.00085 -> 0.012): the two schedules do not match, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .layers import CROSS, SPATIAL, TEMPORAL
from .vae import VAE_SCALE

# frames per VAE call: bounds the reference's activation memory
VAE_FRAMES = 8


def linear_alphas_cumprod(n: int = 1000, start: float = 1e-4,
                          end: float = 2e-2) -> np.ndarray:
    betas = np.linspace(start ** 0.5, end ** 0.5, n, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas, axis=0).astype(np.float32)


def sd15_train_alphas_cumprod(n: int = 1000) -> np.ndarray:
    return linear_alphas_cumprod(n, 0.00085, 0.012)


@dataclass(frozen=True)
class DDIMTables:
    timesteps: np.ndarray
    alphas: np.ndarray
    alphas_prev: np.ndarray
    sqrt_one_minus_alphas: np.ndarray


def ddim_tables(num_steps: int, n: int = 1000) -> DDIMTables:
    """Reverse-ordered tables of the uniform grid, eta 0."""
    acp = linear_alphas_cumprod(n).astype(np.float64)
    ts = np.asarray(list(range(0, n, n // num_steps))) + 1
    alphas = acp[ts]
    alphas_prev = np.asarray([acp[0]] + acp[ts[:-1]].tolist())
    rev = slice(None, None, -1)
    return DDIMTables(ts[rev].astype(np.int32), alphas[rev].astype(np.float32),
                      alphas_prev[rev].astype(np.float32),
                      np.sqrt(1.0 - alphas)[rev].astype(np.float32))


def pab_flags(num_steps: int, spatial: int, cross: int, temporal: int,
              window=(0.1, 0.9)) -> list:
    """Each step's {kind: reuse the cached delta}: inside the window a
    kind is computed at the window's first step and every ``range`` steps
    after it; step 0 and the steps outside compute everything."""
    w_lo = int(np.ceil(window[0] * num_steps))
    w_hi = int(np.floor(window[1] * num_steps))
    out = []
    for i in range(num_steps):
        if i == 0 or not w_lo <= i < w_hi:
            flags = (False, False, False)
        else:
            flags = tuple((i - w_lo) % r != 0 for r in (spatial, cross, temporal))
        out.append(dict(zip((SPATIAL, CROSS, TEMPORAL), flags)))
    return out


def draws(seed: int, b: int, f1: int, f2: int, lat: tuple, device) -> tuple:
    """The posterior noise (b, f1, *lat) and x_T (b, f2, *lat), drawn in
    that order from a generator seeded ``seed`` on ``device``, as the
    pipeline draws them."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    post = torch.randn((b, f1) + tuple(lat), generator=g, device=device)
    x_T = torch.randn((b, f2) + tuple(lat), generator=g, device=device)
    return post, x_T


def _chunks(fn, *xs):
    """fn over (b, f, ...) tensors flattened to frames, VAE_FRAMES at a
    time."""
    b, f = xs[0].shape[:2]
    flat = [x.reshape(b * f, *x.shape[2:]) for x in xs]
    out = torch.cat([fn(*(x[i:i + VAE_FRAMES] for x in flat))
                     for i in range(0, b * f, VAE_FRAMES)])
    return out.reshape(b, f, *out.shape[1:])


def vae_encode(vae, video, noise):
    """(b, f, h, w, 3) in [-1, 1] -> scaled latents, posterior draw
    ``noise`` (b, f, h/8, w/8, 4)."""
    return _chunks(lambda v, n: vae.encode(v, n) * VAE_SCALE, video, noise)


def vae_decode(vae, latents):
    """Scaled latents (b, f, h', w', 4) -> frames (b, f, h, w, 3) in [0, 1]."""
    x = _chunks(lambda z: vae.decode(z / VAE_SCALE), latents)
    return ((x + 1.0) / 2.0).clamp(0.0, 1.0)


@torch.no_grad()
def generate(models, cond, ids, mask, uc_ids, uc_mask, post_noise, x_T,
             ddim_steps: int, guidance_scale: float, pab=None) -> tuple:
    """cond frames (b, f1, h, w, 3) in [-1, 1], token ids / masks (b, 77),
    the draws -> (latents (b, f2, h/8, w/8, 4), frames (b, f2, h, w, 3)).
    ``pab``: (spatial, cross, temporal) ranges, or None."""
    x0 = vae_encode(models.vae, cond, post_noise)
    context = models.fstext(models.clip(ids, mask))
    b, f = context.shape[:2]
    uncond = models.clip(uc_ids, uc_mask)
    uncond = uncond[:, None].expand(b, f, *uncond.shape[1:])
    ctx_in = torch.cat([uncond, context])
    tables = ddim_tables(ddim_steps)
    steps = len(tables.timesteps)
    flags = pab_flags(steps, *pab) if pab else [None] * steps
    cache = {}
    f1 = x0.shape[1]
    img = x_T
    for i, t in enumerate(tables.timesteps.tolist()):
        x_cat = torch.cat([x0, img], dim=1)
        ts = torch.full((2 * b,), int(t), dtype=torch.int32, device=img.device)
        e = models.unet(torch.cat([x_cat, x_cat]), ts, ctx_in,
                        pab=None if flags[i] is None else (flags[i], cache))
        e_u, e_c = e[:, f1:].chunk(2)
        e_t = e_u + guidance_scale * (e_c - e_u)
        a_t, a_prev = tables.alphas[i], tables.alphas_prev[i]
        pred_x0 = (img - float(tables.sqrt_one_minus_alphas[i]) * e_t) / float(np.sqrt(a_t))
        c_dir = float(np.sqrt(np.maximum(np.float32(1.0) - a_prev, np.float32(0.0))))
        img = float(np.sqrt(a_prev)) * pred_x0 + c_dir * e_t
    return img, vae_decode(models.vae, img)
