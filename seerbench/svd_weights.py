"""Seeded weights of Stable Video Diffusion XT in the released key set
(diffusers' UNet and VAE names, HF's image-encoder names), made on the
device, as ``weights.py`` makes Seer's: the key set and shapes come from
the reference models on the meta device (``reference/svd_sampling.py``),
one ``torch.randn`` fills a flat buffer, each leaf is a view of it:

- matrices and convolutions (every ``proj_out``, temporal conv and
  ``time_conv_out`` included): std 1 / sqrt(fan_in);
- norm weights: 1 + 0.1 n; biases: 0.02 n; the class and position
  embeddings: 0.02 n;
- each blend's ``mix_factor``: 0.75 clamp(n, -2, 2), so that
  sigmoid(mix_factor) lies in (0.18, 0.82) and both branches of every
  blend reach the output.

The weights are served in bf16; the port loads them through
``io/pretrained.convert_svd``, as it would load the released files.
"""
from __future__ import annotations

import math

import torch

from .reference.svd_sampling import MODEL_KEYS, build_meta

TABLES = ("class_embedding", "position_embedding.weight")


def _kind(name: str, t: torch.Tensor) -> str:
    if name.endswith("mix_factor"):
        return "mix"
    if name.endswith(TABLES):
        return "table"
    if t.dim() >= 2:
        return "matrix"
    return "norm" if name.endswith("weight") else "bias"


@torch.no_grad()
def make_state(config: dict, seed: int, device,
               dtype: torch.dtype = torch.bfloat16) -> dict:
    """``{"unet.<name>" | "vae.<name>" | "image_encoder.<name>": tensor}``
    drawn from ``seed`` on ``device``."""
    models = build_meta(config)
    leaves = [(f"{key}.{name}", tuple(t.shape), _kind(name, t))
              for key in MODEL_KEYS
              for name, t in getattr(models, key).state_dict().items()]
    total = sum(math.prod(s) for _, s, _ in leaves)
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    at = 0
    for name, shape, kind in leaves:
        n = math.prod(shape)
        t = flat[at:at + n]
        at += n
        if kind == "matrix":
            t.mul_(1.0 / math.sqrt(n // shape[0]))
        elif kind == "norm":
            t.mul_(0.1).add_(1.0)
        elif kind == "mix":
            t.clamp_(-2.0, 2.0).mul_(0.75)
        else:
            t.mul_(0.02)
    out = flat.to(dtype)
    del flat
    state, at = {}, 0
    for name, shape, _ in leaves:
        n = math.prod(shape)
        state[name] = out[at:at + n].view(shape)
        at += n
    return state


def split(state: dict) -> dict:
    """``{model key: its state dict}``."""
    out = {key: {} for key in MODEL_KEYS}
    for name, t in state.items():
        key, _, rest = name.partition(".")
        out[key][rest] = t
    return out


def load_into_port(models, state: dict) -> None:
    """Strictly load ``state`` into the port's ``SVDModels`` through the
    released-weight loader."""
    from seervideoldm_tpu_torch.io.pretrained import convert_svd

    parts = split(state)
    convert_svd(parts["unet"], parts["vae"], parts["image_encoder"], models)
