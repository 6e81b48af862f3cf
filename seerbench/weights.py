"""Seeded weights in the port's key set, made on the device.

The key set and shapes come from the benchmark's own reference models
(built on the meta device, so nothing is allocated); the port loads the
same dict strictly, so a key the two disagree on fails the run.  One
``torch.randn`` on the card fills one flat bf16 buffer (the type the
weights are served in); each leaf is a view of it, scaled in place:

- matrices and convolutions: std 1 / sqrt(fan_in), every ``proj_out``
  included, so every transformer site reaches the output (the port's own
  init zeroes ``proj_out`` and makes each site the identity);
- norm weights: 1 + 0.1 n; biases: 0.02 n; embedding tables and FSText's
  query and position table: 0.02 n;
- the rotary ``freqs`` buffers: their fixed inverse frequencies.
"""
from __future__ import annotations

import math

import torch

from .reference import MODEL_KEYS, build_meta
from .reference.layers import inv_freq


def _leaves(config: dict):
    """[(name, shape, kind)] of every parameter and buffer, in the order of
    the models' state dicts."""
    models = build_meta(config)
    out = []
    for key in MODEL_KEYS:
        module = getattr(models, key)
        for name, t in module.state_dict(keep_vars=True).items():
            full = f"{key}.{name}"
            if not isinstance(t, torch.nn.Parameter):
                if not name.endswith("rotary_emb.freqs"):
                    raise ValueError(f"unexpected buffer {full}")
                kind = "freqs"
            elif t.dim() >= 2 and "embedding" not in name:
                kind = "matrix"
            elif t.dim() == 1 and name.endswith("weight"):
                kind = "norm"
            elif name.endswith("bias"):
                kind = "bias"
            else:
                kind = "table"
            out.append((full, tuple(t.shape), kind))
    return out


@torch.no_grad()
def make_state(config: dict, seed: int, device,
               dtype: torch.dtype = torch.bfloat16) -> dict:
    """``{"<model>.<name>": tensor}`` drawn from ``seed`` on ``device``."""
    leaves = _leaves(config)
    total = sum(math.prod(s) for _, s, k in leaves if k != "freqs")
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    state, at = {}, 0
    for name, shape, kind in leaves:
        if kind == "freqs":
            state[name] = inv_freq(shape[0] * 2, device=device)
            continue
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        if kind == "matrix":
            t.mul_(1.0 / math.sqrt(n // shape[0]))
        elif kind == "norm":
            t.mul_(0.1).add_(1.0)
        else:
            t.mul_(0.02)
        state[name] = t
    out = flat.to(dtype)
    del flat
    at = 0
    for name, shape, kind in leaves:
        if kind != "freqs":
            n = math.prod(shape)
            state[name] = out[at:at + n].view(shape)
            at += n
    return state


def load_into_port(models, state: dict) -> None:
    """Strictly load ``state`` into the port's ``SeerModels`` (each tensor
    cast to its module's dtype) and into its fp32 masters, when it has
    them."""
    for key in MODEL_KEYS:
        prefix = key + "."
        sd = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
        getattr(models, key).load_state_dict(sd, strict=True)
    if models.masters is not None:
        with torch.no_grad():
            for name, master in models.masters.items():
                master.copy_(state[name])

