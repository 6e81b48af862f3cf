"""Pretrained weights into the port's modules (port of
``seervideoldm_tpu/io/convert.py:147-240``: ``convert_vae``,
``convert_clip_text``, ``convert_clip_vision``, ``convert_clip_projections``,
``convert_seer_unet``, ``convert_fstext``).

The port keeps the reference's torch names, so a file's keys are the
module's ``state_dict`` keys after a few renames:

- VAE: diffusers' newer mid-block attention names map onto the classic
  ones (``to_q`` -> ``query``, ``to_k`` -> ``key``, ``to_v`` -> ``value``,
  ``to_out.0`` -> ``proj_attn``), as the JAX rules do;
- CLIP (text and vision): the ``position_ids`` buffers are dropped;
- SeerUNet from SD-1.5's 2D UNet (inflation): every key of the file lands
  on a parameter of the same shape, and what stays fresh must be the
  temporal attentions;
- SeerUNet and FSText: ``rotary_emb.freqs`` buffers are never read but
  recomputed from ``theta = 10000`` (JAX ``convert.py:111``).

Every key of a file must find a tensor of its shape, or the load raises
naming them.  Each tensor is cast to its module's dtype on its module's
device (``Tensor.copy_``).  Each function returns the module keys it left
fresh, as the JAX ones return the paths they left at their init.  Loading
works on modules on the ``meta`` device too (shapes only).
``write_pretrained_dir`` writes a model set back out in the layout the
loaders read.
"""
from __future__ import annotations

import re
from typing import Mapping, Sequence

import torch
import torch.nn as nn

from ..ops.rotary import inv_freq

# diffusers' newer VAE mid-block attention names -> the classic ones
NEWER_VAE_NAMES = {"to_q": "query", "to_k": "key", "to_v": "value",
                   "to_out.0": "proj_attn"}
VAE_RENAMES = [(rf"mid_block\.attentions\.0\.{re.escape(new)}\.",
                f"mid_block.attentions.0.{old}.")
               for new, old in NEWER_VAE_NAMES.items()]
TEMPORAL = "temporal_attentions"
FREQS = "rotary_emb.freqs"


def load_into(module: nn.Module, state_dict: Mapping[str, torch.Tensor],
              renames: Sequence[tuple[str, str]] = (),
              skip=lambda name: False) -> list[str]:
    """Copy every tensor of ``state_dict`` (keys renamed by ``renames``,
    keys where ``skip`` holds left out) onto the module tensor of that
    name, cast to its dtype on its device.  Raises, before anything is
    copied, when a key has no module tensor of its shape or two keys land
    on one.  Returns the module keys left fresh."""
    target = module.state_dict(keep_vars=True)
    pairs, bad, taken = [], [], set()
    for name, value in state_dict.items():
        if skip(name):
            continue
        dst = name
        for pat, repl in renames:
            dst = re.sub(pat, repl, dst)
        ref = target.get(dst)
        if ref is None or dst in taken or tuple(ref.shape) != tuple(value.shape):
            why = ("no such tensor" if ref is None else "loaded twice"
                   if dst in taken else f"module shape {list(ref.shape)}")
            bad.append(f"{name} {list(value.shape)} -> {dst}: {why}")
            continue
        pairs.append((name, ref))
        taken.add(dst)
    if bad:
        raise ValueError(f"{type(module).__name__}: {len(bad)} of "
                         f"{len(state_dict)} keys do not load, e.g. {bad[:4]}")
    with torch.no_grad():
        for name, ref in pairs:
            ref.copy_(state_dict[name])
    return [k for k in target if k not in taken]


def _strict(module: nn.Module, fresh: list[str]) -> list[str]:
    if fresh:
        raise ValueError(f"{type(module).__name__}: {len(fresh)} tensors "
                         f"have no key in the file, e.g. {fresh[:4]}")
    return fresh


def convert_vae(state_dict: Mapping[str, torch.Tensor], vae: nn.Module
                ) -> list[str]:
    """SD-1.5's ``AutoencoderKL`` (classic or newer diffusers names)."""
    return _strict(vae, load_into(vae, state_dict, VAE_RENAMES))


def convert_clip_text(state_dict: Mapping[str, torch.Tensor],
                      clip: nn.Module) -> list[str]:
    """HF ``CLIPTextModel`` (``text_model.*``)."""
    return _strict(clip, load_into(clip, state_dict,
                                   skip=lambda k: "position_ids" in k))


def convert_clip_vision(state_dict: Mapping[str, torch.Tensor],
                        vision: nn.Module) -> list[str]:
    """The CLIP ViT image tower from a whole HF ``CLIPModel`` state dict
    (its ``vision_model.*`` keys)."""
    sd = {k: v for k, v in state_dict.items() if k.startswith("vision_model.")}
    return _strict(vision, load_into(vision, sd,
                                     skip=lambda k: "position_ids" in k))


def convert_clip_projections(state_dict: Mapping[str, torch.Tensor],
                             projections: nn.Module) -> list[str]:
    """The two no-bias projection heads of HF ``CLIPModel``."""
    sd = {k: state_dict[k]
          for k in ("visual_projection.weight", "text_projection.weight")}
    return _strict(projections, load_into(projections, sd))


def _recompute_rotary(module: nn.Module) -> None:
    """Every ``rotary_emb.freqs`` buffer set to its analytic value."""
    with torch.no_grad():
        for name, buf in module.state_dict(keep_vars=True).items():
            if name.endswith(FREQS):
                buf.copy_(inv_freq(2 * buf.shape[0]))


def convert_seer_unet(state_dict: Mapping[str, torch.Tensor],
                      unet: nn.Module) -> list[str]:
    """A SeerUNet or SD-1.5 2D UNet file (inflation, reference
    ``train.py:175-180``): every key lands, and only temporal-attention
    tensors may stay fresh (all of them for a 2D file).  Returns them."""
    fresh = load_into(unet, state_dict, skip=lambda k: k.endswith(FREQS))
    _recompute_rotary(unet)
    spatial = [k for k in fresh if TEMPORAL not in k]
    if spatial:
        raise ValueError(f"SeerUNet: {len(spatial)} tensors outside the "
                         f"temporal attentions have no key in the file, e.g. "
                         f"{spatial[:4]}")
    return fresh


def convert_fstext(state_dict: Mapping[str, torch.Tensor],
                   fstext: nn.Module) -> list[str]:
    """FSText, strictly but for its ``rotary_emb.freqs`` buffers, which are
    recomputed."""
    fresh = load_into(fstext, state_dict, skip=lambda k: k.endswith(FREQS))
    _recompute_rotary(fstext)
    return _strict(fstext, [k for k in fresh if not k.endswith(FREQS)])


def write_pretrained_dir(models, root: str) -> dict:
    """``models``' weights as a directory the pretrained route reads
    (``pipelines/loading.load_pretrained``, and the JAX package's
    ``load_models``): ``vae/diffusion_pytorch_model.bin``,
    ``text_encoder/pytorch_model.bin``, ``unet/diffusion_pytorch_model.bin``
    (the whole SeerUNet, temporal attentions included, which both loaders
    take where the file has them) and ``fstext.bin`` for
    ``fstext_init_ckpt``; fp32, under the port's (the reference's) names.
    Returns the state dicts written, by model (CPU)."""
    import os

    sds = {key: {k: v.detach().float().cpu()
                 for k, v in getattr(models, key).state_dict().items()
                 if not k.endswith(FREQS)}
           for key in ("vae", "clip", "unet", "fstext")}
    for key, (sub, name) in (("vae", ("vae", "diffusion_pytorch_model.bin")),
                             ("clip", ("text_encoder", "pytorch_model.bin")),
                             ("unet", ("unet", "diffusion_pytorch_model.bin"))):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        torch.save(sds[key], os.path.join(root, sub, name))
    torch.save(sds["fstext"], os.path.join(root, "fstext.bin"))
    return sds
