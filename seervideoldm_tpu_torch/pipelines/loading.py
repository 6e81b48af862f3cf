"""Model construction for the entry points (port of the random-init branch,
``model_overrides`` and ``load_finetuned`` of
``seervideoldm_tpu/pipelines/loading.py``).

Weights are random, made from ``cfg.seed``, or come from a checkpoint
directory in the reference's two-file layout (``load_finetuned``: what the
port's trainer and the JAX package's exporter write).  Pretrained SD-1.5
and CLIP checkpoints are not loaded yet (``config.py`` refuses a config
that names one).  ``model_overrides`` (YAML dicts under ``unet`` / ``vae``
/ ``clip`` / ``fstext``) scale the sub-models down for smoke runs, with the
JAX package's keys; the top-level ``tome_ratio`` / ``tome_min_tokens`` and
``freeu`` go into the UNet config unless ``model_overrides.unet`` names
the same key (``unet_config_from``).

``load_models(mesh=...)`` registers the mesh for the model code
(``parallel.activation``) and the ``ring_attention`` key (``ops/ring.py``),
and, when several ranks run, broadcasts rank 0's seeded weights (and fp32
masters) to every rank, so all ranks start from the same values.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from ..config import Config
from ..models.clip_text import CLIPTextConfig
from ..models.unet3d import SeerUNetConfig
from ..models.vae import VAEConfig
from ..ops.ring import set_ring_enabled
from ..parallel.activation import set_activation_mesh
from ..parallel.collectives import broadcast_, group_size
from ..utils.device import DTYPES
from ..utils.tokenizer import build_tokenizer
from .text_video import SeerModels


def compute_dtype(cfg: Config):
    """``compute_dtype`` unless ``mixed_precision: no`` asks for fp32, as in
    the JAX package."""
    key = cfg.compute_dtype or cfg.mixed_precision or "bfloat16"
    if cfg.mixed_precision == "no":
        key = "no"
    return DTYPES[str(key)]


def broadcast_weights(models: SeerModels) -> None:
    """Every parameter, buffer and fp32 master of every rank takes rank 0's
    value (one flat broadcast per dtype and model)."""
    if group_size(None) == 1:
        return
    for m in models.modules():
        tensors = list(m.parameters()) + list(m.buffers())
        _broadcast_flat(tensors)
    if models.masters is not None:
        _broadcast_flat(list(models.masters.values()))


def _broadcast_flat(tensors) -> None:
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            broadcast_(flat, 0)
            for t, src in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(src.view_as(t))


def unet_config_from(cfg: Config) -> SeerUNetConfig:
    """The UNet config: ``model_overrides.unet`` over the defaults, then
    the top-level ToMe / FreeU knobs where the overrides do not set them
    (presence decides: an explicit ``tome_ratio: 0.0`` override stays)."""
    over = (cfg.model_overrides or {}).get("unet") or {}
    unet = SeerUNetConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in over.items()})
    if float(cfg.tome_ratio or 0.0) > 0.0 and "tome_ratio" not in over:
        tome_min = (unet.tome_min_tokens if "tome_min_tokens" in over
                    else int(cfg.tome_min_tokens or 1024))
        unet = dataclasses.replace(unet, tome_ratio=float(cfg.tome_ratio),
                                   tome_min_tokens=tome_min)
    if cfg.freeu is not None and "freeu" not in over:
        unet = dataclasses.replace(unet,
                                   freeu=tuple(float(v) for v in cfg.freeu))
    return unet


def load_models(cfg: Config, device=None, trainable_scope=None, mesh=None):
    """``(SeerModels, tokenizer)`` at the config's widths on ``device``;
    ``trainable_scope`` builds them for training (fp32 masters, remat).
    ``mesh`` (``parallel.mesh.Mesh``) is registered for the model code;
    None clears a registered one."""
    set_activation_mesh(mesh)
    set_ring_enabled(bool(cfg.ring_attention))
    overrides = cfg.model_overrides or {}

    def sub(cls, key):
        if key not in overrides:
            return None
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in overrides[key].items()})

    models = SeerModels.initialize(
        num_frames=cfg.num_frames,
        unet_config=unet_config_from(cfg),
        vae_config=sub(VAEConfig, "vae"),
        clip_config=sub(CLIPTextConfig, "clip"),
        fstext_kwargs=overrides.get("fstext"),
        dtype=compute_dtype(cfg), device=device, seed=int(cfg.seed),
        trainable_scope=trainable_scope,
        remat=(cfg.remat or bool(cfg.gradient_checkpointing))
        if trainable_scope else False)
    broadcast_weights(models)
    return models, build_tokenizer(cfg.tokenizer_path)


def resolve_finetuned_dir(cfg: Config) -> Optional[str]:
    """Reference convention: ``<output_dir>/learned_sdunet-steps-<N>``
    selected by ``saved_global_step``, or an explicit ``learned_unet_ckpt``
    path."""
    if cfg.learned_unet_ckpt:
        return cfg.learned_unet_ckpt
    if cfg.saved_global_step:
        path = os.path.join(cfg.output_dir,
                            f"learned_sdunet-steps-{cfg.saved_global_step}")
        if os.path.isdir(path):
            return path
    return None


def load_finetuned(models: SeerModels, ckpt_dir: str) -> SeerModels:
    """Strictly load SeerUNet (``pytorch_model.bin``) and FSText
    (``pytorch_model_1.bin``) from a checkpoint directory into ``models``
    (each tensor cast to the module's own dtype).  Models built for training
    also take their fp32 masters from the files."""
    from ..io.checkpoint import FSTEXT_FILE, UNET_FILE

    for key, fname in (("unet", UNET_FILE), ("fstext", FSTEXT_FILE)):
        path = os.path.join(ckpt_dir, fname)
        if not os.path.exists(path):
            raise FileNotFoundError(f"{path}: not a checkpoint directory in "
                                    "the two-file layout")
        sd = torch.load(path, map_location="cpu")
        getattr(models, key).load_state_dict(sd, strict=True)
        if models.masters is not None:
            with torch.no_grad():
                for name, master in models.masters.items():
                    model, _, pname = name.partition(".")
                    if model == key:
                        master.copy_(sd[pname])
    return models
