"""Model construction for the entry points (port of the random-init branch,
``model_overrides`` and ``load_finetuned`` of
``seervideoldm_tpu/pipelines/loading.py``).

Weights are random, made from ``cfg.seed``; then, when the config names
them, SD-1.5's VAE, CLIP text encoder and 2D UNet come from a local
diffusers directory (``pretrained_model_name_or_path``; the UNet inflated
into SeerUNet, the temporal attentions left fresh) and FSText from
``fstext_init_ckpt`` (``load_pretrained``).  A named directory or file
that is missing raises, where the JAX package skips it.  A checkpoint
directory in the reference's two-file layout (``load_finetuned``: what the
port's trainer and the JAX package's exporter write) applies on top.
``param_dtype: bfloat16`` stores every parameter in bf16 (the trainable
masters are then the parameters themselves).  ``model_overrides`` (YAML
dicts under ``unet`` / ``vae``
/ ``clip`` / ``fstext``) scale the sub-models down for smoke runs, with the
JAX package's keys; the top-level ``tome_ratio`` / ``tome_min_tokens`` and
``freeu`` go into the UNet config unless ``model_overrides.unet`` names
the same key (``unet_config_from``).

``model: svd_xt`` builds Stable Video Diffusion XT instead
(``load_svd_models``: ``SVDModels`` of ``pipelines/image_video.py``,
random from ``cfg.seed``, widths from ``model_overrides`` under
``svd_unet`` / ``vae`` / ``image_encoder``, then the released weights from
``<pretrained_model_name_or_path>/{unet,vae,image_encoder}`` when the
config names the directory).  It runs on one card: no mesh.

``load_models(mesh=...)`` registers the mesh for the model code
(``parallel.activation``) and the ``ring_attention`` key (``ops/ring.py``),
and, when several ranks run, broadcasts rank 0's weights (and fp32
masters) to every rank after the pretrained loads, so all ranks start
from the same values.  Under a ``model`` axis every rank then keeps its
slices of them (``parallel.sharding.shard_tensor_parallel``): each loads
whole tensors, ``load_finetuned`` too, and cuts its part.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from ..config import Config
from ..io.pretrained import (convert_clip_text, convert_fstext,
                             convert_seer_unet, convert_svd, convert_vae)
from ..io.state_dict import load_state_dict
from ..models.clip_text import CLIPTextConfig
from ..models.clip_vision import VIT_H14_CONFIG, CLIPVisionConfig
from ..models.svd_unet import SVDUNetConfig
from ..models.unet3d import SeerUNetConfig
from ..models.vae import VAEConfig
from ..ops.ring import set_ring_enabled
from ..parallel.activation import set_activation_mesh
from ..parallel.collectives import broadcast_, group_size
from ..parallel.distributed import is_main_process
from ..parallel.mesh import describe
from ..parallel.sharding import shard_tensor_parallel
from ..utils.device import DTYPES
from ..utils.tokenizer import build_tokenizer
from .image_video import SVDModels
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
    models = initialize_models(cfg, device, trainable_scope)
    broadcast_weights(models)
    if mesh is not None and mesh.size > 1 and is_main_process():
        print(describe(mesh), flush=True)
    shard_tensor_parallel(models, mesh)
    return models, build_tokenizer(cfg.tokenizer_path)


def initialize_models(cfg: Config, device=None,
                      trainable_scope=None) -> SeerModels:
    """This rank's whole models before any collective: the seeded init and
    the pretrained loads (what ``load_models`` broadcasts and splits)."""
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
        param_dtype=DTYPES[str(cfg.param_dtype)],
        trainable_scope=trainable_scope,
        remat=(cfg.remat or bool(cfg.gradient_checkpointing))
        if trainable_scope else False)
    load_pretrained(models, cfg)
    return models


def load_svd_models(cfg: Config, device=None,
                    init: Optional[bool] = None) -> SVDModels:
    """SVD-XT's models for ``cfg`` on ``device`` (``model: svd_xt``).
    Random weights from ``cfg.seed`` unless ``init`` is False or the
    released weights are read (every tensor strictly): then none."""
    if cfg.mesh_shape and any(int(v) > 1 for v in dict(cfg.mesh_shape).values()):
        raise ValueError("model: svd_xt runs on one card (no mesh_shape)")
    over = cfg.model_overrides or {}
    fields = lambda key: {k: tuple(v) if isinstance(v, list) else v  # noqa: E731
                          for k, v in (over.get(key) or {}).items()}
    image = (CLIPVisionConfig(**fields("image_encoder"))
             if "image_encoder" in over else VIT_H14_CONFIG)
    root = cfg.pretrained_model_name_or_path
    models = SVDModels.initialize(
        unet_config=SVDUNetConfig(**fields("svd_unet")),
        vae_config=VAEConfig(**fields("vae")), image_config=image,
        dtype=compute_dtype(cfg), device=device, seed=int(cfg.seed),
        init=not root if init is None else init)
    if root:
        if not os.path.isdir(root):
            raise FileNotFoundError(f"pretrained_model_name_or_path {root!r} "
                                    "is not a directory")
        sub = lambda d, *names: load_state_dict(  # noqa: E731
            _find_weights(os.path.join(root, d), *names))
        convert_svd(sub("unet", "diffusion_pytorch_model.safetensors",
                        "diffusion_pytorch_model.bin"),
                    sub("vae", "diffusion_pytorch_model.safetensors",
                        "diffusion_pytorch_model.bin"),
                    sub("image_encoder", "model.safetensors",
                        "pytorch_model.bin"), models)
    return models


def _find_weights(directory: str, *names: str) -> str:
    """The first of ``names`` that exists in ``directory`` (the JAX
    package's ``_find_weights`` order); raises naming them when none
    does."""
    for name in names:
        path = os.path.join(directory, name)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"{directory}: none of {list(names)} exists")


def _take_masters(models: SeerModels, key: str, sd: dict) -> None:
    """The fp32 masters of ``models.<key>`` take the file's values where
    the file has the parameter (the rest keep their init)."""
    if models.masters is None:
        return
    with torch.no_grad():
        for name, master in models.masters.items():
            model, _, pname = name.partition(".")
            if model == key and pname in sd:
                master.copy_(sd[pname])


def load_pretrained(models: SeerModels, cfg: Config) -> None:
    """SD-1.5 from ``<pretrained_model_name_or_path>/{vae,text_encoder,
    unet}`` (``.safetensors`` before ``.bin``; the UNet's temporal
    attentions stay fresh) and FSText from ``fstext_init_ckpt``, each when
    the config names it; fp32 masters take the loaded values."""
    root = cfg.pretrained_model_name_or_path
    if root:
        if not os.path.isdir(root):
            raise FileNotFoundError(f"pretrained_model_name_or_path {root!r} "
                                    "is not a directory")
        sub = lambda d, *names: load_state_dict(  # noqa: E731
            _find_weights(os.path.join(root, d), *names))
        convert_vae(sub("vae", "diffusion_pytorch_model.safetensors",
                        "diffusion_pytorch_model.bin"), models.vae)
        convert_clip_text(sub("text_encoder", "model.safetensors",
                              "pytorch_model.bin"), models.clip)
        sd = sub("unet", "diffusion_pytorch_model.safetensors",
                 "diffusion_pytorch_model.bin")
        convert_seer_unet(sd, models.unet)
        _take_masters(models, "unet", sd)
    if cfg.fstext_init_ckpt:
        if not os.path.isfile(cfg.fstext_init_ckpt):
            raise FileNotFoundError(f"fstext_init_ckpt "
                                    f"{cfg.fstext_init_ckpt!r} does not exist")
        sd = load_state_dict(cfg.fstext_init_ckpt)
        convert_fstext(sd, models.fstext)
        _take_masters(models, "fstext", sd)


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
    (each tensor cast to the module's own dtype; this rank's slices under
    a ``model`` axis).  Models built for training also take their fp32
    masters from the files."""
    from ..io.checkpoint import FSTEXT_FILE, UNET_FILE

    tp = models.tensor_parallel

    for key, fname in (("unet", UNET_FILE), ("fstext", FSTEXT_FILE)):
        path = os.path.join(ckpt_dir, fname)
        if not os.path.exists(path):
            raise FileNotFoundError(f"{path}: not a checkpoint directory in "
                                    "the two-file layout")
        sd = torch.load(path, map_location="cpu")
        if tp is not None:
            sd = tp.local_dict(sd, prefix=f"{key}.")
        getattr(models, key).load_state_dict(sd, strict=True)
        _take_masters(models, key, sd)
    return models
