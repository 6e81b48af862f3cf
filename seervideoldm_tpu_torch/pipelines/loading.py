"""Model construction for the entry points (port of the random-init branch
and ``model_overrides`` of ``seervideoldm_tpu/pipelines/loading.py``).

Weights are random, made from ``cfg.seed``: pretrained SD-1.5, CLIP and
Seer checkpoints are not loaded by this slice of the port (``config.py``
refuses a config that names one).  ``model_overrides`` (YAML dicts under
``unet`` / ``vae`` / ``clip`` / ``fstext``) scale the sub-models down for
smoke runs, with the JAX package's keys.
"""
from __future__ import annotations

from ..config import Config
from ..models.clip_text import CLIPTextConfig
from ..models.unet3d import SeerUNetConfig
from ..models.vae import VAEConfig
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


def load_models(cfg: Config, device=None):
    """``(SeerModels, tokenizer)`` at the config's widths on ``device``."""
    overrides = cfg.model_overrides or {}

    def sub(cls, key):
        if key not in overrides:
            return None
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in overrides[key].items()})

    models = SeerModels.initialize(
        num_frames=cfg.num_frames,
        unet_config=sub(SeerUNetConfig, "unet"),
        vae_config=sub(VAEConfig, "vae"),
        clip_config=sub(CLIPTextConfig, "clip"),
        fstext_kwargs=overrides.get("fstext"),
        dtype=compute_dtype(cfg), device=device, seed=int(cfg.seed))
    return models, build_tokenizer(cfg.tokenizer_path)
