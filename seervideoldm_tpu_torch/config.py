"""YAML configuration, key-compatible with the JAX package's configs (the
port's own copy, cut to the keys the image + prompt -> video path reads).

Unknown keys are kept in ``extras`` so a config written for the JAX package
loads unchanged.  PyYAML is imported only when a file is read.
"""
from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class Config:
    pretrained_model_name_or_path: Optional[str] = None
    fstext_init_ckpt: Optional[str] = None
    tokenizer_path: Optional[str] = None
    learned_unet_ckpt: Optional[str] = None
    output_dir: str = "outputs/run"
    resolution: int = 256
    cond_frames: int = 2
    num_frames: int = 12
    seed: int = 0
    mixed_precision: str = "bf16"
    compute_dtype: str = "bfloat16"
    vae_scale: float = 0.18215
    ddim_steps: int = 30
    sampler: str = "ddim"
    scale: float = 7.5  # classifier-free guidance scale
    prediction_type: str = "epsilon"
    timestep_spacing: str = "uniform"
    rescale_zero_snr: bool = False
    guidance_interval: Optional[list] = None
    guidance_rescale: float = 0.0
    pab: bool = False
    tome_ratio: float = 0.0
    freeu: Optional[list] = None
    total_frames: Optional[int] = None
    image_path: Optional[str] = None
    input_text_prompts: Optional[str] = None
    model_overrides: Optional[dict] = None
    extras: dict = field(default_factory=dict)

    def get(self, name: str, default: Any = None) -> Any:
        if name in _FIELDS:
            return getattr(self, name)
        return self.extras.get(name, default)


_FIELDS = {f.name for f in dataclasses.fields(Config)}

# Options of the JAX package that this slice of the port does not run yet;
# a config asking for one is refused rather than silently sampled without it.
_NOT_YET = {
    "sampler": ("ddim",), "prediction_type": ("epsilon",),
    "timestep_spacing": ("uniform",), "rescale_zero_snr": (False,),
    "guidance_interval": (None,), "guidance_rescale": (0.0, 0),
    "pab": (False,), "tome_ratio": (0.0, 0), "freeu": (None,),
    "total_frames": (None,),
}


def validate(cfg: Config) -> Config:
    for key, allowed in _NOT_YET.items():
        if getattr(cfg, key) not in allowed:
            raise ValueError(f"{key}={getattr(cfg, key)!r} is not supported by "
                             f"the PyTorch port yet (supported: {allowed})")
    if cfg.pretrained_model_name_or_path or cfg.learned_unet_ckpt \
            or cfg.fstext_init_ckpt:
        raise ValueError("the PyTorch port runs random weights from a seed; "
                         "checkpoint loading is not ported yet")
    if not float(cfg.vae_scale) > 0.0:
        raise ValueError(f"vae_scale must be > 0, got {cfg.vae_scale!r}")
    return cfg


def config_from_dict(raw: dict) -> Config:
    cfg = Config()
    for key, value in (raw or {}).items():
        if key in _FIELDS:
            setattr(cfg, key, value)
        else:
            cfg.extras[key] = value
    return validate(cfg)


def load_config(path: str, overrides: Optional[list[str]] = None) -> Config:
    """Load a flat YAML config and apply ``key=value`` overrides."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    for item in overrides or []:
        key, _, value = item.partition("=")
        raw[key] = yaml.safe_load(value)
    return config_from_dict(raw)


def parse_args(description: str, extra_flags: Optional[dict] = None,
               argv: Optional[list[str]] = None) -> Config:
    """``--config <yaml>`` plus ``--set key=value`` and script flags."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--set", dest="overrides", action="append", default=[])
    for flag, default in (extra_flags or {}).items():
        parser.add_argument(f"--{flag}", type=str, default=default)
    ns = parser.parse_args(argv)
    cfg = load_config(ns.config, ns.overrides)
    for flag in extra_flags or {}:
        value = getattr(ns, flag)
        if value is not None:
            if flag in _FIELDS:
                setattr(cfg, flag, value)
            else:
                cfg.extras[flag] = value
    return cfg
