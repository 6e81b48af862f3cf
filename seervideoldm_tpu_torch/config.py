"""YAML configuration, key-compatible with the JAX package's configs (the
port's own copy, cut to the keys the sampling, training, evaluation and
serving paths read),
with its ``pab_config_from``, ``sampler_schedule_from`` and
``sampling_kwargs_from``.

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
    saved_global_step: Optional[int] = None
    output_dir: str = "outputs/run"
    # --- data ---
    dataset: str = "sthv2"
    dataset_path: Optional[str] = None  # or the reference's `data_dir` key
    center_crop: bool = True
    dataloader_num_workers: int = 4     # or the reference's `num_workers`
    # --- training (the keys of configs/train.yaml) ---
    train_batch_size: int = 1
    gradient_accumulation_steps: int = 2
    learning_rate: float = 1.28e-5
    scale_lr: bool = True
    lr_scheduler: str = "cosine"
    lr_warmup_steps: int = 10000
    max_train_steps: int = 200000
    num_train_epochs: int = 10000
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 0.3
    vae_sample_posterior: bool = True   # False: encode the posterior mean
    ema_decay: float = 0.0              # 0 disables the EMA
    snr_gamma: float = 0.0              # min-SNR-gamma; 0 disables
    text_loss: bool = False
    trainable_scope: str = "reference"  # or "all"
    save_steps: int = 1000
    max_to_keep: Optional[int] = None
    logging_dir: str = "logs"
    remat: Any = False                  # False | True | "block" | "save_attn"
    gradient_checkpointing: bool = False  # the reference's key for remat
    param_dtype: str = "float32"        # or "bfloat16": bf16 storage, masters
    use_8bit_adam: bool = False         # blockwise int8 Adam moments
    # LoRA adapters on the UNet's attention projections (0: off); the UNet
    # freezes and the adapters + FSText train; delta scaled by alpha / rank
    lora_rank: int = 0
    lora_alpha: Optional[float] = None  # null: the rank (scale 1)
    lora_targets: str = "attention"     # or "temporal"
    # sharded optimizer state / parameters over 'data' (parallel/sharding.py)
    zero1: bool = False
    fsdp: bool = False
    # {"data": D, "seq": S} over the ranks torchrun starts; null: all data
    mesh_shape: Optional[dict] = None
    ring_attention: bool = True         # False: gather-based paths under seq
    push_to_hub: bool = False
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
    pab_spatial_range: int = 2
    pab_cross_range: int = 6
    pab_temporal_range: int = 4
    pab_window: list = field(default_factory=lambda: [0.1, 0.9])
    tome_ratio: float = 0.0
    tome_min_tokens: int = 1024
    freeu: Optional[list] = None
    total_frames: Optional[int] = None
    num_samples: int = 1
    sample_iter: int = 1
    n_rows: int = 2
    val_batch_size: int = 1
    # --- evaluation (the JAX package's keys and defaults) ---
    compute_fvd: bool = True
    MAX_FVD_BATCH: int = 32
    compute_is: bool = False
    MAX_IS_BATCH: int = 100
    is_cast_frames: bool = False        # resample clips to C3D's 16 frames
    i3d_ckpt: Optional[str] = None
    c3d_ckpt: Optional[str] = None
    c3d_mean_path: Optional[str] = None  # default: mean2.npz beside c3d_ckpt
    compute_clip_sim: bool = False
    clip_sim_ckpt: Optional[str] = None  # a local HF CLIPModel state dict
    image_path: Optional[str] = None
    input_text_prompts: Optional[str] = None
    # --- serving (the JAX package's keys and defaults) ---
    serve_host: str = "127.0.0.1"
    serve_port: int = 8000
    serve_max_batch: int = 4
    serve_max_wait_ms: float = 100.0
    model_overrides: Optional[dict] = None
    extras: dict = field(default_factory=dict)

    def get(self, name: str, default: Any = None) -> Any:
        if name in _FIELDS:
            return getattr(self, name)
        return self.extras.get(name, default)


_FIELDS = {f.name for f in dataclasses.fields(Config)}

PARAM_DTYPES = ("float32", "fp32", "bfloat16", "bf16")


def pab_config_from(cfg: Config):
    """A ``diffusion.pab.PABConfig`` from the flat YAML knobs, or None when
    ``pab: false``."""
    if not cfg.pab:
        return None
    from .diffusion.pab import PABConfig

    return PABConfig(spatial_range=int(cfg.pab_spatial_range),
                     cross_range=int(cfg.pab_cross_range),
                     temporal_range=int(cfg.pab_temporal_range),
                     window=tuple(float(v) for v in cfg.pab_window))


def sampler_schedule_from(cfg: Config):
    """The sampler's ``DiffusionSchedule``: the reference's defaults,
    zero-terminal-SNR rescaled under ``rescale_zero_snr``."""
    from .diffusion.schedules import DiffusionSchedule

    return DiffusionSchedule.create(1000,
                                    rescale_zero_snr=bool(cfg.rescale_zero_snr))


def sampling_kwargs_from(cfg: Config) -> dict:
    """The per-call sampling knobs every entry passes to the pipeline."""
    return dict(sampler=cfg.sampler, guidance_interval=cfg.guidance_interval,
                prediction_type=cfg.prediction_type,
                pab_config=pab_config_from(cfg),
                timestep_spacing=cfg.timestep_spacing,
                guidance_rescale=float(cfg.guidance_rescale))


def parse_remat(value: Any) -> Any:
    """YAML ``remat``: False / none, True / "block", or "save_attn" (any
    case); an unknown value is refused by name, as the JAX package's
    ``_parse_remat`` does, rather than taken as a policy."""
    low = value.lower() if isinstance(value, str) else value
    if low in (False, None, 0, "false", "no", "none", ""):
        return False
    if low in (True, 1, "true", "yes"):
        return True
    if low in ("block", "save_attn"):
        return low
    raise ValueError(f"remat={value!r} is not supported (one of False/none, "
                     "True/block, save_attn)")


def validate(cfg: Config) -> Config:
    cfg.remat = parse_remat(cfg.remat)
    if cfg.mesh_shape is not None:
        for axis, size in dict(cfg.mesh_shape).items():
            if axis not in ("data", "model", "seq"):
                raise ValueError(f"mesh_shape axis {axis!r} is unknown "
                                 "(supported: 'data', 'model', 'seq')")
            if int(size) < 1:
                raise ValueError(f"mesh_shape {axis}={size} must be >= 1")
    if cfg.push_to_hub:
        raise ValueError("push_to_hub is not supported: there is no network "
                         "access; upload the checkpoint directory manually")
    if cfg.center_crop is False:
        raise ValueError("center_crop: false is not supported: the data path "
                         "always applies Resize -> CenterCrop")
    if cfg.trainable_scope not in ("reference", "all"):
        raise ValueError(f"trainable_scope must be 'reference' or 'all', got "
                         f"{cfg.trainable_scope!r}")
    _validate_training_options(cfg)
    if float(cfg.snr_gamma) < 0.0:
        raise ValueError(f"snr_gamma must be >= 0, got {cfg.snr_gamma!r}")
    if not float(cfg.vae_scale) > 0.0:
        raise ValueError(f"vae_scale must be > 0, got {cfg.vae_scale!r}")
    _validate_sampling(cfg)
    return cfg


def _validate_training_options(cfg: Config) -> None:
    """The JAX package's checks of ``lora_rank`` / ``lora_alpha`` /
    ``lora_targets``, and the parameter dtypes the port stores."""
    if str(cfg.param_dtype) not in PARAM_DTYPES:
        raise ValueError(f"param_dtype={cfg.param_dtype!r} is not supported "
                         f"(supported: {PARAM_DTYPES})")
    if int(cfg.lora_rank) < 0:
        raise ValueError(f"lora_rank must be >= 0, got {cfg.lora_rank!r}")
    if int(cfg.lora_rank) > 0 and cfg.trainable_scope != "reference":
        raise ValueError("lora_rank > 0 freezes the full UNet (adapters train "
                         "instead); combine it with trainable_scope: "
                         "reference only")
    if int(cfg.lora_rank) > 0:
        from .training.lora import SCOPES

        if cfg.lora_targets not in SCOPES:
            raise ValueError(f"lora_targets must be one of {SCOPES}, got "
                             f"{cfg.lora_targets!r}")
        if cfg.lora_alpha is not None and float(cfg.lora_alpha) <= 0.0:
            raise ValueError(f"lora_alpha must be > 0, got {cfg.lora_alpha!r}")


def check_serving(cfg: Config) -> None:
    """Serving runs in one process on one card.  The JAX server shards the
    padded batch over the chips of its one process; under the port a mesh
    is one process per rank, and a rank-0 front end would have to
    broadcast every batch to the others, which is not ported."""
    if cfg.mesh_shape:
        raise ValueError(f"serving under mesh_shape={cfg.mesh_shape!r} is not "
                         "ported yet: the port serves on one card (drop "
                         "mesh_shape)")


def _validate_sampling(cfg: Config) -> None:
    """The JAX package's checks of the sampling knobs."""
    if cfg.sampler not in ("ddim", "dpm++", "dpmpp"):
        raise ValueError(f"sampler must be 'ddim' or 'dpm++', got "
                         f"{cfg.sampler!r}")
    if cfg.prediction_type not in ("epsilon", "v_prediction"):
        raise ValueError("prediction_type must be 'epsilon' or "
                         f"'v_prediction', got {cfg.prediction_type!r}")
    if cfg.timestep_spacing not in ("uniform", "trailing"):
        raise ValueError("timestep_spacing must be 'uniform' or 'trailing', "
                         f"got {cfg.timestep_spacing!r}")
    if cfg.rescale_zero_snr and cfg.prediction_type != "v_prediction":
        raise ValueError("rescale_zero_snr requires prediction_type: "
                         "v_prediction (epsilon prediction is undefined at "
                         "the zero-SNR terminal step)")
    if cfg.rescale_zero_snr and cfg.timestep_spacing != "trailing":
        print("warning: rescale_zero_snr without timestep_spacing: trailing "
              "-- sampling will never reach the terminal SNR-0 step")
    if not 0.0 <= float(cfg.tome_ratio) < 1.0:
        raise ValueError(f"tome_ratio must be in [0, 1), got "
                         f"{cfg.tome_ratio!r}")
    if int(cfg.tome_min_tokens) < 4:
        raise ValueError(f"tome_min_tokens must be >= 4, got "
                         f"{cfg.tome_min_tokens!r}")
    fu = cfg.freeu
    if fu is not None and (
            len(fu) != 4 or not all(
                isinstance(v, (int, float)) and not isinstance(v, bool)
                and 0 < v <= 10 for v in fu)):
        raise ValueError("freeu must be [b1, b2, s1, s2] with floats in "
                         f"(0, 10], got {fu!r}")
    if not 0.0 <= float(cfg.guidance_rescale) <= 1.0:
        raise ValueError("guidance_rescale must be in [0, 1], got "
                         f"{cfg.guidance_rescale!r}")
    gi = cfg.guidance_interval
    if gi is not None and (
            len(gi) != 2 or not all(isinstance(v, (int, float)) for v in gi)
            or gi[0] > gi[1]):
        raise ValueError("guidance_interval must be [lo, hi] timesteps with "
                         f"lo <= hi, got {gi!r}")
    if cfg.pab:
        if gi is not None:
            raise ValueError("pab and guidance_interval cannot be combined: "
                             "the interval's single-batch CFG branch "
                             "conflicts with the CFG-batched PAB cache")
        pab_config_from(cfg)  # raises on invalid ranges / window


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
