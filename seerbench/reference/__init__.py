"""The benchmark's plain reference of Seer: SeerUNet, FSText, the CLIP
text encoder, the SD-1.5 VAE, DDIM with batched CFG and Pyramid Attention
Broadcast, the service's tokenizer, and the training loss, clip and
AdamW, in plain PyTorch, computed in fp32 with TF32 off.

It imports nothing of the program under test: it is a frozen copy of the
port's math, and it takes from the program only the outputs it judges.
``build`` loads the benchmark's own state dict (the same one the program
loads) strictly, so every key of the port's key set is matched.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .text import CLIPTextConfig, CLIPTextModel, FSTextTransformer
from .unet import SeerUNet, UNetConfig
from .vae import AutoencoderKL, VAEConfig

MODEL_KEYS = ("unet", "fstext", "vae", "clip")


@dataclass
class Models:
    unet: SeerUNet
    fstext: FSTextTransformer
    vae: AutoencoderKL
    clip: CLIPTextModel


def set_numerics() -> None:
    """fp32 matmuls and convolutions in fp32, never TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def widths(config: dict) -> dict:
    """Constructor keywords of the four models from a configuration file."""
    return {
        "unet": dict(block_out_channels=tuple(config["block_out_channels"]),
                     layers_per_block=config["layers_per_block"],
                     norm_num_groups=config["norm_num_groups"],
                     cross_attention_dim=config["cross_attention_dim"],
                     attention_head_dim=config["attention_heads"]),
        "vae": dict(block_out_channels=tuple(config["vae_block_out_channels"]),
                    layers_per_block=config["vae_layers_per_block"],
                    norm_num_groups=config["norm_num_groups"]),
        "clip": dict(vocab_size=config["clip_vocab_size"],
                     hidden_size=config["clip_hidden_size"],
                     intermediate_size=config["clip_intermediate_size"],
                     num_hidden_layers=config["clip_layers"],
                     num_attention_heads=config["clip_heads"],
                     max_position_embeddings=config["clip_max_positions"]),
        "fstext": dict(num_frames=config["num_frames"],
                       n_heads=config["fstext_heads"],
                       num_layers=config["fstext_layers"],
                       in_channels=config["cross_attention_dim"],
                       out_channels=config["cross_attention_dim"],
                       cross_attention_dim=config["cross_attention_dim"]),
    }


def build_meta(config: dict) -> Models:
    """The reference models at the configuration's widths on the meta
    device: shapes and names, no storage."""
    w = widths(config)
    with torch.device("meta"):
        return Models(unet=SeerUNet(UNetConfig(**w["unet"])),
                      fstext=FSTextTransformer(**w["fstext"]),
                      vae=AutoencoderKL(VAEConfig(**w["vae"])),
                      clip=CLIPTextModel(CLIPTextConfig(**w["clip"])))


def build(config: dict, state: dict, device, dtype=torch.float32) -> Models:
    """The reference models holding ``state`` (``{"unet.<name>": tensor,
    ...}``, the port's key set) in ``dtype``; every key is loaded
    strictly."""
    models = build_meta(config)
    for key in MODEL_KEYS:
        prefix = key + "."
        sd = {k[len(prefix):]: v.to(device=device, dtype=dtype)
              for k, v in state.items() if k.startswith(prefix)}
        module = getattr(models, key)
        module.load_state_dict(sd, strict=True, assign=True)
        module.requires_grad_(False).eval()
    return models
