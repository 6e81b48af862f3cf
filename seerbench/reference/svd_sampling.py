"""Plain fp32 reference of Stable Video Diffusion sampling (diffusers
``StableVideoDiffusionPipeline`` and ``EulerDiscreteScheduler`` at SVD-XT's
published settings), and ``build``, which makes the reference models from
a configuration file.

- Karras sigmas (rho 7) from ``sigma_max`` to ``sigma_min``, then 0; the
  UNet's timestep is ``c_noise = ln(sigma) / 4``; x_T = n sqrt(sigma_max^2
  + 1); input ``cat(x / sqrt(sigma^2 + 1), image latents)``; v-prediction,
  ``x0 = -sigma / sqrt(sigma^2 + 1) v + x / (sigma^2 + 1)``; Euler,
  ``x + (x - x0) / sigma (sigma_next - sigma)``;
- CFG ``[uncond; cond]`` with a zero image embedding and zero image
  latents for uncond, guidance ``linspace(min, max, frames)`` per frame;
  added time ids ``[fps - 1, motion bucket, noise augmentation]``;
- the generator draws the augmentation noise (image-shaped, channels
  last, as the program lays the image out), then x_T ``(b, f, h, w, 4)``
  channels last; both are permuted here to diffusers' layout;
- the decode takes every frame in one call, latents / 0.18215, frames
  mapped to [0, 1].

Latents leave ``generate`` as ``(b, f, h, w, 4)`` and frames as
``(b, f, H, W, 3)``, the program's layout.  It imports nothing of the
program.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .svd_image import CLIPVisionModelWithProjection, VisionConfig, preprocess
from .svd_unet import SVDUNetConfig, UNetSpatioTemporalConditionModel
from .svd_vae import AutoencoderKLTemporalDecoder, SVDVAEConfig

MODEL_KEYS = ("unet", "vae", "image_encoder")


@dataclass
class SVDModels:
    unet: UNetSpatioTemporalConditionModel
    vae: AutoencoderKLTemporalDecoder
    image_encoder: CLIPVisionModelWithProjection


def widths(config: dict) -> dict:
    """Constructor keywords of the three models from a configuration
    file (``seerbench/configs/svd-xt.json``)."""
    u, v, i = config["unet"], config["vae"], config["image_encoder"]
    return {
        "unet": dict(in_channels=u["in_channels"], out_channels=u["out_channels"],
                     block_out_channels=tuple(u["block_out_channels"]),
                     layers_per_block=u["layers_per_block"],
                     num_attention_heads=tuple(u["num_attention_heads"]),
                     cross_attention_dim=u["cross_attention_dim"],
                     addition_time_embed_dim=u["addition_time_embed_dim"],
                     projection_class_embeddings_input_dim=u[
                         "projection_class_embeddings_input_dim"],
                     norm_num_groups=u["norm_num_groups"]),
        "vae": dict(in_channels=v["in_channels"], out_channels=v["out_channels"],
                    latent_channels=v["latent_channels"],
                    block_out_channels=tuple(v["block_out_channels"]),
                    layers_per_block=v["layers_per_block"],
                    norm_num_groups=v["norm_num_groups"]),
        "image_encoder": dict(image_size=i["image_size"],
                              patch_size=i["patch_size"],
                              hidden_size=i["hidden_size"],
                              intermediate_size=i["intermediate_size"],
                              num_hidden_layers=i["num_hidden_layers"],
                              num_attention_heads=i["num_attention_heads"],
                              projection_dim=i["projection_dim"],
                              layer_norm_eps=i["layer_norm_eps"]),
    }


def build_meta(config: dict) -> SVDModels:
    w = widths(config)
    with torch.device("meta"):
        return SVDModels(
            unet=UNetSpatioTemporalConditionModel(SVDUNetConfig(**w["unet"])),
            vae=AutoencoderKLTemporalDecoder(SVDVAEConfig(**w["vae"])),
            image_encoder=CLIPVisionModelWithProjection(
                VisionConfig(**w["image_encoder"])))


def build(config: dict, state: dict, device, dtype=torch.float32) -> SVDModels:
    """The reference models holding ``state`` (``{"unet.<name>": tensor,
    ...}``, diffusers' and HF's names) in ``dtype``, loaded strictly."""
    models = build_meta(config)
    for key in MODEL_KEYS:
        prefix = key + "."
        sd = {k[len(prefix):]: v.to(device=device, dtype=dtype)
              for k, v in state.items() if k.startswith(prefix)}
        module = getattr(models, key)
        module.load_state_dict(sd, strict=True, assign=True)
        module.requires_grad_(False).eval()
    return models


def karras_sigmas(n: int, sigma_min: float, sigma_max: float,
                  rho: float = 7.0) -> list:
    """n + 1 sigmas as fp32 values: Karras et al. eq. 5, then 0."""
    ramp = np.linspace(0.0, 1.0, n)
    lo, hi = sigma_min ** (1.0 / rho), sigma_max ** (1.0 / rho)
    sigmas = (hi + ramp * (lo - hi)) ** rho
    return np.append(sigmas, 0.0).astype(np.float32).tolist()


def draws(seed: int, image_shape: tuple, latent_shape: tuple, device):
    """The program's generator draws for one pipeline call: the
    augmentation noise (image shape, channels last), then the unit-scale
    x_T (channels last)."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    noise = torch.randn(image_shape, generator=g, device=device)
    x_T = torch.randn(latent_shape, generator=g, device=device)
    return noise, x_T


@torch.no_grad()
def generate(models: SVDModels, image, noise, x_T, s: dict):
    """``image`` (b, H, W, 3) in [-1, 1], ``noise`` / ``x_T`` from
    ``draws``, ``s`` the sampling settings of the configuration file.
    Returns (final latents (b, f, h, w, 4), frames (b, f, H, W, 3) in
    [0, 1])."""
    b = image.shape[0]
    img = image.permute(0, 3, 1, 2)
    emb = models.image_encoder(preprocess(
        img, models.image_encoder.cfg.image_size))[:, None]
    aug = img + s["noise_aug_strength"] * noise.permute(0, 3, 1, 2)
    lat = models.vae.encode_mean(aug)
    frames = x_T.shape[1]
    x = x_T.permute(0, 1, 4, 2, 3) * math.sqrt(s["sigma_max"] ** 2 + 1.0)
    ctx = torch.cat([torch.zeros_like(emb), emb])
    image_lat = torch.cat([torch.zeros_like(lat), lat])[:, None].repeat(
        1, frames, 1, 1, 1)
    ids = torch.tensor([s["fps"] - 1, s["motion_bucket_id"],
                        s["noise_aug_strength"]], device=x.device,
                       dtype=torch.float32).repeat(2 * b, 1)
    guidance = torch.linspace(s["min_guidance_scale"], s["max_guidance_scale"],
                              frames, device=x.device).view(1, frames, 1, 1, 1)
    sigmas = karras_sigmas(s["steps"], s["sigma_min"], s["sigma_max"],
                           s["rho"])
    for i in range(s["steps"]):
        sig, nxt = sigmas[i], sigmas[i + 1]
        inp = torch.cat([x, x]) / math.sqrt(sig * sig + 1.0)
        v = models.unet(torch.cat([inp, image_lat], dim=2),
                        0.25 * math.log(sig), ctx, ids)
        vu, vc = v.chunk(2)
        v = vu + guidance * (vc - vu)
        x0 = v * (-sig / math.sqrt(sig * sig + 1.0)) + x / (sig * sig + 1.0)
        x = x + (x - x0) / sig * (nxt - sig)
    out = models.vae.decoder(x.flatten(0, 1) / s["vae_scale"], frames)
    out = out.reshape(b, frames, *out.shape[1:]).permute(0, 1, 3, 4, 2)
    return (x.permute(0, 1, 3, 4, 2).contiguous(),
            ((out + 1.0) / 2.0).clamp(0.0, 1.0))
