"""Image -> video sampling with Stable Video Diffusion (diffusers
``StableVideoDiffusionPipeline`` at its published defaults; the port's
second architecture beside Seer's ``text_video.py``).

One call, per image (``(b, h, w, 3)`` in [-1, 1]):

1. the CLIP image embedding (``models/clip_vision.py``, ViT-H/14 with its
   projection) of the image resized to 224 x 224 (bicubic, antialiased),
   mapped to [0, 1] and normalised with CLIP's mean and std;
2. noise augmentation: ``image + noise_aug_strength * n``, the first
   draw of the generator (image-shaped, channels-last);
3. the VAE posterior mean of that image (unscaled), repeated over the
   frames and concatenated to the UNet's input on channels;
4. x_T, the generator's second draw, ``(b, frames, h/8, w/8, 4)`` times
   ``sqrt(sigma_max^2 + 1)``;
5. Euler-EDM over Karras sigmas (``diffusion/euler_edm.py``) with CFG
   ``[uncond; cond]`` in one batch: the uncond rows take a zero image
   embedding and zero image latents; the guidance rises per frame from
   ``min_guidance_scale`` to ``max_guidance_scale``; the added time ids are
   ``[fps - 1, motion_bucket_id, noise_aug_strength]``;
6. every frame decoded in one decoder call (latents / 0.18215), mapped
   to [0, 1].

Spans: the always-on pipeline-call record ``pipe.svd`` (counts:
``unet.calls``, ``svd.frames``, ``svd.steps``), and detailed spans with
CUDA events ``pipe.svd_call`` (the whole call), ``pipe.encode_image``,
``pipe.vae_encode``, ``pipe.sample``, ``pipe.vae_decode``, ``euler.step``
and ``unet.call``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from ..diffusion.euler_edm import (euler_edm_sample_loop, init_noise_sigma,
                                   karras_sigmas)
from ..evaluation.clip_sim import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD
from ..models.clip_vision import (VIT_H14_CONFIG, CLIPVisionConfig,
                                  CLIPVisionModel)
from ..models.svd_unet import SVDUNetConfig, UNetSpatioTemporalConditionModel
from ..models.svd_vae import AutoencoderKLTemporalDecoder
from ..models.vae import VAE_SCALE, VAEConfig
from ..utils import profiling
from ..utils.device import cast_for_compute, resolve_device


@dataclass
class SVDModels:
    unet: UNetSpatioTemporalConditionModel
    vae: AutoencoderKLTemporalDecoder
    image_encoder: CLIPVisionModel

    @staticmethod
    def initialize(unet_config: Optional[SVDUNetConfig] = None,
                   vae_config: Optional[VAEConfig] = None,
                   image_config: Optional[CLIPVisionConfig] = None,
                   dtype: torch.dtype = torch.bfloat16, device=None,
                   seed: int = 0, init: bool = True) -> "SVDModels":
        """Random weights from ``seed``, built on ``device`` (CUDA unless
        asked otherwise) and cast to ``dtype`` (norm layers stay fp32).
        ``init=False`` leaves every tensor uninitialised, for a caller that
        loads all of them next."""
        dev = resolve_device(device)
        if dev.type == "cuda" and dtype != torch.bfloat16:
            raise ValueError(f"the CUDA kernels compute in bf16, got {dtype}")
        forked = [dev] if dev.type == "cuda" else []
        with torch.random.fork_rng(devices=forked), \
                torch.device(dev if init else "meta"):
            torch.manual_seed(seed)
            models = SVDModels(
                unet=UNetSpatioTemporalConditionModel(unet_config
                                                      or SVDUNetConfig()),
                vae=AutoencoderKLTemporalDecoder(vae_config or VAEConfig()),
                image_encoder=CLIPVisionModel(image_config or VIT_H14_CONFIG,
                                              with_projection=True))
        for m in models.modules():
            cast_for_compute(m, dtype).eval().requires_grad_(False)
            if not init:
                m.to_empty(device=dev)
        return models

    def modules(self):
        return (self.unet, self.vae, self.image_encoder)


def clip_image_input(image: torch.Tensor, size: int) -> torch.Tensor:
    """(b, h, w, 3) in [-1, 1] -> (b, 3, size, size) CLIP-normalised: the
    bicubic antialiased resize in [-1, 1] (SVD resizes before mapping to
    [0, 1]), then ``(x + 1) / 2``, then CLIP's mean and std."""
    x = F.interpolate(image.permute(0, 3, 1, 2).float(), size=(size, size),
                      mode="bicubic", align_corners=False, antialias=True)
    x = (x + 1.0) / 2.0
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(CLIP_IMAGE_STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


class SVDPipeline:
    def __init__(self, models: SVDModels, vae_scale: float = VAE_SCALE,
                 sigma_min: float = 0.002, sigma_max: float = 700.0):
        self.m = models
        self.vae_scale = float(vae_scale)
        self.sigma_min, self.sigma_max = float(sigma_min), float(sigma_max)
        self.device = models.unet.conv_in.weight.device
        self.dtype = models.unet.conv_in.weight.dtype

    @torch.no_grad()
    @profiling.span("pipe.encode_image", events=True)
    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        """(b, h, w, 3) in [-1, 1] -> image embeddings (b, 1, d)."""
        enc = self.m.image_encoder
        pixels = clip_image_input(image, enc.config.image_size)
        return enc(pixels.to(self.dtype))[:, None]

    @torch.no_grad()
    @profiling.span("pipe.vae_encode", events=True)
    def vae_encode(self, image: torch.Tensor) -> torch.Tensor:
        """(b, h, w, 3) -> the unscaled posterior mean (b, h/8, w/8, 4)."""
        return self.m.vae.encode(image.to(self.dtype))

    @torch.no_grad()
    @profiling.span("pipe.vae_decode", events=True)
    def vae_decode(self, latents: torch.Tensor) -> torch.Tensor:
        """(b, f, h', w', 4) latents -> (b, f, h, w, 3) in [0, 1]."""
        x = self.m.vae.decode((latents / self.vae_scale).to(self.dtype))
        return ((x.float() + 1.0) / 2.0).clamp(0.0, 1.0)

    @torch.no_grad()
    @profiling.span("pipe.sample", events=True)
    def sample(self, x_T: torch.Tensor, image_latents: torch.Tensor,
               context: torch.Tensor, added_time_ids: torch.Tensor,
               steps: int, guidance: torch.Tensor) -> torch.Tensor:
        sigmas = karras_sigmas(steps, self.sigma_min, self.sigma_max)
        return euler_edm_sample_loop(self.m.unet, x_T, image_latents, context,
                                     added_time_ids, sigmas, guidance,
                                     self.dtype)

    @torch.no_grad()
    @profiling.pipeline_call("pipe.svd")
    def generate(self, image, generator: torch.Generator,
                 num_frames: int = 25, steps: int = 25,
                 min_guidance_scale: float = 1.0,
                 max_guidance_scale: float = 3.0, fps: int = 7,
                 motion_bucket_id: int = 127,
                 noise_aug_strength: float = 0.02,
                 return_latents: bool = False):
        """``image`` (b, h, w, 3) in [-1, 1]; ``generator`` on the
        pipeline's device draws the augmentation noise, then x_T.
        Returns frames (b, num_frames, h, w, 3) in [0, 1] (and the final
        latents with ``return_latents``)."""
        with profiling.span("pipe.svd_call", events=True):
            img = torch.as_tensor(image, device=self.device,
                                  dtype=torch.float32)
            b, h, w = img.shape[:3]
            profiling.count("svd.frames", b * num_frames)
            profiling.count("svd.steps", steps)
            emb = self.encode_image(img)
            noise = torch.randn(img.shape, generator=generator,
                                device=self.device)
            latents = self.vae_encode(img + noise_aug_strength * noise)
            scale = 2 ** (len(self.m.vae.config.block_out_channels) - 1)
            shape = (b, num_frames, h // scale, w // scale,
                     self.m.vae.config.latent_channels)
            x_T = torch.randn(shape, generator=generator, device=self.device)
            x_T = x_T * init_noise_sigma(self.sigma_max)
            ids = torch.tensor([fps - 1, motion_bucket_id, noise_aug_strength],
                               device=self.device, dtype=torch.float32)
            context = torch.cat([torch.zeros_like(emb), emb])
            image_latents = torch.cat([torch.zeros_like(latents), latents])
            image_latents = image_latents[:, None].expand(2 * b, num_frames,
                                                          *latents.shape[1:])
            guidance = torch.linspace(min_guidance_scale, max_guidance_scale,
                                      num_frames, device=self.device)
            final = self.sample(x_T, image_latents, context,
                                ids.expand(2 * b, 3), steps,
                                guidance.view(1, num_frames, 1, 1, 1))
            frames = self.vae_decode(final)
        return (frames, final) if return_latents else frames
