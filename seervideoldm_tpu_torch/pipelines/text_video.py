"""Image + prompt -> video sampling pipeline (port of
``seervideoldm_tpu/pipelines/text_video.py``: ``SeerModels`` and
``SeerPipeline.generate`` / ``sample_latents``).

CLIP-encode the prompt and the empty uncond prompt -> FSText per-frame
sub-instructions (the uncond context is the raw CLIP embedding repeated per
frame) -> VAE-encode the cond frames x 0.18215 -> DDIM with batched CFG,
re-concatenating the clean cond latents at every step -> per-frame VAE
decode x (1 / 0.18215) -> clamp to [0, 1].  Video layout at this boundary:
``(b, f, h, w, c)``, cond frames in [-1, 1].

Under a registered mesh (``parallel.activation``, port of ``_shard``):
``data`` splits the prompt / image batch when it divides (else every data
rank computes the whole batch, as the JAX package replicates it); the CFG
``[uncond; cond]`` pairing stays whole on each rank.  ``seq`` splits the
latent frames: each rank runs the UNet on its frames of the
``cond + future`` video, the clean cond latents re-concatenated on the
ranks that own frames 0..cond-1, and updates its own future frames; the
VAE runs frame-local, each rank on its share of the frames.  Every rank
returns the whole result; noise is drawn for the whole batch and video on
every rank, so a split run sees the draws of a single-rank run.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from ..diffusion.ddim import ddim_sample_loop
from ..diffusion.schedules import DiffusionSchedule
from ..models.clip_text import CLIPTextConfig, CLIPTextModel
from ..models.fstext import FSTextTransformer
from ..models.unet3d import SeerUNet, SeerUNetConfig
from ..models.vae import VAE_SCALE, AutoencoderKL, VAEConfig
from ..parallel.activation import (frame_local, frame_shard,
                                   get_activation_mesh)
from ..parallel.collectives import all_gather_cat, group_size
from ..training.optim import trainable_names
from ..utils.device import cast_for_compute, resolve_device


def _zero_proj_out(unet: SeerUNet) -> None:
    """The JAX package zero-initialises every transformer site's 1x1
    ``proj_out``, so fresh sites start as the identity."""
    for name, p in unet.named_parameters():
        if ".proj_out." in name:
            torch.nn.init.zeros_(p)


@dataclass
class SeerModels:
    unet: SeerUNet
    fstext: FSTextTransformer
    vae: AutoencoderKL
    clip: CLIPTextModel
    # fp32 masters of the trainable parameters, ``{"unet.<name>" |
    # "fstext.<name>": tensor}``; None for models built for sampling
    masters: Optional[dict] = None

    @staticmethod
    def initialize(num_frames: int = 12,
                   unet_config: Optional[SeerUNetConfig] = None,
                   vae_config: Optional[VAEConfig] = None,
                   clip_config: Optional[CLIPTextConfig] = None,
                   fstext_kwargs: Optional[dict] = None,
                   dtype: torch.dtype = torch.bfloat16, device=None,
                   seed: int = 0, trainable_scope: Optional[str] = None,
                   remat: Union[bool, str] = False) -> "SeerModels":
        """Random weights from ``seed``, built directly on ``device`` (CUDA
        unless asked otherwise) and cast to the compute ``dtype`` (norm
        layers stay fp32).

        For training pass ``trainable_scope`` ('reference' or 'all'): the
        parameters it names keep an fp32 master (``masters``, taken before
        the cast, so the compute copy is the master rounded once) and get
        ``requires_grad``; everything else is frozen as for sampling."""
        dev = resolve_device(device)
        if dev.type == "cuda" and dtype != torch.bfloat16:
            raise ValueError(f"the CUDA kernels compute in bf16, got {dtype}: "
                             "use compute_dtype bfloat16 on the GPU (fp32 "
                             "runs on the CPU, device='cpu')")
        unet_config = unet_config or SeerUNetConfig()
        ctx = unet_config.cross_attention_dim
        fs_kw = dict(in_channels=ctx, out_channels=ctx, cross_attention_dim=ctx)
        fs_kw.update(fstext_kwargs or {})
        forked = [dev] if dev.type == "cuda" else []
        with torch.random.fork_rng(devices=forked), torch.device(dev):
            torch.manual_seed(seed)
            models = SeerModels(
                unet=SeerUNet(unet_config, remat=remat),
                fstext=FSTextTransformer(num_frames=num_frames, **fs_kw),
                vae=AutoencoderKL(vae_config or VAEConfig()),
                clip=CLIPTextModel(clip_config or CLIPTextConfig()))
        _zero_proj_out(models.unet)
        if trainable_scope is not None:
            named = models.named_trainable()
            models.masters = {
                n: named[n].detach().clone()
                for n in trainable_names(models.trainable_modules(),
                                         trainable_scope)}
        for m in models.modules():
            cast_for_compute(m, dtype).eval().requires_grad_(False)
        if models.masters is not None:
            named = models.named_trainable()
            for n in models.masters:
                named[n].requires_grad_(True)
        return models

    def modules(self):
        return (self.unet, self.fstext, self.vae, self.clip)

    def trainable_modules(self) -> dict:
        """The two models training may touch (VAE and CLIP never train)."""
        return {"unet": self.unet, "fstext": self.fstext}

    def named_trainable(self) -> dict:
        """``{"unet.<name>" | "fstext.<name>": parameter}`` of both."""
        return {f"{key}.{name}": p
                for key, m in self.trainable_modules().items()
                for name, p in m.named_parameters()}


class SeerPipeline:
    def __init__(self, models: SeerModels,
                 schedule: Optional[DiffusionSchedule] = None,
                 vae_scale: float = VAE_SCALE):
        self.m = models
        self.schedule = schedule or DiffusionSchedule.create(1000)
        self.vae_scale = float(vae_scale)
        self.device = models.unet.conv_in.weight.device
        self.dtype = models.unet.conv_in.weight.dtype

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               device=self.device, dtype=dtype)

    @torch.no_grad()
    def encode_text(self, input_ids, attention_mask) -> torch.Tensor:
        return self.m.clip(self._tensor(input_ids, torch.long),
                           self._tensor(attention_mask, torch.long))

    @torch.no_grad()
    def fstext(self, clip_emb: torch.Tensor) -> torch.Tensor:
        return self.m.fstext(clip_emb)

    @torch.no_grad()
    def vae_encode_video(self, video: torch.Tensor,
                         noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(b, f, h, w, 3) in [-1, 1] -> (b, f, h/8, w/8, 4) scaled
        latents; ``noise`` the posterior draw, shaped like the latents."""
        if noise is None:
            return frame_local(self._encode, video)
        return frame_local(self._encode, video, noise)

    def _encode(self, video, noise=None):
        b, f = video.shape[:2]
        x = video.reshape(b * f, *video.shape[2:]).to(self.dtype)
        if noise is not None:
            noise = noise.reshape(b * f, *noise.shape[2:])
        z = self.m.vae.encode(x, noise) * self.vae_scale
        return z.reshape(b, f, *z.shape[1:])

    @torch.no_grad()
    def vae_decode_video(self, latents: torch.Tensor) -> torch.Tensor:
        """(b, f, h', w', 4) scaled latents -> (b, f, h, w, 3) in [0, 1]."""
        return frame_local(self._decode, latents)

    def _decode(self, latents):
        b, f = latents.shape[:2]
        z = latents.reshape(b * f, *latents.shape[2:]) / self.vae_scale
        x = self.m.vae.decode(z.to(self.dtype))
        x = x.reshape(b, f, *x.shape[1:])
        return ((x.float() + 1.0) / 2.0).clamp(0.0, 1.0)

    @torch.no_grad()
    def sample_latents(self, x_T: torch.Tensor, x0_emb: torch.Tensor,
                       context: torch.Tensor,
                       uncond_context: Optional[torch.Tensor] = None,
                       ddim_steps: int = 30,
                       guidance_scale: float = 7.5) -> torch.Tensor:
        """x_T (b, f2, h', w', 4) noise; x0_emb (b, f1, h', w', 4) clean
        cond latents; context / uncond_context (b, f1 + f2, l, d).  Returns
        the whole (b, f2, ...) latents, under ``seq`` too."""
        tables = self.schedule.ddim_tables(ddim_steps, eta=0.0)
        f1, f2 = x0_emb.shape[1], x_T.shape[1]
        shard = frame_shard(f1 + f2)
        if shard is None:
            return ddim_sample_loop(self.m.unet, x_T, tables, context,
                                    x0_emb=x0_emb,
                                    uncond_context=uncond_context,
                                    guidance_scale=guidance_scale)
        # this rank's frames of the (cond + future) video
        lo, hi = shard.start, shard.stop
        local = lambda t: None if t is None else t[:, lo:hi]  # noqa: E731
        starts = [sum(shard.counts[:i]) for i in range(len(shard.counts))]
        future = [max(0, a + n - max(a, f1))
                  for a, n in zip(starts, shard.counts)]
        img = ddim_sample_loop(
            functools.partial(self.m.unet, num_frames=f1 + f2),
            x_T[:, max(lo, f1) - f1:max(hi, f1) - f1], tables,
            local(context), x0_emb=x0_emb[:, min(lo, f1):min(hi, f1)],
            uncond_context=local(uncond_context),
            guidance_scale=guidance_scale)
        return all_gather_cat(img, shard.group, 1, future)

    @torch.no_grad()
    def generate(self, cond_video, input_ids, attention_mask, uncond_ids,
                 uncond_mask, num_frames: int, generator: torch.Generator,
                 ddim_steps: int = 30, guidance_scale: float = 7.5
                 ) -> torch.Tensor:
        """cond frames (b, f1, h, w, 3) in [-1, 1] + tokenized prompt ->
        decoded future frames (b, num_frames - f1, h, w, 3) in [0, 1].
        ``generator`` (on the pipeline's device) draws the posterior noise
        and x_T."""
        cond_video = self._tensor(cond_video, torch.float32)
        b, f1, h, w, _ = cond_video.shape
        f2 = num_frames - f1
        if f2 < 1:
            raise ValueError(f"num_frames={num_frames} leaves no future frames "
                             f"beyond the {f1} conditioning frames")
        vcfg = self.m.vae.config
        scale = 2 ** (len(vcfg.block_out_channels) - 1)
        lat = (h // scale, w // scale, vcfg.latent_channels)
        randn = lambda *s: torch.randn(s, generator=generator,  # noqa: E731
                                       device=self.device)
        post_noise = randn(b, f1, *lat)
        x_T = randn(b, f2, *lat)
        rows, data = self._data_rows(b)
        # the uncond prompt may be one row for the whole batch
        ids, mask, uids, umask = (
            t[rows] if t.shape[0] == b else t
            for t in map(self._tensor, (input_ids, attention_mask, uncond_ids,
                                        uncond_mask)))
        x0_emb = self.vae_encode_video(cond_video[rows], post_noise[rows])
        context = self.fstext(self.encode_text(ids, mask))
        if context.shape[1] != num_frames:
            raise ValueError(f"FSText was built for {context.shape[1]} frames "
                             f"but num_frames={num_frames}")
        uncond = self.encode_text(uids, umask)
        uncond_context = uncond[:, None].expand(context.shape[0], num_frames,
                                                *uncond.shape[1:])
        latents = self.sample_latents(x_T[rows].to(x0_emb.dtype), x0_emb,
                                      context, uncond_context, ddim_steps,
                                      guidance_scale)
        frames = self.vae_decode_video(latents)
        if data is not None:
            frames = all_gather_cat(frames, data, 0,
                                    [frames.shape[0]] * group_size(data))
        return frames

    def _data_rows(self, b: int):
        """This rank's rows of a batch of ``b`` under a registered ``data``
        axis, and the group to gather over (None: every rank takes the
        whole batch)."""
        mesh = get_activation_mesh()
        group = mesh.group("data") if mesh is not None else None
        if group is None or b % group_size(group):
            return slice(None), None
        return mesh.batch_slice(b), group
