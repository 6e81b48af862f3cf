"""Image + prompt -> video sampling pipeline (port of
``seervideoldm_tpu/pipelines/text_video.py``: ``SeerModels`` and
``SeerPipeline.generate`` / ``generate_rollout`` / ``edit`` /
``sample_latents``).

CLIP-encode the prompt and the empty uncond prompt -> FSText per-frame
sub-instructions (the uncond context is the raw CLIP embedding repeated per
frame) -> VAE-encode the cond frames x 0.18215 -> DDIM or DPM-Solver++
with batched CFG and the sampling knobs, re-concatenating the clean cond
latents at every step -> per-frame VAE decode x (1 / 0.18215) -> clamp to
[0, 1].  Video layout at this boundary: ``(b, f, h, w, c)``, cond frames
in [-1, 1].

Under a registered mesh (``parallel.activation``, port of ``_shard``):
``data`` splits the prompt / image batch when it divides (else every data
rank computes the whole batch, as the JAX package replicates it); the CFG
``[uncond; cond]`` pairing stays whole on each rank.  ``seq`` splits the
latent frames: each rank runs the UNet on its frames of the
``cond + future`` video, the clean cond latents re-concatenated on the
ranks that own frames 0..cond-1, and updates its own future frames; the
VAE runs frame-local, each rank on its share of the frames.  ``model``
splits the weights (``parallel.sharding.shard_tensor_parallel``): the
ranks of one model group hold the same rows and frames, draw the same
x_T and noise, and after each row-parallel projection's all-reduce the
same activations; each data line (one model index) gathers its rows, so
every rank returns the whole result.  Noise is drawn for the whole batch and video on every rank, so a split
run sees the draws of a single-rank run.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from ..diffusion.ddim import (ddim_decode_loop, ddim_sample_loop,
                              stochastic_encode)
from ..diffusion.dpm_solver import dpm_solver_sample_loop
from ..diffusion.pab import build_pab_schedule
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
    # masters of the trainable parameters, ``{"unet.<name>" |
    # "fstext.<name>" | "lora.<key>": tensor}`` (fp32, or the parameters
    # themselves under param_dtype bf16); None for models built for sampling
    masters: Optional[dict] = None
    # LoRA adapters (training/lora.py), ``{"<module path>.lora_a" |
    # ".lora_b": fp32 tensor}``; None without LoRA
    lora: Optional[dict] = None
    # the sharded training state under zero1 / fsdp
    # (parallel.sharding.ShardPlan); None when nothing is sharded
    sharding: Optional[object] = None
    # the model-axis layout (parallel.sharding.TensorParallel); None
    # without a 'model' axis
    tensor_parallel: Optional[object] = None

    @staticmethod
    def initialize(num_frames: int = 12,
                   unet_config: Optional[SeerUNetConfig] = None,
                   vae_config: Optional[VAEConfig] = None,
                   clip_config: Optional[CLIPTextConfig] = None,
                   fstext_kwargs: Optional[dict] = None,
                   dtype: torch.dtype = torch.bfloat16, device=None,
                   seed: int = 0, trainable_scope: Optional[str] = None,
                   remat: Union[bool, str] = False,
                   param_dtype: torch.dtype = torch.float32) -> "SeerModels":
        """Random weights from ``seed``, built directly on ``device`` (CUDA
        unless asked otherwise) and cast to the compute ``dtype`` (norm
        layers stay fp32).  ``param_dtype`` bf16 stores every parameter,
        the norm layers' too, in bf16 (the compute dtype must then be
        bf16: the modules compute in their parameters' dtype).

        For training pass ``trainable_scope`` ('reference' or 'all'): the
        parameters it names keep a master (``masters``) and get
        ``requires_grad``; everything else is frozen as for sampling.  An
        fp32 master is taken before the cast, so the compute copy is the
        master rounded once; under ``param_dtype`` bf16 the master is the
        parameter itself, one tensor."""
        dev = resolve_device(device)
        if dev.type == "cuda" and dtype != torch.bfloat16:
            raise ValueError(f"the CUDA kernels compute in bf16, got {dtype}: "
                             "use compute_dtype bfloat16 on the GPU (fp32 "
                             "runs on the CPU, device='cpu')")
        if param_dtype not in (torch.float32, dtype):
            raise ValueError(f"param_dtype {param_dtype} with compute dtype "
                             f"{dtype}: the port computes in its parameters' "
                             "dtype, so bf16 parameters need compute_dtype "
                             "bfloat16")
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
        names = (trainable_names(models.trainable_modules(), trainable_scope)
                 if trainable_scope is not None else None)
        if names is not None and param_dtype == torch.float32:
            named = models.named_trainable()
            models.masters = {n: named[n].detach().clone() for n in names}
        for m in models.modules():
            cast_for_compute(m, dtype).eval().requires_grad_(False)
            if param_dtype != torch.float32:
                for p in m.parameters():
                    p.data = p.data.to(param_dtype)
        if names is not None:
            named = models.named_trainable()
            if models.masters is None:
                models.masters = {n: named[n].data for n in names}
            for n in models.masters:
                named[n].requires_grad_(True)
        return models

    def modules(self):
        return (self.unet, self.fstext, self.vae, self.clip)

    def trainable_modules(self) -> dict:
        """The two models training may touch (VAE and CLIP never train)."""
        return {"unet": self.unet, "fstext": self.fstext}

    def named_trainable(self) -> dict:
        """``{"unet.<name>" | "fstext.<name>": parameter}`` of both, and
        ``{"lora.<key>": adapter}`` under LoRA."""
        out = {f"{key}.{name}": p
               for key, m in self.trainable_modules().items()
               for name, p in m.named_parameters()}
        out.update({f"lora.{k}": t for k, t in (self.lora or {}).items()})
        return out


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

    def _loop(self, loop, x_T: torch.Tensor, x0_emb: torch.Tensor,
              context: torch.Tensor, uncond_context, tables, **kw):
        """``loop`` (a sampler) over the whole video, or under ``seq`` over
        this rank's frames of the ``cond + future`` video, the result
        joined on every rank."""
        f1, f2 = x0_emb.shape[1], x_T.shape[1]
        shard = frame_shard(f1 + f2)
        if shard is None:
            return loop(self.m.unet, x_T, tables, context, x0_emb=x0_emb,
                        uncond_context=uncond_context, **kw)
        lo, hi = shard.start, shard.stop
        local = lambda t: None if t is None else t[:, lo:hi]  # noqa: E731
        starts = [sum(shard.counts[:i]) for i in range(len(shard.counts))]
        future = [max(0, a + n - max(a, f1))
                  for a, n in zip(starts, shard.counts)]
        img = loop(functools.partial(self.m.unet, num_frames=f1 + f2),
                   x_T[:, max(lo, f1) - f1:max(hi, f1) - f1], tables,
                   local(context), x0_emb=x0_emb[:, min(lo, f1):min(hi, f1)],
                   uncond_context=local(uncond_context), group=shard.group,
                   **kw)
        return all_gather_cat(img, shard.group, 1, future)

    @torch.no_grad()
    def sample_latents(self, x_T: torch.Tensor, x0_emb: torch.Tensor,
                       context: torch.Tensor,
                       uncond_context: Optional[torch.Tensor] = None,
                       ddim_steps: int = 30, guidance_scale: float = 7.5,
                       sampler: str = "ddim", guidance_interval=None,
                       prediction_type: str = "epsilon", pab_config=None,
                       timestep_spacing: str = "uniform",
                       guidance_rescale: float = 0.0) -> torch.Tensor:
        """x_T (b, f2, h', w', 4) noise; x0_emb (b, f1, h', w', 4) clean
        cond latents; context / uncond_context (b, f1 + f2, l, d).  Returns
        the whole (b, f2, ...) latents, under ``seq`` too.

        ``sampler`` "ddim" or "dpm++" (DPM-Solver++ 2M on the same grid);
        ``guidance_interval=(lo, hi)``: CFG only for timesteps in the
        window; ``pab_config`` (``diffusion.pab.PABConfig``): Pyramid
        Attention Broadcast over the table's length (31 UNet calls for 30
        uniform steps; a config with every range 1 runs the all-compute
        mode with its cache at every step); ``timestep_spacing``,
        ``prediction_type`` and ``guidance_rescale`` with a
        ``rescale_zero_snr`` schedule make the zero-terminal-SNR recipe.
        ``guidance_scale == 1`` turns CFG and its knobs off."""
        use_cfg = uncond_context is not None and guidance_scale != 1.0
        sampler = "dpm++" if sampler == "dpmpp" else sampler
        if sampler == "dpm++":
            loop = dpm_solver_sample_loop
        elif sampler == "ddim":
            loop = ddim_sample_loop
        else:
            raise ValueError(f"unknown sampler {sampler!r} (ddim or dpm++)")
        tables = self.schedule.ddim_tables(ddim_steps, eta=0.0,
                                           discr_method=timestep_spacing)
        pab = None
        if pab_config is not None:
            pab = build_pab_schedule(len(tables.timesteps), pab_config)
        if guidance_interval is not None:
            guidance_interval = tuple(float(v) for v in guidance_interval)
        return self._loop(
            loop, x_T, x0_emb, context, uncond_context if use_cfg else None,
            tables, guidance_scale=guidance_scale if use_cfg else 1.0,
            guidance_interval=guidance_interval if use_cfg else None,
            prediction_type=prediction_type, pab=pab,
            guidance_rescale=float(guidance_rescale) if use_cfg else 0.0)

    def latent_shape(self, h: int, w: int) -> tuple:
        """(h', w', latent channels) of an h x w frame."""
        vcfg = self.m.vae.config
        scale = 2 ** (len(vcfg.block_out_channels) - 1)
        return (h // scale, w // scale, vcfg.latent_channels)

    def _rows_of(self, b: int, *tensors):
        """This rank's rows (``_data_rows``) of each tensor with ``b``
        rows; a one-row tensor (an uncond prompt for the whole batch)
        stays whole."""
        rows, data = self._data_rows(b)
        return rows, data, [t[rows] if t.shape[0] == b else t
                            for t in map(self._tensor, tensors)]

    def _gather_rows(self, frames: torch.Tensor, data) -> torch.Tensor:
        if data is None:
            return frames
        return all_gather_cat(frames, data, 0,
                              [frames.shape[0]] * group_size(data))

    def _uncond_context(self, uncond: torch.Tensor, context: torch.Tensor):
        """The raw CLIP uncond embedding repeated per frame."""
        return uncond[:, None].expand(context.shape[0], context.shape[1],
                                      *uncond.shape[1:])

    @torch.no_grad()
    def edit(self, video, input_ids, attention_mask, uncond_ids, uncond_mask,
             cond_frames: int, edit_strength: float,
             generator: torch.Generator, ddim_steps: int = 30,
             guidance_scale: float = 7.5, prediction_type: str = "epsilon",
             timestep_spacing: str = "uniform",
             guidance_rescale: float = 0.0) -> torch.Tensor:
        """SDEdit-style editing (Meng et al., arXiv 2108.01073): the
        future-frame latents of a real clip (``video`` (b, f, h, w, 3) in
        [-1, 1], the first ``cond_frames`` kept clean as conditioning)
        re-noised to ``edit_strength`` of the DDIM grid
        (``stochastic_encode`` at forward index ``t_enc = round(strength *
        len(grid))``, clamped to the noisiest step) and decoded for the
        last ``t_enc`` steps under the new prompt.  Strength 0 returns the
        input's future frames.  ``generator`` draws the posterior noise,
        then the re-noising noise.  Returns (b, f - cond_frames, h, w, 3)
        in [0, 1]."""
        if not 0.0 <= edit_strength <= 1.0:
            raise ValueError(f"edit_strength must be in [0, 1], got "
                             f"{edit_strength}")
        video = self._tensor(video, torch.float32)
        b, f, h, w, _ = video.shape
        f1, lat = cond_frames, self.latent_shape(h, w)
        randn = lambda *s: torch.randn(s, generator=generator,  # noqa: E731
                                       device=self.device)
        post_noise = randn(b, f, *lat)
        noise = randn(b, f - f1, *lat)
        rows, data, (ids, mask, uids, umask) = self._rows_of(
            b, input_ids, attention_mask, uncond_ids, uncond_mask)
        latents = self.vae_encode_video(video[rows], post_noise[rows])
        x0_emb, x0_future = latents[:, :f1], latents[:, f1:]
        context = self.fstext(self.encode_text(ids, mask))
        uncond_context = self._uncond_context(self.encode_text(uids, umask),
                                              context)
        tables = self.schedule.ddim_tables(ddim_steps, eta=0.0,
                                           discr_method=timestep_spacing)
        t_enc = int(round(edit_strength * len(tables.timesteps)))
        if t_enc == 0:
            return self._gather_rows(self.vae_decode_video(x0_future), data)
        use_cfg = guidance_scale != 1.0
        x = stochastic_encode(tables, x0_future, t_enc,
                              noise[rows].to(x0_future.dtype))
        edited = self._loop(
            ddim_decode_loop, x, x0_emb, context,
            uncond_context if use_cfg else None, tables, t_start=t_enc,
            guidance_scale=guidance_scale if use_cfg else 1.0,
            prediction_type=prediction_type,
            guidance_rescale=float(guidance_rescale) if use_cfg else 0.0)
        return self._gather_rows(self.vae_decode_video(edited), data)

    @torch.no_grad()
    def generate(self, cond_video, input_ids, attention_mask, uncond_ids,
                 uncond_mask, num_frames: int, generator: torch.Generator,
                 ddim_steps: int = 30, guidance_scale: float = 7.5,
                 **knobs) -> torch.Tensor:
        """cond frames (b, f1, h, w, 3) in [-1, 1] + tokenized prompt ->
        decoded future frames (b, num_frames - f1, h, w, 3) in [0, 1]: the
        one-chunk rollout.  ``generator`` (on the pipeline's device) draws
        the posterior noise, then x_T; ``knobs`` are ``sample_latents``'s
        sampling keywords."""
        cond_video = self._tensor(cond_video, torch.float32)
        return self.generate_rollout(
            cond_video, [{"input_ids": input_ids,
                          "attention_mask": attention_mask}],
            uncond_ids, uncond_mask, num_frames=num_frames,
            total_frames=num_frames - cond_video.shape[1],
            generator=generator, ddim_steps=ddim_steps,
            guidance_scale=guidance_scale, **knobs)

    @torch.no_grad()
    def generate_rollout(self, cond_video, prompts_tok: list, uncond_ids,
                         uncond_mask, num_frames: int, total_frames: int,
                         generator: torch.Generator, ddim_steps: int = 30,
                         guidance_scale: float = 7.5, **knobs
                         ) -> torch.Tensor:
        """Autoregressive long-video rollout: the ``num_frames`` window
        rolls forward, the last ``f1`` generated latents (or, for chunks
        shorter than f1, the last f1 of the previous window and the chunk)
        conditioning the next chunk, until ``total_frames`` future frames
        exist.  ``prompts_tok``: tokenizer outputs (``input_ids`` /
        ``attention_mask``), one for every chunk or one per chunk (chained
        instructions).  ``generator`` draws the posterior noise, then each
        chunk's x_T in chunk order (the JAX package folds the chunk index
        into its key instead, which a torch generator cannot reproduce), so
        chunk 0 equals ``generate`` with the same generator state.  Returns
        (b, total_frames, h, w, 3) in [0, 1]."""
        cond_video = self._tensor(cond_video, torch.float32)
        b, f1, h, w, _ = cond_video.shape
        f2 = num_frames - f1
        if f2 < 1:
            raise ValueError(f"num_frames={num_frames} leaves no future frames "
                             f"beyond the {f1} conditioning frames")
        if total_frames < 1:
            raise ValueError(f"total_frames must be >= 1, got {total_frames}")
        n_chunks = -(-total_frames // f2)
        if len(prompts_tok) == 1:
            prompts_tok = list(prompts_tok) * n_chunks
        if len(prompts_tok) != n_chunks:
            raise ValueError(f"rollout needs 1 or {n_chunks} prompts (one per "
                             f"{f2}-frame chunk covering total_frames="
                             f"{total_frames}), got {len(prompts_tok)}")
        lat = self.latent_shape(h, w)
        randn = lambda *s: torch.randn(s, generator=generator,  # noqa: E731
                                       device=self.device)
        post_noise = randn(b, f1, *lat)
        rows, data, (uids, umask) = self._rows_of(b, uncond_ids, uncond_mask)
        x0_emb = self.vae_encode_video(cond_video[rows], post_noise[rows])
        uncond = self.encode_text(uids, umask)
        contexts: dict = {}  # chained instructions often repeat

        def context_for(tok):
            key = (np.asarray(tok["input_ids"]).tobytes(),
                   np.asarray(tok["attention_mask"]).tobytes())
            if key not in contexts:
                _, _, (ids, mask) = self._rows_of(b, tok["input_ids"],
                                                  tok["attention_mask"])
                contexts[key] = self.fstext(self.encode_text(ids, mask))
            return contexts[key]

        chunks = []
        for c in range(n_chunks):
            x_T = randn(b, f2, *lat)
            context = context_for(prompts_tok[c])
            if context.shape[1] != num_frames:
                raise ValueError(f"FSText was built for {context.shape[1]} "
                                 f"frames but num_frames={num_frames}")
            latents = self.sample_latents(
                x_T[rows].to(x0_emb.dtype), x0_emb, context,
                self._uncond_context(uncond, context), ddim_steps,
                guidance_scale, **knobs)
            chunks.append(latents)
            if c + 1 < n_chunks:
                x0_emb = (latents[:, -f1:] if f2 >= f1 else
                          torch.cat([x0_emb, latents], dim=1)[:, -f1:])
        frames = self.vae_decode_video(
            torch.cat(chunks, dim=1)[:, :total_frames])
        return self._gather_rows(frames, data)

    def _data_rows(self, b: int):
        """This rank's rows of a batch of ``b`` under a registered ``data``
        axis, and the group to gather over (None: every rank takes the
        whole batch)."""
        mesh = get_activation_mesh()
        group = mesh.group("data") if mesh is not None else None
        if group is None or b % group_size(group):
            return slice(None), None
        return mesh.batch_slice(b), group
