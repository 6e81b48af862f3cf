"""Plain fp32 reference of Stable Video Diffusion's image encoder: HF
``CLIPVisionModelWithProjection`` (OpenCLIP ViT-H/14: 224 px, patch 14,
hidden 1280, 32 pre-LN layers of 16 heads, MLP 5120 with exact GELU,
``pre_layrnorm``, the class token through ``post_layernorm`` and the
no-bias ``visual_projection`` to 1024), and the pipeline's preprocessing
of the conditioning image: a bicubic antialiased resize to 224 x 224 in
[-1, 1] (the antialiasing filter is the assumed one: PyTorch's
``antialias=True``, not diffusers' Gaussian pre-blur), then [0, 1], then
CLIP's mean and std.  Names are HF's (``position_ids`` is not a key)."""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import attention

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_hidden_layers: int = 32
    num_attention_heads: int = 16
    projection_dim: int = 1024
    layer_norm_eps: float = 1e-5


class SelfAttention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)

    def forward(self, x):
        b, n, d = x.shape
        split = lambda t: t.reshape(b, n, self.heads, -1).transpose(1, 2)  # noqa: E731
        out = attention(split(self.q_proj(x)), split(self.k_proj(x)),
                        split(self.v_proj(x)), (d // self.heads) ** -0.5)
        return self.out_proj(out.transpose(1, 2).reshape(b, n, d))


class MLP(nn.Module):
    def __init__(self, d: int, inner: int):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(d, inner), nn.Linear(inner, d)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.self_attn = SelfAttention(d, cfg.num_attention_heads)
        self.layer_norm1 = nn.LayerNorm(d, eps)
        self.mlp = MLP(d, cfg.intermediate_size)
        self.layer_norm2 = nn.LayerNorm(d, eps)

    def forward(self, x):
        x = self.self_attn(self.layer_norm1(x)) + x
        return self.mlp(self.layer_norm2(x)) + x


class Embeddings(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.patch_embedding = nn.Conv2d(3, d, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(
            (cfg.image_size // cfg.patch_size) ** 2 + 1, d)

    def forward(self, pixels):
        p = self.patch_embedding(pixels).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(p.shape[0], 1, -1)
        return torch.cat([cls, p], dim=1) + self.position_embedding.weight


class Encoder(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.layers = nn.ModuleList([EncoderLayer(cfg)
                                     for _ in range(cfg.num_hidden_layers)])


class VisionTransformer(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.embeddings = Embeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.encoder = Encoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)


class CLIPVisionModelWithProjection(nn.Module):
    def __init__(self, cfg: VisionConfig = VisionConfig()):
        super().__init__()
        self.cfg = cfg
        self.vision_model = VisionTransformer(cfg)
        self.visual_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim,
                                           bias=False)

    def forward(self, pixels):
        """(b, 3, S, S) CLIP-normalised -> image_embeds (b, projection)."""
        vm = self.vision_model
        x = vm.pre_layrnorm(vm.embeddings(pixels))
        for layer in vm.encoder.layers:
            x = layer(x)
        return self.visual_projection(vm.post_layernorm(x[:, 0]))


def preprocess(image, size: int):
    """(b, 3, h, w) in [-1, 1] -> (b, 3, size, size) CLIP-normalised."""
    x = F.interpolate(image, size=(size, size), mode="bicubic",
                      align_corners=False, antialias=True)
    x = (x + 1.0) / 2.0
    mean = torch.tensor(CLIP_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(CLIP_STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std
