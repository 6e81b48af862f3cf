"""The CLIP ViT image tower: HF ``CLIPVisionTransformer`` semantics under
HF's names (``vision_model.embeddings.patch_embedding``, the upstream
``pre_layrnorm`` spelling, ``encoder.layers.N`` of the port's
``CLIPEncoderLayer`` with a full, non-causal mask, ``post_layernorm``).

- ``CLIPVisionModel`` returns the pooled class token ``(b, hidden)``
  (CLIPSIM's tower, ``evaluation/clip_sim.py``, quick-GELU);
- with ``projection_dim`` set it also holds HF
  ``CLIPVisionModelWithProjection``'s no-bias ``visual_projection`` and
  returns ``image_embeds`` ``(b, projection_dim)``: Stable Video
  Diffusion's image encoder (OpenCLIP ViT-H/14, ``hidden_act: gelu``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn

from ..ops.norms import LayerNorm
from .clip_text import CLIPEncoder, CLIPTextConfig


@dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"


# SVD-XT's ``image_encoder/config.json`` (CLIPVisionModelWithProjection)
VIT_H14_CONFIG = CLIPVisionConfig(hidden_size=1280, intermediate_size=5120,
                                  num_hidden_layers=32,
                                  num_attention_heads=16, projection_dim=1024,
                                  hidden_act="gelu")


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.class_embedding = nn.Parameter(torch.randn(d) * 0.02)
        self.patch_embedding = nn.Conv2d(3, d, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        n = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.position_embedding = nn.Embedding(n, d)
        nn.init.normal_(self.position_embedding.weight, std=0.02)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        patches = self.patch_embedding(pixels).flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(patches.dtype).expand(
            patches.shape[0], 1, -1)
        return (torch.cat([cls, patches], dim=1)
                + self.position_embedding.weight[None])


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        layer_cfg = CLIPTextConfig(
            hidden_size=cfg.hidden_size,
            intermediate_size=cfg.intermediate_size,
            num_hidden_layers=cfg.num_hidden_layers,
            num_attention_heads=cfg.num_attention_heads,
            layer_norm_eps=cfg.layer_norm_eps)
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.encoder = CLIPEncoder(layer_cfg, cfg.hidden_act)
        self.post_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)


class CLIPVisionModel(nn.Module):
    def __init__(self, config: CLIPVisionConfig = CLIPVisionConfig(),
                 with_projection: bool = False):
        super().__init__()
        self.config = config
        self.vision_model = CLIPVisionTransformer(config)
        self.visual_projection: Optional[nn.Linear] = (
            nn.Linear(config.hidden_size, config.projection_dim, bias=False)
            if with_projection else None)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels (b, 3, S, S), CLIP-normalized -> pooled (b, hidden), or
        the projected ``image_embeds`` (b, projection_dim) when the model
        holds ``visual_projection``."""
        vm = self.vision_model
        x = vm.pre_layrnorm(vm.embeddings(pixels))
        n = x.shape[1]
        mask = torch.ones(1, 1, n, n, dtype=torch.bool, device=x.device)
        for layer in vm.encoder.layers:
            x = layer(x, mask)
        pooled = vm.post_layernorm(x[:, 0])
        if self.visual_projection is None:
            return pooled
        return self.visual_projection(pooled)
