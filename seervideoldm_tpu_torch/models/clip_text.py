"""CLIP ViT-L/14 text encoder (port of
``seervideoldm_tpu/models/clip_text.py``): last hidden state ``(b, 77, 768)``
under a causal mask and the tokenizer's padding mask; quick_gelu, pre-LN,
learned positions.  ``hidden_act`` (an argument of ``CLIPMLP``,
``CLIPEncoderLayer`` and ``CLIPEncoder``) picks the MLP's activation
(``quick_gelu``, CLIP ViT-L/14's, or ``gelu``, the exact erf form of
OpenCLIP's ViT-H/14, which ``models/clip_vision.py`` builds from these
layers).  Module names follow the HF ``CLIPTextModel`` state dict
(``text_model.encoder.layers.N.self_attn.q_proj`` ...).  Under a
``model`` axis (``parallel.sharding.shard_tensor_parallel``) the attention
holds its slice of the heads (``q/k/v_proj`` column, ``out_proj``
row-parallel) and the MLP its slice of the hidden units (``fc1`` column,
``fc2`` row-parallel).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn

from ..ops.norms import LayerNorm
from ..parallel.collectives import copy_to_model, row_parallel_linear

NEG_INF = torch.finfo(torch.float32).min


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def exact_gelu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x, approximate="none")


ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu": exact_gelu}


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.heads = cfg.num_attention_heads
        d = cfg.hidden_size
        self.head_dim = d // self.heads
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.tp_group = None  # the model group once split (parallel/sharding)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        d, group = self.head_dim, self.tp_group
        x = copy_to_model(x, group)
        split = lambda t: t.reshape(b, n, self.heads, d).transpose(1, 2)  # noqa: E731
        q = split(self.q_proj(x)) * (d ** -0.5)
        k, v = split(self.k_proj(x)), split(self.v_proj(x))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        logits = logits.masked_fill(~mask, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, n, -1)
        if group is None:
            return self.out_proj(out)
        return row_parallel_linear(out, self.out_proj.weight,
                                   self.out_proj.bias, group)


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, hidden_act: str = "quick_gelu"):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.act = ACTIVATIONS[hidden_act]
        self.tp_group = None  # the model group once split (parallel/sharding)

    def forward(self, x):
        if self.tp_group is None:
            return self.fc2(self.act(self.fc1(x)))
        hidden = self.act(self.fc1(copy_to_model(x, self.tp_group)))
        return row_parallel_linear(hidden, self.fc2.weight, self.fc2.bias,
                                   self.tp_group)


class CLIPEncoderLayer(nn.Module):
    # an FSDP unit: gathers its weights whole per call (parallel/sharding.py)
    fsdp_unit = True

    def __init__(self, cfg: CLIPTextConfig, hidden_act: str = "quick_gelu"):
        super().__init__()
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg, hidden_act)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x, mask):
        x = self.self_attn(self.layer_norm1(x), mask) + x
        return self.mlp(self.layer_norm2(x)) + x


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, hidden_act: str = "quick_gelu"):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg, hidden_act)
                                     for _ in range(cfg.num_hidden_layers)])


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)


class CLIPTextModel(nn.Module):
    # an FSDP unit: gathers its weights whole per call (parallel/sharding.py)
    fsdp_unit = True

    def __init__(self, config: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """input_ids (b, n) -> last hidden state (b, n, hidden)."""
        tm = self.text_model
        n = input_ids.shape[1]
        x = (tm.embeddings.token_embedding(input_ids.long())
             + tm.embeddings.position_embedding.weight[None, :n])
        mask = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()[None, None]
        if attention_mask is not None:
            mask = mask & attention_mask[:, None, None, :].bool()
        for layer in tm.encoder.layers:
            x = layer(x, mask)
        return tm.final_layer_norm(x)
