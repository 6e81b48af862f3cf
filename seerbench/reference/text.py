"""Plain fp32 text side: the CLIP ViT-L/14 text encoder, FSText (the
frame-sequential text decomposer) and the hash tokenizer the service
uses when no CLIP vocabulary is on disk.  Frozen copies of the port's
``models/clip_text.py``, ``models/fstext.py`` and
``utils/tokenizer.py::DebugTokenizer``; parameter names are the port's."""
from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn

from .layers import NEG_INF, CrossAttention, FeedForward, LayerNorm

MAX_LENGTH = 1024


class DebugTokenizer:
    """crc32 of each lower-cased word modulo vocab - 2, between BOS and EOS,
    padded with EOS to 77; the mask covers BOS..EOS."""

    def __init__(self, vocab_size: int = 49408, max_length: int = 77):
        self.vocab_size, self.max_length = vocab_size, max_length
        self.bos_id, self.eos_id = vocab_size - 2, vocab_size - 1

    def __call__(self, texts):
        if isinstance(texts, str):
            texts = [texts]
        n = self.max_length
        ids = np.full((len(texts), n), self.eos_id, np.int64)
        mask = np.zeros((len(texts), n), np.int64)
        for i, t in enumerate(texts):
            words = [int(zlib.crc32(w.encode()) % (self.vocab_size - 2))
                     for w in t.lower().split()][: n - 2]
            row = [self.bos_id] + words + [self.eos_id]
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return {"input_ids": ids, "attention_mask": mask}


# ------------------------------------------------------------------- CLIP

@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.heads = cfg.num_attention_heads
        d = cfg.hidden_size
        self.head_dim = d // self.heads
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)

    def forward(self, x, mask):
        b, n, _ = x.shape
        d = self.head_dim
        split = lambda t: t.reshape(b, n, self.heads, d).transpose(1, 2)  # noqa: E731
        q = split(self.q_proj(x)) * (d ** -0.5)
        k, v = split(self.k_proj(x)), split(self.v_proj(x))
        logits = torch.matmul(q, k.transpose(-1, -2)).masked_fill(~mask, NEG_INF)
        out = torch.matmul(torch.softmax(logits, dim=-1), v)
        return self.out_proj(out.transpose(1, 2).reshape(b, n, -1))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h))  # quick GELU


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)
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
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg)
                                     for _ in range(cfg.num_hidden_layers)])


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)


class CLIPTextModel(nn.Module):
    def __init__(self, config: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config)

    def forward(self, input_ids, attention_mask):
        """(b, n) ids -> last hidden state (b, n, hidden): causal mask and
        the padding mask on the keys."""
        tm = self.text_model
        n = input_ids.shape[1]
        x = (tm.embeddings.token_embedding(input_ids.long())
             + tm.embeddings.position_embedding.weight[None, :n])
        mask = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()[None, None]
        mask = mask & attention_mask[:, None, None, :].bool()
        for layer in tm.encoder.layers:
            x = layer(x, mask)
        return tm.final_layer_norm(x)


# ----------------------------------------------------------------- FSText

class BasicLinearTransformerBlock3D(nn.Module):
    def __init__(self, dim, n_heads, d_head, context_dim=None, temporal=False):
        super().__init__()
        self.temporal = temporal
        self.attn1 = CrossAttention(dim, heads=n_heads, dim_head=d_head,
                                    temporal=temporal, causal=temporal)
        self.norm1 = LayerNorm(dim)
        if not temporal:
            self.attn2 = CrossAttention(dim, context_dim, heads=n_heads,
                                        dim_head=d_head)
            self.norm2 = LayerNorm(dim)
        self.ff = FeedForward(dim)
        self.norm3 = LayerNorm(dim)

    def forward(self, x, context=None):
        b, f, l, c = x.shape
        if self.temporal:
            # frames are the sequence, per token position
            x = x.transpose(1, 2).reshape(b * l, f, c)
            x = self.attn1(self.norm1(x)) + x
            x = self.ff(self.norm3(x)) + x
            return x.reshape(b, l, f, c).transpose(1, 2)
        x = x.reshape(b * f, l, c)
        x = self.attn1(self.norm1(x)) + x
        if context is not None:
            x = x.reshape(b, f * l, c)
            x = self.attn2(self.norm2(x), context=context) + x
        x = self.ff(self.norm3(x)) + x
        return x.reshape(b, f, l, c)


class LinearTransformer3D(nn.Module):
    def __init__(self, in_channels, n_heads, d_head, context_dim=None):
        super().__init__()
        self.transformer_blocks = nn.ModuleList([
            BasicLinearTransformerBlock3D(in_channels, n_heads, d_head,
                                          context_dim, temporal=False),
            BasicLinearTransformerBlock3D(in_channels, n_heads, d_head,
                                          temporal=True)])

    def forward(self, x, context=None):
        x = self.transformer_blocks[0](x, context)
        return self.transformer_blocks[1](x)


class FSTextTransformer(nn.Module):
    """One CLIP embedding (b, l, 768) -> per-frame sub-instructions
    (b, num_frames, l, 768).  Reference parity: the 16-frame position
    table is resized to ``num_frames`` by nearest neighbour (index
    floor(i * 16 / num_frames)) when the two differ."""

    def __init__(self, num_frames=16, pos_embed_frames=16, in_channels=768,
                 out_channels=768, n_heads=8, num_layers=8,
                 cross_attention_dim=768):
        super().__init__()
        self.num_frames, self.pos_embed_frames = num_frames, pos_embed_frames
        d_head = out_channels // n_heads
        self.learnable_query = nn.Parameter(torch.zeros(1, 1, 1, out_channels))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, pos_embed_frames, MAX_LENGTH, out_channels))
        self.trf_blocks = nn.ModuleList([
            LinearTransformer3D(in_channels, n_heads, d_head,
                                cross_attention_dim)
            for _ in range(num_layers)])
        self.norm = LayerNorm(out_channels)

    def forward(self, context):
        b, l, _ = context.shape
        pe = self.pos_embed[:, :, :l]
        if self.pos_embed_frames != self.num_frames:
            f0 = pe.shape[1]
            idx = torch.floor(torch.arange(self.num_frames, dtype=torch.float64)
                              * (f0 / self.num_frames)).long().to(pe.device)
            pe = pe.index_select(1, idx)
        x = self.learnable_query.expand(b, self.num_frames, l, -1) + pe
        for block in self.trf_blocks:
            x = block(x, context)
        return self.norm(x)
