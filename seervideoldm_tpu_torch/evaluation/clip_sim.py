"""CLIP similarity (CLIPSIM), the text-faithfulness metric of the eval
entry (port of ``seervideoldm_tpu/evaluation/clip_sim.py``): the mean
cosine similarity between each generated frame's CLIP image embedding and
the prompt's CLIP text embedding (GODIVA / NUWA protocol).

- ``CLIPVisionModel`` (``models/clip_vision.py``, quick-GELU by
  default): the image tower, returning the pooled class token
  ``(b, hidden)``;
- ``CLIPProjections``: the two no-bias projection heads of HF
  ``CLIPModel``;
- ``preprocess_frames``: the OpenAI CLIP transform on square frames,
  bicubic resize (``antialias=True``: PyTorch's antialiased bicubic is
  the Keys a = -0.5 kernel that ``jax.image.resize(..., "cubic")`` uses,
  antialiasing on downscale as JAX does by default) and the CLIP mean /
  std.

Weights come from a local HF ``CLIPModel`` state dict through
``io/pretrained.py`` (``convert_clip_vision``, ``convert_clip_text``,
``convert_clip_projections``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.clip_vision import CLIPVisionConfig, CLIPVisionModel  # noqa: F401

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


class CLIPProjections(nn.Module):
    def __init__(self, vision_hidden: int = 1024, text_hidden: int = 768,
                 projection_dim: int = 768):
        super().__init__()
        self.visual_projection = nn.Linear(vision_hidden, projection_dim,
                                           bias=False)
        self.text_projection = nn.Linear(text_hidden, projection_dim,
                                         bias=False)

    def forward(self, pooled_image, pooled_text):
        return (self.visual_projection(pooled_image),
                self.text_projection(pooled_text))


def pool_text_eos(hidden: torch.Tensor, input_ids: torch.Tensor
                  ) -> torch.Tensor:
    """HF CLIP text pooling: the hidden state at the first EOS, found by
    ``argmax`` because ``<|endoftext|>`` (49407) is the highest id."""
    eos = input_ids.argmax(dim=-1)
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), eos]


def preprocess_frames(frames: torch.Tensor, image_size: int) -> torch.Tensor:
    """(n, h, w, 3) in [0, 1] -> CLIP-normalized (n, 3, S, S).  Frames are
    square (the pipeline's crop), so the resize is the centre crop."""
    x = F.interpolate(frames.permute(0, 3, 1, 2).float(),
                      size=(image_size, image_size), mode="bicubic",
                      align_corners=False, antialias=True)
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(CLIP_IMAGE_STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


def clip_similarity(image_features: torch.Tensor,
                    text_features: torch.Tensor) -> torch.Tensor:
    """Cosine similarity per row: (n, d) x (n, d) -> (n,)."""
    a = image_features / image_features.norm(dim=-1, keepdim=True)
    b = text_features / text_features.norm(dim=-1, keepdim=True)
    return (a * b).sum(dim=-1)


def make_clip_sim_fn(vision: CLIPVisionModel, text: nn.Module,
                     projections: CLIPProjections):
    """(videos, input_ids, attention_mask) -> per-clip CLIPSIM, numpy (b,).
    videos (b, f, h, w, 3) in [0, 1]; a clip's score is its frames' mean
    cosine similarity to the prompt."""
    image_size = vision.config.image_size
    device = next(vision.parameters()).device

    @torch.no_grad()
    def score(videos, input_ids, attention_mask) -> np.ndarray:
        videos = torch.as_tensor(videos, device=device)
        b, f = videos.shape[:2]
        frames = preprocess_frames(videos.reshape(b * f, *videos.shape[2:]),
                                   image_size)
        ids = torch.as_tensor(input_ids, device=device).long()
        mask = torch.as_tensor(attention_mask, device=device)
        pooled_img = vision(frames)
        pooled_txt = pool_text_eos(text(ids, mask), ids)
        img, txt = projections(pooled_img, pooled_txt)
        sims = clip_similarity(img, txt.repeat_interleave(f, dim=0))
        return sims.reshape(b, f).mean(dim=1).cpu().numpy()

    return score
