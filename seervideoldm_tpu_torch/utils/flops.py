"""Analytic matmul/conv FLOP counts for the Seer model family (the port's
own copy of ``seervideoldm_tpu/utils/flops.py``, reading the port's configs:
``SEER_UNET_SD15_CONFIG``, ``SD15_VAE_CONFIG``).

MFU convention: numerator = 2·M·N·K over the *algorithmic* matmuls and
convolutions (the standard "model FLOPs" of the scaling literature) — no
elementwise/softmax/norm work, no rematerialization double-counting, no
padding waste.  It is the numerator of the port's model-FLOP utilization.

Counts follow the architecture exactly (``models/unet3d.py``,
``models/unet_blocks.py``, ``models/vae.py``; reference
``seer/models/unet_3d_condition.py:283-376``).
"""
from __future__ import annotations

from dataclasses import dataclass


def _conv2d(n_img: int, h: int, w: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * n_img * h * w * cin * cout * k * k


def _linear(tokens: float, din: int, dout: int) -> float:
    return 2.0 * tokens * din * dout


def _attention(bh: float, n: float, m: float, d: int) -> float:
    """Scores + p@v for one folded batch of heads (no projections)."""
    return 2.0 * bh * n * m * d * 2


@dataclass
class UNetShape:
    b: int  # UNet batch (CFG-doubled by the caller if applicable)
    f: int  # frames (incl. re-concatenated cond frames)
    h: int  # latent height at input
    w: int
    ctx_tokens: int = 77
    ctx_dim: int = 768


def seer_unet_flops(shape: UNetShape, config=None) -> float:
    """One SeerUNet forward (matmul/conv only)."""
    if config is None:
        from ..models.unet3d import SEER_UNET_SD15_CONFIG

        config = SEER_UNET_SD15_CONFIG
    boc = tuple(config.block_out_channels)
    L = config.layers_per_block
    head_dim_cfg = config.attention_head_dim
    b, f = shape.b, shape.f
    bf = b * f
    total = 0.0

    def resnet(h, w, cin, cout, temb=boc[0] * 4):
        fl = _conv2d(bf, h, w, cin, cout, 3) + _conv2d(bf, h, w, cout, cout, 3)
        fl += _linear(b, temb, cout)  # time-emb projection
        if cin != cout:
            fl += _conv2d(bf, h, w, cin, cout, 1)
        return fl

    def attn_block(h, w, c):
        """SpatialTransformer3D pair: text (self+cross) + temporal (SWAT)."""
        s = h * w
        heads = head_dim_cfg  # config value is the HEAD COUNT (SD-1.5 usage)
        d = c // heads
        fl = 0.0
        for _ in range(2):  # two SpatialTransformer3D per triplet
            fl += _conv2d(bf, h, w, c, c, 1) * 2  # proj_in + proj_out
        # text transformer block: per-frame self-attn + per-frame cross-attn + FF
        fl += _linear(bf * s, c, c) * 4  # self qkv + out
        fl += _attention(bf * heads, s, s, d)
        fl += _linear(bf * s, c, c) * 2  # cross q + out
        fl += _linear(bf * shape.ctx_tokens, shape.ctx_dim, c) * 2  # cross k,v
        fl += _attention(bf * heads, s, shape.ctx_tokens, d)
        fl += _linear(bf * s, c, 4 * c) * 2 + _linear(bf * s, 4 * c, c)  # GEGLU FF
        # temporal block: SWAT windowed attention + FF.  Window selection per
        # the reference (attention.py:31-34,661-668): full-frame if h <= 4,
        # ws=8 when h//8 >= 4, else ws=4.  Tokens per window = f*ws^2 over
        # s/ws^2 windows -> pair count f^2 * ws^2 * s per (b, head).
        fl += _linear(bf * s, c, c) * 4  # qkv + out (full sequence)
        if h <= 4:
            fl += _attention(b * heads, f * s, f * s, d)
        else:
            ws = 8 if h // 8 >= 4 else 4
            fl += _attention(b * heads * s // (ws * ws), f * ws * ws,
                             f * ws * ws, d)
        fl += _linear(bf * s, c, 4 * c) * 2 + _linear(bf * s, 4 * c, c)
        return fl

    h, w = shape.h, shape.w
    # conv_in
    total += _conv2d(bf, h, w, config.in_channels, boc[0], 3)
    # time MLP
    total += _linear(b, boc[0], boc[0] * 4) + _linear(b, boc[0] * 4, boc[0] * 4)

    skips = []  # (h, w, channels) of each stored skip
    skips.append((h, w, boc[0]))
    cin = boc[0]
    n = len(boc)
    for i, cout in enumerate(boc):
        for layer in range(L):
            total += resnet(h, w, cin if layer == 0 else cout, cout)
            if i < n - 1:
                total += attn_block(h, w, cout)
            skips.append((h, w, cout))
        cin = cout
        if i < n - 1:
            total += _conv2d(bf, h // 2, w // 2, cout, cout, 3)  # downsample
            skips.append((h // 2, w // 2, cout))
            h, w = h // 2, w // 2

    # mid: resnet + attn pair + resnet
    total += resnet(h, w, boc[-1], boc[-1]) * 2
    total += attn_block(h, w, boc[-1])

    # up path
    rev = list(reversed(boc))
    prev = rev[0]
    for i, cout in enumerate(rev):
        for _ in range(L + 1):
            sh, sw, sc = skips.pop()
            total += resnet(h, w, prev + sc, cout)
            if i > 0:
                total += attn_block(h, w, cout)
            prev = cout
        if i < n - 1:
            h, w = h * 2, w * 2
            total += _conv2d(bf, h, w, cout, cout, 3)  # upsample conv

    # out conv
    total += _conv2d(bf, h, w, boc[0], config.out_channels, 3)
    return total


def vae_flops(n_img: int, h: int, w: int, decode: bool, config=None) -> float:
    """AutoencoderKL encode (h, w = pixel dims) or decode (latent dims in)."""
    if config is None:
        from ..models.vae import SD15_VAE_CONFIG

        config = SD15_VAE_CONFIG
    ch = tuple(config.block_out_channels)  # (128, 256, 512, 512)
    lat = config.latent_channels
    total = 0.0

    def resnet(hh, ww, cin, cout):
        fl = _conv2d(n_img, hh, ww, cin, cout, 3) + _conv2d(n_img, hh, ww, cout, cout, 3)
        if cin != cout:
            fl += _conv2d(n_img, hh, ww, cin, cout, 1)
        return fl

    def mid(hh, ww, c):
        fl = resnet(hh, ww, c, c) * 2
        fl += _linear(n_img * hh * ww, c, c) * 4  # attention qkv + proj
        fl += _attention(n_img, hh * ww, hh * ww, c)
        return fl

    if not decode:
        hh, ww = h, w
        total += _conv2d(n_img, hh, ww, 3, ch[0], 3)
        cin = ch[0]
        for i, cout in enumerate(ch):
            for j in range(2):
                total += resnet(hh, ww, cin if j == 0 else cout, cout)
            cin = cout
            if i < len(ch) - 1:
                hh, ww = hh // 2, ww // 2
                total += _conv2d(n_img, hh, ww, cout, cout, 3)
        total += mid(hh, ww, ch[-1])
        total += _conv2d(n_img, hh, ww, ch[-1], 2 * lat, 3)
        total += _conv2d(n_img, hh, ww, 2 * lat, 2 * lat, 1)  # quant_conv
    else:
        hh, ww = h, w  # latent dims
        total += _conv2d(n_img, hh, ww, lat, lat, 1)  # post_quant
        total += _conv2d(n_img, hh, ww, lat, ch[-1], 3)
        total += mid(hh, ww, ch[-1])
        prev = ch[-1]
        for i, cout in enumerate(reversed(ch)):
            for _ in range(3):
                total += resnet(hh, ww, prev, cout)
                prev = cout
            if i < len(ch) - 1:
                hh, ww = hh * 2, ww * 2
                total += _conv2d(n_img, hh, ww, cout, cout, 3)
        total += _conv2d(n_img, hh, ww, ch[0], 3, 3)
    return total


def fstext_flops(b: int, f: int, tokens: int = 77, dim: int = 768,
                 num_layers: int = 8) -> float:
    """FSTextTransformer forward: 8 outer layers x (spatial + temporal)."""
    total = 0.0
    n_tok = b * f * tokens
    for _ in range(num_layers):
        # inner 0: per-frame self-attn + cross-attn to CLIP + FF
        total += _linear(n_tok, dim, dim) * 4
        total += _attention(b * f * 8, tokens, tokens, dim // 8)
        total += _linear(n_tok, dim, dim) * 2
        total += _linear(b * tokens, dim, dim) * 2  # k, v from 77 CLIP tokens
        total += _attention(b * 8, f * tokens, tokens, dim // 8)
        total += _linear(n_tok, dim, 4 * dim) * 2 + _linear(n_tok, 4 * dim, dim)
        # inner 1: temporal self-attn + FF
        total += _linear(n_tok, dim, dim) * 4
        total += _attention(b * tokens * 8, f, f, dim // 8)
        total += _linear(n_tok, dim, 4 * dim) * 2 + _linear(n_tok, 4 * dim, dim)
    return total


def sampling_clip_flops(
    b: int, f: int, cond_frames: int, resolution: int, ddim_steps: int,
    cfg: bool = True, include_vae: bool = False,
) -> dict:
    """FLOPs of one sampled clip: DDIM loop (+ optional VAE encode/decode)."""
    latent = resolution // 8
    b_eff = (2 if cfg else 1) * b
    unet = seer_unet_flops(UNetShape(b=b_eff, f=f, h=latent, w=latent))
    out = {
        "unet_per_call": unet,
        "ddim_total": unet * ddim_steps + fstext_flops(b, f),
    }
    if include_vae:
        out["vae_encode"] = vae_flops(b * cond_frames, resolution, resolution,
                                      decode=False)
        out["vae_decode"] = vae_flops(b * (f - cond_frames), latent, latent,
                                      decode=True)
        out["e2e_total"] = out["ddim_total"] + out["vae_encode"] + out["vae_decode"]
    return out
