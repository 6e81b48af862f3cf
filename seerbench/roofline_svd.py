"""The frozen work counts of Stable Video Diffusion XT (the ``svd-xt``
configuration), beside ``roofline.py``'s of Seer and with its
conventions: algorithmic matmul and convolution FLOPs (2 M N K) of the
published architecture, no elementwise, norm or softmax work, worked out
from the cell's shapes, never from what the program reports.

- ``unet_flops``: one UNet call on ``b`` rows (CFG-doubled clips) of
  ``f`` frames at ``h`` x ``w`` latents: per SpatioTemporalResBlock the
  two 3 x 3 convs (+ 1 x 1 shortcut) and the two (3, 1, 1) convs; per
  transformer site ``proj_in`` / ``proj_out``, the spatial block (self-
  and cross-attention with their projections, the GEGLU FF), the frame
  MLP, the temporal block (``ff_in``, full self-attention over the
  frames, cross-attention to one token, FF); the resamplers, ``conv_in``,
  ``conv_out`` and the time embeddings;
- ``image_encoder_flops``: the ViT-H/14 on one 224 px image;
- ``decoder_flops``: the temporal decoder on ``f`` frames (SD's decoder
  without ``post_quant_conv``, plus the temporal convs and
  ``time_conv_out``); the encoder is ``roofline.vae_flops``;
- ``clip_flops``: one clip sampled: ``steps`` UNet calls at CFG batch 2,
  the image encoder, the encode of the augmented image, the decode;
- ``spatial_attention_bound``: the roofline bound of one spatial
  self-attention site from the shape its span carries
  (``roofline.cross_attention_site``).
"""
from __future__ import annotations

from .roofline import (Widths, _attention, _conv2d, _linear,
                       cross_attention_site, vae_flops)


def _conv3d_t(n_vid, f, h, w, cin, cout, k=3) -> float:
    return 2.0 * n_vid * f * h * w * cin * cout * k


def unet_flops(config: dict, b: int, f: int, h: int, w: int) -> float:
    u = config["unet"]
    boc, heads = u["block_out_channels"], u["num_attention_heads"]
    ctx, L, temb = u["cross_attention_dim"], u["layers_per_block"], boc[0] * 4
    bf = b * f
    total = _conv2d(bf, h, w, u["in_channels"], boc[0], 3)
    total += _linear(b, boc[0], temb) + _linear(b, temb, temb)
    total += (_linear(b, u["projection_class_embeddings_input_dim"], temb)
              + _linear(b, temb, temb))

    def resnet(hh, ww, cin, cout):
        fl = _conv2d(bf, hh, ww, cin, cout, 3) + _conv2d(bf, hh, ww, cout, cout, 3)
        if cin != cout:
            fl += _conv2d(bf, hh, ww, cin, cout, 1)
        fl += 2 * _conv3d_t(b, f, hh, ww, cout, cout) + 2 * _linear(b, temb, cout)
        return fl

    def ff(tokens, c):
        return _linear(tokens, c, 8 * c) + _linear(tokens, 4 * c, c)

    def site(hh, ww, c, nh):
        s, d = hh * ww, c // nh
        t = bf * s
        fl = 2 * _linear(t, c, c)                                   # proj_in/out
        fl += 4 * _linear(t, c, c) + _attention(bf * nh, s, s, d)   # spatial self
        fl += 2 * _linear(t, c, c) + 2 * _linear(bf, ctx, c)        # spatial cross
        fl += _attention(bf * nh, s, 1, d) + ff(t, c)
        fl += _linear(f, c, 4 * c) + _linear(f, 4 * c, c)           # frame MLP
        fl += ff(t, c)                                              # ff_in
        fl += 4 * _linear(t, c, c) + _attention(b * s * nh, f, f, d)
        fl += 2 * _linear(t, c, c) + 2 * _linear(b * s, ctx, c)
        fl += _attention(b * s * nh, f, 1, d) + ff(t, c)
        return fl

    hh, ww, ch = h, w, boc[0]
    skips = [ch]
    for i, cout in enumerate(boc):
        for j in range(L):
            total += resnet(hh, ww, ch, cout)
            ch = cout
            if i < len(boc) - 1:
                total += site(hh, ww, cout, heads[i])
            skips.append(ch)
        if i < len(boc) - 1:
            hh, ww = hh // 2, ww // 2
            total += _conv2d(bf, hh, ww, ch, ch, 3)
            skips.append(ch)
    total += 2 * resnet(hh, ww, ch, ch) + site(hh, ww, ch, heads[-1])
    rev, rheads = boc[::-1], heads[::-1]
    for i, cout in enumerate(rev):
        for j in range(L + 1):
            total += resnet(hh, ww, ch + skips.pop(), cout)
            ch = cout
            if i > 0:
                total += site(hh, ww, cout, rheads[i])
        if i < len(rev) - 1:
            hh, ww = hh * 2, ww * 2
            total += _conv2d(bf, hh, ww, ch, ch, 3)
    return total + _conv2d(bf, hh, ww, boc[0], u["out_channels"], 3)


def image_encoder_flops(config: dict, n: int = 1) -> float:
    i = config["image_encoder"]
    d, tokens = i["hidden_size"], (i["image_size"] // i["patch_size"]) ** 2 + 1
    per_layer = (4 * _linear(n * tokens, d, d)
                 + _attention(n * i["num_attention_heads"], tokens, tokens,
                              d // i["num_attention_heads"])
                 + 2 * _linear(n * tokens, d, i["intermediate_size"]))
    patches = (i["image_size"] // i["patch_size"]) ** 2
    return (i["num_hidden_layers"] * per_layer
            + 2.0 * n * patches * 3 * d * i["patch_size"] ** 2
            + _linear(n, d, i["projection_dim"]))


def decoder_flops(config: dict, f: int, h: int, w: int) -> float:
    """The temporal decoder on one clip of ``f`` frames at ``h`` x ``w``
    latents."""
    v = config["vae"]
    ch = v["block_out_channels"]
    lat = v["latent_channels"]

    def resnet(hh, ww, cin, cout):
        fl = _conv2d(f, hh, ww, cin, cout, 3) + _conv2d(f, hh, ww, cout, cout, 3)
        if cin != cout:
            fl += _conv2d(f, hh, ww, cin, cout, 1)
        return fl + 2 * _conv3d_t(1, f, hh, ww, cout, cout)

    hh, ww = h, w
    total = _conv2d(f, hh, ww, lat, ch[-1], 3)
    total += (2 * resnet(hh, ww, ch[-1], ch[-1])
              + 4 * _linear(f * hh * ww, ch[-1], ch[-1])
              + _attention(f, hh * ww, hh * ww, ch[-1]))
    prev = ch[-1]
    for i, cout in enumerate(reversed(ch)):
        for _ in range(v["layers_per_block"] + 1):
            total += resnet(hh, ww, prev, cout)
            prev = cout
        if i < len(ch) - 1:
            hh, ww = hh * 2, ww * 2
            total += _conv2d(f, hh, ww, cout, cout, 3)
    total += _conv2d(f, hh, ww, ch[0], v["out_channels"], 3)
    return total + _conv3d_t(1, f, hh, ww, v["out_channels"], v["out_channels"])


def clip_flops(config: dict) -> float:
    """Model FLOPs of one sampled clip at the configuration's settings."""
    s = config["sampling"]
    scale = 2 ** (len(config["vae"]["block_out_channels"]) - 1)
    h, w, f = s["height"] // scale, s["width"] // scale, s["num_frames"]
    wd = Widths(vae_block_out_channels=tuple(config["vae"]["block_out_channels"]))
    return (s["steps"] * unet_flops(config, 2, f, h, w)
            + image_encoder_flops(config)
            + vae_flops(1, s["height"], s["width"], False, wd)
            + decoder_flops(config, f, h, w))


def spatial_attention_bound(ids: dict) -> float:
    """Seconds: the bound of one spatial self-attention site from its
    span's ids (rows, n, m, c, cc, heads, d)."""
    return cross_attention_site(ids["rows"], ids["n"], ids["m"], ids["c"],
                                ids["cc"], ids["heads"], ids["d"],
                                self_attn=True)
