"""The benchmark's frozen work counts: model FLOPs for the MFU numerators
and per-site operation, byte and exponential counts for the roofline
shares, all worked out from the shapes of the cell and the schedule its
configuration fixes, never from what the program reports, so a share
reads the same work whatever implements it.

The model-FLOP functions (``seer_unet_flops``, ``vae_flops``,
``fstext_flops``) are a frozen copy of the port's ``utils/flops.py``: the
algorithmic matmul and convolution FLOPs (2 M N K), no elementwise, norm
or softmax work, the attention cores counted whole (a causal window's
masked half included, as the reference computes it).  ``unet_layers`` and
``fstext_layers`` split the same totals by layer, into weight matmuls and
activation matmuls (the attention cores), which the training count needs:
a training step counts every matmul and conv once forward, once more for
the input gradient of each layer the loss flows back through (an
attention core's two inputs both take one, so its backward is twice its
forward), and once more for the weight gradients of the trainable
parameters only (the UNet's temporal sites and FSText).

Peaks: NVIDIA's H100 SXM data sheet, dense: 989 TFLOP/s bf16, 3.35 TB/s
HBM3; the special-function units' exp2 rate is 16 results per clock per
SM (CUDA programming guide, compute capability 9.0) x 132 SMs x the
1.98 GHz boost clock.  A site's bound is the largest of its FLOPs over the
bf16 peak, its bytes (each input read once, each output written once, in
bf16) over the HBM rate, and its softmax exponentials over the exp2 rate:
no implementation can beat any of the three.
"""
from __future__ import annotations

from dataclasses import dataclass

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
PEAK_EXP2 = 16 * 132 * 1.98e9
BF16 = 2


# ------------------------------------------- frozen copy of utils/flops.py

def _conv2d(n_img, h, w, cin, cout, k) -> float:
    return 2.0 * n_img * h * w * cin * cout * k * k


def _linear(tokens, din, dout) -> float:
    return 2.0 * tokens * din * dout


def _attention(bh, n, m, d) -> float:
    """Scores + p@v for one folded batch of heads (no projections)."""
    return 2.0 * bh * n * m * d * 2


@dataclass
class UNetShape:
    b: int  # UNet batch (CFG-doubled by the caller)
    f: int  # frames, the re-concatenated cond frames included
    h: int  # latent height
    w: int
    ctx_tokens: int = 77
    ctx_dim: int = 768


@dataclass(frozen=True)
class Widths:
    block_out_channels: tuple = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    heads: int = 8
    in_channels: int = 4
    out_channels: int = 4
    vae_block_out_channels: tuple = (128, 256, 512, 512)
    latent_channels: int = 4
    fstext_layers: int = 8
    fstext_heads: int = 8


def widths_of(config: dict) -> Widths:
    return Widths(block_out_channels=tuple(config["block_out_channels"]),
                  layers_per_block=config["layers_per_block"],
                  heads=config["attention_heads"],
                  vae_block_out_channels=tuple(config["vae_block_out_channels"]),
                  fstext_layers=config["fstext_layers"],
                  fstext_heads=config["fstext_heads"])


def unet_layers(shape: UNetShape, wd: Widths = Widths()) -> list:
    """Every layer of one SeerUNet forward in order:
    ``{"name", "w", "a", "ctx", "trainable"}`` with ``w`` the weight
    matmul / conv FLOPs on the main path, ``a`` the attention cores', and
    ``ctx`` the cross-attention's k / v projections of the context."""
    boc = tuple(wd.block_out_channels)
    L, heads = wd.layers_per_block, wd.heads
    b, f = shape.b, shape.f
    bf = b * f
    out = []

    def add(name, w=0.0, a=0.0, ctx=0.0, trainable=False):
        out.append(dict(name=name, w=w, a=a, ctx=ctx, trainable=trainable))

    def resnet(h, w, cin, cout):
        fl = _conv2d(bf, h, w, cin, cout, 3) + _conv2d(bf, h, w, cout, cout, 3)
        fl += _linear(b, boc[0] * 4, cout)
        if cin != cout:
            fl += _conv2d(bf, h, w, cin, cout, 1)
        add("resnet", w=fl)

    def attn_pair(h, w, c):
        s, d = h * w, c // heads
        add("text", w=_conv2d(bf, h, w, c, c, 1) * 2 + _linear(bf * s, c, c) * 6
            + _linear(bf * s, c, 4 * c) * 2 + _linear(bf * s, 4 * c, c),
            a=_attention(bf * heads, s, s, d)
            + _attention(bf * heads, s, shape.ctx_tokens, d),
            ctx=_linear(bf * shape.ctx_tokens, shape.ctx_dim, c) * 2)
        if h <= 4:
            core = _attention(b * heads, f * s, f * s, d)
        else:
            ws = 8 if h // 8 >= 4 else 4
            core = _attention(b * heads * s // (ws * ws), f * ws * ws,
                              f * ws * ws, d)
        add("temporal", w=_conv2d(bf, h, w, c, c, 1) * 2
            + _linear(bf * s, c, c) * 4 + _linear(bf * s, c, 4 * c) * 2
            + _linear(bf * s, 4 * c, c), a=core, trainable=True)

    h, w = shape.h, shape.w
    add("conv_in", w=_conv2d(bf, h, w, wd.in_channels, boc[0], 3))
    add("time_embedding", w=_linear(b, boc[0], boc[0] * 4)
        + _linear(b, boc[0] * 4, boc[0] * 4))
    skips = [(h, w, boc[0])]
    cin, n = boc[0], len(boc)
    for i, cout in enumerate(boc):
        for layer in range(L):
            resnet(h, w, cin if layer == 0 else cout, cout)
            if i < n - 1:
                attn_pair(h, w, cout)
            skips.append((h, w, cout))
        cin = cout
        if i < n - 1:
            add("downsample", w=_conv2d(bf, h // 2, w // 2, cout, cout, 3))
            skips.append((h // 2, w // 2, cout))
            h, w = h // 2, w // 2
    resnet(h, w, boc[-1], boc[-1])
    attn_pair(h, w, boc[-1])
    resnet(h, w, boc[-1], boc[-1])
    rev = list(reversed(boc))
    prev = rev[0]
    for i, cout in enumerate(rev):
        for _ in range(L + 1):
            _, _, sc = skips.pop()
            resnet(h, w, prev + sc, cout)
            if i > 0:
                attn_pair(h, w, cout)
            prev = cout
        if i < n - 1:
            h, w = h * 2, w * 2
            add("upsample", w=_conv2d(bf, h, w, cout, cout, 3))
    add("conv_out", w=_conv2d(bf, h, w, boc[0], wd.out_channels, 3))
    return out


def seer_unet_flops(shape: UNetShape, wd: Widths = Widths()) -> float:
    """One SeerUNet forward (matmul / conv only)."""
    return sum(x["w"] + x["a"] + x["ctx"] for x in unet_layers(shape, wd))


def vae_flops(n_img, h, w, decode: bool, wd: Widths = Widths()) -> float:
    """AutoencoderKL encode (h, w: pixels) or decode (h, w: latents)."""
    ch = tuple(wd.vae_block_out_channels)
    lat = wd.latent_channels
    total = 0.0

    def resnet(hh, ww, cin, cout):
        fl = (_conv2d(n_img, hh, ww, cin, cout, 3)
              + _conv2d(n_img, hh, ww, cout, cout, 3))
        if cin != cout:
            fl += _conv2d(n_img, hh, ww, cin, cout, 1)
        return fl

    def mid(hh, ww, c):
        return (resnet(hh, ww, c, c) * 2 + _linear(n_img * hh * ww, c, c) * 4
                + _attention(n_img, hh * ww, hh * ww, c))

    hh, ww = h, w
    if not decode:
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
        total += _conv2d(n_img, hh, ww, 2 * lat, 2 * lat, 1)
    else:
        total += _conv2d(n_img, hh, ww, lat, lat, 1)
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


def fstext_layers(b, f, tokens=77, dim=768, wd: Widths = Widths()) -> list:
    """FSText's layers as ``unet_layers`` gives the UNet's (all trainable)."""
    heads = wd.fstext_heads
    n_tok = b * f * tokens
    ff = _linear(n_tok, dim, 4 * dim) * 2 + _linear(n_tok, 4 * dim, dim)
    out = []
    for _ in range(wd.fstext_layers):
        out.append(dict(name="fstext_spatial", trainable=True, ctx=0.0,
                        w=_linear(n_tok, dim, dim) * 6
                        + _linear(b * tokens, dim, dim) * 2 + ff,
                        a=_attention(b * f * heads, tokens, tokens, dim // heads)
                        + _attention(b * heads, f * tokens, tokens,
                                     dim // heads)))
        out.append(dict(name="fstext_temporal", trainable=True, ctx=0.0,
                        w=_linear(n_tok, dim, dim) * 4 + ff,
                        a=_attention(b * tokens * heads, f, f, dim // heads)))
    return out


def fstext_flops(b, f, tokens=77, dim=768, wd: Widths = Widths()) -> float:
    return sum(x["w"] + x["a"] for x in fstext_layers(b, f, tokens, dim, wd))


# ------------------------------------------------- model FLOPs of the work

def sampled_clip_flops(wd: Widths, frames: int, cond_frames: int,
                       resolution: int, unet_calls: int) -> float:
    """One clip (one prompt row) sampled with batched CFG: the UNet at CFG
    batch 2 for every call, FSText, the VAE encode of the cond frames and
    the decode of the predicted ones."""
    lat = resolution // 8
    unet = seer_unet_flops(UNetShape(b=2, f=frames, h=lat, w=lat), wd)
    return (unet * unet_calls + fstext_flops(1, frames, wd=wd)
            + vae_flops(cond_frames, resolution, resolution, False, wd)
            + vae_flops(frames - cond_frames, lat, lat, True, wd))


def _backward(layers: list, first_trainable: bool) -> float:
    """Input-gradient FLOPs of the layers the loss flows back through
    (those after the first trainable one on the main path; every layer's
    context projections, the context coming from FSText) plus the weight
    gradients of the trainable layers."""
    total, seen = 0.0, not first_trainable
    for x in layers:
        if seen:
            total += x["w"] + 2 * x["a"]
        total += x["ctx"]
        if x["trainable"]:
            total += x["w"] + (0.0 if seen else 2 * x["a"])
            seen = True
    return total


def train_step_flops(wd: Widths, batch: int, frames: int, cond_frames: int,
                     resolution: int, accumulation: int) -> float:
    """One optimizer step of ``accumulation`` micro-steps of ``batch``
    clips: the frozen VAE encode of every frame, then FSText and the UNet
    forward and backward."""
    lat = resolution // 8
    unet = unet_layers(UNetShape(b=batch, f=frames, h=lat, w=lat), wd)
    fst = fstext_layers(batch, frames, wd=wd)
    fwd = (sum(x["w"] + x["a"] + x["ctx"] for x in unet + fst)
           + vae_flops(batch * frames, resolution, resolution, False, wd))
    bwd = _backward(unet, True) + _backward(fst, False)
    return accumulation * (fwd + bwd)


# --------------------------------------------------- per-site roofline bound

def bound_s(flops: float, nbytes: float, exps: float = 0.0) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES, exps / PEAK_EXP2)


def resnet_site(n_img, h, w, cin, cout, b, temb) -> float:
    """ResnetBlock3D over n_img frames of h x w: two 3x3 convs, the time
    projection, the 1x1 shortcut when the widths differ."""
    px = n_img * h * w
    flops = 2.0 * px * 9 * (cin * cout + cout * cout) + 2.0 * b * temb * cout
    weights = 9 * (cin * cout + cout * cout) + temb * cout + 4 * cout
    if cin != cout:
        flops += 2.0 * px * cin * cout
        weights += cin * cout + cout
    return bound_s(flops, BF16 * (px * (cin + cout) + weights))


def cross_attention_site(batch, n, m, c, cc, heads, d, causal=False,
                         self_attn=False) -> float:
    """CrossAttention: q from (batch, n, c), k / v from the context (batch,
    m, cc) (from the input itself under ``self_attn``), the core over
    heads x d (causal: the n (n + 1) / 2 pairs of tril, n == m), the
    output projection back to c."""
    inner = heads * d
    pairs = batch * heads * (n * (n + 1) / 2.0 if causal else float(n) * m)
    flops = (2.0 * batch * (n * c * inner * 2 + m * cc * inner * 2)
             + 4.0 * pairs * d)
    reads = batch * (n * c + (0 if self_attn else m * cc))
    nbytes = BF16 * (reads + batch * n * c + inner * (2 * c + 2 * cc) + c)
    return bound_s(flops, nbytes, pairs)


def window_size(h: int):
    if h <= 4:
        return None
    return 8 if (h // 8) >= 4 else 4


def temporal_attention_site(b, f, h, w, c, heads, d) -> float:
    """WindowTemporalAttention: q / k / v and output projections over
    f*h*w tokens, causal attention inside each ws x ws window across all
    frames (the whole video when h <= 4)."""
    inner, n = heads * d, f * h * w
    ws = window_size(h)
    if ws is None:
        windows, t = 1, n
    else:
        windows, t = (h // ws) * (w // ws), f * ws * ws
    pairs = b * heads * windows * t * (t + 1) / 2.0
    flops = 2.0 * b * n * c * inner * 4 + 4.0 * pairs * d
    nbytes = BF16 * (2 * b * n * c + 4 * c * inner + c)
    return bound_s(flops, nbytes, pairs)


def ff_site(n, c, inner, proj: bool = False) -> float:
    """GEGLU feed-forward on n tokens: c -> 2 inner -> c; ``proj`` adds the
    site's 1x1 proj_out and its residual (K4's tail)."""
    flops = 2.0 * n * c * inner * 3
    weights = 3 * c * inner + 2 * inner + c
    io = 2 * n * c
    if proj:
        flops += 2.0 * n * c * c
        weights += c * c + c
        io += n * c
    return bound_s(flops, BF16 * (io + weights))
