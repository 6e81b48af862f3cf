"""The frozen work counts against hand-worked shapes."""
from __future__ import annotations

import pytest

from seerbench import roofline as r


def test_unet_flops_of_the_sd15_shapes():
    # the port's utils/flops.py gives these (SD-1.5 width, CFG batch 2 and 8,
    # 12 frames, 256 px; 16 frames at batch 4)
    assert r.seer_unet_flops(r.UNetShape(2, 12, 32, 32)) == 5846755573760.0
    assert r.seer_unet_flops(r.UNetShape(8, 12, 32, 32)) == 23387022295040.0
    assert r.seer_unet_flops(r.UNetShape(4, 16, 32, 32)) == 15719116308480.0


def test_layers_add_up_and_split():
    shape = r.UNetShape(2, 12, 32, 32)
    layers = r.unet_layers(shape)
    names = [x["name"] for x in layers]
    # 2 resnets + 2 site pairs at each of three attention levels, 2
    # resnets at the last, the mid block, 3 (+ 3 pairs) per up level
    assert names.count("resnet") == 6 + 2 + 2 + 12
    assert names.count("text") == names.count("temporal") == 6 + 1 + 9
    assert all(x["trainable"] == (x["name"] == "temporal") for x in layers)
    assert sum(x["w"] + x["a"] + x["ctx"] for x in layers) == \
        r.seer_unet_flops(shape)


def test_conv_linear_attention_by_hand():
    assert r._conv2d(2, 4, 4, 3, 5, 3) == 2 * 2 * 4 * 4 * 3 * 5 * 9
    assert r._linear(7, 3, 5) == 2 * 7 * 3 * 5
    # scores and p @ v
    assert r._attention(3, 4, 5, 8) == 2 * 2 * 3 * 4 * 5 * 8


def test_site_bounds_by_hand():
    # GEGLU: c -> 2 x inner, inner -> c; bytes: x, out and weights in bf16
    n, c, inner = 10, 4, 16
    flops = 2 * n * c * 2 * inner + 2 * n * inner * c
    nbytes = 2 * (2 * n * c + 3 * c * inner + 2 * inner + c)
    assert r.ff_site(n, c, inner) == pytest.approx(
        max(flops / r.PEAK_FLOPS, nbytes / r.PEAK_BYTES))
    # a big token count is bound by FLOPs
    assert r.ff_site(98304, 320, 1280) == pytest.approx(
        2 * 98304 * 320 * 1280 * 3 / r.PEAK_FLOPS)
    # the causal core sees n (n + 1) / 2 pairs; exp2 bounds a d-40 softmax
    b, n, d = 192, 1024, 40
    one = r.cross_attention_site(b, n, n, 8 * d, 8 * d, 8, d, self_attn=True)
    assert one >= b * 8 * n * n / r.PEAK_EXP2
    half = r.cross_attention_site(b, n, n, 8 * d, 8 * d, 8, d, causal=True,
                                  self_attn=True)
    assert half < one


def test_temporal_windows():
    assert r.window_size(32) == 8 and r.window_size(16) == 4
    assert r.window_size(8) == 4 and r.window_size(4) is None
    # 32 x 32 at 12 frames: 16 windows of 12 x 64 tokens, causal
    t = 12 * 64
    pairs = 2 * 8 * 16 * t * (t + 1) / 2
    assert r.temporal_attention_site(2, 12, 32, 32, 320, 8, 40) >= \
        pairs / r.PEAK_EXP2


def test_train_step_counts_forward_backward_and_weight_grads():
    wd = r.Widths()
    shape = r.UNetShape(4, 16, 32, 32)
    layers = r.unet_layers(shape)
    fst = r.fstext_layers(4, 16)
    fwd = (sum(x["w"] + x["a"] + x["ctx"] for x in layers + fst)
           + r.vae_flops(64, 256, 256, False))
    total = r.train_step_flops(wd, 4, 16, 1, 256, 1)
    # backward: more than the trainable weights' gradients, less than twice
    # the forward
    trainable_w = sum(x["w"] for x in layers + fst if x["trainable"])
    assert fwd + trainable_w < total < 3 * fwd
    assert r.train_step_flops(wd, 4, 16, 1, 256, 2) == 2 * total


def test_sampled_clip_counts_cfg_vae_and_fstext():
    wd = r.Widths()
    clip = r.sampled_clip_flops(wd, 12, 2, 256, 31)
    unet = r.seer_unet_flops(r.UNetShape(2, 12, 32, 32))
    assert clip == pytest.approx(
        31 * unet + r.fstext_flops(1, 12) + r.vae_flops(2, 256, 256, False)
        + r.vae_flops(10, 32, 32, True))
