"""Stable Video Diffusion XT on the port's normal path, against the
benchmark's plain fp32 reference (``seerbench/reference/svd_*.py``, which
imports nothing of the port) on seeded random weights at toy widths (2
levels, 2 heads, 3 frames, 8 x 8 latents), on the CPU in fp32:

- one UNet call (both CFG halves, two clips with different image
  embeddings and added time ids), the temporal decoder, the image encoder
  (also against transformers' ``CLIPVisionModelWithProjection``), and a
  whole sampled clip from image to frames through the port's pipeline,
  the draws from one generator;
- pinned separately: the frame-spanning temporal GroupNorm beside the
  per-frame spatial one, the two blend directions, each clip's own
  temporal context, the Karras table and c_noise against closed forms,
  ``time_conv_out`` mixing neighbouring frames;
- the released key set at the published widths (meta device), the
  ``inference_img`` entry under ``model: svd_xt``, the benchmark driver
  and its fp8 control at toy width, and the reference's import boundary.

Tolerances: fp32 against fp32, the same math in a different layout and
op order (channels last against channels first, folded against unfolded
frames, a lerp against the blend's two products): relative L2 1e-5 on
one call of a model; 1e-4 on a sampled clip, whose three Euler steps
start from x_T scaled by sqrt(700^2 + 1) and divide by sigma.
"""
from __future__ import annotations

import ast
import copy
import json
import math
import os
import time

import pytest
import torch
import torch.nn.functional as F

from seerbench import harness
from seerbench.drivers import svd_sample
from seerbench.reference import svd_sampling as ref_sampling
from seerbench.reference.svd_unet import AlphaBlender as RefBlender
from seerbench.svd_weights import load_into_port, make_state
from seervideoldm_tpu_torch.diffusion.euler_edm import (c_noise,
                                                        init_noise_sigma,
                                                        karras_sigmas)
from seervideoldm_tpu_torch.inference_img import build_pipeline
from seervideoldm_tpu_torch.models import svd_unet
from seervideoldm_tpu_torch.ops.conv import TemporalConv
from seervideoldm_tpu_torch.ops.norms import GroupNorm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = json.load(open(os.path.join(ROOT, "seerbench", "configs",
                                     "svd-xt.json")))
SEED = 2 ** 31 + 4321
torch.set_num_threads(2)


def toy_config() -> dict:
    c = copy.deepcopy(CONFIG)
    c["unet"].update(block_out_channels=[32, 64], num_attention_heads=[2, 2],
                     layers_per_block=1, norm_num_groups=8,
                     cross_attention_dim=16, addition_time_embed_dim=8,
                     projection_class_embeddings_input_dim=24)
    c["vae"].update(block_out_channels=[16, 32], layers_per_block=1,
                    norm_num_groups=8)
    c["image_encoder"].update(image_size=28, patch_size=14, hidden_size=32,
                              intermediate_size=64, num_hidden_layers=2,
                              num_attention_heads=4, projection_dim=16)
    c["sampling"].update(height=16, width=16, num_frames=3, steps=3)
    c["compute_dtype"] = "float32"
    return c


def rel(a, b) -> float:
    a, b = a.detach().double().reshape(-1), b.detach().double().reshape(-1)
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def pair():
    """(port pipeline, reference models, toy config) on the same weights."""
    config = toy_config()
    raw = svd_sample.port_config(config, SEED)
    raw["mixed_precision"] = "no"
    pipe, _, _ = build_pipeline(raw, device="cpu")
    state = make_state(config, SEED, "cpu", dtype=torch.float32)
    load_into_port(pipe.m, state)
    return pipe, ref_sampling.build(config, state, "cpu"), config


def test_unet_call_matches_reference(pair):
    """Both CFG halves of two clips whose image embeddings and added time
    ids differ: rows [uncond a, uncond b, cond a, cond b]."""
    pipe, ref, _ = pair
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4, 3, 8, 8, 8, generator=g)
    emb = torch.randn(2, 1, 16, generator=g)
    ctx = torch.cat([torch.zeros_like(emb), emb])
    ids = torch.tensor([[6.0, 127.0, 0.02], [3.0, 40.0, 0.1]]).repeat(2, 1)
    with torch.no_grad():
        got = pipe.m.unet(x, 0.25 * math.log(3.7), ctx, ids)
        want = ref.unet(x.permute(0, 1, 4, 2, 3), 0.25 * math.log(3.7), ctx,
                        ids).permute(0, 1, 3, 4, 2)
    assert got.shape == (4, 3, 8, 8, 4)
    assert rel(got, want) < 1e-5
    # the two clips (and the two halves) are not the same computation
    assert rel(got[2], got[3]) > 1e-2 and rel(got[0], got[2]) > 1e-2


def test_temporal_decoder_matches_reference(pair):
    pipe, ref, _ = pair
    z = torch.randn(2, 3, 8, 8, 4, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = pipe.m.vae.decode(z)
        want = ref.vae.decoder(z.permute(0, 1, 4, 2, 3).flatten(0, 1), 3)
    want = want.reshape(2, 3, *want.shape[1:]).permute(0, 1, 3, 4, 2)
    assert got.shape == (2, 3, 16, 16, 3)
    assert rel(got, want) < 1e-5


def test_vae_encoder_matches_reference(pair):
    pipe, ref, _ = pair
    x = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = pipe.m.vae.encode(x * 2 - 1)
        want = ref.vae.encode_mean((x * 2 - 1).permute(0, 3, 1, 2))
    assert rel(got, want.permute(0, 2, 3, 1)) < 1e-5


def test_image_encoder_matches_reference(pair):
    pipe, ref, _ = pair
    img = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(4))
    img = img * 2 - 1
    with torch.no_grad():
        got = pipe.encode_image(img)
        from seerbench.reference.svd_image import preprocess

        want = ref.image_encoder(preprocess(img.permute(0, 3, 1, 2), 28))
    assert got.shape == (2, 1, 16)
    assert rel(got[:, 0], want) < 1e-5


def test_image_encoder_matches_transformers(pair):
    """An outside check of one component: HF's
    ``CLIPVisionModelWithProjection`` (exact GELU) on the same weights."""
    transformers = pytest.importorskip("transformers")
    pipe, _, config = pair
    i = config["image_encoder"]
    hf_cfg = transformers.CLIPVisionConfig(
        image_size=i["image_size"], patch_size=i["patch_size"],
        hidden_size=i["hidden_size"], intermediate_size=i["intermediate_size"],
        num_hidden_layers=i["num_hidden_layers"],
        num_attention_heads=i["num_attention_heads"],
        projection_dim=i["projection_dim"], hidden_act="gelu",
        layer_norm_eps=i["layer_norm_eps"])
    hf = transformers.CLIPVisionModelWithProjection(hf_cfg).eval()
    sd = pipe.m.image_encoder.state_dict()
    missing, unexpected = hf.load_state_dict(sd, strict=False)
    assert not unexpected and all("position_ids" in k for k in missing)
    pixels = torch.randn(2, 3, 28, 28, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        got = pipe.m.image_encoder(pixels)
        want = hf(pixel_values=pixels).image_embeds
    assert rel(got, want) < 1e-5


def test_sampled_clip_matches_reference(pair):
    """Image -> frames through the port's pipeline and the reference, the
    augmentation noise and x_T drawn from one generator seed."""
    pipe, ref, config = pair
    s = config["sampling"]
    image = svd_sample.images(7, 1, 16, 16)
    gen = torch.Generator().manual_seed(11)
    frames, latents = pipe.generate(image, gen, num_frames=3, steps=3,
                                    return_latents=True)
    noise, x_T = ref_sampling.draws(11, (1, 16, 16, 3), (1, 3, 8, 8, 4), "cpu")
    want_lat, want_frames = ref_sampling.generate(ref, image, noise, x_T, s)
    assert frames.shape == (1, 3, 16, 16, 3)
    assert rel(latents, want_lat) < 1e-4
    assert rel(frames, want_frames) < 1e-4


def test_temporal_group_norm_spans_frames_and_spatial_does_not(monkeypatch):
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 3, 4, 4, 16, generator=g)
    x[:, 1] *= 5.0  # frames of different scale
    norm = GroupNorm(4, 16, 1e-6)
    spatial = svd_unet.frame_group_norm(norm, x)
    temporal = norm(x)
    want_s = F.group_norm(x.flatten(0, 1).permute(0, 3, 1, 2), 4, eps=1e-6)
    want_t = F.group_norm(x.permute(0, 4, 1, 2, 3), 4, eps=1e-6)
    assert rel(spatial, want_s.permute(0, 2, 3, 1).reshape(x.shape)) < 1e-6
    assert rel(temporal, want_t.permute(0, 2, 3, 4, 1)) < 1e-6
    assert rel(spatial, temporal) > 0.1
    # the blocks use them so: the spatial resnet per frame, the temporal
    # resnet over the clip
    block = svd_unet.SpatioTemporalResBlock(16, 16, None, 1e-6, groups=4)
    assert block.spatial_res_block.frame_norm
    seen, real = [], svd_unet.group_norm_silu
    monkeypatch.setattr(svd_unet, "group_norm_silu",
                        lambda norm, t: seen.append(t.shape) or real(norm, t))
    with torch.no_grad():
        block(x)
    # the temporal resnet's two norms see the clip whole: (c / g, f, h, w)
    assert seen == [x.shape, x.shape]


@pytest.mark.parametrize("switch", [False, True])
def test_blend_directions(switch):
    m = svd_unet.AlphaBlender(0.8, switch=switch)
    r = RefBlender(0.8, switch=switch)
    xs, xt = torch.full((3,), 2.0), torch.full((3,), -1.0)
    s = 1.0 / (1.0 + math.exp(-0.8))
    want = ((1 - s) * 2.0 + s * -1.0) if switch else (s * 2.0 + (1 - s) * -1.0)
    with torch.no_grad():
        assert torch.allclose(m(xs, xt), torch.full((3,), want), atol=1e-6)
        assert torch.allclose(r(xs, xt), torch.full((3,), want), atol=1e-6)


def test_temporal_context_is_each_clips_own(pair):
    """Two clips with different image tokens: each spatial position of a
    clip attends to its own clip's token, as if the clips ran alone."""
    pipe, _, _ = pair
    site = pipe.m.unet.down_blocks[0].attentions[0]
    g = torch.Generator().manual_seed(8)
    x = torch.randn(2, 3, 8, 8, 32, generator=g)
    ctx = torch.randn(2, 1, 16, generator=g)
    with torch.no_grad():
        both = site(x, ctx)
        alone = torch.cat([site(x[:1], ctx[:1]), site(x[1:], ctx[1:])])
        swapped = site(x, ctx.flip(0))
    assert rel(both, alone) < 1e-6
    assert rel(both, swapped) > 1e-3


def test_karras_table_and_c_noise():
    n, lo, hi, rho = 25, 0.002, 700.0, 7.0
    sig = karras_sigmas(n, lo, hi, rho)
    assert sig.shape == (n + 1,) and sig.dtype == torch.float32
    for i in range(n):
        closed = (hi ** (1 / rho) + i / (n - 1)
                  * (lo ** (1 / rho) - hi ** (1 / rho))) ** rho
        assert abs(float(sig[i]) - closed) <= 1e-6 * closed
    assert float(sig[-1]) == 0.0 and bool((sig[:-1].diff() < 0).all())
    assert ref_sampling.karras_sigmas(n, lo, hi, rho) == sig.tolist()
    assert c_noise(700.0) == pytest.approx(0.25 * math.log(700.0))
    assert c_noise(0.002) == pytest.approx(0.25 * math.log(0.002))
    assert init_noise_sigma(700.0) == pytest.approx(math.sqrt(700 ** 2 + 1))


def test_time_conv_out_mixes_neighbouring_frames(pair):
    pipe, _, _ = pair
    conv = pipe.m.vae.decoder.time_conv_out
    assert isinstance(conv, TemporalConv) and conv.kernel_size == (3, 1, 1)
    x = torch.zeros(1, 5, 4, 4, 3)
    with torch.no_grad():
        base = conv(x)
        x[:, 2] = 1.0
        moved = (conv(x) - base).abs().flatten(2).amax(-1)[0]
    assert bool((moved[1:4] > 0).all()) and bool((moved[[0, 4]] == 0).all())


def test_released_key_set_at_published_widths():
    """The port's modules at SVD-XT's widths hold exactly the released
    names (the VAE's mid attentions through the loader's renames) with
    the reference's shapes; ~1.5 B UNet and ~0.63 B image-encoder
    parameters."""
    from seervideoldm_tpu_torch.io.pretrained import VAE_RENAMES
    from seervideoldm_tpu_torch.models.clip_vision import (VIT_H14_CONFIG,
                                                           CLIPVisionModel)
    from seervideoldm_tpu_torch.models.svd_vae import \
        AutoencoderKLTemporalDecoder
    from seervideoldm_tpu_torch.models.vae import VAEConfig
    import re

    ref = ref_sampling.build_meta(CONFIG)
    with torch.device("meta"):
        port = {"unet": svd_unet.UNetSpatioTemporalConditionModel(
                    svd_unet.SVDUNetConfig()),
                "vae": AutoencoderKLTemporalDecoder(VAEConfig()),
                "image_encoder": CLIPVisionModel(VIT_H14_CONFIG,
                                                 with_projection=True)}
    for key, module in port.items():
        want = {}
        for name, t in getattr(ref, key).state_dict().items():
            for pat, repl in VAE_RENAMES:
                name = re.sub(pat, repl, name)
            want[name] = tuple(t.shape)
        got = {k: tuple(t.shape) for k, t in module.state_dict().items()}
        assert got == want, key
    count = lambda m: sum(p.numel() for p in m.parameters())  # noqa: E731
    assert 1.45e9 < count(port["unet"]) < 1.6e9
    assert 0.6e9 < count(port["image_encoder"]) < 0.66e9


def test_inference_img_entry_runs_svd_on_the_cpu(tmp_path):
    import yaml
    from PIL import Image

    from seervideoldm_tpu_torch import inference_img

    config = toy_config()
    raw = svd_sample.port_config(config, 0)
    raw.update(mixed_precision="no", output_dir=str(tmp_path / "out"),
               num_inference_steps=2, width=24)  # a 16 x 24 frame
    path = tmp_path / "svd.yaml"
    path.write_text(yaml.safe_dump(raw))
    Image.new("RGB", (40, 24), (200, 30, 90)).save(tmp_path / "img.png")
    out = inference_img.main(["--config", str(path), "--image_path",
                              str(tmp_path / "img.png")], device="cpu")
    assert out and os.path.exists(out)
    with Image.open(out) as gif:
        assert gif.size[1] == 16 and gif.size[0] % 24 == 0


def test_the_configuration_file_loads_as_published():
    from seervideoldm_tpu_torch.config import (SVD_DEFAULTS, load_config,
                                               model_of, svd_settings)

    cfg = load_config(os.path.join(ROOT, "configs", "inference_svd_xt.yaml"))
    s, got = CONFIG["sampling"], svd_settings(cfg)
    assert got == SVD_DEFAULTS
    assert model_of(cfg) == "svd_xt" and cfg.num_frames == s["num_frames"] == 25
    assert (got["height"], got["width"]) == (s["height"], s["width"])
    assert got["num_inference_steps"] == s["steps"] == 25
    assert (got["min_guidance_scale"], got["max_guidance_scale"]) == (1.0, 3.0)
    assert (got["fps"], got["motion_bucket_id"], got["noise_aug_strength"]) == (
        s["fps"], s["motion_bucket_id"], s["noise_aug_strength"])


def test_group_norm_epsilons_are_the_assumed_ones():
    """The configuration file's ``assumed.group_norm_eps`` documents the
    constants both the program and the reference build with."""
    from seerbench.reference import svd_unet as ref_unet
    from seerbench.reference import svd_vae as ref_vae
    from seervideoldm_tpu_torch.models import svd_vae

    eps = CONFIG["assumed"]["group_norm_eps"]
    for key, value in eps.items():
        if key.startswith("vae_"):
            assert getattr(svd_vae, key[4:].upper()) == value, key
            assert getattr(ref_vae, key[4:].upper()) == value, key
        else:
            assert getattr(svd_unet, key.upper()) == value, key
            assert getattr(ref_unet, key.upper()) == value, key


def test_chip_smoke_svd_counts_match_the_models():
    """``chip_smoke.py`` phase 6h's expected counts: K11 once a norm of a
    UNet call and of a 25-frame decode (counted at toy widths with the
    published structure), K2 once a transformer site outside the mid
    block; and K2 / K11 take the phase-3 rows' shapes."""
    import chip_smoke as cs
    from seervideoldm_tpu_torch.models.svd_vae import \
        AutoencoderKLTemporalDecoder
    from seervideoldm_tpu_torch.models.vae import VAEConfig
    from seervideoldm_tpu_torch.ops import norms
    from seervideoldm_tpu_torch.ops.kernels import flash_attention as FA
    from seervideoldm_tpu_torch.ops.kernels import group_norm as GN

    calls, real = [0], norms._group_norm

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    torch.manual_seed(0)
    unet = svd_unet.UNetSpatioTemporalConditionModel(svd_unet.SVDUNetConfig(
        block_out_channels=(32, 64, 128, 128), num_attention_heads=(1, 2, 4, 4),
        cross_attention_dim=16)).eval()
    vae = AutoencoderKLTemporalDecoder(VAEConfig(
        block_out_channels=(32, 32, 64, 64))).eval()
    f = cs.SVD_FRAMES
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(norms, "_group_norm", counted)
        unet(torch.randn(2, 2, 8, 8, 8), 0.5, torch.randn(2, 1, 16),
             torch.randn(2, 3))
        assert calls[0] == cs.SVD_GN_PER_UNET_CALL
        calls[0] = 0
        vae.decode(torch.randn(1, f, 2, 2, 4))
        assert calls[0] == cs.SVD_GN_PER_DECODE
    sites = [m for name, m in unet.named_modules()
             if isinstance(m, svd_unet.TransformerSpatioTemporalModel)
             and not name.startswith("mid_block")]
    assert len(sites) == cs.SVD_K2_PER_UNET_CALL
    rows = [args for path, make, args in cs.KERNEL_CASES if path == "svd"]
    for batch, n, d in (a for a in rows if len(a) == 3 and a[2] == 64):
        assert FA.covers(n, n, d)
    for shape, groups, *_ in (a for a in rows if isinstance(a[0], tuple)):
        GN.check(torch.empty(shape, dtype=torch.bfloat16, device="meta"),
                 groups)


def test_uninitialised_build_matches_once_every_tensor_is_loaded(pair):
    """``load_svd_models(init=False)``, the driver's build: nothing drawn,
    every tensor on the device, and once the state is loaded the UNet
    call is the randomly initialised build's after the same load."""
    from seervideoldm_tpu_torch.config import config_from_dict
    from seervideoldm_tpu_torch.pipelines.loading import load_svd_models

    pipe, _, config = pair
    raw = svd_sample.port_config(config, SEED)
    raw["mixed_precision"] = "no"
    state = torch.random.get_rng_state()
    models = load_svd_models(config_from_dict(raw), "cpu", init=False)
    assert torch.equal(torch.random.get_rng_state(), state)
    tensors = [t for m in models.modules()
               for t in list(m.parameters()) + list(m.buffers())]
    assert tensors and all(t.device.type == "cpu" for t in tensors)
    load_into_port(models, make_state(config, SEED, "cpu",
                                      dtype=torch.float32))
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 3, 8, 8, 8, generator=g)
    ctx = torch.randn(2, 1, 16, generator=g)
    ids = torch.tensor([[6.0, 127.0, 0.02]] * 2)
    with torch.no_grad():
        assert torch.equal(models.unet(x, 0.3, ctx, ids),
                           pipe.m.unet(x, 0.3, ctx, ids))


def _toy_ctx(seconds: float) -> harness.Context:
    wl = harness.load_json("workloads", "svd-xt.sample.576")
    wl["limits"] = {"latent_rel_l2": 1e-4, "video_rel_l2": 1e-4}
    config = toy_config()
    config["sampling"]["steps"] = 2
    return harness.Context(seed=SEED, seconds=seconds, config=config,
                           workload=wl, t0=time.monotonic(), device="cpu")


def test_driver_equals_the_reference_at_toy_width(monkeypatch):
    """The cell's driver end to end on the CPU: the pipeline back to back,
    then the check against the reference (fp32 both: summation order)."""
    ctx = _toy_ctx(0.5)
    monkeypatch.setattr(svd_sample, "port_config", _fp32(svd_sample.port_config))
    result = svd_sample.run(ctx)
    assert result.correct, [(c.name, c.value) for c in result.checks]
    assert result.attempted >= 1 and result.e2e["clips_per_s"] > 0
    assert result.record["flops"] > 0


def _fp32(port_config):
    def cfg(config, seed):
        out = port_config(config, seed)
        out["mixed_precision"] = "no"
        return out
    return cfg


def test_the_fp8_control_reads_far_above_the_program():
    gaps = svd_sample.control(_toy_ctx(0.0))
    assert min(gaps.values()) > 100 * 1e-5


def test_the_reference_imports_nothing_of_the_program():
    for name in ("svd_unet", "svd_vae", "svd_image", "svd_sampling",
                 "lowp_svd"):
        tree = ast.parse(open(os.path.join(ROOT, "seerbench", "reference",
                                           f"{name}.py")).read())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names]
                        if isinstance(node, ast.Import) else [node.module or ""])
                for m in mods:
                    assert not m.startswith(("seervideoldm", "jax", "flax")), (
                        name, m)


def test_the_spans_the_benchmark_reads(pair):
    """With the detailed tier on, one sampled clip leaves the spans the
    cell's readers take (``seerbench/metrics/*.svd.py``): ``unet.call`` per
    Euler step, the temporal sites and blends inside them, each
    attention labelled by kind with its shape, the decode inside the
    pipeline call; the always-on record carries its counts."""
    from seervideoldm_tpu_torch.utils import profiling

    pipe, _, _ = pair
    profiling.reset()
    profiling.set_enabled(True)
    try:
        pipe.generate(svd_sample.images(3, 1, 16, 16),
                      torch.Generator().manual_seed(5), num_frames=3, steps=2)
    finally:
        profiling.set_enabled(None)
    spans = profiling.spans()
    names = [s["name"] for s in spans]
    unet = {s["seq"] for s in spans if s["name"] == "unet.call"}
    assert len(unet) == 2 and names.count("euler.step") == 2
    by_seq = {s["seq"]: s for s in spans}

    def under(s, seqs):
        p = s["parent"]
        while p is not None and p not in seqs:
            p = by_seq[p]["parent"] if p in by_seq else None
        return p is not None

    # a toy UNet call: 2 down + 2 mid + 4 up resnets, 1 + 1 + 2 sites
    per_call = {"site.temporal_resnet": 8, "site.temporal_block": 4,
                "site.blend": 12}
    for name, n in per_call.items():
        inside = [s for s in spans if s["name"] == name and under(s, unet)]
        assert len(inside) == 2 * n, name
    attn = [s for s in spans if s["name"] == "site.attn.spatial_self"]
    assert len(attn) == 2 * 4 and attn[0]["ids"]["n"] == 64
    assert {"rows", "n", "m", "c", "cc", "heads", "d"} <= set(attn[0]["ids"])
    for kind in ("spatial_cross", "temporal_self", "temporal_cross"):
        assert names.count(f"site.attn.{kind}") == 8
    call = [s for s in spans if s["name"] == "pipe.svd_call"]
    assert len(call) == 1
    for name in ("pipe.encode_image", "pipe.vae_encode", "pipe.sample",
                 "pipe.vae_decode"):
        assert [s for s in spans if s["name"] == name
                and under(s, {call[0]["seq"]})], name
    record = [s for s in spans if s["name"] == "pipe.svd"][-1]
    assert record["counts"]["unet.calls"] == 2
    assert record["counts"]["svd.frames"] == 3
    assert record["counts"]["svd.steps"] == 2


def test_the_cells_readers_on_recorded_spans(monkeypatch):
    """The four SVD readers on a hand-made record of spans (device ms as
    the CUDA events would give them): the temporal sites count only inside
    ``unet.call`` (the decoder's do not), the roofline sums each spatial
    site's bound from its ids, and a program without the spans gives
    None."""
    from seerbench import program_spans
    from seerbench.roofline_svd import spatial_attention_bound
    from seerbench.run import load_module

    ids = dict(rows=50, n=9216, m=9216, c=320, cc=320, heads=5, d=64)
    recs = [
        dict(seq=1, name="pipe.svd_call", parent=None, device_ms=1000.0, ids={}),
        dict(seq=2, name="unet.call", parent=1, device_ms=30.0, ids={}),
        dict(seq=3, name="site.temporal_resnet", parent=2, device_ms=4.0, ids={}),
        dict(seq=4, name="site.blend", parent=2, device_ms=1.0, ids={}),
        dict(seq=5, name="site.attn.spatial_self", parent=2, device_ms=2.0,
             ids=ids),
        dict(seq=6, name="unet.call", parent=1, device_ms=50.0, ids={}),
        dict(seq=7, name="site.temporal_block", parent=6, device_ms=10.0, ids={}),
        dict(seq=8, name="pipe.vae_decode", parent=1, device_ms=200.0, ids={}),
        dict(seq=9, name="site.temporal_resnet", parent=8, device_ms=99.0, ids={}),
    ]
    monkeypatch.setattr(program_spans, "spans", lambda name=None: [
        r for r in recs if name is None or r["name"] == name])
    read = lambda m: load_module("metrics", m).read({})  # noqa: E731
    assert read("unet_call_ms.svd") == pytest.approx(40.0)
    assert read("temporal_share.svd") == pytest.approx(100.0 * 15.0 / 80.0)
    assert read("vae_decode_share.svd") == pytest.approx(20.0)
    assert read("spatial_attn_roofline.svd") == pytest.approx(
        100.0 * spatial_attention_bound(ids) / 2e-3)
    monkeypatch.setattr(program_spans, "spans", lambda name=None: [])
    for m in ("unet_call_ms.svd", "temporal_share.svd", "vae_decode_share.svd",
              "spatial_attn_roofline.svd"):
        assert read(m) is None
