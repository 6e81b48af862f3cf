"""Image-to-video sampling with Stable Video Diffusion XT, back to back:
the port's ``SVDPipeline.generate`` (``model: svd_xt``) on one seeded
image a call at the configuration's published settings (576 x 1024, 25
frames, 25 Euler steps at CFG batch 2, guidance 1.0 -> 3.0, fps 7, motion
bucket 127, noise augmentation 0.02, every frame decoded in one call);
the frames and final latents are copied to the host, as an entry that
writes them would.

End-to-end: ``clips_per_s`` as ``sample_batch`` counts it (the workload's
``ahead`` calls stay dispatched behind the one waited for; every call
sent before the window closes counts, over the time to its end) and
``setup_s``.  The record's ``flops`` are ``roofline_svd.clip_flops`` of
the clips completed.  Under ``--trace 1`` the second call of the window
is the profiled unit (the probe's ``step()``).

``correct``: once the window has closed and the port is freed, a sample
of the completed clips drawn from the seed is sampled again by the plain
fp32 reference (``reference/svd_sampling.py``) from the same image and
generator draws on the same weights; the relative L2 gaps of the final
latents and of the frames are held to the workload's limits.  ``control``
gives the same numbers for the fp8 control (``reference/lowp_svd.py``)
in the program's place.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import deque

import torch

from seerbench import harness
from seerbench.reference import set_numerics
from seerbench.reference.lowp_svd import Fp8ModeSVD
from seerbench.reference.svd_sampling import build, draws, generate
from seerbench.roofline_svd import clip_flops
from seerbench.svd_weights import load_into_port, make_state

NUMBERS = ("latent_rel_l2", "video_rel_l2")


def port_config(config: dict, seed: int) -> dict:
    """The port's configuration keys for the configuration file."""
    u, v, i, s = (config[k] for k in ("unet", "vae", "image_encoder",
                                      "sampling"))
    unet = {k: u[k] for k in ("in_channels", "out_channels",
                              "block_out_channels", "layers_per_block",
                              "num_attention_heads", "cross_attention_dim",
                              "addition_time_embed_dim",
                              "projection_class_embeddings_input_dim",
                              "norm_num_groups")}
    return dict(
        model="svd_xt", seed=int(seed), height=s["height"], width=s["width"],
        num_frames=s["num_frames"], num_inference_steps=s["steps"],
        min_guidance_scale=s["min_guidance_scale"],
        max_guidance_scale=s["max_guidance_scale"], fps=s["fps"],
        motion_bucket_id=s["motion_bucket_id"],
        noise_aug_strength=s["noise_aug_strength"], vae_scale=s["vae_scale"],
        mixed_precision="bf16", compute_dtype=config["compute_dtype"],
        model_overrides={
            "svd_unet": unet,
            "vae": {k: v[k] for k in ("in_channels", "out_channels",
                                      "latent_channels", "block_out_channels",
                                      "layers_per_block", "norm_num_groups")},
            "image_encoder": {k: i[k] for k in (
                "image_size", "patch_size", "hidden_size", "intermediate_size",
                "num_hidden_layers", "num_attention_heads", "projection_dim",
                "layer_norm_eps", "hidden_act")}})


def images(seed: int, n: int, h: int, w: int):
    """n images (n, h, w, 3) float32 in [-1, 1]: ``harness.images``'
    coarse colour fields with fine noise, rectangular."""
    g = torch.Generator().manual_seed(seed)
    coarse = torch.rand((n, 3, 8, 8), generator=g) * 2 - 1
    fine = torch.rand((n, 3, h, w), generator=g) * 0.2 - 0.1
    x = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear",
                                        align_corners=False)
    return (x + fine).clamp(-1, 1).permute(0, 2, 3, 1).contiguous()


def clip_inputs(seed: int, i, s: dict) -> dict:
    """The image and the generator seed of pipeline call ``i``."""
    return dict(image=images(harness.subseed(seed, "images", i), 1,
                             s["height"], s["width"])[0],
                draw_seed=harness.subseed(seed, "draws", i))


def reference_clips(ctx, clips: list, lowp: bool = False) -> list:
    """The reference's (latents, frames) of each checked clip, in fp32, or
    with every matmul and convolution input rounded to fp8 (``lowp``)."""
    set_numerics()
    config, dev = ctx.config, ctx.device
    s = config["sampling"]
    ref = build(config, make_state(config, ctx.seed, dev), dev)
    scale = 2 ** (len(config["vae"]["block_out_channels"]) - 1)
    out = []
    for c in clips:
        image = torch.as_tensor(c["image"], device=dev)[None]
        noise, x_T = draws(c["draw_seed"], tuple(image.shape),
                           (1, s["num_frames"], s["height"] // scale,
                            s["width"] // scale,
                            config["vae"]["latent_channels"]), dev)
        with Fp8ModeSVD() if lowp else contextlib.nullcontext():
            latents, frames = generate(ref, image, noise, x_T, s)
        out.append((latents[0].cpu(), frames[0].cpu()))
        del latents, frames
    del ref
    harness.free_device()
    return out


def gaps(clips: list, refs: list) -> dict:
    return {"latent_rel_l2": max(harness.rel_l2(c["latents"], r[0])
                                 for c, r in zip(clips, refs)),
            "video_rel_l2": max(harness.rel_l2(c["video"], r[1])
                                for c, r in zip(clips, refs))}


def compare(ctx, clips: list) -> list:
    found = (gaps(clips, reference_clips(ctx, clips)) if clips
             else dict.fromkeys(NUMBERS, float("nan")))
    limits = ctx.workload["limits"]
    return [harness.Check(n, found[n], limits.get(n)) for n in NUMBERS]


def control(ctx, n: int = 1) -> dict:
    """The fp8 control's gaps against the fp32 reference on the first
    ``n`` clips a run of the cell would check."""
    s = ctx.config["sampling"]
    clips = [clip_inputs(ctx.seed, i, s) for i in range(n)]
    want = reference_clips(ctx, clips)
    for c, (latents, frames) in zip(clips, reference_clips(ctx, clips,
                                                           lowp=True)):
        c.update(latents=latents, video=frames)
    return gaps(clips, want)


def run(ctx: harness.Context) -> harness.Result:
    # the architecture first: a program without it fails here, at once
    from seervideoldm_tpu_torch.pipelines.image_video import SVDPipeline
    from seervideoldm_tpu_torch.config import config_from_dict
    from seervideoldm_tpu_torch.pipelines.loading import load_svd_models
    from seervideoldm_tpu_torch.utils.device import set_numerics as numerics

    config, wl = ctx.config, ctx.workload
    s = config["sampling"]
    marks = harness.Marks(ctx.t0)
    cfg = config_from_dict(port_config(config, ctx.seed))
    numerics()
    # no random init: every tensor is loaded next
    pipe = SVDPipeline(load_svd_models(cfg, ctx.device, init=False),
                       vae_scale=float(cfg.vae_scale))
    marks("build")
    load_into_port(pipe.m, make_state(config, ctx.seed, ctx.device))
    harness.free_device()
    marks("weights")
    ahead = int(wl.get("ahead", 0))
    probe = ctx.probe

    def call(i, steps: int) -> dict:
        """Dispatches one pipeline call and the copies of its frames and
        latents to the host; ``finish`` waits for them."""
        inp = clip_inputs(ctx.seed, i, s)
        gen = torch.Generator(device=pipe.device).manual_seed(inp["draw_seed"])
        unit = probe.step() if probe is not None else contextlib.nullcontext()
        with unit:
            frames, latents = pipe.generate(
                inp["image"][None], gen, num_frames=s["num_frames"],
                steps=steps, min_guidance_scale=s["min_guidance_scale"],
                max_guidance_scale=s["max_guidance_scale"], fps=s["fps"],
                motion_bucket_id=s["motion_bucket_id"],
                noise_aug_strength=s["noise_aug_strength"],
                return_latents=True)
        copied = torch.cuda.Event() if frames.is_cuda else None
        inp.update(video=frames[0].to("cpu", non_blocking=ahead > 0),
                   latents=latents[0].to("cpu", non_blocking=ahead > 0),
                   copied=copied)
        if copied is not None:
            copied.record()
        return inp

    def finish(out: dict) -> dict:
        copied = out.pop("copied")
        if copied is not None:
            copied.synchronize()
        out["end"] = time.monotonic()
        return out

    # every shape of the window, at fewer Euler steps
    finish(call("warmup", int(wl["warmup_steps"])))
    marks("warmup")
    if probe is not None:
        probe.install()
    if ctx.device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_open = time.monotonic()
    t_close = t_open + ctx.seconds
    if probe is not None:
        probe.open = True
    pending, done, i = deque(), [], 0
    while time.monotonic() < t_close:
        pending.append(call(i, int(s["steps"])))
        i += 1
        while len(pending) > ahead:
            out = finish(pending.popleft())
            if ahead or out["end"] <= t_close:
                done.append(out)
    while pending:
        done.append(finish(pending.popleft()))
    last_end = done[-1]["end"] if done else t_open
    if probe is not None:
        probe.open = False
    peak = torch.cuda.max_memory_allocated() if ctx.device == "cuda" else 0

    window = last_end - t_open
    e2e = {"clips_per_s": len(done) / window if done else float("nan"),
           "setup_s": t_open - ctx.t0}
    record = {"window_s": window, "flops": clip_flops(config) * len(done)}
    if probe is not None:
        record.update(probe.close())
        probe.uninstall()
    t_check = time.monotonic()
    harness.note(setup=marks.seconds, e2e=e2e, memory_peak_bytes=peak,
                 window_s=window, flops=record["flops"],
                 ends=[out["end"] - t_open for out in done],
                 threads=torch.get_num_threads(), cpus=os.cpu_count(),
                 loadavg=os.getloadavg())
    picked = harness.sample_indices(harness.subseed(ctx.seed, "check"),
                                    len(done), int(wl["check_clips"]))
    checked = [done[j] for j in picked]
    del pipe, done
    harness.free_device()
    checks = compare(ctx, checked)
    harness.note(check_s=time.monotonic() - t_check)
    return harness.Result(attempted=i, failed=0, e2e=e2e, checks=checks,
                          memory_peak_bytes=peak, record=record)
