"""Offline sampling, back to back: ``SeerPipeline.generate`` on batches of
``batch`` seeded images with one instruction each, as the port's
``inference_img`` / ``inference`` entries drive it (each cond image
repeated over the cond frames, the uncond prompt empty, one generator
per call drawing the posterior noise and then x_T); the frames are
copied to the host, as an entry that writes them would.

End-to-end: ``clips_per_s``, every clip completed in the window over the
time from the window's start to the last completed call's end. With the
workload's ``ahead`` at 0 (the default) a call that ends after the
window closes is not counted, nor is its time; with ``ahead`` calls
dispatched behind the one waited for, every call sent before the window
closes counts, and so does the time to its end.

``correct``: once the window has closed, a sample of the completed
clips drawn from the seed is sampled again by the plain reference from
the same image, prompt and generator draws (``checks.py``).
"""
from __future__ import annotations

import os
import time
from collections import deque

import torch

from seerbench import checks, harness
from seerbench.roofline import sampled_clip_flops, widths_of
from seerbench.weights import load_into_port, make_state


def _latents_tap(pipe):
    """Keeps the latents of the last ``vae_decode_video`` call."""
    decode, seen = pipe.vae_decode_video, {}

    def decoded(latents):
        seen["latents"] = latents.detach()
        return decode(latents)

    pipe.vae_decode_video = decoded
    return seen


def run(ctx: harness.Context) -> harness.Result:
    from seervideoldm_tpu_torch.config import sampling_kwargs_from
    from seervideoldm_tpu_torch.inference_img import build_pipeline

    config, wl = ctx.config, ctx.workload
    geo = harness.geometry(config, wl)
    b = int(wl["batch"])
    marks = harness.Marks(ctx.t0)
    pipe, tok, cfg = build_pipeline(harness.port_config(config, wl, ctx.seed),
                                    device=ctx.device)
    marks("build")
    load_into_port(pipe.m, make_state(config, ctx.seed, ctx.device))
    harness.free_device()
    marks("weights")
    tap = _latents_tap(pipe)
    knobs = sampling_kwargs_from(cfg)
    uc = tok([""] * b)
    ahead = int(wl.get("ahead", 0))

    def call(i, steps: int) -> dict:
        """Dispatches one pipeline call and the copies of its frames and
        latents to the host; ``finish`` waits for them."""
        imgs = harness.images(harness.subseed(ctx.seed, "images", i), b, geo["res"])
        texts = harness.prompts(harness.subseed(ctx.seed, "prompts", i), b, wl)
        t = tok(texts)
        cond = torch.from_numpy(imgs)[:, None].repeat(1, geo["cond"], 1, 1, 1)
        seed = harness.subseed(ctx.seed, "draws", i)
        gen = torch.Generator(device=pipe.device).manual_seed(seed)
        frames = pipe.generate(cond, t["input_ids"], t["attention_mask"],
                               uc["input_ids"], uc["attention_mask"],
                               num_frames=geo["frames"], generator=gen,
                               ddim_steps=steps,
                               guidance_scale=float(cfg.scale), **knobs)
        # without a call ahead, the copies wait as ``.cpu()`` does
        copied = torch.cuda.Event() if frames.is_cuda else None
        out = dict(images=imgs, prompts=texts, draw_seed=seed,
                   video=frames.float().to("cpu", non_blocking=ahead > 0),
                   latents=tap["latents"].float().to("cpu", non_blocking=ahead > 0),
                   copied=copied)
        if copied is not None:
            copied.record()
        return out

    def finish(out: dict) -> dict:
        copied = out.pop("copied")
        if copied is not None:
            copied.synchronize()
        out["end"] = time.monotonic()
        return out

    # every shape of the window: the same batch at 2 DDIM steps (1000 // 2
    # grid points, clear of the +1 offset's edge)
    finish(call("warmup", int(wl["warmup_ddim_steps"])))
    marks("warmup")
    probe = ctx.probe
    if probe is not None:
        probe.install()
    if ctx.device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_open = time.monotonic()
    t_close = t_open + ctx.seconds
    if probe is not None:
        probe.open = True
    # ``ahead`` calls stay dispatched behind the one waited for, so that the
    # card has work while the host makes the next inputs or stands still.
    # Without it a call that ends after the window closes is not counted;
    # with it nothing is sent once the window closes, all that was sent is
    # waited for and counts, and the time is read after that wait.
    pending, done, i = deque(), [], 0
    while time.monotonic() < t_close:
        pending.append(call(i, int(cfg.ddim_steps)))
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

    clips = len(done) * b
    unit = sampled_clip_flops(widths_of(config), geo["frames"], geo["cond"],
                              geo["res"], int(wl["unet_calls"]))
    window = last_end - t_open
    e2e = {"clips_per_s": clips / window if clips else float("nan"),
           "setup_s": t_open - ctx.t0}
    record = {"window_s": window, "flops": unit * clips}
    if probe is not None:
        record.update(probe.close())
        probe.uninstall()

    harness.note(setup=marks.seconds, e2e=e2e, memory_peak_bytes=peak,
                 window_s=record["window_s"], flops=record["flops"],
                 ends=[out["end"] - t_open for out in done],
                 threads=torch.get_num_threads(), cpus=os.cpu_count(),
                 affinity=len(os.sched_getaffinity(0)), loadavg=os.getloadavg())
    picked = harness.sample_indices(harness.subseed(ctx.seed, "check"), clips,
                                    int(wl["check_clips"]))
    checked = []
    for j in picked:
        out, row = done[j // b], j % b
        checked.append(dict(image=out["images"][row], prompt=out["prompts"][row],
                            draw_seed=out["draw_seed"], draw_batch=b, row=row,
                            latents=out["latents"][row], video=out["video"][row]))
    del pipe, done, tap
    harness.free_device()
    return harness.Result(attempted=i * b, failed=0, e2e=e2e,
                          checks=checks.compare(ctx, checked),
                          memory_peak_bytes=peak, record=record)
