"""The comparison that decides ``correct`` for the sampling drivers: the
plain reference samples each checked clip again from the same image,
prompt and generator draws, and the worst relative L2 gaps of the final
latents and of the predicted frames are held to the workload's limits.

A checked clip is a dict: ``image`` (res, res, 3) in [-1, 1], ``prompt``,
``draw_seed`` and ``draw_batch`` (the generator the program's pipeline
call drew from, and that call's batch), ``row`` (the clip's row in it),
and the program's ``latents`` and ``video`` (its predicted frames).
"""
from __future__ import annotations

import contextlib

import torch

from . import harness
from .reference import build, set_numerics
from .reference.lowp import Fp8Mode
from .reference.sampling import draws, generate
from .reference.text import DebugTokenizer
from .weights import make_state

NUMBERS = ("latent_rel_l2", "video_rel_l2")


def reference_clips(ctx, clips: list, lowp: bool = False) -> list:
    """The reference's (latents, frames) of each clip, in fp32, or with
    every matmul and convolution input rounded to fp8 (``lowp``, the
    control)."""
    set_numerics()
    config, wl = ctx.config, ctx.workload
    geo = harness.geometry(config, wl)
    dev = ctx.device
    ref = build(config, make_state(config, ctx.seed, dev), dev)
    tok = DebugTokenizer()
    uc = tok([""])
    as_ids = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    out = []
    for c in clips:
        t = tok([c["prompt"]])
        cond = torch.as_tensor(c["image"], device=dev, dtype=torch.float32)
        cond = cond[None, None].expand(1, geo["cond"], *cond.shape).contiguous()
        post, x_T = draws(c["draw_seed"], c["draw_batch"], geo["cond"],
                          geo["future"], geo["lat"], dev)
        r = slice(c["row"], c["row"] + 1)
        with Fp8Mode() if lowp else contextlib.nullcontext():
            latents, frames = generate(
                ref, cond, as_ids(t["input_ids"]), as_ids(t["attention_mask"]),
                as_ids(uc["input_ids"]), as_ids(uc["attention_mask"]),
                post[r], x_T[r], int(config["ddim_steps"]),
                float(config["scale"]), pab=wl.get("pab_ranges"))
        out.append((latents[0].cpu(), frames[0].cpu()))
    del ref
    harness.free_device()
    return out


def gaps(clips: list, refs: list) -> dict:
    """The worst relative L2 gap of the latents and of the frames."""
    return {"latent_rel_l2": max(harness.rel_l2(c["latents"], r[0])
                                 for c, r in zip(clips, refs)),
            "video_rel_l2": max(harness.rel_l2(c["video"], r[1])
                                for c, r in zip(clips, refs))}


def compare(ctx, clips: list) -> list:
    """The checks of one run: each number beside the workload's limit."""
    found = (gaps(clips, reference_clips(ctx, clips)) if clips
             else dict.fromkeys(NUMBERS, float("nan")))
    limits = ctx.workload["limits"]
    return [harness.Check(n, found[n], limits.get(n)) for n in NUMBERS]
