"""Fine-tuning: the port's training step (``training.trainer.
make_train_step`` with ``prepare_batch_fn``, ``build_optimizer`` and
``TrainState``, as the ``train`` entry builds them) on synthetic clips
and instructions from the seed, every micro-step on rows of its own.

Set-up builds one training state and drives it from the seed through
its first ``check_steps`` optimizer steps (they are the warm-up too);
the window then runs that same state on.  The optimizer starts past its
warm-up (its step count at ``lr_warmup_steps``, as a resumed fine-tune
has it), so the checked steps move the weights at the full rate.

End-to-end: ``train_clips_per_s``, the clips of every whole optimizer
step completed in the window over the time from the window's start to
the last such step's end.

``correct``: once the window has closed and the program is freed, the
plain reference follows the same first steps from the same weights and
inputs in fp32; compared are each micro-step's loss, each trainable
leaf's first clipped mean gradient (the program's read from its Adam
moment after one step: mu / (1 - beta1)) and each leaf's change after
the checked steps, by the worst leaf: the gap between the two norms over
the larger of the reference's norm of that leaf and of the median leaf.
A leaf whose reference gradient is under a thousandth of the median
leaf's (nought to rounding) is left out of the change, which is read at
the median leaf (``gaps``).
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from seerbench import harness
from seerbench.reference import build as build_reference
from seerbench.reference import set_numerics as reference_numerics
from seerbench.reference.lowp import Fp8Mode
from seerbench.reference.text import DebugTokenizer
from seerbench.reference.training import train as reference_train
from seerbench.roofline import train_step_flops, widths_of
from seerbench.weights import load_into_port, make_state

FLOOR = 1e-3  # a leaf's reference gradient under this x the median's: rounding


def micro_batch(ctx, geo: dict, k: int) -> dict:
    """Micro-step ``k``'s inputs, made on the device from the seed: clips
    (b, f, res, res, 3) in [-1, 1] (coarse colour fields with fine
    noise), token ids, the VAE posterior draw, the training noise and the
    timesteps."""
    b, dev = int(ctx.workload["batch"]), ctx.device
    g = torch.Generator(device=dev).manual_seed(harness.subseed(ctx.seed, "clip", k))
    f, res = geo["frames"], geo["res"]
    coarse = torch.rand((b * f, 3, 8, 8), generator=g, device=dev) * 2 - 1
    video = torch.nn.functional.interpolate(coarse, size=(res, res),
                                            mode="bilinear", align_corners=False)
    video = video + torch.rand(video.shape, generator=g, device=dev) * 0.2 - 0.1
    video = video.clamp(-1, 1).permute(0, 2, 3, 1).reshape(b, f, res, res, 3)
    tok = DebugTokenizer()(harness.prompts(
        harness.subseed(ctx.seed, "prompts", k), b, ctx.workload))
    lat = geo["lat"]
    return {"video": video.contiguous(),
            "input_ids": torch.as_tensor(tok["input_ids"], device=dev),
            "attention_mask": torch.as_tensor(tok["attention_mask"], device=dev),
            "post_noise": torch.randn((b, f) + lat, generator=g, device=dev),
            "noise": torch.randn((b, geo["future"]) + lat, generator=g, device=dev),
            "timesteps": torch.randint(0, 1000, (b,), generator=g, device=dev)}


def optimizer_settings(ctx) -> dict:
    tr = ctx.config["train"]
    b, acc = int(ctx.workload["batch"]), int(ctx.workload["accumulation"])
    return dict(lr=tr["learning_rate"] * (b * acc if tr["scale_lr"] else 1),
                warmup=int(tr["lr_warmup_steps"]),
                total=int(tr["max_train_steps"]),
                count=int(tr["lr_warmup_steps"]),
                betas=(tr["adam_beta1"], tr["adam_beta2"]),
                weight_decay=tr["adam_weight_decay"], eps=tr["adam_epsilon"],
                max_grad_norm=tr["max_grad_norm"])


def run(ctx: harness.Context) -> harness.Result:
    from seervideoldm_tpu_torch.config import config_from_dict
    from seervideoldm_tpu_torch.pipelines.loading import load_models
    from seervideoldm_tpu_torch.training.optim import build_optimizer
    from seervideoldm_tpu_torch.training.trainer import (
        TrainState, make_train_step, prepare_batch_fn, trainable_masters)
    from seervideoldm_tpu_torch.utils.device import set_numerics

    config, wl = ctx.config, ctx.workload
    geo = harness.geometry(config, wl)
    acc, b = int(wl["accumulation"]), int(wl["batch"])
    cfg = config_from_dict(harness.port_config(config, wl, ctx.seed))
    set_numerics()
    marks = harness.Marks(ctx.t0)
    models, _ = load_models(cfg, ctx.device, trainable_scope="reference")
    marks("build")
    load_into_port(models, make_state(config, ctx.seed, ctx.device))
    harness.free_device()
    marks("weights")
    opt_kw = optimizer_settings(ctx)
    opt, _ = build_optimizer(
        trainable_masters(models), opt_kw["lr"], config["train"]["lr_scheduler"],
        opt_kw["warmup"], opt_kw["total"], opt_kw["betas"],
        opt_kw["weight_decay"], opt_kw["eps"], opt_kw["max_grad_norm"], acc)
    opt.count = opt_kw["count"]
    state = TrainState.create(opt)
    step = make_train_step(models, cond_frames=geo["cond"],
                           text_loss=bool(config["train"]["text_loss"]))
    prepare = prepare_batch_fn(models)

    def micro(k: int) -> dict:
        mb = micro_batch(ctx, geo, k)
        batch = prepare(mb["video"], mb["input_ids"], mb["attention_mask"],
                        geo["cond"], noise=mb["post_noise"])
        return step(state, batch, noise=mb["noise"], timesteps=mb["timesteps"])

    # the checked steps, which are the warm-up too
    n_check = int(wl["check_steps"])
    names = list(opt.names)
    start = [p.detach().clone() for p in opt.params]
    losses, first_grad = [], None
    for k in range(n_check * acc):
        losses.append(float(micro(k)["loss"]))
        if first_grad is None and opt.count > opt_kw["count"]:
            first_grad = [float(torch.linalg.vector_norm(m.float()))
                          / (1.0 - opt_kw["betas"][0]) for m in opt.moments.mu]
    change = [float(torch.linalg.vector_norm(p.float() - s))
              for p, s in zip(opt.params, start)]
    del start
    harness.free_device()
    marks("checked_steps")

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
    k, steps, last_end = n_check * acc, 0, t_open
    while time.monotonic() < t_close:
        with probe.step() if probe is not None else contextlib.nullcontext():
            for _ in range(acc):
                micro(k)
                k += 1
            if ctx.device == "cuda":
                torch.cuda.synchronize()
        end = time.monotonic()
        if end <= t_close:
            steps, last_end = steps + 1, end
    if probe is not None:
        probe.open = False
    peak = torch.cuda.max_memory_allocated() if ctx.device == "cuda" else 0
    window = last_end - t_open
    clips = steps * b * acc
    e2e = {"train_clips_per_s": clips / window if steps else float("nan"),
           "setup_s": t_open - ctx.t0}
    record = {"window_s": window,
              "flops": steps * train_step_flops(widths_of(config), b,
                                                geo["frames"], geo["cond"],
                                                geo["res"], acc)}
    if probe is not None:
        record.update(probe.close())
        probe.uninstall()
    harness.note(setup=marks.seconds, e2e=e2e, memory_peak_bytes=peak,
                 window_s=record["window_s"], flops=record["flops"])
    del models, state, opt, step, prepare
    harness.free_device()

    got = {"names": names, "losses": np.asarray(losses),
           "first_grad": np.asarray(first_grad), "change": np.asarray(change)}
    ref = reference_steps(ctx, geo, n_check)
    found = gaps(got, ref)
    harness.note(worst_leaves=worst_leaves(got, ref))
    limits = wl["limits"]
    checks = [harness.Check(n, found[n], limits.get(n)) for n in found]
    return harness.Result(attempted=k // acc, failed=0, e2e=e2e,
                          checks=checks, memory_peak_bytes=peak, record=record)


def reference_steps(ctx, geo: dict, n_steps: int, lowp: bool = False,
                    half: bool = False) -> dict:
    """The reference's first ``n_steps`` optimizer steps from the seed's
    weights on the seed's micro-batches, in fp32; ``lowp``: the fp8
    control; ``half``: the fault of half of every micro-batch left out."""
    reference_numerics()
    acc = int(ctx.workload["accumulation"])
    ref = build_reference(ctx.config, make_state(ctx.config, ctx.seed,
                                                 ctx.device), ctx.device)
    batches = [micro_batch(ctx, geo, k) for k in range(n_steps * acc)]
    if half:
        batches = [{k: v[:v.shape[0] // 2] for k, v in mb.items()}
                   for mb in batches]
    with Fp8Mode() if lowp else contextlib.nullcontext():
        out = reference_train(ref, batches, acc, geo["cond"],
                              optimizer_settings(ctx), n_steps)
    del ref, batches
    harness.free_device()
    return out


def worst_leaves(got: dict, ref: dict, k: int = 3) -> dict:
    """The ``k`` leaves with the largest gaps of each per-leaf number, with
    the program's and the reference's norms (for the run's notes)."""
    out = {}
    for key in ("first_grad", "change"):
        a, r = got[key], ref[key]
        gap = np.abs(a - r) / np.maximum(r, np.median(r))
        out[key] = [(got["names"][i], float(gap[i]), float(a[i]), float(r[i]),
                     float(ref["first_grad"][i] / np.median(ref["first_grad"])))
                    for i in np.argsort(-gap)[:k]]
    return out


def gaps(got: dict, ref: dict) -> dict:
    """Loss gap (worst micro-step, relative); the worst leaf's gap of the
    first gradient's norm; the median leaf's gap of the change's norm.

    The change is taken at the median leaf, not the worst: Adam divides
    each element's step by its own gradient's scale, so a leaf whose
    gradient is a thousandth of the median leaf's moves as far as any
    other, and bf16's error on its small gradient shows in full in its
    change (the worst leaves read 0.06-0.12 on every seed, each one of
    FSText's temporal q / k projections; PERF.md)."""
    if list(got["names"]) != list(ref["names"]):
        raise RuntimeError("the program's trainable leaves are not the "
                           "reference recipe's")
    loss = float(np.max(np.abs(got["losses"] - ref["losses"])
                        / np.abs(ref["losses"])))

    def per_leaf(a, r):
        return np.abs(a - r) / np.maximum(r, np.median(r))

    g_ref = ref["first_grad"]
    moved = g_ref >= FLOOR * np.median(g_ref)
    return {"loss_gap": loss,
            "grad_gap": float(np.max(per_leaf(got["first_grad"], g_ref))),
            "change_gap_median": float(np.median(
                per_leaf(got["change"], ref["change"])[moved]))}
