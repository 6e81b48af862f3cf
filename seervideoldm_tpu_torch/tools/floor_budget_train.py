"""Training floor budget on the card (port of ``tools/floor_budget_train.py``).

Decomposes the 256 px reference-recipe train step (batch 1, 12 frames, 2
cond frames, ``remat: save_attn`` by default) as the sampling budget does
the UNet call, in four sections:

1. whole optimizer steps over batch layouts at the same recipe (batch 1,
   2, 4; ``--remat``), so accumulation x 2 of batch 1 can be set against
   one step of batch 2;
2. remat policies at batch 1: ``save_attn``, ``block``, ``none``, each
   step's time and the kernel launches of one micro-step per policy
   (``save_attn`` must launch the forward kernels as often as ``none``);
3. the optimizer alone: the port's AdamW + clip + global norm
   (``training/optim.py``) over fp32 tensors shaped like the trainable
   masters (405.9 M at full width), timed directly, beside the full step;
4. forward + backward per site (no remat) against analytic floors with the
   JAX tool's multipliers (``tools/floor_budget.train_site_floors``): the
   two-N delta of the wall time (N = 5 and 15 applications, each feeding
   its input gradient to the next) and the CUDA kernel time per
   application.  The temporal sites run with ``cond_frame = cond_frames``
   and trainable weights, as in the step (the JAX tool called them with
   cond_frame 0).

Remat is an attribute read at call time (``SeerUNet.remat``), so one build
of the full-width SeerUNet and FSText serves every section; the VAE and
CLIP, which the step does not run (the batch holds latents and CLIP
embeddings), are built at toy width.

    python -m seervideoldm_tpu_torch.tools.floor_budget_train [--resolution
        256 --frames 12 --cond_frames 2 --sections 1,2,3,4 --batches 1,2,4
        --remat save_attn --json]
    # plain path on the CPU at narrow width (plumbing only, no device time):
    python -m seervideoldm_tpu_torch.tools.floor_budget_train --device cpu \\
        --resolution 64 --frames 4 --widths 32,64,64,64 --fstext_layers 1 \\
        --batches 1,2 --calib_reps 2,4 --iters 1
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

from .floor_budget import (CTX_DIM, CTX_TOKENS, HEADS, LAYERS, Roofline,
                           _levels, _sync, _unet_config, bench, build_seeded,
                           common_args, parse_widths, setup,
                           train_site_floors)

REMAT_SWEEP = ("save_attn", "block", "none")


def build_models(args, device, dtype):
    """Full-width (``--widths``) SeerUNet and FSText for training."""
    from ..models.clip_text import CLIPTextConfig
    from ..models.vae import VAEConfig
    from ..pipelines.text_video import SeerModels
    from ..training.trainer import trainable_masters

    models = SeerModels.initialize(
        num_frames=args.frames, unet_config=_unet_config(args.widths, HEADS),
        vae_config=VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                             norm_num_groups=8),
        clip_config=CLIPTextConfig(vocab_size=100, hidden_size=32,
                                   intermediate_size=64, num_hidden_layers=1,
                                   num_attention_heads=4,
                                   max_position_embeddings=CTX_TOKENS),
        fstext_kwargs={"num_layers": args.fstext_layers},
        dtype=dtype, device=device, seed=0, trainable_scope="reference")
    trainable_masters(models)
    return models


def make_batch(b: int, args, device, dtype, seed: int) -> tuple:
    """(batch, noise, timesteps) of random latents and CLIP embeddings."""
    import torch

    f1, f2 = args.cond_frames, args.frames - args.cond_frames
    lat = args.resolution // 8
    gen = torch.Generator(device=device).manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=gen, device=device).to(dtype)  # noqa: E731
    batch = {"latents_x0": rn(b, f1, lat, lat, 4),
             "latents": rn(b, f2, lat, lat, 4),
             "clip_emb": rn(b, CTX_TOKENS, CTX_DIM)}
    ts = torch.randint(0, 1000, (b,), generator=gen, device=device)
    return batch, rn(b, f2, lat, lat, 4), ts


def time_steps(call, device, iters: int) -> float:
    """Median seconds of ``call()`` after one warm-up call."""
    call()
    _sync(device)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        call()
        _sync(device)
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def launches_of(call, device) -> dict:
    """Kernel launches per wrapper during ``call()``: the counters' delta,
    which leaves them counting for whoever reads them around this entry."""
    from ..ops.kernels import launch_counters

    counters = launch_counters()
    before = {name: fn.launches for name, fn in counters.items()}
    call()
    _sync(device)
    return {name: fn.launches - before[name] for name, fn in counters.items()}


def site_step(module, call, params):
    """One forward + backward through a site: the gradient of
    sum(site(h)^2) with respect to h (and ``params``), fed on as the next
    input."""
    import torch

    def step(h):
        h = h.detach().requires_grad_(True)
        with torch.enable_grad():
            y = call(module, h)
            grads = torch.autograd.grad((y.float() ** 2).sum(),
                                        [h] + params)
        return grads[0].to(h.dtype)

    return step


def main(argv: Optional[list] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--resolution", type=int, default=256)
    parser.add_argument("--cond_frames", type=int, default=2)
    parser.add_argument("--sections", default="1,2,3,4",
                        help="comma list: 1 batch layouts, 2 remat, "
                             "3 optimizer, 4 sites")
    parser.add_argument("--batches", type=parse_widths, default=(1, 2, 4),
                        help="section-1 batch sizes")
    parser.add_argument("--fstext_layers", type=int, default=8,
                        help="FSText depth (8: the reference's)")
    parser.add_argument("--remat", default="save_attn",
                        help="section-1 remat policy (section 2 sweeps its "
                             "own)")
    common_args(parser)
    args = parser.parse_args(argv)
    sections = {s.strip() for s in args.sections.split(",")}

    import torch

    from ..config import parse_remat
    from ..models.resnet3d import ResnetBlock3D
    from ..models.transformer3d import SpatialTransformer3D
    from ..training.optim import build_optimizer
    from ..training.trainer import TrainState, make_train_step

    section1_remat = parse_remat(args.remat)
    device, dtype, card, sm = setup(args)
    out = dict(card, device=device.type, resolution=args.resolution,
               frames=args.frames, cond_frames=args.cond_frames,
               widths=list(args.widths), sm_ps_per_elem=sm * 1e12)
    print(f"softmax calibration (K10): {sm * 1e12:.4f} ps/element", flush=True)

    models = build_models(args, device, dtype)
    unet = models.unet
    step = make_train_step(models, cond_frames=args.cond_frames)
    optimizer, _ = build_optimizer(models.masters, 1e-4, warmup_steps=1,
                                   total_steps=1000)
    state = TrainState.create(optimizer)
    names = list(models.masters)

    def step_seconds(b: int, remat) -> float:
        unet.remat = remat
        batch, noise, ts = make_batch(b, args, device, dtype, seed=b)
        return time_steps(lambda: step(state, batch, noise=noise,
                                       timesteps=ts), device, args.iters)

    # ---- 1. batch layouts
    if "1" in sections:
        print(f"== whole-step timings ({args.remat} remat) ==", flush=True)
        step_ms = {}
        for b in args.batches:
            try:
                step_ms[b] = step_seconds(b, section1_remat) * 1e3
            except torch.cuda.OutOfMemoryError as e:
                print(f"b={b}: out of memory: {str(e)[:100]}", flush=True)
                torch.cuda.empty_cache()
                continue
            print(f"b={b}: {step_ms[b]:9.3f} ms/step {step_ms[b] / b:9.3f} "
                  "ms/sample", flush=True)
        out["step_ms_by_batch"] = {str(k): v for k, v in step_ms.items()}
        if 1 in step_ms and 2 in step_ms:
            out["accum2_vs_b2_speedup"] = 2 * step_ms[1] / step_ms[2]

    # ---- 2. remat policies at batch 1, and one micro-step's launches
    if "2" in sections:
        print("== remat policies (b=1) ==", flush=True)
        out["remat_ms"], out["remat_launches"] = {}, {}
        batch, noise, ts = make_batch(1, args, device, dtype, seed=1)
        for policy in REMAT_SWEEP:
            remat = parse_remat(policy)
            out["remat_ms"][policy] = step_seconds(1, remat) * 1e3
            unet.remat = remat
            out["remat_launches"][policy] = launches_of(
                lambda: step.loss_and_grads(names, batch, noise, ts), device)
            print(f"remat={policy}: {out['remat_ms'][policy]:9.3f} ms/step; "
                  f"launches per micro-step {out['remat_launches'][policy]}",
                  flush=True)

    # ---- 3. the optimizer alone, beside the full step
    if "3" in sections:
        print("== optimizer ==", flush=True)
        base = step_seconds(1, "save_attn") * 1e3
        params = {n: torch.full_like(m, 1e-2) for n, m in models.masters.items()}
        grads = {n: torch.full_like(m, 1e-4) for n, m in models.masters.items()}
        probe, _ = build_optimizer(params, 1e-4, warmup_steps=1,
                                   total_steps=1000)
        opt_ms = time_steps(lambda: probe.update(grads), device,
                            args.iters) * 1e3
        n_params = sum(t.numel() for t in params.values())
        del params, grads, probe
        out.update(step_ms=base, optimizer_ms=opt_ms,
                   trainable_params=n_params)
        print(f"full step {base:.3f} ms (save_attn); AdamW + clip + global "
              f"norm over {n_params / 1e6:.1f} M fp32 = {opt_ms:.3f} ms "
              f"({100 * opt_ms / base:.1f} % of the step)", flush=True)
    unet.remat = False
    del state, optimizer, step

    # ---- 4. per-site forward + backward against the floors
    if "4" in sections:
        print("== per-site fwd+bwd (no remat; b=1 shapes) ==", flush=True)
        b, f = 1, args.frames
        gen = torch.Generator(device=device).manual_seed(0)
        rn = lambda *s: torch.randn(s, generator=gen, device=device).to(dtype)  # noqa: E731
        ctx = rn(b, f, CTX_TOKENS, CTX_DIM)
        temb = rn(b, args.widths[0] * 4)
        temb_ch = args.widths[0] * 4
        floors = train_site_floors(args.resolution, f, b, Roofline.h100(), sm,
                                   widths=args.widths, heads=HEADS)
        levels, _ = _levels(args.resolution, args.widths, HEADS)

        def site(ctor, call, x_site, seed, trainable=False):
            module = build_seeded(ctor, device, dtype, seed)
            params = []
            if trainable:
                params = list(module.parameters())
                for p in params:
                    p.requires_grad_(True)
            return bench(site_step(module, call, params), x_site, device, 5,
                         15, args.iters)

        rows, total = [], 0.0
        n_sites = 2 * LAYERS + 1
        for i, ((level, hw, c, d), fl) in enumerate(zip(levels, floors)):
            xs = rn(b, f, hw, hw, c)
            r = dict(fl, n_attn=n_sites, n_res=n_sites)
            r["res_ms"], r["res_kernel_ms"] = site(
                lambda: ResnetBlock3D(c, c, temb_ch),
                lambda mod, h: mod(h, temb), xs, 10 * i + 1)
            r["text_ms"], r["text_kernel_ms"] = site(
                lambda: SpatialTransformer3D(c, HEADS, d, context_dim=CTX_DIM,
                                             text_frame_condition=True),
                lambda mod, h: mod(h, context=ctx), xs, 10 * i + 3)
            r["temp_ms"], r["temp_kernel_ms"] = site(
                lambda: SpatialTransformer3D(c, HEADS, d, temporal=True,
                                             causal=True),
                lambda mod, h: mod(h, cond_frame=args.cond_frames), xs,
                10 * i + 4, trainable=True)
            rows.append(r)
            total += n_sites * (r["res_ms"] + r["text_ms"] + r["temp_ms"])
        out["site_rows"] = rows
        out["sites_sum_ms"] = total
        print(f"{'site':<10}{'wall ms':>10}{'kernel ms':>11}{'floor':>9}"
              f"{'act/floor':>10}{'host':>7}")
        for r in rows:
            for kind in ("res", "text", "temp"):
                wall, kern = r[f"{kind}_ms"], r[f"{kind}_kernel_ms"]
                host = "-" if kern is None else f"{1 - kern / wall:.2f}"
                kern = "-" if kern is None else f"{kern:.3f}"
                print(f"{r['level'] + ' ' + kind:<10}{wall:>10.3f}"
                      f"{kern:>11}{r[kind + '_floor']:>9.3f}"
                      f"{wall / r[kind + '_floor']:>10.2f}{host:>7}")
        print(f"sum of L0-L2 sites (fwd+bwd, no remat): {total:.3f} ms vs "
              f"remat=none step "
              f"{out.get('remat_ms', {}).get('none', float('nan')):.3f} ms",
              flush=True)
    if args.json:
        print(json.dumps({"floor_budget_train": out}), flush=True)
    return out


if __name__ == "__main__":
    main()
