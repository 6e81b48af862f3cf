"""Readings of the control and of the planted faults, which set the upper
end of each limit of ``correct`` (the benchmark's runs never run this).

    python3 -m seerbench.control --workload <cell> --seeds 11,12,13

For each seed it builds the inputs a run of the cell checks, at the
cell's own sizes, and compares, by the run's own numbers, against the
fp32 reference:

- sampling cells: the reference computed in fp8 (``reference/lowp.py``)
  in the program's place;
- the training cell: the same, and the reference with half of every
  micro-batch left out (the loss the mean over the rest).  A state left
  unchanged reads 1 on ``change_gap`` by its definition and needs no run.

One JSON line per seed and mode.  On a card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import time

from seerbench import checks, harness
from seerbench.drivers import serve_closed, train_steps


def sampling_clips(ctx, n: int) -> list:
    """The first ``n`` clips a run of the cell would check, as the driver
    makes their inputs; ``latents`` / ``video`` are filled in by the
    caller."""
    wl, geo = ctx.workload, harness.geometry(ctx.config, ctx.workload)
    out = []
    if wl["driver"] == "serve_closed":
        mb = int(wl["program"]["serve_max_batch"])
        per = int(wl["clients"]) * int(wl["requests_per_client"])
        pool = harness.images(harness.subseed(ctx.seed, "images"), per, geo["res"])
        texts = harness.prompts(harness.subseed(ctx.seed, "prompts"), per, wl)
        for j in range(n):
            out.append(dict(image=pool[j], prompt=texts[j],
                            draw_seed=serve_closed.batch_seed(ctx.seed, 1 + j // mb),
                            draw_batch=mb, row=j % mb))
        return out
    b = int(wl["batch"])
    for j in range(n):
        i = j // b
        imgs = harness.images(harness.subseed(ctx.seed, "images", i), b, geo["res"])
        texts = harness.prompts(harness.subseed(ctx.seed, "prompts", i), b, wl)
        out.append(dict(image=imgs[j % b], prompt=texts[j % b],
                        draw_seed=harness.subseed(ctx.seed, "draws", i),
                        draw_batch=b, row=j % b))
    return out


def readings(ctx) -> list:
    wl = ctx.workload
    if wl["driver"] == "train_steps":
        geo = harness.geometry(ctx.config, wl)
        n = int(wl["check_steps"])
        want = train_steps.reference_steps(ctx, geo, n)
        return [{"mode": mode, **train_steps.gaps(
                    train_steps.reference_steps(ctx, geo, n, **kw), want)}
                for mode, kw in (("fp8", {"lowp": True}),
                                 ("half_batch", {"half": True}))]
    n = int(wl.get("check_requests", wl.get("check_clips", 1)))
    clips = sampling_clips(ctx, n)
    want = checks.reference_clips(ctx, clips)
    low = checks.reference_clips(ctx, clips, lowp=True)
    for c, (latents, frames) in zip(clips, low):
        c.update(latents=latents, video=frames)
    return [{"mode": "fp8", **checks.gaps(clips, want)}]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    wl = harness.load_json("workloads", args.workload)
    config = harness.load_json("configs", wl["config"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        ctx = harness.Context(seed=seed, seconds=0.0, config=config,
                              workload=wl, t0=t0,
                              device=args.device)
        for row in readings(ctx):
            print(json.dumps({"workload": args.workload, "seed": seed, **row,
                              "seconds": time.monotonic() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
