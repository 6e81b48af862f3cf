"""The fp8 control's readings in the SVD cell (``drivers/svd_sample.py``:
the reference computed with every matmul and convolution input rounded to
float8 e4m3, ``reference/lowp_svd.py``, against the fp32 reference, on the
first clip a run of the cell would check), which set the upper end of
each limit of ``correct``; the benchmark's runs never run this.

    python3 -m seerbench.control_svd --workload svd-xt.sample.576 --seeds 11,12

One JSON line per seed.  On a card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import time

from seerbench import harness
from seerbench.drivers import svd_sample


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="svd-xt.sample.576")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    wl = harness.load_json("workloads", args.workload)
    config = harness.load_json("configs", wl["config"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        ctx = harness.Context(seed=seed, seconds=0.0, config=config,
                              workload=wl, t0=t0, device=args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "mode": "fp8", **svd_sample.control(ctx),
                          "seconds": time.monotonic() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
