"""How often the kernels' elementwise checks miss, over many draws.

    python -m seervideoldm_tpu_torch.tools.miss_rate [--seeds N]
        [--case-budget S] [--only NAME,...] [--tree DIR]

Every shape of the checkout's ``chip_smoke.py`` ``KERNEL_CASES`` (K1-K9),
its inputs drawn from generator seeds 0, 1, ... instead of the committed
draw, checked as ``check_case`` checks it but not timed: bf16 outputs
within ATOL + RTOL of the plain version element by element, a backward's
dq, dk, dv also within BWD_REL_L2 in relative L2, a forward's lse within
its bound (the GEGLU halves are not run: their check times them).  Up to
``--seeds`` draws a shape, fewer when its ``--case-budget`` seconds run
out.  One ``miss_rate`` JSON line per shape: the draws run, the draws that
missed, and for the worst element over all draws its error and the bound
it had.  ``--tree DIR`` runs another checkout's kernels and cases (see
``tools/tree.py``), for a before-and-after on one card.  The committed
draws and bounds of ``chip_smoke.py`` are not touched.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time


def _check(case: dict) -> tuple:
    """(missed, worst error, its bound, worst relative L2) of one draw."""
    import torch

    import chip_smoke as cs

    got, want = case["kernel"](), case["plain"]()
    torch.cuda.synchronize()
    if not case.get("backward", False):
        got, want = (got,), (want,)
    missed, worst, worst_bound, rel_l2 = False, -math.inf, 0.0, 0.0
    for g, w in zip(got, want):
        g32, w32 = g.float(), w.float()
        err = (g32 - w32).abs()
        bound = cs.ATOL + cs.RTOL * w32.abs()
        i = int(torch.argmax(err - bound))
        if float(err.flatten()[i] - bound.flatten()[i]) > worst - worst_bound:
            worst, worst_bound = float(err.flatten()[i]), float(bound.flatten()[i])
        missed |= not bool(torch.isfinite(g).all()) or bool((err > bound).any())
        rel_l2 = max(rel_l2, float((g32 - w32).norm() / w32.norm()))
    if case.get("backward", False):
        missed |= rel_l2 > cs.BWD_REL_L2
    if "lse_err" in case:
        missed |= case["lse_err"]() > case.get("lse_atol", cs.LSE_ATOL)
    return missed, worst, worst_bound, rel_l2


def _run(seeds: int, case_budget: float, only: set) -> None:
    import torch

    import chip_smoke as cs
    from seervideoldm_tpu_torch.utils.device import set_numerics

    if not torch.cuda.is_available():
        raise SystemExit("miss_rate: needs a CUDA device")
    set_numerics()
    card = cs.card_line()
    for path, make, args in cs.KERNEL_CASES:
        t0, runs, misses, row = time.perf_counter(), 0, [], None
        for seed in range(seeds):
            case = make(torch.Generator(device="cuda").manual_seed(seed), *args)
            if only and case["name"] not in only:
                break
            missed, err, bound, rel_l2 = _check(case)
            runs += 1
            if missed:
                misses.append(seed)
            if row is None or err - bound > row["worst_err"] - row["worst_bound"]:
                row = dict(worst_err=err, worst_bound=bound, worst_seed=seed)
            row["max_rel_l2"] = max(row.get("max_rel_l2", 0.0), rel_l2)
            row.update(name=case["name"], shape=case["shape"])
            del case
            if time.perf_counter() - t0 > case_budget:
                break
        torch.cuda.empty_cache()
        if runs:
            row.update(path=path, draws=runs, misses=len(misses),
                       missed_seeds=misses[:20], card=card, tree=os.getcwd())
            print(json.dumps({"miss_rate": row}), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=200)
    parser.add_argument("--case-budget", type=float, default=8.0,
                        help="seconds of draws a shape at most")
    parser.add_argument("--only", default="",
                        help="comma-separated kernel names (default: all)")
    parser.add_argument("--tree", default=None,
                        help="root of another checkout to run instead")
    args = parser.parse_args(argv)
    if args.tree:  # imported here: the child runs in the other checkout
        from seervideoldm_tpu_torch.tools.tree import run_in_tree

        return run_in_tree(__file__, args.tree, [
            "--seeds", str(args.seeds), "--case-budget", str(args.case_budget),
            "--only", args.only])
    _run(args.seeds, args.case_budget, {n for n in args.only.split(",") if n})
    return 0


if __name__ == "__main__":
    sys.exit(main())
