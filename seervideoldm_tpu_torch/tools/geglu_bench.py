"""Time the GEGLU kernels (K3 / K4 / K5) of a checkout on one card.

    python -m seervideoldm_tpu_torch.tools.geglu_bench [--sweep] [--tree DIR]

Every shape of the checkout's ``chip_smoke.py`` ``KERNEL_CASES`` that runs
a GEGLU kernel, checked and timed by that file's own ``check_case`` (the
kernel against its plain version, their times, one library call's, the
bound), and the host time of one call of the path's wrapper
(``host_ms_per_call``: HOST_CALLS calls enqueued back to back on the host
clock, fewer than the launch queue holds, so the card does not pace
them): one ``geglu_bench`` JSON line per shape, with the card's name and
power limit.  ``--tree DIR`` does the same for another checkout, for
example an unpacked ``git archive`` of a parent commit, in a child process
whose imports resolve there, so two versions are compared in one call on
one card.  ``--sweep`` (a checkout with ``plan``) adds, at each shape, the
up kernel's time at every tiles-per-CTA count and the down kernel's at
every column tile of ``DOWN_TILES``: the data the constants of
``ops/kernels/geglu_ff.py::plan`` were fitted to.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HOST_CALLS = 100


def _sweep(mode: int, n: int, c: int, *_) -> dict:
    import torch

    import chip_smoke as cs
    from seervideoldm_tpu_torch.ops.kernels import build
    from seervideoldm_tpu_torch.ops.kernels import geglu_ff as K

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 1)
    inner = 4 * c

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)

    x, res = rnd(n, c), rnd(n, c)
    w1, b1 = rnd(2 * inner, c, scale=c ** -0.5), rnd(2 * inner, scale=0.1)
    w2, b2 = rnd(c, inner, scale=inner ** -0.5), rnd(c, scale=0.1)
    w3, b3 = rnd(c, c, scale=c ** -0.5), rnd(c, scale=0.1)
    gamma = torch.ones(c, device="cuda")
    beta = torch.zeros(c, device="cuda")
    p = K.plan(n, c, inner, mode)
    cols, stream = inner // p["up_bn"], build.stream_of(x)
    up = {t: cs.time_ms(lambda t=t: K._up_launch(
        "geglu_up", x, gamma, beta, w1, b1, mode > 0, p["up_bn"], t, stream))
        for t in range(1, cols + 1) if cols % t == 0}
    a = K.geglu_up(x, gamma, beta, w1, b1, mode > 0)
    down = {} if mode == 2 else {bn: cs.time_ms(lambda bn=bn: K._down_launch(
        "geglu_down", a, w2, b2, x, w3, b3, res, mode, bn, stream))
        for bn in K.DOWN_TILES if c % bn == 0}
    return {"plan": p, "up_ms_by_tiles": up, "down_ms_by_tile": down}


def _run(sweep: bool) -> None:
    import torch

    import chip_smoke as cs
    from seervideoldm_tpu_torch.ops.kernels import build
    from seervideoldm_tpu_torch.utils.device import set_numerics

    if not torch.cuda.is_available():
        raise SystemExit("geglu_bench: needs a CUDA device")
    set_numerics()
    build.build_all(("geglu_ff",))
    card = cs.card_line()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for path, make, args in cs.KERNEL_CASES:
        if make is not cs.case_geglu:
            continue
        case = make(gen, *args)
        row = cs.check_case(case)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            case["kernel"]()
        row["host_ms_per_call"] = (time.perf_counter() - t0) * 1e3 / HOST_CALLS
        torch.cuda.synchronize()
        row.update(path=path, card=card, tree=os.getcwd())
        if sweep:
            row["sweep"] = _sweep(*args)
        print(json.dumps({"geglu_bench": row}), flush=True)
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=None,
                        help="root of another checkout to time instead")
    parser.add_argument("--sweep", action="store_true",
                        help="also time every tile choice of the plan")
    args = parser.parse_args(argv)
    if args.tree:  # imported here: the child runs in the other checkout
        from seervideoldm_tpu_torch.tools.tree import run_in_tree

        return run_in_tree(__file__, args.tree,
                           ["--sweep"] if args.sweep else [])
    _run(args.sweep)
    return 0


if __name__ == "__main__":
    sys.exit(main())
