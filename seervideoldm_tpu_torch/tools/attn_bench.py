"""Time the attention kernels (K1, K2, K6, K7, K8, K9) of a checkout on one
card.

    python -m seervideoldm_tpu_torch.tools.attn_bench [--sweep] [--tree DIR]

Every shape of the checkout's ``chip_smoke.py`` ``KERNEL_CASES`` that runs
an attention kernel, checked and timed by that file's own ``check_case``
(the kernel against its plain version, their times, one library call's,
the bound), and the host time of one call of the path's wrapper
(``host_ms_per_call``: HOST_CALLS calls enqueued back to back on the host
clock, fewer than the launch queue holds, so the card does not pace
them): one ``attn_bench`` JSON line per shape, with the card's name and
power limit.  ``--tree DIR`` does the same for another checkout, for
example an unpacked ``git archive`` of a parent commit, in a child process
whose imports resolve there (``tools/tree.py``), so two versions are
compared in one call on one card.  ``--sweep`` (a checkout with the
forward kernels' ``cwg_choices`` and the backward's ``bwd_plan``) adds, at
each forward shape, the kernel's time with every count of consumer
warpgroups its head dim has, and at each backward shape its time with
every choice the backward plan has (the dq kernel's consumer warpgroups
and the dk/dv kernel's): the data the plans' order was chosen from.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HOST_CALLS = 100
ATTENTION_CASES = ("case_swat", "case_flash", "case_swat6", "case_swat_bwd",
                   "case_flash_bwd", "case_swat6_bwd")


def _sweep(make_name: str, args: tuple) -> dict:
    """The forward kernel's time with every consumer-warpgroup count of its
    head dim, on inputs from their own generator."""
    import torch

    import chip_smoke as cs
    from seervideoldm_tpu_torch.ops.kernels import flash_attention as F
    from seervideoldm_tpu_torch.ops.kernels import swat_attention as S
    from seervideoldm_tpu_torch.ops.rotary import rotary_tables

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 1)
    rnd = lambda *shape: torch.randn(  # noqa: E731
        shape, generator=gen, device="cuda").to(torch.bfloat16)
    if make_name == "case_flash":
        batch, n, d = args[:3]
        causal = len(args) > 3 and args[3]
        q, k, v = rnd(batch, n, d), rnd(batch, n, d), rnd(batch, n, d)
        call = lambda c: F._launch_fwd(q, k, v, d ** -0.5, causal,  # noqa: E731
                                       False, c)
    else:
        batch, f, h, d = args[:4]
        q, k, v = (rnd(batch, f, h, h, d) for _ in range(3))
        if make_name == "case_swat":
            cos, sin = rotary_tables(f, h, h, d, min(32, d), device="cuda")
            call = lambda c: S._launch_fwd(  # noqa: E731
                q, k, v, cos, sin, d ** -0.5, True, 8, False, c)
        else:
            call = lambda c: S._launch_swat_fwd(  # noqa: E731
                q, k, v, d ** -0.5, True, 8, args[4], False, c)
    return {f"cwg {c}": cs.time_ms(lambda c=c: call(c))
            for c in F.cwg_choices(d)}


def _sweep_bwd(case: dict) -> dict:
    """The backward's time with every (dq warpgroups, dk/dv warpgroups)
    its plan offers at the case's head dim, on the case's own inputs
    (``case["kernel_with"]``)."""
    import chip_smoke as cs
    from seervideoldm_tpu_torch.ops.kernels import flash_attention as F

    d = case["head_dim"]
    return {f"dq {c_dq}, dkv {c_kv}": cs.time_ms(
                lambda c=(c_dq, c_kv): case["kernel_with"](c))
            for c_dq in F.bwd_cwg_choices(d, False)
            for c_kv in F.bwd_cwg_choices(d, True)}


def _run(sweep: bool) -> None:
    import torch

    import chip_smoke as cs
    from seervideoldm_tpu_torch.ops.kernels import build
    from seervideoldm_tpu_torch.utils.device import set_numerics

    if not torch.cuda.is_available():
        raise SystemExit("attn_bench: needs a CUDA device")
    set_numerics()
    build.build_all(("flash_attention", "swat_attention"))
    card = cs.card_line()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for path, make, args in cs.KERNEL_CASES:
        if make.__name__ not in ATTENTION_CASES:
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
        if sweep and case.get("backward"):
            row["sweep"] = _sweep_bwd(case)
        elif sweep:
            row["sweep"] = _sweep(make.__name__, args)
        print(json.dumps({"attn_bench": row}), flush=True)
        del case
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=None,
                        help="root of another checkout to time instead")
    parser.add_argument("--sweep", action="store_true",
                        help="also time every choice of the forward and "
                             "backward kernels' plans")
    args = parser.parse_args(argv)
    if args.tree:  # imported here: the child runs in the other checkout
        from seervideoldm_tpu_torch.tools.tree import run_in_tree

        return run_in_tree(__file__, args.tree,
                           ["--sweep"] if args.sweep else [])
    _run(args.sweep)
    return 0


if __name__ == "__main__":
    sys.exit(main())
