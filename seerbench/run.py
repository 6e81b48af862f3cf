"""One run of one cell of the benchmark of the PyTorch / CUDA port.

    python3 -m seerbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's workload file
(``seerbench/workloads/<cell>.json``) names its configuration
(``seerbench/configs/<config>.json``) and its driver
(``seerbench/drivers/<driver>.py``); each per-layer metric is read by
``seerbench/metrics/<metric>.py``.  ``BENCHMARK.json`` at the root says
which metrics the cell reports.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit); the same numbers end standard error.  The run exits non-zero,
printing no result, when the port cannot be imported, when CUDA or the
cell's cards are missing, or when a module of JAX or of the JAX package
is loaded once the window has closed.
"""
from __future__ import annotations

import time

T0 = time.monotonic()  # as near the process start as Python gets

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "seerbench"
# top-level module names the process must not hold, compared whole: the
# port's own name begins with the JAX package's
BANNED = ("jax", "jaxlib", "flax", "seervideoldm_tpu")


def banned_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(BANNED))


def load_module(kind: str, name: str):
    """``seerbench/<kind>/<name>.py`` as a module."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"seerbench_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cache_dirs() -> None:
    """Kernel and compiler caches at fixed paths inside the checkout (the
    port builds its CUDA libraries into its own ``_build/``, also inside
    the checkout); no library may load JAX on its own."""
    cache = ROOT / ".seerbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def cell_metrics(manifest: dict, cell: str, group: str) -> list:
    return [m for m in manifest[group]
            if "workloads" not in m or cell in m["workloads"]]


def fail(msg: str, code: int) -> int:
    print(f"seerbench: {msg}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        return fail(f"no cell {args.workload!r} in BENCHMARK.json", 2)
    cell = cells[args.workload]
    try:
        import torch

        import seervideoldm_tpu_torch  # noqa: F401 -- the program under test
    except ImportError as exc:
        return fail(f"the program under test cannot be imported: {exc}", 2)
    if not torch.cuda.is_available():
        return fail("CUDA is not available", 3)
    if torch.cuda.device_count() < int(cell["chips"]):
        return fail(f"{cell['chips']} cards needed, "
                    f"{torch.cuda.device_count()} present", 3)

    from seerbench import harness
    from seerbench.probe import Probe

    workload = harness.load_json("workloads", args.workload)
    config = harness.load_json("configs", workload["config"])
    driver = load_module("drivers", workload["driver"])
    torch.cuda.set_device(0)
    ctx = harness.Context(seed=args.seed, seconds=args.seconds, config=config,
                          workload=workload, t0=T0,
                          probe=Probe() if args.trace else None)
    result = driver.run(ctx)
    found = banned_modules()
    if found:
        return fail(f"modules of JAX or the JAX package were loaded: {found}", 4)

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(cell["chips"]),
              "memory_peak_bytes": int(result.memory_peak_bytes)}
    metrics, out = {}, {}
    if args.trace:
        trace = result.record.get("trace")
        if trace is None:
            return fail("the window held no profiled unit: lengthen --seconds", 5)
        device.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
        for m in cell_metrics(manifest, args.workload, "per_layer"):
            value = load_module("metrics", m["name"]).read(result.record)
            if value is None or not math.isfinite(value):
                return fail(f"per-layer metric {m['name']} found nothing to "
                            "read in this cell", 6)
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        out["breakdown"] = {"device_ops": trace["device_ops"],
                            "idle_gaps": trace["idle_gaps"]}
    else:
        for m in cell_metrics(manifest, args.workload, "end_to_end"):
            metrics[m["name"]] = {"value": float(result.e2e[m["name"]]),
                                  "unit": m["unit"]}
    line = {"correct": result.correct, "attempted": int(result.attempted),
            "failed": int(result.failed), "metrics": metrics, "device": device}
    line.update(out)
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in result.checks}
    print(f"seerbench: run took {time.monotonic() - T0:.1f} s", file=sys.stderr)
    for c in result.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
