"""Start N ranks of one function on this host (``torch.multiprocessing``,
spawn), with a timeout: what ``torchrun --nproc_per_node N`` does for the
entry points, for the tests and the chip smoke.

``run(fn, nprocs, args)`` calls ``fn(rank, *args)`` in every rank after the
process group is up (``distributed.initialize_distributed``: torchrun's
variables are set, the rendezvous is a ``file://`` path in a fresh
temporary directory, so concurrent launches never collide) and returns the
ranks' return values in rank order.  A rank that raises, dies or outlives
``timeout`` seconds fails the launch: every rank is then stopped and
``RuntimeError`` carries the tracebacks.  ``fn`` must be importable by
module path (spawn pickles it by name) and return picklable values.
"""
from __future__ import annotations

import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch.multiprocessing as mp


def _worker(fn, rank, nprocs, init_method, backend, device, threads, args,
            results):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(nprocs),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(nprocs))
    try:
        import torch

        from .distributed import initialize_distributed, shutdown

        if threads:
            torch.set_num_threads(threads)
        initialize_distributed(device, init_method=init_method,
                               backend=backend)
        out = fn(rank, *args)
        shutdown()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 -- relayed to the launcher
        results.put((rank, False, traceback.format_exc()))


def run(fn: Callable, nprocs: int, args: tuple = (), backend: Optional[str] = None,
        device: Optional[str] = None, timeout: float = 600.0,
        threads: int = 0) -> list:
    """``[fn(0, *args), ..., fn(nprocs - 1, *args)]``, one process per rank.
    ``backend`` None picks NCCL or gloo from the card count
    (``distributed.pick_backend``); ``device`` 'cpu' keeps the ranks off the
    card; ``threads`` > 0 sets each rank's intra-op thread count."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="svl_rendezvous_")
    init_method = "file://" + os.path.join(tmp, "store")
    results = ctx.Queue()
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(fn, r, nprocs, init_method, backend, device,
                               threads, args, results))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    outs, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(outs) + len(errors) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                errors.append(f"timed out after {timeout:.0f} s with ranks "
                              f"{sorted(set(range(nprocs)) - set(outs))} "
                              "unfinished")
                break
            try:
                rank, ok, value = results.get(timeout=min(left, 5.0))
            except queue_mod.Empty:
                dead = [i for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in outs]
                if dead:
                    errors.append(f"ranks {dead} died (exit codes "
                                  f"{[procs[i].exitcode for i in dead]})")
                    break
                continue
            if ok:
                outs[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
    finally:
        for p in procs:
            if errors:
                p.terminate()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError("parallel launch failed: " + "\n".join(errors))
    return [outs[r] for r in range(nprocs)]
