"""The train entry's logs (port of the root ``train.py``'s TensorBoard
writer and ``_plot_series`` / ``plot_graphs`` / ``plot_graphs_async``).

- ``open_writer``: a ``torch.utils.tensorboard.SummaryWriter`` on
  ``<output_dir>/<logging_dir>``, or None where TensorBoard does not
  import (the JAX entry's ``tensorboardX`` writer, the same event files);
  the entry adds ``loss``, ``lr`` and ``grad_norm`` at every optimizer
  step when it fetches the step's device scalars;
- ``loss.png`` / ``lr.png`` of the meters' series at each save, rendered
  off the train thread (at most one render at a time; a request while one
  runs is dropped) and never fatal: where matplotlib does not import or
  the render fails, the entry prints ``plot_graphs failed: ...`` and goes
  on.
"""
from __future__ import annotations

import os
import threading
from typing import Optional


def open_writer(log_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(log_dir)
    except Exception:  # noqa: BLE001 -- logging must never stop training
        return None


def _plot_series(series, output_dir: str) -> None:
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        for steps, vals, name in series:
            if not vals:
                continue
            plt.figure()
            plt.plot(steps, vals)
            plt.xlabel("step")
            plt.ylabel(name)
            plt.savefig(os.path.join(output_dir, f"{name}.png"))
            plt.close()
    except Exception as exc:  # noqa: BLE001 -- plotting must never kill training
        print(f"plot_graphs failed: {exc}")


def _snapshot(losses, lrs) -> list:
    # copied on the caller's thread: the loop keeps appending meanwhile
    return [(list(m.steps), list(m.vals), name)
            for m, name in ((losses, "loss"), (lrs, "lr"))]


def plot_graphs(losses, lrs, output_dir: str) -> None:
    """The loss / lr PNGs, on this thread."""
    _plot_series(_snapshot(losses, lrs), output_dir)


_busy = threading.Lock()
_thread: Optional[threading.Thread] = None


def plot_graphs_async(losses, lrs, output_dir: str) -> None:
    """The loss / lr PNGs on a daemon thread; dropped while one renders."""
    global _thread
    snap = _snapshot(losses, lrs)
    if not _busy.acquire(blocking=False):
        return

    def work() -> None:
        try:
            _plot_series(snap, output_dir)
        finally:
            _busy.release()

    _thread = threading.Thread(target=work, daemon=True, name="plot_graphs")
    _thread.start()


def wait_for_plots(timeout: float = 60.0) -> None:
    """Let a render in flight finish (the end of a run)."""
    if _thread is not None:
        _thread.join(timeout)
