"""The ``train`` entry's logs (``training/logs.py``) on the CPU: the
TensorBoard scalars and the loss / lr PNGs the JAX entry writes.

- 4 optimizer steps at toy scale (save every 2): the event file under
  ``output_dir/logging_dir`` holds ``loss``, ``lr`` and ``grad_norm`` at
  every optimizer step 1..4, as the JAX entry adds them; ``lr`` equals the
  JAX package's schedule (``training/optim.build_optimizer``) at those
  steps, ``loss`` the first value the meters saw, ``grad_norm`` finite
  and positive; ``loss.png`` and ``lr.png`` are written (matplotlib
  imports here);
- where matplotlib does not import, plotting prints the JAX entry's
  ``plot_graphs failed: ...`` line and returns.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from seervideoldm_tpu.training import optim as joptim

from test_torch_train_entry import _train_cfg


def _scalars(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)

    acc = EventAccumulator(log_dir)
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_train_entry_writes_scalars_and_plots(tmp_path):
    from seervideoldm_tpu_torch.train import train

    cfg, _ = _train_cfg(tmp_path, max_train_steps=4, save_steps=2,
                        gradient_accumulation_steps=1, lr_warmup_steps=2,
                        lr_scheduler="cosine")
    summary = train(dict(cfg), device="cpu")
    log_dir = os.path.join(cfg["output_dir"], "logs")
    scalars = _scalars(log_dir)
    assert set(scalars) == {"loss", "lr", "grad_norm"}
    for tag, rows in scalars.items():
        assert [s for s, _ in rows] == [1, 2, 3, 4], tag
    _, schedule = joptim.build_optimizer(
        {"w": jnp.zeros(2)}, cfg["learning_rate"], scheduler="cosine",
        warmup_steps=2, total_steps=4)
    np.testing.assert_allclose([v for _, v in scalars["lr"]],
                               [float(schedule(s)) for s in (1, 2, 3, 4)],
                               rtol=1e-6)
    assert scalars["loss"][0][1] == pytest.approx(summary["losses"][0],
                                                  rel=1e-6)
    assert all(np.isfinite(v) and v > 0 for _, v in scalars["grad_norm"])
    for name in ("loss.png", "lr.png"):
        path = os.path.join(cfg["output_dir"], name)
        assert os.path.getsize(path) > 0, name


def test_plots_are_never_fatal(tmp_path, monkeypatch, capsys):
    from seervideoldm_tpu_torch.training import logs
    from seervideoldm_tpu_torch.training.meters import RunningAverageMeter

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    meter = RunningAverageMeter(0.99)
    meter.update(1.0, 1)
    logs.plot_graphs(meter, meter, str(tmp_path))
    assert "plot_graphs failed:" in capsys.readouterr().out
    assert not os.listdir(tmp_path)
