"""``seervideoldm_tpu_torch/utils/profiling.py`` on the CPU: the JAX module's
interface (``trace``, ``annotate``, ``StepTimer``, NaN checks) over
``torch.profiler`` and module hooks.  Device time (``kernel_ms``) exists
only with a card: here it is None."""
import json
import os

import pytest
import torch
import torch.nn as nn

from seervideoldm_tpu_torch.utils import profiling


def test_trace_and_annotate_write_a_named_region(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("floor_budget_region"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "floor_budget_region" in names
    assert os.path.getsize(tmp_path / "kernels.txt") > 0


def test_step_timer_summary_keys():
    timer = profiling.StepTimer(skip_first=1)
    for _ in range(3):
        with timer:
            torch.randn(32, 32).sum()
    summary = timer.summary()
    assert set(summary) == {"steps", "mean_s", "p50_s", "p95_s"}
    assert summary["steps"] == 3 and summary["mean_s"] >= 0.0


def test_kernel_ms_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: kernel_ms reads device time there")
    assert profiling.kernel_ms(lambda: torch.ones(4).sum()) is None


class _Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.first = nn.Linear(4, 4)
        self.second = nn.Linear(4, 4)

    def forward(self, x):
        return self.second(torch.log(self.first(x)))


def test_nan_checks_name_the_module_and_come_off():
    torch.manual_seed(0)
    net = _Net()
    x = torch.randn(8, 4)
    before = torch.is_anomaly_enabled()
    checks = profiling.enable_nan_checks(net)
    assert torch.is_anomaly_enabled()
    with pytest.raises(FloatingPointError, match="second"):
        net(x)   # log of negative entries: NaN enters 'second'
    profiling.disable_nan_checks(checks)
    assert torch.is_anomaly_enabled() == before
    assert not torch.isfinite(net(x)).all()   # no hook left to raise
