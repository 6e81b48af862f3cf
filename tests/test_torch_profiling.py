"""``seervideoldm_tpu_torch/utils/profiling.py`` on the CPU: ``trace`` with a
``span`` inside it, and the NaN checks, over ``torch.profiler`` and module
hooks.  Device time (``kernel_ms``) exists only with a card: here it is
None.  The tracer itself: ``test_torch_tracing.py``."""
import json
import os

import pytest
import torch
import torch.nn as nn

from seervideoldm_tpu_torch.utils import profiling


def test_trace_and_annotate_write_a_named_region(tmp_path):
    """A ``span`` inside ``trace`` is a named region of the trace (and a
    record of the tracer); the kernel table and the idle gaps are
    written beside it."""
    profiling.reset()
    with profiling.trace(str(tmp_path)):
        with profiling.span("pipe.floor_budget_region"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "pipe.floor_budget_region" in names
    assert [s["name"] for s in profiling.spans()] == ["pipe.floor_budget_region"]
    assert os.path.getsize(tmp_path / "kernels.txt") > 0
    assert (tmp_path / "idle.txt").is_file()
    profiling.reset()


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
