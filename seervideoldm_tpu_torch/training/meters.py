"""Metric meters (the port's copy of ``seervideoldm_tpu/training/meters.py``,
reference ``RunningAverageMeter``): an exponential running average with its
full history, checkpointed in the JSON sidecar of every save.
"""
from __future__ import annotations


class RunningAverageMeter:
    """Exponential running average with recorded history."""

    def __init__(self, momentum: float = 0.99):
        self.momentum = momentum
        self.vals: list[float] = []
        self.steps: list[int] = []
        self.val: float | None = None
        self.avg: float = 0.0

    def reset(self) -> None:
        self.val = None
        self.avg = 0.0
        self.vals = []
        self.steps = []

    def update(self, value: float, step: int) -> None:
        value = float(value)
        if self.val is None:
            self.avg = value
        else:
            self.avg = self.avg * self.momentum + value * (1 - self.momentum)
        self.val = value
        self.vals.append(self.avg)
        self.steps.append(int(step))

    def ckpt(self) -> dict:
        return {"momentum": self.momentum, "vals": self.vals,
                "steps": self.steps, "val": self.val, "avg": self.avg}

    def load_ckpt(self, state: dict) -> None:
        self.momentum = state["momentum"]
        self.vals = list(state["vals"])
        self.steps = list(state["steps"])
        self.val = state["val"]
        self.avg = state["avg"]
