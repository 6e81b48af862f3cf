"""Optimizer assembly: AdamW + warmup schedule + global-norm clip +
accumulation over the trainable subset (port of
``seervideoldm_tpu/training/optim.py``).

The JAX package builds ``optax.MultiSteps(chain(clip_by_global_norm,
adamw(schedule)))`` over the trainable subtree; ``Optimizer`` below is that
chain written out, so that the two trainers stay step-for-step comparable:

- accumulation is ``optax.MultiSteps``: the running MEAN of the micro-step
  gradients (``acc + (g - acc) / (mini_step + 1)``); the inner update runs
  at the sync micro-step only, on that mean, and the schedule counts
  optimizer steps (the first update uses ``lr(0)``);
- the clip is ``optax.clip_by_global_norm``: unchanged below ``max_norm``,
  else ``g / norm * max_norm`` (no epsilon in the denominator);
- AdamW is ``optax.adamw``: bias-corrected moments, ``eps`` outside the
  root, decoupled weight decay added to the update before the learning-rate
  scaling.

Parameters are fp32 masters in a ``{name: tensor}`` dict, updated in place.
Only the reference recipe's subset trains: the UNet's
``temporal_attentions`` and all of FSText (``trainable_names``).
"""
from __future__ import annotations

import math
from typing import Callable, Mapping

import torch
import torch.nn as nn


def trainable_names(modules: Mapping[str, nn.Module],
                    scope: str = "reference") -> list[str]:
    """Names ``"<model>.<parameter>"`` of the trainable parameters of
    ``modules`` (``{"unet": ..., "fstext": ...}``).  scope 'reference': UNet
    parameters whose name contains ``temporal_attentions`` plus everything
    of FSText; scope 'all': every parameter of both."""
    if scope not in ("reference", "all"):
        raise ValueError(f"unknown trainable scope {scope!r}")
    names = []
    for key, module in modules.items():
        for name, _ in module.named_parameters():
            if (scope == "all" or key == "fstext"
                    or "temporal_attentions" in name):
                names.append(f"{key}.{name}")
    return names


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """``optax.linear_schedule``: held at ``init`` when steps <= 0."""
    def fn(count):
        if steps <= 0:
            return init
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return fn


def _join(first, second, boundary: int) -> Callable[[int], float]:
    """``optax.join_schedules`` of two schedules."""
    return lambda step: (first(step) if step < boundary
                         else second(step - boundary))


def lr_schedule(name: str, learning_rate: float, warmup_steps: int,
                total_steps: int) -> Callable[[int], float]:
    """diffusers ``get_scheduler`` shapes as the JAX package builds them from
    optax: 'cosine', 'linear', 'constant'[_with_warmup].  Maps the number of
    optimizer steps already taken to the learning rate of the next."""
    warmup = _linear(0.0, learning_rate, warmup_steps)
    # total_steps <= warmup_steps would leave a non-positive decay length
    decay_steps = max(total_steps, warmup_steps + 1) - warmup_steps
    if name == "cosine":
        def cosine(count):
            count = min(count, decay_steps)
            return learning_rate * 0.5 * (1 + math.cos(math.pi * count
                                                       / decay_steps))

        return _join(warmup, cosine, warmup_steps)
    if name == "linear":
        return _join(warmup, _linear(learning_rate, 0.0, decay_steps),
                     warmup_steps)
    if name in ("constant", "constant_with_warmup"):
        return _join(warmup, lambda count: learning_rate, warmup_steps)
    raise ValueError(f"unknown lr scheduler '{name}'")


def global_norm(tensors) -> torch.Tensor:
    """sqrt(sum of squares) over a list of tensors, an fp32 scalar tensor."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class Optimizer:
    """MultiSteps(clip_by_global_norm -> AdamW(schedule)) over fp32 masters.

    ``update(grads)`` takes one micro-step's gradients (``{name: fp32
    tensor}``, every name of ``params``), folds them into the running mean
    and, at the sync micro-step, applies one AdamW step to ``params`` in
    place.  Returns ``(did_sync, grad_norm)`` with ``grad_norm`` the global
    norm of the running-mean gradient (what the clip sees at the sync
    step).
    """

    def __init__(self, params: Mapping[str, torch.Tensor],
                 schedule: Callable[[int], float],
                 betas: tuple[float, float] = (0.9, 0.999),
                 weight_decay: float = 1e-2, eps: float = 1e-8,
                 max_grad_norm: float = 0.3, accumulation_steps: int = 1):
        self.names = list(params)
        self.params = [params[n] for n in self.names]
        self.schedule = schedule
        self.b1, self.b2 = betas
        self.weight_decay, self.eps = weight_decay, eps
        self.max_grad_norm = max_grad_norm
        self.accumulation_steps = max(1, int(accumulation_steps))
        self.count = 0      # optimizer steps taken
        self.mini_step = 0  # micro-steps into the current window
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if self.accumulation_steps > 1 else None)

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor]):
        g = [grads[n] for n in self.names]
        if self.acc is not None:
            # acc += (g - acc) / (mini_step + 1)
            diff = torch._foreach_sub(g, self.acc)
            torch._foreach_add_(self.acc, diff, alpha=1.0 / (self.mini_step + 1))
            g = self.acc
        gnorm = global_norm(g)
        self.mini_step = (self.mini_step + 1) % self.accumulation_steps
        if self.mini_step != 0:
            return False, gnorm
        # clip: unchanged below max_norm, else g / norm * max_norm
        factor = torch.where(gnorm < self.max_grad_norm,
                             torch.ones_like(gnorm),
                             self.max_grad_norm / gnorm)
        g = torch._foreach_mul(g, factor)
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, g, alpha=1 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1 - self.b2)
        lr = self.schedule(self.count)
        self.count += 1
        c1 = 1 - self.b1 ** self.count
        c2 = 1 - self.b2 ** self.count
        denom = torch._foreach_div(self.nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.mu, c1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-lr)
        if self.acc is not None:
            torch._foreach_zero_(self.acc)
        return True, gnorm

    def state_dict(self) -> dict:
        named = lambda ts: dict(zip(self.names, ts))  # noqa: E731
        return {"count": self.count, "mini_step": self.mini_step,
                "mu": named(self.mu), "nu": named(self.nu),
                "acc": named(self.acc) if self.acc is not None else None}

    def load_state_dict(self, state: Mapping) -> None:
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        for key, dst in (("mu", self.mu), ("nu", self.nu), ("acc", self.acc)):
            src = state.get(key)
            if dst is None or src is None:
                continue
            for name, t in zip(self.names, dst):
                t.copy_(src[name])


def build_optimizer(params: Mapping[str, torch.Tensor], learning_rate: float,
                    scheduler: str = "cosine", warmup_steps: int = 10000,
                    total_steps: int = 200000,
                    betas: tuple[float, float] = (0.9, 0.999),
                    weight_decay: float = 1e-2, eps: float = 1e-8,
                    max_grad_norm: float = 0.3, accumulation_steps: int = 1):
    """``(Optimizer, schedule)`` over the trainable masters ``params``."""
    schedule = lr_schedule(scheduler, learning_rate, warmup_steps, total_steps)
    return Optimizer(params, schedule, betas, weight_decay, eps, max_grad_norm,
                     accumulation_steps), schedule
