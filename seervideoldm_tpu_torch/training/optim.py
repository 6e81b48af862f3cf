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

Parameters are masters in a ``{name: tensor}`` dict (fp32, or bf16 under
``param_dtype: bfloat16``, the moments then bf16 too, as optax keeps them
in the parameters' dtype), updated in place.  Only the reference recipe's
subset trains: the UNet's ``temporal_attentions`` and all of FSText
(``trainable_names``); under LoRA, FSText and the adapters.  With
``use_8bit`` the moments are blockwise int8 (``optim8bit.py``).
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


def bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` in fp32, as optax forms it (an fp32 power of
    the weak-typed decay; held in a double that the divisions round back to
    the same fp32 value)."""
    f32 = torch.float32
    return float(1 - torch.tensor(decay, dtype=f32)
                 ** torch.tensor(float(count), dtype=f32))


class AdamMoments:
    """``optax.scale_by_adam``: the moments in the parameters' dtype.
    ``step(grads, count)`` folds one (clipped) gradient per leaf into them
    and returns the bias-corrected directions ``m_hat / (sqrt(v_hat) +
    eps)``."""

    def __init__(self, params: list, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, g: list, count: int) -> list:
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, g, alpha=1 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1 - self.b2)
        c1 = bias_correction(self.b1, count)
        c2 = bias_correction(self.b2, count)
        denom = torch._foreach_div(self.nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.mu, c1)
        torch._foreach_div_(upd, denom)
        return upd

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.mu + self.nu)

    def state_dict(self, names: list) -> dict:
        return {"mu": dict(zip(names, self.mu)), "nu": dict(zip(names, self.nu))}

    def load_state_dict(self, state: Mapping, names: list) -> None:
        for key, dst in (("mu", self.mu), ("nu", self.nu)):
            for name, t in zip(names, dst):
                t.copy_(state[key][name])


class Optimizer:
    """MultiSteps(clip_by_global_norm -> AdamW(schedule)) over the masters.

    ``update(grads)`` takes one micro-step's gradients (``{name: fp32
    tensor}``, every name of ``params``), folds them into the running mean
    and, at the sync micro-step, applies one AdamW step to ``params`` in
    place.  Returns ``(did_sync, grad_norm)`` with ``grad_norm`` the global
    norm of the running-mean gradient (what the clip sees at the sync
    step).  A gradient is taken in its master's dtype.  ``use_8bit``:
    the moments are ``optim8bit.Adam8bitMoments``.  ``norm_fn`` replaces
    ``global_norm`` (the sharded state's norm sums over the ranks; under a
    ``model`` axis a split gradient's squares are summed over the model
    ranks and a replicated one's counted once,
    ``TensorParallel.global_norm_fn``).
    """

    def __init__(self, params: Mapping[str, torch.Tensor],
                 schedule: Callable[[int], float],
                 betas: tuple[float, float] = (0.9, 0.999),
                 weight_decay: float = 1e-2, eps: float = 1e-8,
                 max_grad_norm: float = 0.3, accumulation_steps: int = 1,
                 use_8bit: bool = False, norm_fn: Callable = None):
        self.names = list(params)
        self.norm_fn = norm_fn or global_norm
        self.params = [params[n] for n in self.names]
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.accumulation_steps = max(1, int(accumulation_steps))
        self.count = 0      # optimizer steps taken
        self.mini_step = 0  # micro-steps into the current window
        if use_8bit:
            from .optim8bit import Adam8bitMoments

            self.moments = Adam8bitMoments(self.params, *betas, eps)
        else:
            self.moments = AdamMoments(self.params, *betas, eps)
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if self.accumulation_steps > 1 else None)

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor]):
        g = [grads[n].to(p.dtype) for n, p in zip(self.names, self.params)]
        if self.acc is not None:
            # acc += (g - acc) / (mini_step + 1)
            diff = torch._foreach_sub(g, self.acc)
            torch._foreach_add_(self.acc, diff, alpha=1.0 / (self.mini_step + 1))
            g = self.acc
        gnorm = self.norm_fn(g)
        self.mini_step = (self.mini_step + 1) % self.accumulation_steps
        if self.mini_step != 0:
            return False, gnorm
        # clip: unchanged below max_norm, else g / norm * max_norm
        factor = torch.where(gnorm < self.max_grad_norm,
                             torch.ones_like(gnorm),
                             self.max_grad_norm / gnorm)
        g = torch._foreach_mul(g, factor)
        lr = self.schedule(self.count)
        self.count += 1
        upd = self.moments.step(g, self.count)
        torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-lr)
        if self.acc is not None:
            torch._foreach_zero_(self.acc)
        return True, gnorm

    def state_bytes(self) -> int:
        """Bytes of the Adam moments (the accumulator not counted)."""
        return self.moments.nbytes()

    def acc_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.acc or [])

    def state_dict(self) -> dict:
        return {"count": self.count, "mini_step": self.mini_step,
                **self.moments.state_dict(self.names),
                "acc": (dict(zip(self.names, self.acc))
                        if self.acc is not None else None)}

    def load_state_dict(self, state: Mapping) -> None:
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        self.moments.load_state_dict(state, self.names)
        if self.acc is not None and state.get("acc") is not None:
            for name, t in zip(self.names, self.acc):
                t.copy_(state["acc"][name])


def build_optimizer(params: Mapping[str, torch.Tensor], learning_rate: float,
                    scheduler: str = "cosine", warmup_steps: int = 10000,
                    total_steps: int = 200000,
                    betas: tuple[float, float] = (0.9, 0.999),
                    weight_decay: float = 1e-2, eps: float = 1e-8,
                    max_grad_norm: float = 0.3, accumulation_steps: int = 1,
                    use_8bit: bool = False, norm_fn: Callable = None):
    """``(Optimizer, schedule)`` over the trainable masters ``params``;
    ``use_8bit``: the reference's ``use_8bit_adam``, int8 blockwise
    moments (``optim8bit.adamw_8bit``); ``norm_fn``: the clip's norm
    (``parallel.sharding.ShardPlan.global_norm`` over shards)."""
    schedule = lr_schedule(scheduler, learning_rate, warmup_steps, total_steps)
    return Optimizer(params, schedule, betas, weight_decay, eps, max_grad_norm,
                     accumulation_steps, use_8bit=use_8bit,
                     norm_fn=norm_fn), schedule
