"""Training checkpoints in the reference's directory convention (port of
``seervideoldm_tpu/io/checkpoint.py`` with the two-file layout of
``seervideoldm_tpu/io/export.py::export_reference_checkpoint``).

``<output_dir>/learned_sdunet-steps-<N>/`` holds

- ``pytorch_model.bin``: the SeerUNet ``state_dict`` and
- ``pytorch_model_1.bin``: the FSText ``state_dict``, under the reference's
  names (the port's modules carry them already), frozen weights as the
  trainer holds them and trained weights from the masters -- or from the
  EMA when it is on; under LoRA the adapters' delta merged into the UNet:
  this is the inference artifact, which every sampling entry loads
  strictly;
- ``train_state.pt``: micro-step count, masters (the adapters' included),
  Adam moments (int8 codes and scales under ``use_8bit_adam``) and
  accumulator, EMA -- what a resume needs.

The JSON sidecar with the meters (``learned_sdunet-steps-<N>.json``) is
written by the train loop beside the directory.

Under ``zero1`` / ``fsdp`` (``models.sharding``) every rank calls ``save``
and ``restore``: the shards are gathered to rank 0 one group at a time and
moved to its host (``ShardPlan.to_names`` and co.), and rank 0 writes the
same files under the same keys as an unsharded run; a restore takes each
rank's shards of them, so a checkpoint resumes on any number of ranks.
Both go through one route (``_names``, ``_load``), the identity on
unsharded state.

Under a ``model`` axis (``models.tensor_parallel``) every rank calls
``save`` as well: each split tensor -- masters, EMA, moments, accumulator
and the modules' own split weights -- is gathered to rank 0 along its split
dimension (``TensorParallel.gather_dict``), so the files hold the keys and
shapes of a single-rank save; a restore cuts each rank's slices from the
whole tensors (``TensorParallel.local_dict``).  8-bit moments are saved in
the whole leaves' blocks (``TensorParallel.gather_q`` / ``local_q``).
Under both a plan and a ``model`` axis the save streams in two stages,
one group or unit at a time: the shards are gathered to data rank 0 of
each model index on the host, then the parts are joined over the model
ranks on the host of rank 0 (``ShardPlan._join``); a restore cuts the
slices, then the shards.  No rank holds the whole unsharded state on the
card.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Optional

import torch

UNET_FILE = "pytorch_model.bin"
FSTEXT_FILE = "pytorch_model_1.bin"
STATE_FILE = "train_state.pt"


def _step_dirs(output_dir: str) -> list[tuple[int, str]]:
    if not os.path.isdir(output_dir):
        return []
    out = []
    for name in os.listdir(output_dir):
        m = re.fullmatch(r"learned_sdunet-steps-(\d+)", name)
        if m and os.path.isdir(os.path.join(output_dir, name)):
            out.append((int(m.group(1)), os.path.join(output_dir, name)))
    return sorted(out)


def export_state_dicts(models, weights: Optional[dict] = None,
                       base: Optional[dict] = None) -> dict:
    """``{"unet": state_dict, "fstext": state_dict}`` on the CPU, with the
    entries named in ``weights`` (``{"unet.<name>": fp32 tensor}``, the
    masters or the EMA) taken from there instead of the modules' compute
    copies, and those named in ``base`` (the same keys; the whole weights
    of modules that hold shards) over the modules' own."""
    out = {}
    for key, module in models.trainable_modules().items():
        sd = {k: v.detach().cpu() for k, v in module.state_dict().items()}
        for name, t in [*(base or {}).items(), *(weights or {}).items()]:
            model, _, pname = name.partition(".")
            if model == key:
                sd[pname] = t.detach().cpu().clone()
        out[key] = sd
    return out


def _load(plan, tensors: dict, whole: dict) -> None:
    """``whole`` (by name) into the state ``tensors`` in place."""
    if plan is not None:
        plan.load_names(tensors, whole)
        return
    for name, t in tensors.items():
        t.copy_(whole[name])


def _local_shapes(plan, state) -> dict:
    """``{name: shape}`` of this rank's trainable tensors."""
    if plan is None:
        return {n: tuple(t.shape) for n, t in state.masters.items()}
    return {n: s for layout in plan.layouts.values()
            for n, s in zip(layout.names, layout.shapes)}


def _to_cpu(obj):
    """``obj`` with every tensor (in nested dicts) detached onto the CPU."""
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    return obj


class CheckpointManager:
    """Save / restore of the train state keyed by optimizer step.
    ``lora_scale`` > 0: the weight files hold the adapters' delta merged
    into the UNet (``training.lora.inference_params``)."""

    def __init__(self, output_dir: str, max_to_keep: Optional[int] = None,
                 lora_scale: float = 0.0):
        self.output_dir = os.path.abspath(output_dir)
        os.makedirs(self.output_dir, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.lora_scale = lora_scale

    def path_for_step(self, step: int) -> str:
        return os.path.join(self.output_dir, f"learned_sdunet-steps-{step}")

    def save(self, step: int, state, models) -> str:
        """Write the step's directory (the two weight files with the EMA
        weights when the state has an EMA, and ``train_state.pt``), then
        drop the oldest directories beyond ``max_to_keep``.  Under a
        sharded state or a ``model`` axis every rank calls it and rank 0
        writes."""
        from ..parallel.distributed import is_main_process

        plan, tp = models.sharding, models.tensor_parallel
        path = self.path_for_step(step)
        if plan is not None:
            # the two stages (shards over data, then parts over model)
            masters = plan.to_names(state.masters)
            ema = plan.to_names(state.ema) if state.ema is not None else None
            optimizer = plan.optimizer_state(state.optimizer)
            base = (plan.module_weights() if plan.units
                    else tp.module_weights(models) if tp is not None
                    else None)
        elif tp is not None:
            masters = tp.gather_dict(state.masters)
            ema = tp.gather_dict(state.ema)
            optimizer = tp.gather_optimizer(state.optimizer.state_dict(),
                                            _local_shapes(plan, state))
            base = tp.module_weights(models)
        else:
            masters, ema = _to_cpu(state.masters), _to_cpu(state.ema)
            optimizer, base = _to_cpu(state.optimizer.state_dict()), None
        if (plan is None and tp is None) or is_main_process():
            # under a mesh with ``seq`` each seq line's data rank 0 holds
            # the gathered state; the first rank alone writes it
            self._write(path, state.step, masters, ema, optimizer, models,
                        base)
        return path

    def _write(self, path: str, step: int, masters: dict,
               ema: Optional[dict], optimizer: dict, models,
               base: Optional[dict]) -> None:
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        from ..training.lora import inference_params

        sds = inference_params(models, ema if ema is not None else masters,
                               self.lora_scale, base)
        torch.save(sds["unet"], os.path.join(tmp, UNET_FILE))
        torch.save(sds["fstext"], os.path.join(tmp, FSTEXT_FILE))
        torch.save({"step": step, "masters": masters, "ema": ema,
                    "optimizer": optimizer}, os.path.join(tmp, STATE_FILE))
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        if self.max_to_keep is not None:
            for _, old in _step_dirs(self.output_dir)[:-self.max_to_keep]:
                shutil.rmtree(old, ignore_errors=True)

    def restore(self, step: int, state, models) -> None:
        """Load ``train_state.pt`` of ``step`` into ``state`` in place and
        refresh the modules' compute copies.  A checkpoint without an EMA
        seeds the EMA from the restored masters; an EMA the state does not
        keep is dropped."""
        from ..training.trainer import sync_compute_copies

        saved = torch.load(os.path.join(self.path_for_step(step), STATE_FILE),
                           map_location="cpu")
        plan, tp = models.sharding, models.tensor_parallel
        if tp is not None:
            # this rank's slices of the whole tensors (then, under a plan,
            # its shards of those)
            saved["masters"] = tp.local_dict(saved["masters"])
            saved["ema"] = tp.local_dict(saved["ema"])
            saved["optimizer"] = tp.local_optimizer(
                saved["optimizer"], _local_shapes(plan, state))
        names = (set(state.masters) if plan is None else
                 {n for layout in plan.layouts.values() for n in layout.names})
        missing = names ^ set(saved["masters"])
        if missing:
            raise ValueError(f"checkpoint and trainer disagree on the "
                             f"trainable set, e.g. {sorted(missing)[:4]}")
        ema_src = saved["ema"]
        if state.ema is not None and ema_src is None:
            print("resume: checkpoint has no EMA state -- seeding the EMA "
                  "from the restored weights")
            ema_src = saved["masters"]
        elif state.ema is None and ema_src is not None:
            print("resume: dropping the checkpoint's EMA state "
                  "(ema_decay: 0)")
        with torch.no_grad():
            _load(plan, state.masters, saved["masters"])
            if state.ema is not None:
                _load(plan, state.ema, ema_src)
            if plan is None:
                state.optimizer.load_state_dict(saved["optimizer"])
            else:
                plan.load_optimizer_state(state.optimizer, saved["optimizer"])
        state.step = int(saved["step"])
        if plan is not None:
            plan.after_step(models)
        else:
            sync_compute_copies(models)

    def latest_step(self) -> Optional[int]:
        dirs = _step_dirs(self.output_dir)
        return dirs[-1][0] if dirs else None
