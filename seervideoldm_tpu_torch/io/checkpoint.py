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


def export_state_dicts(models, weights: Optional[dict] = None) -> dict:
    """``{"unet": state_dict, "fstext": state_dict}`` on the CPU, with the
    entries named in ``weights`` (``{"unet.<name>": fp32 tensor}``, the
    masters or the EMA) taken from there instead of the modules' compute
    copies."""
    out = {}
    for key, module in models.trainable_modules().items():
        sd = {k: v.detach().cpu() for k, v in module.state_dict().items()}
        for name, t in (weights or {}).items():
            model, _, pname = name.partition(".")
            if model == key:
                sd[pname] = t.detach().cpu().clone()
        out[key] = sd
    return out


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
        drop the oldest directories beyond ``max_to_keep``."""
        path = self.path_for_step(step)
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        from ..training.lora import inference_params

        sds = inference_params(
            models, state.ema if state.ema is not None else state.masters,
            self.lora_scale)
        torch.save(sds["unet"], os.path.join(tmp, UNET_FILE))
        torch.save(sds["fstext"], os.path.join(tmp, FSTEXT_FILE))
        torch.save(_to_cpu({
            "step": state.step, "masters": state.masters, "ema": state.ema,
            "optimizer": state.optimizer.state_dict(),
        }), os.path.join(tmp, STATE_FILE))
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        if self.max_to_keep is not None:
            for _, old in _step_dirs(self.output_dir)[:-self.max_to_keep]:
                shutil.rmtree(old, ignore_errors=True)
        return path

    def restore(self, step: int, state, models) -> None:
        """Load ``train_state.pt`` of ``step`` into ``state`` in place and
        refresh the modules' compute copies.  A checkpoint without an EMA
        seeds the EMA from the restored masters; an EMA the state does not
        keep is dropped."""
        from ..training.trainer import sync_compute_copies

        saved = torch.load(os.path.join(self.path_for_step(step), STATE_FILE),
                           map_location="cpu")
        missing = set(state.masters) ^ set(saved["masters"])
        if missing:
            raise ValueError(f"checkpoint and trainer disagree on the "
                             f"trainable set, e.g. {sorted(missing)[:4]}")
        with torch.no_grad():
            for name, t in state.masters.items():
                t.copy_(saved["masters"][name])
            state.optimizer.load_state_dict(saved["optimizer"])
            if state.ema is not None:
                src = saved["ema"]
                if src is None:
                    print("resume: checkpoint has no EMA state -- seeding "
                          "the EMA from the restored weights")
                    src = saved["masters"]
                for name, t in state.ema.items():
                    t.copy_(src[name])
            elif saved["ema"] is not None:
                print("resume: dropping the checkpoint's EMA state "
                      "(ema_decay: 0)")
        state.step = int(saved["step"])
        sync_compute_copies(models)

    def latest_step(self) -> Optional[int]:
        dirs = _step_dirs(self.output_dir)
        return dirs[-1][0] if dirs else None
