"""The port's import boundary and device default.

- every module of ``seervideoldm_tpu_torch`` (the training slice's
  included: ``train``, ``training/``, ``data/``, ``io/checkpoint``,
  ``diffusion/ddpm``; the parallel slice's: ``parallel/``, ``ops/ring``;
  the floor-budget slice's: ``tools/``, ``ops/kernels/softmax_calib``,
  ``ops/remat``, ``utils/flops``, ``utils/profiling``; the sampling-knob
  slice's: ``diffusion/dpm_solver``, ``diffusion/pab``, ``ops/tome``,
  ``ops/freeu`` and the ``inference`` and ``edit`` entries; the
  pretrained and evaluation slice's: ``io/state_dict``, ``io/pretrained``,
  ``evaluation/*`` and the ``eval`` entry; the serving and training-option
  slice's: ``serving/``, the ``serve`` entry, ``training/lora``,
  ``training/optim8bit``, ``data/native``)
  and the root ``chip_smoke.py`` import in a fresh
  interpreter where ``jax``, ``flax``, ``optax``, ``orbax`` and
  ``seervideoldm_tpu`` cannot be imported (nor ``safetensors``, which the
  card machine does not have: the port reads and writes the format
  itself);
- no source file of the port names them in an import;
- on a host without CUDA, the entry points (the two floor budgets
  included) called without ``device="cpu"`` raise instead of running on
  the CPU; models for the GPU are bf16.
"""
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "seervideoldm_tpu_torch")
BLOCKED = ("jax", "flax", "optax", "orbax", "seervideoldm_tpu",
           "safetensors")


def _port_modules():
    names = ["seervideoldm_tpu_torch"]
    for info in pkgutil.walk_packages([PKG], "seervideoldm_tpu_torch."):
        names.append(info.name)
    return names


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_boundary_walk_reaches_the_training_modules():
    names = set(_port_modules())
    for mod in ("train", "training.trainer", "training.optim",
                "training.meters", "diffusion.ddpm", "io.checkpoint",
                "data.datasets", "data.loader"):
        assert f"seervideoldm_tpu_torch.{mod}" in names, mod


def test_boundary_walk_reaches_the_floor_budget_modules():
    names = set(_port_modules())
    for mod in ("tools.floor_budget", "tools.floor_budget_train",
                "ops.kernels.softmax_calib", "ops.remat", "utils.flops",
                "utils.profiling"):
        assert f"seervideoldm_tpu_torch.{mod}" in names, mod


def test_boundary_walk_reaches_the_parallel_modules():
    names = set(_port_modules())
    for mod in ("parallel.distributed", "parallel.mesh",
                "parallel.collectives", "parallel.activation",
                "parallel.launch", "ops.ring", "ops.kernels.swat_attention"):
        assert f"seervideoldm_tpu_torch.{mod}" in names, mod


def test_boundary_walk_reaches_the_sampling_knob_modules():
    names = set(_port_modules())
    for mod in ("diffusion.dpm_solver", "diffusion.pab", "ops.tome",
                "ops.freeu", "inference", "edit", "inference_img"):
        assert f"seervideoldm_tpu_torch.{mod}" in names, mod


def test_boundary_walk_reaches_the_pretrained_and_eval_modules():
    names = set(_port_modules())
    for mod in ("io.state_dict", "io.pretrained", "evaluation",
                "evaluation.fvd", "evaluation.i3d", "evaluation.c3d",
                "evaluation.inception_score", "evaluation.clip_sim", "eval"):
        assert f"seervideoldm_tpu_torch.{mod}" in names, mod


def test_boundary_walk_reaches_the_serving_and_training_option_modules():
    names = set(_port_modules())
    for mod in ("serving", "serving.batcher", "serving.server", "serve",
                "training.lora", "training.optim8bit", "data.native"):
        assert f"seervideoldm_tpu_torch.{mod}" in names, mod


def test_serve_entry_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device is valid here")
    from seervideoldm_tpu_torch import serve

    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("resolution: 32\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--config", str(cfg)])


def test_new_entries_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device is valid here")
    from seervideoldm_tpu_torch import edit, eval as eval_entry, inference

    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("resolution: 32\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        inference.main(["--config", str(cfg)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        edit.main(["--config", str(cfg), "--video_path", "unused.gif"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_entry.main(["--config", str(cfg)])


def test_port_imports_with_jax_blocked():
    code = "\n".join([
        "import importlib, runpy, sys",
        f"for name in {BLOCKED!r}:",
        "    sys.modules[name] = None",
        f"for mod in {_port_modules()!r}:",
        "    importlib.import_module(mod)",
        f"runpy.run_path({os.path.join(ROOT, 'chip_smoke.py')!r}, "
        "run_name='chip_smoke_import')",
        "leaked = [m for m in sys.modules if m.split('.')[0] in "
        f"{BLOCKED!r} and sys.modules[m] is not None]",
        "assert not leaked, leaked",
        "print('ok')",
    ])
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_port_sources_name_no_jax_import():
    pat = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax|orbax|seervideoldm_tpu|"
        r"safetensors)\b", re.MULTILINE)
    offenders = [p for p in _sources() if pat.search(open(p).read())]
    assert not offenders


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device is valid here")
    from seervideoldm_tpu_torch.inference_img import build_pipeline
    from seervideoldm_tpu_torch.pipelines.text_video import SeerModels
    from seervideoldm_tpu_torch.utils.device import resolve_device

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_pipeline({"resolution": 32})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SeerModels.initialize()
    from seervideoldm_tpu_torch.train import train

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train({"resolution": 32, "output_dir": "unused"})
    from seervideoldm_tpu_torch.tools import floor_budget, floor_budget_train

    for entry in (floor_budget, floor_budget_train):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry.main(["--json"])
    assert resolve_device("cpu").type == "cpu"


def test_gpu_models_refuse_fp32(monkeypatch):
    """The CUDA kernels compute in bf16: models for the GPU built in fp32
    are refused before anything is built, not failed deep in a kernel."""
    from seervideoldm_tpu_torch.pipelines import text_video

    monkeypatch.setattr(text_video, "resolve_device",
                        lambda device: torch.device("cuda"))
    with pytest.raises(ValueError, match="compute in bf16"):
        text_video.SeerModels.initialize(dtype=torch.float32)


def test_numpy_image_input_matches_pil_path():
    """``image_to_model_input`` on a numpy image (hosts without Pillow)
    against the PIL path: identical at the target size, within two 8-bit
    levels when resizing."""
    from PIL import Image

    from seervideoldm_tpu_torch.data.transforms import image_to_model_input

    img = np.random.RandomState(0).randint(0, 255, (32, 32, 3), dtype=np.uint8)
    np.testing.assert_array_equal(image_to_model_input(img, 32),
                                  image_to_model_input(Image.fromarray(img), 32))
    smooth = np.linspace(0, 255, 48 * 64 * 3).reshape(48, 64, 3).astype(np.uint8)
    a = image_to_model_input(smooth, 32)
    b = image_to_model_input(Image.fromarray(smooth), 32)
    assert a.shape == b.shape == (32, 32, 3)
    np.testing.assert_allclose(a, b, atol=4 / 255 * 2)
