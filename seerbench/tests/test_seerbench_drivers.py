"""Each driver at toy width on the CPU (the port's plain fp32 path) against
the plain reference; the control and every fault a cell can have make
``correct`` false; the import boundary."""
from __future__ import annotations

import ast
import copy
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from seerbench import control, harness
from seerbench.run import load_module

ROOT = Path(__file__).resolve().parents[2]
torch.set_num_threads(1)  # toy shapes: more threads only contend
SEED = 2 ** 31 + 12345  # more than 32 signed bits
TOY = {"block_out_channels": [32, 64], "layers_per_block": 1,
       "norm_num_groups": 8, "cross_attention_dim": 32, "attention_heads": 4,
       "vae_block_out_channels": [16, 32], "vae_layers_per_block": 1,
       "clip_hidden_size": 32, "clip_intermediate_size": 64, "clip_layers": 2,
       "clip_heads": 4, "fstext_heads": 4, "fstext_layers": 1,
       "compute_dtype": "float32", "resolution": 32, "ddim_steps": 4}
# fp32 against fp32: summation order only
TOY_LIMITS = {"latent_rel_l2": 1e-4, "video_rel_l2": 1e-4, "loss_gap": 1e-4,
              "grad_gap": 1e-4, "change_gap_median": 1e-4}
CELLS = ("sthv2.serve.c8", "sthv2.sample.512", "bridge.sample.b4",
         "bridge.train.b4")


def toy(cell: str, seconds: float = 10.0, seed: int = SEED) -> harness.Context:
    """The cell's own workload at toy width, 32 px, 4 DDIM steps, fp32."""
    wl = copy.deepcopy(harness.load_json("workloads", cell))
    config = harness.load_json("configs", wl["config"])
    config.update(TOY, num_frames=config["num_frames"] // 2)
    wl["program"].pop("resolution", None)
    wl["limits"] = dict(TOY_LIMITS)
    wl["unet_calls"] = 4
    return harness.Context(seed=seed, seconds=seconds, config=config,
                           workload=wl, t0=time.monotonic(),
                           device="cpu")


def drive(ctx):
    torch.manual_seed(0)
    return load_module("drivers", ctx.workload["driver"]).run(ctx)


@pytest.mark.parametrize("cell", CELLS)
def test_driver_equals_the_reference(cell):
    result = drive(toy(cell))
    assert result.correct, [(c.name, c.value) for c in result.checks]
    assert result.attempted > 0 and result.failed == 0
    assert result.e2e["setup_s"] > 0
    assert all(v > 0 for v in result.e2e.values())
    assert result.record["flops"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_reads_far_above_the_program(cell):
    """The fp8 control (and the half-batch fault) against fp32 at toy
    width: every number of the fault-free program (fp32 here) is far
    below, so the comparison can tell them apart."""
    ctx = toy(cell)
    rows = control.readings(ctx)
    assert rows and all(len(r) > 1 for r in rows)
    for row in rows:
        assert max(v for k, v in row.items() if k != "mode") > 100 * 1e-5


def _break(monkeypatch, fault: str) -> None:
    """Plant ``fault`` in the timed path of the port."""
    if fault == "answer_altered":
        from seervideoldm_tpu_torch.models.vae import AutoencoderKL

        real = AutoencoderKL.decode
        monkeypatch.setattr(AutoencoderKL, "decode",
                            lambda self, z: real(self, z) * 1.01)
    elif fault == "token_altered":
        from seervideoldm_tpu_torch.models import unet3d

        real = unet3d.SeerUNet.forward

        def forward(self, sample, timesteps, *a, **k):
            return real(self, sample, timesteps + 1, *a, **k)

        monkeypatch.setattr(unet3d.SeerUNet, "forward", forward)
    elif fault == "state_unchanged":
        from seervideoldm_tpu_torch.training import optim

        real = optim.Optimizer.update

        def update(self, grads):
            saved = [p.detach().clone() for p in self.params]
            out = real(self, grads)
            with torch.no_grad():
                for p, s in zip(self.params, saved):
                    p.copy_(s)
            return out

        monkeypatch.setattr(optim.Optimizer, "update", update)
    elif fault == "half_batch":
        from seervideoldm_tpu_torch.training import trainer

        real = trainer.make_train_step

        def make(*a, **k):
            step = real(*a, **k)

            def half(state, batch, noise=None, timesteps=None, **kw):
                n = batch["latents"].shape[0] // 2
                return step(state, {key: v[:n] for key, v in batch.items()},
                            noise=noise[:n], timesteps=timesteps[:n], **kw)
            return half

        monkeypatch.setattr(trainer, "make_train_step", make)


@pytest.mark.parametrize("cell,fault", [
    ("sthv2.serve.c8", "answer_altered"), ("sthv2.serve.c8", "token_altered"),
    ("sthv2.sample.512", "answer_altered"),
    ("bridge.sample.b4", "token_altered"),
    ("bridge.train.b4", "state_unchanged"), ("bridge.train.b4", "half_batch")])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    """The rest of a run, the card's look skipped, with the timed path
    broken underneath: ``correct`` comes out false."""
    _break(monkeypatch, fault)
    result = drive(toy(cell))
    assert not result.correct, [(c.name, c.value) for c in result.checks]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "seerbench" / "reference").glob("*.py"):
        assert not _imports(path) & {"seervideoldm_tpu_torch", "seervideoldm_tpu",
                                     "jax", "jaxlib", "flax"}, path


def test_no_harness_file_imports_jax_or_the_jax_package():
    for path in (ROOT / "seerbench").rglob("*.py"):
        assert not _imports(path) & {"seervideoldm_tpu", "jax", "jaxlib",
                                     "flax"}, path


def test_a_run_loads_no_jax_module():
    """Everything a run imports, the port included, in a fresh process;
    the names compared whole (the port's name begins with the JAX
    package's)."""
    code = ("import sys; from seerbench import run, harness, checks, probe, control;"
            "import seervideoldm_tpu_torch.inference_img, seervideoldm_tpu_torch.serve;"
            "import seervideoldm_tpu_torch.training.trainer;"
            "[run.load_module('drivers', d) for d in "
            "('serve_closed', 'sample_batch', 'train_steps')];"
            "assert 'seervideoldm_tpu_torch' in sys.modules;"
            "print(run.banned_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    """A short run of the serving cell on the card: a result line, correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "-m", "seerbench.run", "--workload",
                          "sthv2.serve.c8", "--seed", str(SEED), "--seconds",
                          "10", "--trace", "0"], cwd=ROOT, text=True,
                         capture_output=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    import json

    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
