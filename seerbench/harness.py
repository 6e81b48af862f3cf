"""What every driver shares: the run's context and result, seeds derived
from ``--seed``, the port's configuration built from a configuration file
and a workload file, the traffic generator's inputs, and the comparison
helpers that decide ``correct``."""
from __future__ import annotations

import gc
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


def load_json(kind: str, name: str) -> dict:
    """``seerbench/<kind>/<name>.json``."""
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


@dataclass
class Context:
    seed: int
    seconds: float
    config: dict
    workload: dict
    t0: float                  # process start (monotonic), for setup_s
    device: str = "cuda"
    probe: Optional[object] = None


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return (self.limit is not None and bool(np.isfinite(self.value))
                and self.value <= self.limit)


@dataclass
class Result:
    attempted: int
    failed: int
    e2e: dict
    checks: list
    memory_peak_bytes: int
    record: dict = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and bool(self.checks) and all(
            c.ok for c in self.checks)


def subseed(seed: int, *keys) -> int:
    """A 63-bit seed for one stream of the run (``keys`` name it)."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32]
    words += [(int(k) if isinstance(k, int) else
               int.from_bytes(str(k).encode()[:8].ljust(8, b"\0"), "little"))
              & 0xFFFFFFFF for k in keys]
    return int(np.random.SeedSequence(words).generate_state(2, np.uint64)[0]
               >> np.uint64(1))


def port_config(config: dict, workload: dict, seed: int) -> dict:
    """The port's configuration keys for this cell: the widths of the
    configuration file as ``model_overrides``, its sampling settings, then
    the workload's ``program`` keys."""
    cfg = dict(
        resolution=config["resolution"], cond_frames=config["cond_frames"],
        num_frames=config["num_frames"], ddim_steps=config["ddim_steps"],
        scale=config["scale"], seed=int(seed), mixed_precision="bf16",
        compute_dtype=config["compute_dtype"],
        param_dtype=config["param_dtype"],
        model_overrides={
            "unet": dict(block_out_channels=list(config["block_out_channels"]),
                         layers_per_block=config["layers_per_block"],
                         norm_num_groups=config["norm_num_groups"],
                         cross_attention_dim=config["cross_attention_dim"],
                         attention_head_dim=config["attention_heads"]),
            "vae": dict(block_out_channels=list(config["vae_block_out_channels"]),
                        layers_per_block=config["vae_layers_per_block"],
                        norm_num_groups=config["norm_num_groups"]),
            "clip": dict(vocab_size=config["clip_vocab_size"],
                         hidden_size=config["clip_hidden_size"],
                         intermediate_size=config["clip_intermediate_size"],
                         num_hidden_layers=config["clip_layers"],
                         num_attention_heads=config["clip_heads"],
                         max_position_embeddings=config["clip_max_positions"]),
            "fstext": dict(n_heads=config["fstext_heads"],
                           num_layers=config["fstext_layers"])})
    cfg.update(workload.get("program", {}))
    return cfg


def geometry(config: dict, workload: dict) -> dict:
    """Resolution, frames and the latent shape of the cell."""
    res = int(workload.get("program", {}).get("resolution", config["resolution"]))
    f, f1 = int(config["num_frames"]), int(config["cond_frames"])
    down = 2 ** (len(config["vae_block_out_channels"]) - 1)
    return dict(res=res, frames=f, cond=f1, future=f - f1,
                lat=(res // down, res // down, 4))


# ---------------------------------------------------------------- traffic

def images(seed: int, n: int, res: int) -> np.ndarray:
    """n frames (n, res, res, 3) float32 in [-1, 1]: coarse colour fields
    (an 8 x 8 grid, bilinear) with fine noise, from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    coarse = torch.rand((n, 3, 8, 8), generator=g) * 2 - 1
    fine = torch.rand((n, 3, res, res), generator=g) * 0.2 - 0.1
    x = torch.nn.functional.interpolate(coarse, size=(res, res),
                                        mode="bilinear", align_corners=False)
    return (x + fine).clamp(-1, 1).permute(0, 2, 3, 1).contiguous().numpy()


def prompts(seed: int, n: int, workload: dict) -> list:
    """n instructions from the workload's templates and objects."""
    rng = np.random.default_rng(seed)
    tpl, objs = workload["prompt_templates"], workload["prompt_objects"]
    return [tpl[rng.integers(len(tpl))].format(
        obj=objs[rng.integers(len(objs))],
        other=objs[rng.integers(len(objs))]) for _ in range(n)]


def sample_indices(seed: int, n: int, k: int) -> list:
    """k distinct indices of n, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())


# -------------------------------------------------------------- comparing

def rel_l2(got, want) -> float:
    got = torch.as_tensor(got, dtype=torch.float32).cpu().reshape(-1).double()
    want = torch.as_tensor(want, dtype=torch.float32).cpu().reshape(-1).double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want).clamp_min(1e-30))


class Marks:
    """Seconds of each phase of the set-up, for the run's notes."""

    def __init__(self, t0: float):
        self.last = time.monotonic()
        self.seconds = {"imports": self.last - t0}

    def __call__(self, phase: str) -> None:
        now = time.monotonic()
        self.seconds[phase] = now - self.last
        self.last = now


def note(**fields) -> None:
    """A line of what a run has measured so far, on standard error."""
    print("seerbench: " + json.dumps(fields, default=float), file=sys.stderr,
          flush=True)


def free_device() -> None:
    gc.collect()
    torch.cuda.empty_cache()

