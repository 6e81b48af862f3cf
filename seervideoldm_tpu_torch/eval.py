"""FVD / KVD, Inception Score and CLIPSIM over a dataset's validation split,
on the GPU (port of the root ``eval.py``).

    python -m seervideoldm_tpu_torch.eval --config configs/eval.yaml

Loads the models (random from ``seed``, then the pretrained SD-1.5 /
FSText files and the fine-tuned checkpoint the config names), then for
each batch of ``val_batch_size`` clips: the first ``cond_frames`` frames
condition one sample (the sampler and knobs of ``sampling_kwargs_from``,
noise from a generator seeded by ``seed`` and the batch index); CLIPSIM
scores the generated frames against the prompt; the cond frames are
prepended (reference ``eval.py:225``), the clips converted to uint8 and
gathered over the ranks.  Two independent buckets flush when
``MAX_FVD_BATCH`` / ``MAX_IS_BATCH`` clips have accumulated, and both at
the last batch: FVD / KVD are cumulative over I3D embeddings (VideoGPT
protocol), IS over C3D scores of the same concatenated stack; under
``is_cast_frames`` the clips are resampled to C3D's 16 frames.  Prints the
JAX entry's lines (``[n clips] FVD ... KVD ...``, ``IS ... +- ...``,
``CLIPSIM ...``, ``Final ...``).

I3D (``i3d_ckpt``), C3D (``c3d_ckpt`` + ``c3d_mean_path``, default
``mean2.npz`` beside it) and CLIP (``clip_sim_ckpt``, a local HF
``CLIPModel`` state dict; ``model_overrides.clip_sim.{vision,text}`` for
toy widths) run in fp32; without a checkpoint each warns and uses seeded
random weights, as the JAX entry does.  Runs on CUDA; ``--device cpu``
runs the plain PyTorch path.  Under torchrun each rank samples its own
shard of the split (no mesh: ``mesh_shape`` is refused here).
"""
from __future__ import annotations

import contextlib
import sys
import time
from typing import Optional

import numpy as np
import torch

from .config import parse_args, sampling_kwargs_from
from .data import DataLoader, build_dataset
from .evaluation.c3d import C3D, load_c3d_params
from .evaluation.clip_sim import (CLIPProjections, CLIPVisionConfig,
                                  CLIPVisionModel, make_clip_sim_fn)
from .evaluation.fvd import FVDEvaluator
from .evaluation.i3d import InceptionI3d, load_i3d_params
from .evaluation.inception_score import inception_score
from .inference_img import build_pipeline
from .io.pretrained import (convert_clip_projections, convert_clip_text,
                            convert_clip_vision)
from .io.state_dict import load_state_dict
from .models.clip_text import CLIPTextConfig, CLIPTextModel
from .parallel.distributed import (gather_across_hosts, is_main_process,
                                   rank, world_size)


def to_uint8(video01: np.ndarray) -> np.ndarray:
    return (np.clip(video01, 0.0, 1.0) * 255).astype(np.uint8)


def _seeded(build, device: torch.device, seed: int = 0):
    """``build()`` on ``device`` with the global generators seeded (and
    restored after), fp32, in eval mode, frozen."""
    forked = [device] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=forked), torch.device(device):
        torch.manual_seed(seed)
        return build().eval().requires_grad_(False)


def build_i3d(cfg, device) -> InceptionI3d:
    i3d = _seeded(InceptionI3d, device)
    if cfg.i3d_ckpt:
        return load_i3d_params(cfg.i3d_ckpt, i3d)
    print("WARNING: no i3d_ckpt given — FVD uses random I3D weights")
    return i3d


def build_c3d(cfg, device) -> C3D:
    c3d = _seeded(C3D, device)
    if cfg.c3d_ckpt:
        mean_path = cfg.c3d_mean_path or cfg.c3d_ckpt.replace(
            "conv3d_deepnetA_ucf.npz", "mean2.npz")
        return load_c3d_params(cfg.c3d_ckpt, mean_path, c3d)
    print("WARNING: no c3d_ckpt given — IS uses random C3D weights")
    return c3d


def build_clip_sim(cfg, device):
    """(vision, text, projections) for CLIPSIM."""
    over = (cfg.model_overrides or {}).get("clip_sim", {})
    vcfg = CLIPVisionConfig(**over.get("vision", {}))
    tcfg = CLIPTextConfig(**over.get("text", {}))
    vision = _seeded(lambda: CLIPVisionModel(vcfg), device)
    text = _seeded(lambda: CLIPTextModel(tcfg), device)
    proj = _seeded(lambda: CLIPProjections(vcfg.hidden_size, tcfg.hidden_size,
                                           vcfg.projection_dim), device)
    if cfg.clip_sim_ckpt:
        sd = load_state_dict(cfg.clip_sim_ckpt)
        convert_clip_vision(sd, vision)
        convert_clip_text({k: v for k, v in sd.items()
                           if k.startswith("text_model.")}, text)
        convert_clip_projections(sd, proj)
    else:
        print("WARNING: no clip_sim_ckpt given — CLIPSIM uses random CLIP "
              "weights")
    return vision, text, proj


@contextlib.contextmanager
def _timed(seconds: dict, key: str, device: torch.device):
    """Adds the block's wall time, to the device's end, to ``seconds[key]``."""
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0


def main(argv: Optional[list[str]] = None, device=None) -> dict:
    """Command-line entry; returns the final metrics (``fvd``, ``kvd``,
    ``is_mean``, ``is_std``, ``clip_sim``; NaN where not computed), the
    clips scored and each stage's ``seconds`` on this rank."""
    cfg = parse_args("Seer FVD/KVD/IS/CLIPSIM evaluation (PyTorch / CUDA "
                     "port)", extra_flags={"device": None}, argv=argv)
    if cfg.mesh_shape:
        raise ValueError("the eval entry shards the validation split by rank "
                         "and registers no mesh; drop mesh_shape")
    pipe, tokenizer, cfg = build_pipeline(cfg, device or cfg.get("device"),
                                          mesh=False)
    dev = pipe.device
    fvd_eval = FVDEvaluator(build_i3d(cfg, dev)) if cfg.compute_fvd else None
    c3d = build_c3d(cfg, dev) if cfg.compute_is else None
    clip_sim_fn = (make_clip_sim_fn(*build_clip_sim(cfg, dev))
                   if cfg.compute_clip_sim else None)

    @torch.no_grad()
    def c3d_classify(v: np.ndarray) -> np.ndarray:
        return c3d(torch.as_tensor(v, device=dev)).cpu().numpy()

    dataset = build_dataset(cfg.dataset, cfg.dataset_path or cfg.get("data_dir"),
                            int(cfg.resolution), int(cfg.num_frames),
                            split="val")
    loader = DataLoader(dataset, int(cfg.val_batch_size), shuffle=False,
                        num_workers=int(cfg.get("num_workers",
                                                cfg.dataloader_num_workers)),
                        drop_last=True, shard_index=rank(),
                        num_shards=world_size())
    f1 = int(cfg.cond_frames)
    seconds: dict = {}
    y_score_stack: list = []
    clip_sims: list[np.ndarray] = []
    pred_stack: list[np.ndarray] = []
    gt_stack: list[np.ndarray] = []
    fvd = kvd = is_mean = is_std = float("nan")
    clips, num_batches = 0, len(loader)
    for i, (videos, prompts) in enumerate(loader):
        cond = videos[:, :f1]
        tok, tok_uc = tokenizer(prompts), tokenizer([""] * len(prompts))
        gen = torch.Generator(device=dev).manual_seed(
            int(cfg.seed) * 1_000_003 + i)
        with _timed(seconds, "sample", dev):
            samples = pipe.generate(
                cond, tok["input_ids"], tok["attention_mask"],
                tok_uc["input_ids"], tok_uc["attention_mask"],
                num_frames=int(cfg.num_frames), generator=gen,
                ddim_steps=int(cfg.ddim_steps),
                guidance_scale=float(cfg.scale), **sampling_kwargs_from(cfg))
            samples_np = samples.float().cpu().numpy()
        if clip_sim_fn is not None:
            # the GENERATED frames against the prompt (cond frames are
            # inputs, not predictions)
            with _timed(seconds, "clip_sim", dev):
                sims = clip_sim_fn(samples, tok["input_ids"],
                                   tok["attention_mask"])
            clip_sims.append(gather_across_hosts(sims))
            if is_main_process():
                running = float(np.concatenate(clip_sims).mean())
                print(f"[{sum(len(s) for s in clip_sims)} clips] "
                      f"CLIPSIM {running:.4f}")
        # prepend the cond frames to the prediction (reference eval.py:225)
        pred = np.concatenate([(cond + 1.0) / 2.0, samples_np], axis=1)
        gt = (videos + 1.0) / 2.0
        # gathered before bucketing (reference eval.py:226-231)
        pred_stack.append(gather_across_hosts(to_uint8(pred)))
        gt_stack.append(gather_across_hosts(to_uint8(gt)))
        clips += len(pred_stack[-1])
        # concatenated once before both branches: the IS branch reuses the
        # stack from before the FVD reset (reference eval.py:235-247)
        pred_cat = np.concatenate(pred_stack)
        gt_cat = np.concatenate(gt_stack)
        n_acc = len(pred_cat)
        last = i == num_batches - 1
        # independent branches, and both flush at the last batch
        if cfg.compute_fvd and (n_acc >= int(cfg.MAX_FVD_BATCH) or last):
            with _timed(seconds, "fvd", dev):
                metrics = fvd_eval.update(pred_cat, gt_cat)
            fvd, kvd = metrics["fvd"], metrics["kvd"]
            if is_main_process():
                print(f"[{metrics['n']} clips] FVD {fvd:.2f} KVD {kvd:.4f}")
            pred_stack, gt_stack = [], []
        if cfg.compute_is and (n_acc >= int(cfg.MAX_IS_BATCH) or last):
            samples_is = pred_cat / 127.5 - 1.0
            if cfg.is_cast_frames and samples_is.shape[1] != 16:
                from .data.transforms import resample_frames

                samples_is = np.stack([resample_frames(clip, 16)
                                       for clip in samples_is])
            with _timed(seconds, "is", dev):
                is_mean, is_std, y_score_stack = inception_score(
                    c3d_classify, samples_is.astype(np.float32),
                    y_score_stack)
            if is_main_process():
                print(f"IS {is_mean:.2f} +- {is_std:.2f}")
            pred_stack, gt_stack = [], []

    clip_sim = (float(np.concatenate(clip_sims).mean()) if clip_sims
                else float("nan"))
    if is_main_process():
        if cfg.compute_fvd:
            print(f"Final FVD {fvd:.2f}, KVD {kvd:.4f}")
        if cfg.compute_is:
            print(f"Final IS {is_mean:.2f} +- {is_std:.2f}")
        if clip_sims:
            print(f"Final CLIPSIM {clip_sim:.4f}")
    return {"fvd": fvd, "kvd": kvd, "is_mean": is_mean, "is_std": is_std,
            "clip_sim": clip_sim, "clips": clips, "seconds": seconds}


if __name__ == "__main__":
    main(sys.argv[1:])
