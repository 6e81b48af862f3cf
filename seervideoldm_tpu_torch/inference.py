"""Batch sampling over a dataset's validation split, on the GPU (port of
the root ``inference.py``).

    python -m seervideoldm_tpu_torch.inference --config <yaml>

For each of ``sample_iter`` batches of ``val_batch_size`` clips: the first
``cond_frames`` frames condition ``num_samples`` samples (the sampler and
knobs of ``sampling_kwargs_from``); the ground-truth future frames are
VAE-encoded and decoded as the reconstruction row.  Writes
``sample`` / ``recon`` / ``gt``-<n>.gif and ``grid-<n>.png`` per sample,
``n = i_ter * max(10, num_samples) + j`` (the reference's naming, widened
past 10 samples so none is overwritten).  Runs on CUDA; ``--device cpu``
runs the plain PyTorch path.

Several ranks under torchrun take ``mesh_shape`` like ``inference_img``:
every rank loads the same batches, and the pipeline splits the clips over
``data`` and the frames over ``seq`` and joins them, so each rank holds the
whole result and rank 0 writes it (a per-rank loader shard, as the JAX
entry's per-host one, would need no join but a second split of each
rank's own batch).  The noise comes from a generator seeded by ``seed``
and the batch index, the same on every rank.
"""
from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from .config import parse_args, sampling_kwargs_from
from .data import DataLoader, build_dataset
from .inference_img import build_pipeline
from .parallel.distributed import is_main_process
from .utils.viz import save_visualization


def batches(loader):
    """The loader's batches, over and over (an empty loader raises)."""
    while True:
        count = 0
        for item in loader:
            count += 1
            yield item
        if count == 0:
            raise RuntimeError("validation loader yielded no batches: fewer "
                               "clips than val_batch_size?")


def _host(x: torch.Tensor) -> np.ndarray:
    return x.float().cpu().numpy()


def main(argv: Optional[list[str]] = None, device=None) -> list:
    """Command-line entry; returns the sample numbers written (empty on the
    ranks that write nothing)."""
    cfg = parse_args("Seer batch inference (PyTorch / CUDA port)",
                     extra_flags={"device": None}, argv=argv)
    pipe, tokenizer, cfg = build_pipeline(cfg, device or cfg.get("device"))
    dataset = build_dataset(cfg.dataset, cfg.dataset_path or cfg.get("data_dir"),
                            int(cfg.resolution), int(cfg.num_frames),
                            split="val")
    loader = DataLoader(dataset, int(cfg.val_batch_size), shuffle=False,
                        num_workers=int(cfg.get("num_workers",
                                                cfg.dataloader_num_workers)),
                        drop_last=True)
    it = batches(loader)
    f1, written = int(cfg.cond_frames), []
    stride = max(10, int(cfg.num_samples))
    for i_ter in range(int(cfg.sample_iter)):
        videos, prompts = next(it)
        video = torch.as_tensor(videos, device=pipe.device)  # [-1, 1]
        cond, gt = video[:, :f1], video[:, f1:]
        tok, tok_uc = tokenizer(prompts), tokenizer([""] * len(prompts))
        gen = torch.Generator(device=pipe.device).manual_seed(
            int(cfg.seed) * 1_000_003 + i_ter)
        b, f2, h, w, _ = gt.shape
        post = torch.randn((b, f2, *pipe.latent_shape(h, w)),
                           generator=gen, device=pipe.device)
        recon = _host(pipe.vae_decode_video(pipe.vae_encode_video(gt, post)))
        gt01, cond01 = (_host((t + 1.0) / 2.0) for t in (gt, cond))
        for j in range(int(cfg.num_samples)):
            samples = pipe.generate(
                cond, tok["input_ids"], tok["attention_mask"],
                tok_uc["input_ids"], tok_uc["attention_mask"],
                num_frames=int(cfg.num_frames), generator=gen,
                ddim_steps=int(cfg.ddim_steps), guidance_scale=float(cfg.scale),
                **sampling_kwargs_from(cfg))
            samples = _host(samples)
            if is_main_process():
                n = i_ter * stride + j
                save_visualization(samples, recon, gt01, cond01,
                                   cfg.output_dir, global_step=n,
                                   num_sample_rows=int(cfg.n_rows))
                written.append(n)
        if is_main_process():
            print(f"iteration {i_ter + 1}/{cfg.sample_iter} done")
    return written


if __name__ == "__main__":
    main(sys.argv[1:])
