#!/usr/bin/env python3
"""Chip smoke test for the PyTorch/CUDA port (``seervideoldm_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints
no result line):

1. device: CUDA present, compute capability (9, 0); prints the card's name
   and power limit as nvidia-smi reports them;
2. build: compiles the five CUDA sources under ``seervideoldm_tpu_torch/
   csrc`` with nvcc for sm_90a, all at once, and prints the build time,
   each kernel's registers and spills (``-Xptxas -v``) and the shared
   memory a CTA of the attention forward and of the attention backward's
   two kernels takes in each configuration (the backward's as the host's
   ``bwd_layout`` computes it, which must agree with the source);
3. kernel checks: each of K1-K5 (forward) and K7, K8 (backward) at the
   shapes both main paths give it at 256 px -- sampling (CFG batch 2, under
   ``no_grad``) and training (batch 1, called under ``enable_grad`` on
   inputs that require a gradient, so the forward is the log-sum-exp
   writing launch of the ``autograd.Function``) -- and at the 512 px shapes
   (d = 40 and d = 80), bf16 inputs from a seeded generator, against its
   plain PyTorch version (for a backward kernel dq, dk and dv each); the
   forward kernels' log-sum-exp against ``logsumexp`` of the plain scores;
   K6 (pre-rotated, ``rot_dim`` 0, and in-kernel trig, ``rot_dim`` 32) and
   K9 (both modes) at the shapes of the sequence-parallel path and at the
   256 / 512 px shapes; times the kernel, the plain version and one library
   call computing the same function (for the attentions PyTorch's fused
   SDPA on 4-D views under the flash backend, or the memory-efficient one
   where flash refuses the shape, named on the row; a backward's is that
   call's backward alone, ``autograd.grad`` of an output whose forward ran
   outside the timed call, captured in a CUDA graph and replayed, so the
   autograd engine's host time does not pace it; SWAT's on
   window-partitioned inputs made outside the timed call, without
   rotation), and the bound: bytes over
   the HBM rate, products over the bf16 tensor rate and, for a softmax,
   one MUFU ex2 per visible score at K10's rate; K3-K5, each an up kernel (``a =
   bf16(h * gelu(g))``, LayerNorm prologue) and a down kernel (``a W2 +
   b2`` and the mode's epilogue), also as those two halves alone against
   their plain versions, the down kernel fed the plain ``a``, with each
   half's time (``up_ms``, ``down_ms``) and the tile plan on the row;
   last, the sampling-knob path's shapes (path ``knobs``): K2 at the ToMe
   lengths (192, 512, 40) and (192, 717, 40), and the no-gradient batch-1
   forwards of a call outside a guidance interval, K1 (8, 12, 32, 32,
   40), K2 (96, 1024, 40), K3 / K4 (12288, 320), K5 (3072, 640); then the
   serving path's (path ``serving``: ``configs/serve.yaml``'s batch of 4,
   CFG batch 8, no gradient), K1 (64, 12, 32, 32, 40), K2 (768, 1024,
   40), K3 / K4 (98304, 320), K5 (24576, 640); last K11 (GroupNorm, SiLU
   on or off) at the serving path's UNet levels 0 and 2, the VAE
   decoder's top level, the sampling path's UNet shapes (CFG batch 2, every
   channel count of a UNet call), the training path's (batch 1, under
   autograd through ``GroupNormFn``) and odd shapes, each held to its
   plain halves by ``ops/kernels/group_norm.py::check_against_plain`` (the
   moments against fp64, the apply kernel bit for bit on the kernel's own
   moments, each output within one bf16 ulp of the normalised value before
   the SiLU), the training rows' gradients also equal to autograd's
   through the plain halves (``check_gradients_against_plain``); last
   Stable Video Diffusion XT's shapes (path ``svd``: CFG batch 2, 25
   frames of 72 x 128 latents, head dim 64): K2 at levels 0-2 (9216
   tokens, the streamed form, and 2304, their plain versions row by row;
   576), K3 at level 0's 460800 rows, K5 at level 1's 115200, K11 per
   frame at levels 0-2, over a clip's frames at level 0 and at the
   temporal decoder's top level (25 frames at 576 x 1024);
4. reference: one SeerUNet call at narrow widths (64/128) and the main
   path's 256 px / 12 frame / CFG-batch-2 shapes, bf16 with the kernels on
   the card against the port's plain path in fp32 on the CPU, same weights
   and inputs (relative L2 error <= 5e-2);
5. train reference: the same narrow SeerUNet, every ``proj_out`` non-zero,
   one training forward + backward (``cond_frame`` 2, eps-MSE on the future
   frames): loss and per-tensor gradients of the temporal attentions, bf16
   through the kernels on the card against the plain path in fp32 on the
   CPU;
6. end to end: the port's image + prompt -> video pipeline at full SD-1.5
   width (CLIP ViT-L/14 text, FSText, SD-1.5 VAE, SeerUNet 320/640/1280/
   1280), 256 px, 12 frames, 2 cond frames, CFG 7.5, random weights from a
   seed, 30 DDIM steps (the shipped config's count); launch counts are
   zeroed just before and read just after, and every kernel must have run
   its count per step x steps, K11 (GroupNorm) ``GN_PER_UNET_CALL`` times
   inside each UNet call and more around them (the VAE's norms);
   checks the frames (finite, (1, 10, 256, 256, 3), in [0, 1]);
6b. sampling knobs, on phase 6's pipeline after a narrow-width reference
   (SeerUNet 64/128 at the main path's shapes, as phase 4: one call in a
   fully cached PAB mode, one with ToMe 0.5, one with FreeU, bf16 through
   the kernels on the card against the plain path in fp32 on the CPU,
   relative L2 <= 5e-2 each): (a) DPM-Solver++ 20 trailing steps;
   (b) the zero-terminal-SNR recipe (rescaled schedule, v-prediction,
   trailing, ``guidance_rescale`` 0.7), DDIM 30; (c) ``configs/serve.yaml``'s
   PAB at 30 steps, the launches derived from the port's own schedule
   (K2 at the steps that compute the spatial attention, K1 at those that
   compute the temporal one), then two checks bit for bit: every range 1
   against PAB off over 5 steps, and a fully cached UNet call at the same
   (x, t) as the all-compute call before it; (d) ToMe 0.5 with FreeU
   (1.5, 1.6, 0.9, 0.2): K2 sees 512 tokens only; (e) ``guidance_interval``
   [0, 500]: the calls outside it run K1 and K2 at batch 1; (f) a rollout
   to ``total_frames`` 20 (2 chunks); (g) the ``edit`` entry on a seeded
   12-frame GIF at strength 0.6; (h) the ``inference`` entry on a
   synthetic Something-Something-v2 val tree, 1 batch, 1 sample.  Each
   run zeroes the launch counts just before and reads them just after,
   counts the UNet calls, checks the frames (finite, the expected shape,
   in [0, 1]) and prints a ``sampling_knobs`` line: run, UNet calls,
   seconds per clip, peak GB, launches;
6e. serving, on phase 6's pipeline with ``configs/serve.yaml``'s knobs
   (PAB, DDIM 30, ``serve_max_batch`` 4; the batching window raised to
   ``SERVE_WAIT_MS`` for this phase only, so that requests started
   ``SERVE_STAGGER_S`` apart form one batch): a ``GenerationService`` and
   ``make_server`` on port 0 in a thread; the warm-up batch, timed; four
   concurrent POSTs (``/healthz`` then reads 1 batch, 4 requests), one
   lone POST (2, 5), one malformed POST (400); each reply a 256 x 256 GIF
   of at most 12 frames; launches per batch equal to the PAB schedule's;
   then, bit for bit through ``generate_array`` at ``SERVE_CHECK_STEPS``,
   row 0 of [A, B, C, D] against row 0 of [A, E, F, G] under the same
   batch counter, and a restarted service fed [A, B, C, D] again; then
   ``python -m seervideoldm_tpu_torch.serve --config configs/serve.yaml
   --set serve_port=0`` as a subprocess: its port read from the "serving
   on" line, one POST, ``/healthz``, SIGTERM and exit 0 within
   ``SERVE_STOP_TIMEOUT``; a ``serving`` line (warm-up, batch and
   lone-request seconds, requests/s, latency p50 / p95, peak GB,
   launches, the entry's times);
6c. pretrained: a full-width SD-1.5 diffusers directory written to a
   temporary directory from a seeded random-init set of the port's
   modules, under a real download's names (``vae/`` fp32 ``.bin`` with
   diffusers' newer attention names, ``text_encoder/model.safetensors``
   with ``position_ids``, ``unet/`` fp16 safetensors with the 2D keys
   only) and an FSText ``.bin``, ~3.3 GB, written by the port's own
   safetensors writer (bytes and seconds printed, the directory deleted
   at the end); loaded through ``load_models`` on the card with another
   seed: every loaded tensor equals its source cast to the module's
   dtype bit for bit, the 320 temporal-attention keys equal the new
   seed's fresh values; then one 256 px, 12-frame, DDIM 30 clip from the
   loaded models, launches zeroed just before and read just after
   (``PER_STEP`` x 31); a ``pretrained`` line (load seconds, peak GB,
   launches);
6d. eval: the ``eval`` entry through ``main(argv)`` from
   ``configs/eval.yaml`` with ``--set`` overrides only: a synthetic
   Sthv2 val tree of 4 clips, ``MAX_FVD_BATCH`` 2 (the bucket flushes
   twice), IS with ``is_cast_frames``, CLIPSIM, an I3D ``.pt`` in the
   reference's names, a chainer C3D ``.npz`` + ``mean2.npz`` and a whole
   HF ``CLIPModel`` at ViT-L/14 width (fp16 safetensors, ~0.9 GB), all
   written from seeds; FVD, KVD, IS and CLIPSIM finite (random-weight
   values), 31 x 4 UNet calls and ``PER_STEP`` x those launches; then
   I3D, C3D and the CLIP ViT built from the same files on the card
   against copies in fp32 on the CPU, on the videos the run scored
   (relative L2 <= 1e-3); an ``eval`` line (seconds per clip for
   sampling and for each scorer, the metrics, peak GB, launches);
6f. serving and eval under ``MESH_SHAPE`` ({data: 2}) on ``PAR_RANKS``
   ranks started with ``parallel.launch`` (sharing the card over gloo, as
   phase 8): ``configs/serve.yaml``'s service with the raised window,
   rank 0 the front end broadcasting each batch and the other rank
   following: the warm-up and a batch of [A, B, C, D] at 30 steps (each
   kernel's launches per batch on each rank equal to the PAB schedule's
   count under the mesh's gates, as on one card), then [A, B, C, D] at
   ``SERVE_CHECK_STEPS`` under counter 0 against phase 6e's one-card rows
   (relative L2 <= ``PAR_UNET_RTOL`` each); then phase 6d's ``eval`` run
   (its tree and files) under the mesh with ``val_batch_size`` 2: 4 clips
   scored, not 8, the UNet calls and launches per rank of one half of
   each batch, FVD, KVD, IS and CLIPSIM equal on both ranks, IS and
   CLIPSIM within ``EVAL_MESH_RTOL`` of 6d's (FVD and KVD printed beside
   6d's, not gated: 4 clips from random weights leave their covariances
   ill-conditioned); then the ``serve`` entry as 2 processes under the
   mesh (torchrun's variables) at ``SERVE_CHECK_STEPS``: warm-up, four
   concurrent POSTs (``/healthz`` 1 batch, 4 requests), a lone POST (2,
   5), a malformed one (400), SIGTERM to both ranks and each exits 0
   within ``SERVE_STOP_TIMEOUT``; a ``serving_mesh`` line (warm-up and
   batch seconds, requests/s, peak GB and launches per batch per rank,
   the rows' errors, the entry's times) and an ``eval_mesh`` line;
6g. the quality probe (``tools/quality_probe.py``) on one card at
   ``configs/serve.yaml``'s shape (``PROBE_ARGS``: 256 px, 12 frames, 2
   cond frames, DDIM 30, DPM++ 20, one warm and one timed run a mode),
   all five modes: every row finite, K1-K5 launched; a ``quality_probe``
   line (PAB's relative RMSE, every row, the summary, launches);
6h. Stable Video Diffusion XT (``phase_svd``): its UNet and temporal
   decoder at published widths on random weights, one UNet call at the
   ``svd-xt.sample.576`` cell's shapes and one 25-frame decode to
   576 x 1024, each after a warm-up and under counter 0: K2
   ``SVD_K2_PER_UNET_CALL`` times in the UNet call, K11 once a norm
   (``SVD_GN_PER_UNET_CALL``, ``SVD_GN_PER_DECODE``), outputs finite; an
   ``svd`` line per call (seconds, peak GB, launches);
7. training: the port's ``train`` entry at the same full width on a
   synthetic Something-Something-v2 tree written from a numpy seed to a
   temporary directory: 256 px, 12 frames, 2 cond frames, batch 1,
   accumulation 2 (the shipped ``configs/train.yaml`` values) with
   ``text_loss`` on, 4 optimizer steps; launch counts zeroed just before
   and read just after, each kernel must have run its count per
   micro-step, K11 ``GN_PER_UNET_CALL`` times inside each micro-step's
   UNet call; losses finite; read back
   from the checkpoint it wrote, every trainable fp32 master moved and
   every frozen SeerUNet / FSText weight equals its seeded initial value;
   the checkpoint is loaded and sampled for a few DDIM steps;
7b. training options, on phase 7's tree and config, (a) and (b) from a
   seeded base: the seeded init with every transformer's ``proj_out``
   drawn non-zero (at random init they are zero, which hides every
   attention site from the output), written as the directory the
   pretrained route reads (``pretrained_model_name_or_path`` with the
   whole SeerUNet, and ``fstext_init_ckpt``), as the JAX entry reads its
   start.  (b) ``use_8bit_adam`` on the
   reference scope, 2 optimizer steps: every trainable master moved,
   every frozen weight equal to the base's, at most 2.1 bytes of
   optimizer state per trainable parameter, s per step and peak memory
   beside phase 7's; (a) the ``train`` entry with ``lora_rank`` 8 on every
   attention projection and ``use_8bit_adam``, 2 optimizer steps: the
   first window's loss equals (b)'s (B = 0 until the first update), the
   launches per micro-step (K8 at all 5 K2 sites: every site's q, k and v
   carry adapters), every adapter's B moved off zero (weight decay cannot
   move a zero: only a gradient does) and every FSText master moved, at
   most 2.1 bytes of optimizer state per trainable parameter, the merged
   checkpoint loaded strictly by the sampling pipeline and one UNet call
   from it equal to the LoRA-applied call on the base bit for bit (and
   the same at a seeded non-zero B, ``apply_lora``'s merge against the
   applied call); (c) ``param_dtype: bfloat16`` from phase 7's init, 1
   optimizer step, masters and moments bf16, peak memory; (d) one clip
   of the tree through the native frame loader against PIL (max 0.03,
   mean 0.005), required where the machine has ``jpeglib.h``; a
   ``training_options`` line;
8. parallel: 2 ranks started with ``parallel.launch`` (NCCL with a card
   per rank, else gloo with the ranks sharing the card and collectives
   staged through pinned host memory; chosen from the card count before any
   rank starts, and printed), full width, 256 px, in the order (d), (c),
   (a), (b), (g), (h), (l):
   (a) ``inference_img``'s pipeline under ``{seq: 2}``, 12 frames,
   ``PAR_DDIM_STEPS`` DDIM steps (the ring branch), rank 0 writes the
   GIF; one UNet call compared with the single-rank call on the same
   weights and inputs;
   (b) one UNet call under ``{seq: 2}`` at 11 frames (cond 2): the frames
   do not split evenly, the ring declines and K6 runs; compared the same;
   (c) the ``train`` entry under ``{data: 2}``, ``PAR_OPT_STEPS``
   optimizer step (no warmup, as in (d)-(k)); then one micro-step's loss
   and gradients against a single-rank step on the same global batch;
   (d) the ``train`` entry under ``{seq: 2}`` at 11 frames, as many
   steps (K6 and K9), then the same check;
   (ZeRO-1 and FSDP over ``data`` run in (j) and (k), beside the ``model``
   axis, through the same ShardPlan; the data-axis-only case is held on
   the card at narrow widths by
   ``tests/test_torch_cuda.py::test_sharded_training_on_the_card``);
   in (c) and (d) the peak memory of the run without its checkpoint save
   (``peak_mem_gb``: build, data, steps) and of the save
   (``peak_mem_gb_save``), each per rank;
   (g) ``inference_img``'s pipeline under ``{model: 2}`` (tensor
   parallelism: each rank holds its Megatron slices of the attention and
   feed-forward weights), (a)'s size, rank 0 writes the GIF; one UNet call
   against rank 0's call on the whole weights (every ``proj_out`` seeded
   alike on both): relative L2 <= ``PAR_UNET_RTOL``, K1 and K2 5 times
   each a call on each rank, K3-K5 never, the all-reduces (calls and
   bytes) equal to the count worked out from the model
   (``tp_expected_allreduces``), a rank's parameter bytes the replicated
   weights plus half the split ones within ``TP_BYTES_RTOL``;
   (h) the ``train`` entry under ``{model: 2}`` with (c)'s config and
   seed: the checkpoint's keys and shapes equal to (c)'s, K1, K2, K7, K8
   launched and K3-K5 not, trainable master bytes a rank below (c)'s, then
   one micro-step's loss within ``PAR_LOSS_RTOL`` and its gradients,
   joined over the model ranks, within ``TRAIN_REF_RTOL`` of rank 0's step
   on the whole weights;
   (l) the ``train`` entry under ``{model: 2}`` with 7b's (a) config (LoRA
   rank 8 on every attention projection, 8-bit AdamW, from 7b's seeded
   base, accumulation 2, 2 optimizer steps) against (a) on one rank: the
   losses within ``PAR_LOSS_RTOL``, the checkpoint's masters (FSText and
   the adapters, joined) within relative L2 ``TRAIN_REF_RTOL`` and its
   keys and shapes (a)'s, every adapter's B moved, at most 2.1 bytes of
   optimizer state a rank's trainable parameter;
   then 4 ranks started the same way, ``{data: 2, model: 2}`` (two
   process-group axes at once), (c)'s
   config at ``PAR4_FRAMES`` frames with 2 optimizer steps of one
   micro-step each: (i) replicated, the baseline; (j) with ``zero1`` and
   ``use_8bit_adam``: the losses within ``SHARD_LOSS_RTOL`` of (i)'s, the
   masters within the 8-bit bound ``TP_8BIT_STEP_FACTOR`` gives, a rank's
   state at most half (i)'s + 1 %; (k) with ``fsdp``: the losses within
   ``SHARD_LOSS_RTOL``, the masters within ``SHARD_MASTERS_RTOL``, a rank's
   parameters at most half (i)'s + the largest unit; (j) and (k) each
   restored by one rank with no mesh (keys, masters and moments as the
   checkpoint holds them); in (i)-(l) K1, K2, K7, K8 launched, K3-K5 not,
   and per micro-step the launches and collectives in the line;
   each run's launch counts are zeroed just before and read just after, on
   every rank; a ``parallel_run`` JSON line per run;
9. floor budget: K10 (the on-chip softmax calibration) against its plain
   version at (256, 2048) and at the calibration shape (SMs x 16 rows),
   reps 0, 1, 2, 4 and 64 (the final scores element by element and the row
   sums, within 1e-5), then its time, bound (one MUFU ex2 per element per pass),
   plain and library numbers; both budget entries at their defaults through
   ``main(argv)`` (``tools/floor_budget.py``: 512 px sampling sites,
   ``tools/floor_budget_train.py``: the four 256 px training sections),
   launch counts zeroed just before and read just after each; their
   ``floor_budget`` / ``floor_budget_train`` JSON lines; every measured
   time finite and positive, the calibration at least its bound, the whole
   512 px UNet call within 0.5-2x the sum of its sites; a
   ``remat_launches`` line (one full-width micro-step under ``none``,
   ``save_attn`` and ``block``): ``save_attn`` launches the forward kernels
   as often as ``none``, ``block`` more;
10. prints the ``kernels`` line (each kernel's ``launches`` summed over
    phases 6, 6b, 6e, 6c, 6d, 6f, 6g, 6h, 7, 7b, 8 and 9, with each phase's
    own count beside it: ``sampling_launches``, ``knobs_launches``,
    ``serving_launches``, ``pretrained_launches``, ``eval_launches``,
    ``serving_mesh_launches`` and ``eval_mesh_launches`` (rank 0's),
    ``probe_launches``, ``svd_launches``, ``training_launches``,
    ``training_options_launches``, ``parallel_launches``,
    ``floor_budget_launches``), the card line and the result line; before
    them a ``phase_seconds`` line (each phase's wall seconds, which stderr
    also reports as each phase ends).

``--profile PATH`` adds where one full-width DDIM step's time goes (one
SeerUNet call's CUDA kernel time by category and the device busy share, a
``profile`` JSON line) and the same for one training forward + backward (a
``profile_train`` line); the torch.profiler tables are written to PATH and
PATH.train.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
ATOL, RTOL = 2e-2, 2e-2    # bf16 outputs, kernel vs plain version
REF_RTOL = 5e-2            # relative L2, bf16 UNet on the card vs fp32 CPU
# Backward kernels vs plain backward, dq, dk, dv each: the forward's
# elementwise bound (bf16 outputs: one ulp at |x| in [4, 8) is 0.03; the
# kernel takes p and dS as bf16 hi + lo pairs, about 16 of fp32's
# mantissa bits, where the plain version keeps fp32), and a relative L2
# bound over the whole tensor, which the rounding noise averages out of.
BWD_REL_L2 = 1e-2
LSE_ATOL = 1e-3            # natural-log lse of bf16 scores, fp32 both sides
# K6/K9 with in-kernel trig: the kernel's sincosf and the plain version's
# torch cos/sin differ by an fp32 ulp or two, so a rotated q or k element
# can round to the neighbouring bf16 value (2^-8 relative); a score then
# moves by up to scale * 2^-8 * sum |q_i k_i| over the flipped lanes, a few
# 1e-3 on randn inputs at d = 40.  The scores themselves are the same
# function; dq, dk, dv keep the common bounds.
LSE_TRIG_ATOL = 1e-2
# Training gradients, bf16 through the kernels on the card vs fp32 on the
# CPU (narrow SeerUNet): relative L2 over all trainable gradients, and the
# loosest single tensor (small bias / LayerNorm tensors carry the most
# bf16 noise relative to their own size)
TRAIN_REF_RTOL, TRAIN_REF_TENSOR_RTOL = 5e-2, 2.5e-1
TRAIN_OPT_STEPS, TRAIN_ACCUM = 4, 2
TRAIN_SAMPLE_STEPS = 5     # DDIM steps sampled from the trained checkpoint
E2E_STEPS = 30             # DDIM steps of the end-to-end run (the shipped
                           # configs/inference_base.yaml value)
KNOB_DPM_STEPS = 20        # DPM-Solver++ steps of the knob phase (trailing)
SEED = 0
# launches of each kernel per SeerUNet call (one per DDIM step with batched
# CFG) at 256 px: K1 at L0 temporal sites, K2 at L0 per-frame spatial
# attention, K3/K4 at the c = 320 text FF / temporal site tails, K5 at the
# c = 640 FF sites
PER_STEP = {"swat_attention_tables": 5, "flash_attention": 5,
            "ln_geglu_ff": 5, "ln_geglu_ff_proj": 5, "geglu_ff": 10,
            "swat_attention_tables_bwd": 0, "flash_attention_bwd": 0,
            "swat_attention": 0, "swat_attention_bwd": 0, "softmax_calib": 0}
# launches per training micro-step (batch 1, 12 frames, cond_frame 2, no
# remat): with cond_frame > 0 the temporal tails run K3 on the non-cond
# tokens, never K4, so K3 serves the 5 text and the 5 temporal c = 320
# sites; every K1 has its K7.  The first spatial site sees only frozen
# layers upstream, so autograd asks it for no gradient: 4 of the 5 K2
# launches have a K8.
PER_MICRO_STEP = {"swat_attention_tables": 5, "flash_attention": 5,
                  "ln_geglu_ff": 10, "ln_geglu_ff_proj": 0, "geglu_ff": 10,
                  "swat_attention_tables_bwd": 5, "flash_attention_bwd": 4,
                  "swat_attention": 0, "swat_attention_bwd": 0,
                  "softmax_calib": 0}
# the parallel phase: 2 ranks; a sequence-parallel UNet call must agree with
# the single-rank call within PAR_UNET_RTOL (relative L2, bf16 both); a
# parallel training step's loss within PAR_LOSS_RTOL and its gradients
# within TRAIN_REF_RTOL (relative L2 over all trainable gradients) of a
# single-rank step on the same global batch
PAR_RANKS, PAR_TIMEOUT = 2, 700
PAR_UNET_RTOL, PAR_LOSS_RTOL = 2e-2, 1e-2
# cuts of depth that keep the smoke inside its time limit: (c)-(h) take one
# optimizer step (with no warmup, so that it moves the weights), and (a)
# and (g) sample 4 DDIM steps (a clip's time is linear in its UNet calls,
# each staged through the host under a mesh)
PAR_OPT_STEPS = 1
PAR_DDIM_STEPS = 4
# phase 8 (g) / (h), {model: 2}: a rank's parameter bytes against the
# replicated weights plus half the split ones; the GEGLU kernels, which the
# JAX package's gates decline under any mesh, never run there
TP_BYTES_RTOL = 1e-2
TP_SAMPLING_KERNELS = ("swat_attention_tables", "flash_attention")
TP_TRAINING_KERNELS = ("swat_attention_tables", "flash_attention",
                       "swat_attention_tables_bwd", "flash_attention_bwd")
TP_NOT_LAUNCHED = ("ln_geglu_ff", "ln_geglu_ff_proj", "geglu_ff")
# DISK_NOTE: a full-width checkpoint is 3-10 GB, so phases 7, 7b and 8
# delete each run's output once its checks have read it (phase 8 keeps
# (c)'s for (h), and 7b's base and (a)'s for (l)): the smoke
# keeps at most about 25 GB on disk at once, well inside a 45 GiB disk
# phase 8 (i)-(k): 4 ranks, {data: 2, model: 2}, (c)'s config with
# TP_STRATEGY_OPT_STEPS optimizer steps of one micro-step each
# (accumulation under a mesh is (l)'s); (l) {model: 2} on 2 ranks, 7b's (a)
# config
PAR4_RANKS, PAR4_TIMEOUT = 4, 900
PAR4_ACCUM = 1
# (i)-(k) at 6 frames (cond 2), half (c)'s activations.  The 2-rank and
# 4-rank groups run one after the other: together they outgrow the card
# machine's host memory.  The ranks of a group take its share of the
# host's cores for intra-op threads
PAR4_FRAMES = 6
HOST_CORES = os.cpu_count() or 8
TP_STRATEGY_OPT_STEPS = 2
# (j)'s masters against (i)'s: the first update is exact under 8-bit (its
# direction uses the moments before they are quantized), the second's
# direction m_hat / (sqrt(v_hat) + eps) is at most 1.0014 in size at count
# 2 on either side, so each master differs by at most 2.01 lr_2 and the
# relative L2 by at most 2.01 lr_2 sqrt(n) / |masters|, worked out from
# the run's own numbers; with the losses (c)'s bound
TP_8BIT_STEP_FACTOR = 2.01
# phase 8 (j) / (k), zero1 and fsdp against (i): the losses, and (k)'s
# masters after the last step (relative L2)
SHARD_LOSS_RTOL, SHARD_MASTERS_RTOL = 1e-5, 1e-5
# the floor-budget phase: K10 against its plain version (fp32 both sides:
# exp2f of a log2e-scaled argument and one reciprocal per row against exp and
# a division, a few ulps apart per element; sums of 2048 terms in another
# order), at the TPU's block shape and at the calibration shape, on an input
# that spans +-K10_CHECK_SCALE * 5 (an exp without the max subtraction
# overflows there).  The row sums are 1 + cols * 1e-6 after any normalising
# pass, so the check holds the final s element by element, and the sums
# against the rows' sum of |s|, both within K10_RTOL, from 0 passes up.
# Its numbers at the calibration shape after K10_REPS passes; the whole
# 512 px UNet call against the sum of its sites
K10_RTOL = 1e-5
K10_CHECK_REPS = (0, 1, 2, 4, 64)
K10_CHECK_SCALE = 30.0
K10_REPS = 64
MUFU_EX2_PER_CLK_PER_SM = 16   # CUDA C++ Programming Guide, cc 9.0
# K11 calls a SeerUNet call at SD-1.5 widths: 22 resnets x 2, 32
# transformer sites, conv_norm_out
GN_PER_UNET_CALL = 77
# phase 6h, Stable Video Diffusion XT at its published shapes: K2 calls a
# UNet call (5 spatial self-attention sites each at 9216, 2304 and 576
# tokens; the mid block's 144 run plain), K11 calls a UNet call (22
# resnets x 4 norms, 16 transformer sites, conv_norm_out) and a 25-frame
# decode (14 resnets x 4, the mid attention's norm once a frame,
# conv_norm_out)
SVD_FRAMES, SVD_LATENT_HW = 25, (72, 128)
SVD_K2_PER_UNET_CALL = 15
SVD_GN_PER_UNET_CALL = 105
SVD_GN_PER_DECODE = 14 * 4 + SVD_FRAMES + 1
STEP_OVER_SITES = (0.5, 2.0)
FORWARD_KERNELS = ("swat_attention_tables", "flash_attention", "ln_geglu_ff",
                   "ln_geglu_ff_proj", "geglu_ff")


class SmokeFailure(RuntimeError):
    pass


class PhaseClock:
    """Each phase's wall seconds: ``clock(name)`` closes the phase begun
    at the previous call and says so on stderr, so a run cut by its time
    limit still shows how far it got."""

    def __init__(self):
        self.t0 = self.last = time.perf_counter()
        self.seconds = {}

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.last
        self.last = now
        print(f"chip_smoke: {name} done in {self.seconds[name]:.1f} s "
              f"({now - self.t0:.1f} s in all)", file=sys.stderr, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def wrappers() -> dict:
    from seervideoldm_tpu_torch.ops.kernels import launch_counters

    return launch_counters()


def reset_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


# ------------------------------------------------------------------ timing

def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, exps: float = 0.0) -> tuple[float, str]:
    """The least time for the work: the larger of the bytes over the memory
    rate and the operations over their peak rate, the tensor cores' FLOPs
    and, for a softmax, one MUFU ex2 per exponential (``exps``) at K10's
    rate (``k10_ex2_rate``)."""
    t_ops = max(flops / PEAK_BF16_FLOPS, exps / k10_ex2_rate() if exps else 0.0)
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def fused_sdpa(q, k, v, scale: float, causal: bool):
    """The library yardstick of the attention kernels: one
    ``F.scaled_dot_product_attention`` call on 4-D views (1, B, n, d) of
    (B, n, d) tensors, the layout its fused backends take (a 3-D call falls
    back to the unfused math path).  Returns (call, backend, context): the
    flash backend where it takes the shape, else the memory-efficient one;
    ``context()`` allows that backend alone, so a refusal raises instead of
    falling to the math path."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q4, k4, v4 = (t.unsqueeze(0) for t in (q, k, v))

    def call():
        return F.scaled_dot_product_attention(q4, k4, v4, scale=scale,
                                              is_causal=causal)

    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION):
        try:
            with sdpa_kernel(backend):
                call()
        except RuntimeError:
            continue
        return call, backend.name, lambda b=backend: sdpa_kernel(b)
    raise SmokeFailure(f"no fused SDPA backend takes {tuple(q4.shape)}")


def fused_sdpa_grad(q, k, v, g, scale: float, causal: bool):
    """The backward yardstick: the backward of ``fused_sdpa`` alone, as the
    card runs it.  Its forward runs once, here, on copies of q, k, v that
    require a gradient, on a side stream (where autograd then runs its
    backward), and keeps its graph.  ``torch.autograd.grad`` of that
    output (``retain_graph``) is captured once in a CUDA graph and held
    against an eager call (relative L2 <= BWD_REL_L2 on each gradient);
    the timed call replays the graph: the library's backward kernels
    without the autograd engine's host time, which paces an eager call at
    the smaller shapes."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    # every node of the autograd graph is made on the side stream, so the
    # backward runs there alone (a node on the default stream would join
    # it to the capture)
    with torch.cuda.stream(side):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        call, backend, context = fused_sdpa(*leaves, scale, causal)
        g4 = g.unsqueeze(0)
        with context():
            out = call()
        for _ in range(3):  # warm-up before the capture, on its stream
            eager = torch.autograd.grad(out, leaves, g4, retain_graph=True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = torch.autograd.grad(out, leaves, g4, retain_graph=True)
    graph.replay()
    torch.cuda.synchronize()
    for got, want in zip(captured, eager):
        err = float((got.float() - want.float()).norm() / want.float().norm())
        require(err <= BWD_REL_L2, f"SDPA backward in a CUDA graph: "
                f"relative L2 {err} from the eager call")
    return graph.replay, backend, context


# ----------------------------------------------------------- kernel checks

def _randn(shape, gen, dtype, scale=1.0):
    import torch

    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def _as_path_calls(case: dict, inputs, grad: bool) -> dict:
    """The case's forward calls made the way a main path makes them.
    Sampling (``grad`` false): under ``no_grad``.  Training: the wrapper is
    called under ``enable_grad`` on ``inputs`` that require a gradient, so
    it goes through its ``autograd.Function`` (for the attentions the
    log-sum-exp writing launch) and its result must carry a ``grad_fn``;
    the plain version and the library call stay forward-only."""
    import torch

    for t in inputs:
        t.requires_grad_(grad)
    wrapper = case["kernel"]

    def kernel():
        with torch.set_grad_enabled(grad):
            out = wrapper()
        require(not grad or out.grad_fn is not None,
                f"{case['name']}: no grad_fn on a result that needs a gradient")
        return out.detach()

    def forward_only(fn):
        def call():
            with torch.no_grad():
                return fn()
        return call

    case.update(kernel=kernel, plain=forward_only(case["plain"]),
                library=forward_only(case["library"]))
    if grad:
        case["shape"] += ", autograd forward"
    return case


def case_flash(gen, batch, n, d, causal=False, grad=False):
    import torch

    from seervideoldm_tpu_torch.ops.kernels import flash_attention as K

    bf = torch.bfloat16
    q, k, v = (_randn((batch, n, d), gen, bf) for _ in range(3))
    scale = d ** -0.5
    pairs = n * (n + 1) // 2 if causal else n * n
    library, backend, context = fused_sdpa(q, k, v, scale, causal)
    return _as_path_calls(dict(
        name="flash_attention", kernel=lambda: K.flash_attention(q, k, v, scale, causal),
        plain=lambda: K.flash_attention_plain(q, k, v, scale, causal),
        library=library, library_backend=backend, library_context=context,
        flops=4.0 * batch * pairs * d, exps=float(batch * pairs),
        # q, k, v read, o written (bf16); the autograd forward also writes lse
        nbytes=4.0 * batch * n * d * 2 + (4.0 * batch * n if grad else 0.0),
        plan=K.plan(batch, n, n, d, causal),
        shape=f"({batch}, {n}, {d}){' causal' if causal else ''}"),
        (q, k, v), grad)


def case_flash_rows(gen, batch, n, d):
    """``case_flash`` (sampling, not causal) whose plain version runs one
    row of the batch at a time: Stable Video Diffusion's spatial
    self-attention, where the whole batch's fp32 logits would not fit
    (250 rows of 9216^2 are 85 GB)."""
    import torch

    from seervideoldm_tpu_torch.ops.kernels import flash_attention as K

    bf = torch.bfloat16
    q, k, v = (_randn((batch, n, d), gen, bf) for _ in range(3))
    scale = d ** -0.5
    library, backend, context = fused_sdpa(q, k, v, scale, False)

    def plain():
        return torch.cat([K.flash_attention_plain(q[i:i + 1], k[i:i + 1],
                                                  v[i:i + 1], scale)
                          for i in range(batch)])

    return _as_path_calls(dict(
        name="flash_attention", kernel=lambda: K.flash_attention(q, k, v, scale),
        plain=plain, library=library, library_backend=backend,
        library_context=context, flops=4.0 * batch * n * n * d,
        exps=float(batch * n * n), nbytes=4.0 * batch * n * d * 2,
        plan=K.plan(batch, n, n, d),
        shape=f"({batch}, {n}, {d}), plain row by row"), (q, k, v), False)


def case_swat(gen, batch, f, h, d, grad=False):
    import torch

    from seervideoldm_tpu_torch.ops.kernels import swat_attention as K
    from seervideoldm_tpu_torch.ops.rotary import rotary_tables
    from seervideoldm_tpu_torch.ops.windows import window_partition

    bf, ws = torch.bfloat16, 8
    q, k, v = (_randn((batch, f, h, h, d), gen, bf) for _ in range(3))
    cos, sin = rotary_tables(f, h, h, d, min(32, d), device="cuda")
    scale = d ** -0.5
    qw, kw, vw = (window_partition(t, ws) for t in (q, k, v))
    tokens = f * ws * ws
    windows = batch * (h // ws) ** 2
    library, backend, context = fused_sdpa(qw, kw, vw, scale, True)
    return _as_path_calls(dict(
        name="swat_attention_tables",
        kernel=lambda: K.swat_attention_tables(q, k, v, cos, sin, scale, True, ws),
        plain=lambda: K.swat_attention_tables_plain(q, k, v, cos, sin, scale, True, ws),
        library=library, library_backend=backend, library_context=context,
        library_note="SDPA on window-partitioned q, k, v made outside the "
                     "timed call; no rotation",
        flops=4.0 * windows * d * tokens * (tokens + 1) / 2,
        exps=windows * tokens * (tokens + 1) / 2,
        nbytes=(4.0 * q.numel() * 2 + 2.0 * cos.numel() * 4
                + (4.0 * batch * f * h * h if grad else 0.0)),
        plan=K.plan(batch, f, h, h, d),
        shape=f"({batch}, {f}, {h}, {h}, {d}) ws 8 causal"), (q, k, v), grad)


def case_flash_bwd(gen, batch, n, d, causal=False, m=None):
    """K8 against the explicit plain backward; the forward kernel's lse
    against logsumexp of the plain scores.  Library yardstick: SDPA's
    backward alone (``fused_sdpa_grad``)."""
    import math

    import torch

    from seervideoldm_tpu_torch.ops.kernels import flash_attention as K

    bf, m = torch.bfloat16, m or n
    q, g = (_randn((batch, n, d), gen, bf) for _ in range(2))
    k, v = (_randn((batch, m, d), gen, bf) for _ in range(2))
    scale = d ** -0.5
    _, lse = K._launch_fwd(q, k, v, scale, causal, want_lse=True)

    def lse_err():
        sub = slice(0, min(batch, 4))
        logits = torch.matmul(q[sub].float(), k[sub].float().transpose(1, 2)) * scale
        if causal:
            keep = torch.ones(n, m, dtype=torch.bool, device="cuda").tril()
            logits = logits.masked_fill(~keep, float("-inf"))
        want = torch.logsumexp(logits, dim=-1)
        return float((lse[sub] * math.log(2.0) - want).abs().max())

    library, backend, context = fused_sdpa_grad(q, k, v, g, scale, causal)
    pairs = n * (n + 1) // 2 if causal else n * m
    return dict(
        name="flash_attention_bwd",
        kernel=lambda: K.flash_attention_bwd(q, k, v, lse, g, scale, causal),
        kernel_with=lambda cwg: K._launch_bwd(q, k, v, lse, g, scale, causal,
                                              (True,) * 3, cwg),
        head_dim=d,
        plain=lambda: K.flash_attention_bwd_plain(q, k, v, g, scale, causal),
        library=library, library_backend=backend, library_context=context,
        library_note="SDPA's backward alone: autograd.grad of an output "
                     "whose forward ran outside the timed call, replayed "
                     "from a CUDA graph",
        lse_err=lse_err, backward=True,
        # p recomputed once per visible score
        flops=10.0 * batch * pairs * d, exps=float(batch * pairs),
        # q, k, v, g read, dq, dk, dv written (bf16); lse read (fp32)
        nbytes=2.0 * batch * d * (3 * n + 4 * m) + 4.0 * batch * n,
        shape=f"({batch}, {n}{'' if m == n else f' x {m}'}, {d})"
              f"{' causal' if causal else ''}")


def case_swat_bwd(gen, batch, f, h, d):
    """K7 against the explicit plain backward.  Library yardstick: SDPA's
    backward alone (``fused_sdpa_grad``) on window-partitioned inputs, no
    rotary."""
    import math

    import torch

    from seervideoldm_tpu_torch.ops.kernels import swat_attention as K
    from seervideoldm_tpu_torch.ops.rotary import rotary_tables
    from seervideoldm_tpu_torch.ops.windows import window_partition

    bf, ws = torch.bfloat16, 8
    q, k, v, g = (_randn((batch, f, h, h, d), gen, bf) for _ in range(4))
    cos, sin = rotary_tables(f, h, h, d, min(32, d), device="cuda")
    scale = d ** -0.5
    _, lse = K._launch_fwd(q, k, v, cos, sin, scale, True, ws, want_lse=True)
    tokens = f * ws * ws
    windows = batch * (h // ws) ** 2

    def lse_err():
        qr, kr = (K.rotate_tables(t[:1], cos, sin) for t in (q, k))
        qw, kw = window_partition(qr, ws), window_partition(kr, ws)
        logits = torch.matmul(qw.float(), kw.float().transpose(1, 2)) * scale
        keep = torch.ones(tokens, tokens, dtype=torch.bool, device="cuda").tril()
        want = torch.logsumexp(logits.masked_fill(~keep, float("-inf")), dim=-1)
        got = window_partition(lse[:1, ..., None], ws)[..., 0] * math.log(2.0)
        return float((got - want).abs().max())

    library, backend, context = fused_sdpa_grad(
        *(window_partition(t, ws) for t in (q, k, v, g)), scale, True)
    return dict(
        name="swat_attention_tables_bwd",
        kernel=lambda: K.swat_attention_tables_bwd(q, k, v, cos, sin, lse, g,
                                                   scale, True, ws),
        kernel_with=lambda cwg: K._launch_tab_bwd(
            q, k, v, cos, sin, lse, g, scale, True, ws, (True,) * 3, cwg),
        head_dim=d,
        plain=lambda: K.swat_attention_tables_bwd_plain(q, k, v, cos, sin, g,
                                                        scale, True, ws),
        library=library, library_backend=backend, library_context=context,
        library_note="SDPA's backward alone (autograd.grad of an output "
                     "whose forward ran outside the timed call, replayed "
                     "from a CUDA graph) on window-partitioned q, k, v; no "
                     "rotation",
        lse_err=lse_err, backward=True,
        # 5 products x 2 * tokens^2 * d per window, times (f + 1) / (2 f):
        # the share of 64 x 64 tiles on or below the causal diagonal; p
        # recomputed once per visible score
        flops=10.0 * windows * tokens * tokens * d * (f + 1) / (2.0 * f),
        exps=windows * tokens * (tokens + 1) / 2,
        # q, k, v, g read, dq, dk, dv written (bf16); tables, lse read
        nbytes=7.0 * q.numel() * 2 + 2.0 * cos.numel() * 4 + 4.0 * lse.numel(),
        shape=f"({batch}, {f}, {h}, {h}, {d}) ws 8 causal")


def case_swat6(gen, batch, f, h, d, rot_dim, grad=False):
    """K6 against its plain version; library yardstick: SDPA on pre-rotated,
    window-partitioned inputs."""
    import torch

    from seervideoldm_tpu_torch.ops.kernels import swat_attention as K
    from seervideoldm_tpu_torch.ops.windows import window_partition

    bf, ws = torch.bfloat16, 8
    q, k, v = (_randn((batch, f, h, h, d), gen, bf) for _ in range(3))
    scale = d ** -0.5
    qw, kw, vw = (window_partition(t, ws) for t in (q, k, v))
    tokens = f * ws * ws
    windows = batch * (h // ws) ** 2
    library, backend, context = fused_sdpa(qw, kw, vw, scale, True)
    return _as_path_calls(dict(
        name="swat_attention",
        kernel=lambda: K.swat_attention(q, k, v, scale, True, ws, rot_dim),
        plain=lambda: K.swat_attention_plain(q, k, v, scale, True, ws, rot_dim),
        library=library, library_backend=backend, library_context=context,
        library_note="SDPA on window-partitioned q, k, v made outside the "
                     "timed call; no rotation",
        flops=4.0 * windows * d * tokens * (tokens + 1) / 2,
        exps=windows * tokens * (tokens + 1) / 2,
        plan=K.plan(batch, f, h, h, d),
        # q, k, v read, o written (bf16), no tables; lse when it writes one
        nbytes=4.0 * q.numel() * 2 + (4.0 * batch * f * h * h if grad else 0.0),
        shape=f"({batch}, {f}, {h}, {h}, {d}) ws 8 causal rot_dim {rot_dim}"),
        (q, k, v), grad)


def case_swat6_bwd(gen, batch, f, h, d, rot_dim):
    """K9 against the explicit plain backward; the K6 forward's lse against
    logsumexp of the plain scores.  Library yardstick: SDPA's backward
    alone (``fused_sdpa_grad``) on window-partitioned inputs."""
    import math

    import torch

    from seervideoldm_tpu_torch.ops.kernels import swat_attention as K
    from seervideoldm_tpu_torch.ops.rotary import rotary_tables
    from seervideoldm_tpu_torch.ops.windows import window_partition

    bf, ws = torch.bfloat16, 8
    q, k, v, g = (_randn((batch, f, h, h, d), gen, bf) for _ in range(4))
    scale = d ** -0.5
    _, lse = K._launch_swat_fwd(q, k, v, scale, True, ws, rot_dim,
                                want_lse=True)
    tokens = f * ws * ws
    windows = batch * (h // ws) ** 2

    def lse_err():
        qr, kr = q[:1], k[:1]
        if rot_dim:
            cos, sin = rotary_tables(f, h, h, d, rot_dim, device="cuda")
            qr, kr = (K.rotate_tables(t, cos, sin) for t in (qr, kr))
        qw, kw = window_partition(qr, ws), window_partition(kr, ws)
        logits = torch.matmul(qw.float(), kw.float().transpose(1, 2)) * scale
        keep = torch.ones(tokens, tokens, dtype=torch.bool, device="cuda").tril()
        want = torch.logsumexp(logits.masked_fill(~keep, float("-inf")), dim=-1)
        got = window_partition(lse[:1, ..., None], ws)[..., 0] * math.log(2.0)
        return float((got - want).abs().max())

    library, backend, context = fused_sdpa_grad(
        *(window_partition(t, ws) for t in (q, k, v, g)), scale, True)
    return dict(
        name="swat_attention_bwd", lse_atol=LSE_TRIG_ATOL if rot_dim else
        LSE_ATOL,
        kernel=lambda: K.swat_attention_bwd(q, k, v, lse, g, scale, True, ws,
                                            rot_dim),
        kernel_with=lambda cwg: K._launch_swat_bwd(
            q, k, v, lse, g, scale, True, ws, rot_dim, (True,) * 3, cwg),
        head_dim=d,
        plain=lambda: K.swat_attention_bwd_plain(q, k, v, g, scale, True, ws,
                                                 rot_dim),
        library=library, library_backend=backend, library_context=context,
        library_note="SDPA's backward alone (autograd.grad of an output "
                     "whose forward ran outside the timed call, replayed "
                     "from a CUDA graph) on window-partitioned q, k, v; no "
                     "rotation",
        lse_err=lse_err, backward=True,
        flops=10.0 * windows * tokens * tokens * d * (f + 1) / (2.0 * f),
        exps=windows * tokens * (tokens + 1) / 2,
        nbytes=7.0 * q.numel() * 2 + 4.0 * lse.numel(),
        shape=f"({batch}, {f}, {h}, {h}, {d}) ws 8 causal rot_dim {rot_dim}")


def case_geglu(gen, mode, n, c, grad=False):
    import torch
    import torch.nn.functional as F

    from seervideoldm_tpu_torch.ops.kernels import geglu_ff as K

    bf, inner = torch.bfloat16, 4 * c
    x = _randn((n, c), gen, bf)
    w1 = _randn((2 * inner, c), gen, bf, c ** -0.5)
    b1 = _randn((2 * inner,), gen, bf, 0.1)
    w2 = _randn((c, inner), gen, bf, inner ** -0.5)
    b2 = _randn((c,), gen, bf, 0.1)
    gamma = 1.0 + _randn((c,), gen, torch.float32, 0.1)
    beta = _randn((c,), gen, torch.float32, 0.1)
    w3 = _randn((c, c), gen, bf, c ** -0.5)
    b3 = _randn((c,), gen, bf, 0.1)
    res = _randn((n, c), gen, bf)
    flops = 6.0 * n * c * inner
    nbytes = 2.0 * (2 * n * c + 3 * c * inner)

    def chain(xin):
        hg = F.linear(xin, w1, b1)
        a = hg[:, :inner] * F.gelu(hg[:, inner:])
        return F.linear(a, w2, b2)

    def halves():
        """The up and down kernels alone against their plain versions (the
        down kernel fed the plain ``a``), and each one's time."""
        with torch.no_grad():
            up = lambda: K.geglu_up(x, gamma, beta, w1, b1, mode > 0)  # noqa: E731
            a = K.geglu_up_plain(x, gamma, beta, w1, b1, mode > 0)
            down = lambda: K.geglu_down(a, w2, b2, x, w3, b3, res, mode)  # noqa: E731
            up_err, up_ok = _elementwise(up(), a)
            down_err, down_ok = _elementwise(
                down(), K.geglu_down_plain(a, w2, b2, x, w3, b3, res, mode))
            return dict(up_max_abs_err=up_err, down_max_abs_err=down_err,
                        up_ok=up_ok, down_ok=down_ok, up_ms=time_ms(up),
                        down_ms=time_ms(down), plan=K.plan(n, c, inner, mode))

    if mode == 0:
        case = dict(name="geglu_ff", kernel=lambda: K.geglu_ff(x, w1, b1, w2, b2),
                    plain=lambda: K.geglu_ff_plain(x, w1, b1, w2, b2),
                    library=lambda: chain(x), flops=flops, nbytes=nbytes,
                    halves=halves, shape=f"({n}, {c}) inner {inner}")
        return _as_path_calls(case, (x,), grad)
    ln = lambda: F.layer_norm(x.float(), (c,), gamma, beta, K.LN_EPS).to(bf)  # noqa: E731
    if mode == 1:
        case = dict(name="ln_geglu_ff",
                    kernel=lambda: K.ln_geglu_ff(x, gamma, beta, w1, b1, w2, b2),
                    plain=lambda: K.ln_geglu_ff_plain(x, gamma, beta, w1, b1, w2, b2),
                    library=lambda: chain(ln()) + x, flops=flops, nbytes=nbytes,
                    halves=halves, shape=f"({n}, {c}) inner {inner}")
        return _as_path_calls(case, (x,), grad)
    case = dict(name="ln_geglu_ff_proj",
                kernel=lambda: K.ln_geglu_ff_proj(x, gamma, beta, w1, b1, w2, b2,
                                                  w3, b3, res),
                plain=lambda: K.ln_geglu_ff_proj_plain(x, gamma, beta, w1, b1, w2,
                                                       b2, w3, b3, res),
                library=lambda: F.linear(chain(ln()) + x, w3, b3) + res,
                flops=flops + 2.0 * n * c * c,
                nbytes=nbytes + 2.0 * (n * c + c * c), halves=halves,
                shape=f"({n}, {c}) inner {inner}")
    return _as_path_calls(case, (x, res), grad)



def case_group_norm(gen, shape, groups, eps, silu, grad=False):
    """K11 at a main-path shape: bf16 ``x`` (channels last), an fp32 affine
    near (1, 0); the library yardstick is ``F.group_norm`` (+ ``F.silu``)
    on the channels-first view, which the port never calls.  ``grad``:
    the training path's call, a ``GroupNorm`` module's under autograd
    (``GroupNormFn``), its gradients checked beside its output."""
    import torch
    import torch.nn.functional as F

    from seervideoldm_tpu_torch.ops import norms
    from seervideoldm_tpu_torch.ops.kernels import group_norm as GN

    x = _randn(shape, gen, torch.bfloat16)
    c = shape[-1]
    weight = 1.0 + _randn((c,), gen, torch.float32, 0.1)
    bias = _randn((c,), gen, torch.float32, 0.1)
    w16, b16 = weight.to(x.dtype), bias.to(x.dtype)
    if grad:
        norm = norms.GroupNorm(groups, c, eps).cuda()
        with torch.no_grad():
            norm.weight.copy_(weight)
            norm.bias.copy_(bias)
        dy = _randn(shape, gen, torch.bfloat16)

    def plain():
        mean, rstd = norms.group_norm_moments_plain(x, groups, eps)
        return norms.group_norm_apply_plain(x, mean, rstd, weight, bias, silu)

    def library():
        y = F.group_norm(x.movedim(-1, 1), groups, w16, b16, eps)
        return F.silu(y) if silu else y

    def kernel():
        if grad:
            return norms.group_norm_silu(norm, x) if silu else norm(x)
        return GN.group_norm(x, groups, eps, weight, bias, silu)

    def checks():
        row = GN.check_against_plain(x, groups, eps, weight, bias, silu)
        if grad:
            grads = GN.check_gradients_against_plain(norm, x, dy, silu)
            row["checks_ok"] = row["checks_ok"] and grads.pop("checks_ok")
            row.update(grads)
        return row

    case = dict(name="group_norm", kernel=kernel, plain=plain,
                library=library, flops=0.0, nbytes=4.0 * x.numel(),
                checks=checks, shape=f"{tuple(shape)} groups {groups} eps "
                                     f"{eps} silu {silu}")
    return _as_path_calls(case, (x,), grad)

KERNEL_META = {
    "swat_attention_tables": (
        "seervideoldm_tpu_torch/csrc/swat_attention.cu",
        "seervideoldm_tpu/ops/pallas/swat_attention.py:566"),
    "flash_attention": (
        "seervideoldm_tpu_torch/csrc/flash_attention.cu",
        "seervideoldm_tpu/ops/pallas/flash_attention.py:249"),
    "ln_geglu_ff": ("seervideoldm_tpu_torch/csrc/geglu_ff.cu",
                    "seervideoldm_tpu/ops/pallas/geglu_ff.py:304"),
    "ln_geglu_ff_proj": ("seervideoldm_tpu_torch/csrc/geglu_ff.cu",
                         "seervideoldm_tpu/ops/pallas/geglu_ff.py:388"),
    "geglu_ff": ("seervideoldm_tpu_torch/csrc/geglu_ff.cu",
                 "seervideoldm_tpu/ops/pallas/geglu_ff.py:217"),
    "swat_attention_tables_bwd": (
        "seervideoldm_tpu_torch/csrc/swat_attention.cu",
        "seervideoldm_tpu/ops/pallas/swat_attention.py:502"),
    "flash_attention_bwd": (
        "seervideoldm_tpu_torch/csrc/flash_attention.cu",
        "seervideoldm_tpu/ops/pallas/flash_attention.py:331"),
    "swat_attention": (
        "seervideoldm_tpu_torch/csrc/swat_attention.cu",
        "seervideoldm_tpu/ops/pallas/swat_attention.py:850"),
    "swat_attention_bwd": (
        "seervideoldm_tpu_torch/csrc/swat_attention.cu",
        "seervideoldm_tpu/ops/pallas/swat_attention.py:801"),
    "softmax_calib": ("seervideoldm_tpu_torch/csrc/softmax_calib.cu",
                      "tools/floor_budget.py:110"),
    "group_norm": ("seervideoldm_tpu_torch/csrc/group_norm.cu",
                   "none: seervideoldm_tpu/ops/norms.py:15 GroupNorm is "
                   "left to XLA"),
}


# (main path that gives the kernel this shape, or None; function that makes
# the case; its arguments after the generator).  The first case of a kernel
# on a main path gives the numbers of its entry in the `kernels` line.
KERNEL_CASES = (
    ("sampling", case_swat, (16, 12, 32, 40)),
    ("sampling", case_flash, (192, 1024, 40)),
    ("sampling", case_geglu, (1, 24576, 320)),
    ("sampling", case_geglu, (2, 24576, 320)),
    ("sampling", case_geglu, (0, 6144, 640)),
    ("training", case_swat_bwd, (8, 12, 32, 40)),
    ("training", case_flash_bwd, (96, 1024, 40)),
    (None, case_swat, (16, 12, 64, 40)),
    (None, case_swat, (16, 12, 32, 80)),
    (None, case_flash, (192, 4096, 40)),
    (None, case_flash, (192, 1024, 80)),
    (None, case_flash, (16, 1024, 40, True)),
    (None, case_flash, (8, 8192, 40)),
    (None, case_geglu, (1, 98304, 320)),
    (None, case_geglu, (2, 98304, 320)),
    (None, case_geglu, (0, 24576, 640)),
    (None, case_swat_bwd, (8, 12, 64, 40)),
    (None, case_swat_bwd, (8, 12, 32, 80)),
    (None, case_flash_bwd, (96, 4096, 40)),
    (None, case_flash_bwd, (96, 1024, 80)),
    (None, case_flash_bwd, (16, 1024, 40, True)),
    (None, case_flash_bwd, (12, 1000, 40, False, 712)),
    # the forward kernels as the training path calls them (appended, so the
    # cases above keep their draws from the shared generator)
    ("training", case_swat, (8, 12, 32, 40, True)),
    ("training", case_flash, (96, 1024, 40, False, True)),
    ("training", case_geglu, (1, 12288, 320, True)),
    ("training", case_geglu, (1, 10240, 320, True)),
    ("training", case_geglu, (0, 3072, 640, True)),
    ("training", case_geglu, (0, 2560, 640, True)),
    # K6 and K9: the sequence-parallel path's shapes first (whole videos of
    # bh / 2 per rank at 11 frames: the sampling call's CFG batch 2, the
    # training step's batch 1), then the 12-frame 256 / 512 px shapes
    ("parallel", case_swat6, (8, 11, 32, 40, 0)),
    ("parallel", case_swat6, (4, 11, 32, 40, 0, True)),
    ("parallel", case_swat6_bwd, (4, 11, 32, 40, 0)),
    (None, case_swat6, (16, 12, 32, 40, 0)),
    (None, case_swat6, (16, 12, 64, 40, 0)),
    (None, case_swat6, (16, 12, 32, 80, 0)),
    (None, case_swat6, (16, 12, 32, 40, 32)),
    (None, case_swat6_bwd, (8, 12, 32, 40, 0)),
    (None, case_swat6_bwd, (8, 12, 32, 40, 32)),
    (None, case_swat6_bwd, (8, 12, 32, 80, 0)),
    (None, case_swat6_bwd, (8, 12, 32, 80, 32)),
    # the sampling-knob path (appended, so the cases above keep their
    # draws): K2 at the ToMe lengths of the 256 px L0 sites (ratio 0.5 and
    # 0.3), then the no-gradient batch-1 forwards of the UNet calls
    # outside a guidance interval
    ("knobs", case_flash, (192, 512, 40)),
    ("knobs", case_flash, (192, 717, 40)),
    ("knobs", case_swat, (8, 12, 32, 40)),
    ("knobs", case_flash, (96, 1024, 40)),
    ("knobs", case_geglu, (1, 12288, 320)),
    ("knobs", case_geglu, (2, 12288, 320)),
    ("knobs", case_geglu, (0, 3072, 640)),
    # the serving path (appended, so the cases above keep their draws):
    # configs/serve.yaml's batch of serve_max_batch 4 at 256 px, CFG batch
    # 8, no gradient
    ("serving", case_swat, (64, 12, 32, 40)),
    ("serving", case_flash, (768, 1024, 40)),
    ("serving", case_geglu, (1, 98304, 320)),
    ("serving", case_geglu, (2, 98304, 320)),
    ("serving", case_geglu, (0, 24576, 640)),
    # the tensor-parallel path under {model: 2} (appended, so the cases
    # above keep their draws): half the heads a rank.  Sampling's K1 at
    # (8, 12, 32, 40) and K2 at (96, 1024, 40) are the knob rows' shapes;
    # training's, batch 1, are new
    ("tensor_parallel", case_swat, (4, 12, 32, 40, True)),
    ("tensor_parallel", case_flash, (48, 1024, 40, False, True)),
    ("tensor_parallel", case_swat_bwd, (4, 12, 32, 40)),
    ("tensor_parallel", case_flash_bwd, (48, 1024, 40)),
    # phase 8 (i)-(k): the same under {data: 2, model: 2} at PAR4_FRAMES
    # (appended, so the cases above keep their draws)
    ("tensor_parallel", case_swat, (4, 6, 32, 40, True)),
    ("tensor_parallel", case_flash, (24, 1024, 40, False, True)),
    ("tensor_parallel", case_swat_bwd, (4, 6, 32, 40)),
    ("tensor_parallel", case_flash_bwd, (24, 1024, 40)),
    # K11 (appended, so the cases above keep their draws): the serving
    # path's UNet level 0 (CFG batch 8, 12 frames, 32 x 32: the resnets'
    # c = 320 and the up path's c = 960, SiLU on) and level 2 (8 x 8,
    # c = 1280, a transformer site's norm, SiLU off), the VAE decoder's top
    # level (one clip's 12 frames at 256 x 256, c = 128, 4 channels a
    # group), then odd shapes: rows no multiple of a CTA's slices, one
    # batch element, eps 1e-5, c / groups of 10 and 30
    ("serving", case_group_norm, ((8, 12, 32, 32, 320), 32, 1e-6, True)),
    ("serving", case_group_norm, ((8, 12, 32, 32, 960), 32, 1e-6, True)),
    ("serving", case_group_norm, ((8, 12, 8, 8, 1280), 32, 1e-6, False)),
    ("sampling", case_group_norm, ((12, 256, 256, 128), 32, 1e-6, True)),
    (None, case_group_norm, ((2, 12, 64, 64, 320), 32, 1e-6, True)),
    (None, case_group_norm, ((1, 7, 13, 11, 640), 32, 1e-5, False)),
    (None, case_group_norm, ((3, 5, 9, 9, 1920), 64, 1e-5, True)),
    # K11 at a 256 px sampling UNet call's norms (CFG batch 2, 12 frames,
    # 2 x per_b CTAs of the serving rows' batch 8): every channel count a
    # call normalises, each at a level where it runs, the resnets' SiLU on
    # and the transformer sites' off; then the training micro-step's
    # (batch 1, under autograd: GroupNormFn forward, the plain halves'
    # gradients)
    ("sampling", case_group_norm, ((2, 12, 32, 32, 320), 32, 1e-6, True)),
    ("sampling", case_group_norm, ((2, 12, 32, 32, 320), 32, 1e-6, False)),
    ("sampling", case_group_norm, ((2, 12, 16, 16, 640), 32, 1e-6, True)),
    ("sampling", case_group_norm, ((2, 12, 32, 32, 960), 32, 1e-6, True)),
    ("sampling", case_group_norm, ((2, 12, 8, 8, 1280), 32, 1e-6, False)),
    ("sampling", case_group_norm, ((2, 12, 4, 4, 1280), 32, 1e-6, True)),
    ("sampling", case_group_norm, ((2, 12, 16, 16, 1920), 32, 1e-6, True)),
    ("sampling", case_group_norm, ((2, 12, 8, 8, 2560), 32, 1e-6, True)),
    ("training", case_group_norm, ((1, 12, 32, 32, 320), 32, 1e-6, True,
                                   True)),
    ("training", case_group_norm, ((1, 12, 32, 32, 320), 32, 1e-6, False,
                                   True)),
    ("training", case_group_norm, ((1, 12, 16, 16, 640), 32, 1e-6, True,
                                   True)),
    ("training", case_group_norm, ((1, 12, 8, 8, 1280), 32, 1e-6, False,
                                   True)),
    ("training", case_group_norm, ((1, 12, 16, 16, 1920), 32, 1e-6, True,
                                   True)),
    # K2 at Stable Video Diffusion XT's spatial self-attention (appended,
    # so the cases above keep their draws): 576 x 1024 latents, 25 frames,
    # CFG batch 2, head dim 64; level 0 (5 heads, 9216 tokens: the streamed
    # kv > 4096 form) and level 1 (10 heads, 2304 tokens)
    ("svd", case_flash_rows, (250, 9216, 64)),
    ("svd", case_flash_rows, (500, 2304, 64)),
    # then level 2 (20 heads, 576 tokens); K3 at level 0's 50 x 9216 rows
    # (the spatial and the temporal FFs alike, c = 320) and K5 at level 1's
    # 50 x 2304 (c = 640); K11 per frame (the 50 frames folded into the
    # batch) at levels 0-2, over the clip's 25 frames (a temporal resnet's
    # norm at level 0) and at the temporal decoder's top level (one clip,
    # 25 frames at 576 x 1024, c = 128: 1.9 G elements)
    ("svd", case_flash, (1000, 576, 64)),
    ("svd", case_geglu, (1, 460800, 320)),
    ("svd", case_geglu, (0, 115200, 640)),
    ("svd", case_group_norm, ((50, 72, 128, 320), 32, 1e-6, True)),
    ("svd", case_group_norm, ((50, 72, 128, 320), 32, 1e-6, False)),
    ("svd", case_group_norm, ((50, 36, 64, 640), 32, 1e-6, True)),
    ("svd", case_group_norm, ((50, 18, 32, 1280), 32, 1e-6, False)),
    ("svd", case_group_norm, ((2, 25, 72, 128, 320), 32, 1e-6, True)),
    ("svd", case_group_norm, ((1, 25, 576, 1024, 128), 32, 1e-5, True)),
)


def kernel_cases(gen):
    """(path, case) pairs, each case built when it is reached: the 256 px
    main-path shapes first (sampling: CFG batch 2, 12 frames, 8 heads; the
    backward kernels: training, batch 1), then the 512 px shapes (attention
    at d = 40 at L0 and d = 80 at L1, the c = 320 LN forms at L0, the
    c = 640 FF at L1), a causal flash case and the streamed kv > 4096 flash
    form; for the backward also a causal n = m case and a non-causal n != m
    case with ragged tiles; last the forward kernels at the training path's
    shapes (batch 1; the c = 320 LN form sees the 12288 tokens of a text
    site and the 10240 non-cond tokens of a temporal site, the c = 640 FF
    3072 and 2560); then K6 and K9 at the sequence-parallel path's shapes
    and at the 256 / 512 px shapes, in both rotation modes; then the
    sampling-knob path's shapes and the serving path's (CFG batch 8)."""
    for path, build, args in KERNEL_CASES:
        yield path, build(gen, *args)


def _elementwise(got, want) -> tuple[float, bool]:
    """Max abs error and the ATOL + RTOL element-by-element bound, bf16
    outputs compared in fp32; the result must be finite."""
    import torch

    torch.cuda.synchronize()
    g32, w32 = got.float(), want.float()
    err = (g32 - w32).abs()
    return float(err.max()), bool(torch.isfinite(got).all()) and bool(
        (err <= ATOL + RTOL * w32.abs()).all())


def check_case(case: dict) -> dict:
    import torch

    backward = case.get("backward", False)
    got = case["kernel"]()
    want = case["plain"]()
    torch.cuda.synchronize()
    if not backward:
        got, want = (got,), (want,)
    max_abs, rel_l2, ok = 0.0, 0.0, True
    for g, w in zip(got, want):
        g32, w32 = g.float(), w.float()
        err = (g32 - w32).abs()
        max_abs = max(max_abs, float(err.max()))
        rel_l2 = max(rel_l2, float((g32 - w32).norm() / w32.norm()))
        ok = (ok and bool(torch.isfinite(g).all())
              and bool((err <= ATOL + RTOL * w32.abs()).all()))
    tol = f"{ATOL} abs + {RTOL} rel"
    row = dict(name=case["name"], shape=case["shape"], max_abs_err=max_abs)
    if backward:
        tol += f", relative L2 <= {BWD_REL_L2}, dq dk dv each"
        row["rel_l2_err"] = rel_l2
        ok = ok and rel_l2 <= BWD_REL_L2
    row.update(tol=tol, ok=ok)
    if "lse_err" in case:
        row["lse_max_abs_err"] = case["lse_err"]()
        row["lse_tol"] = case.get("lse_atol", LSE_ATOL)
        row["ok"] = row["ok"] and row["lse_max_abs_err"] <= row["lse_tol"]
    del got, want
    if "halves" in case:
        row.update(case["halves"]())
        row["ok"] = row["ok"] and row["up_ok"] and row["down_ok"]
    if "checks" in case:
        row.update(case["checks"]())
        row["ok"] = row["ok"] and row["checks_ok"]
    row["ms"] = time_ms(case["kernel"])
    row["plain_ms"] = time_ms(case["plain"], iters=5, warmup=1)
    with case.get("library_context", contextlib.nullcontext)():
        row["library_ms"] = time_ms(case["library"])
    for key in ("library_backend", "library_note", "plan"):
        if key in case:
            row[key] = case[key]
    row["bound_ms"], row["bound_by"] = bound(case["flops"], case["nbytes"],
                                             case.get("exps", 0.0))
    return row


def phase_kernels() -> dict:
    """Every case checked and timed; returns, for each kernel, the rows of
    its main-path shapes in the order of ``KERNEL_CASES``."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    main_rows, failures = {}, []
    for path, case in kernel_cases(gen):
        row = check_case(case)
        row["path"] = path
        print(json.dumps({"kernel_check": row}), flush=True)
        if not row["ok"]:
            failures.append(f"{row['name']} {row['shape']}: max_abs_err "
                            f"{row['max_abs_err']}, lse "
                            f"{row.get('lse_max_abs_err')}, up/down "
                            f"{row.get('up_max_abs_err')}/"
                            f"{row.get('down_max_abs_err')}")
        if path:
            main_rows.setdefault(row["name"], []).append(row)
        del case
        torch.cuda.empty_cache()
    require(not failures, "kernel disagrees with its plain version: "
            + "; ".join(failures))
    return main_rows


# ------------------------------------------------------------------ phases

def phase_device() -> str:
    import torch

    require(torch.cuda.is_available(), "no CUDA device")
    cap = torch.cuda.get_device_capability(0)
    require(cap == (9, 0), f"needs compute capability (9, 0), got {cap}")
    from seervideoldm_tpu_torch.utils.device import set_numerics

    set_numerics()
    line = card_line()
    print(f"device: {line} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible; "
          "TF32 off for matmul and cuDNN, bf16 GEMMs reduce in fp32)",
          flush=True)
    return line


def ptxas_kernels(log: str) -> list:
    """(kernel, "R registers, S bytes spill stores, L loads, M smem") per
    entry function of an ``nvcc -Xptxas -v`` report."""
    import re

    out, kernel, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernel = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"{m.group(1)} bytes spill stores, {m.group(2)} loads"
            continue
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and kernel:
            out.append((kernel, f"{m.group(1)} registers, {spill}{m.group(2)}"))
            kernel = None
    return out


def phase_build() -> None:
    from seervideoldm_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    reports = build.build_all()
    for name, log in reports.items():
        for kernel, info in ptxas_kernels(log):
            print(f"build {name}: {kernel}: {info}", flush=True)
    print(f"build: {len(reports)} sources in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    from seervideoldm_tpu_torch.ops.kernels import flash_attention as fa

    for d in (40, 80, 160):  # the UNet's head dims
        for cwg in fa.cwg_choices(d):
            nbytes, stages = fa.fwd_smem(d, cwg)
            print(f"build smem: attention forward (K1, K2, K6) d {d}, "
                  f"{cwg} consumer warpgroups: {nbytes} bytes a CTA, "
                  f"{stages} ring stages", flush=True)
    for d in (40, 80):  # the backward's head dims
        for dkv in (False, True):
            for cwg in fa.bwd_cwg_choices(d, dkv):
                got = fa.bwd_smem(d, cwg, dkv)
                want = fa.bwd_layout(d, cwg, dkv)
                require(got == want, f"backward layout d {d} cwg {cwg}: the "
                        f"source gives {got}, the host {want}")
                print(f"build smem: attention backward (K7, K8, K9) "
                      f"{'dk/dv' if dkv else 'dq'} kernel d {d}, {cwg} "
                      f"consumer warpgroups: {got} bytes a CTA, "
                      f"{fa.BWD_STAGES} ring stages", flush=True)


def phase_reference() -> None:
    """Narrow SeerUNet (64/128) at the main path's shapes: bf16 on the card
    through the kernels vs the port's plain path in fp32 on the CPU."""
    import copy

    import torch

    from seervideoldm_tpu_torch.models.unet3d import SeerUNet, SeerUNetConfig
    from seervideoldm_tpu_torch.utils.device import cast_for_compute

    cfg = SeerUNetConfig(block_out_channels=(64, 128), layers_per_block=1,
                         norm_num_groups=8, cross_attention_dim=64,
                         attention_head_dim=2)
    with torch.random.fork_rng(devices=[0]), torch.device("cuda"):
        torch.manual_seed(SEED)
        unet = cast_for_compute(SeerUNet(cfg), torch.bfloat16).eval()
    # the default init keeps every proj_out non-zero, so every kernel's
    # output reaches the UNet's output
    ref = copy.deepcopy(unet).cpu().float()
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    x = torch.randn(2, 12, 32, 32, 4, generator=gen)
    ctx = torch.randn(2, 12, 77, 64, generator=gen)
    ts = torch.tensor([981, 981], dtype=torch.int32)
    reset_launches()
    with torch.no_grad():
        got = unet(x.cuda().bfloat16(), ts.cuda(), ctx.cuda().bfloat16())
        torch.cuda.synchronize()
        launches = read_launches()
        want = ref(x, ts, ctx)
    got = got.float().cpu()
    rel = float((got - want).norm() / want.norm())
    print(json.dumps({"reference": {
        "what": "SeerUNet 64/128, (2, 12, 32, 32, 4) bf16 on the card vs "
                "fp32 plain path on the CPU", "rel_l2_err": rel,
        "tol": REF_RTOL, "launches": launches}}), flush=True)
    require(bool(torch.isfinite(got).all()), "reference: non-finite output")
    require(rel <= REF_RTOL, f"reference: relative L2 error {rel} > {REF_RTOL}")
    for name in ("swat_attention_tables", "flash_attention", "ln_geglu_ff",
                 "ln_geglu_ff_proj"):
        require(launches[name] > 0, f"reference: {name} was not launched")


def phase_train_reference() -> None:
    """Narrow SeerUNet (64/128), one training forward + backward at the
    main path's 256 px / 12 frame / batch 1 shapes with ``cond_frame`` 2:
    bf16 through the kernels (forward and backward) on the card vs the
    port's plain path in fp32 on the CPU, same weights and inputs.  The
    default init keeps every ``proj_out`` non-zero: zero-initialised, it
    would make every gradient upstream of it inside a temporal site exactly
    zero and hide K7."""
    import copy

    import torch

    from seervideoldm_tpu_torch.models.unet3d import SeerUNet, SeerUNetConfig
    from seervideoldm_tpu_torch.utils.device import cast_for_compute

    cfg = SeerUNetConfig(block_out_channels=(64, 128), layers_per_block=1,
                         norm_num_groups=8, cross_attention_dim=64,
                         attention_head_dim=2)
    with torch.random.fork_rng(devices=[0]), torch.device("cuda"):
        torch.manual_seed(SEED + 1)
        unet = SeerUNet(cfg).eval()
    ref = copy.deepcopy(unet).cpu().float()
    cast_for_compute(unet, torch.bfloat16)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    x = torch.randn(1, 12, 32, 32, 4, generator=gen)
    noise = torch.randn(1, 10, 32, 32, 4, generator=gen)
    ctx = torch.randn(1, 12, 77, 64, generator=gen)
    ts = torch.tensor([517], dtype=torch.int32)

    def loss_and_grads(model, dev, dtype):
        names, params = zip(*((n, p) for n, p in model.named_parameters()
                              if "temporal_attentions" in n))
        for p in model.parameters():
            p.requires_grad_(False)
        for p in params:
            p.requires_grad_(True)
        pred = model(x.to(dev, dtype), ts.to(dev), ctx.to(dev, dtype),
                     cond_frame=2)[:, 2:]
        loss = ((pred.float() - noise.to(dev)) ** 2).mean()
        grads = torch.autograd.grad(loss, params)
        return float(loss.detach()), {n: g.float().cpu()
                                      for n, g in zip(names, grads)}

    reset_launches()
    got_loss, got = loss_and_grads(unet, "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    launches = read_launches()
    want_loss, want = loss_and_grads(ref, "cpu", torch.float32)

    num = sum(float((got[n] - want[n]).pow(2).sum()) for n in want)
    den = sum(float(want[n].pow(2).sum()) for n in want)
    rel_all = (num / den) ** 0.5
    per = {n: float((got[n] - want[n]).norm() / want[n].norm()) for n in want}
    worst = max(per, key=per.get)
    dead = [n for n in want if float(want[n].abs().max()) == 0.0]
    print(json.dumps({"train_reference": {
        "what": "SeerUNet 64/128, (1, 12, 32, 32, 4), cond_frame 2, eps-MSE: "
                "bf16 kernels fwd+bwd on the card vs fp32 plain on the CPU",
        "loss": got_loss, "loss_ref": want_loss, "tensors": len(want),
        "grad_rel_l2": rel_all, "tol": TRAIN_REF_RTOL,
        "worst_tensor": worst, "worst_tensor_rel_l2": per[worst],
        "tensor_tol": TRAIN_REF_TENSOR_RTOL, "launches": launches}}),
          flush=True)
    require(all(torch.isfinite(g).all() for g in got.values()),
            "train reference: non-finite gradient")
    require(not dead, f"train reference: zero reference gradient in {dead[:3]}")
    require(abs(got_loss - want_loss) <= REF_RTOL * abs(want_loss),
            f"train reference: loss {got_loss} vs {want_loss}")
    require(rel_all <= TRAIN_REF_RTOL,
            f"train reference: gradient relative L2 {rel_all} > {TRAIN_REF_RTOL}")
    require(per[worst] <= TRAIN_REF_TENSOR_RTOL,
            f"train reference: {worst} relative L2 {per[worst]} > "
            f"{TRAIN_REF_TENSOR_RTOL}")
    for name in ("swat_attention_tables", "flash_attention", "ln_geglu_ff",
                 "swat_attention_tables_bwd", "flash_attention_bwd"):
        require(launches[name] > 0, f"train reference: {name} was not launched")
    require(launches["ln_geglu_ff_proj"] == 0,
            "train reference: K4 ran although cond_frame > 0")


def phase_end_to_end(card: str, profile: str | None) -> tuple:
    """Phase 6; returns (launches, pipeline, tokenizer, config) so the
    knob phase reuses the full-width pipeline."""
    import dataclasses

    import numpy as np
    import torch

    from seervideoldm_tpu_torch.inference_img import build_pipeline, generate_video

    t0 = time.perf_counter()
    pipe, tok, cfg = build_pipeline(dict(
        resolution=256, cond_frames=2, num_frames=12, ddim_steps=E2E_STEPS,
        scale=7.5, seed=SEED, mixed_precision="bf16",
        compute_dtype="bfloat16"))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in pipe.m.modules() for p in m.parameters())
    print(f"e2e: full-width models ({n_params / 1e6:.1f} M parameters) built "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    image = np.random.RandomState(SEED).randint(0, 256, (256, 256, 3),
                                                dtype=np.uint8)
    prompt = "push the green cup to the left"
    # one-step warm-up (cuBLAS/cuDNN handles, allocator), not counted
    generate_video(pipe, tok, dataclasses.replace(cfg, ddim_steps=1), image,
                   prompt)
    torch.cuda.synchronize()
    steps = len(pipe.schedule.ddim_tables(E2E_STEPS).timesteps)

    reset_launches()
    t0 = time.perf_counter()
    with unet_group_norms() as gn_per_call:
        samples, cond = generate_video(pipe, tok, cfg, image, prompt)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_launches()

    frames = samples.shape[1]
    require(tuple(samples.shape) == (1, 10, 256, 256, 3),
            f"e2e: frames shaped {tuple(samples.shape)}")
    require(bool(torch.isfinite(samples).all()), "e2e: non-finite frames")
    require(float(samples.min()) >= 0.0 and float(samples.max()) <= 1.0,
            "e2e: frames outside [0, 1]")
    require(float(samples.std()) > 0.0, "e2e: constant frames")
    print(json.dumps({"e2e": {
        "card": card, "ddim_steps": steps, "unet_calls": steps,
        "cfg_batch": 2, "frames": frames, "seconds": elapsed,
        "frames_per_s": frames / elapsed, "s_per_step": elapsed / steps,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
        "group_norm_outside_unet": launches["group_norm"] - sum(gn_per_call)
        }}), flush=True)
    for name, per_step in PER_STEP.items():
        require(launches[name] == per_step * steps,
                f"e2e: {name} launched {launches[name]} times, expected "
                f"{per_step} x {steps} steps")
    require_group_norms("e2e", gn_per_call, steps, launches)
    require(launches["group_norm"] > sum(gn_per_call),
            "e2e: the VAE's GroupNorms did not run through K11")
    if profile:
        profile_step(pipe, profile)
    return launches, pipe, tok, cfg


@contextlib.contextmanager
def unet_group_norms():
    """Yields a list that receives K11's launches inside each SeerUNet
    call (a wrapper around ``SeerUNet.forward``)."""
    from seervideoldm_tpu_torch.models.unet3d import SeerUNet
    from seervideoldm_tpu_torch.ops.kernels import group_norm as GN

    per_call = []
    forward = SeerUNet.forward

    def counted(self, *args, **kwargs):
        before = GN.group_norm.launches
        out = forward(self, *args, **kwargs)
        per_call.append(GN.group_norm.launches - before)
        return out

    SeerUNet.forward = counted
    try:
        yield per_call
    finally:
        SeerUNet.forward = forward


def require_group_norms(where: str, per_call: list, calls: int,
                        launches: dict) -> None:
    """K11 ran ``GN_PER_UNET_CALL`` times inside each of ``calls`` SeerUNet
    calls (``unet_group_norms``'s list), at least as often in all, and each
    norm with its own moments kernel (no ``seq`` group on one card)."""
    require(per_call == [GN_PER_UNET_CALL] * calls,
            f"{where}: K11 per UNet call {sorted(set(per_call))} over "
            f"{len(per_call)} calls, expected {GN_PER_UNET_CALL} in each of "
            f"{calls}")
    require(launches["group_norm"] >= sum(per_call),
            f"{where}: {launches['group_norm']} K11 launches in all, fewer "
            f"than inside the UNet calls")
    require(launches["group_norm_moments"] == launches["group_norm"],
            f"{where}: {launches['group_norm_moments']} K11 moments launches"
            f" for {launches['group_norm']} norms")


# ------------------------------------------------------- sampling knobs

@contextlib.contextmanager
def observe_sampling():
    """Counts SeerUNet calls and records the shapes the attention kernels
    are handed (K2: (batch, tokens) of q; K1: q's batch x heads), through
    wrappers around ``SeerUNet.forward`` and the names ``ops/attention.py``
    calls (one Python call each, where a global module hook would add one
    to every module call of the UNet and pace the clip); the kernels' own
    launch counters are untouched.  Yields a dict: ``unet_calls``,
    ``flash``, ``swat``."""
    from seervideoldm_tpu_torch.models.unet3d import SeerUNet
    from seervideoldm_tpu_torch.ops import attention

    seen = {"unet_calls": 0, "flash": [], "swat": []}
    forward = SeerUNet.forward

    def counted(self, *args, **kwargs):
        seen["unet_calls"] += 1
        return forward(self, *args, **kwargs)

    real = {n: getattr(attention, n) for n in ("flash_attention",
                                               "swat_attention_tables")}

    def flash(q, *a, **k):
        seen["flash"].append((math.prod(q.shape[:-2]), q.shape[-2]))
        return real["flash_attention"](q, *a, **k)

    def swat(q, *a, **k):
        seen["swat"].append(q.shape[0])
        return real["swat_attention_tables"](q, *a, **k)

    SeerUNet.forward = counted
    attention.flash_attention, attention.swat_attention_tables = flash, swat
    try:
        yield seen
    finally:
        SeerUNet.forward = forward
        for name, fn in real.items():
            setattr(attention, name, fn)


@contextlib.contextmanager
def capture_result(cls, method: str):
    """Wraps ``cls.method``: yields a list that receives (result, seconds)
    of every call, timed to the device's end."""
    import torch

    real = getattr(cls, method)
    got = []

    @functools.wraps(real)
    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        got.append((out, time.perf_counter() - t0))
        return out

    setattr(cls, method, wrapped)
    try:
        yield got
    finally:
        setattr(cls, method, real)


def _check_frames(what: str, samples, shape) -> None:
    import torch

    require(tuple(samples.shape) == tuple(shape),
            f"{what}: frames shaped {tuple(samples.shape)}, expected {shape}")
    require(bool(torch.isfinite(samples).all()), f"{what}: non-finite frames")
    require(float(samples.min()) >= 0.0 and float(samples.max()) <= 1.0,
            f"{what}: frames outside [0, 1]")
    require(float(samples.std()) > 0.0, f"{what}: constant frames")


def knob_run(card: str, run: str, call, calls: int, shape,
             expect: dict | None = None, extra: dict | None = None):
    """One run of the knob phase: launch counts zeroed just before and
    read just after, the UNet calls and the frames checked, a
    ``sampling_knobs`` line.  ``call`` returns (frames, seconds per clip
    or None for the run's wall time).  ``expect``: launches per kernel
    (default: ``PER_STEP`` x calls).  Returns (launches, observed)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with observe_sampling() as seen:
        samples, clip_s = call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    _check_frames(f"knobs {run}", samples, shape)
    line = {"card": card, "run": run, "unet_calls": seen["unet_calls"],
            "s_per_clip": clip_s if clip_s is not None else wall,
            "run_seconds": wall, "frames": list(samples.shape),
            "peak_mem_gb": _peak_gb(), "launches": launches}
    line.update(extra or {})
    print(json.dumps({"sampling_knobs": line}), flush=True)
    require(seen["unet_calls"] == calls,
            f"knobs {run}: {seen['unet_calls']} UNet calls, expected {calls}")
    expect = expect or {name: per * calls for name, per in PER_STEP.items()}
    for name, n in expect.items():
        require(launches[name] == n, f"knobs {run}: {name} launched "
                f"{launches[name]} times, expected {n}")
    return launches, seen


def _pab_expected(tables_len: int, pab_cfg) -> tuple[dict, dict]:
    """Launches of a PAB clip from the port's own schedule: K2 at the
    steps that compute the spatial attention, K1 at those that compute
    the temporal one, K3-K5 at every call (the FF tails still run)."""
    from seervideoldm_tpu_torch.diffusion.pab import build_pab_schedule

    modes, idx = build_pab_schedule(tables_len, pab_cfg)
    flags = [modes[i] for i in idx]
    cached = {kind: sum(m[k] for m in flags)
              for k, kind in enumerate(("spatial", "cross", "temporal"))}
    expect = {name: per * tables_len for name, per in PER_STEP.items()}
    expect["flash_attention"] = PER_STEP["flash_attention"] * (
        tables_len - cached["spatial"])
    expect["swat_attention_tables"] = PER_STEP["swat_attention_tables"] * (
        tables_len - cached["temporal"])
    return expect, cached


def pab_bit_exact(pipe, tok, cfg, image, prompt) -> dict:
    """(1) a clip with every PAB range 1 (the all-compute mode and its
    cache at every step) against PAB off, 5 steps; (2) a fully cached
    mode at the same (x, t) as the all-compute call before it, and that
    call against the UNet without PAB: each equal bit for bit."""
    import dataclasses

    import torch

    from seervideoldm_tpu_torch.diffusion.pab import COMPUTE_ALL, mode_to_flags
    from seervideoldm_tpu_torch.inference_img import generate_video

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        short = dataclasses.replace(cfg, ddim_steps=5)
        ones = dataclasses.replace(short, pab=True, pab_spatial_range=1,
                                   pab_cross_range=1, pab_temporal_range=1)
        clip_ones = generate_video(pipe, tok, ones, image, prompt)[0]
        clip_off = generate_video(pipe, tok, short, image, prompt)[0]
        gen = torch.Generator(device=pipe.device).manual_seed(SEED + 3)
        lat = pipe.latent_shape(cfg.resolution, cfg.resolution)[0]
        unet_cfg = pipe.m.unet.config
        x = torch.randn(2, cfg.num_frames, lat, lat, unet_cfg.in_channels,
                        generator=gen, device=pipe.device).to(pipe.dtype)
        ctx = torch.randn(2, cfg.num_frames, 77,
                          unet_cfg.cross_attention_dim, generator=gen,
                          device=pipe.device).to(pipe.dtype)
        ts = torch.full((2,), 981, dtype=torch.int32, device=pipe.device)
        cache: dict = {}
        with torch.no_grad():
            plain = pipe.m.unet(x, ts, ctx)
            computed = pipe.m.unet(x, ts, ctx, pab=mode_to_flags(COMPUTE_ALL),
                                   pab_cache=cache)
            cached = pipe.m.unet(x, ts, ctx,
                                 pab=mode_to_flags((True, True, True)),
                                 pab_cache=cache)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    out = {"ranges_one_equals_off_5_steps": bool(torch.equal(clip_ones,
                                                             clip_off)),
           "all_compute_equals_no_pab": bool(torch.equal(computed, plain)),
           "cached_equals_all_compute": bool(torch.equal(cached, computed)),
           "cache_entries": len(cache)}
    for key in ("ranges_one_equals_off_5_steps", "all_compute_equals_no_pab",
                "cached_equals_all_compute"):
        require(out[key], f"knobs pab: {key} does not hold bit for bit")
    return out


def _write_config(path: str, raw: dict) -> str:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def phase_knobs(card: str, pipe, tok, cfg) -> dict:
    """The sampling-knob phase (module docstring, phase 6b) on phase 6's
    full-width pipeline.  Returns the launches summed over its runs."""
    import dataclasses

    import numpy as np
    import torch
    from PIL import Image

    from seervideoldm_tpu_torch import edit as edit_entry
    from seervideoldm_tpu_torch import inference as inference_entry
    from seervideoldm_tpu_torch.config import load_config, pab_config_from
    from seervideoldm_tpu_torch.diffusion.schedules import DiffusionSchedule
    from seervideoldm_tpu_torch.inference_img import generate_video
    from seervideoldm_tpu_torch.pipelines.text_video import SeerPipeline

    t_phase = time.perf_counter()
    res, f1, nf = cfg.resolution, cfg.cond_frames, cfg.num_frames
    image = np.random.RandomState(SEED).randint(0, 256, (res, res, 3),
                                                dtype=np.uint8)
    prompt = "push the green cup to the left"
    clip = (1, nf - f1, res, res, 3)
    total = {name: 0 for name in wrappers()}

    def add(launches):
        for name in total:
            total[name] += launches[name]

    def sample(c):
        return lambda: (generate_video(pipe, tok, c, image, prompt)[0], None)

    def grid(steps, spacing="uniform", zero_snr=False):
        return len(DiffusionSchedule.create(1000, rescale_zero_snr=zero_snr)
                   .ddim_tables(steps, discr_method=spacing).timesteps)

    # (a) DPM-Solver++, 20 trailing steps
    c = dataclasses.replace(cfg, sampler="dpm++", ddim_steps=KNOB_DPM_STEPS,
                            timestep_spacing="trailing")
    add(knob_run(card, f"dpm++ {KNOB_DPM_STEPS} trailing", sample(c),
                 grid(KNOB_DPM_STEPS, "trailing"), clip)[0])

    # (b) the zero-terminal-SNR recipe on its rescaled schedule
    c = dataclasses.replace(cfg, rescale_zero_snr=True,
                            prediction_type="v_prediction",
                            timestep_spacing="trailing", guidance_rescale=0.7)
    schedule = pipe.schedule
    pipe.schedule = DiffusionSchedule.create(1000, rescale_zero_snr=True)
    try:
        add(knob_run(card, "zero-snr ddim 30", sample(c),
                     grid(cfg.ddim_steps, "trailing", True), clip)[0])
    finally:
        pipe.schedule = schedule

    # (c) configs/serve.yaml's PAB at 30 steps; then the bit-exact checks
    serve = load_config(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "configs", "serve.yaml"))
    pab_cfg = pab_config_from(serve)
    c = dataclasses.replace(cfg, pab=True,
                            pab_spatial_range=pab_cfg.spatial_range,
                            pab_cross_range=pab_cfg.cross_range,
                            pab_temporal_range=pab_cfg.temporal_range,
                            pab_window=list(pab_cfg.window))
    n = grid(cfg.ddim_steps)
    expect, cached = _pab_expected(n, pab_cfg)
    add(knob_run(card, "pab serve.yaml ddim 30", sample(c), n, clip,
                 expect=expect,
                 extra={"pab": dataclasses.asdict(pab_cfg),
                        "steps_cached": cached,
                        "bit_exact": pab_bit_exact(pipe, tok, cfg, image,
                                                   prompt)})[0])

    # (d) ToMe 0.5 with FreeU: K2 runs at the merged 512 tokens
    unet_cfg = pipe.m.unet.config
    pipe.m.unet.config = dataclasses.replace(
        unet_cfg, tome_ratio=0.5, tome_min_tokens=1024,
        freeu=(1.5, 1.6, 0.9, 0.2))
    try:
        launches, seen = knob_run(card, "tome 0.5 + freeu ddim 30", sample(cfg),
                                  n, clip)
    finally:
        pipe.m.unet.config = unet_cfg
    add(launches)
    tokens = sorted({t for _, t in seen["flash"]})
    print(json.dumps({"sampling_knobs_tome": {"k2_tokens": tokens}}),
          flush=True)
    require(tokens == [512], f"knobs tome: K2 saw {tokens} tokens, not 512")

    # (e) guidance_interval [0, 500]: calls outside it run at batch 1
    c = dataclasses.replace(cfg, guidance_interval=[0, 500])
    timesteps = pipe.schedule.ddim_tables(cfg.ddim_steps).timesteps
    outside = int((timesteps > 500).sum())
    launches, seen = knob_run(card, "guidance_interval [0, 500] ddim 30",
                              sample(c), n, clip,
                              extra={"calls_at_batch_1": outside})
    add(launches)
    heads = pipe.m.unet.config.attention_head_dim
    for kind, batch_1 in (("flash", lambda s: s[0] == nf * heads),
                          ("swat", lambda s: s == heads)):
        per_call, ones = len(seen[kind]) // n, sum(map(batch_1, seen[kind]))
        require(per_call > 0 and ones == per_call * outside,
                f"knobs guidance_interval: {kind} ran {ones} of "
                f"{len(seen[kind])} times at batch 1, expected {outside} "
                f"calls' worth")

    # (f) rollout to 20 future frames: 2 chunks
    c = dataclasses.replace(cfg, total_frames=20)
    add(knob_run(card, "rollout total_frames 20", sample(c),
                 -(-20 // (nf - f1)) * n, (1, 20, res, res, 3))[0])

    tmp = tempfile.mkdtemp(prefix="chip_smoke_knobs_")
    try:
        base = dict(resolution=res, cond_frames=f1, num_frames=nf,
                    ddim_steps=cfg.ddim_steps, scale=cfg.scale, seed=SEED,
                    mixed_precision="bf16", compute_dtype="bfloat16")
        # (g) the edit entry on a seeded 12-frame GIF, strength 0.6
        rng = np.random.RandomState(SEED + 4)
        coarse = rng.randint(0, 200, (nf, 8, 8, 3)).astype(np.uint8)
        frames = [Image.fromarray(f).resize((res, res), Image.BILINEAR)
                  for f in coarse]
        gif = os.path.join(tmp, "clip.gif")
        frames[0].save(gif, save_all=True, append_images=frames[1:],
                       duration=100)
        conf = _write_config(os.path.join(tmp, "edit.yaml"),
                             dict(base, output_dir=os.path.join(tmp, "edit")))
        t_enc = int(round(0.6 * n))

        def run_edit():
            with capture_result(SeerPipeline, "edit") as got:
                path = edit_entry.main(
                    ["--config", conf, "--video_path", gif,
                     "--input_text_prompts", "pour the water instead",
                     "--edit_strength", "0.6"], device="cuda")
            require(path is not None and os.path.exists(path),
                    "knobs edit: the entry wrote no GIF")
            return got[0]

        add(knob_run(card, "edit entry strength 0.6", run_edit, t_enc,
                     clip)[0])

        # (h) the inference entry on a synthetic Sthv2 val tree
        write_synthetic_sthv2(os.path.join(tmp, "data"), clips=1,
                              frames=nf + 2, res=res)
        conf = _write_config(os.path.join(tmp, "inference.yaml"), dict(
            base, output_dir=os.path.join(tmp, "inference"),
            data_dir=os.path.join(tmp, "data"), dataset="sthv2",
            val_batch_size=1, num_samples=1, sample_iter=1, num_workers=1))

        def run_inference():
            with capture_result(SeerPipeline, "generate") as got:
                written = inference_entry.main(["--config", conf],
                                               device="cuda")
            require(written == [0] and os.path.exists(os.path.join(
                tmp, "inference", "grid-0.png")),
                f"knobs inference: the entry wrote {written}")
            return got[0]

        add(knob_run(card, "inference entry 1 batch 1 sample",
                     run_inference, n, clip)[0])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"sampling_knobs_phase": {
        "seconds": time.perf_counter() - t_phase, "launches": total}}),
        flush=True)
    return total


def phase_knob_reference() -> None:
    """Narrow SeerUNet (64/128) at the main path's shapes, as phase 4: one
    call in a fully cached PAB mode (the cache written by an all-compute
    call at other inputs), one with ToMe 0.5 and one with FreeU, bf16
    through the kernels on the card against the plain path in fp32 on the
    CPU (relative L2 <= REF_RTOL each)."""
    import copy
    import dataclasses

    import torch

    from seervideoldm_tpu_torch.diffusion.pab import COMPUTE_ALL, mode_to_flags
    from seervideoldm_tpu_torch.models.unet3d import SeerUNet, SeerUNetConfig
    from seervideoldm_tpu_torch.utils.device import cast_for_compute

    cfg = SeerUNetConfig(block_out_channels=(64, 128), layers_per_block=1,
                         norm_num_groups=8, cross_attention_dim=64,
                         attention_head_dim=2)
    with torch.random.fork_rng(devices=[0]), torch.device("cuda"):
        torch.manual_seed(SEED + 2)
        unet = cast_for_compute(SeerUNet(cfg), torch.bfloat16).eval()
    ref = copy.deepcopy(unet).cpu().float()
    gen = torch.Generator(device="cpu").manual_seed(SEED + 2)
    x1, x2 = (torch.randn(2, 12, 32, 32, 4, generator=gen) for _ in range(2))
    ctx = torch.randn(2, 12, 77, 64, generator=gen)
    t1 = torch.tensor([981, 981], dtype=torch.int32)
    t2 = torch.tensor([500, 500], dtype=torch.int32)

    def both(fn):
        with torch.no_grad():
            got = fn(unet, lambda t: t.cuda().bfloat16()
                     if t.is_floating_point() else t.cuda())
            torch.cuda.synchronize()
            want = fn(ref, lambda t: t)
        return got.float().cpu(), want

    def pab_call(model, dev):
        cache: dict = {}
        model(dev(x1), dev(t1), dev(ctx), pab=mode_to_flags(COMPUTE_ALL),
              pab_cache=cache)
        return model(dev(x2), dev(t2), dev(ctx),
                     pab=mode_to_flags((True, True, True)), pab_cache=cache)

    def with_config(**knobs):
        def call(model, dev):
            base = model.config
            model.config = dataclasses.replace(base, **knobs)
            try:
                return model(dev(x1), dev(t1), dev(ctx))
            finally:
                model.config = base
        return call

    out = {}
    for name, fn in (("pab cached (True, True, True)", pab_call),
                     ("tome 0.5", with_config(tome_ratio=0.5,
                                              tome_min_tokens=1024)),
                     ("freeu (1.5, 1.6, 0.9, 0.2)",
                      with_config(freeu=(1.5, 1.6, 0.9, 0.2)))):
        reset_launches()
        got, want = both(fn)
        rel = float((got - want).norm() / want.norm())
        out[name] = {"rel_l2_err": rel, "launches": read_launches()}
        require(bool(torch.isfinite(got).all()),
                f"knob reference {name}: non-finite output")
        require(rel <= REF_RTOL, f"knob reference {name}: relative L2 "
                f"{rel} > {REF_RTOL}")
    print(json.dumps({"knob_reference": {
        "what": "SeerUNet 64/128, (2, 12, 32, 32, 4) bf16 on the card vs "
                "fp32 plain path on the CPU", "tol": REF_RTOL, **out}}),
        flush=True)
    require(out["tome 0.5"]["launches"]["flash_attention"] > 0,
            "knob reference: K2 did not run under ToMe")


def write_synthetic_sthv2(root: str, clips: int, frames: int, res: int) -> None:
    """A Something-Something-v2 tree (annotations/train.json + rawframes/
    <id>/*.jpg) of seeded smooth random clips: a moving bright square on a
    low-frequency background, so the JPEGs are small."""
    import numpy as np
    from PIL import Image

    ann = os.path.join(root, "annotations")
    os.makedirs(ann, exist_ok=True)
    entries = [{"id": str(i), "label": f"pushing thing {i} from left to right"}
               for i in range(clips)]
    for name in ("train", "validation"):
        with open(os.path.join(ann, f"{name}.json"), "w") as f:
            json.dump(entries, f)
    rng = np.random.RandomState(SEED)
    for e in entries:
        d = os.path.join(root, "rawframes", e["id"])
        os.makedirs(d, exist_ok=True)
        coarse = rng.randint(0, 160, (8, 8, 3)).astype(np.uint8)
        base = np.asarray(Image.fromarray(coarse).resize((res, res),
                                                         Image.BILINEAR))
        y0 = rng.randint(0, res // 2)
        for j in range(frames):
            frame = base.copy()
            x0 = (res // 8) + j * (res // 24)
            frame[y0:y0 + res // 4, x0:x0 + res // 4] = 235
            Image.fromarray(frame).save(os.path.join(d, f"{j:04d}.jpg"),
                                        quality=90)


# ------------------------------------------------------------- serving

SERVE_WAIT_MS = 3000.0     # batching window of phase 6e (serve.yaml: 100)
SERVE_STAGGER_S = 0.05     # between the concurrent requests' starts
SERVE_CHECK_STEPS = 5      # DDIM steps of the bit-exact service checks
SERVE_ENTRY_TIMEOUT = 420  # s for the serve entry to print its port
SERVE_STOP_TIMEOUT = 60    # s for it to exit after SIGTERM
# the requests [A, B, C, D] of the service checks ((prompt, image seed))
SERVE_A_SPEC = [("push the green cup to the left", 30), ("lift it", 31),
                ("turn it over", 32), ("drop it", 33)]


def _png(seed: int, res: int) -> bytes:
    import io

    import numpy as np
    from PIL import Image

    arr = np.random.RandomState(seed).randint(0, 256, (res, res, 3),
                                              dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _http(port: int, path: str, payload=None, timeout: float = 600.0):
    """(status, content type, body) of a GET, or of a POST of ``payload``
    (a dict sent as JSON, or bytes sent as they are)."""
    import urllib.error
    import urllib.request

    url = f"http://127.0.0.1:{port}{path}"
    data = None
    if payload is not None:
        data = payload if isinstance(payload, bytes) else json.dumps(
            payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers.get("Content-Type"), exc.read()


def _gif_frames(what: str, body: bytes, res: int, frames: int) -> int:
    import io

    from PIL import Image

    with Image.open(io.BytesIO(body)) as gif:
        require(gif.format == "GIF" and gif.size == (res, res),
                f"{what}: a {gif.format} of {gif.size}")
        n = gif.n_frames
    # identical consecutive frames (the repeated cond frames) merge
    require(1 <= n <= frames, f"{what}: {n} GIF frames, at most {frames}")
    return n


def _concurrent(calls: list) -> list:
    """Runs each call on its own thread, started ``SERVE_STAGGER_S`` apart
    in list order (so they queue in that order); returns their results."""
    import threading

    out, errors = [None] * len(calls), []

    def run(i, fn):
        try:
            out[i] = fn()
        except Exception as exc:  # noqa: BLE001 -- reported below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i, fn), daemon=True)
               for i, fn in enumerate(calls)]
    for th in threads:
        th.start()
        time.sleep(SERVE_STAGGER_S)
    for th in threads:
        th.join(timeout=900)
        require(not th.is_alive(), "serving: a request did not return")
    if errors:
        raise errors[0]
    return out


def _service_batch(svc, spec) -> list:
    """The requests of ``spec`` ((prompt, image seed) each) through
    ``generate_array`` at once; they must form one batch, in order."""
    import numpy as np

    from seervideoldm_tpu_torch.data.transforms import image_to_model_input

    res = svc.resolution
    images = [image_to_model_input(np.random.RandomState(s).randint(
        0, 256, (res, res, 3), dtype=np.uint8), res) for _, s in spec]
    before = svc.batcher.batches
    rows = _concurrent([functools.partial(svc.generate_array, p, img)
                        for (p, _), img in zip(spec, images)])
    require(svc.batcher.batches == before + 1,
            f"serving: {len(spec)} requests formed "
            f"{svc.batcher.batches - before} batches, expected 1")
    return rows


def _start_serve(sets: list, ranks: int = 1) -> tuple:
    """``python -m seervideoldm_tpu_torch.serve --config configs/serve.yaml``
    with ``--set`` ``sets``, as ``ranks`` processes (torchrun's variables,
    a free rendezvous port) when more than one; waits for rank 0's
    "serving on" line.  Returns (processes, port, seconds to it, each
    rank's output so far)."""
    import queue
    import re
    import socket
    import threading

    root = os.path.dirname(os.path.abspath(__file__))
    argv = [sys.executable, "-m", "seervideoldm_tpu_torch.serve", "--config",
            os.path.join(root, "configs", "serve.yaml")]
    for item in sets:
        argv += ["--set", item]
    env = dict(os.environ, PYTHONPATH=root)
    if ranks > 1:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            rendezvous = sock.getsockname()[1]
        env.update(WORLD_SIZE=str(ranks), LOCAL_WORLD_SIZE=str(ranks),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(rendezvous))
    t0 = time.perf_counter()
    procs, logs, lines = [], [], queue.Queue()
    for r in range(ranks):
        rank_env = dict(env, RANK=str(r), LOCAL_RANK=str(r)) if ranks > 1 \
            else env
        proc = subprocess.Popen(argv, cwd=root, env=rank_env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        log: list = []

        def read(proc=proc, log=log, r=r):
            for ln in proc.stdout:
                log.append(ln)
                if r == 0:
                    lines.put(ln)
            if r == 0:
                lines.put(None)

        threading.Thread(target=read, daemon=True).start()
        procs.append(proc)
        logs.append(log)
    port = None
    deadline = time.monotonic() + SERVE_ENTRY_TIMEOUT
    try:
        while port is None:
            try:
                line = lines.get(timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                break
            if line is None:
                break
            m = re.search(r"serving on http://[\d.]+:(\d+)", line)
            port = int(m.group(1)) if m else None
        require(port is not None, "serve entry: no 'serving on' line within "
                f"{SERVE_ENTRY_TIMEOUT} s:\n" + "\n----\n".join(
                    "".join(log[-20:]) for log in logs))
    except BaseException:
        _stop_procs(procs)
        raise
    return procs, port, time.perf_counter() - t0, logs


def _stop_procs(procs) -> None:
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _sigterm_all(what: str, procs, logs) -> tuple:
    """SIGTERM to every rank (as torchrun signals them); each must exit 0
    within ``SERVE_STOP_TIMEOUT``.  Returns (exit codes, seconds)."""
    import signal

    t0 = time.perf_counter()
    for proc in procs:
        proc.send_signal(signal.SIGTERM)
    codes = []
    for proc in procs:
        try:
            codes.append(proc.wait(timeout=max(
                0.1, SERVE_STOP_TIMEOUT - (time.perf_counter() - t0))))
        except subprocess.TimeoutExpired:
            codes.append(None)
    require(codes == [0] * len(procs), f"{what}: exit codes {codes} after "
            f"SIGTERM (limit {SERVE_STOP_TIMEOUT} s):\n" + "\n----\n".join(
                "".join(log[-20:]) for log in logs))
    return codes, time.perf_counter() - t0


def serve_entry(card: str) -> dict:
    """``python -m seervideoldm_tpu_torch.serve --config configs/serve.yaml
    --set serve_port=0`` as a subprocess: the port it prints, one POST,
    ``/healthz``, SIGTERM, exit 0 within ``SERVE_STOP_TIMEOUT``."""
    import base64

    procs, port, startup, logs = _start_serve(["serve_port=0"])
    try:
        t1 = time.perf_counter()
        status, ctype, body = _http(port, "/generate", {
            "prompt": "push the green cup to the left",
            "image": base64.b64encode(_png(SEED + 20, 256)).decode()})
        post_s = time.perf_counter() - t1
        require(status == 200 and ctype == "image/gif",
                f"serve entry: POST answered {status} {ctype}: {body[:200]!r}")
        frames = _gif_frames("serve entry", body, 256, 12)
        status, _, body = _http(port, "/healthz")
        health = json.loads(body)
        require(status == 200 and health["batches"] == 1
                and health["requests"] == 1, f"serve entry: healthz {health}")
        (code,), stop_s = _sigterm_all("serve entry", procs, logs)
        return {"startup_seconds": startup, "post_seconds": post_s,
                "gif_frames": frames, "healthz": health,
                "stop_seconds": stop_s, "exit_code": code}
    finally:
        _stop_procs(procs)


def phase_serving(card: str, pipe, tok) -> dict:
    """Phase 6e (module docstring): ``configs/serve.yaml``'s service on
    phase 6's full-width pipeline, over HTTP and through
    ``generate_array``, then the ``serve`` entry.  The batching window is
    raised to ``SERVE_WAIT_MS`` for this phase only, so that requests
    started ``SERVE_STAGGER_S`` apart form one batch, in order.  Returns
    the launches of the in-process batches and the rows of [A, B, C, D]
    at ``SERVE_CHECK_STEPS`` under counter 0 (phase 6f's reference)."""
    import dataclasses
    import threading

    import torch

    from seervideoldm_tpu_torch.config import load_config, pab_config_from
    from seervideoldm_tpu_torch.serve import build_service
    from seervideoldm_tpu_torch.serving import make_server

    root = os.path.dirname(os.path.abspath(__file__))
    serve = load_config(os.path.join(root, "configs", "serve.yaml"))
    serve = dataclasses.replace(serve, serve_max_wait_ms=SERVE_WAIT_MS)
    res, nb = int(serve.resolution), int(serve.serve_max_batch)
    n_frames = int(serve.num_frames)
    calls = len(pipe.schedule.ddim_tables(int(serve.ddim_steps)).timesteps)
    expect, _ = _pab_expected(calls, pab_config_from(serve))
    total = {name: 0 for name in wrappers()}

    def measured(what, fn, want=None):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        for name in total:
            total[name] += launches[name]
        for name, n in (want or {}).items():
            require(launches[name] == n, f"serving {what}: {name} launched "
                    f"{launches[name]} times, expected {n}")
        return out, seconds, launches

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    svc = build_service(serve, pipe, tok)
    server = make_server(svc, host="127.0.0.1", port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    try:
        _, warm_s, _ = measured("warmup", svc.warmup, expect)
        thread.start()
        body = {"prompt": "push the green cup to the left",
                "image": _b64_png(SEED + 10, res)}
        bodies = [dict(body, image=_b64_png(SEED + 10 + i, res),
                       negative_prompt="blurry" if i == 3 else "")
                  for i in range(nb)]
        replies, batch_s, batch_launches = measured(
            f"batch of {nb}", lambda: _concurrent([
                functools.partial(_http, port, "/generate", b)
                for b in bodies]), expect)
        for i, (status, ctype, data) in enumerate(replies):
            require(status == 200 and ctype == "image/gif",
                    f"serving: request {i} answered {status} {ctype}")
            _gif_frames(f"serving request {i}", data, res, n_frames)
        health = json.loads(_http(port, "/healthz")[2])
        require(health["batches"] == 1 and health["requests"] == nb,
                f"serving: after {nb} concurrent requests healthz {health}")
        # the lone request waits out serve.yaml's own window, not the
        # raised one
        svc.batcher.max_wait_s = float(
            load_config(os.path.join(root, "configs", "serve.yaml"))
            .serve_max_wait_ms) / 1000.0
        (status, ctype, data), lone_s, _ = measured(
            "lone request", lambda: _http(port, "/generate", body), expect)
        require(status == 200 and ctype == "image/gif",
                f"serving: the lone request answered {status}")
        _gif_frames("serving lone request", data, res, n_frames)
        health = json.loads(_http(port, "/healthz")[2])
        require(health["batches"] == 2 and health["requests"] == nb + 1,
                f"serving: after the lone request healthz {health}")
        status, _, _ = _http(port, "/generate", b'{"prompt": "x", "image": 3')
        require(status == 400, f"serving: a malformed body answered {status}")
        peak = _peak_gb()
    finally:
        if thread.is_alive():   # shutdown() waits for serve_forever
            server.shutdown()
        server.server_close()
        svc.stop()

    # bit for bit, through generate_array at SERVE_CHECK_STEPS: row 0 of
    # [A, B, C, D] against row 0 of [A, E, F, G] under the same counter,
    # and a restarted service fed the same requests
    short = dataclasses.replace(serve, ddim_steps=SERVE_CHECK_STEPS)
    a_spec = SERVE_A_SPEC[:nb]
    e_spec = a_spec[:1] + [("spin it", 34), ("tilt it", 35),
                           ("slide it right", 36)][:nb - 1]
    rows = {}

    def checks():
        for key, spec in (("first", a_spec), ("other", e_spec),
                          ("restart", a_spec)):
            svc = build_service(short, pipe, tok)
            try:
                rows[key] = _service_batch(svc, spec)
            finally:
                svc.stop()

    _, check_s, _ = measured("bit-exact checks", checks)
    independent = bool((rows["first"][0] == rows["other"][0]).all())
    restart = all(bool((a == b).all())
                  for a, b in zip(rows["first"], rows["restart"]))
    differs = not bool((rows["first"][1] == rows["other"][1]).all())
    require(independent, "serving: row 0 of a batch depends on the other rows")
    require(restart, "serving: a restarted service returned other videos")
    require(differs, "serving: different requests returned equal rows")

    from seervideoldm_tpu_torch.utils.viz import gif_bytes

    t0 = time.perf_counter()
    gif_bytes(rows["first"][0])   # what each HTTP reply costs the host
    gif_s = time.perf_counter() - t0
    entry = serve_entry(card)
    stats = health
    print(json.dumps({"serving": {
        "card": card, "max_batch": nb, "cfg_batch": 2 * nb,
        "ddim_steps": int(serve.ddim_steps), "unet_calls_per_batch": calls,
        "pab": True, "warmup_seconds": warm_s,
        "batch_seconds": batch_s, "lone_request_seconds": lone_s,
        "requests_per_s_full_batch": nb / batch_s,
        "seconds_per_request_full_batch": batch_s / nb,
        "latency_p50_s": stats["latency_p50_s"],
        "latency_p95_s": stats["latency_p95_s"],
        "peak_mem_gb": peak, "launches_per_batch": batch_launches,
        "expected_launches_per_batch": expect,
        "row_independent": independent, "restart_reproduces": restart,
        "check_ddim_steps": SERVE_CHECK_STEPS, "check_seconds": check_s,
        "gif_encode_seconds": gif_s,
        "entry": entry}}), flush=True)
    return total, rows["first"]


def _b64_png(seed: int, res: int) -> str:
    import base64

    return base64.b64encode(_png(seed, res)).decode()


# ------------------------------------------------- pretrained and eval

EVAL_CLIPS = 4
EVAL_CHECK_RTOL = 1e-3     # scorers on the card vs fp32 on the CPU, rel L2


def _seeded_on_card(seed: int, *builders):
    """Modules built on the card in fp32 with the global generators seeded
    (and restored after)."""
    import torch

    with torch.random.fork_rng(devices=[0]), torch.device("cuda"):
        torch.manual_seed(seed)
        return [build().eval() for build in builders]


def _file_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)


def write_sd15_dir(root: str, seed: int) -> dict:
    """A full-width SD-1.5 diffusers directory and an FSText ``.bin`` from
    a seeded random-init set of the port's modules, under the names a real
    download uses: ``vae/diffusion_pytorch_model.bin`` (fp32, the newer
    attention names), ``text_encoder/model.safetensors`` (fp32, with
    ``position_ids``), ``unet/diffusion_pytorch_model.safetensors`` (fp16,
    the 2D keys only: the ``fp16`` variant layout), ``fstext.bin`` (fp32).
    Returns the tensors written, by module, under the port's names (CPU)."""
    import torch

    from seervideoldm_tpu_torch.io.pretrained import NEWER_VAE_NAMES
    from seervideoldm_tpu_torch.io.state_dict import write_safetensors
    from seervideoldm_tpu_torch.models.clip_text import CLIPTextModel
    from seervideoldm_tpu_torch.models.fstext import FSTextTransformer
    from seervideoldm_tpu_torch.models.unet3d import SeerUNet
    from seervideoldm_tpu_torch.models.vae import AutoencoderKL

    mods = _seeded_on_card(seed, AutoencoderKL, CLIPTextModel, SeerUNet,
                           lambda: FSTextTransformer(
                               num_frames=12, in_channels=768,
                               out_channels=768, cross_attention_dim=768))
    src = {}
    for key, m in zip(("vae", "clip", "unet", "fstext"), mods):
        src[key] = {k: v.detach().cpu() for k, v in m.state_dict().items()}
    del mods
    src["unet"] = {k: v.half() for k, v in src["unet"].items()
                   if "temporal_attentions" not in k
                   and not k.endswith("rotary_emb.freqs")}
    for d in ("vae", "text_encoder", "unet"):
        os.makedirs(os.path.join(root, d))
    newer = {}
    for k, v in src["vae"].items():
        for new, old in NEWER_VAE_NAMES.items():
            k = k.replace(f"mid_block.attentions.0.{old}.",
                          f"mid_block.attentions.0.{new}.")
        newer[k] = v
    torch.save(newer, os.path.join(root, "vae", "diffusion_pytorch_model.bin"))
    write_safetensors(
        {**src["clip"],
         "text_model.embeddings.position_ids": torch.arange(77)[None]},
        os.path.join(root, "text_encoder", "model.safetensors"))
    write_safetensors(src["unet"], os.path.join(
        root, "unet", "diffusion_pytorch_model.safetensors"),
        metadata={"format": "pt"})
    torch.save(src["fstext"], os.path.join(root, "fstext.bin"))
    return src


def phase_pretrained(card: str) -> dict:
    """Phase 6c: a full-width diffusers directory written from seeded
    tensors, loaded through ``load_models`` on the card with another seed
    (bit-exact against the files; the temporal attentions equal the new
    seed's fresh values), then one 256 px clip sampled from the loaded
    models.  Returns that clip's launches."""
    import numpy as np
    import torch

    from seervideoldm_tpu_torch.config import (config_from_dict,
                                               sampler_schedule_from)
    from seervideoldm_tpu_torch.inference_img import generate_video
    from seervideoldm_tpu_torch.ops.rotary import inv_freq
    from seervideoldm_tpu_torch.pipelines.loading import load_models
    from seervideoldm_tpu_torch.pipelines.text_video import SeerPipeline

    base = dict(resolution=256, cond_frames=2, num_frames=12,
                ddim_steps=E2E_STEPS, scale=7.5, seed=SEED + 6,
                mixed_precision="bf16", compute_dtype="bfloat16")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sd15_")
    try:
        t0 = time.perf_counter()
        src = write_sd15_dir(tmp, SEED + 5)
        write_s, nbytes = time.perf_counter() - t0, _file_bytes(tmp)
        print(json.dumps({"pretrained_write": {"bytes": nbytes,
                                               "seconds": write_s}}),
              flush=True)
        cfg = config_from_dict(dict(
            base, pretrained_model_name_or_path=tmp,
            fstext_init_ckpt=os.path.join(tmp, "fstext.bin")))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        models, tok = load_models(cfg, torch.device("cuda"))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        fresh_models, _ = load_models(config_from_dict(base), torch.device(
            "cuda"))
        loaded, fresh = 0, []
        for key in ("vae", "clip", "unet", "fstext"):
            seeded = getattr(fresh_models, key).state_dict()
            for k, v in getattr(models, key).state_dict().items():
                if k.endswith("rotary_emb.freqs"):
                    want, what = inv_freq(2 * v.shape[0]).cuda(), "analytic"
                elif k in src[key]:
                    want, what = src[key][k].cuda().to(v.dtype), "the file"
                    loaded += 1
                else:
                    want, what = seeded[k], "the new seed's fresh value"
                    fresh.append(f"{key}.{k}")
                require(v.dtype == want.dtype and torch.equal(v, want),
                        f"pretrained: {key}.{k} differs from {what}")
        del fresh_models
        require(len(fresh) + sum(k.endswith("rotary_emb.freqs")
                                 for k in models.unet.state_dict()) == 320
                and all(k.startswith("unet.") and "temporal_attentions" in k
                        for k in fresh),
                f"pretrained: {len(fresh)} fresh tensors outside the "
                "320 temporal-attention keys")
        peak_load = _peak_gb()

        pipe = SeerPipeline(models, schedule=sampler_schedule_from(cfg),
                            vae_scale=float(cfg.vae_scale))
        image = np.random.RandomState(SEED + 5).randint(0, 256, (256, 256, 3),
                                                        dtype=np.uint8)
        steps = len(pipe.schedule.ddim_tables(E2E_STEPS).timesteps)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with observe_sampling() as seen:
            samples, _ = generate_video(pipe, tok, cfg, image,
                                        "push the green cup to the left")
        torch.cuda.synchronize()
        clip_s = time.perf_counter() - t0
        launches = read_launches()
        _check_frames("pretrained", samples, (1, 10, 256, 256, 3))
        print(json.dumps({"pretrained": {
            "card": card, "bytes_written": nbytes, "write_seconds": write_s,
            "load_seconds": load_s, "tensors_loaded": loaded,
            "tensors_fresh": len(fresh), "peak_mem_gb_load": peak_load,
            "unet_calls": seen["unet_calls"], "s_per_clip": clip_s,
            "peak_mem_gb": _peak_gb(), "launches": launches}}), flush=True)
        require(seen["unet_calls"] == steps,
                f"pretrained: {seen['unet_calls']} UNet calls, not {steps}")
        for name, per_step in PER_STEP.items():
            require(launches[name] == per_step * steps,
                    f"pretrained: {name} launched {launches[name]} times, "
                    f"expected {per_step} x {steps}")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def write_i3d_pt(path: str, seed: int) -> None:
    """Seeded I3D weights under the reference's names (with
    ``num_batches_tracked``), He-scaled kernels, small biases."""
    import numpy as np
    import torch

    from seervideoldm_tpu_torch.evaluation.i3d import InceptionI3d

    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in InceptionI3d().state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("running_var"):
            a = rng.rand(*shape) * 0.5 + 0.5
            sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(0)
        elif k.endswith("running_mean") or k.endswith("bias"):
            a = rng.randn(*shape) * 0.1
        elif k.endswith("bn.weight"):
            a = rng.rand(*shape) * 0.5 + 0.75
        else:
            a = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        sd[k] = torch.from_numpy(a.astype(np.float32))
    torch.save(sd, path)


def write_c3d_npz(npz_path: str, mean_path: str, seed: int) -> None:
    """Seeded chainer-layout C3D weights and a UCF-101-like mean image."""
    import numpy as np

    rng = np.random.RandomState(seed)
    data = {}
    for name, cin, cout in (("conv1a", 3, 64), ("conv2a", 64, 128),
                            ("conv3a", 128, 256), ("conv3b", 256, 256),
                            ("conv4a", 256, 512), ("conv4b", 512, 512),
                            ("conv5a", 512, 512), ("conv5b", 512, 512)):
        data[f"{name}/W"] = (rng.randn(cout, cin, 3, 3, 3)
                             * np.sqrt(2.0 / (cin * 27))).astype(np.float32)
        data[f"{name}/b"] = (rng.randn(cout) * 0.05).astype(np.float32)
    for name, fin, fout in (("fc6", 8192, 4096), ("fc7", 4096, 4096),
                            ("fc8", 4096, 101)):
        data[f"{name}/W"] = (rng.randn(fout, fin)
                             * np.sqrt(2.0 / fin)).astype(np.float32)
        data[f"{name}/b"] = (rng.randn(fout) * 0.05).astype(np.float32)
    np.savez(npz_path, **data)
    np.savez(mean_path, mean=rng.uniform(80, 140, (3, 16, 120, 120)))


def write_clip_model(path: str, seed: int) -> int:
    """A whole HF ``CLIPModel`` state dict at ViT-L/14 width (vision tower,
    text tower, both projections, ``position_ids``, ``logit_scale``), fp16
    safetensors, from seeded port modules.  Returns the bytes written."""
    import torch

    from seervideoldm_tpu_torch.evaluation.clip_sim import (CLIPProjections,
                                                            CLIPVisionModel)
    from seervideoldm_tpu_torch.io.state_dict import write_safetensors
    from seervideoldm_tpu_torch.models.clip_text import CLIPTextModel

    sd = {}
    for m in _seeded_on_card(seed, CLIPVisionModel, CLIPTextModel,
                             CLIPProjections):
        sd.update({k: v.detach().half() for k, v in m.state_dict().items()})
    sd["vision_model.embeddings.position_ids"] = torch.arange(257)[None]
    sd["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    sd["logit_scale"] = torch.tensor(4.6052, dtype=torch.float16)
    return write_safetensors(sd, path, metadata={"format": "pt"})


def _scorers_card_vs_cpu(cfg, videos) -> dict:
    """I3D, C3D and the CLIP ViT built from the eval run's files on the
    card and copied to the CPU, fp32 both (TF32 off), on the videos the
    run scored: relative L2 of the logits / pooled features."""
    import copy

    import numpy as np
    import torch

    from seervideoldm_tpu_torch import eval as eval_entry
    from seervideoldm_tpu_torch.data.transforms import resample_frames
    from seervideoldm_tpu_torch.evaluation.clip_sim import preprocess_frames
    from seervideoldm_tpu_torch.evaluation.fvd import preprocess_videos

    card = torch.device("cuda")
    x_i3d = preprocess_videos(videos).permute(0, 4, 1, 2, 3)
    x_c3d = torch.from_numpy(np.stack(
        [resample_frames(v, 16) for v in videos / 127.5 - 1.0]).astype(
            np.float32))
    vision = eval_entry.build_clip_sim(cfg, card)[0]
    x_clip = preprocess_frames(torch.from_numpy(videos[0, -4:] / 255.0),
                               vision.config.image_size)
    out = {}
    for name, module, x in (("i3d", eval_entry.build_i3d(cfg, card), x_i3d),
                            ("c3d", eval_entry.build_c3d(cfg, card), x_c3d),
                            ("clip_vit", vision, x_clip)):
        cpu = copy.deepcopy(module).cpu()
        with torch.no_grad():
            got = module(x.to(card)).cpu()
            want = cpu(x)
        rel = _rel_l2(got, want)
        out[name] = {"shape": list(x.shape), "rel_l2_err": rel}
        require(bool(torch.isfinite(got).all()), f"eval: {name} non-finite "
                "on the card")
        require(rel <= EVAL_CHECK_RTOL, f"eval: {name} on the card vs the "
                f"CPU, relative L2 {rel} > {EVAL_CHECK_RTOL}")
        del module, cpu
    return out


def phase_eval(card: str, tmp: str) -> tuple:
    """Phase 6d: the ``eval`` entry through ``main(argv)`` from
    ``configs/eval.yaml`` with ``--set`` overrides only, on a synthetic
    Sthv2 val tree of ``EVAL_CLIPS`` clips in ``tmp``, every scorer on with
    files written from seeds; then the scorers on the card against the
    CPU.  Returns the run's launches, its metrics and its ``argv`` (phase
    6f runs the same under a mesh)."""
    import torch

    from seervideoldm_tpu_torch import eval as eval_entry
    from seervideoldm_tpu_torch.config import load_config
    from seervideoldm_tpu_torch.diffusion.schedules import DiffusionSchedule
    from seervideoldm_tpu_torch.evaluation.fvd import FVDEvaluator

    t0 = time.perf_counter()
    data = os.path.join(tmp, "data")
    write_synthetic_sthv2(data, clips=EVAL_CLIPS, frames=14, res=256)
    i3d = os.path.join(tmp, "i3d_pretrained_400.pt")
    write_i3d_pt(i3d, SEED + 7)
    c3d = os.path.join(tmp, "conv3d_deepnetA_ucf.npz")
    write_c3d_npz(c3d, os.path.join(tmp, "mean2.npz"), SEED + 8)
    clip = os.path.join(tmp, "clip_vit_l14.safetensors")
    clip_bytes = write_clip_model(clip, SEED + 9)
    setup_s = time.perf_counter() - t0
    conf = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "configs", "eval.yaml")
    sets = [f"data_dir={data}", f"output_dir={os.path.join(tmp, 'out')}",
            "MAX_FVD_BATCH=2", "compute_is=true", "is_cast_frames=true",
            "compute_clip_sim=true", f"i3d_ckpt={i3d}", f"c3d_ckpt={c3d}",
            f"clip_sim_ckpt={clip}", "num_workers=1"]
    argv = ["--config", conf] + [a for s in sets for a in ("--set", s)]
    cfg = load_config(conf, sets)
    steps = len(DiffusionSchedule.create(1000).ddim_tables(
        cfg.ddim_steps).timesteps)
    scored = []
    embed = FVDEvaluator.embed

    def recording(self, videos):
        scored.append(videos)
        return embed(self, videos)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    FVDEvaluator.embed = recording
    t0 = time.perf_counter()
    try:
        with observe_sampling() as seen:
            res = eval_entry.main(argv, device="cuda")
    finally:
        FVDEvaluator.embed = embed
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_launches()
    peak = _peak_gb()
    metrics = {k: res[k] for k in ("fvd", "kvd", "is_mean", "is_std",
                                   "clip_sim")}
    require(all(math.isfinite(v) for v in metrics.values()),
            f"eval: non-finite metrics {metrics}")
    require(res["clips"] == EVAL_CLIPS and len(scored) == 4,
            f"eval: {res['clips']} clips, {len(scored)} FVD embeddings "
            f"(expected {EVAL_CLIPS} clips, 2 buckets of fake + real)")
    require(tuple(scored[0].shape) == (2, 12, 256, 256, 3),
            f"eval: FVD saw {tuple(scored[0].shape)}")
    check = _scorers_card_vs_cpu(cfg, scored[0])
    per_clip = {f"{k}_s_per_clip": v / res["clips"]
                for k, v in res["seconds"].items()}
    print(json.dumps({"eval": {
        "card": card, "clips": res["clips"], "unet_calls":
        seen["unet_calls"], **per_clip, "run_seconds": run_s,
        "setup_seconds": setup_s, "clip_file_bytes": clip_bytes,
        "metrics_random_weights": metrics, "card_vs_cpu": check,
        "tol": EVAL_CHECK_RTOL, "peak_mem_gb": peak,
        "launches": launches}}), flush=True)
    calls = steps * EVAL_CLIPS
    require(seen["unet_calls"] == calls,
            f"eval: {seen['unet_calls']} UNet calls, expected {calls}")
    for name, per_step in PER_STEP.items():
        require(launches[name] == per_step * calls,
                f"eval: {name} launched {launches[name]} times, "
                f"expected {per_step} x {calls}")
    return launches, metrics, argv


# ------------------------------------ serving and eval under a mesh, probe

MESH_SHAPE = {"data": 2}
MESH_TIMEOUT = 900
EVAL_MESH_RTOL = 5e-2      # IS and CLIPSIM under the mesh against 6d's
# the quality probe at configs/serve.yaml's shape (tools/quality_probe.py)
PROBE_ARGS = ["--resolution", "256", "--num_frames", "12", "--cond_frames",
              "2", "--ddim_steps", "30", "--dpm_steps", "20", "--iters", "1"]


def _serve_mesh_config(steps=None):
    """``configs/serve.yaml`` under ``MESH_SHAPE`` with the raised batching
    window (and ``steps`` DDIM steps)."""
    from seervideoldm_tpu_torch.config import load_config

    root = os.path.dirname(os.path.abspath(__file__))
    sets = [f"mesh_shape={json.dumps(MESH_SHAPE)}",
            f"serve_max_wait_ms={SERVE_WAIT_MS}"]
    if steps is not None:
        sets.append(f"ddim_steps={steps}")
    return load_config(os.path.join(root, "configs", "serve.yaml"), sets)


def mesh_rank(rank: int, eval_argv: list) -> dict:
    """Phase 6f on one rank (started by ``parallel.launch``): the service of
    ``configs/serve.yaml`` under ``MESH_SHAPE`` (rank 0 the front end, the
    other rank following): its warm-up and a batch of [A, B, C, D] at the
    config's steps, then [A, B, C, D] at ``SERVE_CHECK_STEPS`` under
    counter 0; then phase 6d's eval run under the mesh with
    ``val_batch_size`` 2.  Returns this rank's numbers (rank 0 also the
    rows)."""
    import dataclasses

    import torch

    from seervideoldm_tpu_torch import eval as eval_entry
    from seervideoldm_tpu_torch.config import pab_config_from
    from seervideoldm_tpu_torch.inference_img import build_pipeline
    from seervideoldm_tpu_torch.serve import build_service

    serve = _serve_mesh_config()
    t0 = _start_run()
    pipe, tok, cfg = build_pipeline(serve, "cuda")
    out = {"build_seconds": time.perf_counter() - t0}
    nb = int(cfg.serve_max_batch)
    runs = {}
    for key, steps in (("full", int(cfg.ddim_steps)),
                       ("check", SERVE_CHECK_STEPS)):
        run_cfg = dataclasses.replace(cfg, ddim_steps=steps)
        calls = len(pipe.schedule.ddim_tables(steps).timesteps)
        svc = build_service(run_cfg, pipe, tok)
        row = {"unet_calls_per_batch": calls, "expected_launches_per_batch":
               _pab_expected(calls, pab_config_from(cfg))[0]}
        if rank == 0:
            try:
                if key == "full":
                    t0 = _start_run()
                    svc.warmup()
                    row["warmup"] = _end_run(t0)
                t0 = _start_run()
                rows = _service_batch(svc, SERVE_A_SPEC[:nb])
                row["batch"] = _end_run(t0)
                row["healthz"] = svc.stats()
            finally:
                svc.stop()
            if key == "check":
                row["rows"] = rows
        else:
            t0 = _start_run()
            svc.follow()
            row["follow"] = _end_run(t0)
            row["follow"]["batches"] = 2 if key == "full" else 1
        runs[key] = row
    out["serving"] = runs
    out["serving_peak_mem_gb"] = max(
        r[k]["peak_mem_gb"] for r in runs.values()
        for k in ("warmup", "batch", "follow") if k in r)
    del svc, pipe
    torch.cuda.empty_cache()
    argv = eval_argv + ["--set", f"mesh_shape={json.dumps(MESH_SHAPE)}",
                        "--set", "val_batch_size=2"]
    t0 = _start_run()
    with observe_sampling() as seen:
        res = eval_entry.main(argv, device="cuda")
    row = _end_run(t0)
    row.update(unet_calls=seen["unet_calls"], clips=res["clips"],
               metrics={k: res[k] for k in ("fvd", "kvd", "is_mean",
                                            "is_std", "clip_sim")},
               stage_seconds=res["seconds"])
    out["eval"] = row
    return out


def serve_entry_mesh(card: str) -> dict:
    """The ``serve`` entry as ``PAR_RANKS`` processes under ``MESH_SHAPE``
    at ``SERVE_CHECK_STEPS``: rank 0's port, the warm-up, four concurrent
    POSTs (``/healthz`` 1 batch, 4 requests), a lone POST (2, 5), a
    malformed one (400), then SIGTERM to every rank: each exits 0 within
    ``SERVE_STOP_TIMEOUT``."""
    procs, port, startup, logs = _start_serve(
        ["serve_port=0", f"mesh_shape={json.dumps(MESH_SHAPE)}",
         f"serve_max_wait_ms={SERVE_WAIT_MS}",
         f"ddim_steps={SERVE_CHECK_STEPS}"], ranks=PAR_RANKS)
    try:
        body = {"prompt": "push the green cup to the left"}
        bodies = [dict(body, image=_b64_png(SEED + 40 + i, 256))
                  for i in range(4)]
        t0 = time.perf_counter()
        replies = _concurrent([functools.partial(_http, port, "/generate", b)
                               for b in bodies])
        batch_s = time.perf_counter() - t0
        for i, (status, ctype, data) in enumerate(replies):
            require(status == 200 and ctype == "image/gif",
                    f"serve entry (mesh): request {i} answered {status}")
            _gif_frames(f"serve entry (mesh) request {i}", data, 256, 12)
        health = [json.loads(_http(port, "/healthz")[2])]
        t0 = time.perf_counter()
        status, ctype, data = _http(port, "/generate",
                                    dict(body, image=_b64_png(SEED + 44, 256)))
        lone_s = time.perf_counter() - t0
        require(status == 200 and ctype == "image/gif",
                f"serve entry (mesh): the lone request answered {status}")
        health.append(json.loads(_http(port, "/healthz")[2]))
        require([(h["batches"], h["requests"]) for h in health]
                == [(1, 4), (2, 5)], f"serve entry (mesh): healthz {health}")
        status = _http(port, "/generate", b'{"prompt": "x", "image": 3')[0]
        require(status == 400,
                f"serve entry (mesh): a malformed body answered {status}")
        codes, stop_s = _sigterm_all("serve entry (mesh)", procs, logs)
        require(any("ranks=2" in ln for ln in logs[0]),
                "serve entry (mesh): rank 0 does not serve 2 ranks")
        return {"startup_seconds": startup, "batch_seconds": batch_s,
                "lone_request_seconds": lone_s, "healthz": health,
                "stop_seconds": stop_s, "exit_codes": codes,
                "ddim_steps": SERVE_CHECK_STEPS}
    finally:
        _stop_procs(procs)


def _per_batch(run: dict) -> dict:
    """A rank's launches per batch of a ``mesh_rank`` serving run: rank
    0's batch, or a follower's run over its batches."""
    part = run.get("batch") or run["follow"]
    n = part.get("batches", 1)
    return {name: v / n for name, v in part["launches"].items()}


def phase_mesh(card: str, one_card_rows: list, eval_argv: list,
               eval_ref: dict) -> tuple:
    """Phase 6f (module docstring): serving and eval under ``MESH_SHAPE`` on
    ``PAR_RANKS`` ranks sharing the card, then the ``serve`` entry on as
    many ranks.  Returns rank 0's launches of the serving batches and of
    the eval run."""
    import numpy as np
    import torch

    from seervideoldm_tpu_torch.parallel import launch
    from seervideoldm_tpu_torch.parallel.distributed import pick_backend

    transport = pick_backend("cuda", PAR_RANKS)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        ranks = launch.run(mesh_rank, PAR_RANKS, args=(eval_argv,),
                           backend=transport, timeout=MESH_TIMEOUT,
                           threads=max(1, HOST_CORES // PAR_RANKS))
    except RuntimeError as e:
        raise SmokeFailure(f"serving / eval under a mesh: {e}") from e
    wall = time.perf_counter() - t0
    entry = serve_entry_mesh(card)

    # serving: per rank the launches of each batch, the rows against 6e's
    full, check = ranks[0]["serving"]["full"], ranks[0]["serving"]["check"]
    for r, out in enumerate(ranks):
        for key, run in out["serving"].items():
            want = run["expected_launches_per_batch"]
            parts = ([run["warmup"], run["batch"]] if "warmup" in run
                     else [run["batch"]] if "batch" in run
                     else [run["follow"]])
            for part in parts:
                n = part.get("batches", 1)
                for name, per in want.items():
                    require(part["launches"][name] == per * n,
                            f"serving mesh rank {r} ({key}): {name} "
                            f"launched {part['launches'][name]} times, "
                            f"expected {per} x {n} batches")
    nb = len(SERVE_A_SPEC)
    require((full["healthz"]["batches"], full["healthz"]["requests"])
            == (1, nb), f"serving mesh: healthz {full['healthz']}")
    rels = [_rel_l2(torch.from_numpy(np.asarray(a)),
                    torch.from_numpy(np.asarray(b)))
            for a, b in zip(check["rows"], one_card_rows)]
    require(len(rels) == len(one_card_rows) and max(rels) <= PAR_UNET_RTOL,
            f"serving mesh: rows against one card, relative L2 {rels} > "
            f"{PAR_UNET_RTOL}")
    batch_s = full["batch"]["seconds"]
    print(json.dumps({"serving_mesh": {
        "card": card, "mesh": MESH_SHAPE, "ranks": PAR_RANKS,
        "transport": transport, "max_batch": nb,
        "ddim_steps": int(_serve_mesh_config().ddim_steps),
        "warmup_seconds": full["warmup"]["seconds"], "batch_seconds": batch_s,
        "requests_per_s_full_batch": nb / batch_s,
        "build_seconds_per_rank": [o["build_seconds"] for o in ranks],
        "peak_mem_gb_per_rank": [o["serving_peak_mem_gb"] for o in ranks],
        "launches_per_batch_per_rank": [_per_batch(o["serving"]["full"])
                                        for o in ranks],
        "expected_launches_per_batch": full["expected_launches_per_batch"],
        "broadcasts_rank0": full["batch"]["collectives"].get("broadcast"),
        "rows_rel_l2_vs_one_card": rels, "tol": PAR_UNET_RTOL,
        "check_ddim_steps": SERVE_CHECK_STEPS, "launch_seconds": wall,
        "entry": entry}}), flush=True)

    # eval: each clip once, the same metrics on every rank
    evs = [o["eval"] for o in ranks]
    steps = full["unet_calls_per_batch"]
    for r, ev in enumerate(evs):
        require(ev["clips"] == EVAL_CLIPS, f"eval mesh rank {r}: "
                f"{ev['clips']} clips scored, expected {EVAL_CLIPS}")
        calls = steps * EVAL_CLIPS // 2
        require(ev["unet_calls"] == calls, f"eval mesh rank {r}: "
                f"{ev['unet_calls']} UNet calls, expected {calls}")
        for name, per_step in PER_STEP.items():
            require(ev["launches"][name] == per_step * calls,
                    f"eval mesh rank {r}: {name} launched "
                    f"{ev['launches'][name]} times, expected {per_step} x "
                    f"{calls}")
    metrics = evs[0]["metrics"]
    require(all(math.isfinite(v) for v in metrics.values()),
            f"eval mesh: non-finite metrics {metrics}")
    require(all(ev["metrics"] == metrics for ev in evs),
            f"eval mesh: metrics differ over the ranks "
            f"{[ev['metrics'] for ev in evs]}")
    rel = {k: abs(metrics[k] - eval_ref[k]) / abs(eval_ref[k])
           for k in ("is_mean", "clip_sim")}
    print(json.dumps({"eval_mesh": {
        "card": card, "mesh": MESH_SHAPE, "ranks": PAR_RANKS,
        "transport": transport, "val_batch_size": 2, "clips": evs[0]["clips"],
        "unet_calls_per_rank": [ev["unet_calls"] for ev in evs],
        "metrics_random_weights": metrics, "one_card_metrics": eval_ref,
        "rel_diff_vs_one_card": rel, "tol": EVAL_MESH_RTOL,
        "seconds_per_rank": [ev["seconds"] for ev in evs],
        "stage_seconds_rank0": evs[0]["stage_seconds"],
        "peak_mem_gb_per_rank": [ev["peak_mem_gb"] for ev in evs],
        "launches_per_rank": [ev["launches"] for ev in evs]}}), flush=True)
    require(max(rel.values()) <= EVAL_MESH_RTOL,
            f"eval mesh: IS / CLIPSIM against one card {rel} > "
            f"{EVAL_MESH_RTOL}")
    serving = {name: full["warmup"]["launches"][name]
               + full["batch"]["launches"][name]
               + check["batch"]["launches"][name] for name in wrappers()}
    return serving, evs[0]["launches"]


def phase_quality_probe(card: str) -> dict:
    """Phase 6g: ``tools/quality_probe.py`` through ``main(argv)`` at
    ``configs/serve.yaml``'s shape (``PROBE_ARGS``, every mode), on one
    card; every row finite, K1-K5 launched.  Returns its launches."""
    import torch

    from seervideoldm_tpu_torch.tools import quality_probe

    torch.cuda.empty_cache()
    reset_launches()
    t0 = time.perf_counter()
    rows, summary = quality_probe.main(PROBE_ARGS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    require(sorted(r["mode"] for r in rows) == sorted(quality_probe.MODES),
            f"quality probe: modes {[r['mode'] for r in rows]}")
    for r in rows:
        require(all(math.isfinite(r[k]) for k in (
            "rmse", "maxdiff", "rel_rmse", "speedup", "latency_s")),
            f"quality probe: a non-finite row {r}")
    require(math.isfinite(summary["parity_std"]) and summary["parity_std"]
            > 0, f"quality probe: parity std {summary['parity_std']}")
    for name in FORWARD_KERNELS:
        require(launches[name] > 0,
                f"quality probe: {name} was not launched")
    pab = next(r for r in rows if r["mode"] == "pab")
    print(json.dumps({"quality_probe": {
        "card": card, "args": PROBE_ARGS, "pab_rel_rmse": pab["rel_rmse"],
        "rows": rows, "summary": summary, "seconds": seconds,
        "launches": launches}}), flush=True)
    return launches


def phase_svd(card: str) -> dict:
    """Phase 6h: Stable Video Diffusion XT's UNet and temporal decoder at
    published widths on random weights from ``SEED``: one UNet call at the
    cell's shapes (CFG batch 2, ``SVD_FRAMES`` frames of ``SVD_LATENT_HW``
    latents) and one decode of those frames to 576 x 1024, each after a
    warm-up call, with the launch counts zeroed just before and read just
    after; K2 ``SVD_K2_PER_UNET_CALL`` times in the UNet call, K11 once a
    norm (``SVD_GN_PER_UNET_CALL``, ``SVD_GN_PER_DECODE``) with a moments
    launch each.  Returns the two calls' launches."""
    import torch

    from seervideoldm_tpu_torch.models.svd_unet import \
        UNetSpatioTemporalConditionModel
    from seervideoldm_tpu_torch.models.svd_vae import \
        AutoencoderKLTemporalDecoder
    from seervideoldm_tpu_torch.utils.device import cast_for_compute

    def counted(what: str, call, out_shape: tuple, k2: int, k11: int):
        call()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        seconds, launches = time.perf_counter() - t0, read_launches()
        require(tuple(out.shape) == out_shape,
                f"svd {what}: output shaped {tuple(out.shape)}")
        require(bool(torch.isfinite(out).all()) and float(out.float().std())
                > 0.0, f"svd {what}: non-finite or constant output")
        require(launches["flash_attention"] == k2,
                f"svd {what}: K2 launched {launches['flash_attention']} "
                f"times, expected {k2}")
        require(launches["group_norm"] == k11
                and launches["group_norm_moments"] == k11,
                f"svd {what}: K11 launched {launches['group_norm']} times "
                f"({launches['group_norm_moments']} moments), expected {k11}")
        print(json.dumps({"svd": {
            "card": card, "call": what, "shape": list(out_shape),
            "seconds": seconds,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches}}), flush=True)
        return launches

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf, (h, w) = torch.bfloat16, SVD_LATENT_HW
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.random.fork_rng(devices=[0]), torch.device("cuda"):
        torch.manual_seed(SEED)
        unet = UNetSpatioTemporalConditionModel()
    cast_for_compute(unet, bf).eval().requires_grad_(False)
    sample = _randn((2, SVD_FRAMES, h, w, 8), gen, bf)
    context = torch.cat([torch.zeros(1, 1, 1024, device="cuda", dtype=bf),
                         _randn((1, 1, 1024), gen, bf)])
    ids = torch.tensor([[6.0, 127.0, 0.02]] * 2, device="cuda")
    with torch.no_grad():
        unet_launches = counted(
            "unet", lambda: unet(sample, 0.25 * math.log(700.0), context, ids),
            (2, SVD_FRAMES, h, w, 4), SVD_K2_PER_UNET_CALL,
            SVD_GN_PER_UNET_CALL)
    del unet, sample
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.random.fork_rng(devices=[0]), torch.device("cuda"):
        torch.manual_seed(SEED)
        vae = AutoencoderKLTemporalDecoder()
    cast_for_compute(vae, bf).eval().requires_grad_(False)
    latents = _randn((1, SVD_FRAMES, h, w, 4), gen, bf)
    with torch.no_grad():
        decode_launches = counted(
            "decode", lambda: vae.decode(latents),
            (1, SVD_FRAMES, 8 * h, 8 * w, 3), 0, SVD_GN_PER_DECODE)
    del vae, latents
    torch.cuda.empty_cache()
    return {name: unet_launches[name] + decode_launches[name]
            for name in unet_launches}


def phase_training(card: str, profile: str | None, tmp: str) -> tuple:
    """The port's ``train`` entry at full SD-1.5 width on a synthetic
    Sthv2 tree written under ``tmp``, then sampling from the checkpoint it
    wrote.  Returns (launches, what phase 7b reuses: the config, the
    losses, seconds per optimizer step and peak memory)."""
    import numpy as np
    import torch

    from seervideoldm_tpu_torch.config import config_from_dict
    from seervideoldm_tpu_torch.inference_img import build_pipeline, generate_video
    from seervideoldm_tpu_torch.io.checkpoint import (FSTEXT_FILE, STATE_FILE,
                                                      UNET_FILE,
                                                      export_state_dicts)
    from seervideoldm_tpu_torch.pipelines.loading import load_models
    from seervideoldm_tpu_torch.train import train

    torch.cuda.empty_cache()
    write_synthetic_sthv2(os.path.join(tmp, "data"), clips=4, frames=14,
                          res=256)
    micro_steps = TRAIN_OPT_STEPS * TRAIN_ACCUM
    raw = dict(
        output_dir=os.path.join(tmp, "out"),
        data_dir=os.path.join(tmp, "data"), dataset="sthv2",
        resolution=256, num_frames=12, cond_frames=2, train_batch_size=1,
        gradient_accumulation_steps=TRAIN_ACCUM, learning_rate=1.28e-5,
        scale_lr=True, lr_scheduler="cosine", lr_warmup_steps=1,
        max_train_steps=TRAIN_OPT_STEPS, save_steps=TRAIN_OPT_STEPS,
        max_grad_norm=0.3, num_workers=4, seed=SEED,
        mixed_precision="bf16", compute_dtype="bfloat16", remat=False,
        # From random weights every proj_out is zero, the frozen text
        # sites' included, so the eps loss alone sends FSText no
        # gradient at all; the FSText init objective does.  The
        # temporal sites open up by themselves: their own proj_out
        # trains first (step 2; step 1 has lr(0) = 0 under a 1-step
        # warmup), then everything upstream of it.
        text_loss=True)
    cfg = config_from_dict(dict(raw))

    # the seeded initial weights, built once more to compare against
    init, _ = load_models(cfg, "cuda", trainable_scope=cfg.trainable_scope)
    masters0 = {n: t.detach().cpu().clone() for n, t in init.masters.items()}
    weights0 = export_state_dicts(init)
    n_trainable = sum(t.numel() for t in masters0.values())
    del init
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with unet_group_norms() as gn_per_call:
        summary = train(config_from_dict(dict(raw)))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_launches()

    require(summary["global_step"] == TRAIN_OPT_STEPS
            and summary["micro_steps"] == micro_steps,
            f"training: took {summary['global_step']} optimizer steps / "
            f"{summary['micro_steps']} micro-steps")
    require(all(np.isfinite(summary["losses"])) and summary["losses"],
            f"training: losses {summary['losses']}")
    # what training changed, read back from the checkpoint it wrote
    ckpt = summary["checkpoint"]
    masters = torch.load(os.path.join(ckpt, STATE_FILE),
                         map_location="cpu")["masters"]
    require(set(masters) == set(masters0),
            "training: the checkpoint's trainable set differs")
    still = [n for n, t in masters.items() if torch.equal(t, masters0[n])]
    groups = {"fstext": 0, "temporal_attentions": 0}
    for n in masters:
        groups["fstext" if n.startswith("fstext.")
               else "temporal_attentions"] += 1
    require(not still, f"training: {len(still)} trainable masters did not "
            f"move, e.g. {still[:3]}")
    require(all(groups.values()), f"training: trainable groups {groups}")
    changed, n_frozen = [], 0
    for model, file in (("unet", UNET_FILE), ("fstext", FSTEXT_FILE)):
        saved = torch.load(os.path.join(ckpt, file), map_location="cpu")
        require(set(saved) == set(weights0[model]),
                f"training: {file} holds other names than the model")
        for key, t in saved.items():
            if f"{model}.{key}" in masters:
                continue
            n_frozen += 1
            if not torch.equal(t, weights0[model][key]):
                changed.append(f"{model}.{key}")
    require(n_frozen > 0 and not changed,
            f"training: {len(changed)} of {n_frozen} frozen weights "
            f"changed, e.g. {changed[:3]}")
    del weights0
    for name, per in PER_MICRO_STEP.items():
        require(launches[name] == per * micro_steps,
                f"training: {name} launched {launches[name]} times, "
                f"expected {per} x {micro_steps} micro-steps")
    require_group_norms("training", gn_per_call, micro_steps, launches)
    # measured by the entry per optimizer step (CUDA events around its
    # micro-steps, data loading included, the save excluded); the first
    # carries cuBLAS/cuDNN set-up, so report the rest
    steady = summary["step_seconds"][1:]
    s_step = sum(steady) / len(steady)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps({"train": {
        "card": card, "optimizer_steps": TRAIN_OPT_STEPS,
        "micro_steps": micro_steps, "accumulation": TRAIN_ACCUM,
        "remat": bool(cfg.remat), "trainable_params": n_trainable,
        "trainable_tensors": groups, "frozen_tensors_unchanged": n_frozen,
        "losses": summary["losses"],
        "s_per_optimizer_step": s_step,
        "optimizer_step_seconds": summary["step_seconds"],
        # not measured apart: the step's time over its micro-steps
        "s_per_micro_step": s_step / TRAIN_ACCUM,
        "train_entry_seconds": elapsed, "peak_mem_gb": peak,
        "optimizer_state_bytes": summary["optimizer_state_bytes"],
        "launches": launches,
        "launches_per_micro_step": dict(PER_MICRO_STEP,
                                        group_norm=GN_PER_UNET_CALL)}}),
        flush=True)
    if profile:
        models, _ = load_models(cfg, "cuda",
                                trainable_scope=cfg.trainable_scope)
        profile_train_step(models, profile + ".train")
        del models
    torch.cuda.empty_cache()

    pipe, tok, scfg = build_pipeline(dict(
        resolution=256, cond_frames=2, num_frames=12,
        ddim_steps=TRAIN_SAMPLE_STEPS, scale=7.5, seed=SEED,
        mixed_precision="bf16", compute_dtype="bfloat16",
        learned_unet_ckpt=ckpt))
    trained = torch.load(os.path.join(ckpt, "pytorch_model_1.bin"))
    loaded = pipe.m.fstext.state_dict()
    require(all(torch.equal(loaded[k].cpu(), v.to(loaded[k].dtype))
                for k, v in trained.items()),
            "training: the sampling pipeline did not load the checkpoint")
    image = np.random.RandomState(SEED).randint(0, 256, (256, 256, 3),
                                                dtype=np.uint8)
    samples, _ = generate_video(pipe, tok, scfg, image,
                                "pushing thing 0 from left to right")
    torch.cuda.synchronize()
    require(tuple(samples.shape) == (1, 10, 256, 256, 3),
            f"training: sampled frames shaped {tuple(samples.shape)}")
    require(bool(torch.isfinite(samples).all()),
            "training: non-finite frames from the trained checkpoint")
    print(json.dumps({"train_sample": {
        "checkpoint_files": sorted(os.listdir(ckpt)),
        "ddim_steps": TRAIN_SAMPLE_STEPS,
        "frames": list(samples.shape)}}), flush=True)
    del pipe
    torch.cuda.empty_cache()
    shutil.rmtree(raw["output_dir"], ignore_errors=True)   # DISK_NOTE
    return launches, {"raw": raw, "losses": summary["losses"],
                      "s_per_optimizer_step": s_step,
                      "peak_mem_gb": peak,
                      "optimizer_state_bytes":
                          summary["optimizer_state_bytes"],
                      "trainable_params": n_trainable}


# ---------------------------------------------------- training options

LORA_RANK = 8
OPTION_OPT_STEPS = 2           # optimizer steps of phase 7b's (a) and (b)
STATE_BYTES_PER_PARAM = 2.1    # 8-bit moments: 2 + 8 / 256, padding
NATIVE_MAX_ERR, NATIVE_MEAN_ERR = 0.03, 0.005   # tests/test_native_loader.py
PROJ_OUT_STD = 0.05            # the seeded base's proj_out weights
# under LoRA on every attention projection each K2 site's q, k and v need a
# gradient (their weights carry adapters), the first spatial site's too:
# 5 K8 launches per micro-step where the reference scope has 4
PER_MICRO_STEP_LORA = dict(PER_MICRO_STEP, flash_attention_bwd=5)


def write_seeded_base(raw: dict, path: str) -> dict:
    """The seeded init of ``raw``'s models with every transformer's
    ``proj_out`` drawn non-zero, written to ``path`` as the directory the
    pretrained route reads (``io.pretrained.write_pretrained_dir``: the
    whole SeerUNet, VAE, CLIP and ``fstext.bin``): the base phase 7b's runs
    start from, as the JAX entry would read it.  At random init every
    ``proj_out`` is zero, which hides each attention site from the output,
    so no adapter would get a gradient.  Returns the UNet's and FSText's
    state dicts as the modules hold them (CPU)."""
    import torch

    from seervideoldm_tpu_torch.config import config_from_dict
    from seervideoldm_tpu_torch.io.checkpoint import export_state_dicts
    from seervideoldm_tpu_torch.io.pretrained import write_pretrained_dir
    from seervideoldm_tpu_torch.pipelines.loading import load_models

    models, _ = load_models(config_from_dict(dict(raw)), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    with torch.no_grad():
        for name, p in models.unet.named_parameters():
            if ".proj_out." in name:
                p.copy_(torch.randn(p.shape, generator=gen, device="cuda")
                        * PROJ_OUT_STD)
    sds = export_state_dicts(models)
    write_pretrained_dir(models, path)
    del models
    return sds


def _base_keys(path: str) -> dict:
    """The config keys that start a run from ``write_seeded_base``'s
    directory."""
    return dict(pretrained_model_name_or_path=path,
                fstext_init_ckpt=os.path.join(path, "fstext.bin"))


def _option_run(card: str, run: str, raw: dict, opt_steps: int,
                per_micro: dict) -> tuple:
    """One ``train`` entry run of phase 7b: launch counts zeroed just
    before and read just after (``per_micro`` x micro-steps each), losses
    finite.  Returns (summary, the checkpoint's masters on the CPU,
    launches, seconds, peak GB)."""
    import numpy as np
    import torch

    from seervideoldm_tpu_torch.config import config_from_dict
    from seervideoldm_tpu_torch.io.checkpoint import STATE_FILE
    from seervideoldm_tpu_torch.train import train

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with unet_group_norms() as gn_per_call:
        summary = train(config_from_dict(dict(raw)))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_launches()
    peak = _peak_gb()
    micro = opt_steps * TRAIN_ACCUM
    require(summary["global_step"] == opt_steps
            and summary["micro_steps"] == micro,
            f"training options {run}: {summary['global_step']} optimizer "
            f"steps / {summary['micro_steps']} micro-steps")
    require(summary["losses"] and all(np.isfinite(summary["losses"])),
            f"training options {run}: losses {summary['losses']}")
    for name, per in per_micro.items():
        require(launches[name] == per * micro,
                f"training options {run}: {name} launched {launches[name]} "
                f"times, expected {per} x {micro} micro-steps")
    require_group_norms(f"training options {run}", gn_per_call, micro,
                        launches)
    masters = torch.load(os.path.join(summary["checkpoint"], STATE_FILE),
                         map_location="cpu")["masters"]
    return summary, masters, launches, elapsed, peak


def _unmoved(masters: dict, start: dict) -> list:
    """Names of ``masters`` (``{"<model>.<name>": t}``) still equal to
    their value in ``start`` (``{"unet": sd, "fstext": sd}``)."""
    import torch

    out = []
    for name, t in masters.items():
        model, _, pname = name.partition(".")
        if torch.equal(t, start[model][pname].to(t.dtype)):
            out.append(name)
    return out


def _lora_forward_check(ckpt: str, raw: dict, scale: float) -> dict:
    """The merged checkpoint loaded strictly by the sampling pipeline; one
    UNet call from it against the LoRA-applied call on the base with the
    checkpoint's adapters, bit for bit; then, at seeded non-zero B (a
    delta bf16 resolves), the merge (``apply_lora``) against the applied
    forward again, bit for bit: both sides round the same W + s (A B)^T to
    the weight's dtype once."""
    import torch

    from seervideoldm_tpu_torch.config import config_from_dict
    from seervideoldm_tpu_torch.inference_img import build_pipeline
    from seervideoldm_tpu_torch.io.checkpoint import STATE_FILE
    from seervideoldm_tpu_torch.pipelines.loading import load_models
    from seervideoldm_tpu_torch.training.lora import apply_lora, lora_applied

    plain = dict(raw, lora_rank=0, use_8bit_adam=False)
    pipe, _, _ = build_pipeline(dict(plain, learned_unet_ckpt=ckpt), "cuda")
    base, _ = load_models(config_from_dict(plain), "cuda")
    masters = torch.load(os.path.join(ckpt, STATE_FILE),
                         map_location="cuda")["masters"]
    lora = {k[len("lora."):]: v for k, v in masters.items()
            if k.startswith("lora.")}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    unet_cfg, dtype = base.unet.config, base.unet.conv_in.weight.dtype
    lat, f = int(raw["resolution"]) // 8, int(raw["num_frames"])
    x = torch.randn(2, f, lat, lat, unet_cfg.in_channels, generator=gen,
                    device="cuda").to(dtype)
    ctx = torch.randn(2, f, 77, unet_cfg.cross_attention_dim, generator=gen,
                      device="cuda").to(dtype)
    ts = torch.full((2,), 500, dtype=torch.long, device="cuda")
    with torch.no_grad():
        merged = pipe.m.unet(x, ts, ctx)
        with lora_applied(base.unet, lora, scale):
            applied = base.unet(x, ts, ctx)
        plain_out = base.unet(x, ts, ctx)
        moved = {k: v.clone() for k, v in lora.items()}
        for k, v in moved.items():
            if k.endswith("lora_b"):
                v.copy_(torch.randn(v.shape, generator=gen, device="cuda")
                        * 0.02)
        with lora_applied(base.unet, moved, scale):
            applied_b = base.unet(x, ts, ctx)
        sd = apply_lora(dict(base.unet.state_dict()), moved, scale)
        base.unet.load_state_dict(sd, strict=True)
        merged_b = base.unet(x, ts, ctx)
    torch.cuda.synchronize()
    out = {"ckpt_equals_applied": torch.equal(merged, applied),
           "merged_equals_applied_nonzero_b": torch.equal(merged_b,
                                                          applied_b),
           "rel_l2_trained_b_vs_base": _rel_l2(applied, plain_out),
           "rel_l2_nonzero_b_vs_base": _rel_l2(applied_b, applied)}
    del pipe, base
    torch.cuda.empty_cache()
    require(out["ckpt_equals_applied"], "training options lora: the merged "
            "checkpoint's UNet call differs from the LoRA-applied one (rel "
            f"L2 {_rel_l2(merged, applied)})")
    require(out["merged_equals_applied_nonzero_b"], "training options lora: "
            "apply_lora's merge differs from the applied forward at non-zero "
            f"B (rel L2 {_rel_l2(merged_b, applied_b)})")
    require(out["rel_l2_nonzero_b_vs_base"] > 0, "training options lora: a "
            "non-zero B does not change the UNet's output")
    return out


def _native_check(tree: str) -> dict:
    """One clip of the synthetic tree through the native loader against
    PIL; required when the machine has libjpeg's header."""
    import glob

    import numpy as np

    from seervideoldm_tpu_torch.data import native
    from seervideoldm_tpu_torch.data.transforms import load_frame

    paths = sorted(glob.glob(os.path.join(tree, "rawframes", "0", "*.jpg")))
    has_header = os.path.exists("/usr/include/jpeglib.h")
    if not native.native_available():
        reason = native.unavailable_reason()
        require(not has_header, "training options: the machine has "
                f"jpeglib.h but the native loader did not build: {reason}")
        return {"native_loader": False, "reason": reason}
    t0 = time.perf_counter()
    got = native.decode_frames(paths, 256)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = np.stack([load_frame(p, 256) for p in paths])
    pil_s = time.perf_counter() - t0
    require(got is not None, "training options: the native loader refused "
            "the tree's JPEGs")
    err = np.abs(got - want)
    out = {"native_loader": True, "frames": len(paths),
           "max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
           "native_seconds": native_s, "pil_seconds": pil_s}
    require(out["max_abs_err"] <= NATIVE_MAX_ERR
            and out["mean_abs_err"] <= NATIVE_MEAN_ERR,
            f"training options: native vs PIL {out}")
    return out


def phase_training_options(card: str, tmp: str, phase7: dict) -> tuple:
    """Phase 7b (module docstring) on phase 7's tree and config.  Returns
    the launches summed over its three runs, and (a)'s config, losses and
    checkpoint (phase 8's (l) is held against them)."""
    import torch

    from seervideoldm_tpu_torch.io.checkpoint import FSTEXT_FILE, UNET_FILE
    from seervideoldm_tpu_torch.training.lora import lora_scale

    base_dir = os.path.join(tmp, "base")
    start = write_seeded_base(phase7["raw"], base_dir)
    base = dict(phase7["raw"], max_train_steps=OPTION_OPT_STEPS,
                save_steps=OPTION_OPT_STEPS, **_base_keys(base_dir))
    total = {name: 0 for name in wrappers()}

    def add(launches):
        for name in total:
            total[name] += launches[name]

    # (b) 8-bit AdamW on the reference scope (the temporal attentions and
    # FSText) from the seeded base
    raw = dict(base, output_dir=os.path.join(tmp, "out_8bit"),
               use_8bit_adam=True)
    summary, masters, launches, secs, peak = _option_run(
        card, "8bit", raw, OPTION_OPT_STEPS, PER_MICRO_STEP)
    add(launches)
    no_lora_loss = summary["losses"][0]
    still = _unmoved(masters, start)
    require(not still, f"training options 8bit: {len(still)} of "
            f"{len(masters)} trainable masters did not move, e.g. {still[:3]}")
    changed, n_frozen = [], 0
    for model, file in (("unet", UNET_FILE), ("fstext", FSTEXT_FILE)):
        saved = torch.load(os.path.join(summary["checkpoint"], file),
                           map_location="cpu")
        for key, t in saved.items():
            if f"{model}.{key}" in masters:
                continue
            n_frozen += 1
            if not torch.equal(t, start[model][key]):
                changed.append(f"{model}.{key}")
    require(n_frozen > 0 and not changed,
            f"training options 8bit: {len(changed)} of {n_frozen} frozen "
            f"weights changed, e.g. {changed[:3]}")
    bpp = summary["optimizer_state_bytes"] / summary["trainable_params"]
    require(bpp <= STATE_BYTES_PER_PARAM, f"training options 8bit: {bpp:.3f} "
            "bytes of optimizer state per trainable parameter")
    shutil.rmtree(raw["output_dir"], ignore_errors=True)   # DISK_NOTE
    adam8_line = {
        "trainable_params": summary["trainable_params"],
        "masters_moved": len(masters), "frozen_tensors_unchanged": n_frozen,
        "optimizer_state_bytes": summary["optimizer_state_bytes"],
        "optimizer_state_bytes_fp32_adam": phase7["optimizer_state_bytes"],
        "optimizer_state_bytes_per_param": bpp,
        "s_per_optimizer_step": _steady(summary),
        "s_per_optimizer_step_fp32_adam": phase7["s_per_optimizer_step"],
        "peak_mem_gb": peak, "peak_mem_gb_fp32_adam": phase7["peak_mem_gb"],
        "entry_seconds": secs, "launches": launches}

    # (a) LoRA rank 8 on every attention projection, 8-bit AdamW, from the
    # same base
    raw = dict(base, output_dir=os.path.join(tmp, "out_lora"),
               lora_rank=LORA_RANK, lora_targets="attention",
               use_8bit_adam=True)
    summary, masters, launches, secs, peak = _option_run(
        card, "lora", raw, OPTION_OPT_STEPS, PER_MICRO_STEP_LORA)
    add(launches)
    lora_b = {k: t for k, t in masters.items() if k.endswith(".lora_b")}
    fstext = {k: t for k, t in masters.items() if k.startswith("fstext.")}
    require(set(masters) == set(fstext) | {k for k in masters
                                           if k.startswith("lora.")},
            "training options lora: trainable masters outside FSText and "
            "the adapters")
    n_adapter = sum(t.numel() for k, t in masters.items()
                    if k.startswith("lora."))
    bpp = summary["optimizer_state_bytes"] / summary["trainable_params"]
    # the first window's micro-steps both run at B = 0 (no update before
    # the sync step): the no-LoRA run's loss exactly
    same_loss = summary["losses"][0] == no_lora_loss
    require(same_loss, f"training options lora: first loss "
            f"{summary['losses'][0]} != the no-LoRA run's {no_lora_loss}")
    # B starts at zero, so weight decay cannot move it: only a gradient does
    still_b = [k for k, t in lora_b.items() if not bool(t.abs().max() > 0)]
    require(lora_b and not still_b, f"training options lora: {len(still_b)} "
            f"of {len(lora_b)} adapters' B still zero, e.g. {still_b[:3]}")
    still = _unmoved(fstext, start)
    require(fstext and not still, f"training options lora: {len(still)} of "
            f"{len(fstext)} FSText masters did not move, e.g. {still[:3]}")
    require(bpp <= STATE_BYTES_PER_PARAM, f"training options lora: "
            f"{bpp:.3f} bytes of optimizer state per trainable parameter")
    forward = _lora_forward_check(summary["checkpoint"], raw,
                                  lora_scale(LORA_RANK, None))
    lora_ref = {"raw": raw, "losses": summary["losses"],
                "checkpoint": summary["checkpoint"],
                "s_per_optimizer_step": _steady(summary)}
    lora_line = {
        "adapter_params": n_adapter,
        "trainable_params": summary["trainable_params"],
        "optimizer_state_bytes_per_param": bpp,
        "first_loss": summary["losses"][0],
        "first_loss_equals_no_lora": same_loss,
        "adapters_b_moved": len(lora_b), "fstext_masters_moved": len(fstext),
        "s_per_optimizer_step": _steady(summary), "peak_mem_gb": peak,
        "entry_seconds": secs, "launches": launches,
        "launches_per_micro_step": PER_MICRO_STEP_LORA, **forward}
    del start

    # (c) bf16 parameters: the masters are the bf16 parameters
    raw = dict(base, output_dir=os.path.join(tmp, "out_bf16"),
               param_dtype="bfloat16", mixed_precision="bf16",
               compute_dtype="bfloat16", max_train_steps=1, save_steps=1,
               pretrained_model_name_or_path=None, fstext_init_ckpt=None)
    summary, _, launches, secs, peak = _option_run(card, "bf16", raw, 1,
                                                   PER_MICRO_STEP)
    add(launches)
    state = torch.load(os.path.join(summary["checkpoint"], "train_state.pt"),
                       map_location="cpu")
    dtypes = {str(t.dtype) for t in state["masters"].values()}
    moments = {str(t.dtype) for t in state["optimizer"]["mu"].values()}
    require(dtypes == moments == {"torch.bfloat16"}, f"training options "
            f"bf16: masters {dtypes}, moments {moments}")
    shutil.rmtree(raw["output_dir"], ignore_errors=True)   # DISK_NOTE
    bf16_line = {
        "masters_dtype": sorted(dtypes), "moments_dtype": sorted(moments),
        "optimizer_state_bytes": summary["optimizer_state_bytes"],
        "first_loss": summary["losses"][0],
        "first_loss_equals_fp32_params": (summary["losses"][0]
                                          == phase7["losses"][0]),
        "step_seconds": summary["step_seconds"], "peak_mem_gb": peak,
        "peak_mem_gb_fp32_params": phase7["peak_mem_gb"],
        "entry_seconds": secs, "launches": launches}

    # (d) the native frame loader
    native_line = _native_check(phase7["raw"]["data_dir"])
    print(json.dumps({"training_options": {
        "card": card, "optimizer_steps": OPTION_OPT_STEPS,
        "accumulation": TRAIN_ACCUM, "lora": lora_line, "adam8bit": adam8_line,
        "bf16_params": bf16_line, **native_line}}), flush=True)
    return total, lora_ref


def _steady(summary: dict) -> float:
    """Seconds per optimizer step after the first (which carries the
    cuBLAS / cuDNN set-up)."""
    steps = summary["step_seconds"][1:] or summary["step_seconds"]
    return sum(steps) / len(steps)


# ---------------------------------------------------------------- parallel

def _rel_l2(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def _peak_gb() -> float:
    import torch

    return torch.cuda.max_memory_allocated() / 1e9


def _start_run():
    import torch

    from seervideoldm_tpu_torch.parallel import collectives

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    collectives.reset_stats()
    return time.perf_counter()


def _end_run(t0: float) -> dict:
    """Seconds, peak memory, launches and collectives (calls and bytes
    sent, by operation) since ``_start_run``."""
    import torch

    from seervideoldm_tpu_torch.parallel import collectives

    torch.cuda.synchronize()
    # copies of the [calls, bytes] lists: the counters keep counting into
    # them until the next reset
    return {"seconds": time.perf_counter() - t0, "peak_mem_gb": _peak_gb(),
            "launches": read_launches(),
            "collectives": {op: list(v) for op, v in collectives.stats.items()}}


@contextlib.contextmanager
def _saves_apart():
    """Inside, every ``CheckpointManager.save`` is measured on its own: the
    collectives it ran and its peak device memory (``save_peak_gb``); the
    peak of everything else until then (model build, data, the steps) is
    ``step_peak_gb``, to be joined with the peak after the last save."""
    import torch

    from seervideoldm_tpu_torch.io.checkpoint import CheckpointManager
    from seervideoldm_tpu_torch.parallel import collectives

    real_save = CheckpointManager.save
    rec = {"collectives": {}, "save_peak_gb": 0.0, "step_peak_gb": 0.0,
           "saves": 0}

    def save(self, *args, **kwargs):
        torch.cuda.synchronize()
        rec["step_peak_gb"] = max(rec["step_peak_gb"], _peak_gb())
        torch.cuda.reset_peak_memory_stats()
        before = {op: list(v) for op, v in collectives.stats.items()}
        out = real_save(self, *args, **kwargs)
        torch.cuda.synchronize()
        rec["save_peak_gb"] = max(rec["save_peak_gb"], _peak_gb())
        torch.cuda.reset_peak_memory_stats()
        for op, v in collectives.stats.items():
            got = rec["collectives"].setdefault(op, [0, 0])
            for i in (0, 1):
                got[i] += v[i] - before.get(op, [0, 0])[i]
        rec["saves"] += 1
        return out

    CheckpointManager.save = save
    try:
        yield rec
    finally:
        CheckpointManager.save = real_save


def _end_train_run(t0: float, rec: dict) -> dict:
    """``_end_run`` of a train entry run under ``_saves_apart``: the peak
    of the steps (``peak_mem_gb``) and of the saves (``peak_mem_gb_save``)
    apart."""
    row = _end_run(t0)
    row.update(peak_mem_gb=max(row["peak_mem_gb"], rec["step_peak_gb"]),
               peak_mem_gb_save=rec["save_peak_gb"] if rec["saves"] else None,
               saves=rec["saves"])
    return row


def _unet_vs_single(unet, mesh, f: int, cond_frame: int, seed: int) -> dict:
    """One CFG-batch-2 SeerUNet call on this rank's frames under ``mesh``,
    the frames joined, against rank 0's single-rank call on the whole
    input (the mesh cleared meanwhile; the other rank waits)."""
    import torch

    from seervideoldm_tpu_torch.parallel.activation import (
        frame_shard, gather_frames, set_activation_mesh)
    from seervideoldm_tpu_torch.parallel.distributed import barrier_sync, rank

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(2, f, 32, 32, 4, generator=gen, device="cuda").bfloat16()
    ctx = torch.randn(2, f, 77, 768, generator=gen, device="cuda").bfloat16()
    ts = torch.tensor([981, 981], dtype=torch.int32, device="cuda")
    lo, hi = mesh.frame_range(f)
    with torch.no_grad():
        unet(x[:, lo:hi], ts, ctx[:, lo:hi], cond_frame=cond_frame,
             num_frames=f)                              # warm-up
        t0 = _start_run()
        part = unet(x[:, lo:hi], ts, ctx[:, lo:hi], cond_frame=cond_frame,
                    num_frames=f)
        row = {"unet_call": _end_run(t0)}
        launches = row["unet_call"]["launches"]
        got = gather_frames(part, frame_shard(f))
        row["launches"] = launches
        set_activation_mesh(None)
        if rank() == 0:
            unet(x, ts, ctx, cond_frame=cond_frame)     # warm-up
            t0 = time.perf_counter()
            want = unet(x, ts, ctx, cond_frame=cond_frame)
            torch.cuda.synchronize()
            row.update(rel_l2_err=_rel_l2(got, want),
                       single_rank_call_s=time.perf_counter() - t0,
                       finite=bool(torch.isfinite(got).all()))
        barrier_sync()
        set_activation_mesh(mesh)
    return row


def _train_vs_single(cfg, mesh, seed: int) -> dict:
    """One micro-step's loss and gradients under ``mesh`` (this rank's rows
    and frames; reduced over the ranks) against rank 0's single-rank step on
    the same global batch, noise and timesteps.  Every ``proj_out`` gets
    seeded non-zero weights so that the temporal attentions' gradients (K9
    under ``seq``) are not all zero."""
    import torch

    from seervideoldm_tpu_torch.parallel.activation import set_activation_mesh
    from seervideoldm_tpu_torch.parallel.distributed import barrier_sync, rank
    from seervideoldm_tpu_torch.pipelines.loading import (broadcast_weights,
                                                          load_models)
    from seervideoldm_tpu_torch.training.trainer import make_train_step

    models, _ = load_models(cfg, torch.device("cuda", torch.cuda.current_device()),
                            trainable_scope=cfg.trainable_scope, mesh=mesh)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for name, p in models.unet.named_parameters():
            if ".proj_out." in name:
                p.copy_(torch.randn(p.shape, generator=gen, device="cuda")
                        * 0.02)
    broadcast_weights(models)
    f, cond = int(cfg.num_frames), int(cfg.cond_frames)
    n_global = int(cfg.train_batch_size) * mesh.axis_size("data")
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    batch = {"latents_x0": rn(n_global, cond, 32, 32, 4).bfloat16(),
             "latents": rn(n_global, f - cond, 32, 32, 4).bfloat16(),
             "clip_emb": rn(n_global, 77, 768).bfloat16()}
    noise = rn(n_global, f - cond, 32, 32, 4).bfloat16()
    ts = torch.randint(0, 1000, (n_global,), generator=gen, device="cuda")
    step = make_train_step(models, cond_frames=cond, text_loss=True)
    names = list(models.masters)
    rows = mesh.batch_slice(n_global)
    t0 = _start_run()
    loss, _, grads = step.loss_and_grads(
        names, {k: v[rows] for k, v in batch.items()}, noise[rows], ts[rows])
    row = {"micro_step": _end_run(t0), "loss": float(loss)}
    row["launches"] = row["micro_step"]["launches"]
    set_activation_mesh(None)
    if rank() == 0:
        want_loss, _, want = step.loss_and_grads(names, batch, noise, ts)
        num = sum(float((grads[n] - want[n]).pow(2).sum()) for n in names)
        den = sum(float(want[n].pow(2).sum()) for n in names)
        row.update(loss_single=float(want_loss), grad_rel_l2=(num / den) ** 0.5,
                   finite=all(bool(torch.isfinite(g).all())
                              for g in grads.values()))
    barrier_sync()
    del models, grads
    return row


def tp_expected_allreduces(unet, batch: int, frames: int,
                           side: int) -> list:
    """[calls, bytes] of the all-reduces one SeerUNet call makes under a
    ``model`` axis, worked out from the model: one per split unit (each
    attention's ``to_out.0``, each feed-forward's ``net.2``), of its
    site's tokens x channels in fp32.  ``side``: the level-0 latent's
    height and width."""
    levels = len(unet.config.block_out_channels)
    calls = nbytes = 0
    for name, m in unet.named_modules():
        if getattr(m, "tp_group", None) is None:
            continue
        parts = name.split(".")
        level = {"down_blocks": lambda: int(parts[1]),
                 "mid_block": lambda: levels - 1,
                 "up_blocks": lambda: levels - 1 - int(parts[1])}[parts[0]]()
        row = m.to_out[0] if hasattr(m, "to_out") else m.net[2]
        s = side >> level
        calls += 1
        nbytes += 4 * batch * frames * s * s * row.out_features
    return [calls, nbytes]


def _whole_models(cfg, trainable_scope=None):
    """Rank 0's whole models of ``cfg`` on the card, with no mesh: the
    weights every rank starts from before the split."""
    import torch

    from seervideoldm_tpu_torch.parallel.activation import set_activation_mesh
    from seervideoldm_tpu_torch.pipelines.loading import initialize_models

    set_activation_mesh(None)
    return initialize_models(cfg, torch.device("cuda",
                                               torch.cuda.current_device()),
                             trainable_scope)


def _split_bytes(models, splits) -> tuple[int, int]:
    """(bytes of every parameter, bytes of those ``splits`` names) of whole
    models."""
    from seervideoldm_tpu_torch.parallel.sharding import param_bytes

    named = {f"{k}.{n}": p for k, m in zip(("unet", "fstext", "vae", "clip"),
                                           models.modules())
             for n, p in m.named_parameters()}
    return (param_bytes(models),
            sum(named[n].numel() * named[n].element_size() for n in splits))


def _seed_proj_out(unet, seed: int):
    """Every ``proj_out`` of ``unet`` drawn from ``seed`` (zero at random
    init, they would leave every transformer site out of the output); the
    generator, to draw on from."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for name, p in unet.named_parameters():
            if ".proj_out." in name:
                p.copy_(torch.randn(p.shape, generator=gen, device="cuda")
                        * 0.02)
    return gen


def _tp_unet_vs_single(models, cfg, seed: int) -> dict:
    """One CFG-batch-2 SeerUNet call under the registered ``model`` axis
    (its launches, all-reduces against ``tp_expected_allreduces``, this
    rank's parameter bytes) against rank 0's call on the whole weights
    and the same inputs (the other rank waits); every ``proj_out`` seeded
    alike on both sides, so that the split sites reach the output."""
    import torch

    from seervideoldm_tpu_torch.parallel.activation import (
        get_activation_mesh, set_activation_mesh)
    from seervideoldm_tpu_torch.parallel.distributed import barrier_sync, rank
    from seervideoldm_tpu_torch.parallel.sharding import param_bytes

    unet, tp, mesh = models.unet, models.tensor_parallel, get_activation_mesh()
    f, side = int(cfg.num_frames), int(cfg.resolution) // 8
    seq = models.clip.config.max_position_embeddings
    gen = _seed_proj_out(unet, seed)
    x = torch.randn(2, f, side, side, 4, generator=gen,
                    device="cuda").bfloat16()
    ctx = torch.randn(2, f, seq, unet.config.cross_attention_dim,
                      generator=gen, device="cuda").bfloat16()
    ts = torch.tensor([981, 981], dtype=torch.int32, device="cuda")
    row = {"allreduce_expected": tp_expected_allreduces(unet, 2, f, side),
           "param_bytes": param_bytes(models), "split_tensors": len(tp.splits)}
    with torch.no_grad():
        unet(x, ts, ctx, cond_frame=0)                  # warm-up
        t0 = _start_run()
        got = unet(x, ts, ctx, cond_frame=0)
        row["unet_call"] = _end_run(t0)
        row["launches"] = row["unet_call"]["launches"]
        if rank() == 0:
            whole = _whole_models(cfg)
            _seed_proj_out(whole.unet, seed)
            total, split = _split_bytes(whole, tp.splits)
            row.update(param_bytes_whole=total, split_bytes_whole=split,
                       param_bytes_expected=total - split // 2)
            whole.unet(x, ts, ctx, cond_frame=0)        # warm-up
            t0 = time.perf_counter()
            want = whole.unet(x, ts, ctx, cond_frame=0)
            torch.cuda.synchronize()
            row.update(rel_l2_err=_rel_l2(got, want),
                       single_rank_call_s=time.perf_counter() - t0,
                       finite=bool(torch.isfinite(got).all()))
            del whole, want
            torch.cuda.empty_cache()
        set_activation_mesh(mesh)
        barrier_sync()
    return row


def _tp_train_vs_single(cfg, mesh, seed: int) -> dict:
    """``_train_vs_single`` under a ``model`` axis: the split gradients
    joined over the model ranks, rank 0's step on whole models built from
    the same seed (no broadcast after the split: every rank draws the same
    ``proj_out`` weights)."""
    import torch

    from seervideoldm_tpu_torch.parallel.activation import set_activation_mesh
    from seervideoldm_tpu_torch.parallel.distributed import barrier_sync, rank
    from seervideoldm_tpu_torch.pipelines.loading import load_models
    from seervideoldm_tpu_torch.training.trainer import make_train_step

    models, _ = load_models(cfg, torch.device("cuda",
                                              torch.cuda.current_device()),
                            trainable_scope=cfg.trainable_scope, mesh=mesh)
    tp = models.tensor_parallel
    gen = _seed_proj_out(models.unet, seed)
    f, cond = int(cfg.num_frames), int(cfg.cond_frames)
    side = int(cfg.resolution) // 8
    emb = (models.clip.config.max_position_embeddings,
           models.unet.config.cross_attention_dim)
    n_global = int(cfg.train_batch_size) * mesh.axis_size("data")
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    batch = {"latents_x0": rn(n_global, cond, side, side, 4).bfloat16(),
             "latents": rn(n_global, f - cond, side, side, 4).bfloat16(),
             "clip_emb": rn(n_global, *emb).bfloat16()}
    noise = rn(n_global, f - cond, side, side, 4).bfloat16()
    ts = torch.randint(0, 1000, (n_global,), generator=gen, device="cuda")
    step = make_train_step(models, cond_frames=cond, text_loss=True)
    names = list(models.masters)
    rows = mesh.batch_slice(n_global)
    t0 = _start_run()
    loss, _, grads = step.loss_and_grads(
        names, {k: v[rows] for k, v in batch.items()}, noise[rows], ts[rows])
    row = {"micro_step": _end_run(t0), "loss": float(loss)}
    row["launches"] = row["micro_step"]["launches"]
    grads = {n: tp.whole(n, g) for n, g in grads.items()}
    del models, step
    torch.cuda.empty_cache()
    if rank() == 0:
        whole = _whole_models(cfg, cfg.trainable_scope)
        _seed_proj_out(whole.unet, seed)
        want_loss, _, want = make_train_step(
            whole, cond_frames=cond, text_loss=True).loss_and_grads(
                names, batch, noise, ts)
        num = sum(float((grads[n] - want[n]).pow(2).sum()) for n in names)
        den = sum(float(want[n].pow(2).sum()) for n in names)
        row.update(loss_single=float(want_loss), grad_rel_l2=(num / den) ** 0.5,
                   finite=all(bool(torch.isfinite(g).all())
                              for g in grads.values()))
        del whole, want
    set_activation_mesh(mesh)
    barrier_sync()
    del grads
    torch.cuda.empty_cache()
    return row


def _tp_sample_run(out_dir: str) -> dict:
    """Phase 8 (g): ``inference_img``'s pipeline under ``{model: 2}`` at
    (a)'s size, a clip timed, rank 0 writing the GIF; then one UNet call
    against the whole weights."""
    import dataclasses

    import numpy as np
    import torch

    from seervideoldm_tpu_torch.inference_img import (build_pipeline,
                                                      generate_video)
    from seervideoldm_tpu_torch.parallel.distributed import is_main_process
    from seervideoldm_tpu_torch.utils.viz import save_visualization_onegif

    t0 = _start_run()
    pipe, tok, cfg = build_pipeline(dict(
        resolution=256, cond_frames=2, num_frames=12, ddim_steps=PAR_DDIM_STEPS,
        scale=7.5, seed=SEED, mixed_precision="bf16",
        compute_dtype="bfloat16", mesh_shape={"model": 2},
        output_dir=os.path.join(out_dir, "sample_model2")))
    image = np.random.RandomState(SEED).randint(0, 256, (256, 256, 3),
                                                dtype=np.uint8)
    build_s = time.perf_counter() - t0
    generate_video(pipe, tok, dataclasses.replace(cfg, ddim_steps=1), image,
                   "push the green cup to the left")
    t0 = _start_run()
    samples, cond = generate_video(pipe, tok, cfg, image,
                                   "push the green cup to the left")
    row = _end_run(t0)
    gif = None
    if is_main_process():
        gif = save_visualization_onegif(samples.cpu().numpy(),
                                        ((cond + 1.0) / 2.0).numpy(),
                                        cfg.output_dir, 0)
    row.update(build_seconds=build_s, frames=list(samples.shape),
               finite=bool(torch.isfinite(samples).all()),
               in_range=bool(samples.min() >= 0 and samples.max() <= 1),
               gif_written=gif is not None and os.path.exists(gif),
               unet_calls=len(pipe.schedule.ddim_tables(
                   PAR_DDIM_STEPS).timesteps),
               unet_check=_tp_unet_vs_single(pipe.m, cfg, SEED + 6))
    del pipe
    return row


def _tp_train_run(raw: dict, replicated: dict, out_dir: str) -> dict:
    """Phase 8 (h): the ``train`` entry with (c)'s config and seed under
    ``{model: 2}``; its steps, the master and parameter bytes this rank
    holds, the collectives per micro-step (the save's apart), the
    checkpoint's keys and shapes against (c)'s (rank 0 reads both), then
    one micro-step against a single rank's."""
    import torch

    from seervideoldm_tpu_torch.config import config_from_dict
    from seervideoldm_tpu_torch.parallel.distributed import (barrier_sync,
                                                             is_main_process)
    from seervideoldm_tpu_torch.parallel.mesh import create_mesh
    from seervideoldm_tpu_torch.train import train

    split = dict(raw, output_dir=os.path.join(out_dir, "train_model2"),
                 mesh_shape={"model": 2})
    t0 = _start_run()
    with _saves_apart() as rec:
        summary = train(config_from_dict(dict(split)))
    row = _end_train_run(t0, rec)
    micro = summary["micro_steps"]
    in_saves = {op: rec["collectives"].get(op, [0, 0])
                for op in row["collectives"]}
    row.update(
        global_step=summary["global_step"], losses=summary["losses"],
        step_seconds=summary["step_seconds"],
        step_seconds_replicated=replicated["step_seconds"],
        master_bytes=summary["master_bytes"],
        master_bytes_replicated=replicated["master_bytes"],
        param_bytes=summary["param_bytes"],
        param_bytes_replicated=replicated["param_bytes"],
        state_bytes=summary["state_bytes"],
        collectives_per_micro_step={
            op: [(v[0] - in_saves[op][0]) / micro,
                 (v[1] - in_saves[op][1]) / micro]
            for op, v in row["collectives"].items()},
        collectives_checkpoint=in_saves,
        checkpoint_written=os.path.isdir(summary["checkpoint"]))
    if is_main_process():
        got = _layout(summary["checkpoint"])
        row["checkpoint_layout_equal"] = got == replicated["layout"]
        row["checkpoint_tensors"] = sum(len(v) for v in got.values())
    barrier_sync()
    torch.cuda.empty_cache()
    row["step_check"] = _tp_train_vs_single(config_from_dict(dict(split)),
                                            create_mesh({"model": 2}),
                                            SEED + 5)
    return row


def parallel_rank(rank: int, data_dir: str, out_dir: str,
                  lora_ref: dict) -> dict:
    """The seven 2-rank runs of the parallel phase on one rank (started by
    ``parallel.launch``); returns each run's numbers from this rank."""
    import dataclasses

    import numpy as np
    import torch

    from seervideoldm_tpu_torch.config import config_from_dict
    from seervideoldm_tpu_torch.inference_img import (build_pipeline,
                                                      generate_video)
    from seervideoldm_tpu_torch.parallel.distributed import is_main_process
    from seervideoldm_tpu_torch.parallel.mesh import create_mesh
    from seervideoldm_tpu_torch.train import train
    from seervideoldm_tpu_torch.utils.viz import save_visualization_onegif

    runs = {}
    # (d) then (c), the train entry, then the step check (its checkpoint
    # goes at once: (h) needs only its keys and shapes)
    for name, mesh_shape, frames in (("train_seq2_f11_k6", {"seq": 2}, 11),
                                     ("train_data2", {"data": 2}, 12)):
        raw = parallel_train_raw(os.path.join(out_dir, name), data_dir,
                                 mesh_shape, frames)
        t0 = _start_run()
        with _saves_apart() as rec:
            summary = train(config_from_dict(dict(raw)))
        row = _end_train_run(t0, rec)
        row.update(global_step=summary["global_step"],
                   losses=summary["losses"],
                   step_seconds=summary["step_seconds"],
                   checkpoint_written=os.path.isdir(summary["checkpoint"]))
        cfg = config_from_dict(dict(raw))
        row["step_check"] = _train_vs_single(cfg, create_mesh(mesh_shape),
                                             SEED + 5)
        runs[name] = row
        if name == "train_data2":
            # (h) holds its checkpoint's keys and shapes against these
            summary = dict(summary, layout=(_layout(summary["checkpoint"])
                                            if is_main_process() else None))
            replicated = (raw, summary)
        _drop_run(raw["output_dir"])
        torch.cuda.empty_cache()
    # (a) sampling under {seq: 2}, 12 frames: the ring
    t0 = _start_run()
    pipe, tok, cfg = build_pipeline(dict(
        resolution=256, cond_frames=2, num_frames=12, ddim_steps=PAR_DDIM_STEPS,
        scale=7.5, seed=SEED, mixed_precision="bf16",
        compute_dtype="bfloat16", mesh_shape={"seq": 2},
        output_dir=os.path.join(out_dir, "sample")))
    image = np.random.RandomState(SEED).randint(0, 256, (256, 256, 3),
                                                dtype=np.uint8)
    build_s = time.perf_counter() - t0
    generate_video(pipe, tok, dataclasses.replace(cfg, ddim_steps=1), image,
                   "push the green cup to the left")
    t0 = _start_run()
    samples, cond = generate_video(pipe, tok, cfg, image,
                                   "push the green cup to the left")
    row = _end_run(t0)
    gif = None
    if is_main_process():
        gif = save_visualization_onegif(samples.cpu().numpy(),
                                        ((cond + 1.0) / 2.0).numpy(),
                                        cfg.output_dir, 0)
    mesh = create_mesh({"seq": 2})
    row.update(build_seconds=build_s, frames=list(samples.shape),
               finite=bool(torch.isfinite(samples).all()),
               in_range=bool(samples.min() >= 0 and samples.max() <= 1),
               gif_written=gif is not None and os.path.exists(gif),
               unet_check=_unet_vs_single(pipe.m.unet, mesh, 12, 0,
                                                   SEED + 3))
    runs["sample_seq2_ring"] = row
    # (b) one UNet call under {seq: 2} at 11 frames, cond 2: K6
    row = _unet_vs_single(pipe.m.unet, mesh, 11, 2, SEED + 4)
    row.update(peak_mem_gb=row["unet_call"]["peak_mem_gb"])
    runs["unet_seq2_f11_k6"] = row
    del pipe
    torch.cuda.empty_cache()
    # (g), (h) the 'model' axis: sampling, then (c)'s training
    runs["sample_model2"] = _tp_sample_run(out_dir)
    torch.cuda.empty_cache()
    runs["train_model2"] = _tp_train_run(*replicated, out_dir)
    _drop_run(os.path.join(out_dir, "train_model2"))
    torch.cuda.empty_cache()
    # (l) LoRA + 8-bit under {model: 2} against 7b's (a) on one rank
    runs["train_model2_lora_8bit"] = _tp_lora_run(lora_ref, out_dir)
    _drop_run(os.path.join(out_dir, "train_model2_lora_8bit"))
    torch.cuda.empty_cache()
    return runs


def parallel_train_raw(out_dir: str, data_dir: str, mesh_shape: dict,
                       frames: int = 12, accum: int = 1,
                       steps: int = PAR_OPT_STEPS) -> dict:
    """Phase 8 (c)'s ``train`` config under ``mesh_shape``."""
    return dict(
        output_dir=out_dir, data_dir=data_dir, dataset="sthv2",
        resolution=256, num_frames=frames, cond_frames=2, train_batch_size=1,
        gradient_accumulation_steps=accum, learning_rate=1.28e-5,
        scale_lr=True, lr_scheduler="cosine", lr_warmup_steps=0,
        max_train_steps=steps, save_steps=steps, max_grad_norm=0.3,
        num_workers=2, seed=SEED, mixed_precision="bf16",
        compute_dtype="bfloat16", text_loss=True, mesh_shape=mesh_shape)


def _drop_run(out_dir: str) -> None:
    """Rank 0 deletes a finished run's output directory, once every rank
    is past it (DISK_NOTE)."""
    from seervideoldm_tpu_torch.parallel.distributed import (barrier_sync,
                                                             is_main_process)

    barrier_sync()
    if is_main_process():
        shutil.rmtree(out_dir, ignore_errors=True)
    barrier_sync()


def _per_micro(row: dict, micro: int) -> dict:
    """The run's launches and collectives (calls; bytes) per micro-step,
    the checkpoint's collectives apart."""
    in_saves = {op: row.get("collectives_checkpoint", {}).get(op, [0, 0])
                for op in row["collectives"]}
    return {"launches_per_micro_step": {k: v / micro for k, v in
                                        row["launches"].items()},
            "collectives_per_micro_step": {
                op: [(v[0] - in_saves[op][0]) / micro,
                     (v[1] - in_saves[op][1]) / micro]
                for op, v in row["collectives"].items()}}


def _layout(path: str) -> dict:
    """The keys and shapes of a checkpoint's weight files and train state
    (8-bit moments as their codes' shapes)."""
    import torch

    from seervideoldm_tpu_torch.io.checkpoint import (FSTEXT_FILE, STATE_FILE,
                                                      UNET_FILE)

    out = {}
    for fname in (UNET_FILE, FSTEXT_FILE):
        sd = torch.load(os.path.join(path, fname), map_location="cpu",
                        mmap=True)
        out[fname] = {k: tuple(v.shape) for k, v in sd.items()}
    state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                       mmap=True)
    for key in ("masters", "ema"):
        out[key] = {k: tuple(v.shape) for k, v in (state[key] or {}).items()}
    for key in ("mu", "nu"):
        out[key] = {k: tuple((v["codes"] if isinstance(v, dict) else v).shape)
                    for k, v in state["optimizer"][key].items()}
    return out


def _masters_of(path: str) -> dict:
    import torch

    from seervideoldm_tpu_torch.io.checkpoint import STATE_FILE

    # mapped: only the masters are read
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      mmap=True)["masters"]


def _masters_rel_l2(got: dict, want: dict) -> float:
    import torch

    names = sorted(want)
    return _rel_l2(torch.cat([got[n].float().reshape(-1) for n in names]),
                   torch.cat([want[n].float().reshape(-1) for n in names]))


def _tp_train_entry(name: str, raw: dict) -> tuple:
    """One ``train`` entry run of phase 8 (i)-(l) on this rank: the peak of
    its steps and of its save apart; returns (its row, its summary)."""
    import torch

    from seervideoldm_tpu_torch.config import config_from_dict
    from seervideoldm_tpu_torch.train import train

    t0 = _start_run()
    with _saves_apart() as rec:
        summary = train(config_from_dict(dict(raw)))
    row = _end_train_run(t0, rec)
    row["collectives_checkpoint"] = {op: rec["collectives"].get(op, [0, 0])
                                     for op in row["collectives"]}
    row.update(_per_micro(row, summary["micro_steps"]))
    row.update(
        sharding=summary["sharding"], global_step=summary["global_step"],
        micro_steps=summary["micro_steps"], losses=summary["losses"],
        step_seconds=summary["step_seconds"],
        s_per_optimizer_step=_steady(summary),
        param_bytes=summary["param_bytes"],
        master_bytes=summary["master_bytes"],
        state_bytes=summary["state_bytes"],
        optimizer_state_bytes=summary["optimizer_state_bytes"],
        trainable_params_rank=summary["trainable_params"],
        largest_unit_bytes=summary["largest_unit_bytes"],
        checkpoint_written=os.path.isdir(summary["checkpoint"]))
    torch.cuda.empty_cache()
    return row, summary


def _tp_lora_run(lora_ref: dict, out_dir: str) -> dict:
    """Phase 8 (l): 7b's (a) (LoRA rank 8 + 8-bit AdamW from the seeded
    base, phase 7's tree) under ``{model: 2}``, against (a) on one rank."""
    from seervideoldm_tpu_torch.parallel.distributed import (barrier_sync,
                                                             is_main_process)

    raw = dict(lora_ref["raw"], mesh_shape={"model": 2},
               output_dir=os.path.join(out_dir, "train_model2_lora_8bit"))
    row, summary = _tp_train_entry("train_model2_lora_8bit", raw)
    row.update(losses_ref=lora_ref["losses"],
               s_per_optimizer_step_ref=lora_ref["s_per_optimizer_step"],
               optimizer_state_bytes_per_param=(
                   summary["optimizer_state_bytes"]
                   / summary["trainable_params"]))
    if is_main_process():
        got, want = (_masters_of(summary["checkpoint"]),
                     _masters_of(lora_ref["checkpoint"]))
        b_still = [k for k, t in got.items()
                   if k.endswith(".lora_b") and not bool(t.abs().max() > 0)]
        row.update(
            masters_equal_keys=set(got) == set(want),
            masters_rel_l2=(_masters_rel_l2(got, want) if set(got) == set(want)
                            else float("inf")),
            adapters_b=sum(k.endswith(".lora_b") for k in got),
            adapters_b_still_zero=len(b_still),
            checkpoint_layout_equal=(_layout(summary["checkpoint"])
                                     == _layout(lora_ref["checkpoint"])))
    barrier_sync()
    return row


def _restore_on_one_rank(raw: dict, path: str, step: int,
                         held: dict) -> dict:
    """Rank 0 alone, no mesh: the whole models of ``raw`` for training
    (built once into ``held`` and restored into again), its optimizer, and
    ``path``'s checkpoint of ``step`` restored into them; the restored
    masters and moments against the file's."""
    import torch

    from seervideoldm_tpu_torch.config import config_from_dict
    from seervideoldm_tpu_torch.io.checkpoint import (STATE_FILE,
                                                      CheckpointManager)
    from seervideoldm_tpu_torch.training.optim import build_optimizer
    from seervideoldm_tpu_torch.training.trainer import (TrainState,
                                                         trainable_masters)

    cfg = config_from_dict(dict(raw, mesh_shape=None, zero1=False,
                                fsdp=False))
    if "models" not in held:
        held["models"] = _whole_models(cfg, cfg.trainable_scope)
        trainable_masters(held["models"])
    models = held["models"]
    opt, _ = build_optimizer(models.masters, 1e-5,
                             use_8bit=bool(cfg.use_8bit_adam),
                             accumulation_steps=int(
                                 cfg.gradient_accumulation_steps))
    state = TrainState.create(opt, ema=float(cfg.ema_decay) > 0.0)
    t0 = time.perf_counter()
    CheckpointManager(os.path.dirname(path)).restore(step, state, models)
    seconds = time.perf_counter() - t0
    saved = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                       mmap=True)
    masters_equal = all(torch.equal(t.cpu(), saved["masters"][n])
                        for n, t in state.masters.items())
    mine = opt.state_dict()

    def same(a, b):
        if isinstance(b, dict):
            return all(same(a[k], b[k]) for k in b)
        return torch.equal(a.cpu(), b)

    moments_equal = all(same(mine[k][n], saved["optimizer"][k][n])
                        for k in ("mu", "nu") for n in saved["optimizer"][k])
    named = models.named_trainable()
    synced = all(torch.equal(named[n], t.to(named[n].dtype))
                 for n, t in state.masters.items())
    return {"tensors": len(state.masters), "masters_equal": masters_equal,
            "moments_equal": moments_equal, "modules_synced": synced,
            "count": opt.count, "seconds": seconds}


def parallel_rank4(rank: int, data_dir: str, out_dir: str) -> dict:
    """Phase 8 (i)-(k) on one of 4 ranks, ``{data: 2, model: 2}``;
    returns each run's numbers from this rank."""
    from seervideoldm_tpu_torch.parallel.distributed import is_main_process
    from seervideoldm_tpu_torch.training.optim import lr_schedule

    mesh = {"data": 2, "model": 2}
    raw = parallel_train_raw(os.path.join(out_dir, "train_d2m2"), data_dir,
                             mesh, frames=PAR4_FRAMES, accum=PAR4_ACCUM,
                             steps=TP_STRATEGY_OPT_STEPS)
    runs, held = {}, {}
    runs["train_d2m2"], ref = _tp_train_entry("train_d2m2", raw)
    ref_masters = _masters_of(ref["checkpoint"]) if is_main_process() else None
    lr = raw["learning_rate"] * PAR4_ACCUM * 2   # scale_lr: x accum x D
    lr_2 = lr_schedule("cosine", lr, raw["lr_warmup_steps"],
                       TP_STRATEGY_OPT_STEPS)(TP_STRATEGY_OPT_STEPS - 1)
    for name, flags in (("train_d2m2_zero1_8bit",
                         dict(zero1=True, use_8bit_adam=True)),
                        ("train_d2m2_fsdp", dict(fsdp=True))):
        run_raw = dict(raw, output_dir=os.path.join(out_dir, name), **flags)
        row, summary = _tp_train_entry(name, run_raw)
        row.update(losses_ref=ref["losses"],
                   state_bytes_ref=ref["state_bytes"],
                   param_bytes_ref=ref["param_bytes"],
                   s_per_optimizer_step_ref=_steady(ref))
        if is_main_process():
            got = _masters_of(summary["checkpoint"])
            row["masters_rel_l2"] = _masters_rel_l2(got, ref_masters)
            norm = math.sqrt(sum(float(t.float().pow(2).sum())
                                 for t in ref_masters.values()))
            n = sum(t.numel() for t in ref_masters.values())
            row["masters_rel_l2_bound"] = (
                TP_8BIT_STEP_FACTOR * lr_2 * math.sqrt(n) / norm
                if flags.get("use_8bit_adam") else SHARD_MASTERS_RTOL)
            row["restore_one_rank"] = _restore_on_one_rank(
                run_raw, summary["checkpoint"], summary["global_step"], held)
        _drop_run(run_raw["output_dir"])
        runs[name] = row
    held.clear()
    _drop_run(raw["output_dir"])
    return runs


def phase_parallel(card: str, lora_ref: dict) -> dict:
    """The parallel phase (see the module docstring).  Returns the launch
    counts of the parallel path, summed over its runs (rank 0's)."""
    import torch

    from seervideoldm_tpu_torch.parallel import launch
    from seervideoldm_tpu_torch.parallel.distributed import pick_backend

    cards = torch.cuda.device_count()
    transport = pick_backend("cuda", PAR_RANKS)
    print(json.dumps({"parallel": {
        "ranks": PAR_RANKS, "cards": cards, "transport": transport,
        "note": ("one card per rank" if transport == "nccl" else
                 "ranks share one card; collectives staged through pinned "
                 "host memory; times are not a parallel speed-up")}}),
          flush=True)
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    try:
        write_synthetic_sthv2(os.path.join(tmp, "data"), clips=4, frames=14,
                              res=256)
        t0 = time.perf_counter()
        results = launch.run(parallel_rank, PAR_RANKS,
                             args=(os.path.join(tmp, "data"),
                                   os.path.join(tmp, "out"), lora_ref),
                             backend=transport, timeout=PAR_TIMEOUT,
                             threads=max(1, HOST_CORES // PAR_RANKS))
        wall = time.perf_counter() - t0
        torch.cuda.empty_cache()
        transport4 = pick_backend("cuda", PAR4_RANKS)
        t0 = time.perf_counter()
        results4 = launch.run(parallel_rank4, PAR4_RANKS,
                              args=(os.path.join(tmp, "data"),
                                    os.path.join(tmp, "out")),
                              backend=transport4, timeout=PAR4_TIMEOUT,
                              threads=max(1, HOST_CORES // PAR4_RANKS))
        wall4 = time.perf_counter() - t0
    except RuntimeError as e:
        raise SmokeFailure(f"parallel: {e}") from e
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    main = results[0]
    total = {name: 0 for name in wrappers()}
    per_rank_keys = ("launches", "peak_mem_gb", "peak_mem_gb_save",
                     "param_bytes", "master_bytes", "state_bytes")
    for ranks, way, group in ((PAR_RANKS, transport, results),
                              (PAR4_RANKS, transport4, results4)):
        for name, row in group[0].items():
            per_rank = [r[name] for r in group]
            print(json.dumps({"parallel_run": {
                "run": name, "card": card, "transport": way,
                "ranks": ranks, **{k: v for k, v in row.items()
                                   if k not in per_rank_keys},
                **{f"{k}_per_rank": [r[k] for r in per_rank]
                   for k in per_rank_keys if k in row}}}), flush=True)
            for k, n in row["launches"].items():
                total[k] += n
    print(json.dumps({"parallel_phase": {"seconds": wall,
                                         "seconds_4_ranks": wall4}}),
          flush=True)
    _check_tp_lora(main["train_model2_lora_8bit"],
                   [r["train_model2_lora_8bit"] for r in results])
    _check_tp_strategies(results4)

    a = main["sample_seq2_ring"]
    require(a["frames"] == [1, 10, 256, 256, 3] and a["finite"]
            and a["in_range"] and a["gif_written"],
            f"parallel (a): frames {a['frames']}, GIF {a['gif_written']}")
    require(a["unet_check"]["rel_l2_err"] <= PAR_UNET_RTOL,
            f"parallel (a): UNet relative L2 {a['unet_check']['rel_l2_err']}")
    require(a["launches"]["swat_attention"] == 0
            and a["launches"]["swat_attention_tables"] == 0,
            "parallel (a): the ring branch ran a SWAT kernel")
    b = main["unet_seq2_f11_k6"]
    require(b["rel_l2_err"] <= PAR_UNET_RTOL and b["finite"],
            f"parallel (b): UNet relative L2 {b['rel_l2_err']}")
    require(b["launches"]["swat_attention"] > 0,
            "parallel (b): K6 was not launched")
    _check_tensor_parallel(main, results)
    for name, kernels in (("train_data2", ("swat_attention_tables",
                                           "swat_attention_tables_bwd")),
                          ("train_seq2_f11_k6", ("swat_attention",
                                                 "swat_attention_bwd"))):
        row = main[name]
        check = row["step_check"]
        require(row["global_step"] == PAR_OPT_STEPS
                and row["checkpoint_written"],
                f"parallel {name}: {row['global_step']} optimizer steps")
        require(row["losses"] and all(map(math.isfinite, row["losses"])),
                f"parallel {name}: losses {row['losses']}")
        require(abs(check["loss"] - check["loss_single"])
                <= PAR_LOSS_RTOL * abs(check["loss_single"]),
                f"parallel {name}: loss {check['loss']} vs single-rank "
                f"{check['loss_single']}")
        require(check["grad_rel_l2"] <= TRAIN_REF_RTOL and check["finite"],
                f"parallel {name}: gradient relative L2 "
                f"{check['grad_rel_l2']}")
        for k in kernels:
            require(row["launches"][k] > 0,
                    f"parallel {name}: {k} was not launched")
    return total


def _tp_kernels_launched(what: str, row: dict) -> None:
    """K1, K2, K7, K8 launched and K3-K5 not on a rank's run under a
    ``model`` axis."""
    for k in TP_TRAINING_KERNELS:
        require(row["launches"][k] > 0, f"parallel {what}: {k} was not "
                "launched")
    for k in TP_NOT_LAUNCHED:
        require(row["launches"][k] == 0,
                f"parallel {what}: {k} launched under 'model'")


def _check_tp_run(what: str, row: dict) -> None:
    require(row["global_step"] == len(row["losses"]) > 0
            and row["checkpoint_written"]
            and all(map(math.isfinite, row["losses"])),
            f"parallel {what}: {row['global_step']} steps, losses "
            f"{row['losses']}")


def _check_tp_lora(row: dict, per_rank: list) -> None:
    """Phase 8 (l) against 7b's (a) on one rank."""
    _check_tp_run("(l)", row)
    got, want = row["losses"], row["losses_ref"]
    require(len(got) == len(want) and all(
        abs(a - b) <= PAR_LOSS_RTOL * abs(b) for a, b in zip(got, want)),
        f"parallel (l): losses {got} vs one rank's {want}")
    require(row["masters_equal_keys"] and row["checkpoint_layout_equal"],
            "parallel (l): the checkpoint's keys or shapes differ from (a)'s")
    require(row["masters_rel_l2"] <= TRAIN_REF_RTOL,
            f"parallel (l): masters relative L2 {row['masters_rel_l2']}")
    require(row["adapters_b"] > 0 and row["adapters_b_still_zero"] == 0,
            f"parallel (l): {row['adapters_b_still_zero']} of "
            f"{row['adapters_b']} adapters' B still zero")
    for r in per_rank:
        require(r["optimizer_state_bytes_per_param"] <= STATE_BYTES_PER_PARAM,
                f"parallel (l): {r['optimizer_state_bytes_per_param']:.3f} "
                "bytes of optimizer state per trainable parameter a rank")
        _tp_kernels_launched("(l)", r)


def _check_tp_strategies(results4: list) -> None:
    """Phase 8 (i)-(k): (j) and (k) against (i), each rank's bytes, the
    one-rank restores, the kernels."""
    main = results4[0]
    _check_tp_run("(i)", main["train_d2m2"])
    for name, what in (("train_d2m2_zero1_8bit", "(j)"),
                       ("train_d2m2_fsdp", "(k)")):
        row = main[name]
        _check_tp_run(what, row)
        require(row["sharding"] == ("zero1" if what == "(j)" else "fsdp"),
                f"parallel {what}: sharding {row['sharding']}")
        got, want = row["losses"], row["losses_ref"]
        require(len(got) == len(want) and all(
            abs(a - b) <= SHARD_LOSS_RTOL * abs(b) for a, b in zip(got, want)),
            f"parallel {what}: losses {got} vs (i)'s {want}")
        require(row["masters_rel_l2"] <= row["masters_rel_l2_bound"],
                f"parallel {what}: masters relative L2 "
                f"{row['masters_rel_l2']} > {row['masters_rel_l2_bound']}")
        back = row["restore_one_rank"]
        require(back["masters_equal"] and back["moments_equal"]
                and back["modules_synced"]
                and back["count"] == row["global_step"],
                f"parallel {what}: the one-rank restore {back}")
    for r in results4:
        for name in ("train_d2m2", "train_d2m2_zero1_8bit",
                     "train_d2m2_fsdp"):
            _tp_kernels_launched(name, r[name])
        j, k = r["train_d2m2_zero1_8bit"], r["train_d2m2_fsdp"]
        require(j["state_bytes"] <= 0.5 * j["state_bytes_ref"] * 1.01,
                f"parallel (j): state {j['state_bytes']} B a rank vs (i)'s "
                f"{j['state_bytes_ref']}")
        require(k["param_bytes"] <= 0.5 * k["param_bytes_ref"]
                + k["largest_unit_bytes"],
                f"parallel (k): parameters {k['param_bytes']} B a rank vs "
                f"(i)'s {k['param_bytes_ref']}")


def _check_tensor_parallel(main: dict, results: list) -> None:
    """Phase 8 (g) / (h), ``{model: 2}``, against a single rank and (c)."""
    g = main["sample_model2"]
    check = g["unet_check"]
    require(g["frames"] == [1, 10, 256, 256, 3] and g["finite"]
            and g["in_range"] and g["gif_written"],
            f"parallel (g): frames {g['frames']}, GIF {g['gif_written']}")
    require(check["rel_l2_err"] <= PAR_UNET_RTOL and check["finite"],
            f"parallel (g): UNet relative L2 {check['rel_l2_err']}")
    want_bytes = check["param_bytes_expected"]
    for r in results:
        rc = r["sample_model2"]["unet_check"]
        clip = r["sample_model2"]["launches"]
        for k in TP_SAMPLING_KERNELS:
            require(rc["launches"][k] == PER_STEP[k]
                    and clip[k] == PER_STEP[k] * g["unet_calls"],
                    f"parallel (g): {k} launched {rc['launches'][k]} times "
                    f"a UNet call ({clip[k]} a clip of {g['unet_calls']} "
                    f"calls), a single rank {PER_STEP[k]}")
        for k in TP_NOT_LAUNCHED:
            require(r["sample_model2"]["launches"][k] == 0,
                    f"parallel (g): {k} launched under 'model'")
        calls = rc["unet_call"]["collectives"].get("all_reduce", [0, 0])
        require(calls == rc["allreduce_expected"],
                f"parallel (g): all-reduces {calls} a UNet call, the model "
                f"gives {rc['allreduce_expected']}")
        require(abs(rc["param_bytes"] - want_bytes)
                <= TP_BYTES_RTOL * want_bytes,
                f"parallel (g): {rc['param_bytes']} parameter bytes a rank, "
                f"replicated + split / 2 = {want_bytes}")
    h = main["train_model2"]
    step = h["step_check"]
    require(h["global_step"] == PAR_OPT_STEPS and h["checkpoint_written"]
            and h["losses"] and all(map(math.isfinite, h["losses"])),
            f"parallel (h): {h['global_step']} steps, losses {h['losses']}")
    require(h["checkpoint_layout_equal"],
            "parallel (h): the checkpoint's keys or shapes differ from (c)'s")
    require(abs(step["loss"] - step["loss_single"])
            <= PAR_LOSS_RTOL * abs(step["loss_single"]),
            f"parallel (h): loss {step['loss']} vs single-rank "
            f"{step['loss_single']}")
    require(step["grad_rel_l2"] <= TRAIN_REF_RTOL and step["finite"],
            f"parallel (h): gradient relative L2 {step['grad_rel_l2']}")
    for r in results:
        row = r["train_model2"]
        for k in TP_TRAINING_KERNELS:
            require(row["launches"][k] > 0,
                    f"parallel (h): {k} was not launched")
        for k in TP_NOT_LAUNCHED:
            require(row["launches"][k] == 0,
                    f"parallel (h): {k} launched under 'model'")
        require(row["master_bytes"] < row["master_bytes_replicated"],
                f"parallel (h): {row['master_bytes']} master bytes a rank, "
                f"not below (c)'s {row['master_bytes_replicated']}")


# ------------------------------------------------------------ floor budget

@functools.lru_cache(maxsize=None)
def _max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def k10_ex2_rate() -> float:
    """ex2 results per second of the whole card: SMs x 16 per clock x the
    maximum SM clock nvidia-smi reports."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * MUFU_EX2_PER_CLK_PER_SM * _max_sm_clock_hz()


def check_k10() -> dict:
    """K10 against its plain version at the TPU's (256, 2048) and at the
    calibration shape, reps K10_CHECK_REPS: the final s element by element
    and the row sums (of the rows' sum of |s|) within K10_RTOL; then its
    time, bound, plain and library numbers at the calibration shape after
    K10_REPS passes.  The library yardstick is one ``torch.softmax`` pass
    over the same array (it goes through HBM)."""
    import torch

    from seervideoldm_tpu_torch.ops.kernels import softmax_calib as K

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = K.calibration_rows("cuda")
    worst_rel, worst_abs, failures = 0.0, 0.0, []
    for n in (256, rows):
        x = torch.randn(n, K.CALIB_COLS, generator=gen,
                        device="cuda") * K10_CHECK_SCALE
        for reps in K10_CHECK_REPS:
            got, got_s = K.softmax_calib(x, reps, return_s=True)
            want, want_s = K.softmax_calib_plain(x, reps, return_s=True)
            torch.cuda.synchronize()
            err_s, err_sum = (got_s - want_s).abs(), (got - want).abs()
            scale_sum = want_s.abs().sum(1, keepdim=True)
            ok = (bool(torch.isfinite(got_s).all())
                  and bool((err_s <= K10_RTOL * want_s.abs()).all())
                  and bool((err_sum <= K10_RTOL * scale_sum).all()))
            tiny = torch.finfo(torch.float32).tiny
            rel_s = float((err_s / want_s.abs().clamp_min(tiny)).max())
            rel_sum = float((err_sum / scale_sum.clamp_min(tiny)).max())
            worst_rel = max(worst_rel, rel_s, rel_sum)
            worst_abs = max(worst_abs, float(err_s.max()),
                            float(err_sum.max()))
            if not ok:
                failures.append(f"({n}, {K.CALIB_COLS}) reps {reps}: max "
                                f"relative error s {rel_s}, sums {rel_sum}")
    x = torch.randn(rows, K.CALIB_COLS, generator=gen, device="cuda")
    elems = x.numel()
    t_ops = K10_REPS * elems / k10_ex2_rate()
    t_bytes = (elems + rows) * 4 / PEAK_BYTES
    row = dict(name="softmax_calib", path="floor_budget",
               shape=f"({rows}, {K.CALIB_COLS}) fp32, {K10_REPS} passes",
               max_abs_err=worst_abs, max_rel_err=worst_rel,
               tol=f"{K10_RTOL} relative on the final s and on the row "
                   "sums (of the rows' sum of |s|)", ok=not failures,
               ms=time_ms(lambda: K.softmax_calib(x, K10_REPS)),
               plain_ms=time_ms(lambda: K.softmax_calib_plain(x, K10_REPS),
                                iters=3, warmup=1),
               library_ms=time_ms(lambda: torch.softmax(x, dim=1)),
               library_note="one torch.softmax pass over the array (HBM in "
                            "and out), not K10_REPS passes",
               bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               bound_note="one MUFU ex2 per element per pass at "
                          f"{MUFU_EX2_PER_CLK_PER_SM} per clock per SM, the "
                          "maximum SM clock")
    print(json.dumps({"kernel_check": row}), flush=True)
    require(not failures, "K10 disagrees with its plain version: "
            + "; ".join(failures))
    return row


def _positive_times(where: str, values: dict) -> None:
    bad = {k: v for k, v in values.items()
           if v is None or not math.isfinite(v) or v <= 0.0}
    require(not bad, f"{where}: measured times not finite and positive: {bad}")


def phase_floor_budget(card: str) -> tuple[dict, dict]:
    """K10 checked and timed; both budget entries driven at their defaults
    through ``main(argv)`` with the launch counts zeroed just before and
    read just after each; the checks on what they measured.  Returns (the
    K10 row, the launches of this path)."""
    import torch

    from seervideoldm_tpu_torch.ops.kernels.softmax_calib import \
        calibration_rows
    from seervideoldm_tpu_torch.tools import floor_budget, floor_budget_train

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    k10 = check_k10()
    reset_launches()
    fb = floor_budget.main(["--json"])
    launches = read_launches()
    torch.cuda.empty_cache()
    reset_launches()
    fbt = floor_budget_train.main(["--json"])
    for name, n in read_launches().items():
        launches[name] += n
    torch.cuda.empty_cache()

    times = {"step_ms": fb["step_ms"], "step_kernel_ms": fb["step_kernel_ms"]}
    for r in fb["rows"] + [fb["l3"]]:
        times.update({f"{r['level']} {k}": v for k, v in r.items()
                      if k.endswith("_ms") and "floor" not in k
                      and not k.endswith("_sm_ms")})
    _positive_times("floor_budget", times)
    times = {f"b={b}": v for b, v in fbt["step_ms_by_batch"].items()}
    times.update({f"remat {k}": v for k, v in fbt["remat_ms"].items()})
    times.update(step_ms=fbt["step_ms"], optimizer_ms=fbt["optimizer_ms"])
    for r in fbt["site_rows"]:
        times.update({f"{r['level']} {k}": r[k] for k in
                      ("res_ms", "res_kernel_ms", "text_ms", "text_kernel_ms",
                       "temp_ms", "temp_kernel_ms")})
    _positive_times("floor_budget_train", times)
    require(len(fbt["step_ms_by_batch"]) == 3,
            f"floor_budget_train: batches {list(fbt['step_ms_by_batch'])}")
    bound_s = 1.0 / k10_ex2_rate()
    for what, out in (("floor_budget", fb), ("floor_budget_train", fbt)):
        require(out["sm_ps_per_elem"] * 1e-12 >= bound_s,
                f"{what}: softmax calibration {out['sm_ps_per_elem']} ps per "
                f"element below its bound {bound_s * 1e12} ps")
    lo, hi = STEP_OVER_SITES
    require(lo <= fb["step_over_sites"] <= hi,
            f"floor_budget: whole UNet call {fb['step_ms']} ms is "
            f"{fb['step_over_sites']} x the sum of its sites "
            f"{fb['site_sum_ms']} ms, outside [{lo}, {hi}]")

    rl = fbt["remat_launches"]
    print(json.dumps({"remat_launches": {
        "card": card, "what": "kernel launches of one full-width training "
        "micro-step (batch 1, 256 px, 12 frames, cond_frame 2) per remat "
        "policy", **rl}}), flush=True)
    differ = {k: (rl["none"][k], rl["save_attn"][k]) for k in FORWARD_KERNELS
              if rl["none"][k] != rl["save_attn"][k]}
    require(not differ, f"remat save_attn launched the forward kernels "
            f"otherwise than no remat (none, save_attn): {differ}")
    fwd = lambda p: sum(rl[p][k] for k in FORWARD_KERNELS)  # noqa: E731
    require(fwd("block") > fwd("none"),
            f"remat block launched {fwd('block')} forward kernels, no remat "
            f"{fwd('none')}: the recompute did not run")
    require(launches["softmax_calib"] > 0, "floor budget: K10 not launched")
    seconds = time.perf_counter() - t_phase
    print(json.dumps({"floor_budget_phase": {
        "seconds": seconds, "k10_calibration_rows": calibration_rows("cuda"),
        "launches": launches}}), flush=True)
    return k10, launches


# kernel-name fragments -> category of the step breakdown (first match wins)
KERNEL_CATEGORIES = (
    ("port: flash_attention (K2)", ("flash_fwd_wgmma_kernel",)),
    ("port: swat_attention_tables (K1; K6 a mode of it)",
     ("swat_fwd_wgmma_kernel", "rotate_qk_kernel")),
    ("port: flash_attention_bwd (K8)", ("flash_bwd_",)),
    ("port: swat_attention_tables_bwd (K7; K9 a mode of it)",
     ("swat_bwd_",)),
    ("port: geglu_ff (K3/K4/K5)", ("geglu_up_kernel", "geglu_down_kernel")),
    ("convolution (cuDNN)", ("cudnn", "fprop", "implicit_gemm", "winograd",
                             "conv2d", "nchwtonhwc", "nhwctonchw")),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "cublas")),
    ("softmax", ("softmax",)),
    ("reductions (norm statistics)", ("reduce",)),
    ("copies", ("copy", "memcpy")),
)


def _profile_call(call, path: str, label: str, what: str) -> None:
    """Profile ``call`` (which ends in a synchronize): its CUDA kernel time
    by category against its un-profiled host-clock time (device busy
    share).  The full kernel table is written to ``path``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        call()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
    wall_ms = 1e3 * sum(walls) / len(walls)
    by_cat, busy_ms = {}, 0.0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0)) / 1e3
        name = evt.key.lower()
        cat = next((c for c, frags in KERNEL_CATEGORIES
                    if any(f in name for f in frags)),
                   "other elementwise kernels")
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
        busy_ms += ms
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=80)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(table)
    print(json.dumps({label: {
        "what": what, "call_ms": wall_ms, "kernel_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms if busy_ms else None,
        "kernel_ms_by_category": dict(sorted(by_cat.items(),
                                             key=lambda kv: -kv[1]))}}),
          flush=True)


def profile_step(pipe, path: str) -> None:
    """Where one full-width DDIM step goes: one CFG-batched SeerUNet call
    at the main path's shapes."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(2, 12, 32, 32, 4, generator=gen, device="cuda").bfloat16()
    ctx = torch.randn(2, 12, 77, 768, generator=gen, device="cuda").bfloat16()
    ts = torch.full((2,), 500, dtype=torch.int32, device="cuda")

    def call():
        pipe.m.unet(x, ts, ctx)
        torch.cuda.synchronize()

    with torch.no_grad():
        _profile_call(call, path, "profile",
                      "one SeerUNet call, (2, 12, 32, 32, 4) bf16, full width")


def profile_train_step(models, path: str) -> None:
    """Where one full-width training micro-step goes: FSText + SeerUNet
    forward and backward (batch 1, 12 frames, cond_frame 2), without the
    frozen encoders and the optimizer update."""
    import torch

    from seervideoldm_tpu_torch.training.trainer import make_train_step

    step = make_train_step(models, cond_frames=2)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    batch = {"latents_x0": rn(1, 2, 32, 32, 4).bfloat16(),
             "latents": rn(1, 10, 32, 32, 4).bfloat16(),
             "clip_emb": rn(1, 77, 768).bfloat16()}
    noise = rn(1, 10, 32, 32, 4).bfloat16()
    ts = torch.tensor([500], device="cuda")
    names = list(models.masters)

    def call():
        step.loss_and_grads(names, batch, noise, ts)
        torch.cuda.synchronize()

    _profile_call(call, path, "profile_train",
                  "one training forward + backward, FSText + SeerUNet, "
                  "(1, 12, 32, 32, 4) bf16, cond_frame 2, full width, no remat")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="PATH", default=None,
                        help="also profile one full-width DDIM step and one "
                             "training forward + backward; kernel tables go "
                             "to PATH and PATH.train")
    args = parser.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    try:
        import seervideoldm_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: FAIL: the port package is missing ({e})",
              file=sys.stderr)
        return 1
    done = PhaseClock()
    try:
        card = phase_device()
        phase_build()
        done("build")
        rows = phase_kernels()
        done("kernels")
        phase_reference()
        phase_train_reference()
        done("references")
        launches, pipe, tok, cfg = phase_end_to_end(card, args.profile)
        done("6 end to end")
        phase_knob_reference()
        knob_launches = phase_knobs(card, pipe, tok, cfg)
        done("6b knobs")
        serving_launches, serve_rows = phase_serving(card, pipe, tok)
        done("6e serving")
        del pipe
        torch.cuda.empty_cache()
        pretrained_launches = phase_pretrained(card)
        done("6c pretrained")
        torch.cuda.empty_cache()
        eval_tmp = tempfile.mkdtemp(prefix="chip_smoke_eval_")
        try:
            eval_launches, eval_ref, eval_argv = phase_eval(card, eval_tmp)
            done("6d eval")
            torch.cuda.empty_cache()
            # 6f evaluates 6d's tree under a mesh
            serving_mesh_launches, eval_mesh_launches = phase_mesh(
                card, serve_rows, eval_argv, eval_ref)
            done("6f mesh")
        finally:
            shutil.rmtree(eval_tmp, ignore_errors=True)
        del serve_rows
        probe_launches = phase_quality_probe(card)
        done("6g probe")
        svd_launches = phase_svd(card)
        done("6h svd")
        torch.cuda.empty_cache()
        train_tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
        try:
            train_launches, phase7 = phase_training(card, args.profile,
                                                    train_tmp)
            done("7 training")
            option_launches, lora_ref = phase_training_options(
                card, train_tmp, phase7)
            done("7b training options")
            # phase 8's (l) trains on phase 7's tree from 7b's base
            par_launches = phase_parallel(card, lora_ref)
            done("8 parallel")
        finally:
            shutil.rmtree(train_tmp, ignore_errors=True)
        k10_row, fb_launches = phase_floor_budget(card)
        done("9 floor budget")
        rows["softmax_calib"] = [k10_row]
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        row, shapes = rows[name][0], rows[name]
        # each path is driven with the counts zeroed just before and read
        # just after; `launches` is the sum over the thirteen paths (the
        # parallel paths': rank 0's, summed over their runs; the knob
        # phase's: summed over its eight runs; serving's: over its
        # in-process batches; the training options': over their three runs)
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=(launches[name] + knob_launches[name]
                      + serving_launches[name]
                      + pretrained_launches[name] + eval_launches[name]
                      + serving_mesh_launches[name]
                      + eval_mesh_launches[name] + probe_launches[name]
                      + svd_launches[name] + train_launches[name] + option_launches[name]
                      + par_launches[name] + fb_launches[name]),
            sampling_launches=launches[name],
            knobs_launches=knob_launches[name],
            serving_launches=serving_launches[name],
            pretrained_launches=pretrained_launches[name],
            eval_launches=eval_launches[name],
            serving_mesh_launches=serving_mesh_launches[name],
            eval_mesh_launches=eval_mesh_launches[name],
            probe_launches=probe_launches[name],
            svd_launches=svd_launches[name],
            training_launches=train_launches[name],
            training_options_launches=option_launches[name],
            parallel_launches=par_launches[name],
            floor_budget_launches=fb_launches[name],
            max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            library_backend=row.get("library_backend"),
            shape=row["shape"], tol=row["tol"], ok=row["ok"],
            main_path_shapes=[
                {key: r.get(key) for key in (
                    "path", "shape", "max_abs_err", "ms", "plain_ms",
                    "bound_ms", "bound_by", "library_ms", "library_backend")}
                for r in shapes]))
        if name == "group_norm":
            # K11's launches above are its apply kernel's; its moments
            # kernel counts on a wrapper of its own, one a norm on one card
            kernels[-1]["moments_launches"] = sum(
                d["group_norm_moments"] for d in (
                    launches, knob_launches, serving_launches,
                    pretrained_launches, eval_launches, serving_mesh_launches,
                    eval_mesh_launches, probe_launches, svd_launches,
                    train_launches,
                    option_launches, par_launches, fb_launches))
    print(json.dumps({"phase_seconds": {
        "card": card, "phases": done.seconds,
        "total_seconds": time.perf_counter() - done.t0}}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
