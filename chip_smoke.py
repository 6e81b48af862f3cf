#!/usr/bin/env python3
"""Chip smoke test for the PyTorch/CUDA port (``seervideoldm_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints
no result line):

1. device: CUDA present, compute capability (9, 0); prints the card's name
   and power limit as nvidia-smi reports them;
2. build: compiles the four CUDA sources under ``seervideoldm_tpu_torch/
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
   its count per step x steps;
   checks the frames (finite, (1, 10, 256, 256, 3), in [0, 1]);
7. training: the port's ``train`` entry at the same full width on a
   synthetic Something-Something-v2 tree written from a numpy seed to a
   temporary directory: 256 px, 12 frames, 2 cond frames, batch 1,
   accumulation 2 (the shipped ``configs/train.yaml`` values) with
   ``text_loss`` on, 4 optimizer steps; launch counts zeroed just before and read just after, each
   kernel must have run its count per micro-step; losses finite; read back
   from the checkpoint it wrote, every trainable fp32 master moved and
   every frozen SeerUNet / FSText weight equals its seeded initial value;
   the checkpoint is loaded and sampled for a few DDIM steps;
8. parallel: 2 ranks started with ``parallel.launch`` (NCCL with a card
   per rank, else gloo with the ranks sharing the card and collectives
   staged through pinned host memory; chosen from the card count before any
   rank starts, and printed), full width, 256 px:
   (a) ``inference_img``'s pipeline under ``{seq: 2}``, 12 frames, 30 DDIM
   steps (the ring branch), rank 0 writes the GIF; one UNet call compared
   with the single-rank call on the same weights and inputs;
   (b) one UNet call under ``{seq: 2}`` at 11 frames (cond 2): the frames
   do not split evenly, the ring declines and K6 runs; compared the same;
   (c) the ``train`` entry under ``{data: 2}``, 2 optimizer steps; then one
   micro-step's loss and gradients against a single-rank step on the same
   global batch;
   (d) the ``train`` entry under ``{seq: 2}`` at 11 frames, 2 optimizer
   steps (K6 and K9), then the same check;
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
10. prints the ``kernels`` line, the card line and the result line.

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
PAR_OPT_STEPS = 2
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
STEP_OVER_SITES = (0.5, 2.0)
FORWARD_KERNELS = ("swat_attention_tables", "flash_attention", "ln_geglu_ff",
                   "ln_geglu_ff_proj", "geglu_ff")


class SmokeFailure(RuntimeError):
    pass


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
    and at the 256 / 512 px shapes, in both rotation modes."""
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


def phase_end_to_end(card: str, profile: str | None) -> dict:
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
        "launches": launches}}), flush=True)
    for name, per_step in PER_STEP.items():
        require(launches[name] == per_step * steps,
                f"e2e: {name} launched {launches[name]} times, expected "
                f"{per_step} x {steps} steps")
    if profile:
        profile_step(pipe, profile)
    return launches


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


def phase_training(card: str, profile: str | None) -> dict:
    """The port's ``train`` entry at full SD-1.5 width on a synthetic
    Sthv2 tree, then sampling from the checkpoint it wrote."""
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
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
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
        # measured by the entry per optimizer step (CUDA events around its
        # micro-steps, data loading included, the save excluded); the first
        # carries cuBLAS/cuDNN set-up, so report the rest
        steady = summary["step_seconds"][1:]
        s_step = sum(steady) / len(steady)
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
            "train_entry_seconds": elapsed,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches,
            "launches_per_micro_step": PER_MICRO_STEP}}), flush=True)
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
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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


def parallel_rank(rank: int, data_dir: str, out_dir: str) -> dict:
    """The four runs of the parallel phase on one rank (started by
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
    # (a) sampling under {seq: 2}, 12 frames: the ring
    t0 = _start_run()
    pipe, tok, cfg = build_pipeline(dict(
        resolution=256, cond_frames=2, num_frames=12, ddim_steps=E2E_STEPS,
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
    # (c), (d) the train entry, then the step check
    for name, mesh_shape, frames in (("train_data2", {"data": 2}, 12),
                                     ("train_seq2_f11_k6", {"seq": 2}, 11)):
        raw = dict(
            output_dir=os.path.join(out_dir, name), data_dir=data_dir,
            dataset="sthv2", resolution=256, num_frames=frames,
            cond_frames=2, train_batch_size=1, gradient_accumulation_steps=1,
            learning_rate=1.28e-5, scale_lr=True, lr_scheduler="cosine",
            lr_warmup_steps=1, max_train_steps=PAR_OPT_STEPS,
            save_steps=PAR_OPT_STEPS, max_grad_norm=0.3, num_workers=2,
            seed=SEED, mixed_precision="bf16", compute_dtype="bfloat16",
            text_loss=True, mesh_shape=mesh_shape)
        t0 = _start_run()
        summary = train(config_from_dict(dict(raw)))
        row = _end_run(t0)
        row.update(global_step=summary["global_step"],
                   losses=summary["losses"],
                   step_seconds=summary["step_seconds"],
                   checkpoint_written=os.path.isdir(summary["checkpoint"]))
        cfg = config_from_dict(dict(raw))
        row["step_check"] = _train_vs_single(cfg, create_mesh(mesh_shape),
                                             SEED + 5)
        runs[name] = row
        torch.cuda.empty_cache()
    return runs


def phase_parallel(card: str) -> dict:
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
                                   os.path.join(tmp, "out")),
                             backend=transport, timeout=PAR_TIMEOUT)
        wall = time.perf_counter() - t0
    except RuntimeError as e:
        raise SmokeFailure(f"parallel: {e}") from e
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    main = results[0]
    total = {name: 0 for name in wrappers()}
    for name, row in main.items():
        per_rank = [r[name] for r in results]
        print(json.dumps({"parallel_run": {
            "run": name, "card": card, "transport": transport,
            "ranks": PAR_RANKS, **{k: v for k, v in row.items()
                                   if k not in ("launches", "peak_mem_gb")},
            "launches_per_rank": [r["launches"] for r in per_rank],
            "peak_mem_gb_per_rank": [r["peak_mem_gb"] for r in per_rank]}}),
              flush=True)
        for k, n in row["launches"].items():
            total[k] += n
    print(json.dumps({"parallel_phase": {"seconds": wall}}), flush=True)

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
    try:
        card = phase_device()
        phase_build()
        rows = phase_kernels()
        phase_reference()
        phase_train_reference()
        launches = phase_end_to_end(card, args.profile)
        train_launches = phase_training(card, args.profile)
        par_launches = phase_parallel(card)
        k10_row, fb_launches = phase_floor_budget(card)
        rows["softmax_calib"] = [k10_row]
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        row, shapes = rows[name][0], rows[name]
        # each path is driven with the counts zeroed just before and read
        # just after; `launches` is the sum over the four paths (the
        # parallel path's: rank 0's, summed over its runs)
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=(launches[name] + train_launches[name]
                      + par_launches[name] + fb_launches[name]),
            sampling_launches=launches[name],
            training_launches=train_launches[name],
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
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
