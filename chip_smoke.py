#!/usr/bin/env python3
"""Chip smoke test for the PyTorch/CUDA port (``seervideoldm_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints
no result line):

1. device: CUDA present, compute capability (9, 0); prints the card's name
   and power limit as nvidia-smi reports them;
2. build: compiles the three CUDA sources under ``seervideoldm_tpu_torch/
   csrc`` with nvcc for sm_90a, all at once, and prints the build time;
3. kernel checks: each of K1-K5 at the main-path shapes (256 px) and at the
   512 px shapes (d = 40 and d = 80), bf16 inputs from a seeded generator,
   against its plain PyTorch version; times the kernel, the plain version
   and one library call computing the same function;
4. reference: one SeerUNet call at narrow widths (64/128) and the main
   path's 256 px / 12 frame / CFG-batch-2 shapes, bf16 with the kernels on
   the card against the port's plain path in fp32 on the CPU, same weights
   and inputs (relative L2 error <= 5e-2);
5. end to end: the port's image + prompt -> video pipeline at full SD-1.5
   width (CLIP ViT-L/14 text, FSText, SD-1.5 VAE, SeerUNet 320/640/1280/
   1280), 256 px, 12 frames, 2 cond frames, CFG 7.5, random weights from a
   seed, 30 DDIM steps (the shipped config's count); launch counts are
   zeroed just before and read just after, and every kernel must have run
   its count per step x steps;
   checks the frames (finite, (1, 10, 256, 256, 3), in [0, 1]);
6. prints the ``kernels`` line, the card line and the result line.

``--profile PATH`` adds where one full-width DDIM step's time goes: one
SeerUNet call's CUDA kernel time by category and the device busy share (a
``profile`` JSON line); the full torch.profiler table is written to PATH.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
ATOL, RTOL = 2e-2, 2e-2    # bf16 outputs, kernel vs plain version
REF_RTOL = 5e-2            # relative L2, bf16 UNet on the card vs fp32 CPU
E2E_STEPS = 30             # DDIM steps of the end-to-end run (the shipped
                           # configs/inference_base.yaml value)
SEED = 0
# launches of each kernel per SeerUNet call (one per DDIM step with batched
# CFG) at 256 px: K1 at L0 temporal sites, K2 at L0 per-frame spatial
# attention, K3/K4 at the c = 320 text FF / temporal site tails, K5 at the
# c = 640 FF sites
PER_STEP = {"swat_attention_tables": 5, "flash_attention": 5,
            "ln_geglu_ff": 5, "ln_geglu_ff_proj": 5, "geglu_ff": 10}


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
    from seervideoldm_tpu_torch.ops.kernels import flash_attention as fa
    from seervideoldm_tpu_torch.ops.kernels import geglu_ff as gg
    from seervideoldm_tpu_torch.ops.kernels import swat_attention as sw

    return {"swat_attention_tables": sw.swat_attention_tables,
            "flash_attention": fa.flash_attention,
            "ln_geglu_ff": gg.ln_geglu_ff,
            "ln_geglu_ff_proj": gg.ln_geglu_ff_proj, "geglu_ff": gg.geglu_ff}


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


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# ----------------------------------------------------------- kernel checks

def _randn(shape, gen, dtype, scale=1.0):
    import torch

    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def case_flash(gen, batch, n, d, causal=False):
    import torch
    import torch.nn.functional as F

    from seervideoldm_tpu_torch.ops.kernels import flash_attention as K

    bf = torch.bfloat16
    q, k, v = (_randn((batch, n, d), gen, bf) for _ in range(3))
    scale = d ** -0.5
    pairs = n * (n + 1) // 2 if causal else n * n
    return dict(
        name="flash_attention", kernel=lambda: K.flash_attention(q, k, v, scale, causal),
        plain=lambda: K.flash_attention_plain(q, k, v, scale, causal),
        library=lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale, is_causal=causal),
        flops=4.0 * batch * pairs * d, nbytes=4.0 * batch * n * d * 2,
        shape=f"({batch}, {n}, {d}){' causal' if causal else ''}")


def case_swat(gen, batch, f, h, d):
    import torch
    import torch.nn.functional as F

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
    return dict(
        name="swat_attention_tables",
        kernel=lambda: K.swat_attention_tables(q, k, v, cos, sin, scale, True, ws),
        plain=lambda: K.swat_attention_tables_plain(q, k, v, cos, sin, scale, True, ws),
        library=lambda: F.scaled_dot_product_attention(
            qw, kw, vw, scale=scale, is_causal=True),
        flops=4.0 * windows * d * tokens * (tokens + 1) / 2,
        nbytes=4.0 * q.numel() * 2 + 2.0 * cos.numel() * 4,
        shape=f"({batch}, {f}, {h}, {h}, {d}) ws 8 causal")


def case_geglu(gen, mode, n, c):
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

    if mode == 0:
        return dict(name="geglu_ff", kernel=lambda: K.geglu_ff(x, w1, b1, w2, b2),
                    plain=lambda: K.geglu_ff_plain(x, w1, b1, w2, b2),
                    library=lambda: chain(x), flops=flops, nbytes=nbytes,
                    shape=f"({n}, {c}) inner {inner}")
    ln = lambda: F.layer_norm(x.float(), (c,), gamma, beta, K.LN_EPS).to(bf)  # noqa: E731
    if mode == 1:
        return dict(name="ln_geglu_ff",
                    kernel=lambda: K.ln_geglu_ff(x, gamma, beta, w1, b1, w2, b2),
                    plain=lambda: K.ln_geglu_ff_plain(x, gamma, beta, w1, b1, w2, b2),
                    library=lambda: chain(ln()) + x, flops=flops, nbytes=nbytes,
                    shape=f"({n}, {c}) inner {inner}")
    return dict(name="ln_geglu_ff_proj",
                kernel=lambda: K.ln_geglu_ff_proj(x, gamma, beta, w1, b1, w2, b2,
                                                  w3, b3, res),
                plain=lambda: K.ln_geglu_ff_proj_plain(x, gamma, beta, w1, b1, w2,
                                                       b2, w3, b3, res),
                library=lambda: F.linear(chain(ln()) + x, w3, b3) + res,
                flops=flops + 2.0 * n * c * c,
                nbytes=nbytes + 2.0 * (n * c + c * c), shape=f"({n}, {c}) inner {inner}")


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
}


def kernel_cases(gen):
    """(main_path, case) pairs: the 256 px main-path shapes first (CFG
    batch 2, 12 frames, 8 heads), then the 512 px shapes (attention at
    d = 40 at L0 and d = 80 at L1, the c = 320 LN forms at L0, the c = 640
    FF at L1), a causal flash case and the streamed kv > 4096 flash form."""
    return [
        (True, case_swat(gen, 16, 12, 32, 40)),
        (True, case_flash(gen, 192, 1024, 40)),
        (True, case_geglu(gen, 1, 24576, 320)),
        (True, case_geglu(gen, 2, 24576, 320)),
        (True, case_geglu(gen, 0, 6144, 640)),
        (False, case_swat(gen, 16, 12, 64, 40)),
        (False, case_swat(gen, 16, 12, 32, 80)),
        (False, case_flash(gen, 192, 4096, 40)),
        (False, case_flash(gen, 192, 1024, 80)),
        (False, case_flash(gen, 16, 1024, 40, causal=True)),
        (False, case_flash(gen, 8, 8192, 40)),
        (False, case_geglu(gen, 1, 98304, 320)),
        (False, case_geglu(gen, 2, 98304, 320)),
        (False, case_geglu(gen, 0, 24576, 640)),
    ]


def check_case(case: dict) -> dict:
    import torch

    got = case["kernel"]()
    want = case["plain"]()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    max_abs = float(err.max())
    worst = float((err - (ATOL + RTOL * want.float().abs())).max())
    finite = bool(torch.isfinite(got).all())
    row = dict(name=case["name"], shape=case["shape"], max_abs_err=max_abs,
               tol=f"{ATOL} abs + {RTOL} rel", ok=finite and worst <= 0.0)
    del got, want, err
    row["ms"] = time_ms(case["kernel"])
    row["plain_ms"] = time_ms(case["plain"], iters=5, warmup=1)
    row["library_ms"] = time_ms(case["library"])
    row["bound_ms"], row["bound_by"] = bound(case["flops"], case["nbytes"])
    return row


def phase_kernels() -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    main_rows, failures = {}, []
    for main_path, case in kernel_cases(gen):
        row = check_case(case)
        print(json.dumps({"kernel_check": row}), flush=True)
        if not row["ok"]:
            failures.append(f"{row['name']} {row['shape']}: max_abs_err "
                            f"{row['max_abs_err']}")
        if main_path:
            main_rows[row["name"]] = row
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


def phase_build() -> None:
    from seervideoldm_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    reports = build.build_all()
    for name, log in reports.items():
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"build {name}: " + " | ".join(regs[:6]), flush=True)
    print(f"build: {len(reports)} sources in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


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


# kernel-name fragments -> category of the step breakdown (first match wins)
KERNEL_CATEGORIES = (
    ("port: flash_attention (K2)", ("flash_fwd_kernel",)),
    ("port: swat_attention_tables (K1)", ("swat_tab_fwd_kernel",)),
    ("port: geglu_ff (K3/K4/K5)", ("geglu_ff_kernel",)),
    ("convolution (cuDNN)", ("cudnn", "fprop", "implicit_gemm", "winograd",
                             "conv2d", "nchwtonhwc", "nhwctonchw")),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "cublas")),
    ("softmax", ("softmax",)),
    ("reductions (norm statistics)", ("reduce",)),
    ("copies", ("copy", "memcpy")),
)


def profile_step(pipe, path: str) -> None:
    """Where one full-width DDIM step goes: one CFG-batched SeerUNet call
    at the main path's shapes, its CUDA kernel time by category, against
    the call's un-profiled host-clock time (device busy share).  The full
    kernel table is written to ``path``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(2, 12, 32, 32, 4, generator=gen, device="cuda").bfloat16()
    ctx = torch.randn(2, 12, 77, 768, generator=gen, device="cuda").bfloat16()
    ts = torch.full((2,), 500, dtype=torch.int32, device="cuda")

    def call():
        pipe.m.unet(x, ts, ctx)
        torch.cuda.synchronize()

    with torch.no_grad():
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
    print(json.dumps({"profile": {
        "what": "one SeerUNet call, (2, 12, 32, 32, 4) bf16, full width",
        "unet_call_ms": wall_ms, "kernel_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms if busy_ms else None,
        "kernel_ms_by_category": dict(sorted(by_cat.items(),
                                             key=lambda kv: -kv[1]))}}),
          flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="PATH", default=None,
                        help="also profile one full-width DDIM step and "
                             "write the kernel table to PATH")
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
        launches = phase_end_to_end(card, args.profile)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        row = rows[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            shape=row["shape"], tol=row["tol"], ok=row["ok"]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
