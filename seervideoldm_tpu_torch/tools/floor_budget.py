"""Per-site sampling floor budget on the card (port of
``tools/floor_budget.py``).

One table at the sampling shape (CFG batch 2, 12 frames, 512 px, full
SD-1.5 width): one whole SeerUNet call, then every resnet, text-attention
and temporal-attention site alone, each against an analytic floor -- the
site's matmuls at the card's peak (derated by the contraction granule
``occ``), the HBM passes of its norm islands, and K10's measured cost per
softmax element.

Timing.  PyTorch runs eagerly, so the TPU tool's ``lax.scan`` becomes a
Python loop that feeds each output back as the next input; the wall time
per application is the two-N delta (N = 10 and 50 for a site, 5 and 15
for the whole UNet: the fixed cost of the loop cancels), each N the median
of ``--iters`` runs ending in a synchronize.  Each row also reports the
CUDA kernel time per application (the ``torch.profiler`` device time of one
N-loop over N) and its busy share, kernel / wall: wall minus kernel is what
the host adds (Python and launch overhead).

The floor model (``Roofline``, ``occ``, ``lin``, ``attn_mm``, ``hbm_ms``,
``resnet_floor``, ``site_floors``, ``train_site_floors``) is pure Python:
with ``Roofline.v5e()`` and the TPU's calibration it reproduces the JAX
tool's record (``FLOORBUDGET.json``, ``FLOORBUDGET_TRAIN.json``), with
``Roofline.h100()`` and K10's calibration it gives this card's floors.

    python -m seervideoldm_tpu_torch.tools.floor_budget [--resolution 512
        --frames 12 --batch 2 --json]
    # plain path on the CPU at narrow width (plumbing only, no device time):
    python -m seervideoldm_tpu_torch.tools.floor_budget --device cpu \\
        --resolution 64 --frames 4 --widths 32,64,64,64 --calib_reps 2,4
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

SD15_WIDTHS = (320, 640, 1280, 1280)
HEADS, LAYERS = 8, 2
CTX_TOKENS, CTX_DIM = 77, 768


# ------------------------------------------------------------ floor model

@dataclass(frozen=True)
class Roofline:
    """The constants of a floor: dense bf16 peak (FLOP/s), HBM bandwidth
    (bytes/s) and the contraction granule that ``occ`` derates by."""

    name: str
    peak: float
    hbm_bw: float
    granule: int

    @staticmethod
    def h100() -> "Roofline":
        """H100 SXM data sheet (989 TFLOP/s dense bf16, 3.35 TB/s HBM3);
        granule 16, the k of the ``mma.sync m16n8k16`` in the port's
        kernels (d = 40 pads to 48)."""
        return Roofline("H100 SXM", 989e12, 3.35e12, 16)

    @staticmethod
    def v5e() -> "Roofline":
        """The JAX tool's TPU v5e constants (197 TFLOP/s, 819 GB/s, 128
        MXU lanes); for holding these formulas against its record only."""
        return Roofline("TPU v5e", 197e12, 819e9, 128)


def occ(d: int, roofline: Roofline) -> float:
    """Occupancy of a matmul whose contraction (or minor) dim is d."""
    g = roofline.granule
    return d / (math.ceil(d / g) * g)


def lin(tokens: float, din: int, dout: int, roofline: Roofline) -> float:
    """ms of a (tokens, din) @ (din, dout) matmul at the derated peak."""
    fl = 2.0 * tokens * din * dout
    return fl / (roofline.peak * min(occ(din, roofline),
                                     occ(dout, roofline))) * 1e3


def attn_mm(bh: float, n: float, m: float, d: int, roofline: Roofline) -> float:
    """ms of QK^T + P@V at the d-derated peak."""
    fl = 2.0 * bh * n * m * d * 2
    return fl / (roofline.peak * occ(d, roofline)) * 1e3


def hbm_ms(elems: float, n_passes: float, roofline: Roofline,
           bytes_per: int = 2) -> float:
    """ms to move elems * bytes_per bytes n_passes times over HBM."""
    return elems * bytes_per * n_passes / roofline.hbm_bw * 1e3


def resnet_floor(tokens: float, cin: int, cout: int,
                 roofline: Roofline) -> float:
    """Both 3x3 convs (+ the 1x1 shortcut when cin != cout) as matmuls,
    plus the HBM passes that are not the convs' own: GN1 read + write over
    cin, GN2 over cout, the residual read of x and the final write."""
    mm = (lin(tokens, 9 * cin, cout, roofline)
          + lin(tokens, 9 * cout, cout, roofline))
    if cin != cout:
        mm += lin(tokens, cin, cout, roofline)
    bw = (hbm_ms(tokens * cin, 2, roofline) + hbm_ms(tokens * cout, 2, roofline)
          + hbm_ms(tokens * cin, 1, roofline)
          + hbm_ms(tokens * cout, 1, roofline))
    return mm + bw


def _levels(resolution: int, widths: Sequence[int], heads: int):
    """(level, hw, c, d) of the cross-attention levels, then of L3 + mid."""
    hw = resolution // 8
    out = []
    for lvl, c in enumerate(widths[:-1]):
        out.append((f"L{lvl}", hw, c, c // heads))
        hw //= 2
    return out, (hw, widths[-1], widths[-1] // heads)


def _temporal(hw: int, frames: int, batch: int, heads: int):
    """(groups, n, m) of the temporal attention: full-frame at hw <= 4,
    else ws x ws windows (ws 8 when hw // 8 >= 4, else 4) over all frames."""
    s = hw * hw
    if hw <= 4:
        return batch * heads, frames * s, frames * s
    ws = 8 if hw // 8 >= 4 else 4
    return batch * heads * s // (ws * ws), frames * ws * ws, frames * ws * ws


def _text_mm(bf: float, s: int, c: int, d: int, heads: int, rl: Roofline,
             ctx_tokens: int, ctx_dim: int) -> float:
    return (lin(bf * s, c, c, rl) * 2           # proj_in + proj_out
            + lin(bf * s, c, c, rl) * 4         # self q, k, v, out
            + attn_mm(bf * heads, s, s, d, rl)
            + lin(bf * s, c, c, rl) * 2         # cross q, out
            + lin(bf * ctx_tokens, ctx_dim, c, rl) * 2   # cross k, v
            + attn_mm(bf * heads, s, ctx_tokens, d, rl)
            + lin(bf * s, c, 4 * c, rl) * 2 + lin(bf * s, 4 * c, c, rl))


def _temp_mm(bf: float, s: int, c: int, d: int, groups: float, n_t: float,
             rl: Roofline) -> float:
    return (lin(bf * s, c, c, rl) * 2 + lin(bf * s, c, c, rl) * 4
            + attn_mm(groups, n_t, n_t, d, rl) * 0.5   # causal half
            + lin(bf * s, c, 4 * c, rl) * 2 + lin(bf * s, 4 * c, c, rl))


def site_floors(resolution: int, frames: int, batch: int, roofline: Roofline,
                sm_per_elem: float, widths: Sequence[int] = SD15_WIDTHS,
                heads: int = HEADS, layers: int = LAYERS,
                ctx_tokens: int = CTX_TOKENS, ctx_dim: int = CTX_DIM) -> dict:
    """The sampling budget's floors (ms): per level L0-L2 the resnet down /
    up, text and temporal site floors and their softmax parts; L3 + mid
    (resnet, the mid attention pair); and the floor sum over every site of
    one UNet forward (``tools/floor_budget.py:70-107, 266-305, 345-372,
    407``)."""
    levels, (hw3, c3, d3) = _levels(resolution, widths, heads)
    bf = batch * frames
    rows, floor_sum = [], 0.0
    for level, hw, c, d in levels:
        s = hw * hw
        groups, n_t, _ = _temporal(hw, frames, batch, heads)
        text_sm = sm_per_elem * (bf * heads * s * s) * 1e3
        temp_sm = sm_per_elem * (groups * n_t * n_t) * 0.5 * 1e3
        row = dict(
            level=level, hw=hw, ch=c, d=d, n_triplets=2 * layers + 1,
            n_res_down=layers, n_res_up=layers + 1,
            res_down_floor_ms=resnet_floor(bf * s, c, c, roofline),
            res_up_floor_ms=resnet_floor(bf * s, 2 * c, c, roofline),
            text_floor_ms=_text_mm(bf, s, c, d, heads, roofline, ctx_tokens,
                                   ctx_dim) + text_sm,
            temp_floor_ms=_temp_mm(bf, s, c, d, groups, n_t, roofline)
            + temp_sm,
            text_sm_ms=text_sm, temp_sm_ms=temp_sm)
        rows.append(row)
        floor_sum += (row["n_triplets"] * (row["text_floor_ms"]
                                           + row["temp_floor_ms"])
                      + layers * row["res_down_floor_ms"]
                      + (layers + 1) * row["res_up_floor_ms"])
    s3 = hw3 * hw3
    groups3, n_t3, _ = _temporal(hw3, frames, batch, heads)
    mid_text = (_text_mm(bf, s3, c3, d3, heads, roofline, ctx_tokens, ctx_dim)
                + sm_per_elem * (bf * heads * s3 * s3) * 1e3)
    mid_temp = (_temp_mm(bf, s3, c3, d3, groups3, n_t3, roofline)
                + sm_per_elem * (groups3 * n_t3 * n_t3) * 0.5 * 1e3)
    # L3: down `layers` + up `layers + 1` resnets; mid: 2 resnets + 1 pair
    l3 = dict(level="L3+mid", hw=hw3, ch=c3, d=d3, n_res=2 * layers + 3,
              res_floor_ms=resnet_floor(bf * s3, c3, c3, roofline),
              mid_text_floor_ms=mid_text, mid_temp_floor_ms=mid_temp,
              mid_floor_ms=mid_text + mid_temp)
    floor_sum += l3["n_res"] * l3["res_floor_ms"] + l3["mid_floor_ms"]
    return dict(roofline=roofline.name, rows=rows, l3=l3,
                floor_sum_ms=floor_sum)


def train_site_floors(resolution: int, frames: int, batch: int,
                      roofline: Roofline, sm_per_elem: float,
                      widths: Sequence[int] = SD15_WIDTHS, heads: int = HEADS,
                      ctx_tokens: int = CTX_TOKENS,
                      ctx_dim: int = CTX_DIM) -> list:
    """The training budget's forward + backward floors (ms) per level
    L0-L2 (``tools/floor_budget_train.py:346-367``): frozen sites (text
    attention, resnets) back-propagate activations only, x2 their forward
    matmuls; the trainable temporal sites also make weight gradients, x3;
    flash-style attention backwards recompute scores and probabilities,
    x3.5 the forward attention matmuls; softmax x2."""
    levels, _ = _levels(resolution, widths, heads)
    bf = batch * frames
    rows = []
    for level, hw, c, d in levels:
        s = hw * hw
        groups, n_t, _ = _temporal(hw, frames, batch, heads)
        rl = roofline
        text = (2.0 * (lin(bf * s, c, c, rl) * 6
                       + lin(bf * ctx_tokens, ctx_dim, c, rl) * 2
                       + lin(bf * s, c, 4 * c, rl) * 2
                       + lin(bf * s, 4 * c, c, rl))
                + 3.5 * (attn_mm(bf * heads, s, s, d, rl)
                         + attn_mm(bf * heads, s, ctx_tokens, d, rl))
                + 2 * sm_per_elem * (bf * heads * s * (s + ctx_tokens)) * 1e3)
        temp = (3.0 * (lin(bf * s, c, c, rl) * 6 + lin(bf * s, c, 4 * c, rl) * 2
                       + lin(bf * s, 4 * c, c, rl))
                + 3.5 * attn_mm(groups, n_t, n_t, d, rl) * 0.5
                + 2 * sm_per_elem * (groups * n_t * n_t) * 0.5 * 1e3)
        rows.append(dict(level=level, hw=hw, ch=c, d=d,
                         res_floor=2.0 * resnet_floor(bf * s, c, c, rl),
                         text_floor=text, temp_floor=temp))
    return rows


# ----------------------------------------------------------------- timing

def card_info() -> dict:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    name, limit = out.stdout.strip().splitlines()[0].rsplit(",", 1)
    return {"card": name.strip(), "power_limit_w": float(limit)}


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench(step: Callable, x, device, lo: int, hi: int,
          iters: int = 3) -> tuple[float, Optional[float]]:
    """(wall ms, CUDA kernel ms) per application of ``step`` chained
    (each output the next input): the two-N delta of the wall time, each N
    the median of ``iters`` runs ending in a synchronize, and the
    profiler's kernel time over one ``lo``-loop / lo (None on the CPU).
    The delta is not clamped: a non-positive one stays visible."""
    from ..utils.profiling import kernel_ms

    def run(n: int):
        h = x
        for _ in range(n):
            h = step(h)
        return h

    def timed(n: int) -> float:
        run(1)
        _sync(device)
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            run(n)
            _sync(device)
            times.append(time.perf_counter() - t0)
        return sorted(times)[len(times) // 2]

    wall = (timed(hi) - timed(lo)) / (hi - lo) * 1e3
    kern = kernel_ms(lambda: run(lo)) if device.type == "cuda" else None
    return wall, None if kern is None else kern / lo


def build_seeded(ctor: Callable, device, dtype, seed: int):
    """``ctor()`` built on ``device`` from the seeded default generator,
    cast to the compute dtype (norm layers fp32), frozen."""
    import torch

    from ..utils.device import cast_for_compute

    forked = [device] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=forked), torch.device(device):
        torch.manual_seed(seed)
        module = ctor()
    return cast_for_compute(module, dtype).eval().requires_grad_(False)


def parse_widths(text: str) -> tuple:
    return tuple(int(v) for v in text.split(","))


def common_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--frames", type=int, default=12)
    parser.add_argument("--json", action="store_true")
    parser.add_argument("--device", default=None,
                        help="default: the CUDA card; 'cpu' runs the plain "
                             "path (plumbing only, no device time)")
    parser.add_argument("--widths", type=parse_widths, default=SD15_WIDTHS,
                        help="SeerUNet block_out_channels")
    parser.add_argument("--calib_reps", type=parse_widths,
                        default=(2048, 8192),
                        help="the K10 calibration's two points")
    parser.add_argument("--iters", type=int, default=3,
                        help="timed runs per N (median)")


def setup(args):
    """(device, compute dtype, card dict, s per softmax element)."""
    import torch

    from ..ops.kernels.softmax_calib import softmax_s_per_elem
    from ..utils.device import resolve_device, set_numerics

    device = resolve_device(args.device)
    if device.type == "cuda":
        set_numerics()
        card = card_info()
        dtype = torch.bfloat16
    else:
        card = {"card": "cpu", "power_limit_w": None}
        dtype = torch.float32
    sm = softmax_s_per_elem(device, reps=tuple(args.calib_reps),
                            iters=args.iters)
    return device, dtype, card, sm


def _unet_config(widths, heads: int):
    from ..models.unet3d import SeerUNetConfig

    return SeerUNetConfig(block_out_channels=tuple(widths),
                          attention_head_dim=heads)


def main(argv: Optional[list] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--resolution", type=int, default=512)
    parser.add_argument("--batch", type=int, default=2,
                        help="CFG-doubled UNet batch")
    common_args(parser)
    args = parser.parse_args(argv)

    import torch

    from ..models.resnet3d import ResnetBlock3D
    from ..models.transformer3d import SpatialTransformer3D
    from ..models.unet3d import SeerUNet

    device, dtype, card, sm = setup(args)
    b, f = args.batch, args.frames
    latent = args.resolution // 8
    widths, heads, L = tuple(args.widths), HEADS, LAYERS
    gen = torch.Generator(device=device).manual_seed(0)
    rn = lambda *s: torch.randn(s, generator=gen, device=device).to(dtype)  # noqa: E731
    ctx = rn(b, f, CTX_TOKENS, CTX_DIM)
    temb = rn(b, widths[0] * 4)
    temb_ch = widths[0] * 4
    out = dict(card, device=device.type, resolution=args.resolution,
               frames=f, batch=b, widths=list(widths),
               sm_ps_per_elem=sm * 1e12)
    print(f"softmax calibration (K10): {sm * 1e12:.4f} ps/element", flush=True)

    with torch.no_grad():
        # ---- whole-UNet call (the number the rows are set against)
        unet = build_seeded(lambda: SeerUNet(_unet_config(widths, heads)),
                            device, dtype, 0)
        ts = torch.full((b,), 500, dtype=torch.int32, device=device)
        x = rn(b, f, latent, latent, 4)
        step_ms, step_kernel = bench(
            lambda h: unet(h, ts, ctx).to(h.dtype), x, device, 5, 15,
            args.iters)
        del unet
        out.update(step_ms=step_ms, step_kernel_ms=step_kernel)
        print(f"whole UNet forward: {step_ms:.3f} ms wall, kernel "
              f"{_fmt(step_kernel)} ms", flush=True)

        # ---- per-site measurements
        def site(ctor, call, x_site, seed):
            module = build_seeded(ctor, device, dtype, seed)
            return bench(lambda h: call(module, h).to(h.dtype), x_site,
                         device, 10, 50, args.iters)

        levels, (hw3, c3, d3) = _levels(args.resolution, widths, heads)
        measured = []
        for i, (level, hw, c, d) in enumerate(levels):
            xs = rn(b, f, hw, hw, c)
            m = {}
            m["res_down"] = site(lambda: ResnetBlock3D(c, c, temb_ch),
                                 lambda mod, h: mod(h, temb), xs, 10 * i + 1)
            m["res_up"] = site(lambda: ResnetBlock3D(2 * c, c, temb_ch),
                               lambda mod, h: mod(torch.cat([h, h], -1), temb),
                               xs, 10 * i + 2)
            m["text"] = site(lambda: SpatialTransformer3D(
                c, heads, d, context_dim=CTX_DIM, text_frame_condition=True),
                lambda mod, h: mod(h, context=ctx), xs, 10 * i + 3)
            m["temp"] = site(lambda: SpatialTransformer3D(
                c, heads, d, temporal=True, causal=True),
                lambda mod, h: mod(h), xs, 10 * i + 4)
            measured.append(m)
            print(f"{level}: " + ", ".join(f"{k} {v[0]:.3f} ms" for k, v in
                                           m.items()), flush=True)
        xs = rn(b, f, hw3, hw3, c3)
        m3 = {"res": site(lambda: ResnetBlock3D(c3, c3, temb_ch),
                          lambda mod, h: mod(h, temb), xs, 41),
              "text": site(lambda: SpatialTransformer3D(
                  c3, heads, d3, context_dim=CTX_DIM,
                  text_frame_condition=True),
                  lambda mod, h: mod(h, context=ctx), xs, 43),
              "temp": site(lambda: SpatialTransformer3D(
                  c3, heads, d3, temporal=True, causal=True),
                  lambda mod, h: mod(h), xs, 44)}

    floors = site_floors(args.resolution, f, b, Roofline.h100(), sm,
                         widths=widths, heads=heads)
    out.update(assemble(floors, measured, m3, step_ms, step_kernel, L))
    print_table(out)
    if args.json:
        print(json.dumps({"floor_budget": out}), flush=True)
    return out


def _fmt(v) -> str:
    return "not measured" if v is None else f"{v:.3f}"


def _busy(kern, wall):
    return None if kern is None else kern / wall


def assemble(floors: dict, measured: list, m3: dict, step_ms: float,
             step_kernel, layers: int) -> dict:
    """The JAX tool's rows, sums and headrooms from measured
    (wall ms, kernel ms) pairs and the floors."""
    rows, table = [], []
    total = 0.0
    for fl, m in zip(floors["rows"], measured):
        r = dict(fl)
        for key in ("res_down", "res_up", "text", "temp"):
            r[f"{key}_ms"], r[f"{key}_kernel_ms"] = m[key]
        rows.append(r)
        n_dn, n_up, n_t = layers, layers + 1, r["n_triplets"]
        res_wall = n_dn * r["res_down_ms"] + n_up * r["res_up_ms"]
        res_kern = (None if r["res_down_kernel_ms"] is None else
                    n_dn * r["res_down_kernel_ms"]
                    + n_up * r["res_up_kernel_ms"])
        res_floor = (n_dn * r["res_down_floor_ms"]
                     + n_up * r["res_up_floor_ms"])
        table.append((f"{r['level']} resnet", n_dn + n_up, res_wall, res_kern,
                      res_floor))
        for key, name in (("text", "text-attn"), ("temp", "temporal-attn")):
            kern = r[f"{key}_kernel_ms"]
            table.append((f"{r['level']} {name}", n_t, n_t * r[f"{key}_ms"],
                          None if kern is None else n_t * kern,
                          n_t * r[f"{key}_floor_ms"]))
        total += res_wall + n_t * (r["text_ms"] + r["temp_ms"])
    l3 = dict(floors["l3"])
    l3["res_ms"], l3["res_kernel_ms"] = m3["res"]
    l3["mid_text_ms"], l3["mid_text_kernel_ms"] = m3["text"]
    l3["mid_temp_ms"], l3["mid_temp_kernel_ms"] = m3["temp"]
    mid_wall = l3["mid_text_ms"] + l3["mid_temp_ms"]
    mid_kern = (None if l3["mid_text_kernel_ms"] is None else
                l3["mid_text_kernel_ms"] + l3["mid_temp_kernel_ms"])
    n3 = l3["n_res"]
    table.append(("L3+mid resnet", n3, n3 * l3["res_ms"],
                  None if l3["res_kernel_ms"] is None
                  else n3 * l3["res_kernel_ms"], n3 * l3["res_floor_ms"]))
    table.append(("mid attn pair", 1, mid_wall, mid_kern, l3["mid_floor_ms"]))
    total += n3 * l3["res_ms"] + mid_wall
    site_rows = [dict(site=name, count=n, wall_ms=wall,
                      wall_ms_per_site=wall / n, kernel_ms=kern,
                      floor_ms=floor, act_floor=wall / floor,
                      busy=_busy(kern, wall),
                      host_share=None if kern is None else 1.0 - kern / wall)
                 for name, n, wall, kern, floor in table]
    kern_total = (None if any(r["kernel_ms"] is None for r in site_rows)
                  else sum(r["kernel_ms"] for r in site_rows))
    return dict(rows=rows, l3=l3, site_table=site_rows,
                site_sum_ms=total, site_kernel_sum_ms=kern_total,
                residual_ms=step_ms - total, step_over_sites=step_ms / total,
                step_busy=_busy(step_kernel, step_ms),
                floor_sum_ms=floors["floor_sum_ms"],
                step_over_floor=step_ms / floors["floor_sum_ms"])


def print_table(out: dict) -> None:
    print(f"\nper-site budget @ {out['resolution']}px b={out['batch']} "
          f"f={out['frames']} on {out['card']} ({out['power_limit_w']} W); "
          f"floors: {Roofline.h100().name} roofline, K10 calibration")
    print(f"{'site':<22}{'count':>6}{'wall ms':>10}{'kernel ms':>11}"
          f"{'floor':>9}{'act/floor':>10}{'host':>7}")
    for r in out["site_table"]:
        host = "-" if r["host_share"] is None else f"{r['host_share']:.2f}"
        kern = "-" if r["kernel_ms"] is None else f"{r['kernel_ms']:.3f}"
        print(f"{r['site']:<22}{r['count']:>6}{r['wall_ms']:>10.3f}"
              f"{kern:>11}{r['floor_ms']:>9.3f}{r['act_floor']:>10.2f}"
              f"{host:>7}")
    print(f"{'SUM of isolated sites':<22}{'':>6}{out['site_sum_ms']:>10.3f}")
    kern = out["step_kernel_ms"]
    kern = "-" if kern is None else f"{kern:.3f}"
    print(f"{'whole UNet call':<22}{'':>6}{out['step_ms']:>10.3f}"
          f"{kern:>11}{out['floor_sum_ms']:>9.3f}"
          f"{out['step_over_floor']:>10.2f}")
    print(f"whole call / isolated sites: {out['step_over_sites']:.3f}",
          flush=True)


if __name__ == "__main__":
    main()
