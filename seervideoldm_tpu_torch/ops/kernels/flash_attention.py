"""K2 and K8: fused flash attention and its backward (CUDA C++,
``csrc/flash_attention.cu``).

Replaces ``seervideoldm_tpu/ops/pallas/flash_attention.py``:
``flash_attention`` (forward; the single-shot and streamed TPU forms
alike) and ``_flash_backward`` (with ``_bwd_einsum`` beyond kv = 4096).  On
the H100 both are tensor-core bound at the main-path shapes.  The forward
streams K/V in 64-key tiles through shared memory with an online softmax,
because 227 KB cannot hold the whole K/V row the TPU kept in VMEM; when a
gradient is needed it also writes the rows' log-sum-exp, so the backward
recomputes the probabilities exactly, tile by tile, in two kernels without
atomics (see the source notes).  Both are Hopper kernels (wgmma fed by a
TMA ring, ``csrc/attn_fwd_hopper.cuh`` and ``attn_bwd_hopper.cuh``);
``plan`` picks how many consumer warpgroups a forward CTA has, each
holding one 64-row query tile, and ``cta_tiles`` is the kernel's map from
a CTA to its query tiles; ``bwd_plan`` and ``bwd_cta_tiles`` are the same
for the backward's dq and dk/dv kernels.

The wrapper runs the plain version for CPU tensors and the kernels for
CUDA tensors; there is no other path.  Where a gradient is needed both go
through ``FlashAttentionFn`` (on CPU tensors its explicit plain forward and
backward), so that the CPU path has the CUDA path's autograd structure and
``remat: save_attn`` (``ops/remat.py``) keeps the forward's output and lse
on either.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..remat import needs_grad, saved_site
from . import build

NEG_INF = torch.finfo(torch.float32).min
BWD_MAX_D = 80  # csrc/attn_bwd_hopper.cuh
FWD_MAX_D = 160  # csrc/attn_fwd_hopper.cuh: d % 8 == 0, padded to 64/128/192
TILE = 64        # query rows / keys of a tile (SWAT: one window frame)
SMS = 132        # H100 SXM streaming multiprocessors


def cta_tiles(tiles: int, cwg: int, group: int) -> list:
    """The query tiles CTA ``group`` holds, one a consumer warpgroup (None
    past the last tile): the kernel's own map, for the tests."""
    return [t if t < tiles else None
            for t in range(group * cwg, (group + 1) * cwg)]


def cwg_choices(d: int) -> tuple:
    """Consumer warpgroups per CTA the forward kernels are built for at
    head dim ``d``, in the plan's order of preference: three where a
    tile's O, S and P fit their 152 registers a thread (d_pad <= 128),
    else two (``csrc/attn_fwd_hopper.cuh::cwg_ok``)."""
    return (3, 2) if d <= 128 else (2,)


def choose_cwg(d: int, ctas_at) -> int:
    """The plan's rule for K1, K2 and K6: the first of ``cwg_choices(d)``
    that gives every SM a CTA, else the one with the most CTAs (two).
    ``ctas_at(cwg)`` is the CTA count."""
    options = cwg_choices(d)
    full = [c for c in options if ctas_at(c) >= SMS]
    return full[0] if full else min(options)


def covers(n: int, m: int, d: int, causal: bool = False) -> bool:
    """Whether the K2 forward kernel takes (n, m, d): d a multiple of 8 up
    to 160, causal only with n == m."""
    return (n > 0 and m > 0 and 0 < d <= FWD_MAX_D and d % 8 == 0
            and (not causal or n == m))


@functools.lru_cache(maxsize=None)
def plan(batch: int, n: int, m: int, d: int, causal: bool = False) -> dict:
    """The K2 launch for one covered shape: ``cwg`` consumer warpgroups
    per CTA, each one 64-row query tile (``choose_cwg``), ``ctas`` = batch
    x ceil(tiles / cwg)."""
    tiles = -(-n // TILE)
    ctas = lambda c: batch * -(-tiles // c)  # noqa: E731
    cwg = choose_cwg(d, ctas)
    return {"cwg": cwg, "ctas": ctas(cwg), "tiles": tiles}


SMEM_MAX = 227 * 1024   # csrc/attn_fwd_hopper.cuh: a CTA's shared memory
SMEM_FIXED = 1024 + 256  # alignment slack, barriers
BOX = 64 * 128           # one 64-row x 64-column bf16 box
BWD_STAGES = 4           # csrc/attn_bwd_hopper.cuh::Plan::STAGES


def bwd_cwg_choices(d: int, dkv: bool) -> tuple:
    """Consumer warpgroups per CTA the backward kernels are built for at
    head dim ``d`` (``csrc/attn_bwd_hopper.cuh::cwg_ok``), in the plan's
    order of preference: the dq kernel three where d_pad is 64 (one
    accumulator in 160 registers a thread), else two; the dk/dv kernel
    two (two accumulators in 240).  A ValueError for a head dim no
    instantiation takes (not a multiple of 8, above BWD_MAX_D)."""
    if not (0 < d <= BWD_MAX_D and d % 8 == 0):
        raise ValueError(f"no backward instantiation for d={d}")
    return (3, 2) if not dkv and d <= 64 else (2,)


def bwd_layout(d: int, cwg: int, dkv: bool) -> int:
    """Dynamic shared memory bytes of a CTA of the backward kernels, as
    ``csrc/attn_bwd_hopper.cuh::Plan`` lays it out: the consumers' own
    tiles (dq: Q and G, dk/dv: K and V), then BWD_STAGES ring stages (dq: K
    and V; dk/dv: Q, G and a 1024-byte block of lse and delta)."""
    if cwg not in bwd_cwg_choices(d, dkv):
        raise ValueError(f"no backward instantiation for d={d}, cwg={cwg}")
    tile = (64 if d <= 64 else 128) // 64 * BOX
    stage = 2 * tile + (1024 if dkv else 0)
    return SMEM_FIXED + 2 * cwg * tile + BWD_STAGES * stage


@functools.lru_cache(maxsize=None)
def bwd_plan(units: int, qtiles: int, ktiles: int, d: int,
             causal: bool = False) -> dict:
    """The backward's two launches for one covered shape: ``units`` CTA
    columns (flash: batch; SWAT: windows x batch), ``qtiles`` query and
    ``ktiles`` key tiles of 64 rows each.  For the dq and the dk/dv kernel:
    ``cwg`` (the first of ``bwd_cwg_choices`` that gives every SM a CTA,
    else the one with the most CTAs) and ``ctas`` (a one-dimensional grid:
    ``bwd_cta_tiles``)."""
    out = {}
    for kind, tiles in (("dq", qtiles), ("dkv", ktiles)):
        ctas = lambda c, t=tiles: units * -(-t // c)  # noqa: E731
        options = bwd_cwg_choices(d, kind == "dkv")
        full = [c for c in options if ctas(c) >= SMS]
        cwg = full[0] if full else min(options)
        out[kind] = {"cwg": cwg, "ctas": ctas(cwg)}
    out.update(units=units, qtiles=qtiles, ktiles=ktiles, causal=causal)
    return out


def bwd_cta_tiles(plan: dict, kind: str, block: int) -> tuple:
    """(unit, own tiles, visited tiles) of CTA ``block`` of the dq
    (``kind`` "dq": own = query tiles, visited = key tiles) or dk/dv kernel
    ("dkv": own = key tiles, visited = query tiles): the kernels' own map
    (``csrc/attn_bwd_hopper.cuh::cta_tiles``, held against this one on the
    card through ``bwd_cta_source``), for the tests.  The grid is
    group-major; when causal, the groups with the most visited tiles come
    first (dq: the last query tiles; dk/dv: the first key tiles).  A
    consumer whose own tile is t visits, when causal, key tiles 0..t (dq)
    or query tiles t..qtiles-1 (dk/dv)."""
    units, cwg = plan["units"], plan[kind]["cwg"]
    own_n = plan["qtiles"] if kind == "dq" else plan["ktiles"]
    groups = -(-own_n // cwg)
    gi, unit = divmod(block, units)
    group = groups - 1 - gi if kind == "dq" and plan["causal"] else gi
    own = [t for t in range(group * cwg, (group + 1) * cwg) if t < own_n]
    if kind == "dq":
        end = min(own[-1] + 1, plan["ktiles"]) if plan["causal"] else \
            plan["ktiles"]
        visited = list(range(end))
    else:
        visited = list(range(group * cwg if plan["causal"] else 0,
                             plan["qtiles"]))
    return unit, own, visited


_LIB = None


def _lib():
    """The loaded ``csrc/flash_attention.cu`` library, its C signatures set
    once."""
    global _LIB
    if _LIB is None:
        lib = build.load("flash_attention")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.svl_flash_attention_fwd.argtypes = [ptr] * 5 + [i32] * 4 + [
            ctypes.c_float, i32, i32, ptr]
        lib.svl_flash_attention_fwd.restype = i32
        lib.svl_flash_attention_bwd.argtypes = [ptr] * 9 + [i32] * 4 + [
            ctypes.c_float, i32, i32, i32, ptr]
        lib.svl_flash_attention_bwd.restype = i32
        lib.svl_attn_fwd_smem.argtypes = [i32] * 2 + [ctypes.POINTER(i32)]
        lib.svl_attn_fwd_smem.restype = i32
        lib.svl_attn_bwd_smem.argtypes = [i32] * 3
        lib.svl_attn_bwd_smem.restype = i32
        lib.svl_attn_bwd_cta.argtypes = [i32] * 7 + [ctypes.POINTER(i32)]
        lib.svl_attn_bwd_cta.restype = None
        _LIB = lib
    return _LIB


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """fp32 arithmetic, fp64 for fp64 inputs (gradient checks)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, causal: bool = False) -> torch.Tensor:
    """The einsum branch of ``dot_product_attention``: fp32 logits and
    softmax, probabilities cast to v's dtype for the product."""
    acc = _acc_dtype(q)
    logits = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    if causal:
        n, m = logits.shape[-2:]
        keep = torch.ones(n, m, dtype=torch.bool, device=q.device).tril(m - n)
        logits = logits.masked_fill(~keep, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def attention_bwd_f32(q, k, v, g, scale: float, causal: bool):
    """dq, dk, dv of softmax(q k^T * scale) v by recomputation, as explicit
    formulas in fp32 (``_bwd_einsum``; causal = top-left tril, key <=
    query).  Outputs stay fp32."""
    acc = _acc_dtype(q)
    q32, k32, v32, g32 = (t.to(acc) for t in (q, k, v, g))
    logits = torch.matmul(q32, k32.transpose(-1, -2)) * scale
    if causal:
        n, m = logits.shape[-2:]
        keep = torch.ones(n, m, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), g32)
    dp = torch.matmul(g32, v32.transpose(-1, -2))
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    return (torch.matmul(ds, k32), torch.matmul(ds.transpose(-1, -2), q32), dv)


def flash_attention_bwd_plain(q, k, v, g, scale: float, causal: bool = False):
    """``_bwd_einsum``: (dq, dk, dv) cast to the inputs' dtypes."""
    dq, dk, dv = attention_bwd_f32(q, k, v, g, scale, causal)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def fwd_smem(d: int, cwg: int) -> tuple:
    """(dynamic shared memory bytes, ring stages) of a CTA of the forward
    kernels (K1, K2, K6) at head dim ``d`` with ``cwg`` consumer
    warpgroups, as the CUDA source lays it out (needs the built library)."""
    stages = ctypes.c_int(0)
    nbytes = _lib().svl_attn_fwd_smem(d, cwg, ctypes.byref(stages))
    if nbytes < 0:
        raise ValueError(f"no forward instantiation for d={d}, cwg={cwg}")
    return nbytes, stages.value


def bwd_smem(d: int, cwg: int, dkv: bool) -> int:
    """``bwd_layout`` as the built CUDA source computes it (needs the
    library)."""
    nbytes = _lib().svl_attn_bwd_smem(d, cwg, int(dkv))
    if nbytes < 0:
        raise ValueError(f"no backward instantiation for d={d}, cwg={cwg}")
    return nbytes


def bwd_cta_source(plan: dict, kind: str, block: int) -> tuple:
    """``bwd_cta_tiles`` as the built CUDA source computes it (needs the
    library): the map the backward kernels run."""
    out = (ctypes.c_int * 5)()
    _lib().svl_attn_bwd_cta(block, plan[kind]["cwg"], int(kind == "dkv"),
                            plan["units"], plan["qtiles"], plan["ktiles"],
                            int(plan["causal"]), out)
    unit, own, own_end, vis, vis_end = out
    return unit, list(range(own, own_end)), list(range(vis, vis_end))


def _check_cuda(q, k, v, causal: bool, what: str):
    n, d = q.shape[-2:]
    m = k.shape[-2]
    if causal and n != m:
        raise ValueError(f"{what}: causal needs n == m")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what}: kernel takes bf16, got {q.dtype}")
    if not covers(n, m, d, causal):
        raise ValueError(f"{what}: head dim {d} not covered "
                         f"(multiple of 8, at most {FWD_MAX_D})")
    return n, m, d


def _launch_fwd(qf, kf, vf, scale: float, causal: bool, want_lse: bool,
                cwg: int = None):
    """The K2 launch on folded contiguous (B, n, d) / (B, m, d) bf16 CUDA
    tensors, ``cwg`` from ``plan`` unless given.  Returns (out, lse or
    None); lse (B, n) fp32, log2 domain."""
    batch, n, d = qf.shape
    m = kf.shape[1]
    if cwg is None:
        cwg = plan(batch, n, m, d, causal)["cwg"]
    out = torch.empty_like(qf)
    lse = (torch.empty(batch, n, dtype=torch.float32, device=qf.device)
           if want_lse else None)
    lib = _lib()
    code = lib.svl_flash_attention_fwd(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(),
        lse.data_ptr() if want_lse else None, batch, n, m, d, float(scale),
        int(causal), cwg, build.stream_of(qf))
    build.check(lib, code, "flash_attention")
    flash_attention.launches += 1
    return out, lse


def flash_attention_bwd(q, k, v, lse, g, scale: float, causal: bool = False,
                        need=(True, True, True)):
    """K8 on CUDA tensors: q/g (B, n, d), k/v (B, m, d) bf16, ``lse`` (B, n)
    fp32 as the forward wrote it.  Returns (dq, dk, dv); an entry is None
    where ``need`` is false and its kernel could be skipped."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    _, _, d = _check_cuda(q, k, v, causal, "flash_attention_bwd")
    if d > BWD_MAX_D:
        raise ValueError(f"flash_attention_bwd: head dim {d} not covered by "
                         f"the backward kernel (at most {BWD_MAX_D})")
    q, k, v, g = (t.contiguous() for t in (q, k, v, g))
    return _launch_bwd(q, k, v, lse.contiguous(), g, scale, causal, need)


def _launch_bwd(q, k, v, lse, g, scale: float, causal: bool, need,
                cwg: tuple = None):
    """The K8 launches on contiguous checked CUDA tensors, ``cwg`` (dq,
    dk/dv) from ``bwd_plan`` unless given."""
    batch, n, d = q.shape
    m = k.shape[1]
    if cwg is None:
        p = bwd_plan(batch, -(-n // TILE), -(-m // TILE), d, causal)
        cwg = (p["dq"]["cwg"], p["dkv"]["cwg"])
    need_kv = need[1] or need[2]
    dq = torch.empty_like(q) if need[0] else None
    dk = torch.empty_like(k) if need_kv else None
    dv = torch.empty_like(v) if need_kv else None
    delta = torch.empty(batch, n, dtype=torch.float32, device=q.device)
    lib = _lib()
    opt = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    code = lib.svl_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), opt(dq), opt(dk), opt(dv), batch,
        n, m, d, float(scale), int(causal), cwg[0], cwg[1],
        build.stream_of(q))
    build.check(lib, code, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """softmax(q k^T * scale) v on folded (B, n, d) / (B, m, d) tensors.
    With ``kernel`` (default: on CUDA tensors) the K2 forward and the K8
    backward, saving q, k, v and lse; otherwise the plain forward and
    its explicit backward, saving q, k, v.  The forward's outputs are a
    saved site under ``remat: save_attn`` (``ops/remat.py``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, kernel=None):
        ctx.scale, ctx.causal = float(scale), bool(causal)
        ctx.kernel = q.device.type == "cuda" if kernel is None else kernel
        if ctx.kernel:
            out, lse = saved_site(lambda: _launch_fwd(q, k, v, scale, causal,
                                                      want_lse=True))
            ctx.save_for_backward(q, k, v, lse)
        else:
            if causal and q.shape[-2] != k.shape[-2]:
                raise ValueError("flash_attention: causal needs n == m")
            out, = saved_site(lambda: (flash_attention_plain(q, k, v, scale,
                                                             causal),))
            ctx.save_for_backward(q, k, v)
        return out

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:3]
        if ctx.kernel:
            q, k, v, lse = ctx.saved_tensors
            dq, dk, dv = flash_attention_bwd(q, k, v, lse, g, ctx.scale,
                                             ctx.causal, need)
        else:
            q, k, v = ctx.saved_tensors
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, g, ctx.scale,
                                                   ctx.causal)
        grads = [t if keep else None for t, keep in zip((dq, dk, dv), need)]
        return (*grads, None, None, None)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, causal: bool = False) -> torch.Tensor:
    """``flash_attention_plain`` as an attention site, on any device:
    through ``FlashAttentionFn``'s plain branch when a gradient is needed,
    a saved site either way.  (A causal n != m call keeps plain autograd:
    the explicit backward covers the top-left mask only.)"""
    if needs_grad(q, k, v):
        if causal and q.shape[-2] != k.shape[-2]:
            return flash_attention_plain(q, k, v, scale, causal)
        return FlashAttentionFn.apply(q, k, v, scale, causal, False)
    return saved_site(lambda: (flash_attention_plain(q, k, v, scale,
                                                     causal),))[0]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, causal: bool = False) -> torch.Tensor:
    """softmax(q k^T * scale) v.  q: (..., n, d), k/v: (..., m, d); leading
    dims fold.  Causal = top-left tril (key <= query)."""
    if q.device.type == "cpu":
        return plain_attention(q, k, v, scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    n, m, d = _check_cuda(q, k, v, causal, "flash_attention")
    lead = q.shape[:-2]
    qf = q.reshape(-1, n, d).contiguous()
    kf = k.reshape(-1, m, d).contiguous()
    vf = v.reshape(-1, m, d).contiguous()
    if needs_grad(qf, kf, vf):
        if d > BWD_MAX_D:
            raise ValueError(f"flash_attention: head dim {d} has no backward "
                             f"kernel (at most {BWD_MAX_D})")
        out = FlashAttentionFn.apply(qf, kf, vf, scale, causal)
    else:
        out, = saved_site(lambda: _launch_fwd(qf, kf, vf, scale, causal,
                                              want_lse=False)[:1])
    return out.reshape(*lead, n, d)


flash_attention.launches = 0
flash_attention_bwd.launches = 0
