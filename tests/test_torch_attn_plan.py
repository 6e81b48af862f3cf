"""The attention forward kernels' host-side plans, and the GEGLU kernels'
LayerNorm, on the CPU.

K1 / K6 (``ops/kernels/swat_attention.py``) and K2
(``ops/kernels/flash_attention.py``) are Hopper kernels whose CTAs hold a
few 64-row query tiles, one a consumer warpgroup (``plan``: consumer
warpgroups per CTA; ``cta_tiles``: which tiles, the kernel's own map).
These tests pin, without a card:

- ``covers`` and ``plan`` take every shape the site gates
  (``ops/attention.py``: the flash gate of ``dot_product_attention``, the
  window gate of ``WindowTemporalAttention``) send them at the UNet's head
  dims, at 256 and 512 px, for sampling (CFG batch 2), training (batch 1)
  and the sequence-parallel shards (whole videos of half the batch*heads,
  11 frames), and refuse what no kernel takes;
- the CTA split covers every (query tile, window, batch*head) exactly
  once;
- the LayerNorm of the GEGLU up kernel's plain version (``_layer_norm``,
  the formula and rounding points the kernel keeps) matches the JAX
  package's LayerNorm in fp32.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seervideoldm_tpu_torch.ops.kernels import flash_attention as F
from seervideoldm_tpu_torch.ops.kernels import geglu_ff as G
from seervideoldm_tpu_torch.ops.kernels import swat_attention as S
from seervideoldm_tpu_torch.ops.windows import select_window_size

jnorms = importlib.import_module("seervideoldm_tpu.ops.norms")

torch.set_num_threads(1)

HEADS = 8
HEAD_DIMS = (40, 80, 160, 160)          # block_out 320 / 640 / 1280 / 1280
# (batch, frames a rank's per-frame attention sees, frames of a whole
# video, seq ranks, model ranks) of the attention sites: sampling (CFG 2,
# 12 frames), training (1, 12), both under {seq: 2} at 11 frames (6 and 5
# a rank per frame; the window kernels on whole videos of half the
# batch*heads), and both under {model: 2} (half the heads a rank)
PATHS = {"sampling": (2, (12,), 12, 1, 1), "training": (1, (12,), 12, 1, 1),
         "parallel sampling": (2, (6, 5), 11, 2, 1),
         "parallel training": (1, (6, 5), 11, 2, 1),
         "tensor-parallel sampling": (2, (12,), 12, 1, 2),
         "tensor-parallel training": (1, (12,), 12, 1, 2)}


def _latents(resolution: int):
    """The (h, w) of each UNet level's latent at a resolution."""
    side = resolution // 8
    return [side >> level for level in range(4)]


def _site_shapes():
    """(kernel, shape args) of every site gate that reaches K1 or K2."""
    out = []
    for res in (256, 512):
        for level, side in enumerate(_latents(res)):
            d = HEAD_DIMS[level]
            for b, local, f, ranks, model in PATHS.values():
                heads = HEADS // model
                n = side * side
                # spatial self-attention: the flash gate (n, m >= 512)
                if n >= 512:
                    out += [("flash", (b * fl * heads, n, n, d, False))
                            for fl in local]
                ws = select_window_size(side)
                if ws is not None and ws >= 8 and side % ws == 0:
                    out.append(("swat", (b * heads // ranks, f, side, side, d,
                                         ws)))
    return out


@pytest.mark.parametrize("kernel,args", _site_shapes())
def test_plan_and_covers_take_every_gated_site(kernel, args):
    if kernel == "flash":
        batch, n, m, d, causal = args
        assert F.covers(n, m, d, causal)
        p = F.plan(batch, n, m, d, causal)
        assert p["tiles"] == -(-n // 64)
        groups = -(-p["tiles"] // p["cwg"])
        assert p["ctas"] == batch * groups
    else:
        bh, f, h, w, d, ws = args
        assert S.covers(f, h, w, d, ws)
        p = S.plan(bh, f, h, w, d)
        assert p["tiles"] == f and p["windows"] == (h // 8) * (w // 8)
        groups = -(-f // p["cwg"])
        assert p["ctas"] == bh * p["windows"] * groups
    assert p["cwg"] in F.cwg_choices(d)
    # the most warpgroups that fill the card, else the most CTAs
    if p["ctas"] < F.SMS:
        assert p["cwg"] == min(F.cwg_choices(d))


def test_the_gates_reach_the_main_path_shapes():
    """The shapes the card checks (chip_smoke.py KERNEL_CASES) are among
    the gated ones: K2 over 1024 and 4096 tokens, K1 at 32 and 64 px."""
    shapes = _site_shapes()
    assert ("flash", (192, 1024, 1024, 40, False)) in shapes
    assert ("flash", (96, 1024, 1024, 40, False)) in shapes
    assert ("flash", (192, 4096, 4096, 40, False)) in shapes
    assert ("flash", (192, 1024, 1024, 80, False)) in shapes
    assert ("swat", (16, 12, 32, 32, 40, 8)) in shapes
    assert ("swat", (8, 12, 32, 32, 40, 8)) in shapes
    assert ("swat", (8, 11, 32, 32, 40, 8)) in shapes
    assert ("swat", (4, 11, 32, 32, 40, 8)) in shapes
    # under {model: 2}: half the heads (training: K2 at 48, K1 at 4)
    assert ("flash", (48, 1024, 1024, 40, False)) in shapes
    assert ("swat", (4, 12, 32, 32, 40, 8)) in shapes
    assert ("swat", (16, 12, 64, 64, 40, 8)) in shapes
    assert ("swat", (16, 12, 32, 32, 80, 8)) in shapes


@pytest.mark.parametrize("args", [
    (1024, 1024, 44, False),   # d not a multiple of 8
    (1024, 1024, 168, False),  # d above 160
    (1024, 512, 40, True),     # causal with n != m
    (0, 1024, 40, False),
])
def test_flash_covers_refuses(args):
    assert not F.covers(*args)


@pytest.mark.parametrize("args", [
    (12, 32, 32, 40, 4),       # ws 4
    (12, 36, 32, 40, 8),       # h not whole windows
    (12, 32, 32, 36, 8),       # d not a multiple of 8
    (12, 32, 32, 168, 8),      # d above 160
])
def test_swat_covers_refuses(args):
    assert not S.covers(*args)


def test_warpgroup_counts_fit_the_register_split():
    """Three consumer warpgroups only up to d_pad 128: a tile's O, S and P
    in 152 registers a thread (csrc/attn_fwd_hopper.cuh::cwg_ok)."""
    assert F.cwg_choices(40) == F.cwg_choices(128) == (3, 2)
    assert F.cwg_choices(136) == F.cwg_choices(160) == (2,)


@pytest.mark.parametrize("cwg", [2, 3])
@pytest.mark.parametrize("tiles", list(range(1, 70)))
def test_cta_split_covers_every_tile_once(tiles, cwg):
    groups = -(-tiles // cwg)
    seen = [t for g in range(groups) for t in F.cta_tiles(tiles, cwg, g)]
    assert sorted(t for t in seen if t is not None) == list(range(tiles))
    # the slots past the last tile are the grid's last ones
    assert all(t is None for t in seen[tiles:])
    assert None not in seen[:tiles]


def test_windows_times_frames_cover_the_volume():
    """Every (frame, window, batch*head) of a SWAT launch belongs to
    exactly one CTA of the grid (groups, windows, bh)."""
    bh, f, h, w, d = 4, 11, 32, 48, 40
    p = S.plan(bh, f, h, w, d)
    groups = -(-f // p["cwg"])
    owner = {}
    for z in range(bh):
        for y in range(p["windows"]):
            for x in range(groups):
                for t in F.cta_tiles(f, p["cwg"], x):
                    if t is not None:
                        assert (t, y, z) not in owner
                        owner[(t, y, z)] = (x, y, z)
    assert len(owner) == f * p["windows"] * bh


@pytest.mark.parametrize("n,c,seed", [(64, 320, 0), (128, 64, 1), (32, 640, 2)])
def test_layer_norm_matches_jax_in_fp32(n, c, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, c) * 2.0 + 0.5).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.randn(c)).astype(np.float32)
    beta = (0.1 * rng.randn(c)).astype(np.float32)
    ln = jnorms.LayerNorm(eps=G.LN_EPS)
    want = ln.apply({"params": {"scale": jnp.asarray(gamma),
                                "bias": jnp.asarray(beta)}}, jnp.asarray(x))
    got = G._layer_norm(torch.from_numpy(x), torch.from_numpy(gamma),
                        torch.from_numpy(beta))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-6)


def test_layer_norm_statistics_do_not_depend_on_the_order():
    """The mean and centred variance are fp64 sums rounded once: on bf16
    inputs a permutation of the channels gives the same statistics, so the
    kernel's warp-order sums and torch's give the same normalised row."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(16, 320).astype(np.float32)).bfloat16()
    gamma, beta = torch.ones(320), torch.zeros(320)
    perm = torch.from_numpy(rng.permutation(320))
    a = G._layer_norm(x, gamma, beta)
    b = G._layer_norm(x[:, perm], gamma, beta)
    assert torch.equal(a[:, perm], b)
