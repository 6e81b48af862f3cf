"""The attention backward kernels' host-side plans, on the CPU.

K8 (``ops/kernels/flash_attention.py``) and K7 / K9
(``ops/kernels/swat_attention.py``) are two Hopper kernels each, a dq
kernel and a dk/dv kernel, whose CTAs hold a few 64-row tiles, one a
consumer warpgroup (``bwd_plan``: consumer warpgroups and CTAs of each;
``bwd_layout``: a CTA's shared memory; ``bwd_cta_tiles``: the kernels' own
map from a CTA to the tiles it owns and visits, held against the CUDA
source's on the card).  These tests pin, without a card:

- the plans take every shape the training path's site gates send the
  backward (``ops/attention.py``: the flash gate, n, m >= 512; the window
  gate of ``WindowTemporalAttention``) at 256 and 512 px, single-rank and
  under ``{seq: 2}``, and every backward case ``chip_smoke.py`` checks on
  the card;
- every instantiation's shared memory, its four ring stages in, fits a
  CTA's 227 KB;
- each grid visits every (query tile, key tile) pair its mask keeps exactly
  once, per unit, and when causal starts with the CTAs that have the most
  tiles;
- uncovered head dims (above 80, not a multiple of 8) are refused.
"""
import pytest

import chip_smoke as cs
from seervideoldm_tpu_torch.ops.kernels import flash_attention as F
from seervideoldm_tpu_torch.ops.kernels import swat_attention as S
from seervideoldm_tpu_torch.ops.windows import select_window_size

HEADS = 8
HEAD_DIMS = (40, 80, 160, 160)          # block_out 320 / 640 / 1280 / 1280
# (batch, frames a rank's per-frame attention sees, frames of a whole
# video, seq ranks, model ranks) of the training paths: single rank (batch
# 1, 12 frames), {seq: 2} at 11 frames, and {model: 2} (half the heads a
# rank)
PATHS = {"training": (1, (12,), 12, 1, 1),
         "parallel training": (1, (6, 5), 11, 2, 1),
         "tensor-parallel training": (1, (12,), 12, 1, 2)}


def _training_sites():
    """(kernel, shape args) of every site gate of the training paths that
    reaches K7, K8 or K9 (a backward kernel runs where its forward does)."""
    out = []
    for res in (256, 512):
        side = res // 8
        for level in range(4):
            d, s = HEAD_DIMS[level], side >> level
            for b, local, f, ranks, model in PATHS.values():
                heads = HEADS // model
                if s * s >= 512:
                    out += [("flash", (b * fl * heads, s * s, s * s, d))
                            for fl in local]
                ws = select_window_size(s)
                if ws is not None and ws >= 8 and s % ws == 0:
                    out.append(("swat", (b * heads // ranks, f, s, s, d)))
    return out


def _case_shapes():
    """(kernel, shape args) of every backward case of chip_smoke.py."""
    out = []
    for _, make, args in cs.KERNEL_CASES:
        if make is cs.case_flash_bwd:
            batch, n, d = args[:3]
            causal = len(args) > 3 and args[3]
            m = args[4] if len(args) > 4 else n
            out.append(("flash", (batch, n, m, d, causal)))
        elif make in (cs.case_swat_bwd, cs.case_swat6_bwd):
            batch, f, h, d = args[:4]
            out.append(("swat", (batch, f, h, h, d)))
    return out


def _check_plan(p: dict) -> None:
    for kind in ("dq", "dkv"):
        e = p[kind]
        d_ok = e["cwg"] in F.bwd_cwg_choices(p["d"], kind == "dkv")
        assert d_ok, (kind, e)
        assert F.bwd_layout(p["d"], e["cwg"], kind == "dkv") <= F.SMEM_MAX
        tiles = p["qtiles"] if kind == "dq" else p["ktiles"]
        assert e["ctas"] == p["units"] * -(-tiles // e["cwg"])


def _plan(kernel: str, args: tuple) -> dict:
    if kernel == "flash":
        batch, n, m, d = args[:4]
        causal = len(args) > 4 and args[4]
        p = F.bwd_plan(batch, -(-n // 64), -(-m // 64), d, causal)
    else:
        batch, f, h, w, d = args
        p = S.swat_bwd_plan(batch, f, h, w, d)
        assert p["units"] == batch * (h // 8) * (w // 8)
        assert p["qtiles"] == p["ktiles"] == f and p["causal"]
    return dict(p, d=d)


@pytest.mark.parametrize("kernel,args", sorted(set(_training_sites())))
def test_plans_take_every_gated_training_site(kernel, args):
    d = args[-1]
    assert d <= F.BWD_MAX_D  # the c = 1280 sites stay plain
    if kernel == "flash":
        assert F.covers(*args[1:3], d)
    else:
        assert S.covers(*args[1:], 8)
    _check_plan(_plan(kernel, args))


@pytest.mark.parametrize("kernel,args", _case_shapes())
def test_plans_take_every_backward_case_of_the_card_checks(kernel, args):
    _check_plan(_plan(kernel, args))


def test_the_card_checks_reach_the_main_backward_shapes():
    """The backward cases the card holds include K7 at (8, 12, 32, 32, 40
    | 80) and (8, 12, 64, 64, 40), K8 at (96, 1024 | 4096, 40), (96, 1024,
    80), (16, 1024, 40) causal and (12, 1000 x 712, 40), K9 at (4, 11,
    32, 32, 40) and (8, 12, 32, 32, 40 | 80), and under {model: 2} K7 at
    (4, 12, 32, 32, 40) and K8 at (48, 1024, 40)."""
    shapes = _case_shapes()
    for want in [("swat", (8, 12, 32, 32, 40)), ("swat", (8, 12, 32, 32, 80)),
                 ("swat", (8, 12, 64, 64, 40)), ("swat", (4, 11, 32, 32, 40)),
                 ("flash", (96, 1024, 1024, 40, False)),
                 ("flash", (96, 4096, 4096, 40, False)),
                 ("flash", (96, 1024, 1024, 80, False)),
                 ("flash", (16, 1024, 1024, 40, True)),
                 ("flash", (12, 1000, 712, 40, False)),
                 ("swat", (4, 12, 32, 32, 40)),
                 ("flash", (48, 1024, 1024, 40, False))]:
        assert want in shapes, want
    sites = _training_sites()
    assert ("flash", (48, 1024, 1024, 40)) in sites
    assert ("swat", (4, 12, 32, 32, 40)) in sites
    assert ("flash", (96, 1024, 1024, 40)) in sites
    assert ("swat", (8, 12, 32, 32, 40)) in sites
    assert ("swat", (4, 11, 32, 32, 40)) in sites


@pytest.mark.parametrize("d", list(range(8, 81, 8)))
@pytest.mark.parametrize("dkv", [False, True])
def test_every_instantiation_fits_shared_memory(d, dkv):
    """Each layout fits; the bytes are those the CUDA source reported for
    its instantiation on the card (chip_smoke.py phase 2)."""
    assert F.BWD_STAGES == 4
    reported = {(64, 3, False): 115968, (64, 2, False): 99584,
                (64, 2, True): 103680, (128, 2, False): 197888,
                (128, 2, True): 201984}
    for cwg in F.bwd_cwg_choices(d, dkv):
        nbytes = F.bwd_layout(d, cwg, dkv)
        assert nbytes <= F.SMEM_MAX
        assert nbytes == reported[(64 if d <= 64 else 128, cwg, dkv)]


def _visits(p: dict, kind: str) -> tuple:
    """{(unit, query tile, key tile): times} over the whole grid of one
    kernel, and the tiles each CTA streams, in launch order."""
    seen, streamed = {}, []
    for block in range(p[kind]["ctas"]):
        unit, own, visited = F.bwd_cta_tiles(p, kind, block)
        streamed.append(len(visited))
        for t in own:
            for u in visited:
                qt, kt = (t, u) if kind == "dq" else (u, t)
                if p["causal"] and kt > qt:
                    continue  # the consumer skips tiles above the diagonal
                seen[(unit, qt, kt)] = seen.get((unit, qt, kt), 0) + 1
    return seen, streamed


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tiles", [1, 2, 3, 5, 11, 12, 16])
@pytest.mark.parametrize("d", [40, 80])
def test_grids_visit_every_tile_pair_once_heaviest_first(causal, tiles, d):
    units = 3
    p = F.bwd_plan(units, tiles, tiles, d, causal)
    want = {(u, qt, kt) for u in range(units) for qt in range(tiles)
            for kt in range(tiles) if not causal or kt <= qt}
    for kind in ("dq", "dkv"):
        seen, streamed = _visits(p, kind)
        assert set(seen) == want and set(seen.values()) == {1}, kind
        if causal:
            assert streamed == sorted(streamed, reverse=True), kind
        else:
            assert len(set(streamed)) == 1, kind


def test_ragged_flash_grid_covers_n_not_m():
    """n != m (1000 x 712): 16 query tiles and 12 key tiles, every pair
    once."""
    p = F.bwd_plan(2, 16, 12, 40)
    want = {(u, qt, kt) for u in range(2) for qt in range(16)
            for kt in range(12)}
    for kind in ("dq", "dkv"):
        seen, _ = _visits(p, kind)
        assert set(seen) == want and set(seen.values()) == {1}, kind


def test_warpgroups_follow_the_register_budget():
    """The dq kernel takes three consumer warpgroups at d_pad 64 (160
    registers a thread), two at d_pad 128; the dk/dv kernel two always
    (two accumulators in 240), and the plan takes three where they fill
    the card."""
    assert F.bwd_cwg_choices(40, False) == F.bwd_cwg_choices(64, False) == (3, 2)
    assert F.bwd_cwg_choices(72, False) == F.bwd_cwg_choices(80, False) == (2,)
    assert F.bwd_cwg_choices(40, True) == F.bwd_cwg_choices(80, True) == (2,)
    assert F.bwd_plan(96, 16, 16, 40)["dq"]["cwg"] == 3
    assert F.bwd_plan(1, 2, 2, 40)["dq"]["cwg"] == 2  # too few CTAs for 3


@pytest.mark.parametrize("d", [84, 88, 96, 160, 44, 36, 0])
def test_uncovered_head_dims_are_refused(d):
    with pytest.raises(ValueError):
        F.bwd_layout(d, 2, False)
    with pytest.raises(ValueError):
        F.bwd_plan(4, 16, 16, d)


def test_uncovered_warpgroup_counts_are_refused():
    with pytest.raises(ValueError):
        F.bwd_layout(40, 3, True)   # dk/dv: two only
    with pytest.raises(ValueError):
        F.bwd_layout(80, 3, False)  # dq at d_pad 128: two only
