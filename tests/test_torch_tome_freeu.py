"""Token Merging (``ops/tome.py``) and FreeU (``ops/freeu.py``) in the port
against the JAX package on the CPU, fp32.

- ``_dst_src_indices`` equals JAX's for (32, 32), (64, 64) (whose seed
  needs the 32-bit mask) and (12, 20), sd 2 and 3;
- merge and unmerge against JAX's closures (1e-5) on features whose
  merge decisions have a margin the test asserts (bf16 features, fp32
  sums: a near tie could rank differently under another summation
  order);
- ``fourier_filter`` and ``apply_freeu`` (1e-5);
- one SeerUNet call with ``tome_ratio`` 0.5 and one with ``freeu``
  against the JAX UNet with the same knobs (1e-4), each moved away from
  the call without its knob;
- the attention gate sees the merged length: a 32 x 32 text block sends
  512 tokens to the flash kernel's wrapper at ratio 0.5, 717 at 0.3, and
  410 at 0.6 to the plain path (the JAX gate's n >= 512).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seervideoldm_tpu.ops import freeu as jfreeu
from seervideoldm_tpu.ops import tome as jtome
from seervideoldm_tpu_torch.ops import attention, freeu, tome

from test_torch_samplers import _t, inputs, tiny_unets

torch.set_num_threads(1)


@pytest.mark.parametrize("hw", [(32, 32), (64, 64), (12, 20)])
@pytest.mark.parametrize("sd", [2, 3])
def test_dst_src_indices_match_jax(hw, sd):
    got, want = tome._dst_src_indices(*hw, sd), jtome._dst_src_indices(*hw, sd)
    for a, b in zip(got, want):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    dst, src = got
    assert len(dst) + len(src) == hw[0] * hw[1]


def _margins(metric, h, w, r, sd):
    """What decides the merge, in fp32 from bf16 features as both sides
    compute it: the gap at the top-r cut of the sources' best-match
    scores, and the smallest gap between a merged source's best and
    second-best match."""
    mn = metric / (np.linalg.norm(metric, axis=-1, keepdims=True) + 1e-6)
    mn = np.asarray(jnp.asarray(mn).astype(jnp.bfloat16).astype(jnp.float32))
    dst, src = tome._dst_src_indices(h, w, sd)
    scores = np.einsum("bic,bjc->bij", mn[:, src], mn[:, dst])
    top2 = np.sort(scores, axis=-1)[..., -2:]
    order = np.argsort(-top2[..., 1], axis=-1)
    best = np.take_along_axis(top2[..., 1], order, axis=-1)
    second = np.take_along_axis(top2[..., 0], order, axis=-1)
    cut = float((best[:, r - 1] - best[:, r]).min())
    match = float((best[:, :r] - second[:, :r]).min())
    return cut, match


def _by_rows(a):
    """Rows in a fixed order (by their first two channels)."""
    return np.stack([b[np.lexsort((b[:, 1], b[:, 0]))] for b in a])


@pytest.mark.parametrize("h,w,ratio,sd", [(8, 8, 0.5, 2), (16, 12, 0.3, 2),
                                          (12, 12, 0.5, 3)])
def test_merge_unmerge_match_jax(h, w, ratio, sd):
    """Which sources merge into which destination is held where it is
    decided with a margin: each side's fp32 sum of C = 48 exact bf16
    products lies within C * 2^-24 of the true score (unit vectors), so
    two orders differ by less than 2 C 2^-24 = 5.7e-6.  Then the destination
    rows of the merge and the round trip ``unmerge(merge(x))`` exactly, and
    the kept rows as a set (their order follows the sorted scores, whose
    neighbours lie closer than any margin)."""
    rng = np.random.RandomState(h * w)
    metric = rng.randn(2, h * w, 48).astype(np.float32)
    x = rng.randn(2, h * w, 40).astype(np.float32)
    r = int(ratio * h * w)
    cut, match = _margins(metric, h, w, r, sd)
    margin = 2 * metric.shape[-1] * 2.0 ** -24
    assert cut > margin and match > margin, (cut, match, margin)
    jm, ju = jtome.bipartite_soft_matching_2d(jnp.asarray(metric), h, w, r, sd)
    m, u = tome.bipartite_soft_matching_2d(_t(metric), h, w, r, sd)
    want_m = np.asarray(jm(jnp.asarray(x)))
    got_m = m(_t(x)).numpy()
    assert got_m.shape == want_m.shape == (2, h * w - r, 40)
    n_unm = h * w - r - len(tome._dst_src_indices(h, w, sd)[0])
    np.testing.assert_allclose(got_m[:, n_unm:], want_m[:, n_unm:], atol=1e-5)
    np.testing.assert_allclose(_by_rows(got_m[:, :n_unm]),
                               _by_rows(want_m[:, :n_unm]), atol=1e-5)
    np.testing.assert_allclose(
        u(m(_t(x))).numpy(), np.asarray(ju(jm(jnp.asarray(x)))), atol=1e-5)
    assert tome.bipartite_soft_matching_2d(_t(metric), h, w, 0) == (None, None)


@pytest.mark.parametrize("threshold,scale", [(1, 0.9), (2, 0.2), (5, 1.5)])
def test_fourier_filter_and_freeu_match_jax(threshold, scale):
    rng = np.random.RandomState(threshold)
    x = rng.randn(2, 3, 8, 6, 16).astype(np.float32)
    res = rng.randn(2, 3, 8, 6, 8).astype(np.float32)
    np.testing.assert_allclose(
        freeu.fourier_filter(_t(x), threshold, scale).numpy(),
        np.asarray(jfreeu.fourier_filter(jnp.asarray(x), threshold, scale)),
        atol=1e-5)
    got = freeu.apply_freeu(_t(x), _t(res), 1.6, scale, threshold)
    want = jfreeu.apply_freeu(jnp.asarray(x), jnp.asarray(res), 1.6, scale,
                              threshold)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-5)


@pytest.mark.parametrize("knobs", [
    dict(tome_ratio=0.5, tome_min_tokens=64),
    dict(freeu=(1.5, 1.6, 0.9, 0.2)),
], ids=["tome", "freeu"])
def test_unet_call_with_knob_matches_jax(knobs):
    jm, params, port = tiny_unets(3, **knobs)
    x_T, x0, ctx, _ = inputs(20)
    x = np.concatenate([x0, x_T], axis=1)
    t = np.array([600, 250], np.int32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                               jnp.asarray(t), jnp.asarray(ctx), 0))
    _, _, plain = tiny_unets(3)
    with torch.no_grad():
        got = port(_t(x), torch.from_numpy(t), _t(ctx))
        off = plain(_t(x), torch.from_numpy(t), _t(ctx))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    assert not torch.allclose(got, off, atol=1e-3)


@pytest.mark.parametrize("ratio,n,route", [(0.5, 512, "flash"),
                                           (0.3, 717, "flash"),
                                           (0.6, 410, "plain")])
def test_attention_gate_sees_merged_length(monkeypatch, ratio, n, route):
    from seervideoldm_tpu_torch.models.transformer3d import \
        BasicTextTransformerBlock3D

    seen = []
    for name in ("flash_attention", "plain_attention"):
        real = getattr(attention, name)

        def spy(q, *a, _name=name, _real=real, **k):
            seen.append((_name.split("_")[0], q.shape[-2]))
            return _real(q, *a, **k)

        monkeypatch.setattr(attention, name, spy)
    torch.manual_seed(0)
    block = BasicTextTransformerBlock3D(8, 1, 8, context_dim=8).eval()
    x = torch.randn(1, 1, 32, 32, 8)
    with torch.no_grad():
        block(x, context=None, tome=(ratio, 1024, 2))
    assert seen == [(route, n)]
