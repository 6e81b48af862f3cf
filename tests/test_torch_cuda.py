"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip on a host without a GPU (the kernels have no
interpret mode).  On a machine with an H100 (``--noconftest``: the
repository's conftest sets up JAX, which that machine need not have):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Small shapes of each kernel's main-path form, bf16 inputs from a seed,
tolerance 2e-2 abs + 2e-2 rel on bf16 outputs (as ``chip_smoke.py``); K1,
K2 and K6 also at the training and sequence-parallel paths' shapes; for
the backward kernels (K7, K8) the same bound and a relative L2 error of at
most 1e-2 on each of dq, dk, dv, at odd shapes: n not a multiple of 64,
n != m, a fully masked tail tile, a non-contiguous ``grad_output``, d =
80; and K7, K8, K9 within 1e-3 relative L2, the fp32 precision of p and
dS the TPU bodies keep, and bit-equal over two calls (deterministic).  K3-K5 also
as their two halves, the up and the down kernel, each alone.  K6 and K9 (the
pre-rotated and in-kernel-trig modes of the SWAT kernels) the same, with
``rot_dim`` 0 and 32.  K10 (the softmax calibration): the final scores and
the row sums within 1e-5 relative of its plain version, from 0 passes up.
K11 (GroupNorm + SiLU), by ``ops/kernels/group_norm.py``'s own checks:
the moments within 1e-5 of fp64, the apply kernel bit for bit the plain
apply on the kernel's moments, every output within one bf16 ulp before the
SiLU of the plain chain's, at every channel count the port uses;
``GroupNormFn``'s gradients equal the plain halves'.
The evaluation scorers (I3D, C3D, the CLIP ViT; plain PyTorch ops in fp32)
on the card against the CPU within 1e-3 relative L2.  ZeRO-1 and FSDP on 2
gloo ranks sharing the card against the replicated run, with the gathered
weights feeding the kernels.
"""
import pytest
import torch

pytestmark = pytest.mark.cuda

ATOL = RTOL = 2e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from seervideoldm_tpu_torch.utils.device import set_numerics

    set_numerics()
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(
        torch.bfloat16)


def _close(got, want):
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs()
    assert bool((err <= ATOL + RTOL * want.float().abs()).all()), float(err.max())


@pytest.mark.parametrize("d", [40, 80])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel(gen, d, causal):
    from seervideoldm_tpu_torch.ops.kernels import flash_attention as K

    q, k, v = (_randn(gen, 6, 700, d) for _ in range(3))
    before = K.flash_attention.launches
    got = K.flash_attention(q, k, v, d ** -0.5, causal)
    assert K.flash_attention.launches == before + 1
    _close(got, K.flash_attention_plain(q, k, v, d ** -0.5, causal))


@pytest.mark.parametrize("d", [40, 80])
def test_swat_kernel(gen, d):
    from seervideoldm_tpu_torch.ops.kernels import swat_attention as K
    from seervideoldm_tpu_torch.ops.rotary import rotary_tables

    q, k, v = (_randn(gen, 4, 3, 16, 24, d) for _ in range(3))
    cos, sin = rotary_tables(3, 16, 24, d, min(32, d), device="cuda")
    got = K.swat_attention_tables(q, k, v, cos, sin, d ** -0.5, True, 8)
    _close(got, K.swat_attention_tables_plain(q, k, v, cos, sin, d ** -0.5,
                                              True, 8))


@pytest.mark.parametrize("shape,rot_dim,grad", [
    ((8, 12, 32, 32, 40), None, True),   # K1, the training path
    ((8, 11, 32, 32, 40), 0, False),     # K6, a {seq: 2} sampling shard
    ((4, 11, 32, 32, 40), 0, True),      # K6, a {seq: 2} training shard
])
def test_swat_kernel_path_shapes(gen, shape, rot_dim, grad):
    """K1 / K6 at the shapes the training and the sequence-parallel paths
    give them, called as they call them (under a gradient: the lse-writing
    launch of the autograd.Function)."""
    from seervideoldm_tpu_torch.ops.kernels import swat_attention as K
    from seervideoldm_tpu_torch.ops.rotary import rotary_tables

    _, f, h, w, d = shape
    q, k, v = (_randn(gen, *shape).requires_grad_(grad) for _ in range(3))
    with torch.set_grad_enabled(grad):
        if rot_dim is None:
            cos, sin = rotary_tables(f, h, w, d, min(32, d), device="cuda")
            got = K.swat_attention_tables(q, k, v, cos, sin, d ** -0.5, True, 8)
            want = K.swat_attention_tables_plain(q, k, v, cos, sin, d ** -0.5,
                                                 True, 8)
        else:
            got = K.swat_attention(q, k, v, d ** -0.5, True, 8, rot_dim)
            want = K.swat_attention_plain(q, k, v, d ** -0.5, True, 8, rot_dim)
    assert (got.grad_fn is not None) == grad
    _close(got.detach(), want.detach())


@pytest.mark.parametrize("batch,n,d,grad", [
    (96, 1024, 40, True),    # the training path
    (80, 1024, 40, False),   # a {seq: 2} sampling shard's 5 frames
    (12, 1000, 40, False),   # a ragged tail: n not a multiple of 64
])
def test_flash_kernel_path_shapes(gen, batch, n, d, grad):
    from seervideoldm_tpu_torch.ops.kernels import flash_attention as K

    q, k, v = (_randn(gen, batch, n, d).requires_grad_(grad) for _ in range(3))
    with torch.set_grad_enabled(grad):
        got = K.flash_attention(q, k, v, d ** -0.5)
    assert (got.grad_fn is not None) == grad
    _close(got.detach(), K.flash_attention_plain(q.detach(), k.detach(),
                                                 v.detach(), d ** -0.5))


def _geglu_inputs(gen, n, c):
    inner = 4 * c
    x = _randn(gen, n, c)
    w1, b1 = _randn(gen, 2 * inner, c, scale=c ** -0.5), _randn(gen, 2 * inner)
    w2, b2 = _randn(gen, c, inner, scale=inner ** -0.5), _randn(gen, c)
    gamma = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(c, generator=gen, device="cuda")
    w3, b3 = _randn(gen, c, c, scale=c ** -0.5), _randn(gen, c)
    return x, gamma, beta, w1, b1, w2, b2, w3, b3, _randn(gen, n, c)


# K3-K5 (each an up and a down kernel): the narrow and full UNet widths,
# the training path's token counts (2560, 3072 at c = 640; 10240 at c =
# 320), and the widest c mode 0 takes
@pytest.mark.parametrize("mode,c,n", [(0, 64, 512), (0, 640, 512),
                                      (1, 320, 512), (2, 128, 512),
                                      (0, 640, 2560), (0, 640, 3072),
                                      (0, 704, 512), (1, 320, 10240)])
def test_geglu_kernel(gen, mode, c, n):
    from seervideoldm_tpu_torch.ops.kernels import geglu_ff as K

    x, gamma, beta, w1, b1, w2, b2, w3, b3, res = _geglu_inputs(gen, n, c)
    if mode == 0:
        got, want = K.geglu_ff(x, w1, b1, w2, b2), K.geglu_ff_plain(
            x, w1, b1, w2, b2)
    elif mode == 1:
        got = K.ln_geglu_ff(x, gamma, beta, w1, b1, w2, b2)
        want = K.ln_geglu_ff_plain(x, gamma, beta, w1, b1, w2, b2)
    else:
        got = K.ln_geglu_ff_proj(x, gamma, beta, w1, b1, w2, b2, w3, b3, res)
        want = K.ln_geglu_ff_proj_plain(x, gamma, beta, w1, b1, w2, b2, w3,
                                        b3, res)
    _close(got, want)


@pytest.mark.parametrize("mode,c", [(0, 640), (1, 320), (2, 320), (2, 64)])
def test_geglu_halves_kernel(gen, mode, c):
    """The up and down kernels alone against their plain versions (the
    down kernel fed the plain ``a``)."""
    from seervideoldm_tpu_torch.ops.kernels import geglu_ff as K

    x, gamma, beta, w1, b1, w2, b2, w3, b3, res = _geglu_inputs(gen, 1024, c)
    a = K.geglu_up_plain(x, gamma, beta, w1, b1, mode > 0)
    _close(K.geglu_up(x, gamma, beta, w1, b1, mode > 0), a)
    _close(K.geglu_down(a, w2, b2, x, w3, b3, res, mode),
           K.geglu_down_plain(a, w2, b2, x, w3, b3, res, mode))


@pytest.mark.parametrize("rows,reps", [(256, 0), (256, 1), (256, 2),
                                       (256, 4), (256, 64), (37, 16),
                                       (200, 3)])
def test_softmax_calib_kernel(gen, rows, reps):
    """K10 against its plain version on an input that spans +-150 (an exp
    without the max subtraction overflows there): the final s element by
    element and the row sums, each within 1e-5 relative (the sums: of the
    rows' sum of |s|, which is the sum itself once a pass has run).  fp32
    both sides; exp2f and one reciprocal per row against exp and a
    division, sums in another order."""
    from seervideoldm_tpu_torch.ops.kernels import softmax_calib as K

    x = torch.randn(rows, K.CALIB_COLS, generator=gen, device="cuda") * 30
    before = K.softmax_calib.launches
    got, got_s = K.softmax_calib(x, reps, return_s=True)
    assert K.softmax_calib.launches == before + 1
    want, want_s = K.softmax_calib_plain(x, reps, return_s=True)
    torch.cuda.synchronize()
    assert got.shape == (rows, 1) and torch.isfinite(got_s).all()
    assert bool(((got_s - want_s).abs() <= 1e-5 * want_s.abs()).all())
    scale = want_s.abs().sum(1, keepdim=True)
    assert bool(((got - want).abs() <= 1e-5 * scale).all())
    torch.testing.assert_close(K.softmax_calib(x, reps), got, rtol=0, atol=0)
    with pytest.raises(ValueError, match="not covered"):
        K.softmax_calib(x[:, :1024].contiguous(), reps)


def test_kernel_refuses_uncovered_shape(gen):
    from seervideoldm_tpu_torch.ops.kernels import flash_attention as K

    q = _randn(gen, 2, 600, 36)  # head dim not a multiple of 8
    with pytest.raises(ValueError, match="not covered"):
        K.flash_attention(q, q, q, 0.1)


# ------------------------------------------------------- backward (K7, K8)

def _close_bwd(got, want):
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert torch.isfinite(g).all(), name
        g32, w32 = g.float(), w.float()
        err = (g32 - w32).abs()
        assert bool((err <= ATOL + RTOL * w32.abs()).all()), (
            name, float(err.max()))
        assert float((g32 - w32).norm() / w32.norm()) <= 1e-2, name


@pytest.mark.parametrize("n,m,d,causal", [
    (700, 700, 40, False),   # n not a multiple of 64
    (700, 700, 80, True),    # causal, ragged last tile, d = 80
    (1000, 712, 40, False),  # n != m
    (520, 65, 40, False),    # a key tile with one live key: 63 masked
    (64, 64, 16, True),      # one tile, narrow head
])
def test_flash_bwd_kernel(gen, n, m, d, causal):
    from seervideoldm_tpu_torch.ops.kernels import flash_attention as K

    q, g = _randn(gen, 5, n, d), _randn(gen, 5, n, d)
    k, v = _randn(gen, 5, m, d), _randn(gen, 5, m, d)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    before = K.flash_attention_bwd.launches
    out = K.flash_attention(qa, ka, va, d ** -0.5, causal)
    assert out.grad_fn is not None
    out.backward(g)
    assert K.flash_attention_bwd.launches == before + 1
    want = K.flash_attention_bwd_plain(q, k, v, g, d ** -0.5, causal)
    _close_bwd((qa.grad, ka.grad, va.grad), want)


def test_flash_bwd_noncontiguous_grad_and_heads_layout(gen):
    """The gradient autograd hands back through ``merge_heads`` is a
    transposed view; q/k/v come as (b, H, n, d) views of (b, n, H*d)."""
    from seervideoldm_tpu_torch.ops.attention import merge_heads, split_heads
    from seervideoldm_tpu_torch.ops.kernels import flash_attention as K

    x = [_randn(gen, 2, 576, 4 * 40).requires_grad_() for _ in range(3)]
    q, k, v = (split_heads(t, 4) for t in x)
    w = _randn(gen, 2, 576, 160)
    (merge_heads(K.flash_attention(q, k, v, 40 ** -0.5)) * w).sum().backward()
    ref = [t.detach().clone().requires_grad_() for t in x]
    qr, kr, vr = (split_heads(t, 4) for t in ref)
    (merge_heads(K.flash_attention_plain(qr, kr, vr, 40 ** -0.5)) * w
     ).sum().backward()
    _close_bwd([t.grad for t in x], [t.grad for t in ref])


def test_flash_bwd_skips_unneeded_and_refuses_wide_heads(gen):
    from seervideoldm_tpu_torch.ops.kernels import flash_attention as K

    q, k, v = (_randn(gen, 3, 512, 40) for _ in range(3))
    qa = q.clone().requires_grad_()
    K.flash_attention(qa, k, v, 0.2).sum().backward()  # dq only
    want = K.flash_attention_bwd_plain(q, k, v, torch.ones_like(q), 0.2)
    _close_bwd((qa.grad,), want[:1])
    wide = _randn(gen, 2, 512, 160).requires_grad_()
    with pytest.raises(ValueError, match="no backward kernel"):
        K.flash_attention(wide, wide, wide, 0.1)
    with torch.no_grad():  # the forward alone still covers d = 160
        assert K.flash_attention(wide, wide, wide, 0.1).shape == wide.shape


@pytest.mark.parametrize("shape,causal", [
    ((4, 3, 16, 24, 40), True), ((2, 5, 8, 16, 80), True),
    ((3, 2, 8, 8, 16), False)])
def test_swat_bwd_kernel(gen, shape, causal):
    from seervideoldm_tpu_torch.ops.kernels import swat_attention as K
    from seervideoldm_tpu_torch.ops.rotary import rotary_tables

    _, f, h, w, d = shape
    q, k, v, g = (_randn(gen, *shape) for _ in range(4))
    cos, sin = rotary_tables(f, h, w, d, min(32, d), device="cuda")
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    before = K.swat_attention_tables_bwd.launches
    out = K.swat_attention_tables(qa, ka, va, cos, sin, d ** -0.5, causal, 8)
    assert out.grad_fn is not None
    # a non-contiguous grad_output: a permuted view of another layout
    g_view = g.permute(0, 1, 3, 2, 4).contiguous().permute(0, 1, 3, 2, 4)
    assert not g_view.is_contiguous() or h == w
    out.backward(g_view)
    assert K.swat_attention_tables_bwd.launches == before + 1
    want = K.swat_attention_tables_bwd_plain(q, k, v, cos, sin, g, d ** -0.5,
                                             causal, 8)
    _close_bwd((qa.grad, ka.grad, va.grad), want)


@pytest.mark.parametrize("shape,rot_dim,causal", [
    ((4, 3, 16, 24, 40), 0, True), ((4, 3, 16, 24, 40), 32, True),
    ((2, 5, 8, 16, 80), 32, True), ((3, 2, 8, 8, 16), 0, False)])
def test_swat_k6_k9_kernels(gen, shape, rot_dim, causal):
    """K6 forward against its plain version, then K9 through the
    ``autograd.Function`` against the plain backward."""
    from seervideoldm_tpu_torch.ops.kernels import swat_attention as K

    d = shape[-1]
    q, k, v, g = (_randn(gen, *shape) for _ in range(4))
    before = K.swat_attention.launches
    with torch.no_grad():
        got = K.swat_attention(q, k, v, d ** -0.5, causal, 8, rot_dim)
    assert K.swat_attention.launches == before + 1
    _close(got, K.swat_attention_plain(q, k, v, d ** -0.5, causal, 8, rot_dim))
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    before = K.swat_attention_bwd.launches
    out = K.swat_attention(qa, ka, va, d ** -0.5, causal, 8, rot_dim)
    assert out.grad_fn is not None
    out.backward(g)
    assert K.swat_attention_bwd.launches == before + 1
    want = K.swat_attention_bwd_plain(q, k, v, g, d ** -0.5, causal, 8,
                                      rot_dim)
    _close_bwd((qa.grad, ka.grad, va.grad), want)


@pytest.mark.parametrize("kernel", ["K8", "K7", "K9 rot_dim 0",
                                    "K9 rot_dim 32"])
def test_backward_keeps_fp32_precision(gen, kernel):
    """dq, dk, dv within 1e-3 relative L2 of the fp32 plain backward.  The
    TPU bodies keep p and dS in fp32 for p^T g, dS k and dS^T q, and form
    delta = rowsum(p * dp) in fp32.  The kernels of PRs 2-5 rounded p and
    dS to bf16 as tensor-core operands and took delta from the bf16
    forward output: 2.6e-3 to 2.8e-3 at every backward case, which this
    bound fails.  With p and dS as bf16 hi + lo pairs and delta from p and
    dp, what is left is the rounding of the outputs to bf16 (about 1e-4);
    the common 1e-2 bound of the other tests stays as it is."""
    from seervideoldm_tpu_torch.ops.kernels import flash_attention as KF
    from seervideoldm_tpu_torch.ops.kernels import swat_attention as KS
    from seervideoldm_tpu_torch.ops.rotary import rotary_tables

    if kernel == "K8":
        q, k, v, g = (_randn(gen, 8, 1024, 40) for _ in range(4))
        fwd = lambda a, b, c: KF.flash_attention(a, b, c, 40 ** -0.5)  # noqa: E731
        want = KF.flash_attention_bwd_plain(q, k, v, g, 40 ** -0.5)
    elif kernel == "K7":
        q, k, v, g = (_randn(gen, 4, 12, 32, 32, 40) for _ in range(4))
        cos, sin = rotary_tables(12, 32, 32, 40, 32, device="cuda")
        fwd = lambda a, b, c: KS.swat_attention_tables(  # noqa: E731
            a, b, c, cos, sin, 40 ** -0.5, True, 8)
        want = KS.swat_attention_tables_bwd_plain(q, k, v, cos, sin, g,
                                                  40 ** -0.5, True, 8)
    else:
        rot = int(kernel.split()[-1])
        q, k, v, g = (_randn(gen, 4, 11, 32, 32, 40) for _ in range(4))
        fwd = lambda a, b, c: KS.swat_attention(  # noqa: E731
            a, b, c, 40 ** -0.5, True, 8, rot)
        want = KS.swat_attention_bwd_plain(q, k, v, g, 40 ** -0.5, True, 8,
                                           rot)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    fwd(qa, ka, va).backward(g)
    torch.cuda.synchronize()
    for got, ref, name in zip((qa.grad, ka.grad, va.grad), want,
                              ("dq", "dk", "dv")):
        rel = float((got.float() - ref.float()).norm() / ref.float().norm())
        assert rel <= 1e-3, (name, rel)


@pytest.mark.parametrize("kernel", ["K8", "K8 causal", "K7", "K9 rot_dim 0",
                                    "K9 rot_dim 32"])
def test_backward_is_deterministic(gen, kernel):
    """Two backward calls on the same inputs give bit-equal dq, dk, dv: no
    atomics, every output element written once by one thread, and the
    sums in one fixed order (csrc/attn_bwd_hopper.cuh)."""
    from seervideoldm_tpu_torch.ops.kernels import flash_attention as KF
    from seervideoldm_tpu_torch.ops.kernels import swat_attention as KS
    from seervideoldm_tpu_torch.ops.rotary import rotary_tables

    if kernel.startswith("K8"):
        causal = kernel.endswith("causal")
        q, k, v, g = (_randn(gen, 6, 1000, 40) for _ in range(4))
        _, lse = KF._launch_fwd(q, k, v, 40 ** -0.5, causal, want_lse=True)
        call = lambda: KF.flash_attention_bwd(  # noqa: E731
            q, k, v, lse, g, 40 ** -0.5, causal)
    elif kernel == "K7":
        q, k, v, g = (_randn(gen, 2, 12, 32, 32, 40) for _ in range(4))
        cos, sin = rotary_tables(12, 32, 32, 40, 32, device="cuda")
        _, lse = KS._launch_fwd(q, k, v, cos, sin, 40 ** -0.5, True, 8,
                                want_lse=True)
        call = lambda: KS.swat_attention_tables_bwd(  # noqa: E731
            q, k, v, cos, sin, lse, g, 40 ** -0.5, True, 8)
    else:
        rot = int(kernel.split()[-1])
        q, k, v, g = (_randn(gen, 2, 11, 32, 32, 40) for _ in range(4))
        _, lse = KS._launch_swat_fwd(q, k, v, 40 ** -0.5, True, 8, rot,
                                     want_lse=True)
        call = lambda: KS.swat_attention_bwd(  # noqa: E731
            q, k, v, lse, g, 40 ** -0.5, True, 8, rot)
    first = call()
    second = call()
    torch.cuda.synchronize()
    for a, b, name in zip(first, second, ("dq", "dk", "dv")):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("d", [16, 40, 64, 80])
def test_backward_layout_matches_the_source(gen, d):
    """The host lays out a backward CTA's shared memory as the CUDA source
    does, for every instantiation."""
    from seervideoldm_tpu_torch.ops.kernels import flash_attention as K

    for dkv in (False, True):
        for cwg in K.bwd_cwg_choices(d, dkv):
            assert K.bwd_smem(d, cwg, dkv) == K.bwd_layout(d, cwg, dkv)


@pytest.mark.parametrize("qtiles,ktiles,causal", [
    (1, 1, False), (1, 1, True), (5, 5, False), (5, 5, True),
    (12, 12, False), (12, 12, True), (16, 12, False)])
@pytest.mark.parametrize("d", [40, 80])
def test_backward_grid_matches_the_source(gen, qtiles, ktiles, causal, d):
    """``bwd_cta_tiles``, the map the CPU tests hold, is the one the CUDA
    kernels run (``csrc/attn_bwd_hopper.cuh::cta_tiles``), for every CTA of
    both kernels."""
    from seervideoldm_tpu_torch.ops.kernels import flash_attention as K

    p = K.bwd_plan(3, qtiles, ktiles, d, causal)
    for kind in ("dq", "dkv"):
        for block in range(p[kind]["ctas"]):
            assert K.bwd_cta_source(p, kind, block) == K.bwd_cta_tiles(
                p, kind, block), (kind, block)


def test_swat_k6_refuses_odd_rot_dim_and_wide_backward(gen):
    from seervideoldm_tpu_torch.ops.kernels import swat_attention as K

    q = _randn(gen, 1, 2, 8, 8, 40)
    with pytest.raises(ValueError, match="rot_dim"):
        K.swat_attention(q, q, q, 0.1, True, 8, 5)
    wide = _randn(gen, 1, 2, 8, 8, 160).requires_grad_()
    with pytest.raises(ValueError, match="no backward kernel"):
        K.swat_attention(wide, wide, wide, 0.1, True, 8, 0)


def test_geglu_wrappers_carry_grad_fn(gen):
    """On CUDA tensors a wrapper's result has a ``grad_fn`` when a gradient
    is required, and the frozen weights get none."""
    from seervideoldm_tpu_torch.ops.kernels import geglu_ff as K

    n, c, inner = 512, 64, 256
    x = _randn(gen, n, c).requires_grad_()
    w1, b1 = _randn(gen, 2 * inner, c, scale=c ** -0.5), _randn(gen, 2 * inner)
    w2, b2 = _randn(gen, c, inner, scale=inner ** -0.5), _randn(gen, c)
    gamma = (1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
             ).requires_grad_()
    beta = 0.1 * torch.randn(c, generator=gen, device="cuda")
    out = K.ln_geglu_ff(x, gamma, beta, w1, b1, w2, b2)
    assert out.grad_fn is not None
    g = _randn(gen, n, c)
    out.backward(g)
    xr = x.detach().clone().requires_grad_()
    gr = gamma.detach().clone().requires_grad_()
    K.ln_geglu_ff_plain(xr, gr, beta, w1, b1, w2, b2).backward(g)
    torch.cuda.synchronize()
    assert torch.equal(x.grad, xr.grad) and torch.equal(gamma.grad, gr.grad)
    assert w1.grad is None and beta.grad is None


def test_no_grad_leaves_sampling_launch_counts_unchanged(gen):
    """Under ``torch.no_grad()`` nothing is saved and no backward kernel
    can run: one SeerUNet call launches what it launched before the
    wrappers had ``autograd.Function``s, even with trainable weights."""
    from seervideoldm_tpu_torch.models.unet3d import SeerUNet, SeerUNetConfig
    from seervideoldm_tpu_torch.ops.kernels import flash_attention as fa
    from seervideoldm_tpu_torch.ops.kernels import geglu_ff as gg
    from seervideoldm_tpu_torch.ops.kernels import swat_attention as sw
    from seervideoldm_tpu_torch.utils.device import cast_for_compute

    cfg = SeerUNetConfig(block_out_channels=(64, 128), layers_per_block=1,
                         norm_num_groups=8, cross_attention_dim=64,
                         attention_head_dim=2)
    with torch.device("cuda"):
        unet = cast_for_compute(SeerUNet(cfg), torch.bfloat16)
    x = _randn(gen, 2, 12, 32, 32, 4)
    ctx = _randn(gen, 2, 12, 77, 64)
    ts = torch.tensor([500, 500], device="cuda")
    fns = (sw.swat_attention_tables, fa.flash_attention, gg.ln_geglu_ff,
           gg.ln_geglu_ff_proj, gg.geglu_ff, sw.swat_attention_tables_bwd,
           fa.flash_attention_bwd)

    def counts(grad):
        for p in unet.parameters():
            p.requires_grad_(grad)
        for fn in fns:
            fn.launches = 0
        with torch.no_grad():
            out = unet(x, ts, ctx)
        torch.cuda.synchronize()
        assert out.grad_fn is None
        return [fn.launches for fn in fns]

    frozen, trainable = counts(False), counts(True)
    assert frozen == trainable
    assert frozen[0] > 0 and frozen[1] > 0 and frozen[3] > 0
    assert frozen[5] == frozen[6] == 0


def test_remat_equals_no_remat_on_the_card(gen):
    """``remat: True`` (non-reentrant checkpoint around each top-level block)
    through the kernels' ``autograd.Function``s: the recomputed forward
    launches the forward kernels a second time and the gradients are those
    of the plain run (the kernels are deterministic: no atomics)."""
    import copy

    from seervideoldm_tpu_torch.models.unet3d import SeerUNet, SeerUNetConfig
    from seervideoldm_tpu_torch.ops.kernels import flash_attention as fa
    from seervideoldm_tpu_torch.ops.kernels import swat_attention as sw
    from seervideoldm_tpu_torch.utils.device import cast_for_compute

    cfg = SeerUNetConfig(block_out_channels=(64, 128), layers_per_block=1,
                         norm_num_groups=8, cross_attention_dim=64,
                         attention_head_dim=2)
    with torch.device("cuda"):
        plain = cast_for_compute(SeerUNet(cfg), torch.bfloat16)
    remat = copy.deepcopy(plain)
    remat.remat = True
    x = _randn(gen, 1, 12, 32, 32, 4)
    ctx = _randn(gen, 1, 12, 77, 64)
    ts = torch.tensor([400], device="cuda")

    def run(model):
        params = [p for n, p in model.named_parameters()
                  if "temporal_attentions" in n]
        for p in model.parameters():
            p.requires_grad_(False)
        for p in params:
            p.requires_grad_(True)
        for fn in (sw.swat_attention_tables, sw.swat_attention_tables_bwd,
                   fa.flash_attention, fa.flash_attention_bwd):
            fn.launches = 0
        loss = model(x, ts, ctx, cond_frame=2)[:, 2:].float().pow(2).mean()
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        return (float(loss.detach()), grads, sw.swat_attention_tables.launches,
                sw.swat_attention_tables_bwd.launches)

    loss_a, grads_a, fwd_a, bwd_a = run(plain)
    loss_b, grads_b, fwd_b, bwd_b = run(remat)
    assert loss_a == loss_b
    assert bwd_a == bwd_b > 0 and fwd_b == 2 * fwd_a
    for ga, gb in zip(grads_a, grads_b):
        assert torch.equal(ga, gb)


def _card_vs_cpu(build, x):
    """A module built on the CPU in fp32 from a seed, run there and on the
    card (fp32, TF32 off) on the same input: relative L2 of the outputs."""
    import copy

    torch.manual_seed(0)
    cpu = build().eval()
    card = copy.deepcopy(cpu).cuda()
    with torch.no_grad():
        want = cpu(x)
        got = card(x.cuda()).cpu()
    assert torch.isfinite(got).all()
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("scorer", ["i3d", "c3d", "clip_vit"])
def test_eval_scorers_card_vs_cpu(gen, scorer):
    """The eval path's scorers (plain PyTorch ops, fp32) on the card
    against the CPU: relative L2 <= 1e-3 on the logits / features."""
    from seervideoldm_tpu_torch.evaluation import c3d, clip_sim, i3d

    g = torch.Generator().manual_seed(1)
    if scorer == "i3d":
        x = torch.rand(1, 3, 9, 224, 224, generator=g) * 2 - 1
        rel = _card_vs_cpu(i3d.InceptionI3d, x)
    elif scorer == "c3d":
        x = torch.rand(1, 16, 128, 160, 3, generator=g) * 2 - 1
        rel = _card_vs_cpu(c3d.C3D, x)
    else:
        cfg = clip_sim.CLIPVisionConfig(num_hidden_layers=4)
        x = clip_sim.preprocess_frames(torch.rand(2, 256, 256, 3, generator=g),
                                       cfg.image_size)
        rel = _card_vs_cpu(lambda: clip_sim.CLIPVisionModel(cfg), x)
    assert rel <= 1e-3, rel


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4", "K5"])
def test_serving_shapes(gen, kernel):
    """K1-K5 at the shapes a batch of ``configs/serve.yaml`` gives them
    (256 px, 12 frames, ``serve_max_batch`` 4: CFG batch 8), no gradient,
    against their plain versions."""
    from seervideoldm_tpu_torch.ops.kernels import flash_attention as FA
    from seervideoldm_tpu_torch.ops.kernels import geglu_ff as G
    from seervideoldm_tpu_torch.ops.kernels import swat_attention as SW
    from seervideoldm_tpu_torch.ops.rotary import rotary_tables

    with torch.no_grad():
        if kernel == "K1":
            q, k, v = (_randn(gen, 64, 12, 32, 32, 40) for _ in range(3))
            cos, sin = rotary_tables(12, 32, 32, 40, 32, device="cuda")
            got = SW.swat_attention_tables(q, k, v, cos, sin, 40 ** -0.5,
                                           True, 8)
            want = SW.swat_attention_tables_plain(q, k, v, cos, sin,
                                                  40 ** -0.5, True, 8)
        elif kernel == "K2":
            q, k, v = (_randn(gen, 768, 1024, 40) for _ in range(3))
            got = FA.flash_attention(q, k, v, 40 ** -0.5)
            want = FA.flash_attention_plain(q, k, v, 40 ** -0.5)
        else:
            n, c = (24576, 640) if kernel == "K5" else (98304, 320)
            x, gamma, beta, w1, b1, w2, b2, w3, b3, res = _geglu_inputs(
                gen, n, c)
            if kernel == "K5":
                got = G.geglu_ff(x, w1, b1, w2, b2)
                want = G.geglu_ff_plain(x, w1, b1, w2, b2)
            elif kernel == "K3":
                got = G.ln_geglu_ff(x, gamma, beta, w1, b1, w2, b2)
                want = G.ln_geglu_ff_plain(x, gamma, beta, w1, b1, w2, b2)
            else:
                got = G.ln_geglu_ff_proj(x, gamma, beta, w1, b1, w2, b2, w3,
                                         b3, res)
                want = G.ln_geglu_ff_proj_plain(x, gamma, beta, w1, b1, w2,
                                                b2, w3, b3, res)
    _close(got, want)


def test_adamw_8bit_step_card_vs_cpu(gen):
    """Two 8-bit AdamW updates on CUDA tensors against the same updates on
    the CPU: the int8 codes equal, the scales and parameters within 1e-6
    (separate fp32 elementwise kernels on both sides; the final
    ``p - lr * u`` may fuse into one rounding on either)."""
    from seervideoldm_tpu_torch.training.optim8bit import adamw_8bit

    shapes = {"w": (1280, 640), "b": (700,), "n": (3, 5)}
    cpu = {k: torch.randn(s, generator=torch.Generator().manual_seed(i))
           for i, (k, s) in enumerate(shapes.items())}
    card = {k: v.cuda() for k, v in cpu.items()}
    opts = [adamw_8bit(p, lambda c: 1e-2, weight_decay=1e-2)
            for p in (cpu, card)]
    g0 = torch.Generator().manual_seed(9)
    for _ in range(2):
        grads = {k: torch.randn(s, generator=g0) for k, s in shapes.items()}
        opts[0].update(grads)
        opts[1].update({k: v.cuda() for k, v in grads.items()})
    torch.cuda.synchronize()
    for k in shapes:
        torch.testing.assert_close(card[k].cpu(), cpu[k], atol=1e-6, rtol=0)
    sa, sb = (o.state_dict() for o in opts)
    for key in ("mu", "nu"):
        for k in shapes:
            assert torch.equal(sb[key][k]["codes"].cpu(), sa[key][k]["codes"])
            torch.testing.assert_close(sb[key][k]["scales"].cpu(),
                                       sa[key][k]["scales"], atol=1e-6, rtol=0)


def test_sharded_training_on_the_card(gen):
    """ZeRO-1 and FSDP on 2 gloo ranks sharing the card (the collectives
    staged through pinned host memory), narrow widths, bf16: two optimizer
    steps each against the replicated data-parallel run on the same batch
    and draws, within the bounds ``chip_smoke.py`` holds phase 8 (j) / (k)
    to (losses 1e-5 relative, masters 1e-5 relative L2); under FSDP the
    gathered weights feed the kernels: K1, K2, K3 and their backward
    kernels launch, no plain fallback."""
    import os
    import sys

    import numpy as np

    from seervideoldm_tpu_torch.parallel import launch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_sharding_workers as workers

    sizes = dict(frames=12, cond=2, device="cuda",
                 unet=dict(block_out_channels=(64, 128), layers_per_block=1,
                           norm_num_groups=8, cross_attention_dim=64,
                           attention_head_dim=2),
                 vae=dict(block_out_channels=(16, 32), layers_per_block=1,
                          norm_num_groups=8),
                 clip=dict(vocab_size=100, hidden_size=64,
                           intermediate_size=128, num_hidden_layers=2,
                           num_attention_heads=4, max_position_embeddings=16),
                 fstext=dict(n_heads=4, num_layers=1))
    rng = np.random.RandomState(0)
    lat = (2, 10, 32, 32, 4)
    batch = {"latents_x0": rng.randn(2, 2, 32, 32, 4).astype(np.float32),
             "latents": rng.randn(*lat).astype(np.float32),
             "clip_emb": rng.randn(2, 16, 64).astype(np.float32)}
    draws = [{"noise": rng.randn(*lat).astype(np.float32),
              "ts": rng.randint(0, 1000, (2,))} for _ in range(2)]
    base = dict(lr=1e-4, warmup=0, accum=1, steps=2)
    cases = {"none": base, "zero1": dict(base, mode="zero1"),
             "fsdp": dict(base, mode="fsdp")}
    got = launch.run(workers.sharded_cases, 2,
                     args=(sizes, None, batch, draws, cases),
                     backend="gloo", timeout=600)[0]
    want = got["none"]
    for mode in ("zero1", "fsdp"):
        run = got[mode]
        for a, b in zip(run["losses"], want["losses"]):
            assert abs(a - b) <= 1e-5 * abs(b), (mode, run["losses"],
                                                 want["losses"])
        num = sum(float(((run["masters"][n] - w) ** 2).sum())
                  for n, w in want["masters"].items())
        den = sum(float((w ** 2).sum()) for w in want["masters"].values())
        assert (num / den) ** 0.5 <= 1e-5, mode
    launches = got["fsdp"]["launches"]
    for name in ("swat_attention_tables", "flash_attention", "ln_geglu_ff",
                 "swat_attention_tables_bwd", "flash_attention_bwd"):
        assert launches[name] > 0, (name, launches)


# ------------------------------------------------------------ K11 GroupNorm

def _gn_affine(gen, c):
    w = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    return w, 0.1 * torch.randn(c, generator=gen, device="cuda")


def _check_group_norm(x, groups, eps, w, b, silu):
    """K11 held to its plain halves by the wrapper's own check (the one
    ``chip_smoke.py`` makes, with the same limits), one apply and one
    moments launch counted for a norm call."""
    from seervideoldm_tpu_torch.ops.kernels import group_norm as GN

    before = GN.group_norm.launches, GN.group_norm_moments.launches
    readings = GN.check_against_plain(x, groups, eps, w, b, silu)
    torch.cuda.synchronize()
    assert readings["checks_ok"], readings
    # the moments alone, the apply on them, then a whole norm call
    assert (GN.group_norm.launches - before[0],
            GN.group_norm_moments.launches - before[1]) == (2, 2)


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("c", [128, 256, 512, 320, 640, 960, 1280, 1920, 2560])
def test_group_norm_kernel_channels(gen, c, silu):
    """Every channel count the port normalises: the VAE's as 4-D images,
    the UNet's as 5-D videos, 32 groups (c / groups 4 to 80)."""
    shape = (2, 24, 20, c) if c in (128, 256, 512) else (2, 3, 10, 12, c)
    x = _randn(gen, *shape)
    _check_group_norm(x, 32, 1e-6, *_gn_affine(gen, c), silu)


@pytest.mark.parametrize("shape,eps,silu", [
    ((1, 4, 16, 16, 320), 1e-6, True), ((8, 3, 8, 8, 640), 1e-5, False),
    ((2, 37, 29, 960), 1e-5, True), ((8, 12, 4, 4, 1280), 1e-6, False),
    ((2, 7, 13, 11, 320), 1e-6, True),      # rows no multiple of the tile
    ((1, 3, 1, 1, 2560), 1e-5, True)])      # fewer rows than slices
def test_group_norm_kernel_shapes(gen, shape, eps, silu):
    x = _randn(gen, *shape)
    _check_group_norm(x, 32, eps, *_gn_affine(gen, shape[-1]), silu)


def test_group_norm_kernel_offset_mean(gen):
    """|mean| 100 x the standard deviation: the Welford sums and Chan's
    merges keep the variance where a sum of squares would cancel."""
    c = 320
    x = (100.0 + torch.randn(2, 4, 16, 16, c, generator=gen, device="cuda")
         ).to(torch.bfloat16)
    _check_group_norm(x, 32, 1e-6, *_gn_affine(gen, c), True)


def test_group_norm_back_to_back_calls(gen):
    """The moments kernel's tickets reset: calls of other B and C one after
    the other each come out right."""
    for shape in ((8, 3, 8, 8, 320), (2, 3, 4, 4, 1280), (8, 3, 8, 8, 320),
                  (1, 64, 64, 128), (8, 3, 8, 8, 320)):
        x = _randn(gen, *shape)
        _check_group_norm(x, 32, 1e-6, *_gn_affine(gen, shape[-1]), True)


def test_group_norm_fn_gradients(gen):
    """``GroupNormFn`` (K11 forward, the plain halves recomputed backward)
    against autograd through the plain halves, with and without SiLU; a
    frozen affine gets no gradient."""
    from seervideoldm_tpu_torch.ops import norms
    from seervideoldm_tpu_torch.ops.kernels import group_norm as GN

    c = 320
    norm = norms.GroupNorm(32, c, 1e-6).cuda()
    with torch.no_grad():
        w, b = _gn_affine(gen, c)
        norm.weight.copy_(w)
        norm.bias.copy_(b)
    x = _randn(gen, 2, 3, 8, 8, c)
    g = _randn(gen, 2, 3, 8, 8, c)
    for silu in (True, False):
        readings = GN.check_gradients_against_plain(norm, x, g, silu)
        assert readings["checks_ok"], readings
    norm.requires_grad_(False)
    readings = GN.check_gradients_against_plain(norm, x, g, True)
    assert readings["checks_ok"], readings
    x = x.detach().requires_grad_()
    norm(x).backward(g)
    assert norm.weight.grad is None and norm.bias.grad is None
    assert x.grad is not None


def test_group_norm_refuses_uncovered_shapes(gen):
    """On the card K11 runs or raises: no fallback to the plain chain."""
    from seervideoldm_tpu_torch.ops import norms
    from seervideoldm_tpu_torch.ops.kernels import group_norm as GN

    x = _randn(gen, 2, 4, 4, 12)
    with pytest.raises(ValueError, match="not covered"):
        GN.group_norm(x, 4, 1e-6, *_gn_affine(gen, 12))
    with pytest.raises(ValueError, match="not covered"):
        norms.GroupNorm(4, 12).cuda()(x)
    for dtype in (torch.float16, torch.float32):
        with pytest.raises(ValueError, match="takes bf16"):
            GN.group_norm(_randn(gen, 2, 4, 4, 16).to(dtype), 4, 1e-6,
                          *_gn_affine(gen, 16))


def test_group_norm_launches_per_unet_call(gen):
    """A narrow SeerUNet call counts one K11 call per GroupNorm module of
    the UNet, none sharded on one card."""
    from seervideoldm_tpu_torch.models.unet3d import SeerUNet, SeerUNetConfig
    from seervideoldm_tpu_torch.ops.kernels import group_norm as GN
    from seervideoldm_tpu_torch.ops.norms import GroupNorm
    from seervideoldm_tpu_torch.utils.device import cast_for_compute

    cfg = SeerUNetConfig(block_out_channels=(64, 128), layers_per_block=1,
                         norm_num_groups=8, cross_attention_dim=64,
                         attention_head_dim=2)
    with torch.device("cuda"):
        unet = cast_for_compute(SeerUNet(cfg), torch.bfloat16)
    x = _randn(gen, 2, 12, 32, 32, 4)
    ctx = _randn(gen, 2, 12, 77, 64)
    ts = torch.tensor([500, 500], device="cuda")
    before = (GN.group_norm.launches, GN.group_norm_moments.launches,
              GN.group_norm.sharded)
    with torch.no_grad():
        unet(x, ts, ctx)
    torch.cuda.synchronize()
    norms = sum(isinstance(m, GroupNorm) for m in unet.modules())
    assert (GN.group_norm.launches - before[0],
            GN.group_norm_moments.launches - before[1],
            GN.group_norm.sharded - before[2]) == (norms, norms, 0)
