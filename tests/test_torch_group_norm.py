"""K11's plain side on the CPU (``ops/norms.py``, ``ops/kernels/group_norm.py``).

- ``group_norm_moments_plain`` then ``group_norm_apply_plain`` (and
  ``group_norm_silu``) against the GroupNorm forward the port ran before
  K11 (a frozen copy below) and ``F.silu`` of it, bit for bit, fp32 and
  bf16, 4-D and 5-D; ``group_norm_silu`` against the JAX layer and
  ``jax.nn.silu`` in fp32;
- ``GroupNormFn`` (the kernel's autograd function; the plain halves on a
  CPU tensor) by fp64 ``gradcheck``, and its gradients against autograd
  through the plain halves;
- the launch plan at every shape the port gives the kernel, and the
  wrapper's refusals (the CUDA launches themselves are the ``cuda``-marked
  cases of ``tests/test_torch_cuda.py`` and ``chip_smoke.py``);
- the model sites: which norms fuse the SiLU, and the counters.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from seervideoldm_tpu.ops import norms as jnorms
from seervideoldm_tpu_torch.ops import norms
from seervideoldm_tpu_torch.ops.kernels import group_norm as K

torch.set_num_threads(1)

# (shape, groups): a 5-D video (c / groups 10), a 4-D image (4: a chunk
# of 8 channels holds two groups), a 5-D video at c / groups 20
CASES = [((2, 3, 4, 5, 40), 4), ((3, 6, 6, 32), 8), ((1, 2, 3, 3, 640), 32)]


def _former_forward(norm, x):
    """``GroupNorm.forward`` as the port ran it before K11 (no ``seq``)."""
    b, c, g = x.shape[0], x.shape[-1], norm.num_groups
    x32 = x.float()
    flat = x32.reshape(b, -1, g, c // g)
    var, mean = torch.var_mean(flat, dim=(1, 3), unbiased=False)
    rstd = torch.rsqrt(var + norm.eps)
    scale = rstd.repeat_interleave(c // g, dim=-1) * norm.weight.float()
    shift = norm.bias.float() - mean.repeat_interleave(c // g, dim=-1) * scale
    shape = (b,) + (1,) * (x.dim() - 2) + (c,)
    return (x32 * scale.reshape(shape) + shift.reshape(shape)).to(x.dtype)


def _norm(shape, groups, seed, eps=1e-6):
    g = torch.Generator().manual_seed(seed)
    norm = norms.GroupNorm(groups, shape[-1], eps)
    with torch.no_grad():
        norm.weight.copy_(1.0 + 0.1 * torch.randn(shape[-1], generator=g))
        norm.bias.copy_(0.1 * torch.randn(shape[-1], generator=g))
    x = 3.0 * torch.randn(shape, generator=g) + 1.0
    return norm, x


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", CASES)
def test_plain_halves_equal_the_former_forward(shape, groups, dtype, silu):
    norm, x = _norm(shape, groups, 0)
    x = x.to(dtype)
    want = _former_forward(norm, x)
    if silu:
        want = F.silu(want)
    with torch.no_grad():
        mean, rstd = norms.group_norm_moments_plain(x, groups, norm.eps)
        halves = norms.group_norm_apply_plain(x, mean, rstd, norm.weight,
                                              norm.bias, silu)
        module = norms.group_norm_silu(norm, x) if silu else norm(x)
    assert mean.shape == rstd.shape == (shape[0], groups)
    assert halves.dtype == dtype
    assert torch.equal(halves, want)
    assert torch.equal(module, want)


@pytest.mark.parametrize("shape,groups", CASES[:2])
def test_group_norm_silu_against_jax(shape, groups):
    norm, x = _norm(shape, groups, 1)
    jmod = jnorms.GroupNorm(groups, eps=norm.eps)
    params = {"params": {"scale": jnp.asarray(norm.weight.detach().numpy()),
                         "bias": jnp.asarray(norm.bias.detach().numpy())}}
    want = np.asarray(jax.nn.silu(jmod.apply(params, jnp.asarray(x.numpy()))))
    with torch.no_grad():
        got = norms.group_norm_silu(norm, x).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def _fn(x, w, b, mean, rstd, groups, silu):
    return norms.GroupNormFn.apply(x, w, b, mean, rstd, groups, 1e-5, silu)


@pytest.mark.parametrize("moments", [False, True])
@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_fn_gradcheck(silu, moments):
    """fp64 on the CPU: the forward and the recomputing backward are the
    plain halves in fp64, so finite differences check the backward;
    ``moments``: mean and rstd arrive as inputs (the ``seq`` path) and get
    their own gradients."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 2, 3, 3, 16, generator=g, dtype=torch.float64)
    w = 1.0 + 0.1 * torch.randn(16, generator=g, dtype=torch.float64)
    b = 0.1 * torch.randn(16, generator=g, dtype=torch.float64)
    inputs = [x, w, b]
    if moments:
        inputs += list(norms.group_norm_moments_plain(x, 4, 1e-5))
    inputs = [t.detach().requires_grad_() for t in inputs]
    if moments:
        call = lambda *t: _fn(*t, 4, silu)  # noqa: E731
    else:
        call = lambda *t: _fn(*t, None, None, 4, silu)  # noqa: E731
    assert torch.autograd.gradcheck(call, tuple(inputs))


@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_fn_matches_autograd_through_plain(silu, frozen):
    """fp32 and bf16 inputs: ``GroupNormFn``'s gradients are those of
    autograd through the plain halves, bit for bit; a frozen affine gets
    none."""
    for dtype in (torch.float32, torch.bfloat16):
        norm, x = _norm((2, 3, 4, 4, 40), 4, 3)
        norm.requires_grad_(not frozen)
        x = x.to(dtype).requires_grad_()
        gy = torch.randn(x.shape, generator=torch.Generator().manual_seed(4)
                         ).to(dtype)
        _fn(x, norm.weight, norm.bias, None, None, 4, silu).backward(gy)
        xr = x.detach().clone().requires_grad_()
        wr, br = (p.detach().clone().requires_grad_() for p in
                  (norm.weight, norm.bias))
        mean, rstd = norms.group_norm_moments_plain(xr, 4, 1e-5)
        norms.group_norm_apply_plain(xr, mean, rstd, wr, br, silu).backward(gy)
        assert torch.equal(x.grad, xr.grad)
        if frozen:
            assert norm.weight.grad is None and norm.bias.grad is None
        else:
            assert torch.equal(norm.weight.grad, wr.grad)
            assert torch.equal(norm.bias.grad, br.grad)


# every (b, n, c) the port hands the kernel at 256 / 512 px (UNet levels at
# CFG batch 2 and 8, 12 and 16 frames; the VAE per frame), and odd ones
PLAN_SHAPES = [
    (2, 12 * 32 * 32, 320), (8, 12 * 32 * 32, 320), (8, 12 * 32 * 32, 960),
    (8, 12 * 16 * 16, 640), (8, 12 * 16 * 16, 1920), (8, 12 * 8 * 8, 1280),
    (8, 12 * 4 * 4, 2560), (2, 12 * 64 * 64, 320), (8, 16 * 4 * 4, 1280),
    (12, 256 * 256, 128), (12, 128 * 128, 256), (12, 64 * 64, 512),
    (48, 32 * 32, 512), (1, 3, 2560), (1, 1, 8), (3, 1001, 640),
    (65535, 2, 64)]


@pytest.mark.parametrize("b,n,c", PLAN_SHAPES)
def test_plan_covers_the_port_shapes(b, n, c):
    rpi, per_b = K.plan(b, n, c)
    assert 256 <= rpi * (c // K.VEC) <= K.MAX_THREADS
    assert 1 <= per_b <= n
    rows = -(-n // per_b)
    assert (per_b - 1) * rows < n          # no CTA without rows
    assert rows >= min(n, rpi * K.MIN_ROWS_PER_THREAD)
    assert b * per_b < K.CTAS_PER_SM * 132 + b  # about one resident wave


@pytest.mark.parametrize("shape,groups,dtype,match", [
    ((2, 4, 4, 12), 4, torch.bfloat16, "not covered"),        # c % 8
    ((2, 4, 4, 4104), 8, torch.bfloat16, "not covered"),      # c > 4096
    ((2, 4, 4, 40), 3, torch.bfloat16, "not covered"),        # c % groups
    ((2, 4, 4, 40), 4, torch.float16, "takes bf16"),
    ((2, 4, 4, 40), 4, torch.float64, "takes bf16"),
    ((2, 4, 4, 40), 4, torch.float32, "takes bf16"),
    ((40,), 4, torch.bfloat16, r"\(b, \.\.\., c\)")])
def test_wrapper_refuses_uncovered_inputs(shape, groups, dtype, match):
    with pytest.raises(ValueError, match=match):
        K.check(torch.zeros(shape, dtype=dtype), groups)


@pytest.mark.parametrize("value", [-3.0, -1e-3, -1e-40, -0.0, 0.0, 1e-40,
                                   1e-3, 2.5])
def test_bf16_step_is_one_ulp_along_the_number_line(value):
    """The card check's ulp arithmetic: a step of +-1 is ``nextafter``, and
    the keys of neighbours differ by one, across the signs and zero."""
    t = torch.tensor([value]).to(torch.bfloat16)
    inf = torch.full_like(t, float("inf"))
    up, down = K._bf16_step(t, 1), K._bf16_step(t, -1)
    assert torch.equal(up, torch.nextafter(t, inf))
    assert torch.equal(down, torch.nextafter(t, -inf))
    assert int(K._bf16_key(up) - K._bf16_key(t)) == 1
    assert int(K._bf16_key(t) - K._bf16_key(down)) == 1


@pytest.mark.parametrize("chunk", [1 << 26, 97])
@pytest.mark.parametrize("silu", [False, True])
def test_card_check_in_slices_reads_the_plain_halves_clean(monkeypatch, chunk,
                                                           silu):
    """``check_against_plain``'s arithmetic on the CPU, the kernels stood in
    by their plain halves: nothing outside one ulp, the apply bit for bit,
    the fp64 moments of its slices ``var_mean``'s, whole or in slices of
    97 elements (rows not a multiple of a slice); a value one ulp off is
    still in, one a hundred ulps off is not."""
    def plain(x, groups, eps, weight, bias, silu=False, moments=None):
        m, r = moments or norms.group_norm_moments_plain(x, groups, eps)
        return norms.group_norm_apply_plain(x, m, r, weight, bias, silu)

    monkeypatch.setattr(K, "group_norm", plain)
    monkeypatch.setattr(K, "group_norm_moments",
                        norms.group_norm_moments_plain)
    monkeypatch.setattr(K, "CHECK_CHUNK", chunk)
    g = torch.Generator().manual_seed(3)
    x = (torch.randn((2, 3, 5, 7, 64), generator=g) + 0.5).to(torch.bfloat16)
    w, b = 1 + 0.1 * torch.randn(64, generator=g), 0.1 * torch.randn(64,
                                                                     generator=g)
    row = K.check_against_plain(x, 8, 1e-6, w, b, silu)
    assert row["checks_ok"] and row["outside_one_ulp"] == 0
    assert row["apply_ulps_on_kernel_moments"] == 0
    var, mean = K._moments64(x, 8)
    want_var, want_mean = torch.var_mean(x.double().reshape(2, -1, 8, 8),
                                         dim=(1, 3), unbiased=False)
    torch.testing.assert_close(mean, want_mean, rtol=1e-12, atol=0)
    torch.testing.assert_close(var, want_var, rtol=1e-12, atol=0)

    def off(steps):
        """The whole path with one normalised value ``steps`` ulps off
        before the SiLU; the apply on given moments left exact."""
        def shifted(x, groups, eps, weight, bias, silu=False, moments=None):
            if moments is not None:
                return plain(x, groups, eps, weight, bias, silu, moments)
            flat = plain(x, groups, eps, weight, bias).reshape(-1).clone()
            flat[5] = K._bf16_step(flat[5:6], steps)[0]
            y = flat.reshape(x.shape)
            return F.silu(y) if silu else y
        return shifted

    monkeypatch.setattr(K, "group_norm", off(1))
    assert K.check_against_plain(x, 8, 1e-6, w, b, silu)["checks_ok"]
    monkeypatch.setattr(K, "group_norm", off(100))
    row = K.check_against_plain(x, 8, 1e-6, w, b, silu)
    assert not row["checks_ok"] and row["outside_one_ulp"] == 1


def test_wrapper_takes_only_cuda_tensors():
    x = torch.zeros(2, 4, 4, 32)
    with pytest.raises(ValueError, match="unsupported device"):
        K.group_norm(x, 8, 1e-6, torch.ones(32), torch.zeros(32))
    with pytest.raises(ValueError, match="unsupported device"):
        norms.GroupNorm(8, 32)(torch.zeros(2, 4, 4, 32, device="meta"))


def test_counters_read_group_norm():
    from seervideoldm_tpu_torch.utils import profiling

    before = profiling.counters()
    norm, x = _norm((2, 3, 4, 4, 40), 4, 5)
    with torch.no_grad():
        norms.group_norm_silu(norm, x)
    after = profiling.counters()
    # the CPU runs the plain halves and counts no launch
    for key in ("kernels.group_norm.launches", "kernels.group_norm.sharded",
                "kernels.group_norm_moments.launches"):
        assert key in before and after[key] == before[key]


def test_model_sites_fuse_silu_where_the_model_applies_it(monkeypatch):
    """A toy SeerUNet call and a toy VAE decode: the resnets' two norms and
    ``conv_norm_out`` go through ``group_norm_silu``, the transformer sites'
    norms (and the VAE's attention norm) through ``GroupNorm.forward``;
    every GroupNorm module runs once."""
    from seervideoldm_tpu_torch.models.unet3d import SeerUNet, SeerUNetConfig
    from seervideoldm_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    calls = {True: 0, False: 0}
    real = norms._group_norm

    def counted(norm, x, silu):
        calls[silu] += 1
        return real(norm, x, silu)

    monkeypatch.setattr(norms, "_group_norm", counted)
    torch.manual_seed(0)
    cfg = SeerUNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                         norm_num_groups=8, cross_attention_dim=32,
                         attention_head_dim=4)
    unet = SeerUNet(cfg)
    with torch.no_grad():
        unet(torch.randn(1, 3, 8, 8, 4), torch.tensor([10]),
             torch.randn(1, 3, 77, 32))
    resnets = sum(type(m).__name__ == "ResnetBlock3D" for m in unet.modules())
    modules = sum(isinstance(m, norms.GroupNorm) for m in unet.modules())
    assert calls[True] == 2 * resnets + 1
    assert calls[True] + calls[False] == modules
    calls.update({True: 0, False: 0})
    vae = AutoencoderKL(VAEConfig(block_out_channels=(16, 32),
                                  layers_per_block=1, norm_num_groups=8))
    with torch.no_grad():
        vae.decode(torch.randn(2, 4, 4, 4))
    resnets = sum(type(m).__name__ == "ResnetBlock2D"
                  for m in vae.decoder.modules())
    assert calls[True] == 2 * resnets + 1 and calls[False] == 1
