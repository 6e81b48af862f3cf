"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip on a host without a GPU (the kernels have no
interpret mode).  On a machine with an H100 (``--noconftest``: the
repository's conftest sets up JAX, which that machine need not have):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Small shapes of each kernel's main-path form, bf16 inputs from a seed,
tolerance 2e-2 abs + 2e-2 rel on bf16 outputs (as ``chip_smoke.py``).
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


@pytest.mark.parametrize("mode,c", [(0, 64), (0, 640), (1, 320), (2, 128)])
def test_geglu_kernel(gen, mode, c):
    from seervideoldm_tpu_torch.ops.kernels import geglu_ff as K

    n, inner = 512, 4 * c
    x = _randn(gen, n, c)
    w1, b1 = _randn(gen, 2 * inner, c, scale=c ** -0.5), _randn(gen, 2 * inner)
    w2, b2 = _randn(gen, c, inner, scale=inner ** -0.5), _randn(gen, c)
    gamma = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(c, generator=gen, device="cuda")
    w3, b3 = _randn(gen, c, c, scale=c ** -0.5), _randn(gen, c)
    res = _randn(gen, n, c)
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


def test_kernel_refuses_uncovered_shape(gen):
    from seervideoldm_tpu_torch.ops.kernels import flash_attention as K

    q = _randn(gen, 2, 600, 36)  # head dim not a multiple of 8
    with pytest.raises(ValueError, match="not covered"):
        K.flash_attention(q, q, q, 0.1)
