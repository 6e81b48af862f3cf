"""The GEGLU kernels' two halves (``ops/kernels/geglu_ff.py``), on the CPU.

On the card K3, K4 and K5 are each an up kernel (``a = bf16(h * gelu(g))``,
LayerNorm prologue in the LN modes) and a down kernel (``a W2 + b2`` and the
mode's epilogue).  Their plain versions, ``geglu_up_plain`` and
``geglu_down_plain``, keep the kernels' rounding points; these tests pin
that:

- composed, they equal ``geglu_ff_plain``, ``ln_geglu_ff_plain`` and
  ``ln_geglu_ff_proj_plain`` bit for bit in bf16 (and so do the CPU
  dispatch of ``geglu_up`` / ``geglu_down``);
- in fp32 the composition matches the JAX package's ``_reference``,
  ``_ln_reference`` and ``_ln_proj_reference`` within 5e-5 (summation order
  only, as ``tests/test_torch_kernels.py``);
- the kernels' coverage (``covers``) takes every shape the site gates send
  them at the UNet's widths, and ``plan`` gives tiles that divide it.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seervideoldm_tpu_torch.ops.kernels import geglu_ff as tgg

jgg = importlib.import_module("seervideoldm_tpu.ops.pallas.geglu_ff")

torch.set_num_threads(1)


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _args(n, c, seed):
    """numpy inputs, weights in JAX layout (in, out)."""
    inner = 4 * c
    return dict(x=_rand((n, c), seed), gamma=1.0 + _rand((c,), seed + 1, 0.1),
                beta=_rand((c,), seed + 2, 0.1),
                w1=_rand((c, 2 * inner), seed + 3, c ** -0.5),
                b1=_rand((2 * inner,), seed + 4, 0.1),
                w2=_rand((inner, c), seed + 5, inner ** -0.5),
                b2=_rand((c,), seed + 6, 0.1),
                w3=_rand((c, c), seed + 7, c ** -0.5),
                b3=_rand((c,), seed + 8, 0.1), res=_rand((n, c), seed + 9))


def _torch(a, dtype):
    """torch tensors; Linear weights (out, in); gamma/beta stay fp32."""
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    for k in ("w1", "w2", "w3"):
        t[k] = t[k].t().contiguous()
    return {k: v if k in ("gamma", "beta") else v.to(dtype)
            for k, v in t.items()}


def _split(t, mode, up=tgg.geglu_up_plain, down=tgg.geglu_down_plain):
    a = up(t["x"], t["gamma"], t["beta"], t["w1"], t["b1"], mode > 0)
    return down(a, t["w2"], t["b2"], t["x"], t["w3"], t["b3"], t["res"], mode)


def _whole(t, mode):
    if mode == 0:
        return tgg.geglu_ff_plain(t["x"], t["w1"], t["b1"], t["w2"], t["b2"])
    if mode == 1:
        return tgg.ln_geglu_ff_plain(t["x"], t["gamma"], t["beta"], t["w1"],
                                     t["b1"], t["w2"], t["b2"])
    return tgg.ln_geglu_ff_proj_plain(
        t["x"], t["gamma"], t["beta"], t["w1"], t["b1"], t["w2"], t["b2"],
        t["w3"], t["b3"], t["res"])


SHAPES = [(0, 256, 64), (0, 256, 320), (0, 128, 640), (1, 256, 64),
          (1, 256, 320), (2, 256, 64), (2, 128, 320)]


@pytest.mark.parametrize("mode,n,c", SHAPES)
def test_halves_compose_bit_for_bit_bf16(mode, n, c):
    t = _torch(_args(n, c, 40 + c + mode), torch.bfloat16)
    want = _whole(t, mode)
    assert torch.equal(_split(t, mode), want)
    # the public halves dispatch CPU tensors to the plain versions
    assert torch.equal(_split(t, mode, tgg.geglu_up, tgg.geglu_down), want)


@pytest.mark.parametrize("mode,n,c", [(0, 256, 64), (0, 128, 640),
                                      (1, 256, 64), (1, 128, 320),
                                      (2, 256, 64), (2, 128, 320)])
def test_halves_match_jax_reference_fp32(mode, n, c):
    a = _args(n, c, 70 + c + mode)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    if mode == 0:
        want = jgg._reference(j["x"], j["w1"], j["b1"], j["w2"], j["b2"])
    elif mode == 1:
        want = jgg._ln_reference(j["x"], j["gamma"], j["beta"], j["w1"],
                                 j["b1"], j["w2"], j["b2"])
    else:
        want = jgg._ln_proj_reference(j["x"], j["gamma"], j["beta"], j["w1"],
                                      j["b1"], j["w2"], j["b2"], j["w3"],
                                      j["b3"], j["res"])
    got = _split(_torch(a, torch.float32), mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


@pytest.mark.parametrize("c", [320, 640])
def test_coverage_takes_every_gated_unet_shape(c):
    """n = 256 ... 98304 in steps of 256, inner = 4c: every shape a site
    gate sends to a kernel mode is covered, and its plan divides it."""
    x = torch.empty(1, dtype=torch.bfloat16, device="meta")
    inner, sent = 4 * c, 0
    for n in range(256, 98304 + 1, 256):
        modes = []
        if tgg.geglu_ff_supported(n, c, inner, x):
            modes.append(0)
        if tgg.ln_geglu_ff_preferred(n, c, inner, x):
            modes += [1, 2]
        for mode in modes:
            sent += 1
            assert tgg.covers(mode, n, c, inner), (mode, n, c)
            p = tgg.plan(n, c, inner, mode)
            assert inner % p["up_bn"] == 0
            assert (inner // p["up_bn"]) % p["up_tiles"] == 0
            assert c % p["down_bn"] == 0
            assert p["down_bn"] == c if mode == 2 else \
                p["down_bn"] in tgg.DOWN_TILES
            assert p["up_ctas"] == (n // 128) * (inner // p["up_bn"]
                                                 // p["up_tiles"])
            assert p["down_ctas"] == (n // 128) * (c // p["down_bn"])
    assert sent == 384 * (3 if c == 320 else 1)


def test_coverage_refuses_what_no_kernel_takes():
    x = torch.empty(1, dtype=torch.bfloat16, device="meta")
    # c = 1280: the weight budget keeps it plain, and no kernel mode takes it
    assert not tgg.geglu_ff_supported(1536, 1280, 5120, x)
    for mode in (0, 1, 2):
        assert not tgg.covers(mode, 1536, 1280, 5120)
    assert not tgg.covers(1, 256, 640, 2560)      # LN modes: c <= 320
    assert tgg.covers(0, 256, 704, 2816)
    assert not tgg.covers(0, 256, 768, 3072)
    assert not tgg.covers(0, 192, 320, 1280)      # n % 128
    assert not tgg.covers(0, 256, 96, 384)        # c % 64
    assert not tgg.covers(0, 256, 320, 1248)      # inner % 64
