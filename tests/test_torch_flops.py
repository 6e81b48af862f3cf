"""The port's analytic FLOP counter (``seervideoldm_tpu_torch/utils/flops.py``)
against the JAX package's (``seervideoldm_tpu/utils/flops.py``) and against
PyTorch's own count of the port's plain UNet forward.

- every count equals the JAX count exactly (the same float arithmetic in
  the same order), over a grid of shapes, for the SD-1.5 configs and a
  narrow one;
- at toy scale, ``torch.utils.flop_counter.FlopCounterMode`` over the
  port's plain SeerUNet forward on the CPU (matmuls, convolutions and the
  attention products it sees) brackets the analytic count within the band
  ``tests/test_flops.py`` holds the JAX count to against XLA's cost model:
  analytic <= 1.05 x counted and >= 0.5 x counted.
"""
import pytest
import torch

from seervideoldm_tpu.models.unet3d import SeerUNetConfig as JUNetConfig
from seervideoldm_tpu.models.vae import VAEConfig as JVAEConfig
from seervideoldm_tpu.utils import flops as jflops
from seervideoldm_tpu_torch.models.unet3d import SeerUNet, SeerUNetConfig
from seervideoldm_tpu_torch.models.vae import VAEConfig
from seervideoldm_tpu_torch.utils import flops as tflops

NARROW_UNET = dict(block_out_channels=(32, 64), layers_per_block=1,
                   norm_num_groups=8, cross_attention_dim=32,
                   attention_head_dim=4)
NARROW_VAE = dict(block_out_channels=(16, 32), layers_per_block=1,
                  norm_num_groups=8)
SHAPES = [dict(b=1, f=12, h=32, w=32), dict(b=2, f=12, h=64, w=64),
          dict(b=2, f=16, h=8, w=8), dict(b=3, f=7, h=40, w=24),
          dict(b=1, f=4, h=16, w=16, ctx_tokens=16, ctx_dim=32)]


@pytest.mark.parametrize("narrow", [False, True], ids=["sd15", "narrow"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(
    str(v) for v in s.values()))
def test_unet_flops_equal_jax(shape, narrow):
    kw = NARROW_UNET if narrow else {}
    jcfg = JUNetConfig(**kw) if narrow else None
    tcfg = SeerUNetConfig(**kw) if narrow else None
    got = tflops.seer_unet_flops(tflops.UNetShape(**shape), tcfg)
    want = jflops.seer_unet_flops(jflops.UNetShape(**shape), jcfg)
    assert got == want


@pytest.mark.parametrize("narrow", [False, True], ids=["sd15", "narrow"])
@pytest.mark.parametrize("decode,n,h,w", [(False, 1, 256, 256),
                                          (False, 4, 512, 320),
                                          (True, 10, 32, 32),
                                          (True, 2, 64, 40)])
def test_vae_flops_equal_jax(decode, n, h, w, narrow):
    jcfg = JVAEConfig(**NARROW_VAE) if narrow else None
    tcfg = VAEConfig(**NARROW_VAE) if narrow else None
    assert (tflops.vae_flops(n, h, w, decode, tcfg)
            == jflops.vae_flops(n, h, w, decode, jcfg))


@pytest.mark.parametrize("b,f,tokens,dim,layers", [(1, 12, 77, 768, 8),
                                                   (2, 16, 77, 768, 8),
                                                   (1, 4, 16, 32, 1)])
def test_fstext_flops_equal_jax(b, f, tokens, dim, layers):
    assert (tflops.fstext_flops(b, f, tokens, dim, layers)
            == jflops.fstext_flops(b, f, tokens, dim, layers))


@pytest.mark.parametrize("args", [(1, 12, 2, 256, 30, True, True),
                                  (1, 12, 2, 512, 50, True, True),
                                  (2, 16, 1, 256, 25, False, False)])
def test_sampling_clip_flops_equal_jax(args):
    assert (tflops.sampling_clip_flops(*args)
            == jflops.sampling_clip_flops(*args))


def test_default_configs_are_sd15():
    """The port's default configs are the SD-1.5 widths the JAX counter
    reads by default."""
    from seervideoldm_tpu_torch.models.unet3d import SEER_UNET_SD15_CONFIG
    from seervideoldm_tpu_torch.models.vae import SD15_VAE_CONFIG

    assert tuple(SEER_UNET_SD15_CONFIG.block_out_channels) == (320, 640,
                                                                1280, 1280)
    assert tuple(SD15_VAE_CONFIG.block_out_channels) == (128, 256, 512, 512)


@pytest.mark.parametrize("b,f,h", [(2, 4, 16), (1, 3, 8)])
def test_unet_flops_bracket_flop_counter(b, f, h):
    """FlopCounterMode over the port's plain UNet forward (fp32, CPU)."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = SeerUNetConfig(**NARROW_UNET)
    torch.manual_seed(0)
    unet = SeerUNet(cfg).eval()
    x = torch.randn(b, f, h, h, 4)
    ctx = torch.randn(b, f, 77, 32)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        unet(x, torch.zeros(b, dtype=torch.int32), ctx)
    counted = counter.get_total_flops()
    analytic = tflops.seer_unet_flops(
        tflops.UNetShape(b=b, f=f, h=h, w=h, ctx_dim=32), cfg)
    assert analytic <= counted * 1.05, (analytic, counted)
    assert analytic >= counted * 0.5, (analytic, counted)
