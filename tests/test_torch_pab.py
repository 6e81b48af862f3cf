"""Pyramid Attention Broadcast in the port (``diffusion/pab.py``, the
cache sites of ``models/transformer3d.py``, the samplers' PAB path)
against the JAX package on the CPU, fp32, on the tiny SeerUNet of
``tests/test_torch_samplers.py`` (every ``proj_out`` non-zero).

- ``build_pab_schedule`` equals JAX's (modes and ``mode_idx``) for step
  counts 1-60 under several configs;
- one UNet call per cached mode, the cache written by an all-compute call
  at other inputs, against the JAX ``pab_apply`` with its ``pab``
  collection (1e-4);
- a PAB DDIM and a PAB DPM++ sample against JAX (rtol 1e-3, atol 1e-4);
- all ranges 1 equal PAB off bit for bit, in both samplers, and the
  all-compute mode equals ``pab=None`` bit for bit;
- the cache holds one entry per site (spatial and cross per text block,
  the temporal attention per temporal block), keyed by module name; a read
  before a write, PAB with remat, PAB with ``guidance_interval`` and with
  two-call CFG all raise.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seervideoldm_tpu.diffusion import ddim as jddim
from seervideoldm_tpu.diffusion import dpm_solver as jdpm
from seervideoldm_tpu.diffusion import pab as jpab
from seervideoldm_tpu.diffusion.schedules import DiffusionSchedule as JSchedule
from seervideoldm_tpu_torch.diffusion import ddim, dpm_solver, pab
from seervideoldm_tpu_torch.diffusion.schedules import DiffusionSchedule
from seervideoldm_tpu_torch.models.unet3d import SeerUNet

from test_torch_samplers import _t, inputs, tiny_unets

torch.set_num_threads(1)

CONFIGS = [pab.PABConfig(), pab.PABConfig(3, 5, 2, (0.0, 1.0)),
           pab.PABConfig(1, 1, 1), pab.PABConfig(2, 1, 7, (0.25, 0.6)),
           pab.PABConfig(4, 4, 4, (0.5, 0.5))]


@pytest.fixture(scope="module")
def unets():
    return tiny_unets(2)


def _jpab_apply(jm, params):
    def apply(x, t, c, cf, state, flags):
        variables = {"params": params, **({"pab": state} if state else {})}
        out, mut = jm.apply(variables, x, t, c, cf, pab=flags, mutable=["pab"])
        return out, mut["pab"]
    return apply


def _jax_unet_apply(jm, params):
    return lambda x, t, c, cf: jm.apply({"params": params}, x, t, c, cf)


@pytest.mark.parametrize("ci", range(len(CONFIGS)))
def test_schedule_matches_jax(ci):
    cfg = CONFIGS[ci]
    jcfg = jpab.PABConfig(cfg.spatial_range, cfg.cross_range,
                          cfg.temporal_range, cfg.window)
    assert cfg.enabled == jcfg.enabled
    for n in range(1, 61):
        modes, idx = pab.build_pab_schedule(n, cfg)
        jmodes, jidx = jpab.build_pab_schedule(n, jcfg)
        assert modes == jmodes, n
        np.testing.assert_array_equal(idx, jidx)
        assert idx.dtype == np.int32 and modes[0] == pab.COMPUTE_ALL


def _unet_inputs(seed):
    x_T, x0, ctx, _ = inputs(seed)
    x = np.concatenate([x0, x_T], axis=1)
    return x, np.array([700, 700], np.int32), ctx


@pytest.mark.parametrize("mode", [m for m in itertools.product(
    (False, True), repeat=3) if any(m)])
def test_cached_mode_call_matches_jax(unets, mode):
    """All-compute at (x1, t1) writes the cache; the cached mode at other
    inputs (x2, t2) reuses each flagged site's delta and computes the
    rest, on both sides."""
    jm, params, port = unets
    x1, t1, c1 = _unet_inputs(10)
    x2, _, c2 = _unet_inputs(11)
    t2 = np.array([400, 400], np.int32)
    japply = _jpab_apply(jm, params)
    _, state = japply(jnp.asarray(x1), jnp.asarray(t1), jnp.asarray(c1), 0,
                      {}, jpab.mode_to_flags(jpab.COMPUTE_ALL))
    want, _ = japply(jnp.asarray(x2), jnp.asarray(t2), jnp.asarray(c2), 0,
                     state, jpab.mode_to_flags(mode))
    cache = {}
    with torch.no_grad():
        port(_t(x1), torch.from_numpy(t1), _t(c1),
             pab=pab.mode_to_flags(pab.COMPUTE_ALL), pab_cache=cache)
        got = port(_t(x2), torch.from_numpy(t2), _t(c2),
                   pab=pab.mode_to_flags(mode), pab_cache=cache)
        fresh = port(_t(x2), torch.from_numpy(t2), _t(c2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    # the reuse is visible: the cached call is not the fresh one
    assert not torch.allclose(got, fresh, atol=1e-3)


def test_cache_sites_and_all_compute_equals_no_pab(unets):
    _, _, port = unets
    x, t, c = (_t(a) if a.dtype != np.int32 else torch.from_numpy(a)
               for a in _unet_inputs(12))
    cache = {}
    with torch.no_grad():
        got = port(x, t, c, pab=pab.mode_to_flags(pab.COMPUTE_ALL),
                   pab_cache=cache)
        want = port(x, t, c)
    assert torch.equal(got, want)
    text = [n for n, m in port.named_modules()
            if type(m).__name__ == "BasicTextTransformerBlock3D"]
    temporal = [n for n, m in port.named_modules()
                if type(m).__name__ == "BasicTransformerBlock3D"]
    assert sorted(cache) == sorted(
        [f"{n}.attn1" for n in text] + [f"{n}.attn2" for n in text]
        + [f"{n}.attn1" for n in temporal])


def _sample(loop_port, loop_jax, unets, cfg, steps=7, **kw):
    jm, params, port = unets
    x_T, x0, ctx, unc = inputs(13)
    modes, idx = pab.build_pab_schedule(steps + 1, cfg)
    tables = DiffusionSchedule.create(1000).ddim_tables(steps)
    assert len(tables.timesteps) == steps + 1  # the +1 grid: 7 -> 8 calls
    jmodes, jidx = jpab.build_pab_schedule(steps + 1, jpab.PABConfig(
        cfg.spatial_range, cfg.cross_range, cfg.temporal_range, cfg.window))
    want = loop_jax(_jax_unet_apply(jm, params), jnp.asarray(x_T),
                    JSchedule.create(1000).ddim_tables(steps),
                    jnp.asarray(ctx), jnp.asarray(x0), jnp.asarray(unc), 7.5,
                    pab=(jmodes, jidx, _jpab_apply(jm, params)), **kw)
    with torch.no_grad():
        got = loop_port(port, _t(x_T), tables, _t(ctx), _t(x0), _t(unc), 7.5,
                        pab=(modes, idx), **kw)
        off = loop_port(port, _t(x_T), tables, _t(ctx), _t(x0), _t(unc), 7.5,
                        **kw)
    return got, np.asarray(want), off


@pytest.mark.parametrize("sampler", ["ddim", "dpm++"])
def test_pab_sample_matches_jax(unets, sampler):
    loops = ((ddim.ddim_sample_loop, jddim.ddim_sample_loop)
             if sampler == "ddim" else
             (dpm_solver.dpm_solver_sample_loop, jdpm.dpm_solver_sample_loop))
    got, want, off = _sample(*loops, unets, pab.PABConfig(2, 3, 2,
                                                         (0.1, 0.9)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)
    assert not torch.allclose(got, off, atol=1e-3)


@pytest.mark.parametrize("sampler", ["ddim", "dpm++"])
def test_ranges_one_equals_pab_off_bitwise(unets, sampler):
    loop = (ddim.ddim_sample_loop if sampler == "ddim"
            else dpm_solver.dpm_solver_sample_loop)
    _, _, port = unets
    x_T, x0, ctx, unc = (_t(a) for a in inputs(14))
    tables = DiffusionSchedule.create(1000).ddim_tables(6)
    cfg = pab.PABConfig(1, 1, 1)
    assert not cfg.enabled
    with torch.no_grad():
        got = loop(port, x_T, tables, ctx, x0, unc, 7.5,
                   pab=pab.build_pab_schedule(len(tables.timesteps), cfg))
        want = loop(port, x_T, tables, ctx, x0, unc, 7.5)
    assert torch.equal(got, want)


def test_read_before_write_raises(unets):
    _, _, port = unets
    x, t, c = _unet_inputs(15)
    with pytest.raises(ValueError, match="read before it was written"):
        port(_t(x), torch.from_numpy(t), _t(c),
             pab=pab.mode_to_flags((True, False, False)), pab_cache={})
    with pytest.raises(ValueError, match="pab_cache"):
        port(_t(x), torch.from_numpy(t), _t(c),
             pab=pab.mode_to_flags(pab.COMPUTE_ALL))


def test_pab_with_remat_raises(unets):
    _, params, port = unets
    remat = SeerUNet(port.config, remat=True)
    x, t, c = _unet_inputs(16)
    with pytest.raises(ValueError, match="remat"):
        remat(_t(x), torch.from_numpy(t), _t(c),
              pab=pab.mode_to_flags(pab.COMPUTE_ALL), pab_cache={})


def test_pab_refuses_interval_and_unequal_context(unets):
    _, _, port = unets
    _, x0, ctx, unc = (_t(a) for a in inputs(17))
    with pytest.raises(ValueError, match="guidance_interval"):
        ddim.make_eps_fn(port, ctx, x0, unc, 7.5,
                         guidance_interval=(0.0, 500.0), pab_cache={})
    with pytest.raises(ValueError, match="batched CFG"):
        ddim.make_eps_fn(port, ctx, x0, unc[:, :, :8], 7.5, pab_cache={})
    tables = DiffusionSchedule.create(1000).ddim_tables(4)
    with pytest.raises(ValueError, match="PAB schedule has"):
        ddim.ddim_sample_loop(port, x0, tables, ctx, x0, unc, 7.5,
                              pab=pab.build_pab_schedule(3, pab.PABConfig()))
