"""The port's samplers and sampling knobs (``diffusion/ddim.py``,
``dpm_solver.py``, ``schedules.py``, ``config.py``) against the JAX
package on the CPU, fp32, the same weights carried by ``io/convert.py``
and the same inputs made with numpy.

- the golden keys ``dpmpp``, ``ddim_zero_snr`` and ``dpmpp_zero_snr`` of
  ``tests/fixtures/golden_latents.npz`` through the port's pipeline with
  the ``build_case`` inputs (rtol 1e-3, atol 1e-4, as the ``ddim`` key in
  ``test_torch_models.py``);
- DPM++ at order 1 equals DDIM (two algebraically equal fp32 updates: rtol
  1e-5 plus 1e-6 of the largest magnitude); on a ``quad`` grid with
  repeated timesteps it stays finite and matches JAX;
- DDIM tables for ``uniform``, ``quad`` and ``trailing`` with zero-SNR off
  and on, over several step counts: timesteps equal, fp32 tables rtol
  1e-6;
- ``make_eps_fn`` with ``guidance_interval``, ``guidance_rescale`` 0.7 and
  two-call CFG against JAX's on a tiny UNet: 1e-5 of the output's largest
  magnitude per element and relative L2 <= 1e-5 (CFG 7.5 scales the
  UNet's fp32 differences up with its output); ``eta`` > 0 at
  ``temperature`` 0; ``stochastic_encode`` and ``ddim_decode_loop`` on the
  same noise (1e-4);
- the knobs under ``{seq: 2}`` on 2 gloo ranks (DDIM with
  ``guidance_rescale``, whose std is then the whole clip's; DPM++; PAB)
  against 1 rank (rtol 1e-3, atol 1e-4, the golden latents' bound of a
  sampled clip);
- the config accepts every knob with the JAX package's checks and still
  refuses the training options not ported.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seervideoldm_tpu.diffusion import ddim as jddim
from seervideoldm_tpu.diffusion import dpm_solver as jdpm
from seervideoldm_tpu.diffusion.schedules import DiffusionSchedule as JSchedule
from seervideoldm_tpu.models import unet3d as junet
from seervideoldm_tpu_torch.config import config_from_dict
from seervideoldm_tpu_torch.diffusion import ddim, dpm_solver
from seervideoldm_tpu_torch.diffusion.schedules import DiffusionSchedule
from seervideoldm_tpu_torch.io.convert import load_jax_params
from seervideoldm_tpu_torch.models.unet3d import SeerUNet, SeerUNetConfig
from seervideoldm_tpu_torch.parallel import launch
from seervideoldm_tpu_torch.pipelines.text_video import SeerPipeline

import torch_parallel_workers as workers
from test_torch_models import GOLDEN, UNET_CFG, _t, case  # noqa: F401

torch.set_num_threads(1)

# the tiny UNet of the knob tests: test_torch_models' widths
TINY = {k: getattr(UNET_CFG, k) for k in UNET_CFG.__dataclass_fields__}


def seeded_params(module, seed, *inputs):
    """Parameters shaped as ``module.init`` makes them (traced only),
    filled from a numpy seed: kernels N(0, 1 / fan_in), norm scales
    1 + N(0, 0.1), the rest N(0, 0.05), so every ``proj_out`` is non-zero
    and every attention site reaches the output."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *inputs))["params"]
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = str(path[-1].key)
        r = rng.randn(*leaf.shape).astype(np.float32)
        if name == "kernel":
            return r * np.float32(np.prod(leaf.shape[:-1]) ** -0.5)
        if name == "scale":
            return 1.0 + 0.1 * r
        return 0.05 * r

    return jax.tree_util.tree_map_with_path(fill, shapes)


def tiny_unets(seed=0, **knobs):
    """(JAX SeerUNet, its params, the port's SeerUNet on the same
    weights), fp32, with ``knobs`` (tome_*, freeu) in both configs."""
    cfg = dict(TINY, **knobs)
    jm = junet.SeerUNet(config=junet.SeerUNetConfig(**cfg))
    params = seeded_params(jm, seed, jnp.zeros((1, 1, 8, 8, 4)),
                           jnp.zeros((1,), jnp.int32),
                           jnp.zeros((1, 1, 16, 32)), 0)
    port = load_jax_params(SeerUNet(SeerUNetConfig(**cfg)).eval(), params)
    return jm, params, port


def jax_apply(jm, params):
    fn = jax.jit(lambda x, t, c: jm.apply({"params": params}, x, t, c, 0))
    return lambda x, t, c, cf=0: fn(x, t, c)


def inputs(seed, b=2, f1=1, f2=3, ctx_len=16):
    rng = np.random.RandomState(seed)
    x_T = rng.randn(b, f2, 8, 8, 4).astype(np.float32)
    x0 = rng.randn(b, f1, 8, 8, 4).astype(np.float32)
    ctx = rng.randn(b, f1 + f2, ctx_len, 32).astype(np.float32)
    unc = rng.randn(b, f1 + f2, ctx_len, 32).astype(np.float32)
    return x_T, x0, ctx, unc


@pytest.fixture(scope="module")
def unets():
    return tiny_unets(0)


# ------------------------------------------------------------- golden keys

@pytest.mark.parametrize("key", ["dpmpp", "ddim_zero_snr", "dpmpp_zero_snr"])
def test_golden_keys(case, key):  # noqa: F811
    """``tests/test_golden_latents.py::compute_outputs`` through the port:
    the ``build_case`` weights and RandomState(3) inputs, 4 steps, CFG 7.5;
    the zero-SNR keys with the rescaled schedule, the trailing grid,
    v-prediction and ``guidance_rescale`` 0.7."""
    rng = np.random.RandomState(3)
    x_T = _t(rng.randn(2, 3, 8, 8, 4))
    x0_emb = _t(rng.randn(2, 1, 8, 8, 4))
    clip_emb = _t(rng.randn(2, 16, 32))
    pipe = case["pipe"]
    kw = dict(ddim_steps=4, guidance_scale=7.5,
              sampler="ddim" if key.startswith("ddim") else "dpm++")
    if key.endswith("zero_snr"):
        pipe = SeerPipeline(pipe.m, schedule=DiffusionSchedule.create(
            1000, rescale_zero_snr=True))
        kw.update(prediction_type="v_prediction", timestep_spacing="trailing",
                  guidance_rescale=0.7)
    context = pipe.fstext(clip_emb)
    uncond = clip_emb[:, None].expand(2, 4, 16, 32)
    got = pipe.sample_latents(x_T, x0_emb, context, uncond, **kw)
    want = np.load(GOLDEN)[key]
    assert got.shape == want.shape == (2, 3, 8, 8, 4)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------- tables

@pytest.mark.parametrize("method", ["uniform", "quad", "trailing"])
@pytest.mark.parametrize("zero_snr", [False, True])
def test_tables_match_jax(method, zero_snr):
    ours = DiffusionSchedule.create(1000, rescale_zero_snr=zero_snr)
    ref = JSchedule.create(1000, rescale_zero_snr=zero_snr)
    assert ours.has_zero_terminal_snr == ref.has_zero_terminal_snr == zero_snr
    np.testing.assert_allclose(ours.alphas_cumprod, ref.alphas_cumprod,
                               rtol=1e-6)
    train = DiffusionSchedule.sd15_train_schedule(rescale_zero_snr=zero_snr)
    np.testing.assert_allclose(
        train.alphas_cumprod,
        JSchedule.sd15_train_schedule(rescale_zero_snr=zero_snr).alphas_cumprod,
        rtol=1e-6)
    for steps in (1, 4, 10, 20, 25, 30, 50, 61):
        got = ours.ddim_tables(steps, eta=0.5, discr_method=method)
        want = ref.ddim_tables(steps, eta=0.5, discr_method=method)
        np.testing.assert_array_equal(got.timesteps, want.timesteps)
        for name in ("alphas", "alphas_prev", "sigmas",
                     "sqrt_one_minus_alphas"):
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=name)


# -------------------------------------------------------------- samplers

def test_dpm_order1_equals_ddim(unets):
    _, _, port = unets
    x_T, x0, ctx, unc = (_t(a) for a in inputs(1))
    tables = DiffusionSchedule.create(1000).ddim_tables(5)
    kw = dict(x0_emb=x0, uncond_context=unc, guidance_scale=3.0)
    with torch.no_grad():
        want = ddim.ddim_sample_loop(port, x_T, tables, ctx, **kw)
        got = dpm_solver.dpm_solver_sample_loop(port, x_T, tables, ctx,
                                                order=1, **kw)
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6 * scale)


@pytest.mark.parametrize("steps", [30, 100])
def test_dpm_degenerate_quad_grid_matches_jax(unets, steps):
    """The ``quad`` grid repeats its first timesteps (h == 0): the step
    drops to first order instead of writing NaN, as in JAX."""
    jm, params, port = unets
    x_T, x0, ctx, unc = inputs(2)
    tables = DiffusionSchedule.create(1000).ddim_tables(steps,
                                                        discr_method="quad")
    assert len(set(tables.timesteps.tolist())) < len(tables.timesteps)
    want = jdpm.dpm_solver_sample_loop(
        jax_apply(jm, params), jnp.asarray(x_T),
        JSchedule.create(1000).ddim_tables(steps, discr_method="quad"),
        jnp.asarray(ctx), jnp.asarray(x0), jnp.asarray(unc), 2.0)
    with torch.no_grad():
        got = dpm_solver.dpm_solver_sample_loop(
            port, _t(x_T), tables, _t(ctx), _t(x0), _t(unc), 2.0)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize("sampler", ["ddim", "dpm++"])
def test_epsilon_at_zero_snr_raises(unets, sampler):
    _, _, port = unets
    x_T, x0, ctx, _ = (_t(a) for a in inputs(3))
    tables = DiffusionSchedule.create(1000, rescale_zero_snr=True).ddim_tables(
        4, discr_method="trailing")
    loop = (ddim.ddim_sample_loop if sampler == "ddim"
            else dpm_solver.dpm_solver_sample_loop)
    with pytest.raises(ValueError, match="undefined at SNR 0"):
        loop(port, x_T, tables, ctx, x0)


EPS_CASES = {
    "interval": dict(guidance_interval=(0.0, 500.0)),
    "rescale": dict(guidance_rescale=0.7),
    "interval_rescale": dict(guidance_interval=(400.0, 1000.0),
                             guidance_rescale=0.3),
    "two_call": dict(two_call=True),
    "two_call_rescale": dict(two_call=True, guidance_rescale=0.7),
}


@pytest.mark.parametrize("name", list(EPS_CASES))
def test_eps_fn_knobs_match_jax(unets, name):
    """One ``make_eps_fn`` call per timestep on both sides; the interval
    case takes the single-batch branch at t = 901 and CFG at t = 301;
    two-call CFG has an uncond context of another length."""
    jm, params, port = unets
    kw = dict(EPS_CASES[name])
    two_call = kw.pop("two_call", False)
    x_T, x0, ctx, unc = inputs(4)
    if two_call:
        unc = np.random.RandomState(5).randn(2, 4, 8, 32).astype(np.float32)
    jeps = jddim.make_eps_fn(jax_apply(jm, params), jnp.asarray(ctx),
                             jnp.asarray(x0), jnp.asarray(unc), 7.5, 0, **kw)
    eps = ddim.make_eps_fn(port, _t(ctx), _t(x0), _t(unc), 7.5, **kw)
    for t in (901, 301):
        want = np.asarray(jeps(jnp.asarray(x_T), jnp.int32(t)))
        with torch.no_grad():
            got = eps(_t(x_T), t)
        assert got.dtype == torch.float32
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * scale,
                                   err_msg=f"t={t}")
        rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert rel <= 1e-5, (t, rel)


def test_eta_at_temperature_zero_matches_jax(unets):
    """Tables made with eta 0.5 change the update's direction term; at
    temperature 0 the drawn noise adds nothing, so both sides agree
    whatever their generators draw."""
    jm, params, port = unets
    x_T, x0, ctx, unc = inputs(6)
    want = jddim.ddim_sample_loop(
        jax_apply(jm, params), jnp.asarray(x_T),
        JSchedule.create(1000).ddim_tables(5, eta=0.5), jnp.asarray(ctx),
        jnp.asarray(x0), jnp.asarray(unc), 3.0,
        eta_noise_key=jax.random.PRNGKey(0), temperature=0.0)
    with torch.no_grad():
        got = ddim.ddim_sample_loop(
            port, _t(x_T), DiffusionSchedule.create(1000).ddim_tables(
                5, eta=0.5), _t(ctx), _t(x0), _t(unc), 3.0,
            eta_generator=torch.Generator().manual_seed(0), temperature=0.0)
        plain = ddim.ddim_sample_loop(
            port, _t(x_T), DiffusionSchedule.create(1000).ddim_tables(5),
            _t(ctx), _t(x0), _t(unc), 3.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-4)
    assert not torch.allclose(got, plain, atol=1e-3)


@pytest.mark.parametrize("t_enc", [0, 2, 5, 6])
def test_stochastic_encode_and_decode_match_jax(unets, t_enc):
    """Encode at forward index ``t_enc`` (6 = the grid's length, clamped to
    the noisiest step) and decode the last ``t_enc`` steps, same noise."""
    jm, params, port = unets
    x_T, x0, ctx, unc = inputs(7)
    noise = np.random.RandomState(8).randn(*x_T.shape).astype(np.float32)
    jt = JSchedule.create(1000).ddim_tables(6)
    tables = DiffusionSchedule.create(1000).ddim_tables(6)
    jx = jddim.stochastic_encode(jt, jnp.asarray(x_T), jnp.asarray(t_enc),
                                 jnp.asarray(noise))
    x = ddim.stochastic_encode(tables, _t(x_T), t_enc, _t(noise))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-6)
    if t_enc == 0:
        return
    want = jddim.ddim_decode_loop(
        jax_apply(jm, params), jx, jt, jnp.asarray(ctx), t_enc,
        jnp.asarray(unc), 5.0, x0_emb=jnp.asarray(x0))
    with torch.no_grad():
        got = ddim.ddim_decode_loop(port, x, tables, _t(ctx), t_enc, _t(unc),
                                    5.0, x0_emb=_t(x0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


# ------------------------------------------------------------ under seq

SEQ_CASES = {
    "ddim_rescale": dict(sampler="ddim", guidance_rescale=0.7),
    "dpmpp": dict(sampler="dpm++"),
    "pab": dict(sampler="ddim", pab=(2, 3, 2)),
}


@pytest.fixture(scope="module")
def seq_runs():
    jm = junet.SeerUNet(config=junet.SeerUNetConfig(**TINY))
    params = seeded_params(jm, 1, jnp.zeros((1, 1, 8, 8, 4)),
                           jnp.zeros((1,), jnp.int32),
                           jnp.zeros((1, 1, 16, 32)), 0)
    x_T, x0, ctx, unc = inputs(9, f1=2, f2=3)
    sent = {"x_T": x_T, "x0": x0, "ctx": ctx, "unc": unc}
    params = jax.tree_util.tree_map(np.asarray, params)
    one = launch.run(workers.knob_cases, 1,
                     args=(TINY, params, sent, SEQ_CASES, None),
                     device="cpu", timeout=240, threads=1)[0]
    two = launch.run(workers.knob_cases, 2,
                     args=(TINY, params, sent, SEQ_CASES, {"seq": 2}),
                     device="cpu", timeout=240, threads=1)[0]
    return one, two


@pytest.mark.parametrize("name", list(SEQ_CASES))
def test_knobs_under_seq_match_one_rank(seq_runs, name):
    """5 frames (2 cond) over 2 ranks: 3 and 2 frames, so rank 1 holds only
    future frames and rank 0 both kinds."""
    one, two = seq_runs
    np.testing.assert_allclose(two[name], one[name], rtol=1e-3, atol=1e-4)


# ----------------------------------------------------------------- config

KNOBS = dict(sampler="dpm++", prediction_type="v_prediction",
             timestep_spacing="trailing", rescale_zero_snr=True,
             guidance_rescale=0.7, tome_ratio=0.5, tome_min_tokens=256,
             freeu=[1.5, 1.6, 0.9, 0.2], total_frames=20)


def test_config_accepts_every_knob_like_jax():
    from seervideoldm_tpu.config import Config as JConfig
    from seervideoldm_tpu.config import sampling_kwargs_from as jkw
    from seervideoldm_tpu.config import validate as jvalidate
    from seervideoldm_tpu_torch.config import (sampler_schedule_from,
                                               sampling_kwargs_from)

    for raw in (KNOBS, dict(sampler="dpmpp", guidance_interval=[0, 500]),
                dict(pab=True, pab_spatial_range=3, pab_window=[0.2, 0.8])):
        cfg = config_from_dict(dict(raw))
        jcfg = jvalidate(JConfig(**raw))
        got, want = sampling_kwargs_from(cfg), jkw(jcfg)
        assert got.keys() == want.keys()
        for k in got:
            if k == "pab_config":
                assert (got[k] is None) == (want[k] is None)
                if got[k] is not None:
                    assert vars(got[k]) == vars(want[k])
            else:
                assert got[k] == want[k], k
    zero = sampler_schedule_from(config_from_dict(dict(KNOBS)))
    assert zero.has_zero_terminal_snr


@pytest.mark.parametrize("raw,match", [
    (dict(rescale_zero_snr=True), "requires prediction_type"),
    (dict(tome_ratio=1.0), "tome_ratio"),
    (dict(tome_min_tokens=2), "tome_min_tokens"),
    (dict(freeu=[1.5, 1.6, 0.9]), "freeu"),
    (dict(freeu=[1.5, 1.6, 0.9, 0.0]), "freeu"),
    (dict(guidance_rescale=1.5), "guidance_rescale"),
    (dict(guidance_interval=[500, 0]), "guidance_interval"),
    (dict(pab=True, guidance_interval=[0, 500]), "cannot be combined"),
    (dict(pab=True, pab_spatial_range=0), "spatial_range"),
    (dict(sampler="euler"), "sampler"),
    (dict(timestep_spacing="leading"), "timestep_spacing"),
    (dict(use_8bit_adam=True), "use_8bit_adam"),
    (dict(lora_rank=4), "lora_rank"),
    (dict(param_dtype="bfloat16"), "param_dtype"),
])
def test_config_refusals(raw, match):
    if match in ("use_8bit_adam", "lora_rank", "param_dtype"):
        # ported since: the training options are accepted
        assert getattr(config_from_dict(raw), match) == raw[match]
        return
    with pytest.raises(ValueError, match=match):
        config_from_dict(raw)
