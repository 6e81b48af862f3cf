"""The port's training slice (``seervideoldm_tpu_torch/diffusion/ddpm.py``,
``training/``, ``models`` with ``cond_frame`` at call time) against the JAX
package, on the CPU in fp32.

- ``add_noise`` / ``get_velocity`` / ``min_snr_weight`` vs the JAX functions
  (atol 1e-6: the same fp32 formulas);
- ``lr_schedule`` vs the optax schedules the JAX package builds (rtol 1e-6);
- ``Optimizer`` vs ``build_optimizer(..., partitioned=True)`` over 4
  optimizer updates with accumulation 2 on a small tree (params within
  1e-6);
- ``trainable_names`` equals ``trainable_mask`` through the converter's
  name map;
- one train step of the whole slice at toy widths (the UNet/VAE/FSText
  widths of ``tools/overfit_one_clip.py``), ``cond_frames`` 2: the same
  weights (``io/convert.py``), the same batch, the JAX noise and timesteps
  fed to the port: loss, ``mse``, ``grad_norm`` and every trainable gradient
  vs the JAX trainer's (gradients captured exactly with ``optax.trace(0)``),
  then parameters and EMA after two optimizer steps with accumulation 2;
- ``remat`` (``True`` and ``save_attn``) equals off; ``cond_frame`` at call
  time equals the constructor's value.

Tolerances are stated at each comparison (fp32 summation-order differences
between XLA and PyTorch on the CPU).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seervideoldm_tpu.diffusion import ddpm as jddpm
from seervideoldm_tpu.diffusion.schedules import DiffusionSchedule as JSchedule
from seervideoldm_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from seervideoldm_tpu.models.unet3d import SeerUNetConfig as JUNetConfig
from seervideoldm_tpu.models.vae import VAEConfig as JVAEConfig
from seervideoldm_tpu.pipelines.text_video import SeerModels as JSeerModels
from seervideoldm_tpu.training import optim as joptim
from seervideoldm_tpu.training import trainer as jtrainer
from seervideoldm_tpu_torch.diffusion import ddpm as tddpm
from seervideoldm_tpu_torch.diffusion.schedules import DiffusionSchedule
from seervideoldm_tpu_torch.io.convert import (jax_subtree_to_named,
                                               jax_train_state_to_torch,
                                               load_jax_params)
from seervideoldm_tpu_torch.models.clip_text import CLIPTextConfig
from seervideoldm_tpu_torch.models.unet3d import SeerUNet, SeerUNetConfig
from seervideoldm_tpu_torch.models.vae import VAEConfig
from seervideoldm_tpu_torch.pipelines.text_video import SeerModels
from seervideoldm_tpu_torch.training import optim as toptim
from seervideoldm_tpu_torch.training import trainer as ttrainer

torch.set_num_threads(1)

UNET = dict(block_out_channels=(32, 64), layers_per_block=1, norm_num_groups=8,
            cross_attention_dim=32, attention_head_dim=4)
VAE = dict(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=8)
CLIP = dict(vocab_size=100, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=16)
FSTEXT = dict(n_heads=4, num_layers=1)
FRAMES, COND = 4, 2


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ------------------------------------------------------------- ddpm ops

def test_sd15_train_schedule_matches_jax():
    want = JSchedule.sd15_train_schedule()
    got = DiffusionSchedule.sd15_train_schedule()
    assert got.num_timesteps == want.num_timesteps == 1000
    np.testing.assert_array_equal(got.alphas_cumprod, want.alphas_cumprod)
    np.testing.assert_array_equal(got.betas, want.betas)


@pytest.mark.parametrize("fn", ["add_noise", "get_velocity"])
def test_noise_ops_match_jax(fn):
    rng = np.random.RandomState(0)
    acp = JSchedule.sd15_train_schedule().alphas_cumprod
    x = rng.randn(3, 2, 4, 4, 4).astype(np.float32)
    eps = rng.randn(3, 2, 4, 4, 4).astype(np.float32)
    ts = np.array([0, 517, 999], np.int32)
    want = np.asarray(getattr(jddpm, fn)(jnp.asarray(acp), jnp.asarray(x),
                                         jnp.asarray(eps), jnp.asarray(ts)))
    got = getattr(tddpm, fn)(_t(acp), _t(x), _t(eps), torch.from_numpy(ts))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("ptype", ["epsilon", "v_prediction"])
def test_min_snr_weight_matches_jax(ptype):
    acp = JSchedule.sd15_train_schedule().alphas_cumprod
    ts = np.array([0, 1, 250, 517, 998, 999], np.int32)
    want = np.asarray(jddpm.min_snr_weight(jnp.asarray(acp), jnp.asarray(ts),
                                           5.0, ptype))
    got = tddpm.min_snr_weight(_t(acp), torch.from_numpy(ts), 5.0, ptype)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ schedules

@pytest.mark.parametrize("name,warmup,total", [
    ("cosine", 10, 100), ("cosine", 0, 50), ("cosine", 20, 10),
    ("linear", 10, 100), ("linear", 20, 10), ("constant", 0, 100),
    ("constant_with_warmup", 5, 100)])
def test_lr_schedule_matches_optax(name, warmup, total):
    """Steps 0, 1, the warmup boundary, mid-run, the end and beyond; within
    1e-6 relative, or 1e-6 of the peak rate where optax's fp32 cosine nears
    zero."""
    want = joptim.lr_schedule(name, 3e-4, warmup, total)
    got = toptim.lr_schedule(name, 3e-4, warmup, total)
    for step in sorted({0, 1, max(warmup - 1, 0), warmup, warmup + 1,
                        total // 2, total - 1, total, total + 7}):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=3e-10, err_msg=f"step {step}")


def test_lr_schedule_refuses_unknown():
    with pytest.raises(ValueError, match="unknown lr scheduler"):
        toptim.lr_schedule("polynomial", 1e-3, 0, 10)


# ------------------------------------------------------------ optimizer

@pytest.mark.parametrize("accum,max_norm", [(2, 0.3), (1, 0.3), (2, 1e9)])
def test_optimizer_matches_optax(accum, max_norm):
    """4 optimizer updates (4 * accum micro-steps) on a small tree, against
    the JAX package's chain: clip -> AdamW(schedule) under MultiSteps.
    max_norm 0.3 clips every step (gradient norms ~ 5), 1e9 never."""
    rng = np.random.RandomState(1)
    shapes = {"a": (7, 5), "b": (11,), "c": (3, 2, 2)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    tx, sched = joptim.build_optimizer(
        p0, 1e-2, scheduler="cosine", warmup_steps=2, total_steps=10,
        weight_decay=1e-2, max_grad_norm=max_norm, accumulation_steps=accum,
        partitioned=True)
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = tx.init(jparams)
    tparams = {k: _t(v) for k, v in p0.items()}
    opt, tsched = toptim.build_optimizer(
        tparams, 1e-2, scheduler="cosine", warmup_steps=2, total_steps=10,
        weight_decay=1e-2, max_grad_norm=max_norm, accumulation_steps=accum)
    for micro in range(4 * accum):
        g = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        did_sync, _ = opt.update({k: _t(v) for k, v in g.items()})
        assert did_sync == ((micro + 1) % accum == 0)
        for k in shapes:
            np.testing.assert_allclose(tparams[k].numpy(),
                                       np.asarray(jparams[k]), atol=1e-6,
                                       err_msg=f"micro-step {micro}, {k}")
    assert opt.count == 4
    assert tsched(3) == pytest.approx(float(sched(3)), rel=1e-6)


def test_optimizer_state_round_trip():
    rng = np.random.RandomState(2)
    mk = lambda: {"w": _t(rng.randn(4, 3)), "b": _t(rng.randn(3))}  # noqa: E731
    grads = [mk() for _ in range(5)]
    p_ref, p_two = mk(), None
    p_two = {k: v.clone() for k, v in p_ref.items()}
    ref, _ = toptim.build_optimizer(p_ref, 1e-2, warmup_steps=0,
                                    total_steps=10, accumulation_steps=2)
    first, _ = toptim.build_optimizer(p_two, 1e-2, warmup_steps=0,
                                      total_steps=10, accumulation_steps=2)
    for g in grads:
        ref.update(g)
    for g in grads[:3]:
        first.update(g)
    saved = copy.deepcopy(first.state_dict())
    second, _ = toptim.build_optimizer(p_two, 1e-2, warmup_steps=0,
                                       total_steps=10, accumulation_steps=2)
    second.load_state_dict(saved)
    for g in grads[3:]:
        second.update(g)
    for k in p_ref:
        assert torch.equal(p_ref[k], p_two[k]), k


# ------------------------------------------------------ the whole slice

def _jax_models():
    return JSeerModels.initialize(
        jax.random.PRNGKey(0), num_frames=FRAMES,
        unet_config=JUNetConfig(**UNET), vae_config=JVAEConfig(**VAE),
        clip_config=JCLIPConfig(**CLIP), fstext_kwargs=FSTEXT,
        dtype=jnp.float32, latent_size=8)


def _port_models(jparams, remat=False):
    models = SeerModels.initialize(
        num_frames=FRAMES, unet_config=SeerUNetConfig(**UNET),
        vae_config=VAEConfig(**VAE), clip_config=CLIPTextConfig(**CLIP),
        fstext_kwargs=FSTEXT, dtype=torch.float32, device="cpu",
        trainable_scope="reference", remat=remat)
    for key in ("unet", "fstext", "vae", "clip"):
        load_jax_params(getattr(models, key), jparams[key])
    ttrainer.trainable_masters(models)
    return models


@pytest.fixture(scope="module")
def slice_case():
    """JAX and port models on one set of weights (every ``proj_out`` given
    seeded non-zero weights: zero-initialised, it makes every gradient
    upstream of it inside a temporal site exactly zero), one batch from the
    JAX prepare function, the JAX trainable/frozen partition."""
    import flax.traverse_util as tu

    jm = _jax_models()
    rng = np.random.RandomState(11)
    flat = tu.flatten_dict(jax.tree_util.tree_map(np.asarray, jm.unet_params))
    for path, val in flat.items():
        if "proj_out" in path:
            flat[path] = (rng.randn(*val.shape) * 0.1).astype(np.float32)
    jm.unet_params = jax.tree_util.tree_map(jnp.asarray,
                                            tu.unflatten_dict(flat))
    jparams = {k: jax.tree_util.tree_map(np.asarray, getattr(jm, f"{k}_params"))
               for k in ("unet", "fstext", "vae", "clip")}
    b, res = 2, 16
    video = rng.uniform(-1, 1, (b, FRAMES, res, res, 3)).astype(np.float32)
    ids = rng.randint(0, 100, (b, 16)).astype(np.int32)
    mask = np.ones((b, 16), np.int32)
    jbatch = jtrainer.prepare_batch_fn(jm, sample_posterior=False)(
        jnp.asarray(video), jnp.asarray(ids), jnp.asarray(mask),
        jax.random.PRNGKey(3), cond_frames=COND)
    params = {"unet": jm.unet_params, "fstext": jm.fstext_params}
    trainable, frozen = jtrainer.partition_params(
        params, joptim.trainable_mask(params, "reference"))
    return dict(jm=jm, jparams=jparams, video=video, ids=ids, mask=mask,
                jbatch=jbatch, trainable=trainable, frozen=frozen)


def _jax_draws(rng_key, step, shape, batch):
    """The noise and timesteps the JAX train step draws at ``step``."""
    k_noise, k_t = jax.random.split(jax.random.fold_in(rng_key, step))
    noise = jax.random.normal(k_noise, shape, dtype=jnp.float32)
    ts = jax.random.randint(k_t, (batch,), 0, 1000)
    return np.asarray(noise), np.asarray(ts)


def _tbatch(jbatch):
    return {k: _t(np.asarray(v)) for k, v in jbatch.items()}


def test_trainable_names_equal_jax_mask(slice_case):
    """The names the port trains are the leaves the JAX mask marks, carried
    through the converter's name map; scope 'all' is every parameter."""
    models = _port_models(slice_case["jparams"])
    modules = models.trainable_modules()
    want = set(jax_subtree_to_named(
        jax.tree_util.tree_map(np.asarray, slice_case["trainable"]), modules))
    got = toptim.trainable_names(modules, "reference")
    assert set(got) == want and len(got) == len(want)
    assert set(models.masters) == want
    assert all(n.startswith("fstext.") or "temporal_attentions" in n
               for n in got)
    everything = toptim.trainable_names(modules, "all")
    assert len(everything) == sum(1 for m in modules.values()
                                  for _ in m.parameters())
    frozen = [p for n, p in models.named_trainable().items() if n not in want]
    assert frozen and not any(p.requires_grad for p in frozen)
    with pytest.raises(ValueError, match="unknown trainable scope"):
        toptim.trainable_names(modules, "temporal")


def test_prepare_batch_matches_jax(slice_case):
    """Frozen CLIP + VAE posterior mean x vae_scale, split at cond_frames
    (atol 2e-5: two small encoders in fp32)."""
    models = _port_models(slice_case["jparams"])
    prepare = ttrainer.prepare_batch_fn(models, sample_posterior=False)
    got = prepare(slice_case["video"], slice_case["ids"], slice_case["mask"],
                  COND)
    for key, want in slice_case["jbatch"].items():
        assert tuple(got[key].shape) == tuple(want.shape), key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want),
                                   atol=2e-5, err_msg=key)
    assert not any(t.requires_grad for t in got.values())
    # a posterior draw from a generator differs from the mean and is
    # reproducible from its seed
    sampled = ttrainer.prepare_batch_fn(models, sample_posterior=True)
    g = torch.Generator().manual_seed(5)
    a = sampled(slice_case["video"], slice_case["ids"], slice_case["mask"],
                COND, generator=g)
    b = sampled(slice_case["video"], slice_case["ids"], slice_case["mask"],
                COND, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a["latents"], b["latents"])
    assert not torch.allclose(a["latents"], got["latents"])


def step_vs_jax(c, text_loss=False, snr_gamma=0.0,
                prediction_type="epsilon", rescale_zero_snr=False):
    """One micro-step of the JAX trainer and of the port on ``c``'s
    weights, batch, noise and timesteps: loss, mse, grad_norm and every
    trainable gradient held at the bounds of
    ``test_one_step_loss_and_gradients_match_jax``.  The JAX gradients are
    read exactly from the state of ``optax.trace(0)`` (its trace after one
    update is the gradient).  Returns the port's loss."""
    from seervideoldm_tpu.diffusion.schedules import (
        DiffusionSchedule as JSchedule)
    from seervideoldm_tpu_torch.diffusion.schedules import DiffusionSchedule

    tx = optax.trace(decay=0.0)
    state = jtrainer.TrainState.create(
        jax.tree_util.tree_map(jnp.copy, c["trainable"]), tx)
    step = jtrainer.make_train_step(
        c["jm"], tx, cond_frames=COND, frozen_params=c["frozen"],
        text_loss=text_loss, snr_gamma=snr_gamma,
        prediction_type=prediction_type,
        schedule=JSchedule.sd15_train_schedule(
            rescale_zero_snr=rescale_zero_snr))
    key = jax.random.PRNGKey(4)
    state, jmetrics = step(state, c["jbatch"], key)
    jgrads = jax.tree_util.tree_map(np.asarray, state.opt_state.trace)

    models = _port_models(c["jparams"])
    tstep = ttrainer.make_train_step(
        models, cond_frames=COND, text_loss=text_loss, snr_gamma=snr_gamma,
        prediction_type=prediction_type,
        schedule=DiffusionSchedule.sd15_train_schedule(
            rescale_zero_snr=rescale_zero_snr))
    noise, ts = _jax_draws(key, 0, c["jbatch"]["latents"].shape, 2)
    names = list(models.masters)
    loss, mse, grads = tstep.loss_and_grads(names, _tbatch(c["jbatch"]),
                                            _t(noise), torch.tensor(ts))
    np.testing.assert_allclose(float(loss), float(jmetrics["loss"]), atol=1e-5)
    np.testing.assert_allclose(float(mse), float(jmetrics["mse"]), atol=1e-5)
    if text_loss or snr_gamma:
        assert abs(float(loss) - float(mse)) > 1e-4
    want = jax_subtree_to_named(jgrads, models.trainable_modules())
    assert set(want) == set(grads)
    nonzero = 0
    for name in names:
        scale = max(1.0, float(want[name].abs().max()))
        np.testing.assert_allclose(grads[name].numpy(), want[name].numpy(),
                                   atol=2e-5 * scale, rtol=1e-4, err_msg=name)
        nonzero += bool(want[name].abs().max() > 1e-6)
    # the comparison is not one of zeros: temporal and FSText gradients flow
    assert nonzero > 0.9 * len(names)
    gnorm = toptim.global_norm([grads[n] for n in names])
    np.testing.assert_allclose(float(gnorm), float(jmetrics["grad_norm"]),
                               rtol=1e-4)
    return float(loss)


@pytest.mark.parametrize("text_loss,snr_gamma", [(False, 0.0), (True, 5.0)])
def test_one_step_loss_and_gradients_match_jax(slice_case, text_loss,
                                               snr_gamma):
    """loss, mse, grad_norm and every trainable gradient of one micro-step.
    Tolerance: 1e-5 abs on loss and mse (values ~ 1); per gradient tensor
    1e-4 rel + 2e-5 of the tensor's largest entry (at least 2e-5 abs): fp32
    summation order, and with ``text_loss`` FSText gradients reach 1e3."""
    step_vs_jax(slice_case, text_loss, snr_gamma)


def test_two_optimizer_steps_with_accumulation_and_ema_match_jax(slice_case):
    """4 micro-steps = 2 optimizer steps (accumulation 2) of the real recipe
    (clip 0.3, AdamW, cosine, weight decay) with the EMA on, on both
    trainers from the same state carried by ``jax_train_state_to_torch``.
    Adam turns each element's gradient into an update of about +-lr whatever
    its size, so an element whose gradient lies below the two frameworks'
    rounding noise could differ by 2 lr; eps = 1e-6 keeps those within the
    tolerance: parameters and EMA within 2e-5 abs (lr 1e-3), metrics within
    1e-4 rel."""
    c = slice_case
    kw = dict(scheduler="cosine", warmup_steps=0, total_steps=10, eps=1e-6,
              accumulation_steps=2)
    trainable = jax.tree_util.tree_map(jnp.copy, c["trainable"])
    tx, _ = joptim.build_optimizer(trainable, 1e-3, partitioned=True, **kw)
    state = jtrainer.TrainState.create(trainable, tx, ema=True)
    step = jtrainer.make_train_step(c["jm"], tx, cond_frames=COND,
                                    frozen_params=c["frozen"], ema_decay=0.5)

    models = _port_models(c["jparams"])
    carried = jax_train_state_to_torch(
        models.trainable_modules(),
        jax.tree_util.tree_map(np.asarray, c["trainable"]))
    masters = ttrainer.trainable_masters(models)
    for name, t in carried["masters"].items():
        assert torch.equal(masters[name], t), name
    opt, _ = toptim.build_optimizer(masters, 1e-3, **kw)
    opt.load_state_dict(carried["optimizer"])
    tstate = ttrainer.TrainState.create(opt, ema=True)
    tstep = ttrainer.make_train_step(models, cond_frames=COND, ema_decay=0.5)
    tbatch = _tbatch(c["jbatch"])
    ema0 = {k: v.clone() for k, v in tstate.ema.items()}
    frozen0 = {n: p.detach().clone()
               for n, p in models.named_trainable().items()
               if n not in masters}

    key = jax.random.PRNGKey(4)
    for micro in range(4):
        noise, ts = _jax_draws(key, micro, c["jbatch"]["latents"].shape, 2)
        state, jm = step(state, c["jbatch"], key)
        tm = tstep(tstate, tbatch, noise=_t(noise),
                   timesteps=torch.tensor(ts))
        assert tm["did_sync"] == (micro % 2 == 1)
        for k in ("loss", "mse", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"micro-step {micro} {k}")
        if micro == 0:  # no sync yet: the EMA has not moved
            for k, v in tstate.ema.items():
                assert torch.equal(v, ema0[k]), k
    assert tstate.step == 4 and opt.count == 2

    modules = models.trainable_modules()
    want_p = jax_subtree_to_named(
        jax.tree_util.tree_map(np.asarray, state.params), modules)
    want_e = jax_subtree_to_named(
        jax.tree_util.tree_map(np.asarray, state.ema_params), modules)
    moved = 0
    for name in masters:
        np.testing.assert_allclose(masters[name].numpy(), want_p[name].numpy(),
                                   atol=2e-5, err_msg=name)
        np.testing.assert_allclose(tstate.ema[name].numpy(),
                                   want_e[name].numpy(), atol=2e-5,
                                   err_msg=name)
        moved += not torch.equal(masters[name], carried["masters"][name])
        # the module computes with what the optimizer updated
        assert torch.equal(models.named_trainable()[name].detach(),
                           masters[name])
    assert moved == len(masters)
    for n, p in models.named_trainable().items():
        if n not in masters:
            assert torch.equal(p.detach(), frozen0[n]), n


def test_remat_equals_no_remat(slice_case):
    """``remat: True`` recomputes each block in the backward, ``save_attn``
    all but the attention and feed-forward outputs it kept: the same loss
    and gradients bit for bit on the CPU.  An unknown policy is refused."""
    c = slice_case
    noise, ts = _jax_draws(jax.random.PRNGKey(4), 0,
                           c["jbatch"]["latents"].shape, 2)
    out = []
    for remat in (False, True, "save_attn"):
        models = _port_models(c["jparams"], remat=remat)
        assert models.unet.remat == remat
        tstep = ttrainer.make_train_step(models, cond_frames=COND)
        out.append(tstep.loss_and_grads(
            list(models.masters), _tbatch(c["jbatch"]), _t(noise),
            torch.tensor(ts)))
    loss_a, _, grads_a = out[0]
    for loss_b, _, grads_b in out[1:]:
        assert float(loss_a) == float(loss_b)
        for name in grads_a:
            np.testing.assert_allclose(grads_b[name].numpy(),
                                       grads_a[name].numpy(), atol=1e-7,
                                       err_msg=name)
    with pytest.raises(ValueError, match="remat must be"):
        SeerUNet(SeerUNetConfig(**UNET), remat="bogus")


def test_cond_frame_at_call_time_equals_constructor(slice_case):
    """One module serves training (cond_frame = cond_frames) and sampling
    (0): the call's argument gives what the constructor's value gave, and
    matches the JAX UNet called with the same cond_frame (atol 1e-4)."""
    c = slice_case
    rng = np.random.RandomState(5)
    x = rng.randn(1, FRAMES, 8, 8, 4).astype(np.float32)
    ctx = rng.randn(1, FRAMES, 16, 32).astype(np.float32)
    ts = np.array([300], np.int32)
    at_call = load_jax_params(SeerUNet(SeerUNetConfig(**UNET)),
                              c["jparams"]["unet"])
    built = load_jax_params(SeerUNet(SeerUNetConfig(**UNET), cond_frame=COND),
                            c["jparams"]["unet"])
    with torch.no_grad():
        got = at_call(_t(x), torch.from_numpy(ts), _t(ctx), cond_frame=COND)
        old = built(_t(x), torch.from_numpy(ts), _t(ctx))
        zero = at_call(_t(x), torch.from_numpy(ts), _t(ctx))
    assert torch.equal(got, old)
    assert not torch.allclose(got, zero)
    want = c["jm"].unet.apply({"params": c["jm"].unet_params}, jnp.asarray(x),
                              jnp.asarray(ts), jnp.asarray(ctx), COND)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_train_step_refuses_missing_ema_and_v_prediction(slice_case):
    """An EMA without its state is refused; v-prediction, refused before it
    was ported, now trains against ``get_velocity``: one micro-step against
    the JAX trainer's at the bounds of the eps step, and another loss than
    the eps step's on the same draws."""
    v_loss = step_vs_jax(slice_case, prediction_type="v_prediction")
    assert abs(v_loss - step_vs_jax(slice_case)) > 1e-4
    models = _port_models(slice_case["jparams"])
    with pytest.raises(ValueError, match="unknown prediction type"):
        ttrainer.make_train_step(models, prediction_type="x0")
    opt, _ = toptim.build_optimizer(ttrainer.trainable_masters(models), 1e-3)
    state = ttrainer.TrainState.create(opt, ema=False)
    step = ttrainer.make_train_step(models, cond_frames=COND, ema_decay=0.9)
    with pytest.raises(ValueError, match="ema_decay > 0 requires"):
        step(state, _tbatch(slice_case["jbatch"]))
    sampling = SeerModels.initialize(
        num_frames=FRAMES, unet_config=SeerUNetConfig(**UNET),
        vae_config=VAEConfig(**VAE), clip_config=CLIPTextConfig(**CLIP),
        fstext_kwargs=FSTEXT, dtype=torch.float32, device="cpu")
    assert sampling.masters is None
    assert not any(p.requires_grad for m in sampling.modules()
                   for p in m.parameters())
    with pytest.raises(ValueError, match="built for sampling"):
        ttrainer.trainable_masters(sampling)
