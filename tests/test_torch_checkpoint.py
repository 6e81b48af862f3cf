"""The port's training checkpoints (``seervideoldm_tpu_torch/io/checkpoint.py``
and ``pipelines/loading.py::load_finetuned``) on the CPU at toy widths:

- save -> ``load_finetuned`` round trip: the two weight files hold the
  masters (the EMA when it is on) under the reference's names and load
  strictly into models built for sampling;
- a directory written by the JAX package's ``export_reference_checkpoint``
  loads strictly into the port and equals ``load_jax_params``;
- a resume from ``train_state.pt`` continues bit for bit;
- ``max_to_keep`` and ``latest_step``.
"""
import os

import numpy as np
import pytest
import torch

from seervideoldm_tpu_torch.io.checkpoint import (FSTEXT_FILE, STATE_FILE,
                                                  UNET_FILE, CheckpointManager)
from seervideoldm_tpu_torch.models.clip_text import CLIPTextConfig
from seervideoldm_tpu_torch.models.unet3d import SeerUNetConfig
from seervideoldm_tpu_torch.models.vae import VAEConfig
from seervideoldm_tpu_torch.pipelines.loading import load_finetuned
from seervideoldm_tpu_torch.pipelines.text_video import SeerModels
from seervideoldm_tpu_torch.training.optim import build_optimizer
from seervideoldm_tpu_torch.training.trainer import (TrainState,
                                                     make_train_step,
                                                     trainable_masters)

torch.set_num_threads(1)

KW = dict(num_frames=4,
          unet_config=SeerUNetConfig(block_out_channels=(32, 64),
                                     layers_per_block=1, norm_num_groups=8,
                                     cross_attention_dim=32,
                                     attention_head_dim=4),
          vae_config=VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                               norm_num_groups=8),
          clip_config=CLIPTextConfig(vocab_size=100, hidden_size=32,
                                     intermediate_size=64, num_hidden_layers=2,
                                     num_attention_heads=4,
                                     max_position_embeddings=16),
          fstext_kwargs=dict(n_heads=4, num_layers=1), dtype=torch.float32,
          device="cpu")


def _trainer(seed=0, ema=False, accum=2):
    models = SeerModels.initialize(seed=seed, trainable_scope="reference", **KW)
    with torch.no_grad():  # non-zero proj_out, so the temporal sites train
        g = torch.Generator().manual_seed(100 + seed)
        for name, p in models.unet.named_parameters():
            if ".proj_out." in name:
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    opt, _ = build_optimizer(trainable_masters(models), 1e-3, warmup_steps=0,
                             total_steps=20, accumulation_steps=accum)
    state = TrainState.create(opt, ema=ema)
    step = make_train_step(models, cond_frames=1,
                           ema_decay=0.9 if ema else 0.0)
    return models, state, step


def _batch(i):
    g = torch.Generator().manual_seed(1000 + i)
    return {"latents_x0": torch.randn(1, 1, 8, 8, 4, generator=g),
            "latents": torch.randn(1, 3, 8, 8, 4, generator=g),
            "clip_emb": torch.randn(1, 16, 32, generator=g)}


def _run(state, step, micro_steps):
    for i in micro_steps:
        step(state, _batch(i), generator=torch.Generator().manual_seed(i))


@pytest.mark.parametrize("ema", [False, True])
def test_save_then_load_finetuned_round_trip(tmp_path, ema):
    models, state, step = _trainer(ema=ema)
    _run(state, step, range(4))
    path = CheckpointManager(str(tmp_path)).save(2, state, models)
    assert sorted(os.listdir(path)) == sorted([UNET_FILE, FSTEXT_FILE,
                                               STATE_FILE])
    unet_sd = torch.load(os.path.join(path, UNET_FILE))
    assert list(unet_sd) == list(models.unet.state_dict())
    weights = state.ema if ema else state.masters
    if ema:  # the artifact carries the averaged weights, not the raw ones
        assert any(not torch.equal(state.ema[n], state.masters[n])
                   for n in state.masters)
    for name, t in weights.items():
        model, _, pname = name.partition(".")
        if model == "unet":
            assert torch.equal(unet_sd[pname], t), name

    fresh = SeerModels.initialize(seed=5, **KW)  # other weights, for sampling
    load_finetuned(fresh, path)
    for key in ("unet", "fstext"):
        want = getattr(models, key).state_dict()
        for k, v in getattr(fresh, key).state_dict().items():
            src = weights.get(f"{key}.{k}", want[k])
            assert torch.equal(v, src), (key, k)
    assert not any(p.requires_grad for p in fresh.unet.parameters())
    with pytest.raises(FileNotFoundError, match="two-file layout"):
        load_finetuned(fresh, str(tmp_path / "nowhere"))


def test_jax_exported_checkpoint_loads_strictly(tmp_path):
    """``export_reference_checkpoint`` of a JAX parameter tree (manifests:
    the port's own key -> shape maps at this width) -> ``load_finetuned``
    gives the tensors ``load_jax_params`` gives."""
    import jax
    import jax.numpy as jnp

    from seervideoldm_tpu.io.export import export_reference_checkpoint
    from seervideoldm_tpu.models import fstext as jfstext
    from seervideoldm_tpu.models import unet3d as junet
    from seervideoldm_tpu_torch.io.convert import load_jax_params

    ucfg = KW["unet_config"]
    f32 = dict(dtype=jnp.float32, param_dtype=jnp.float32)
    unet = junet.SeerUNet(config=junet.SeerUNetConfig(
        **{k: getattr(ucfg, k) for k in ucfg.__dataclass_fields__}), **f32)
    fst = jfstext.FSTextTransformer(num_frames=4, in_channels=32,
                                    out_channels=32, cross_attention_dim=32,
                                    n_heads=4, num_layers=1, **f32)
    ku, kf = jax.random.split(jax.random.PRNGKey(9))
    up = jax.jit(lambda k: unet.init(
        k, jnp.zeros((1, 4, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 4, 16, 32)), 0)["params"])(ku)
    fp = jax.jit(lambda k: fst.init(k, jnp.zeros((1, 16, 32)))["params"])(kf)
    up, fp = (jax.tree_util.tree_map(np.asarray, t) for t in (up, fp))

    want = SeerModels.initialize(seed=1, **KW)
    load_jax_params(want.unet, up)
    load_jax_params(want.fstext, fp)
    manifests = {name: {k: list(v.shape) for k, v in m.state_dict().items()}
                 for name, m in (("seer_unet", want.unet),
                                 ("fstext", want.fstext))}
    out_dir = str(tmp_path / "learned_sdunet-steps-7")
    export_reference_checkpoint(up, fp, out_dir, manifests)

    got = SeerModels.initialize(seed=2, trainable_scope="reference", **KW)
    load_finetuned(got, out_dir)
    for key in ("unet", "fstext"):
        sd = getattr(want, key).state_dict()
        for k, v in getattr(got, key).state_dict().items():
            assert torch.equal(v, sd[k]), (key, k)
    # models built for training take their masters from the files too
    named = got.named_trainable()
    for name, master in got.masters.items():
        assert torch.equal(master, named[name].detach()), name


@pytest.mark.parametrize("ema", [False, True])
def test_resume_continues_bit_for_bit(tmp_path, ema):
    """6 micro-steps straight vs 3, save (mid accumulation window), a new
    trainer from other weights, restore, 3 more: masters, moments, EMA and
    compute copies equal exactly."""
    models_a, state_a, step_a = _trainer(ema=ema)
    _run(state_a, step_a, range(6))

    models_b, state_b, step_b = _trainer(ema=ema)
    _run(state_b, step_b, range(3))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state_b, models_b)
    models_c, state_c, step_c = _trainer(seed=3, ema=ema)
    mgr.restore(1, state_c, models_c)
    assert state_c.step == 3 and state_c.optimizer.mini_step == 1
    # the frozen weights are not part of the train state: carry them over
    load_finetuned(models_c, mgr.path_for_step(1))
    mgr.restore(1, state_c, models_c)
    _run(state_c, step_c, range(3, 6))

    assert state_c.step == state_a.step == 6
    assert state_c.optimizer.count == state_a.optimizer.count == 3
    for name in state_a.masters:
        assert torch.equal(state_c.masters[name], state_a.masters[name]), name
        if ema:
            assert torch.equal(state_c.ema[name], state_a.ema[name]), name
    sa, sc = state_a.optimizer.state_dict(), state_c.optimizer.state_dict()
    for part in ("mu", "nu", "acc"):
        for name in sa[part]:
            assert torch.equal(sc[part][name], sa[part][name]), (part, name)
    for (ka, va), (kc, vc) in zip(models_a.unet.state_dict().items(),
                                  models_c.unet.state_dict().items()):
        assert ka == kc and torch.equal(va, vc), ka


def test_restore_migrates_ema_toggle(tmp_path, capsys):
    models, state, step = _trainer(ema=False)
    _run(state, step, range(2))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state, models)
    models_e, state_e, _ = _trainer(seed=4, ema=True)
    mgr.restore(1, state_e, models_e)
    assert "seeding the EMA" in capsys.readouterr().out
    for name in state.masters:
        assert torch.equal(state_e.ema[name], state.masters[name]), name
    mgr.save(2, state_e, models_e)
    models_n, state_n, _ = _trainer(seed=6, ema=False)
    mgr.restore(2, state_n, models_n)
    assert "dropping the checkpoint's EMA" in capsys.readouterr().out
    assert state_n.ema is None


def test_max_to_keep_and_latest_step(tmp_path):
    models, state, _ = _trainer()
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_step() is None
    for s in (3, 10, 20):
        mgr.save(s, state, models)
    kept = sorted(d for d in os.listdir(tmp_path)
                  if os.path.isdir(tmp_path / d))
    assert kept == ["learned_sdunet-steps-10", "learned_sdunet-steps-20"]
    assert mgr.latest_step() == 20
    keep_all = CheckpointManager(str(tmp_path / "all"))
    for s in (1, 2, 3):
        keep_all.save(s, state, models)
    assert len(os.listdir(tmp_path / "all")) == 3
