"""``remat: "save_attn"`` in the port (``ops/remat.py``, ``models/unet3d.py``),
on the CPU in fp32 with toy models made from a seed (no JAX needed).

Two configurations: a narrow SeerUNet whose every attention and FF site is
the plain path, and one whose shapes pass the kernel gates (32 x 32
latents: K2 spatial attention, K1 windowed temporal attention, the c = 64
LN-fused FF, K3 or with ``cond_frames`` 0 K4, and the c = 384 K5), where the
CPU runs each kernel site's plain version through its
``autograd.Function``.

- one micro-step's loss and every trainable gradient under ``save_attn``
  and ``block`` equal those with no remat (atol 1e-7, as
  ``tests/test_torch_training.py::test_remat_equals_no_remat``; they are
  equal bit for bit);
- the attention and FF site computations of one forward + backward,
  counted by wrapping the plain functions: ``save_attn`` computes as many
  as no remat (the FF backward recomputes its intermediates in both),
  ``block`` more;
- unknown policies are refused by name; a replay that reaches more sites
  than its forward recorded raises.
"""
import pytest
import torch

from seervideoldm_tpu_torch.config import config_from_dict, parse_remat
from seervideoldm_tpu_torch.models.clip_text import CLIPTextConfig
from seervideoldm_tpu_torch.models.unet3d import SeerUNet, SeerUNetConfig
from seervideoldm_tpu_torch.models.vae import VAEConfig
from seervideoldm_tpu_torch.ops import remat
from seervideoldm_tpu_torch.ops.kernels import flash_attention as fa
from seervideoldm_tpu_torch.ops.kernels import geglu_ff as gg
from seervideoldm_tpu_torch.ops.kernels import swat_attention as sw
from seervideoldm_tpu_torch.pipelines.text_video import SeerModels
from seervideoldm_tpu_torch.training import trainer

torch.set_num_threads(1)

CASES = {
    # (unet widths, heads, latent, frames, cond_frames)
    "plain_sites": ((32, 64), 4, 8, 4, 2),
    "kernel_gates": ((64, 384), 2, 32, 3, 1),
    "kernel_gates_k4": ((64, 384), 2, 32, 3, 0),
}
POLICIES = (False, "save_attn", "block")


def _models(widths, heads, frames, policy):
    models = SeerModels.initialize(
        num_frames=frames,
        unet_config=SeerUNetConfig(block_out_channels=widths,
                                   layers_per_block=1, norm_num_groups=8,
                                   cross_attention_dim=32,
                                   attention_head_dim=heads),
        vae_config=VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                             norm_num_groups=8),
        clip_config=CLIPTextConfig(vocab_size=100, hidden_size=32,
                                   intermediate_size=64, num_hidden_layers=1,
                                   num_attention_heads=4,
                                   max_position_embeddings=16),
        fstext_kwargs=dict(n_heads=4, num_layers=1), dtype=torch.float32,
        device="cpu", seed=3, trainable_scope="reference", remat=policy)
    # non-zero proj_out, so that every site's gradient reaches its inputs
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for name, p in models.unet.named_parameters():
            if "proj_out" in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    trainer.trainable_masters(models)
    return models


class _Counts:
    """Wraps the plain site functions; counts calls by kind."""

    def __init__(self):
        self.n = {"attention": 0, "ff": 0}
        self._undo = []

    def _wrap(self, owner, key, kind, item=False):
        fn = owner[key] if item else getattr(owner, key)

        def counted(*args, **kwargs):
            self.n[kind] += 1
            return fn(*args, **kwargs)

        if item:
            owner[key] = counted
            self._undo.append(lambda: owner.__setitem__(key, fn))
        else:
            setattr(owner, key, counted)
            self._undo.append(lambda: setattr(owner, key, fn))

    def __enter__(self):
        self._wrap(fa, "flash_attention_plain", "attention")
        self._wrap(sw, "swat_attention_tables_plain", "attention")
        self._wrap(sw, "swat_attention_plain", "attention")
        for mode in list(gg._PLAIN):
            self._wrap(gg._PLAIN, mode, "ff", item=True)
        return self

    def __exit__(self, *exc):
        for undo in reversed(self._undo):
            undo()


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    """{policy: (loss, grads, site counts)} of one micro-step per policy."""
    widths, heads, lat, frames, cond = CASES[request.param]
    gen = torch.Generator().manual_seed(11)
    rn = lambda *s: torch.randn(s, generator=gen)  # noqa: E731
    batch = {"latents_x0": rn(1, cond, lat, lat, 4),
             "latents": rn(1, frames - cond, lat, lat, 4),
             "clip_emb": rn(1, 16, 32)}
    noise = rn(1, frames - cond, lat, lat, 4)
    ts = torch.tensor([321])
    out = {}
    for policy in POLICIES:
        models = _models(widths, heads, frames, policy)
        step = trainer.make_train_step(models, cond_frames=cond)
        with _Counts() as counts:
            loss, _, grads = step.loss_and_grads(list(models.masters), batch,
                                                 noise, ts)
        out[policy] = (loss, grads, dict(counts.n))
    return out


def test_save_attn_equals_no_remat(runs):
    loss0, grads0, _ = runs[False]
    assert sum(float(g.abs().sum()) for g in grads0.values()) > 0.0
    for policy in ("save_attn", "block"):
        loss, grads, _ = runs[policy]
        assert float(loss) == float(loss0), policy
        assert set(grads) == set(grads0)
        for name in grads0:
            torch.testing.assert_close(grads[name], grads0[name], atol=1e-7,
                                       rtol=0, msg=f"{policy} {name}")


def test_save_attn_computes_no_site_twice(runs):
    none, saved, block = (runs[p][2] for p in POLICIES)
    assert none["attention"] > 0 and none["ff"] > 0
    assert saved == none
    assert block["attention"] > none["attention"]
    assert block["ff"] > none["ff"]


@pytest.mark.parametrize("value", ["bogus", "save-attn", "SAVE", 2.5])
def test_unknown_policies_are_refused(value):
    with pytest.raises(ValueError, match="not supported"):
        parse_remat(value)
    with pytest.raises(ValueError, match="not supported"):
        config_from_dict({"remat": value})
    with pytest.raises(ValueError, match="remat must be"):
        SeerUNet(SeerUNetConfig(block_out_channels=(32, 64),
                                layers_per_block=1, norm_num_groups=8),
                 remat=value)


@pytest.mark.parametrize("value,want", [("save_attn", "save_attn"),
                                        ("SAVE_ATTN", "save_attn"),
                                        ("block", "block"), (True, True),
                                        ("none", False), (None, False)])
def test_known_policies_parse(value, want):
    assert parse_remat(value) == want
    assert config_from_dict({"remat": value}).remat == want


def test_train_config_builds_a_save_attn_unet():
    """The train entry's path: ``remat: save_attn`` in a config reaches the
    SeerUNet that ``load_models`` builds for training."""
    from seervideoldm_tpu_torch.pipelines.loading import load_models

    cfg = config_from_dict({
        "remat": "save_attn", "num_frames": 4, "mixed_precision": "no",
        "model_overrides": {
            "unet": {"block_out_channels": [32, 64], "layers_per_block": 1,
                     "norm_num_groups": 8, "cross_attention_dim": 32,
                     "attention_head_dim": 4},
            "vae": {"block_out_channels": [16, 32], "layers_per_block": 1,
                    "norm_num_groups": 8},
            "clip": {"vocab_size": 49408, "hidden_size": 32,
                     "intermediate_size": 64, "num_hidden_layers": 1,
                     "num_attention_heads": 4, "max_position_embeddings": 77},
            "fstext": {"n_heads": 4, "num_layers": 1}}})
    models, _ = load_models(cfg, "cpu", trainable_scope="reference")
    assert models.unet.remat == "save_attn"


def test_replay_past_the_record_raises():
    record, replay = remat.save_attn_contexts()
    with record:
        remat.saved_site(lambda: (torch.ones(2),))
    with replay:
        torch.testing.assert_close(remat.saved_site(lambda: (None,))[0],
                                   torch.ones(2))
        with pytest.raises(RuntimeError, match="more sites"):
            remat.saved_site(lambda: (torch.ones(2),))
    assert remat.saved_site(lambda: (torch.zeros(1),))[0].item() == 0.0
