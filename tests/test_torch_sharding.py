"""ZeRO-1 and FSDP in the port (``parallel/sharding.py``, the trainer, the
checkpoints and the train entry) on 2 gloo CPU ranks, against the port's
replicated data-parallel run on the same global batch.

Weights come from a numpy seed, shaped by the JAX modules' init and
carried with ``io/convert.py`` (every ``proj_out`` non-zero, so that the
temporal sites and the LoRA adapters get gradients); the prepared batch
and every micro-step's noise and timesteps are numpy draws.  One launch
runs every case; each rank trains on its row of the batch of 2.

- one micro-step's gradients under ``zero1`` and ``fsdp`` equal the
  replicated run's bit for bit; after 6 micro-steps (accumulation 2, EMA
  0.9, lr 1e-3) the losses agree within rtol 2e-5 and the masters and EMA
  within atol 2e-6 (the clip's global norm is summed over the shards in
  another order, so the last bits may differ);
- the state stays sharded: per rank the moments, and under fsdp every
  parameter and master, at half the replicated run's plus the padding;
- 8-bit moments under ``zero1`` (no clip, so that the norm's order does
  not enter): codes, scales and masters after 3 optimizer steps equal the
  replicated run's bit for bit;
- FSDP under ``remat: block`` and ``save_attn``: the gradients equal FSDP
  without remat within atol 1e-7;
- LoRA under FSDP: the gradients equal the replicated LoRA step's bit for
  bit, and two optimizer steps agree within atol 2e-6;
- checkpoints written under ``zero1`` and ``fsdp`` hold the replicated
  run's files under the same keys (values within 2e-6); the 2-rank FSDP
  checkpoint resumes on 1 rank to the next loss of the replicated one, and
  a 1-rank checkpoint resumes under FSDP on 2 ranks to the next loss of
  its replicated resume;
- no module reads a weight outside the FSDP unit that holds it;
- the train entry decides as the JAX entry does and prints its lines:
  ``zero1`` / ``fsdp`` ignored at ``data`` 1, ``zero1`` subsumed by
  ``fsdp`` on 2 ranks, where it trains, writes its checkpoint and logs.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seervideoldm_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from seervideoldm_tpu.models.clip_text import CLIPTextModel as JCLIP
from seervideoldm_tpu.models.fstext import FSTextTransformer as JFSText
from seervideoldm_tpu.models.unet3d import SeerUNet as JSeerUNet
from seervideoldm_tpu.models.unet3d import SeerUNetConfig as JUNetConfig
from seervideoldm_tpu.models.vae import AutoencoderKL as JVAE
from seervideoldm_tpu.models.vae import VAEConfig as JVAEConfig
from seervideoldm_tpu_torch.parallel import launch
from seervideoldm_tpu_torch.parallel.mesh import create_mesh
from seervideoldm_tpu_torch.parallel.sharding import ALIGN, decide_mode

import torch_sharding_workers as workers
from test_torch_parallel import _seeded_init
from test_torch_train_entry import _train_cfg

TIMEOUT = 300
UNET = dict(block_out_channels=(32, 64), layers_per_block=1,
            norm_num_groups=8, cross_attention_dim=32, attention_head_dim=4)
VAE = dict(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=8)
CLIP = dict(vocab_size=100, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=16)
FSTEXT = dict(n_heads=4, num_layers=1)
FRAMES, COND, B = 4, 2, 2
SIZES = dict(frames=FRAMES, cond=COND, unet=UNET, vae=VAE, clip=CLIP,
             fstext=FSTEXT)
BASE = dict(lr=1e-3, warmup=0, accum=2, ema=0.9, steps=6)
LORA = dict(lr=1e-3, warmup=0, accum=1, steps=2, lora_rank=2, grads=True)
Q = dict(BASE, use_8bit=True, max_grad_norm=float("inf"))


def _jparams():
    seq = CLIP["max_position_embeddings"]
    kw = dict(dtype=jnp.float32, param_dtype=jnp.float32)
    mods = dict(
        unet=(JSeerUNet(config=JUNetConfig(**UNET), **kw),
              (jnp.zeros((1, FRAMES, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
               jnp.zeros((1, FRAMES, seq, 32)), 0)),
        fstext=(JFSText(num_frames=FRAMES, in_channels=32, out_channels=32,
                        cross_attention_dim=32, **FSTEXT, **kw),
                (jnp.zeros((1, seq, 32)),)),
        vae=(JVAE(config=JVAEConfig(**VAE), **kw),
             (jnp.zeros((1, 16, 16, 3)),)),
        clip=(JCLIP(config=JCLIPConfig(**CLIP), **kw),
              (jnp.zeros((1, seq), jnp.int32),)))
    return {k: _seeded_init(m, i, *inputs)
            for i, (k, (m, inputs)) in enumerate(mods.items())}


def _batch_and_draws():
    rng = np.random.RandomState(3)
    lat = (B, FRAMES - COND, 8, 8, 4)
    batch = {"latents_x0": rng.randn(B, COND, 8, 8, 4).astype(np.float32),
             "latents": rng.randn(*lat).astype(np.float32),
             "clip_emb": rng.randn(B, 16, 32).astype(np.float32)}
    draws = [{"noise": rng.randn(*lat).astype(np.float32),
              "ts": rng.randint(0, 1000, (B,))} for _ in range(10)]
    return batch, draws


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharding")
    jparams = _jparams()
    batch, draws = _batch_and_draws()
    # a one-rank checkpoint after 4 micro-steps, for the resume on 2 ranks
    one = os.path.join(tmp, "one")
    workers.run_case(SIZES, jparams, batch, draws,
                     dict(BASE, steps=4, save_dir=one), create_mesh(None))
    cases = {
        "none": dict(BASE, grads=True, save_dir=os.path.join(tmp, "none")),
        "zero1": dict(BASE, mode="zero1", grads=True,
                      save_dir=os.path.join(tmp, "zero1")),
        "fsdp": dict(BASE, mode="fsdp", grads=True,
                     save_dir=os.path.join(tmp, "fsdp")),
        "q_none": Q, "q_zero1": dict(Q, mode="zero1"),
        "fsdp_block": dict(BASE, mode="fsdp", remat="block", grads=True,
                           steps=0),
        "fsdp_save_attn": dict(BASE, mode="fsdp", remat="save_attn",
                               grads=True, steps=0),
        "lora_none": LORA, "lora_fsdp": dict(LORA, mode="fsdp"),
        "resume_none": dict(BASE, steps=1, resume=(one, 4)),
        "resume_fsdp": dict(BASE, mode="fsdp", steps=1, resume=(one, 4)),
    }
    got = launch.run(workers.sharded_cases, 2,
                     args=(SIZES, jparams, batch, draws, cases),
                     device="cpu", timeout=TIMEOUT, threads=1)
    # the 2-rank checkpoints (written after 6 micro-steps) resumed on 1
    # rank, one micro-step each
    resumed = {mode: workers.run_case(
        SIZES, jparams, batch, draws,
        dict(BASE, steps=1, resume=(os.path.join(tmp, mode), 6)),
        create_mesh(None)) for mode in ("none", "fsdp")}
    return dict(rank0=got[0], rank1=got[1], resumed=resumed, tmp=str(tmp),
                jparams=jparams)


def _max_diff(a: dict, b: dict) -> float:
    assert set(a) == set(b)
    return max(float(np.abs(a[n] - b[n]).max()) for n in b)


@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_sharded_training_equals_replicated(runs, mode):
    got, want = runs["rank0"][mode], runs["rank0"]["none"]
    for name, g in want["grads"].items():
        np.testing.assert_array_equal(got["grads"][name], g, err_msg=name)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-5)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                               rtol=2e-5)
    assert _max_diff(got["masters"], want["masters"]) <= 2e-6
    assert _max_diff(got["ema"], want["ema"]) <= 2e-6
    init = workers.build(SIZES, runs["jparams"])[0].masters
    moved = [n for n, t in got["masters"].items()
             if not np.array_equal(t, init[n].numpy())]
    assert len(moved) > 0.9 * len(init), "the masters did not move"


@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_state_stays_sharded_per_rank(runs, mode):
    """Per rank: the moments at half the replicated run's plus the padding
    (under ALIGN elements a leaf and a group's tail, at 4 bytes an
    element), and under fsdp the parameters and masters at half plus the
    padding of the layouts this rank holds."""
    groups = runs["rank0"][mode]["groups"]
    pad = sum((len(row["shapes"]) + 1) * ALIGN * 4 for row in groups.values())
    for rank in ("rank0", "rank1"):
        got, want = runs[rank][mode], runs[rank]["none"]
        # two moments, each padded as its group
        assert got["moment_bytes"] <= want["moment_bytes"] / 2 + 2 * pad
        if mode == "fsdp":
            assert got["param_bytes"] <= (want["param_bytes"] / 2
                                          + got["pad_bytes"])
        else:
            # the parameters stay replicated (the masters in flat groups)
            assert got["param_bytes"] <= want["param_bytes"] + 2 * pad


def test_8bit_moments_under_zero1_equal_replicated_bit_for_bit(runs):
    got, want = runs["rank0"]["q_zero1"], runs["rank0"]["q_none"]
    for key in ("mu", "nu"):
        assert set(got["optimizer"][key]) == set(want["optimizer"][key])
        for name, q in want["optimizer"][key].items():
            assert q["codes"].dtype == np.int8
            np.testing.assert_array_equal(got["optimizer"][key][name]["codes"],
                                          q["codes"], err_msg=name)
            np.testing.assert_array_equal(
                got["optimizer"][key][name]["scales"], q["scales"],
                err_msg=name)
    for name, m in want["masters"].items():
        np.testing.assert_array_equal(got["masters"][name], m, err_msg=name)
    assert got["optimizer"]["count"] == 3


@pytest.mark.parametrize("remat", ["block", "save_attn"])
def test_fsdp_under_remat_equals_fsdp(runs, remat):
    got = runs["rank0"][f"fsdp_{remat}"]["grads"]
    want = runs["rank0"]["fsdp"]["grads"]
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name], g, atol=1e-7, rtol=0,
                                   err_msg=name)


def test_lora_under_fsdp_equals_replicated(runs):
    got, want = runs["rank0"]["lora_fsdp"], runs["rank0"]["lora_none"]
    assert any(n.startswith("lora.") for n in want["grads"])
    assert set(got["grads"]) == set(want["grads"])
    for name, g in want["grads"].items():
        np.testing.assert_array_equal(got["grads"][name], g, err_msg=name)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-5)
    assert _max_diff(got["masters"], want["masters"]) <= 2e-6
    b_moved = [n for n, t in got["masters"].items()
               if n.endswith(".lora_b") and np.abs(t).max() > 0]
    assert b_moved


@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_sharded_checkpoint_equals_replicated(runs, mode):
    def flat(d, prefix=""):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}/"))
            else:
                out[prefix + k] = v
        return out

    for fname in ("pytorch_model.bin", "pytorch_model_1.bin",
                  "train_state.pt"):
        got = flat(torch.load(os.path.join(runs["tmp"], mode,
                                           "learned_sdunet-steps-6", fname)))
        want = flat(torch.load(os.path.join(runs["tmp"], "none",
                                            "learned_sdunet-steps-6", fname)))
        assert set(got) == set(want), fname
        for key, w in want.items():
            if torch.is_tensor(w):
                assert got[key].shape == w.shape and got[key].dtype == w.dtype
                np.testing.assert_allclose(got[key].float().numpy(),
                                           w.float().numpy(), atol=2e-6,
                                           err_msg=f"{fname} {key}")
            else:
                assert got[key] == w, (fname, key)


def test_checkpoints_resume_across_world_sizes(runs):
    r = runs["resumed"]
    np.testing.assert_allclose(r["fsdp"]["losses"], r["none"]["losses"],
                               rtol=2e-5)
    two = runs["rank0"]
    np.testing.assert_allclose(two["resume_fsdp"]["losses"],
                               two["resume_none"]["losses"], rtol=2e-5)
    assert _max_diff(two["resume_fsdp"]["masters"],
                     two["resume_none"]["masters"]) <= 2e-6


def test_no_weight_is_read_outside_its_unit(runs):
    """Under fsdp, a training micro-step, a VAE encode and decode and a
    CLIP call take no op on a closed unit's placeholder: every module that
    reads a weight runs inside the unit that holds it (a module that reads
    a child's weight without calling the child must declare
    ``fsdp_unit``)."""
    batch, draws = _batch_and_draws()
    got = launch.run(workers.placeholder_reads, 2,
                     args=(SIZES, runs["jparams"], batch, draws),
                     device="cpu", timeout=TIMEOUT, threads=1)
    for r in got:
        assert r["units"] > 0 and np.isfinite(r["loss"])
        assert r["reads"] == []


@pytest.mark.parametrize("zero1", [False, True])
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("n_data", [1, 2])
def test_mode_decision_is_the_jax_entrys(zero1, fsdp, n_data):
    mode, notes = decide_mode(zero1, fsdp, n_data)
    multi = n_data > 1
    want = ("fsdp" if fsdp and multi else
            "zero1" if zero1 and multi else None)
    assert mode == want
    lines = []
    if fsdp and not multi:
        lines.append("fsdp: ignored — mesh has no multi-device 'data' axis")
    if zero1 and not multi:
        lines.append("zero1: ignored — mesh has no multi-device 'data' axis")
    if zero1 and fsdp and multi:
        lines.append("zero1: subsumed by fsdp (ZeRO-3 already shards the "
                     "moments)")
    assert notes == lines


def test_train_entry_prints_the_lines_and_trains_under_fsdp(tmp_path, capsys):
    from seervideoldm_tpu_torch.train import train

    cfg, _ = _train_cfg(tmp_path, zero1=True, fsdp=True, max_train_steps=2,
                        save_steps=2, output_dir=str(tmp_path / "one"))
    summary = train(dict(cfg), device="cpu")
    out = capsys.readouterr().out
    assert "fsdp: ignored — mesh has no multi-device 'data' axis" in out
    assert "zero1: ignored — mesh has no multi-device 'data' axis" in out
    assert summary["sharding"] is None

    cfg, _ = _train_cfg(tmp_path, zero1=True, fsdp=True, max_train_steps=2,
                        save_steps=2, train_batch_size=1,
                        mesh_shape={"data": 2},
                        output_dir=str(tmp_path / "two"))
    got = launch.run(workers.entry_run, 2, args=(cfg,), device="cpu",
                     timeout=TIMEOUT, threads=1)
    assert ("zero1: subsumed by fsdp (ZeRO-3 already shards the moments)"
            in got[0]["stdout"])
    s = got[0]["summary"]
    assert s["sharding"] == "fsdp" and s["global_step"] == 2
    state = torch.load(os.path.join(s["checkpoint"], "train_state.pt"))
    assert set(state["masters"]) == set(
        torch.load(os.path.join(tmp_path, "one", "learned_sdunet-steps-2",
                                "train_state.pt"))["masters"])
    # the half of the parameters each rank holds
    assert got[1]["summary"]["param_bytes"] < 0.6 * summary["param_bytes"]
