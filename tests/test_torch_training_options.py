"""The port's training options against the JAX package, on the CPU:
8-bit AdamW (``training/optim8bit.py``), LoRA (``training/lora.py`` and the
trainer's ``lora_scale``), ``param_dtype: bfloat16`` and the native frame
loader (``data/native.py``), then the ``train`` entry with LoRA and 8-bit
AdamW and a sampling entry loading its checkpoint.

Tolerances are stated at each comparison.
"""
import os

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seervideoldm_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from seervideoldm_tpu.models.unet3d import SeerUNetConfig as JUNetConfig
from seervideoldm_tpu.models.vae import VAEConfig as JVAEConfig
from seervideoldm_tpu.pipelines.text_video import SeerModels as JSeerModels
from seervideoldm_tpu.training import lora as jlora
from seervideoldm_tpu.training import optim as joptim
from seervideoldm_tpu.training import optim8bit as j8
from seervideoldm_tpu.training import trainer as jtrainer
from seervideoldm_tpu_torch.io.convert import (jax_subtree_to_named,
                                               jax_to_state_dict,
                                               load_jax_params, normalize_path)
from seervideoldm_tpu_torch.models.clip_text import CLIPTextConfig
from seervideoldm_tpu_torch.models.unet3d import SeerUNet, SeerUNetConfig
from seervideoldm_tpu_torch.models.vae import VAEConfig
from seervideoldm_tpu_torch.pipelines.text_video import SeerModels
from seervideoldm_tpu_torch.training import lora as tlora
from seervideoldm_tpu_torch.training import optim as toptim
from seervideoldm_tpu_torch.training import optim8bit as t8
from seervideoldm_tpu_torch.training import trainer as ttrainer
from test_torch_train_entry import _run, _train_cfg
from test_torch_training import (CLIP, COND, FRAMES, FSTEXT, UNET, VAE,
                                 _jax_draws, _port_models, _t, _tbatch,
                                 slice_case)  # noqa: F401

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_ULP = 2.0 ** -8   # bf16's unit roundoff (8 significand bits)


# ------------------------------------------------------- 8-bit AdamW

def _moment_inputs():
    """Signed and non-negative inputs: a size that is not a multiple of 256
    (the last block padded), one all-zero block, magnitudes over 6 decades,
    and exact ties of the rounding (x / absmax * 127 = k + 0.5)."""
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 700) * 10.0 ** rng.uniform(-6, 0, (3, 700))).astype(
        np.float32)
    x.reshape(-1)[256:512] = 0.0
    x.reshape(-1)[0] = 1.0
    x.reshape(-1)[1:6] = np.array([0.5, 1.5, 2.5, -3.5, 4.5],
                                  np.float32) / 127.0
    return x


@pytest.mark.parametrize("kind", ["signed", "sqrt"])
def test_quantized_codes_equal_jax(kind):
    """int8 codes equal bit for bit and scales within 1e-7 (the same fp32
    operations; round half to even on both sides)."""
    x = _moment_inputs()
    if kind == "sqrt":
        x = np.abs(x) ** 2
    jq = (j8._quantize_signed if kind == "signed" else j8._quantize_sqrt)(
        jnp.asarray(x))
    tq = (t8.quantize_signed if kind == "signed" else t8.quantize_sqrt)(
        torch.from_numpy(x))
    assert tq.codes.dtype == torch.int8 and tq.codes.shape == (9, 256)
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    np.testing.assert_allclose(tq.scales.numpy(), np.asarray(jq.scales),
                               atol=1e-7, rtol=0)
    assert float(tq.scales[1]) == 0.0 or float(tq.scales.min()) >= 0.0
    jback = (j8._dequantize_signed if kind == "signed"
             else j8._dequantize_sqrt)(jq, x.shape)
    tback = (t8.dequantize_signed if kind == "signed"
             else t8.dequantize_sqrt)(tq, x.shape)
    np.testing.assert_allclose(tback.numpy(), np.asarray(jback), atol=1e-7,
                               rtol=0)


def test_twenty_adamw_8bit_steps_match_jax():
    """20 updates of ``adamw_8bit`` (weight decay 1e-2, lr 1e-2) on a tree
    of odd-sized leaves, the same gradients fed to both: parameters within
    1e-6 after every step, and the int8 state equal at the end."""
    rng = np.random.RandomState(1)
    shapes = {"a": (7, 300), "b": (11,), "c": (3, 2, 2), "d": (256,)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    jtx = j8.adamw_8bit(1e-2, weight_decay=1e-2)
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jtx.init(jparams)
    tparams = {k: _t(v) for k, v in p0.items()}
    opt = t8.adamw_8bit(tparams, lambda count: 1e-2, weight_decay=1e-2)
    for step in range(20):
        g = {k: (rng.randn(*s) * 10.0 ** rng.uniform(-3, 1)).astype(np.float32)
             for k, s in shapes.items()}
        upd, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        assert opt.update({k: _t(v) for k, v in g.items()})[0]
        for k in shapes:
            np.testing.assert_allclose(tparams[k].numpy(),
                                       np.asarray(jparams[k]), atol=1e-6,
                                       rtol=0, err_msg=f"step {step}, {k}")
    state = opt.state_dict()
    for key, jq_tree in (("mu", jstate[0].mu), ("nu", jstate[0].nu)):
        for k in shapes:
            np.testing.assert_array_equal(state[key][k]["codes"].numpy(),
                                          np.asarray(jq_tree[k].codes))


def test_build_optimizer_8bit_chain_matches_jax():
    """The whole chain (clip 0.3 -> 8-bit AdamW(cosine) under accumulation
    2), 8 micro-steps on both sides: parameters within 1e-6."""
    rng = np.random.RandomState(2)
    shapes = {"w": (33, 40), "b": (40,)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(scheduler="cosine", warmup_steps=2, total_steps=10,
              weight_decay=1e-2, max_grad_norm=0.3, accumulation_steps=2)
    tx, _ = joptim.build_optimizer(p0, 1e-2, partitioned=True, use_8bit=True,
                                   **kw)
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = tx.init(jparams)
    tparams = {k: _t(v) for k, v in p0.items()}
    opt, _ = toptim.build_optimizer(tparams, 1e-2, use_8bit=True, **kw)
    for micro in range(8):
        g = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        opt.update({k: _t(v) for k, v in g.items()})
        for k in shapes:
            np.testing.assert_allclose(tparams[k].numpy(),
                                       np.asarray(jparams[k]), atol=1e-6,
                                       rtol=0, err_msg=f"micro {micro} {k}")


# the port versions of tests/test_optim8bit.py's cases

def _roundtrip_signed():
    x = torch.randn(3, 500, generator=torch.Generator().manual_seed(0)) * 0.01
    q = t8.quantize_signed(x)
    assert q.codes.dtype == torch.int8
    err = (t8.dequantize_signed(q, x.shape) - x).abs()
    assert float(err.max()) <= (float(x.abs().max()) / 127 + 1e-12) * 1.01


def _roundtrip_sqrt():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(1)
                    ).abs() ** 4 * 1e-6
    q = t8.quantize_sqrt(x)
    assert q.codes.dtype == torch.int8
    back = t8.dequantize_sqrt(q, x.shape)
    rel = (back.sqrt() - x.sqrt()).abs()
    assert float(rel.max()) <= float(x.max().sqrt()) / 255 + 1e-12


def _zero_block_stable():
    x = torch.zeros(700)
    assert float(t8.dequantize_signed(t8.quantize_signed(x), x.shape)
                 .abs().max()) == 0
    assert float(t8.dequantize_sqrt(t8.quantize_sqrt(x), x.shape).max()) == 0


def _trajectory(shape):
    """A quadratic-bowl descent: the 8-bit trajectory tracks fp32 AdamW."""
    def grad(p):
        return 2 * (p - 1.5) + 0.4 * p ** 3

    def loss(p):
        return float(((p - 1.5) ** 2).sum() + 0.1 * (p ** 4).sum())

    p0 = torch.linspace(-1, 1, int(np.prod(shape))).reshape(shape)
    p8, pf = p0.clone(), p0.clone()
    kw = dict(weight_decay=1e-2, max_grad_norm=float("inf"))
    o8 = t8.adamw_8bit({"p": p8}, lambda c: 1e-2, **kw)
    of = toptim.Optimizer({"p": pf}, lambda c: 1e-2, **kw)
    for _ in range(60):
        o8.update({"p": grad(p8)})
        of.update({"p": grad(pf)})
    assert loss(p8) < loss(p0)
    np.testing.assert_allclose(p8.numpy(), pf.numpy(), atol=0.05)


def _state_is_int8():
    params = {"w": torch.ones(300, 5), "b": torch.zeros(7)}
    opt = t8.adamw_8bit(params, lambda c: 1e-3)
    state = opt.state_dict()
    n = sum(p.numel() for p in params.values())
    code_bytes = 0
    for q in state["mu"].values():
        assert q["codes"].dtype == torch.int8
        assert q["scales"].dtype == torch.float32
        code_bytes += q["codes"].numel()
    assert code_bytes <= n + 2 * 256   # padding bound
    assert opt.state_bytes() == 2 * code_bytes + 2 * 4 * code_bytes // 256


def _build_optimizer_8bit_wiring():
    params = {"fstext.w": torch.ones(4, 4)}
    opt, _ = toptim.build_optimizer(params, 1e-3, use_8bit=True,
                                    warmup_steps=0, accumulation_steps=1)
    assert isinstance(opt.moments, t8.Adam8bitMoments)
    did_sync, _ = opt.update({"fstext.w": torch.ones(4, 4)})
    assert did_sync and params["fstext.w"].shape == (4, 4)
    assert not torch.equal(params["fstext.w"], torch.ones(4, 4))


JAX_8BIT_CASES = {
    "quantize_roundtrip_signed": _roundtrip_signed,
    "quantize_roundtrip_sqrt": _roundtrip_sqrt,
    "zero_block_stable": _zero_block_stable,
    "trajectory_tracks_fp32_adamw_37": lambda: _trajectory((37,)),
    "trajectory_tracks_fp32_adamw_16x33": lambda: _trajectory((16, 33)),
    "state_is_int8": _state_is_int8,
    "build_optimizer_8bit_wiring": _build_optimizer_8bit_wiring,
}


@pytest.mark.parametrize("case", sorted(JAX_8BIT_CASES))
def test_optim8bit_cases_as_jax(case):
    JAX_8BIT_CASES[case]()


def test_8bit_state_round_trips_through_a_checkpoint(tmp_path):
    """Chunked state (two chunks at a 4-block limit): saved per leaf,
    loaded into a fresh optimizer, the next updates equal bit for bit."""
    rng = np.random.RandomState(3)
    shapes = {"a": (700,), "b": (300,), "c": (5, 5)}
    mk = lambda: {k: _t(rng.randn(*s)) for k, s in shapes.items()}  # noqa: E731
    grads = [mk() for _ in range(5)]
    p_ref = mk()
    p_two = {k: v.clone() for k, v in p_ref.items()}

    def opt(p):
        o = toptim.Optimizer(p, lambda c: 1e-2, accumulation_steps=2,
                             use_8bit=True)
        o.moments = t8.Adam8bitMoments(o.params, chunk_blocks=4)
        return o

    ref, first = opt(p_ref), opt(p_two)
    assert len(ref.moments.chunks) == 2
    for g in grads:
        ref.update(g)
    for g in grads[:3]:
        first.update(g)
    torch.save(first.state_dict(), tmp_path / "opt.pt")
    second = opt(p_two)
    second.load_state_dict(torch.load(tmp_path / "opt.pt"))
    for g in grads[3:]:
        second.update(g)
    for k in p_ref:
        assert torch.equal(p_ref[k], p_two[k]), k


# --------------------------------------------------------------- LoRA

def _jax_lora_tree(jm_unet, rank, scope, seed=5):
    """A JAX adapter tree with A from numpy and B non-zero."""
    rng = np.random.RandomState(seed)
    flat_unet = tu.flatten_dict(jm_unet)
    flat = {}
    for path in jlora.lora_target_paths(jm_unet, scope):
        i, o = flat_unet[path].shape
        flat[path[:-1] + ("lora_a",)] = (rng.randn(i, rank) / np.sqrt(i)
                                         ).astype(np.float32)
        flat[path[:-1] + ("lora_b",)] = (rng.randn(rank, o) * 0.05
                                         ).astype(np.float32)
    return tu.unflatten_dict(flat)


def _port_key(jpath):
    return ".".join(jpath).replace("to_out_0", "to_out.0")


def _to_port_lora(jtree, models):
    """The JAX adapter tree as the port's ``models.lora`` keys, through the
    converter's path normalisation."""
    flat = tu.flatten_dict(jtree)
    keys = {tuple(normalize_path(k)): k for k in models.lora}
    assert set(keys) == set(flat)
    return {keys[p]: torch.from_numpy(np.asarray(v)) for p, v in flat.items()}


@pytest.mark.parametrize("scope", ["attention", "temporal"])
def test_lora_targets_equal_jax(slice_case, scope):
    models = _port_models(slice_case["jparams"])
    got = tlora.lora_target_paths(models.unet, scope)
    want = jlora.lora_target_paths(slice_case["jparams"]["unet"], scope)
    assert {tuple(normalize_path(n)[:-1] + ["kernel"]) for n in got} == set(want)
    assert len(got) == len(want)
    if scope == "temporal":
        assert all("temporal_attentions" in n for n in got)
    else:
        assert {n.rsplit(".", 2)[-2] for n in got} >= {"to_q", "to_k", "to_v"}
        assert any(n.endswith("to_out.0.weight") for n in got)


@pytest.mark.parametrize("scope", ["attention", "temporal"])
def test_apply_lora_and_inference_params_equal_jax(slice_case, scope):
    """``apply_lora`` on the UNet's weights and ``inference_params`` (FSText
    from the masters, the delta merged into the UNet) against the JAX
    functions, A and B from numpy, scale 0.5: every tensor within 1e-6."""
    c = slice_case
    jtree = _jax_lora_tree(c["jparams"]["unet"], 4, scope)
    models = _port_models(c["jparams"])
    tlora.enable_lora(models, 4, torch.Generator().manual_seed(0), scope)
    with torch.no_grad():
        for k, v in _to_port_lora(jtree, models).items():
            models.lora[k].copy_(v)
    jmerged = jlora.apply_lora(c["jparams"]["unet"], jtree, 0.5)
    tmerged = tlora.apply_lora(models.unet.state_dict(), models.lora, 0.5)
    want = jax_to_state_dict(jax.tree_util.tree_map(np.asarray, jmerged),
                             models.unet)
    assert set(tmerged) == set(want)
    changed = 0
    for k, v in want.items():
        np.testing.assert_allclose(tmerged[k].detach().numpy(), v.numpy(),
                                   atol=1e-6, rtol=0, err_msg=k)
        changed += not torch.equal(v, models.unet.state_dict()[k])
    assert changed == len(tlora.lora_target_paths(models.unet, scope))

    masters = ttrainer.trainable_masters(models)
    jfull = jlora.inference_params(
        {"fstext": c["jparams"]["fstext"], "lora": jtree},
        {"unet": c["jparams"]["unet"]}, 0.5)
    sds = tlora.inference_params(models, masters, 0.5)
    for key in ("unet", "fstext"):
        module = getattr(models, key)
        want = jax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                        jfull[key]), module)
        assert set(sds[key]) == set(want) == set(module.state_dict())
        for k, v in want.items():
            np.testing.assert_allclose(sds[key][k].numpy(), v.numpy(),
                                       atol=1e-6, rtol=0, err_msg=k)


def _lora_models(c, scope, jtree):
    models = _port_models(c["jparams"])
    tlora.enable_lora(models, 4, torch.Generator().manual_seed(0), scope)
    with torch.no_grad():
        for k, v in _to_port_lora(jtree, models).items():
            models.lora[k].copy_(v)
    ttrainer.trainable_masters(models)
    return models


@pytest.mark.parametrize("scope", ["attention", "temporal"])
def test_lora_train_step_matches_jax(slice_case, scope):
    """One micro-step under LoRA (rank 4, B non-zero, scale 0.5) against
    the JAX trainer with the adapter subtree: loss and mse within 1e-5,
    every adapter and FSText gradient within 1e-4 relative + 2e-5 of the
    tensor's largest entry (the tolerance of ``step_vs_jax``); the frozen
    UNet gets no gradient and is unchanged."""
    c = slice_case
    jtree = _jax_lora_tree(c["jparams"]["unet"], 4, scope)
    trainable = {"fstext": c["jparams"]["fstext"], "lora": jtree}
    frozen = {"unet": c["jparams"]["unet"]}
    tx = optax.trace(decay=0.0)
    state = jtrainer.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, trainable), tx)
    step = jtrainer.make_train_step(
        c["jm"], tx, cond_frames=COND,
        frozen_params=jax.tree_util.tree_map(jnp.asarray, frozen),
        lora_scale=0.5)
    key = jax.random.PRNGKey(4)
    state, jmetrics = step(state, c["jbatch"], key)
    jgrads = jax.tree_util.tree_map(np.asarray, state.opt_state.trace)

    models = _lora_models(c, scope, jtree)
    unet0 = {k: v.clone() for k, v in models.unet.state_dict().items()}
    assert not any(p.requires_grad for p in models.unet.parameters())
    tstep = ttrainer.make_train_step(models, cond_frames=COND, lora_scale=0.5)
    noise, ts = _jax_draws(key, 0, c["jbatch"]["latents"].shape, 2)
    names = list(models.masters)
    assert all(n.startswith(("fstext.", "lora.")) for n in names)
    loss, mse, grads = tstep.loss_and_grads(names, _tbatch(c["jbatch"]),
                                            _t(noise), torch.tensor(ts))
    np.testing.assert_allclose(float(loss), float(jmetrics["loss"]), atol=1e-5)
    np.testing.assert_allclose(float(mse), float(jmetrics["mse"]), atol=1e-5)
    want = jax_subtree_to_named({"fstext": jgrads["fstext"]},
                                models.trainable_modules())
    want.update({"lora." + k: v for k, v in
                 _to_port_lora(jgrads["lora"], models).items()})
    assert set(want) == set(grads)
    nonzero = 0
    for name in names:
        scale = max(1.0, float(want[name].abs().max()))
        np.testing.assert_allclose(grads[name].numpy(), want[name].numpy(),
                                   atol=2e-5 * scale, rtol=1e-4, err_msg=name)
        nonzero += bool(want[name].abs().max() > 1e-6)
    assert nonzero > 0.5 * len(names)
    for k, v in models.unet.state_dict().items():
        assert torch.equal(v, unet0[k]), k


def _lora_step(c, remat=False, b=0.0):
    """(loss, gradients) of one LoRA micro-step, rank 4, every B entry
    ``b``."""
    noise, ts = _jax_draws(jax.random.PRNGKey(4), 0,
                           c["jbatch"]["latents"].shape, 2)
    models = _port_models(c["jparams"], remat=remat)
    tlora.enable_lora(models, 4, torch.Generator().manual_seed(0))
    ttrainer.trainable_masters(models)
    with torch.no_grad():
        for k, v in models.lora.items():
            if k.endswith("lora_b"):
                assert float(v.abs().max()) == 0.0   # initialised at zero
                v.fill_(b)
    step = ttrainer.make_train_step(models, cond_frames=COND, lora_scale=1.0)
    loss, _, grads = step.loss_and_grads(list(models.masters),
                                         _tbatch(c["jbatch"]), _t(noise),
                                         torch.tensor(ts))
    return loss, grads


def test_lora_with_zero_b_is_the_base_model(slice_case):
    """Freshly initialised adapters (B = 0) give the base model's loss bit
    for bit; under ``remat`` (B non-zero) the loss and gradients equal no
    remat's bit for bit: the adapted weights stay in place through the
    recompute inside the backward."""
    c = slice_case
    noise, ts = _jax_draws(jax.random.PRNGKey(4), 0,
                           c["jbatch"]["latents"].shape, 2)
    base = _port_models(c["jparams"])
    loss0, _, _ = ttrainer.make_train_step(base, cond_frames=COND
                                           ).loss_and_grads(
        list(base.masters), _tbatch(c["jbatch"]), _t(noise), torch.tensor(ts))
    loss, _ = _lora_step(c)
    assert torch.equal(loss, loss0)
    plain, g_plain = _lora_step(c, remat=False, b=0.01)
    remat, g_remat = _lora_step(c, remat=True, b=0.01)
    assert not torch.equal(plain, loss0)
    assert torch.equal(plain, remat)
    for k in g_plain:
        assert torch.equal(g_plain[k], g_remat[k]), k
    with pytest.raises(ValueError, match="no adapters"):
        ttrainer.make_train_step(base, lora_scale=1.0)


def test_full_width_merged_keys_equal_the_manifest():
    """At full width on meta tensors: the adapters of both scopes (rank 8)
    and the UNet's weights with the delta merged have exactly the
    manifest's SeerUNet key set and shapes, so the saved checkpoint loads
    strictly where the reference's does."""
    import json

    with open(os.path.join(REPO, "seervideoldm_tpu", "io",
                           "reference_manifests.json")) as f:
        man = json.load(f)["seer_unet"]
    with torch.device("meta"):
        unet = SeerUNet()
    sd = unet.state_dict()
    counts = {}
    for scope in ("attention", "temporal"):
        targets = tlora.lora_target_paths(unet, scope)
        lora = {}
        for name in targets:
            o, i = sd[name].shape
            lora[name[:-len("weight")] + "lora_a"] = torch.empty(
                i, 8, device="meta")
            lora[name[:-len("weight")] + "lora_b"] = torch.empty(
                8, o, device="meta")
        merged = tlora.apply_lora(sd, lora, 1.0)
        assert set(merged) == set(man)
        assert all(list(merged[k].shape) == list(man[k]) for k in man)
        counts[scope] = (len(targets), tlora.param_count(lora))
    assert 0 < counts["temporal"][0] < counts["attention"][0]


# ------------------------------------------------------ param_dtype bf16

def test_bf16_parameters_train_step_matches_jax(slice_case):
    """``param_dtype: bfloat16`` with bf16 compute on both sides, the same
    weights rounded to bf16 and the same batch: the masters are the
    parameters themselves (one tensor, bf16), the gradients come back in
    bf16 and one AdamW step updates the masters in bf16.

    Tolerances, from bf16's unit roundoff u = 2^-8 (the two frameworks
    round at different points, each rounding worth up to u relative):

    - the loss within 4u relative;
    - each side's gradients against the exact ones (the fp32 step, which
      ``test_torch_training.py`` holds to the JAX trainer at 1e-4): the
      port's within the repository's bf16 bounds, relative L2 5e-2 over
      all and 2.5e-1 for any tensor carrying at least 1e-4 of the largest
      tensor's norm (the bounds of the card's bf16 training gradients
      against fp32);
    - the AdamW step against the JAX step, both applying the JAX step's
      own bf16 gradients (the port's gradients are held to the exact ones
      above): each parameter within 4u of the step (the moments, their
      bias-corrected ratio and the lr multiply each round once) plus 2u
      of its magnitude (the sum rounds into p's bf16 grid, whose spacing
      is at most 2u |p|, on each side).  A step of the wrong sign or size
      lands at least a step away."""
    c = slice_case
    bf = jnp.bfloat16
    jm = JSeerModels.initialize(
        jax.random.PRNGKey(0), num_frames=FRAMES,
        unet_config=JUNetConfig(**UNET), vae_config=JVAEConfig(**VAE),
        clip_config=JCLIPConfig(**CLIP), fstext_kwargs=FSTEXT, dtype=bf,
        param_dtype=bf, latent_size=8)
    jparams = {k: jax.tree_util.tree_map(lambda v: jnp.asarray(v, bf),
                                         c["jparams"][k])
               for k in ("unet", "fstext")}
    jm.unet_params, jm.fstext_params = jparams["unet"], jparams["fstext"]
    trainable, frozen = jtrainer.partition_params(
        jparams, joptim.trainable_mask(jparams, "reference"))
    jbatch = {k: jnp.asarray(v, bf) for k, v in c["jbatch"].items()}
    key = jax.random.PRNGKey(4)
    # the JAX step donates its state: each run gets its own copy
    fresh = lambda: jax.tree_util.tree_map(jnp.copy, trainable)  # noqa: E731
    tx = optax.trace(decay=0.0)
    state = jtrainer.TrainState.create(fresh(), tx)
    step = jtrainer.make_train_step(jm, tx, cond_frames=COND,
                                    frozen_params=frozen)
    state, jmetrics = step(state, jbatch, key)
    jgrads = jax.tree_util.tree_map(lambda v: np.asarray(v, np.float32),
                                    state.opt_state.trace)
    lr = 1e-3
    atx, _ = joptim.build_optimizer(trainable, lr, scheduler="constant",
                                    warmup_steps=0, partitioned=True)
    astate = jtrainer.TrainState.create(fresh(), atx)
    astep = jtrainer.make_train_step(jm, atx, cond_frames=COND,
                                     frozen_params=frozen)
    astate, _ = astep(astate, jbatch, key)

    models = SeerModels.initialize(
        num_frames=FRAMES, unet_config=SeerUNetConfig(**UNET),
        vae_config=VAEConfig(**VAE), clip_config=CLIPTextConfig(**CLIP),
        fstext_kwargs=FSTEXT, dtype=torch.bfloat16, device="cpu",
        trainable_scope="reference", param_dtype=torch.bfloat16)
    for k in ("unet", "fstext", "vae", "clip"):
        load_jax_params(getattr(models, k), c["jparams"][k])
    masters = ttrainer.trainable_masters(models)
    named = models.named_trainable()
    for n, t in masters.items():
        assert t.dtype == torch.bfloat16
        assert t.data_ptr() == named[n].data_ptr()   # one tensor
    assert all(p.dtype == torch.bfloat16 for m in models.modules()
               for p in m.parameters())
    tstep = ttrainer.make_train_step(models, cond_frames=COND)
    noise, ts = _jax_draws(key, 0, c["jbatch"]["latents"].shape, 2)
    tbatch = {k: v.to(torch.bfloat16) for k, v in _tbatch(c["jbatch"]).items()}
    names = list(masters)
    loss, _, grads = tstep.loss_and_grads(names, tbatch,
                                          _t(noise).to(torch.bfloat16),
                                          torch.tensor(ts))
    jl = float(jmetrics["loss"])
    assert abs(float(loss) - jl) <= 4 * BF16_ULP * abs(jl)
    want = jax_subtree_to_named(jgrads, models.trainable_modules())
    m32 = _port_models(c["jparams"])
    _, _, exact = ttrainer.make_train_step(m32, cond_frames=COND
                                           ).loss_and_grads(
        names, _tbatch(c["jbatch"]), _t(noise), torch.tensor(ts))

    def rel(a, b):
        num = sum(float(((a[n] - b[n]) ** 2).sum()) for n in names)
        return (num / sum(float((b[n] ** 2).sum()) for n in names)) ** 0.5

    port_err, jax_err = rel(grads, exact), rel(want, exact)
    assert port_err <= 5e-2
    top = max(float(exact[n].norm()) for n in names)
    for n in names:
        if float(exact[n].norm()) >= 1e-4 * top:
            err = float((grads[n] - exact[n]).norm() / exact[n].norm())
            assert err <= 2.5e-1, n

    opt, _ = toptim.build_optimizer(masters, lr, scheduler="constant",
                                    warmup_steps=0)
    assert all(t.dtype == torch.bfloat16 for t in opt.moments.mu)
    before = {n: t.clone() for n, t in masters.items()}
    # the JAX step's own gradients (bf16, exactly as it applied them), so
    # that the two updates differ only in where each rounds
    opt.update({n: want[n].to(torch.bfloat16) for n in names})
    want_p = jax_subtree_to_named(
        jax.tree_util.tree_map(lambda v: np.asarray(v, np.float32),
                               astate.params), models.trainable_modules())
    moved = jax_moved = 0
    for n in names:
        got, start = masters[n].float(), before[n].float()
        jax_step = want_p[n] - start
        tol = (2 * BF16_ULP * torch.maximum(want_p[n].abs(), start.abs())
               + 4 * BF16_ULP * jax_step.abs())
        assert bool(((got - want_p[n]).abs() <= tol).all()), n
        moved += not torch.equal(masters[n], before[n])
        jax_moved += not torch.equal(want_p[n], start)
    # an update below half a bf16 ulp leaves a parameter where it is (a
    # LayerNorm scale of 1 moves only by 2^-8): about the same tensors move
    # on both sides
    assert moved >= 0.9 * jax_moved > 0


def test_bf16_parameters_need_bf16_compute():
    with pytest.raises(ValueError, match="param_dtype"):
        SeerModels.initialize(device="cpu", dtype=torch.float32,
                              param_dtype=torch.bfloat16)


# ------------------------------------------------- native frame loader

def _jpegs(tmp_path):
    from PIL import Image

    rng = np.random.RandomState(0)
    paths = []
    for i, (w, h) in enumerate([(100, 60), (48, 80), (64, 64)]):
        img = Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8))
        p = tmp_path / f"f{i}.jpg"
        img.save(p, quality=95)
        paths.append(str(p))
    return paths


def test_native_decode_matches_jax_and_pil(tmp_path):
    """Built from the same source with the same flags: the port's
    ``decode_frames`` equals the JAX package's bit for bit, and PIL's path
    within 0.03 max and 0.005 mean (the JAX test's bounds)."""
    from seervideoldm_tpu.data import native as jnative
    from seervideoldm_tpu_torch.data import native as tnative
    from seervideoldm_tpu_torch.data.transforms import load_frame

    if not tnative.native_available():
        pytest.skip(f"native loader not built: {tnative.unavailable_reason()}")
    paths = _jpegs(tmp_path)
    got = tnative.decode_frames(paths, 32)
    assert got is not None and got.shape == (3, 32, 32, 3)
    assert tnative._lib_path().startswith(tnative.BUILD_DIR)
    if jnative.native_available():
        np.testing.assert_array_equal(got, jnative.decode_frames(paths, 32))
    want = np.stack([load_frame(p, 32) for p in paths])
    assert np.abs(got - want).max() < 0.03
    assert np.abs(got - want).mean() < 0.005


def test_native_decode_failure_returns_none(tmp_path):
    from seervideoldm_tpu_torch.data import native as tnative

    if not tnative.native_available():
        pytest.skip(f"native loader not built: {tnative.unavailable_reason()}")
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not a jpeg")
    assert tnative.decode_frames([str(bad)], 32) is None
    assert tnative.decode_frames([str(bad)] + _jpegs(tmp_path), 32) is None


def test_clip_loader_takes_the_native_path_for_jpegs(tmp_path, monkeypatch):
    """``_load_clip`` decodes a JPEG clip natively and a PNG clip, or a
    JPEG clip the loader refuses, through PIL."""
    from PIL import Image

    from seervideoldm_tpu_torch.data import datasets, native as tnative
    from seervideoldm_tpu_torch.data.transforms import load_frame

    paths = _jpegs(tmp_path)
    calls = []
    monkeypatch.setattr(tnative, "decode_frames",
                        lambda p, r: calls.append(p) or None)
    pil = datasets._load_clip(paths, 32, 3)
    assert len(calls) == 1
    np.testing.assert_array_equal(pil, np.stack([load_frame(p, 32)
                                                 for p in paths]))
    png = str(tmp_path / "f.png")
    Image.open(paths[0]).save(png)
    datasets._load_clip([png], 32, 1)
    assert len(calls) == 1


# ------------------------------------------------------ the train entry

def test_train_entry_with_lora_and_8bit_then_sampling(tmp_path):
    """``python -m seervideoldm_tpu_torch.train --device cpu`` with
    ``lora_rank: 4`` and ``use_8bit_adam: true``, starting from a base
    whose ``proj_out`` weights are not zero (at random init they are, and
    no adapter would get a gradient), read as the JAX entry reads its
    start: a local ``pretrained_model_name_or_path`` directory (the whole
    SeerUNet, VAE and CLIP) and ``fstext_init_ckpt``.  It reports the
    adapters; the checkpoint's train state holds the adapters and int8
    moments, every adapter's B moved off zero and every FSText master
    moved; its UNet file holds the merged weights under the module's full
    key set (every adapted projection moved, nothing else of the UNet
    did); and ``inference_img`` loads it strictly and samples."""
    from seervideoldm_tpu_torch.config import config_from_dict
    from seervideoldm_tpu_torch.io.checkpoint import UNET_FILE, export_state_dicts
    from seervideoldm_tpu_torch.io.pretrained import write_pretrained_dir
    from seervideoldm_tpu_torch.pipelines.loading import load_models

    init, _ = load_models(config_from_dict(_train_cfg(tmp_path)[0]), "cpu")
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, p in init.unet.named_parameters():
            if ".proj_out." in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    start = export_state_dicts(init)
    root = str(tmp_path / "base")
    write_pretrained_dir(init, root)
    cfg, cfg_path = _train_cfg(
        tmp_path, lora_rank=4, use_8bit_adam=True, max_train_steps=4,
        save_steps=4, learning_rate=1e-2, pretrained_model_name_or_path=root,
        fstext_init_ckpt=os.path.join(root, "fstext.bin"))
    proc = _run("train", cfg_path, "--device", "cpu")
    assert "lora: rank 4 scope attention" in proc.stdout
    ckpt = os.path.join(cfg["output_dir"], "learned_sdunet-steps-4")
    state = torch.load(os.path.join(ckpt, "train_state.pt"))
    masters = state["masters"]
    lora_keys = [k for k in masters if k.startswith("lora.")]
    fstext = [k for k in masters if k.startswith("fstext.")]
    assert lora_keys and set(masters) == set(lora_keys) | set(fstext)
    # B starts at zero (weight decay cannot move it): only a gradient does
    assert all(bool(masters[k].abs().max() > 0) for k in lora_keys
               if k.endswith(".lora_b"))
    assert not [k for k in fstext
                if torch.equal(masters[k], start["fstext"][k[len("fstext."):]])]
    q = state["optimizer"]["mu"][lora_keys[0]]
    assert q["codes"].dtype == torch.int8
    unet_sd = torch.load(os.path.join(ckpt, UNET_FILE))
    assert set(unet_sd) == set(start["unet"])
    targets = set(tlora.lora_target_paths(init.unet, "attention"))
    moved = {k for k in unet_sd if not torch.equal(unet_sd[k],
                                                    start["unet"][k])}
    assert moved == targets
    proc = _run("inference_img", cfg_path, "--device", "cpu",
                "--set", "saved_global_step=4", "--image_path",
                _png(tmp_path), "--input_text_prompts", "doing thing 1")
    assert os.path.exists(os.path.join(cfg["output_dir"], "sample-0.gif"))


def _png(tmp_path):
    from PIL import Image

    path = str(tmp_path / "in.png")
    Image.fromarray(np.random.RandomState(0).randint(
        0, 255, (20, 26, 3), dtype=np.uint8)).save(path)
    return path
