"""ZeRO-1, FSDP, LoRA and 8-bit AdamW beside the tensor-parallel ``model``
axis, on 2 and 4 gloo CPU ranks (rank functions in
``tests/torch_tp_workers.py``), fp32, at the toy widths of
``tests/test_torch_tensor_parallel.py``.

Against the JAX package under the same mesh, built its own way (the 8 host
devices of ``tests/conftest.py``, ``shard_params`` for the TP layout):
``{data: 2, model: 2}`` with ``zero1_state_sharding(params_sharding=<the
TP layout>)`` as ``__graft_entry__.py`` builds it and with
``fsdp_state_sharding``; ``{model: 2}`` with LoRA (rank 4 on every
attention projection, A and B from numpy with B non-zero, scale 0.5, the
adapters carried across) and with ``use_8bit=True``.  Each run: a global
batch of 2, 2 optimizer steps with accumulation 2 (4 micro-steps), lr
1e-3, eps 1e-6 (the recipe of ``tests/test_torch_sharding_jax.py``), EMA
0.9.  Bounds: the losses within atol 1e-5; the clip's norm at every
micro-step within rtol 1e-5 of the JAX step's ``grad_norm`` (the norm of
one rank's gradient: split squares summed over ``model``, replicated ones
counted once); the first micro-step's gradients, joined over ``model``,
within the bounds of ``test_train_step_under_model_axis_matches_jax``
(2e-5 of the tensor's largest entry + 1e-4 relative); the masters, EMA and
adapters the checkpoint holds within atol 2e-6 (the bound of
``test_sharded_training_matches_jax``).  8-bit: after the first optimizer
step the masters within 2e-6 (its direction uses the moments before they
are quantized); after the second the moments within the code steps
``training/optim8bit.py`` states -- ``(b1 * S1 + S2) / 127`` of ``m`` and
``(sqrt(b2) * R1 + R2) / 255`` of ``sqrt(v)``, with S (R) the leaf's
largest ``|m|`` (``sqrt v``) after step 1 and 2: one requantization each,
the first carried with weight b1 (sqrt b2) -- plus 1e-4 of S2 (R2) for the
gradients' rounding, and the masters within 2.01 lr (two Adam directions at
count 2 are each at most 1.0014 in size).

Against the port's own replicated ``{data: 2, model: 2}`` run on the same
batch: the losses within rtol 1e-6, the masters within relative L2 1e-6;
under ``zero1`` and 8-bit moments without a clip the codes and scales of
the checkpoint bit for bit; a rank's moments at most half the replicated
run's plus its share of the padding (``zero1``) and its parameters at most
half plus the largest unit (``fsdp``).

Checkpoints move between meshes: one written under ``{data: 2, model: 2}``
with ``zero1`` or ``fsdp`` restores on one rank, under ``{data: 2}`` (the
same mode) and under ``{model: 2}``, and one written on one rank, under
``{data: 2}`` or under ``{model: 2}`` restores under ``{data: 2, model:
2}`` with either; each restored state written again equals its source bit
for bit.  Resume on the same mesh is bit for bit.  The 8-bit checkpoint
holds the whole leaves' blocks: it restores on one rank code for code, and
its round trip under ``{model: 2}`` keeps the codes of the parts that
keep the whole leaf's blocks and moves the others by at most half a code
step of each block they pass through.

Regressions: the loss pair of a sharded step is reduced over the data
line (a ``{data: 2, model: 2}`` ``zero1`` loss equals ``{data: 2}``'s,
not twice it); LoRA's factor that a split leaves whole gets its gradient
summed over ``model`` (the ``{model: 2}`` gradients equal one rank's).
"""
import os

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seervideoldm_tpu.parallel.mesh import batch_sharding, shard_global
from seervideoldm_tpu.parallel.sharding import (fsdp_param_sharding,
                                                fsdp_state_sharding,
                                                zero1_state_sharding)
from seervideoldm_tpu.pipelines.text_video import SeerModels as JSeerModels
from seervideoldm_tpu.training import lora as jlora
from seervideoldm_tpu.training import optim as joptim
from seervideoldm_tpu.training import trainer as jtrainer
from seervideoldm_tpu_torch.io.checkpoint import (FSTEXT_FILE, STATE_FILE,
                                                  UNET_FILE)
from seervideoldm_tpu_torch.io.convert import (jax_subtree_to_named,
                                               normalize_path)
from seervideoldm_tpu_torch.parallel import launch
from seervideoldm_tpu_torch.parallel.sharding import (ALIGN, COLUMN,
                                                      GEGLU_COLUMN, ROW,
                                                      Split, TensorParallel,
                                                      tp_join, tp_slice)
from seervideoldm_tpu_torch.training import lora as tlora
from seervideoldm_tpu_torch.training import optim8bit as t8

import torch_tp_workers as workers
from test_torch_tensor_parallel import (COND, FRAMES, SIZES, TIMEOUT,
                                        seeded_params, under_mesh)

LR, EPS, EMA, RANK, SCALE = 1e-3, 1e-6, 0.9, 4, 0.5
B1, B2 = 0.9, 0.999
MICRO = 4                  # 2 optimizer steps, accumulation 2
D2M2 = {"data": 2, "model": 2}
M2, D2 = {"model": 2}, {"data": 2}
JAX_CASES = {"d2m2_zero1": (D2M2, dict(mode="zero1")),
             "d2m2_fsdp": (D2M2, dict(mode="fsdp")),
             "m2_lora": (M2, dict(lora=True)),
             "m2_8bit": (M2, dict(use_8bit=True))}
BASE = dict(lr=LR, eps=EPS)


# ----------------------------------------------------------------- inputs

@pytest.fixture(scope="module")
def inputs():
    mods, jparams = seeded_params()
    rng = np.random.RandomState(11)
    video = rng.uniform(-1, 1, (2, FRAMES, 16, 16, 3)).astype(np.float32)
    ids = rng.randint(0, 100, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    jm = JSeerModels(*mods.values(), *(
        jax.tree_util.tree_map(jnp.asarray, jparams[k]) for k in mods))
    jbatch = jtrainer.prepare_batch_fn(jm, sample_posterior=False)(
        jnp.asarray(video), jnp.asarray(ids), jnp.asarray(mask),
        jax.random.PRNGKey(3), cond_frames=COND)
    batch = {k: np.asarray(v) for k, v in jbatch.items()}
    key = jax.random.PRNGKey(2)
    draws = []
    for micro in range(MICRO):
        k_noise, k_t = jax.random.split(jax.random.fold_in(key, micro))
        draws.append({"noise": np.asarray(jax.random.normal(
            k_noise, batch["latents"].shape, dtype=jnp.float32)),
            "ts": np.asarray(jax.random.randint(k_t, (2,), 0, 1000))})
    # LoRA rank 4 on every attention projection: A from numpy, B non-zero
    # (so that both factors have gradients from the first micro-step)
    flat_unet = tu.flatten_dict(jparams["unet"])
    flat = {}
    lrng = np.random.RandomState(5)
    for path in jlora.lora_target_paths(jparams["unet"], "attention"):
        i, o = flat_unet[path].shape
        flat[path[:-1] + ("lora_a",)] = (lrng.randn(i, RANK) / np.sqrt(i)
                                         ).astype(np.float32)
        flat[path[:-1] + ("lora_b",)] = (lrng.randn(RANK, o) * 0.05
                                         ).astype(np.float32)
    jlora_tree = tu.unflatten_dict(flat)
    port = workers.build(SIZES, jparams, trainable_scope="reference")
    tlora.enable_lora(port, RANK, torch.Generator().manual_seed(0))
    keys = {tuple(normalize_path(k)): k for k in port.lora}
    assert set(keys) == set(flat)
    lora = {keys[p]: np.asarray(v) for p, v in flat.items()}
    return dict(mods=mods, jparams=jparams, batch=batch, draws=draws,
                key=key, jlora=jlora_tree, lora=lora, port=port)


def _jax_run(inputs, shape, mode=None, lora=False, use_8bit=False):
    """The JAX training of one case under ``shape``: every micro-step's
    loss and clip norm, the first micro-step's gradients, the trainable
    params after each optimizer step, the EMA, and under 8-bit the
    dequantized moments after each step."""
    mods, key = inputs["mods"], inputs["key"]

    def run(mesh, unet_p, fs_p, vae_p, clip_p):
        jm = JSeerModels(*mods.values(), unet_p, fs_p, vae_p, clip_p)
        params = {"unet": unet_p, "fstext": fs_p}
        if lora:
            trainable = {"fstext": fs_p, "lora": jax.tree_util.tree_map(
                jnp.asarray, inputs["jlora"])}
            frozen = {"unet": unet_p}
        else:
            trainable, frozen = jtrainer.partition_params(
                params, joptim.trainable_mask(params, "reference"))
        tx, _ = joptim.build_optimizer(
            trainable, LR, eps=EPS, warmup_steps=0, total_steps=10,
            accumulation_steps=2, partitioned=True, use_8bit=use_8bit)
        state = jtrainer.TrainState.create(
            jax.tree_util.tree_map(jnp.copy, trainable), tx, ema=True)
        sh = None
        if mode == "zero1":
            # the TP layout of the params kept (__graft_entry__.py)
            sh = zero1_state_sharding(state, mesh, params_sharding=(
                jax.tree_util.tree_map(lambda x: x.sharding, state.params)))
            state = shard_global(mesh, state, sh)
        elif mode == "fsdp":
            sh = fsdp_state_sharding(state, mesh)
            state = shard_global(mesh, state, sh)
            frozen = shard_global(mesh, frozen,
                                  fsdp_param_sharding(frozen, mesh))
        step = jtrainer.make_train_step(
            jm, tx, cond_frames=COND, frozen_params=frozen, ema_decay=EMA,
            state_sharding=sh, lora_scale=SCALE if lora else 0.0)
        batch = {k: (jax.device_put(jnp.asarray(v),
                                    batch_sharding(mesh, v.ndim))
                     if "data" in mesh.axis_names else jnp.asarray(v))
                 for k, v in inputs["batch"].items()}
        out = {"losses": [], "grad_norms": [], "params": [], "moments": []}
        host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        for micro in range(MICRO):
            state, metrics = step(state, batch, key)
            out["losses"].append(float(metrics["loss"]))
            out["grad_norms"].append(float(metrics["grad_norm"]))
            if micro == 0:
                out["grads"] = host(state.opt_state.acc_grads)
            if micro % 2 == 1:
                out["params"].append(host(state.params))
                if use_8bit:
                    out["moments"].append(_dequantized(state))
        out["ema"] = host(state.ema_params)
        return out

    return under_mesh(shape, run, *(inputs["jparams"][k] for k in
                                    ("unet", "fstext", "vae", "clip")))


def _dequantized(state):
    """The 8-bit moments of a JAX state, dequantized in the params'
    shapes (numpy)."""
    inner = state.opt_state.inner_opt_state
    adam = inner[1][0]
    leaves, treedef = jax.tree_util.tree_flatten(state.params)
    out = {}
    for key, qtree, signed in (("mu", adam.mu, True), ("nu", adam.nu, False)):
        qs = treedef.flatten_up_to(qtree)
        vals = []
        for p, q in zip(leaves, qs):
            codes = np.asarray(q.codes).astype(np.float32)
            scales = np.asarray(q.scales)
            x = (codes / 127.0 * scales if signed
                 else ((codes + 128.0) / 255.0 * scales) ** 2)
            vals.append(x.reshape(-1)[:p.size].reshape(p.shape))
        out[key] = jax.tree_util.tree_unflatten(treedef, vals)
    return out


@pytest.fixture(scope="module")
def jax_runs(inputs):
    return {name: _jax_run(inputs, shape, **kw)
            for name, (shape, kw) in JAX_CASES.items()}


def _named(inputs, tree):
    """A JAX tree of the trainable set (``fstext`` / ``unet`` / ``lora``)
    by the port's names, as numpy."""
    port = inputs["port"]
    out = {}
    rest = {k: v for k, v in tree.items() if k != "lora"}
    if rest:
        out.update({n: t.numpy() for n, t in jax_subtree_to_named(
            rest, port.trainable_modules()).items()})
    if "lora" in tree:
        keys = {tuple(normalize_path(k)): k for k in port.lora}
        out.update({tlora.PREFIX + keys[p]: np.asarray(v) for p, v in
                    tu.flatten_dict(tree["lora"]).items()})
    return out


# ------------------------------------------------------------ port launches

def _case(mesh, **kw):
    return dict(BASE, mesh=mesh, **kw)


@pytest.fixture(scope="module")
def port_runs(inputs, tmp_path_factory):
    """Three launches: 2 ranks (the ``{model: 2}`` runs against JAX, the
    sources of the reverse round trips), 4 ranks (``{data: 2, model: 2}``
    runs, resumes, the reverse round trips), 2 ranks (the round trips of
    the 4-rank checkpoints)."""
    root = str(tmp_path_factory.mktemp("tp_strategies"))
    d = lambda *p: os.path.join(root, *p)  # noqa: E731
    lora = inputs["lora"]
    a = {
        "m2_lora": _case(M2, lora=lora, grads=True,
                         save={2: d("m2_lora")}),
        "single_lora": _case(None, lora=lora, grads=True),
        "m2_8bit": _case(M2, use_8bit=True, keep_local=True,
                         save={1: d("m2_8bit_1"), 2: d("m2_8bit")}),
        "m2_8bit_back": _case(M2, use_8bit=True, keep_local=True, steps=0,
                              restore=(d("m2_8bit"), 2)),
        "single_8bit_back": _case(None, use_8bit=True, steps=0,
                                  restore=(d("m2_8bit"), 2),
                                  resave={2: d("single_8bit_back")}),
        "src_single": _case(None, save={2: d("src_single")}),
        "src_d2_zero1": _case(D2, zero1=True, save={2: d("src_d2_zero1")}),
        "src_d2_fsdp": _case(D2, fsdp=True, save={2: d("src_d2_fsdp")}),
        "src_m2": _case(M2, save={2: d("src_m2")}),
    }
    b = {
        "rep": _case(D2M2, grads=True, save={2: d("rep")}),
        "zero1": _case(D2M2, zero1=True, grads=True,
                       save={1: d("zero1_1"), 2: d("zero1")}),
        "fsdp": _case(D2M2, fsdp=True, grads=True,
                      save={1: d("fsdp_1"), 2: d("fsdp")}),
        "rep_8bit": _case(D2M2, use_8bit=True, max_grad_norm=float("inf"),
                          save={2: d("rep_8bit")}),
        "zero1_8bit": _case(D2M2, zero1=True, use_8bit=True,
                            max_grad_norm=float("inf"),
                            save={2: d("zero1_8bit")}),
        "rep_lora": _case(D2M2, lora=lora, save={2: d("rep_lora")}),
        "fsdp_lora": _case(D2M2, fsdp=True, lora=lora,
                           save={2: d("fsdp_lora")}),
        "zero1_resume": _case(D2M2, zero1=True, steps=2,
                              restore=(d("zero1_1"), 1),
                              save={2: d("zero1_resumed")}),
        "fsdp_resume": _case(D2M2, fsdp=True, steps=2,
                             restore=(d("fsdp_1"), 1),
                             save={2: d("fsdp_resumed")}),
    }
    for src in ("single", "d2_zero1", "d2_fsdp", "m2"):
        for mode in ("zero1", "fsdp"):
            b[f"back_{src}_{mode}"] = _case(
                D2M2, steps=0, restore=(d(f"src_{src}"), 2),
                resave={2: d(f"back_{src}_{mode}")}, **{mode: True})
    c = {}
    for mode in ("zero1", "fsdp"):
        for dst, mesh in (("single", None), ("d2", D2), ("m2", M2)):
            c[f"{mode}_to_{dst}"] = _case(
                mesh, steps=0, restore=(d(mode), 2),
                resave={2: d(f"{mode}_to_{dst}")}, **{mode: True})
    args = (SIZES, inputs["jparams"], inputs["batch"], inputs["draws"])
    got = {}
    for n, cases in ((2, a), (4, b), (2, c)):
        got.update(launch.run(workers.strategy_cases, n,
                              args=args + (cases,), device="cpu",
                              timeout=TIMEOUT, threads=1)[0])
    return dict(root=root, got=got, dir=d)


def _state(path, step=2):
    return torch.load(os.path.join(path, f"learned_sdunet-steps-{step}",
                                   STATE_FILE), map_location="cpu")


def _files(path, step=2):
    return {f: torch.load(os.path.join(path, f"learned_sdunet-steps-{step}",
                                       f), map_location="cpu")
            for f in (UNET_FILE, FSTEXT_FILE, STATE_FILE)}


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(float(((got[n].double() - want[n].double()) ** 2).sum())
              for n in want)
    den = sum(float((want[n].double() ** 2).sum()) for n in want)
    return (num / den) ** 0.5


def _assert_grads(got: dict, want: dict):
    assert set(got) == set(want)
    nonzero = 0
    for n, w in want.items():
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[n], w, atol=2e-5 * scale, rtol=1e-4,
                                   err_msg=n)
        nonzero += bool(np.abs(w).max() > 1e-6)
    assert nonzero > 0.5 * len(want)


# ------------------------------------------------------ against the JAX runs

@pytest.mark.parametrize("name", ["d2m2_zero1", "d2m2_fsdp", "m2_lora"])
def test_strategy_beside_model_axis_matches_jax(inputs, jax_runs, port_runs,
                                                name):
    want = jax_runs[name]
    port = {"d2m2_zero1": "zero1", "d2m2_fsdp": "fsdp",
            "m2_lora": "m2_lora"}[name]
    ranks = port_runs["got"][port]
    got = ranks[0]
    assert got["mode"] == {"m2_lora": None}.get(name, name[5:])
    np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-5)
    # the clip saw one rank's norm on every rank
    for r in ranks:
        np.testing.assert_allclose(r["grad_norms"], want["grad_norms"],
                                   rtol=1e-5)
    _assert_grads(got["grads"], _named(inputs, want["grads"]))
    state = _state(port_runs["dir"](port))
    for key, tree in (("masters", want["params"][-1]), ("ema", want["ema"])):
        tree = _named(inputs, tree)
        assert set(state[key]) == set(tree)
        init = _named(inputs, {"fstext": inputs["jparams"]["fstext"],
                               **({"lora": inputs["jlora"]} if "lora" in name
                                  else {"unet": inputs["jparams"]["unet"]})})
        moved = [n for n in tree if not np.array_equal(tree[n], init[n])]
        assert len(moved) > 0.9 * len(tree)
        for n, w in tree.items():
            np.testing.assert_allclose(state[key][n].numpy(), w, atol=2e-6,
                                       err_msg=f"{key} {n}")


def test_8bit_beside_model_axis_matches_jax(inputs, jax_runs, port_runs):
    want = jax_runs["m2_8bit"]
    got = port_runs["got"]["m2_8bit"][0]
    np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-5)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                               rtol=1e-5)
    # the first step is exact in both (the moments before quantization)
    first = _state(port_runs["dir"]("m2_8bit_1"), 1)["masters"]
    for n, w in _named(inputs, want["params"][0]).items():
        np.testing.assert_allclose(first[n].numpy(), w, atol=2e-6,
                                   err_msg=n)
    state = _state(port_runs["dir"]("m2_8bit"))
    m1 = _named(inputs, want["moments"][0]["mu"])
    v1 = _named(inputs, want["moments"][0]["nu"])
    m2 = _named(inputs, want["moments"][1]["mu"])
    v2 = _named(inputs, want["moments"][1]["nu"])
    split = 0
    for n, w in m2.items():
        shape = w.shape
        q = state["optimizer"]["mu"][n]
        got_m = t8.dequantize_signed(t8.Q(q["codes"], q["scales"]),
                                     shape).numpy()
        q = state["optimizer"]["nu"][n]
        got_r = np.sqrt(t8.dequantize_sqrt(t8.Q(q["codes"], q["scales"]),
                                           shape).numpy())
        s1, s2 = np.abs(m1[n]).max(), np.abs(w).max()
        r1, r2 = np.sqrt(v1[n]).max(), np.sqrt(v2[n]).max()
        np.testing.assert_array_less(
            np.abs(got_m - w), (B1 * s1 + s2) / 127.0 + 1e-4 * s2 + 1e-12,
            err_msg=f"mu {n}")
        np.testing.assert_array_less(
            np.abs(got_r - np.sqrt(v2[n])),
            (np.sqrt(B2) * r1 + r2) / 255.0 + 1e-4 * r2 + 1e-12,
            err_msg=f"nu {n}")
        split += n in got["split_names"]
    assert split > 0
    for n, w in _named(inputs, want["params"][1]).items():
        np.testing.assert_array_less(np.abs(state["masters"][n].numpy() - w),
                                     2.01 * LR + 2e-6, err_msg=n)


# ------------------------------------------ against the replicated TP run

@pytest.mark.parametrize("name,ref", [("zero1", "rep"), ("fsdp", "rep"),
                                      ("zero1_8bit", "rep_8bit"),
                                      ("fsdp_lora", "rep_lora")])
def test_strategy_matches_the_replicated_model_axis_run(port_runs, name,
                                                        ref):
    got, want = port_runs["got"][name], port_runs["got"][ref]
    np.testing.assert_allclose(got[0]["losses"], want[0]["losses"],
                               rtol=1e-6)
    a, b = _state(port_runs["dir"](name)), _state(port_runs["dir"](ref))
    assert _rel_l2(a["masters"], b["masters"]) <= 1e-6
    assert _rel_l2(a["ema"], b["ema"]) <= 1e-6
    if name == "zero1_8bit":
        # no clip: the shards' blocks are the parts' blocks, bit for bit
        _assert_same(a["optimizer"]["mu"], b["optimizer"]["mu"])
        _assert_same(a["optimizer"]["nu"], b["optimizer"]["nu"])
    for r, w in zip(got, want):
        assert r["coords"] == w["coords"]
        if name.startswith("zero1"):
            assert r["moment_bytes"] <= 0.5 * w["moment_bytes"] + r[
                "pad_bytes"] * (2 if name == "zero1" else 1)
        else:
            assert r["param_bytes"] <= (0.5 * w["param_bytes"]
                                        + r["largest_unit_bytes"])
    if name in ("zero1", "fsdp"):
        for r, w in zip(got, want):
            np.testing.assert_allclose(r["grad_norms"], w["grad_norms"],
                                       rtol=1e-6)
        for n, g in want[0]["grads"].items():
            np.testing.assert_allclose(got[0]["grads"][n], g, rtol=1e-6,
                                       atol=1e-9, err_msg=n)


def test_loss_pair_is_reduced_over_the_data_line(port_runs):
    """The sharded step's (loss, mse) summed over the data x seq ranks of
    one model index: under ``{data: 2, model: 2}`` the reported loss is
    ``{data: 2}``'s on the same batch (a sum over the world reports it
    twice)."""
    got = port_runs["got"]["zero1"][0]["losses"][:2]
    want = port_runs["got"]["src_d2_zero1"][0]["losses"][:2]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_lora_whole_factor_gradient_is_summed_over_model(port_runs):
    got = port_runs["got"]["m2_lora"][0]
    want = port_runs["got"]["single_lora"][0]
    partial = got["partial_names"]
    assert partial and all(n.startswith(tlora.PREFIX) for n in partial)
    _assert_grads(got["grads"], want["grads"])
    for n in partial:
        assert np.abs(want["grads"][n]).max() > 1e-6, n


def test_lora_adapters_are_drawn_whole_then_cut(port_runs):
    got = port_runs["got"]["m2_lora"][0]["lora_draw"]
    want = port_runs["got"]["single_lora"][0]["lora_draw"]
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


# ------------------------------------------------------------- checkpoints

MOVES = ([(f"{m}_to_{d}", m) for m in ("zero1", "fsdp")
          for d in ("single", "d2", "m2")]
         + [(f"back_{s}_{m}", f"src_{s}") for s in ("single", "d2_zero1",
                                                    "d2_fsdp", "m2")
            for m in ("zero1", "fsdp")])


@pytest.mark.parametrize("moved,source", MOVES)
def test_checkpoint_moves_between_meshes(port_runs, moved, source):
    """Restored under another mesh and written again: every file equal to
    the source's, bit for bit."""
    _assert_same(_files(port_runs["dir"](moved)),
                 _files(port_runs["dir"](source)))


@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_resume_on_the_same_mesh_is_bit_for_bit(port_runs, mode):
    got, want = port_runs["got"][f"{mode}_resume"], port_runs["got"][mode]
    assert got[0]["losses"] == want[0]["losses"][2:]
    _assert_same(_files(port_runs["dir"](f"{mode}_resumed")),
                 _files(port_runs["dir"](mode)))


def test_8bit_checkpoint_restores_on_one_rank(port_runs):
    """The ``{model: 2}`` 8-bit checkpoint holds the whole leaves' codes:
    one rank loads it and writes it again code for code."""
    _assert_same(_files(port_runs["dir"]("single_8bit_back")),
                 _files(port_runs["dir"]("m2_8bit")))


def test_8bit_round_trip_under_model_axis(port_runs):
    """Save and restore under ``{model: 2}``: a part that keeps the whole
    leaf's blocks gets its codes and scales back bit for bit; any other
    part moves by at most half a code step of its whole-leaf block (the
    save) plus half a step of the block it is quantized in again (the
    restore)."""
    kept = moved = 0
    for r, back in zip(port_runs["got"]["m2_8bit"],
                       port_runs["got"]["m2_8bit_back"]):
        before, after = r["local_state"], back["local_state"]
        whole = _state(port_runs["dir"]("m2_8bit"))["optimizer"]
        for key, signed in (("mu", True), ("nu", False)):
            for n, q in before[key].items():
                shape = r["local_shapes"][n]
                if n not in r["split_names"] or r["keeps_blocks"][n]:
                    np.testing.assert_array_equal(after[key][n]["codes"],
                                                  q["codes"], err_msg=n)
                    np.testing.assert_array_equal(after[key][n]["scales"],
                                                  q["scales"], err_msg=n)
                    kept += n in r["split_names"]
                    continue
                moved += 1
                x0 = _values(q, shape, signed)
                x1 = _values(after[key][n], shape, signed)
                step = 127.0 if signed else 255.0
                local = _scale_map(after[key][n], shape)
                split = Split(*r["split_names"][n])
                wq = whole[key][n]
                wshape = list(shape)
                wshape[split.dim] *= 2
                far = tp_slice(torch.from_numpy(_scale_map(
                    {k: v.numpy() for k, v in wq.items()}, wshape)), split,
                    2, r["coords"]["model"]).numpy()
                np.testing.assert_array_less(
                    np.abs(x1 - x0), (local + far) / 2 / step * (1 + 1e-5)
                    + 1e-12, err_msg=f"{key} {n}")
    assert kept > 0 and moved > 0


def _values(q, shape, signed):
    """Dequantized values (signed) or roots of the second moment."""
    codes = np.asarray(q["codes"]).astype(np.float32)
    scales = np.asarray(q["scales"])
    x = codes / 127.0 * scales if signed else (codes + 128.0) / 255.0 * scales
    return x.reshape(-1)[:int(np.prod(shape))].reshape(shape)


def _scale_map(q, shape):
    """Each element's block scale."""
    scales = np.broadcast_to(np.asarray(q["scales"]),
                             (len(q["scales"]), ALIGN))
    return scales.reshape(-1)[:int(np.prod(shape))].reshape(shape)


# ---------------------------------------------------- the 8-bit block rule

class _Mesh:
    def __init__(self, rank):
        self.rank = rank

    def group(self, axis):
        return None

    def axis_size(self, axis):
        return 2 if axis == "model" else 1

    def axis_index(self, axis):
        return self.rank if axis == "model" else 0


# (whole shape, split, keeps the blocks over 2 ranks): SD-1.5's temporal
# q / out projections at 320 and 1280 channels, its GEGLU projection
# (1280 -> 2 x 5120) and down projection, a column-split bias, LoRA's B
# (rank 8, out 320) under a column split and A under a row split
RULE = [((320, 320), COLUMN, True), ((320, 320), ROW, False),
        ((1280, 1280), ROW, False), ((10240, 1280), GEGLU_COLUMN, True),
        ((1280, 5120), ROW, True), ((640,), COLUMN, False),
        ((8, 320), Split(1), False), ((320, 8), COLUMN, True)]


@pytest.mark.parametrize("signed", [True, False], ids=["m", "v"])
@pytest.mark.parametrize("shape,split,keeps", RULE)
def test_8bit_blocks_of_a_part(shape, split, keeps, signed):
    """Blocks of 256 over each rank's part: where ``keeps_blocks`` says so
    the parts' codes and scales, joined, are the whole leaf's bit for bit
    (and ``local_q`` cuts them back bit for bit); elsewhere each value is
    within one code step of its block (half a step in each layout)."""
    rng = np.random.RandomState(len(shape) * 7 + shape[0])
    x = torch.from_numpy((rng.randn(*shape) * 10.0 ** rng.uniform(
        -4, 0, shape)).astype(np.float32))
    if not signed:
        x = x * x
    quant = t8.quantize_signed if signed else t8.quantize_sqrt
    deq = t8.dequantize_signed if signed else t8.dequantize_sqrt
    whole = quant(x)
    name = "unet.w"
    parts, tps = [], []
    for rank in range(2):
        tp = TensorParallel(_Mesh(rank), {name: split})
        tps.append(tp)
        local = tp_slice(x, split, 2, rank)
        assert tp.keeps_blocks(name, local.shape) == keeps
        parts.append((local, quant(local)))
    if keeps:
        codes = tp_join([q.codes.reshape(p.shape) for p, q in parts], split)
        assert torch.equal(t8.blocked(codes), whole.codes)
        scales = tp_join([q.scales.expand(-1, ALIGN).reshape(p.shape)
                          for p, q in parts], split)
        assert torch.equal(t8.blocked(scales)[:, :1], whole.scales)
        for tp, (local, q) in zip(tps, parts):
            back = tp.local_q({name: {"codes": whole.codes,
                                      "scales": whole.scales}},
                              {name: tuple(local.shape)}, signed)[name]
            assert torch.equal(back["codes"], q.codes)
            assert torch.equal(back["scales"], q.scales)
        return
    one = deq(whole, shape)
    got = tp_join([deq(q, p.shape) for p, q in parts], split)
    if not signed:
        one, got = one.sqrt(), got.sqrt()
    steps = (127.0 if signed else 255.0)
    wmap = whole.scales.expand(-1, ALIGN).reshape(-1)[:x.numel()].reshape(
        shape)
    pmap = tp_join([q.scales.expand(-1, ALIGN).reshape(-1)[:p.numel()]
                    .reshape(p.shape) for p, q in parts], split)
    bound = (wmap + pmap) / 2 / steps * (1 + 1e-5) + 1e-12
    assert bool(((got - one).abs() <= bound).all())
    assert not torch.equal(got, one)


# ------------------------------------------------------------ the entry

ENTRY = {"zero1_8bit": dict(zero1=True, use_8bit_adam=True),
         "fsdp_lora": dict(fsdp=True, lora_rank=4),
         "lora_8bit": dict(lora_rank=4, use_8bit_adam=True)}


@pytest.fixture(scope="module")
def entry_runs(tmp_path_factory):
    from test_torch_train_entry import _train_cfg

    root = tmp_path_factory.mktemp("tp_entry")
    raws = []
    for name, over in ENTRY.items():
        (root / name).mkdir()
        cfg, _ = _train_cfg(root / name, train_batch_size=1,
                            max_train_steps=2, save_steps=2,
                            mesh_shape=D2M2, **over)
        raws.append(cfg)
    got = launch.run(workers.entry_runs, 4, args=(raws,), device="cpu",
                     timeout=TIMEOUT, threads=1)
    return raws, got


@pytest.mark.parametrize("name", list(ENTRY))
def test_train_entry_runs_each_strategy_beside_model_axis(entry_runs,
                                                          name):
    """The ``train`` entry under ``{data: 2, model: 2}``: its lines (the
    mesh, the mode, the adapters counted whole), two optimizer steps,
    finite losses, a checkpoint in the single-rank layout (the keys and
    shapes of the whole models' trainable set), and what a rank holds."""
    from seervideoldm_tpu_torch.config import config_from_dict
    from seervideoldm_tpu_torch.pipelines.loading import load_models
    from seervideoldm_tpu_torch.training.lora import param_count
    from seervideoldm_tpu_torch.training.trainer import trainable_masters

    raws, got = entry_runs
    i = list(ENTRY).index(name)
    raw, ranks = raws[i], [r[i] for r in got]
    main = ranks[0]
    summary = main["summary"]
    assert "mesh (data, model, seq) = (2, 2, 1)" in main["stdout"]
    assert summary["global_step"] == 2 and summary["mesh"]["model"] == 2
    assert summary["sharding"] == (None if name == "lora_8bit"
                                   else name.split("_")[0])
    assert all(np.isfinite(summary["losses"]))
    # one rank's whole models: the trainable set the checkpoint must hold
    cfg = config_from_dict(dict(raw, mesh_shape=None))
    whole, _ = load_models(cfg, "cpu", trainable_scope=cfg.trainable_scope)
    if raw.get("lora_rank"):
        tlora.enable_lora(whole, 4, torch.Generator().manual_seed(0))
        assert (f"{param_count(whole.lora) / 1e6:.2f}M adapter params"
                in main["stdout"])
    want = {n: tuple(t.shape) for n, t in trainable_masters(whole).items()}
    state = torch.load(os.path.join(summary["checkpoint"], STATE_FILE),
                       map_location="cpu")
    assert {n: tuple(t.shape) for n, t in state["masters"].items()} == want
    quantized = raw.get("use_8bit_adam", False)
    for n, q in state["optimizer"]["mu"].items():
        numel = int(np.prod(want[n]))
        if quantized:
            assert q["codes"].shape == (-(-numel // ALIGN), ALIGN), n
        else:
            assert tuple(q.shape) == want[n], n
    for r in ranks:
        s = r["summary"]
        assert s["param_bytes"] > 0 and s["state_bytes"] > 0
        assert s["master_bytes"] < 4 * sum(int(np.prod(v))
                                           for v in want.values())
