"""The port's ring attention (``seervideoldm_tpu_torch/ops/ring.py``) and the
frame-split layers (GroupNorm, ``WindowTemporalAttention``) on 2 and 4 gloo
ranks on the CPU, against the JAX package on one device.

Each launch starts the ranks with ``parallel.launch.run`` (spawned
processes, a ``file://`` rendezvous in a fresh temporary directory, a
timeout); the rank functions are in ``tests/torch_parallel_workers.py``.
Inputs, weights and cotangents are made from a numpy seed; every result is
the ranks' frames joined again.

- ring on 2 and 4 ranks, causal and not, ws 8 windows and full frame:
  output and dq, dk, dv of ``sum(out * g)`` vs the single-device windowed
  attention of the JAX package and its vjp (the
  ``tests/test_ring_attention.py`` cases);
- GroupNorm split over ``seq`` (even and uneven frame counts) vs whole:
  output, input and parameter gradients;
- ``WindowTemporalAttention`` under ``{seq: 2}``: the ring (f = 4), the
  pre-rotated kernel branch K6 (f = 5, through its plain version on the
  CPU), the table kernel K1 with the ring off, and the gathered einsum
  (ws 4): output, input gradient, parameter gradients summed over ranks.

Tolerances: 2e-5 absolute on outputs (fp32, summation order); on gradients
1e-4 relative + 2e-5 of the tensor's largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seervideoldm_tpu.ops import attention as jattn
from seervideoldm_tpu.ops import norms as jnorms
from seervideoldm_tpu.ops.windows import window_partition, window_reverse
from seervideoldm_tpu_torch.io.convert import jax_to_state_dict
from seervideoldm_tpu_torch.ops import attention as tattn
from seervideoldm_tpu_torch.ops import norms as tnorms
from seervideoldm_tpu_torch.parallel import launch

import torch_parallel_workers as workers

TIMEOUT = 240


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _close_grad(got, want, what):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=2e-5 * scale, rtol=1e-4,
                               err_msg=what)


# ------------------------------------------------------------------ ring

def _window_attention(q, k, v, scale, causal, ws):
    """Single-device SWAT attention in the windowed layout (JAX)."""
    bh, f, h, w, d = q.shape
    if ws is None:
        flat = lambda x: x.reshape(bh, f * h * w, d)  # noqa: E731
        out = jattn.dot_product_attention(flat(q), flat(k), flat(v), scale,
                                          causal=causal, use_flash=False)
        return out.reshape(bh, f, h, w, d)
    qw, kw, vw = (window_partition(x, ws) for x in (q, k, v))
    ow = jattn.dot_product_attention(qw, kw, vw, scale, causal=causal,
                                     use_flash=False)
    return window_reverse(ow, ws, f, h, w)


RING_CASES = [(ws, causal) for ws in (8, None) for causal in (True, False)]


def _ring_cases(seed):
    cases = {}
    for ws, causal in RING_CASES:
        side = 8 if ws else 4
        shape = (2, 4, side, side, 8)
        q, k, v, g = (_rand(shape, seed + i) for i in range(4))
        cases[f"ws{ws}-causal{causal}"] = dict(q=q, k=k, v=v, g=g, ws=ws,
                                               causal=causal, scale=8 ** -0.5)
    return cases


# ---------------------------------------------------------------- layers

def _layer_cases():
    cases = {}
    for f in (4, 5):
        x = _rand((2, f, 8, 8, 16), 30 + f, 2.0) + 0.5
        mod = jnorms.GroupNorm(num_groups=4)
        params = mod.init(jax.random.PRNGKey(f), jnp.asarray(x))["params"]
        params = jax.tree_util.tree_map(
            lambda p: p + jnp.asarray(_rand(p.shape, 7, 0.1)), params)
        cases[f"group_norm-f{f}"] = dict(layer="group_norm", args=(4, 16),
                                         x=x, mod=mod, params=params,
                                         g=_rand(x.shape, 40 + f))
    for name, f, h, ring in (("ring", 4, 32, True), ("k6", 5, 32, True),
                             ("k1_ring_off", 4, 32, False),
                             ("einsum_ws4", 5, 16, True)):
        x = _rand((1, f, h, h, 16), 50 + f + h)
        mod = jattn.WindowTemporalAttention(16, heads=2, dim_head=8)
        params = mod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
        cases[f"attention-{name}"] = dict(layer="attention", args=(16, 2, 8),
                                          x=x, mod=mod, params=params,
                                          ring=ring, g=_rand(x.shape, 60 + f))
    return cases


@pytest.fixture(scope="module")
def two_ranks():
    ring = _ring_cases(0)
    layers = _layer_cases()
    sent = {k: {kk: vv for kk, vv in c.items() if kk != "mod"}
            for k, c in layers.items()}
    for c in sent.values():
        c["params"] = jax.tree_util.tree_map(np.asarray, c["params"])
    got = launch.run(workers.ring_and_layer_cases, 2, args=(ring, sent),
                     device="cpu", timeout=TIMEOUT, threads=1)[0]
    return dict(ring=ring, layers=layers, got_ring=got[0], got_layers=got[1])


@pytest.fixture(scope="module")
def four_ranks():
    ring = _ring_cases(10)
    got = launch.run(workers.ring_cases, 4, args=(ring,), device="cpu",
                     timeout=TIMEOUT, threads=1)[0]
    return dict(ring=ring, got_ring=got)


def _check_ring(cases, got, name):
    c = cases[name]
    args = (c["scale"], c["causal"], c["ws"])
    fn = lambda q, k, v: _window_attention(q, k, v, *args)  # noqa: E731
    want, vjp = jax.vjp(fn, *(jnp.asarray(c[key]) for key in "qkv"))
    grads = vjp(jnp.asarray(c["g"]))
    np.testing.assert_allclose(got[name]["out"], np.asarray(want), atol=2e-5)
    for key, gw in zip(("dq", "dk", "dv"), grads):
        _close_grad(got[name][key], np.asarray(gw), f"{name} {key}")


@pytest.mark.parametrize("ws,causal", RING_CASES)
def test_ring_on_two_ranks_matches_windowed_attention(two_ranks, ws, causal):
    _check_ring(two_ranks["ring"], two_ranks["got_ring"],
                f"ws{ws}-causal{causal}")


@pytest.mark.parametrize("ws,causal", RING_CASES)
def test_ring_on_four_ranks_matches_windowed_attention(four_ranks, ws,
                                                       causal):
    _check_ring(four_ranks["ring"], four_ranks["got_ring"],
                f"ws{ws}-causal{causal}")


def _check_layer(two_ranks, name):
    c, got = two_ranks["layers"][name], two_ranks["got_layers"][name]
    mod = c["mod"]
    fn = lambda p, x: mod.apply({"params": p}, x)  # noqa: E731
    want, vjp = jax.vjp(fn, c["params"], jnp.asarray(c["x"]))
    dparams, dx = vjp(jnp.asarray(c["g"]))
    np.testing.assert_allclose(got["out"], np.asarray(want), atol=2e-5,
                               err_msg=name)
    _close_grad(got["dx"], np.asarray(dx), f"{name} dx")
    tmod = (tnorms.GroupNorm(*c["args"]) if c["layer"] == "group_norm"
            else tattn.WindowTemporalAttention(*c["args"]))
    want_p = jax_to_state_dict(jax.tree_util.tree_map(np.asarray, dparams),
                               tmod)
    assert set(got["params"]) == {n for n, _ in tmod.named_parameters()}
    for key, gp in got["params"].items():
        _close_grad(gp, want_p[key].numpy(), f"{name} {key}")


@pytest.mark.parametrize("f", [4, 5])
def test_group_norm_split_over_seq_matches_whole(two_ranks, f):
    _check_layer(two_ranks, f"group_norm-f{f}")


@pytest.mark.parametrize("branch", ["ring", "k6", "k1_ring_off",
                                    "einsum_ws4"])
def test_window_temporal_attention_split_over_seq_matches_whole(two_ranks,
                                                                branch):
    _check_layer(two_ranks, f"attention-{branch}")
