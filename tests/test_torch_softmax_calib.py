"""K10, the on-chip softmax calibration
(``seervideoldm_tpu_torch/ops/kernels/softmax_calib.py``), on the CPU.

- the port's plain version against the body of
  ``tools/floor_budget.py::softmax_s_per_elem`` (:122-131) run through
  ``pl.pallas_call(..., interpret=True)`` at the TPU tool's (256, 2048) on
  the same numpy input.  Reps 4 and 16: the row sums and the final s within
  rtol 1e-6 (fp32 both sides; sums in another order).  Reps 0, 1 and 2 on
  an input that spans +-150, where an exp without the max subtraction
  overflows: s element by element within rtol 1e-5 and the row sums within
  1e-5 of the rows' sum of |s|.  The row sums alone are 1 + cols * 1e-6
  after any normalising pass, so s is what tells a wrong pass apart.  The
  body is a closure in the tool, so the harness below copies it, as
  ``tests/test_geglu_ff.py`` does, and also writes s out; the tool itself
  is not imported (it would set up a compilation cache);
- the wrapper takes the plain version for a CPU tensor and refuses another
  device than CPU or CUDA; the calibration shape and the two-point timing
  function on the CPU path.

The kernel itself runs on the card only: ``tests/test_torch_cuda.py``.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from seervideoldm_tpu_torch.ops.kernels import softmax_calib as K


def _pallas_softmax_calib(x, reps):
    """``softmax_s_per_elem``'s kernel body and call, interpret mode; the
    final s is written out beside the row sums."""
    rows, cols = x.shape

    def kernel(x_ref, o_ref, s_ref, *, reps):
        def body(i, s):
            m = jnp.max(s, axis=1, keepdims=True)
            e = jnp.exp(s - m)
            l = jnp.sum(e, axis=1, keepdims=True)
            return e / jnp.where(l == 0.0, 1.0, l) + 1e-6

        s = jax.lax.fori_loop(0, reps, body, x_ref[...])
        o_ref[...] = jnp.sum(s, axis=1, keepdims=True)
        s_ref[...] = s

    run = pl.pallas_call(
        partial(kernel, reps=reps),
        out_shape=(jax.ShapeDtypeStruct((rows, 1), jnp.float32),
                   jax.ShapeDtypeStruct((rows, cols), jnp.float32)),
        interpret=True)
    sums, s = run(jnp.asarray(x))
    return np.asarray(sums), np.asarray(s)


@pytest.mark.parametrize("reps", [4, 16])
def test_plain_matches_pallas_body(reps):
    x = np.random.RandomState(reps).randn(256, 2048).astype(np.float32) * 3
    want, want_s = _pallas_softmax_calib(x, reps)
    got, got_s = K.softmax_calib(torch.from_numpy(x), reps, return_s=True)
    assert got.shape == (256, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-6)


@pytest.mark.parametrize("reps", [0, 1, 2])
def test_plain_matches_pallas_body_first_passes(reps):
    """The passes before s settles near 1 / cols, on an input that spans
    +-150: s element by element within rtol 1e-5, the row sums within 1e-5
    of the rows' sum of |s| (one large term and 2047 small ones round at
    the large term's ulp: some 3e-6 of the sum in either order)."""
    x = np.random.RandomState(reps).randn(256, 2048).astype(np.float32) * 30
    want, want_s = _pallas_softmax_calib(x, reps)
    got, got_s = K.softmax_calib(torch.from_numpy(x), reps, return_s=True)
    assert np.isfinite(got_s.numpy()).all()
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-5, atol=0)
    err = np.abs(got.numpy() - want)
    assert (err <= 1e-5 * np.abs(want_s).sum(1, keepdims=True)).all()
    torch.testing.assert_close(
        K.softmax_calib(torch.from_numpy(x), reps), got, rtol=0, atol=0)


def test_zero_reps_is_the_row_sum():
    x = torch.randn(8, 512, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(K.softmax_calib(x, 0), x.sum(1, keepdim=True))


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        K.softmax_calib(torch.empty(8, 2048, device="meta"), 4)


def test_calibration_shape_and_cpu_timing():
    """Two resident 8-row CTAs on each of an H100 SXM's 132 SMs; the
    two-point delta on the CPU path is a positive number (a host-clock
    price of the plain version, not a device figure)."""
    assert K.calibration_rows("cpu") == 132 * 8 * 2 == 2112
    assert K.CALIB_COLS == 2048
    s = K.softmax_s_per_elem("cpu", reps=(1, 3), iters=1)
    assert s > 0.0
