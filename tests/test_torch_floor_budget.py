"""The port's floor budgets (``seervideoldm_tpu_torch/tools/floor_budget.py``,
``tools/floor_budget_train.py``) on the CPU.

- the floor model with the JAX tool's TPU v5e constants and its measured
  softmax calibration reproduces every floor field of ``FLOORBUDGET.json``
  (three rows) and its ``floor_sum_ms`` within 1e-9 relative (the same
  formulas; the record stores full floats), and the nine floor fields of
  ``FLOORBUDGET_TRAIN.json`` at 2.12 ps within 2e-3 ms (the record keeps
  three decimals and a calibration rounded to 2.12);
- the H100 roofline: the mma.sync k-granule of 16 (d = 40 pads to 48), and
  floors below the v5e's;
- both entries run their plain path on the CPU at narrow widths
  (``--device cpu``) and print their JSON line; the whole-UNet and site
  rows, the four training sections and the remat sweep are all there.
"""
import json
import os

import pytest
import torch

from seervideoldm_tpu_torch.tools import floor_budget as fb
from seervideoldm_tpu_torch.tools import floor_budget_train as fbt

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLING_FIELDS = ("res_down_floor_ms", "res_up_floor_ms", "text_floor_ms",
                   "temp_floor_ms", "text_sm_ms", "temp_sm_ms")


def _record(name):
    with open(os.path.join(ROOT, name)) as f:
        return json.load(f)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_sampling_floors_reproduce_the_tpu_record(level):
    rec = _record("FLOORBUDGET.json")
    got = fb.site_floors(512, 12, 2, fb.Roofline.v5e(),
                         2.4043489243201863e-12)
    row, want = got["rows"][level], rec["rows"][level]
    for key in ("level", "hw", "ch", "d", "n_triplets"):
        assert row[key] == want[key], key
    for key in SAMPLING_FIELDS:
        assert row[key] == pytest.approx(want[key], rel=1e-9), key


def test_sampling_floor_sum_reproduces_the_tpu_record():
    rec = _record("FLOORBUDGET.json")
    got = fb.site_floors(512, 12, 2, fb.Roofline.v5e(),
                         rec["sm_ps_per_elem"] * 1e-12)
    assert got["floor_sum_ms"] == pytest.approx(rec["floor_sum_ms"],
                                                rel=1e-9)
    assert got["l3"]["hw"] == 8 and got["l3"]["n_res"] == 7


@pytest.mark.parametrize("level", [0, 1, 2])
def test_train_floors_reproduce_the_tpu_record(level):
    rec = _record("FLOORBUDGET_TRAIN.json")
    want = rec["section4_site_rows_fwd_bwd_no_remat_b1"][level]
    assert rec["section4_softmax_ps_per_elem"] == 2.12
    row = fb.train_site_floors(256, 12, 1, fb.Roofline.v5e(), 2.12e-12)[level]
    assert row["level"] == want["level"]
    for key in ("res_floor", "text_floor", "temp_floor"):
        assert abs(row[key] - want[key]) <= 2e-3, (key, row[key], want[key])


def test_h100_roofline():
    h100, v5e = fb.Roofline.h100(), fb.Roofline.v5e()
    assert (h100.peak, h100.hbm_bw, h100.granule) == (989e12, 3.35e12, 16)
    assert fb.occ(40, h100) == pytest.approx(40 / 48)
    assert fb.occ(80, h100) == 1.0 and fb.occ(320, h100) == 1.0
    assert fb.occ(40, v5e) == pytest.approx(40 / 128)
    assert fb.hbm_ms(1e9, 1, h100) == pytest.approx(2e9 / 3.35e12 * 1e3)
    fast = fb.site_floors(512, 12, 2, h100, 0.33e-12)
    slow = fb.site_floors(512, 12, 2, v5e, 2.4e-12)
    assert 0.0 < fast["floor_sum_ms"] < slow["floor_sum_ms"] / 4


def _json_line(text, key):
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    assert lines, text[-2000:]
    return json.loads(lines[-1])[key]


def test_sampling_entry_on_the_cpu(capsys):
    out = fb.main(["--device", "cpu", "--resolution", "64", "--frames", "2",
                   "--batch", "1", "--widths", "32,64,64,64",
                   "--calib_reps", "1,2", "--iters", "1", "--json"])
    line = _json_line(capsys.readouterr().out, "floor_budget")
    assert line["device"] == "cpu" and line["card"] == "cpu"
    assert line["step_kernel_ms"] is None
    assert [r["level"] for r in line["rows"]] == ["L0", "L1", "L2"]
    assert len(line["site_table"]) == 3 * 3 + 2
    for r in line["rows"]:
        for key in ("res_down_ms", "res_up_ms", "text_ms", "temp_ms"):
            assert r[key] > 0.0 and r[key.replace("_ms", "_kernel_ms")] is None
    assert line["floor_sum_ms"] == pytest.approx(out["floor_sum_ms"])
    assert line["step_ms"] > 0.0


def test_train_entry_on_the_cpu(capsys):
    out = fbt.main(["--device", "cpu", "--resolution", "64", "--frames", "3",
                    "--cond_frames", "1", "--widths", "32,64,64,64",
                    "--fstext_layers", "1", "--batches", "1,2",
                    "--calib_reps", "1,2", "--iters", "1", "--json"])
    line = _json_line(capsys.readouterr().out, "floor_budget_train")
    assert set(line["step_ms_by_batch"]) == {"1", "2"}
    assert "accum2_vs_b2_speedup" in line
    assert set(line["remat_ms"]) == {"save_attn", "block", "none"}
    # no kernel runs on the CPU: every launch count is 0
    assert all(n == 0 for counts in line["remat_launches"].values()
               for n in counts.values())
    assert line["optimizer_ms"] > 0.0 and line["step_ms"] > 0.0
    assert [r["level"] for r in line["site_rows"]] == ["L0", "L1", "L2"]
    assert line["sites_sum_ms"] == pytest.approx(out["sites_sum_ms"])


def test_train_entry_refuses_an_unknown_remat():
    with pytest.raises(ValueError, match="not supported"):
        fbt.main(["--device", "cpu", "--remat", "bogus"])
