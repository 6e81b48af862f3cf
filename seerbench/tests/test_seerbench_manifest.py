"""BENCHMARK.json against the benchmark's contract, and every piece of a
cell found by its name."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "seerbench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(MANIFEST["command"]) <= 32
    assert all(_line(w) for w in MANIFEST["command"])
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    seen = set()
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"]) and _line(c["source"])
        assert c["file"].startswith("seerbench/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    for group in ("end_to_end", "per_layer"):
        for m in MANIFEST[group]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert m["name"] not in seen
            seen.add(m["name"])
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values())


def test_every_cell_reports_what_it_must():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    by = lambda group, cell: [m for m in MANIFEST[group]  # noqa: E731
                              if cell in m.get("workloads", cells)]
    for cell in cells:
        e2e = {m["name"] for m in by("end_to_end", cell)}
        assert "setup_s" in e2e and len(e2e) >= 2
        per = by("per_layer", cell)
        assert per
        assert {m["moves"] for m in per} <= e2e


def test_every_piece_is_found_by_name():
    for w in MANIFEST["workloads"]:
        wl = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
        assert wl["config"] == w["config"] and wl["chips"] == w["chips"]
        assert wl["why"] == w["why"]
        assert (BENCH / "configs" / f"{wl['config']}.json").is_file()
        assert (BENCH / "drivers" / f"{wl['driver']}.py").is_file()
        for name, limit in wl["limits"].items():
            assert limit is not None and limit > 0, (w["name"], name)
    for m in MANIFEST["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for c in MANIFEST["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


def test_an_added_workload_file_is_found_without_editing_others(tmp_path):
    """A later cell is a workload file and a manifest entry: the harness
    finds its configuration, driver and metrics by name."""
    shutil.copytree(BENCH, tmp_path / "seerbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = json.loads((BENCH / "workloads" / "sthv2.serve.c8.json").read_text())
    base["clients"] = 2
    (tmp_path / "seerbench" / "workloads" / "sthv2.serve.c2.json").write_text(
        json.dumps(base))
    manifest["workloads"].append({"name": "sthv2.serve.c2", "config": "seer-sthv2",
                                  "traffic": "serve.c2", "chips": 1,
                                  "why": "two clients"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    code = ("from seerbench import harness; from seerbench.run import load_module;"
            "wl = harness.load_json('workloads', 'sthv2.serve.c2');"
            "harness.load_json('configs', wl['config']);"
            "print(load_module('drivers', wl['driver']).__name__, wl['clients'])")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["seerbench_drivers_serve_closed", "2"]


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_run_prints_no_result_without_the_program_or_a_card(tmp_path, where):
    """Exits non-zero with no JSON line: here there is no card, and in a
    directory holding only BENCHMARK.json and seerbench/ there is no
    program either."""
    cwd = ROOT
    if where == "repo":
        import torch

        if torch.cuda.is_available():
            pytest.skip("a card is present: the run would measure")
    if where == "alone":
        shutil.copytree(BENCH, tmp_path / "seerbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
        cwd = tmp_path
    out = subprocess.run([sys.executable, "-m", "seerbench.run", "--workload",
                          "sthv2.serve.c8", "--seed", "4294967311",
                          "--seconds", "1", "--trace", "0"], cwd=cwd,
                         text=True, capture_output=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
