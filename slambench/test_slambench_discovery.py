"""Discovery by name, and BENCHMARK.json against the format it must keep.

A configuration, a traffic mix, a limit file and a per-layer metric added
as files (with their manifest entries) run without an edit to any file the
benchmark has."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest
import torch

from slambench import tiny
from slambench.manifest import Cell, load_module

HERE = Path(__file__).resolve().parent
MANIFEST = json.loads((HERE.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_added_files_are_found_and_run(tmp_path):
    root = tiny.make_root(tmp_path)
    (root / "slambench" / "metrics" / "frames_seen.py").write_text(
        'NAME, UNIT, BETTER, SOURCE = "frames_seen", "frames", "higher", "host_clock"\n'
        'LAYER, MOVES = "system", "frames_per_s"\n\n\n'
        "def read(run):\n    return float(run.frames_returned)\n")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["per_layer"].append({"name": "frames_seen", "unit": "frames", "better": "higher",
                                  "source": "program_counter", "layer": "system",
                                  "moves": "frames_per_s", "workloads": [tiny.CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = Cell(root, tiny.CELL)
    assert cell.config["name"] == "tiny" and cell.traffic["entry"] == "batched"
    assert "frames_seen" in [m["name"] for m in cell.metrics("per_layer")]
    from slambench.run import run

    torch.set_num_threads(2)
    res = run(cell, 17, 6.0, True, device="cpu")
    assert res["metrics"]["frames_seen"]["value"] == res["attempted"]
    assert res["correct"], res["checks"]
    assert "busy_s" in res["device"] and "breakdown" in res


def _holds(cfg: dict, key: str) -> bool:
    """A `reduced` key names a field of the configuration file or of its
    `slam_config`, a dotted key one inside a group of it."""
    for node in (cfg, cfg.get("slam_config", {})):
        for part in key.split("."):
            if not isinstance(node, dict) or part not in node:
                break
            node = node[part]
        else:
            return True
    return False


def test_every_named_file_exists_and_declares_its_metric():
    for c in MANIFEST["configs"]:
        cfg = json.loads((HERE.parent / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        assert all(_holds(cfg, k) for k in c["reduced"])
    for w in MANIFEST["workloads"]:
        cell = Cell(HERE.parent, w["name"])
        core = {"frames_missing", "feature_mismatch", "match_mismatch", "rpe_median_m",
                "solve_gap", "ate_median_m", "ate_max_m"}
        dense = {"dense_fixpoint_m"} if cell.config["slam_config"]["use_dense_icp"] else set()
        assert set(cell.limits) == core | dense
    for kind in ("end_to_end", "per_layer"):
        for m in MANIFEST[kind]:
            mod = load_module(HERE / "metrics" / f"{m['name']}.py")
            assert (mod.NAME, mod.UNIT, mod.BETTER, mod.SOURCE) == (
                m["name"], m["unit"], m["better"], m["source"])
            if kind == "per_layer":
                assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])


def test_manifest_keeps_its_format():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["slambench"] and len(MANIFEST["command"]) <= 32
    assert 1 <= MANIFEST["run_seconds"] <= 51
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for group, want in keys.items():
        names = [e["name"] for e in MANIFEST[group]]
        assert len(names) == len(set(names))
        for e in MANIFEST[group]:
            assert set(e) - {"workloads"} == want, e
            assert NAME.match(e["name"])
            for k in ("why", "layer") + (("source",) if group == "configs" else ()):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e and len(m["layer"]) <= 200
    for w in MANIFEST["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
    assert len(json.dumps(MANIFEST)) < 64 * 1024


@pytest.mark.gpu
def test_control_on_the_card(tmp_path):
    """The tf32 control on the card at the tiny size (skips without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from slambench.run import run

    cell = Cell(tiny.make_root(tmp_path), tiny.CELL)
    assert run(cell, 23, 6.0, False, device="cuda")["correct"]
    res = run(cell, 23, 6.0, False, device="cuda", control="tf32")
    assert not res["correct"] and res["checks"]["feature_mismatch"]["value"] > 0
