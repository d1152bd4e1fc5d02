"""A tiny copy of the benchmark for its CPU tests: the manifest and this
folder copied under a temporary root, with a 160x120 configuration, a short
traffic mix and their cell added as files and entries."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from slambench.manifest import FOLDER

HERE = Path(__file__).resolve().parent
CELL = "tiny.sweep_b8"
#: sound tiny runs on the CPU read ATE medians of 0.015-0.07 m and worst
#: sessions under 0.05 m, odometry RPE medians of 0.010 m (clean) and 0.029 m
#: (noisy), solve gaps of 1e-5-5e-5 and dense fixed-point moves of 2e-5 m; a
#: pose left unchanged reads an ATE of ~1.1 m (the sweep's own spread) and no
#: edge, a solve returning its input 1, the polish skipped 0.019 m
LIMITS = {"frames_missing": {"limit": 0}, "feature_mismatch": {"limit": 0},
          "match_mismatch": {"limit": 0}, "rpe_median_m": {"limit": 0.1},
          "solve_gap": {"limit": 0.05}, "ate_median_m": {"limit": 0.25},
          "ate_max_m": {"limit": 0.5}}
DENSE_LIMIT = {"dense_fixpoint_m": {"limit": 0.005}}


def tiny_config(frames: int = 36) -> dict:
    cfg = json.loads((HERE / "configs" / "tum_fast_brief.json").read_text())
    cfg["name"] = "tiny"
    cfg["sensor"].update(width=160, height=120, fx=131.25, fy=131.25, cx=79.5, cy=59.5)
    cfg["sequence_frames"] = frames
    sc = cfg["slam_config"]
    sc["extractor"].update(num_features=256, cell_size=8, fast_threshold=15.0, min_border=8)
    sc["ransac"]["num_hypotheses"] = 64
    sc["keyframe"] = {"max_keyframes": 64}
    return cfg


def make_root(tmp: Path, entry: str = "batched", trajectory: str = "sweep",
              noise: bool = False, frames: int = 36) -> Path:
    """A root holding BENCHMARK.json and the benchmark's folder, with the
    tiny cell `CELL` added as files and manifest entries. `noise` gives it
    the noisy-sensor preset: Kinect noise and the dense-ICP polish."""
    root = Path(tmp)
    shutil.copytree(HERE, root / FOLDER, ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cfg = tiny_config(frames)
    if noise:
        cfg["sensor"]["noise"] = {"sigma_gray": 2.0, "depth_coeff": 0.0015, "dropout": 0.03}
        cfg["slam_config"]["use_dense_icp"] = True
    (root / FOLDER / "configs" / "tiny.json").write_text(json.dumps(cfg))
    traffic = {"trajectory": trajectory, "entry": entry, "batch": 8, "loop": "closed",
               "pool_sessions": 2}
    if trajectory == "tour":
        traffic["trajectory_params"] = {"loops": 1.15}
    (root / FOLDER / "traffic" / "tiny_mix.json").write_text(json.dumps(traffic))
    limits = dict(LIMITS, **DENSE_LIMIT) if noise else LIMITS
    (root / FOLDER / "limits" / f"{CELL}.json").write_text(json.dumps({"limits": limits}))
    manifest["configs"].append({"name": "tiny", "source": "a test", "file":
                                f"{FOLDER}/configs/tiny.json", "reduced": [], "why": "tests"})
    manifest["workloads"].append({"name": CELL, "config": "tiny", "traffic": "tiny_mix",
                                  "chips": 1, "why": "tests"})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root
