"""Run the JAX package's serial full SLAM on the synthetic multi-room tour on
the CPU and print its accuracy record: ATE, keyframes, loops, failures.

  python tools/tour_reference_jax.py [--frames 128] [--seeds 0 1 2]
  python tools/tour_reference_jax.py --loops 1.15 --noise --config noise-robust
  python tools/tour_reference_jax.py --loops 1.15 --detector sift --seeds 0
  python tools/tour_reference_jax.py --loops 1.15 --detector orb --batch 8
  python tools/tour_reference_jax.py --loops 1.15 --detector orb --config cell6 --seeds 0
  python tools/tour_reference_jax.py --sweep --config euclidean --seeds 0 1 2 3 4

The configuration is the one chip_smoke.py drives through the PyTorch port
on the GPU (640x480, default SlamConfig with the loop gates id_interval=12,
min_kfs_since_loop=10, shipped vocabulary), so the two are like for like.
With `--noise` every frame carries the Kinect-class sensor noise of seed s
(the seed of the run): the fields are drawn on the host with numpy
(`kinect_noise_fields(s, i, ...)`) and applied by the port's
`apply_sensor_noise` on the CPU, the same noisy pixels chip_smoke.py feeds
the port on the card. `--config` adds the CLI's accuracy flags, joined by
`+` (noise-robust or dense = dense ICP; local-ba; global-ba; cell5, cell6 =
that grid cell; euclidean, adaptive_euclidean = RANSAC's error model; mahal =
the Mahalanobis polish of RANSAC's winner; reassociate = GICP's nearest-
neighbour re-pairing). `--sweep` runs the 48-frame 640x480 sweep through
`PipelinedOdometry` (batch 8, the RANSAC seed = the run's seed) instead of the
tour through `SlamSystem`: chip_smoke.py's phase 4 and 11 runs. `--detector` picks an
extractor variant of the factory (the vocabulary is then the shipped one of
its descriptor family, or none: the codebook trains online), `--subpixel`
turns on the detector's subpixel refinement, `--batch B` tracks in batches
of B frames. Only accuracy and counts are printed (with the frames that
failed and each frame's RANSAC inliers): a CPU run says nothing about speed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from rgbdslam_tpu.config import LoopConfig, SlamConfig  # noqa: E402
from rgbdslam_tpu.eval.ate import ate_rmse  # noqa: E402
from rgbdslam_tpu.geometry.camera import SYNTHETIC  # noqa: E402
from rgbdslam_tpu.io.synthetic import SyntheticDataset  # noqa: E402
from rgbdslam_tpu.loop.vocabulary import shipped_vocabulary  # noqa: E402
from rgbdslam_tpu.slam.system import SlamSystem  # noqa: E402

# SlamConfig fields by name; a dict value replaces fields of that sub-config
CONFIGS = {"base": {}, "noise-robust": {"use_dense_icp": True},
           "dense": {"use_dense_icp": True},
           "local-ba": {"use_local_ba": True}, "global-ba": {"use_global_ba": True},
           "cell5": {"extractor": {"cell_size": 5}}, "cell6": {"extractor": {"cell_size": 6}},
           "euclidean": {"ransac": {"error_model": "euclidean"}},
           "adaptive_euclidean": {"ransac": {"error_model": "adaptive_euclidean"}},
           "mahal": {"ransac": {"mahalanobis_refine": True}},
           "reassociate": {"icp": {"reassociate": True}}}


def configured(cfg, names: str):
    """cfg with the +-joined CONFIGS entries applied in order."""
    for name in names.split("+"):
        for field, value in CONFIGS[name].items():
            if isinstance(value, dict):
                value = dataclasses.replace(getattr(cfg, field), **value)
            cfg = dataclasses.replace(cfg, **{field: value})
    return cfg


def run_sweep(args, cfg) -> None:
    """The 48-frame sweep through the JAX package's PipelinedOdometry, one
    JSON line a seed."""
    from rgbdslam_tpu.slam.pipeline import PipelinedOdometry

    ds = SyntheticDataset(n_frames=args.frames, cam=SYNTHETIC, trajectory="sweep")
    frames = [ds.grab(i) for i in range(args.frames)]
    for seed in args.seeds:
        ts, poses, stats = PipelinedOdometry(SYNTHETIC, cfg, batch=8, seed=seed).run(frames)
        rmse, _ = ate_rmse(ts, poses, ds.timestamps, ds.poses_twc)
        print(json.dumps({
            "package": "rgbdslam_tpu (JAX, CPU)", "seed": seed, "trajectory": "sweep",
            "frames": args.frames, "config": args.config, "detector": args.detector,
            "ate_rmse": round(float(rmse), 5), "failures": int(stats["failures"]),
            "mean_inliers": int(stats["mean_inliers"]),
            "finite": bool(np.isfinite(poses).all())}), flush=True)


def noisy(frames, seed: int):
    """The frames with seed `seed`'s sensor noise, as host arrays."""
    import torch

    from rgbdslam_tpu_torch.io.synthetic import apply_sensor_noise, kinect_noise_fields

    out = []
    for i, (ts, gray, depth) in enumerate(frames):
        h, w = np.shape(gray)
        g, d = apply_sensor_noise(SYNTHETIC, torch.from_numpy(np.array(gray)),
                                  torch.from_numpy(np.array(depth)),
                                  *([None] + list(kinect_noise_fields(seed, i, h, w))))
        out.append((ts, g.numpy(), d.numpy()))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=None,
                    help="frames of the run (128 on the tour, 48 on the sweep)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--loops", type=float, default=1.0,
                    help="revolutions of the tour (1.15: a real revisit of the start)")
    ap.add_argument("--noise", action="store_true",
                    help="Kinect-class sensor noise, seed = the run's seed")
    ap.add_argument("--config", default="base",
                    help="+-joined names of " + ", ".join(sorted(CONFIGS)))
    ap.add_argument("--detector", default="svo_fast",
                    help="extractor variant (Extractor.VARIANTS)")
    ap.add_argument("--subpixel", action="store_true",
                    help="subpixel refinement of the keypoints")
    ap.add_argument("--batch", type=int, default=0, metavar="B",
                    help="track in batches of B frames (SlamSystem.track_batch) "
                         "instead of frame by frame")
    ap.add_argument("--sweep", action="store_true",
                    help="the 48-frame sweep through PipelinedOdometry (batch 8), "
                         "default SlamConfig")
    args = ap.parse_args()
    if args.sweep:
        args.frames = args.frames or 48
        cfg = dataclasses.replace(SlamConfig(), detector=args.detector)
        run_sweep(args, configured(cfg, args.config))
        return 0
    args.frames = args.frames or 128
    cfg = configured(dataclasses.replace(
        SlamConfig(loop=LoopConfig(id_interval=12, min_kfs_since_loop=10)),
        detector=args.detector), args.config)
    if args.subpixel:
        cfg = dataclasses.replace(
            cfg, extractor=dataclasses.replace(cfg.extractor, subpixel=True))
    vocab = shipped_vocabulary(args.detector)
    ds = SyntheticDataset(n_frames=args.frames, cam=SYNTHETIC, trajectory="tour",
                          loops=args.loops)
    clean = [ds.grab(i) for i in range(args.frames)]
    for seed in args.seeds:
        frames = noisy(clean, seed) if args.noise else clean
        system = SlamSystem(SYNTHETIC, cfg, seed=seed)
        if vocab:
            system.load_vocabulary(vocab)
        failed = []      # serial: the frames; batched: each failure's batch start
        if args.batch:
            for i in range(0, len(frames), args.batch):
                before = system.tracker.stats.failures
                system.track_batch(*zip(*frames[i:i + args.batch]))
                failed += [i] * (system.tracker.stats.failures - before)
        else:
            for i, (ts, gray, depth) in enumerate(frames):
                before = system.tracker.stats.failures
                system.track(ts, gray, depth)
                if system.tracker.stats.failures > before:
                    failed.append(i)
        system.finish()
        ts_c, poses_c = system.camera_trajectory()
        rmse, info = ate_rmse(ts_c, poses_c, ds.timestamps, ds.poses_twc)
        print(json.dumps({
            "package": "rgbdslam_tpu (JAX, CPU)", "seed": seed,
            "frames": args.frames, "loops": args.loops, "noise": args.noise,
            "config": args.config, "detector": args.detector,
            "subpixel": args.subpixel, "batch": args.batch, "ate_rmse": round(float(rmse), 5),
            "keyframes": int(system.store.count),
            "loops_closed": int(system.loops_closed),
            "failures": int(system.tracker.stats.failures),
            "failed_frames": failed,
            "relocalizations": int(system.tracker.stats.relocalizations),
            "graph_vertices": int(system.graph.n_vertices),
            "graph_edges": int(system.graph.n_edges),
            "mean_inliers": int(system.tracker.stats.mean_inliers),
            "finite": bool(np.isfinite(poses_c).all()),
            "inliers": [int(f.num_inliers) for f in system.tracker.trajectory],
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
