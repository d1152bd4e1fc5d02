"""Run the JAX package's serial full SLAM on the synthetic multi-room tour on
the CPU and print its accuracy record: ATE, keyframes, loops, failures.

  python tools/tour_reference_jax.py [--frames 128] [--seeds 0 1 2]
  python tools/tour_reference_jax.py --loops 1.15 --noise --config noise-robust

The configuration is the one chip_smoke.py drives through the PyTorch port
on the GPU (640x480, default SlamConfig with the loop gates id_interval=12,
min_kfs_since_loop=10, shipped vocabulary), so the two are like for like.
With `--noise` every frame carries the Kinect-class sensor noise of seed s
(the seed of the run): the fields are drawn on the host with numpy
(`kinect_noise_fields(s, i, ...)`) and applied by the port's
`apply_sensor_noise` on the CPU, the same noisy pixels chip_smoke.py feeds
the port on the card. `--config` adds the CLI's accuracy flags, joined by
`+` (noise-robust = dense ICP; local-ba; global-ba). Only accuracy and counts
are printed: a CPU run says nothing about speed.
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

CONFIGS = {"base": {}, "noise-robust": {"use_dense_icp": True},
           "local-ba": {"use_local_ba": True}, "global-ba": {"use_global_ba": True}}


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
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--loops", type=float, default=1.0,
                    help="revolutions of the tour (1.15: a real revisit of the start)")
    ap.add_argument("--noise", action="store_true",
                    help="Kinect-class sensor noise, seed = the run's seed")
    ap.add_argument("--config", default="base",
                    help="+-joined names of " + ", ".join(sorted(CONFIGS)))
    args = ap.parse_args()
    flags = {}
    for name in args.config.split("+"):
        flags.update(CONFIGS[name])
    cfg = dataclasses.replace(
        SlamConfig(loop=LoopConfig(id_interval=12, min_kfs_since_loop=10)), **flags)
    ds = SyntheticDataset(n_frames=args.frames, cam=SYNTHETIC, trajectory="tour",
                          loops=args.loops)
    clean = [ds.grab(i) for i in range(args.frames)]
    for seed in args.seeds:
        frames = noisy(clean, seed) if args.noise else clean
        system = SlamSystem(SYNTHETIC, cfg, seed=seed)
        system.load_vocabulary(shipped_vocabulary("svo_fast"))
        for ts, gray, depth in frames:
            system.track(ts, gray, depth)
        system.finish()
        ts_c, poses_c = system.camera_trajectory()
        rmse, info = ate_rmse(ts_c, poses_c, ds.timestamps, ds.poses_twc)
        print(json.dumps({
            "package": "rgbdslam_tpu (JAX, CPU)", "seed": seed,
            "frames": args.frames, "loops": args.loops, "noise": args.noise,
            "config": args.config, "ate_rmse": round(float(rmse), 5),
            "keyframes": int(system.store.count),
            "loops_closed": int(system.loops_closed),
            "failures": int(system.tracker.stats.failures),
            "relocalizations": int(system.tracker.stats.relocalizations),
            "graph_vertices": int(system.graph.n_vertices),
            "graph_edges": int(system.graph.n_edges),
            "mean_inliers": int(system.tracker.stats.mean_inliers),
            "finite": bool(np.isfinite(poses_c).all()),
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
