"""Milliseconds a call of the plain pose-graph and bundle-adjustment solves
on one CUDA card, on problems made from a seed at chip_smoke.py's sizes.

  python tools/solver_ms.py [--root DIR] [--reps 5]

Imports `rgbdslam_tpu_torch` from the tree at --root (default: this one),
so runs on a `git archive` copy of an earlier commit and on this tree,
alternated (parent, change, change, parent), compare the two versions of
the same public entries, which exist in both:

  pose_graph_dense  solvers.pose_graph.optimize_pose_graph, K 117, E 259, 10 iterations
  pose_graph_cg     solvers.cg.optimize_pose_graph_cg, the same graph, 10 x 50 CG
  sim3_dense        solvers.pose_graph.optimize_sim3_graph, the same graph, 10 iterations
  local_ba_window   solvers.ba.local_ba, K 5, L 256, M 5, 4 iterations
  local_ba_map      solvers.ba.local_ba, K 128, L 8192, M 6 with the chain's edges, 6 iterations

The graph is a perturbed chain with random skip edges; the BA problems are
landmarks seen by cameras along a line, pixels with 0.5 px of noise, the
poses and landmarks perturbed. Each entry: one warm call, then --reps
calls, each timed by CUDA events; the median ms a call and the sum of the
solved poses (a check that both trees solve alike) are printed. The card's
name and power limit come first; the last line is one JSON object of every
number. Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def chain_graph(K: int, E: int, rng):
    """(truth Twc (K, 4, 4), initial Twc, a, b, Z) as numpy: a chain with
    E - (K - 1) random skip edges, Z = Twc_a^-1 Twc_b from the truth."""
    from rgbdslam_tpu_torch.geometry import se3
    import torch

    xi = rng.normal(scale=0.2, size=(K, 6)).astype(np.float32)
    xi[0] = 0
    truth = se3.exp(torch.from_numpy(xi)).numpy()
    skip = E - (K - 1)
    a = np.concatenate([np.arange(1, K), rng.integers(2, K, size=skip)])
    b = np.concatenate([np.arange(0, K - 1), np.maximum(a[K - 1:] - rng.integers(2, 10, size=skip), 0)])
    Z = np.stack([np.linalg.inv(truth[i]) @ truth[j] for i, j in zip(a, b)]).astype(np.float32)
    noise = rng.normal(scale=0.05, size=(K, 6)).astype(np.float32)
    noise[0] = 0
    init = (se3.exp(torch.from_numpy(noise)) @ torch.from_numpy(truth)).numpy()
    return truth, init, a, b, Z


def ba_problem(cam, K: int, L: int, M: int, rng, dev, with_edges: bool):
    """A BAProblem (and BAEdges along the chain of keyframes, or None) on
    `dev`: cameras 0.1 m apart along x looking down +z, landmarks 2-4 m
    ahead, each seen by M distinct keyframes."""
    import torch

    from rgbdslam_tpu_torch.geometry import se3
    from rgbdslam_tpu_torch.solvers.ba import BAEdges, BAProblem

    centres = np.zeros((K, 3), np.float32)
    centres[:, 0] = 0.1 * np.arange(K)
    Tcw = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    Tcw[:, :3, 3] = -centres
    Xw = np.stack([rng.uniform(-1.0, 1.0 + 0.1 * K, L), rng.uniform(-0.8, 0.8, L),
                   rng.uniform(2.0, 4.0, L)], axis=1).astype(np.float32)
    kf = np.stack([rng.choice(K, size=M, replace=False) for _ in range(L)])
    Xc = Xw[:, None, :] - centres[kf]
    z = Xc[..., 2]
    uv = np.stack([cam.fx * Xc[..., 0] / z + cam.cx, cam.fy * Xc[..., 1] / z + cam.cy], -1)
    uv = (uv + rng.normal(scale=0.5, size=uv.shape)).astype(np.float32)
    valid = (uv[..., 0] >= 0) & (uv[..., 0] < cam.width) & (uv[..., 1] >= 0) & (uv[..., 1] < cam.height)
    noise = rng.normal(scale=0.01, size=(K, 6)).astype(np.float32)
    noise[0] = 0
    Tcw0 = se3.exp(torch.from_numpy(noise)) @ torch.from_numpy(Tcw)
    Xw0 = Xw + rng.normal(scale=0.02, size=Xw.shape).astype(np.float32)
    problem = BAProblem(
        Tcw=Tcw0.to(dev), Xw=torch.from_numpy(Xw0).to(dev),
        lm_valid=torch.ones(L, dtype=torch.bool, device=dev),
        obs_kf=torch.from_numpy(kf).long().to(dev), obs_uv=torch.from_numpy(uv).to(dev),
        obs_valid=torch.from_numpy(valid).to(dev),
        obs_z=torch.from_numpy(np.where(valid, z, 0.0).astype(np.float32)).to(dev))
    if not with_edges:
        return problem, None
    Twc = np.linalg.inv(Tcw)
    a, b = np.arange(1, K), np.arange(0, K - 1)
    Z = np.stack([np.linalg.inv(Twc[i]) @ Twc[j] for i, j in zip(a, b)]).astype(np.float32)
    edges = BAEdges(a=torch.from_numpy(a).long().to(dev), b=torch.from_numpy(b).long().to(dev),
                    Z=torch.from_numpy(Z).to(dev), w=torch.full((K - 1,), 100.0, device=dev))
    return problem, edges


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                    help="the tree whose rgbdslam_tpu_torch is imported")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    from rgbdslam_tpu_torch.geometry.camera import SYNTHETIC
    from rgbdslam_tpu_torch.solvers import ba, cg, pose_graph

    if not str(Path(pose_graph.__file__).resolve()).startswith(str(root)):
        raise RuntimeError(f"imported {pose_graph.__file__}, not the tree at {root}")
    if not torch.cuda.is_available():
        print("solver_ms: CUDA is not available", file=sys.stderr)
        return 1
    smi = nvidia_smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; root {root}",
          flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    _, init, a, b, Z = chain_graph(117, 259, rng)
    X0 = torch.from_numpy(init).to(dev)
    edges = pose_graph.PoseGraphEdges(
        a=torch.from_numpy(a).long().to(dev), b=torch.from_numpy(b).long().to(dev),
        Z=torch.from_numpy(Z).to(dev), weight=torch.full((len(a),), 100.0, device=dev))
    fixed = torch.arange(117, device=dev) == 0
    window, _ = ba_problem(SYNTHETIC, 5, 256, 5, rng, dev, False)
    whole, map_edges = ba_problem(SYNTHETIC, 128, 8192, 6, rng, dev, True)
    fixed_w = torch.arange(5, device=dev) == 0
    fixed_m = torch.arange(128, device=dev) == 0
    entries = {
        "pose_graph_dense": lambda: pose_graph.optimize_pose_graph(X0, edges, fixed, 10)[0],
        "pose_graph_cg": lambda: cg.optimize_pose_graph_cg(X0, edges, fixed, 10, 50)[0],
        "sim3_dense": lambda: pose_graph.optimize_sim3_graph(X0, edges, fixed, 10)[0],
        "local_ba_window": lambda: ba.local_ba(SYNTHETIC, window, fixed_w, 4)[0],
        "local_ba_map": lambda: ba.local_ba(SYNTHETIC, whole, fixed_m, 6, edges=map_edges)[0],
    }
    out = {"root": str(root), "device": torch.cuda.get_device_name(0), "smi": smi}
    for name, solve in entries.items():
        solve()
        torch.cuda.synchronize()
        ms = []
        for _ in range(args.reps):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            T = solve()
            stop.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(stop))
        out[name] = {"ms": statistics.median(ms), "ms_all": ms,
                     "pose_sum": float(T.double().sum())}
        print(f"[solver] {name}: {statistics.median(ms):.2f} ms a call (median of "
              f"{args.reps}; {', '.join(f'{x:.2f}' for x in ms)}), pose sum "
              f"{out[name]['pose_sum']:.6f} ({smi})", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
