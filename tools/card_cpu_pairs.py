"""The tracking estimate of the 48-frame 640x480 sweep's frame pairs on the
card and on the CPU with the same RANSAC draws, for a grid cell size.

  python tools/card_cpu_pairs.py [--cells 2 16]

For each cell size: every frame's features built on the card (the kernels
alone: a plain version that runs raises) and on the CPU (the plain
versions) from the same pixels, and the fields that differ by more than
1e-4 (or in any integer entry); then each consecutive pair through
`slam.tracking.fused_estimate` (match, RANSAC, the GICP polish) on both
devices with the same draws (numpy, seeded by the cell size): the pairs
whose T21 entries lie more than 1e-3 apart or whose success or inlier count
differ, and the largest and median T21 difference. Separates what the
device does to a run from what its RANSAC draws do (a seed's draws on the
card are not its draws on the CPU). Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, nargs="+", default=[2, 16])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from port_behaviour import plain_versions_forbidden
    from rgbdslam_tpu_torch.config import SlamConfig
    from rgbdslam_tpu_torch.frontend.extractor import Extractor
    from rgbdslam_tpu_torch.frontend.matcher import gather_matched_points, match_frames
    from rgbdslam_tpu_torch.geometry.camera import SYNTHETIC
    from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset
    from rgbdslam_tpu_torch.slam.tracking import fused_estimate

    dev = torch.device("cuda")
    ds = SyntheticDataset(n_frames=48, cam=SYNTHETIC, trajectory="sweep", device=dev)
    frames = [ds.grab(i) for i in range(48)]
    base = SlamConfig()
    for cell in args.cells:
        cfg = dataclasses.replace(base, extractor=dataclasses.replace(base.extractor,
                                                                      cell_size=cell))
        ex = Extractor(SYNTHETIC, cfg.extractor)
        card, cpu, apart = [], [], []
        for i, (_, g, d) in enumerate(frames):
            with plain_versions_forbidden():
                fc = ex(g, d)
            fp = ex(g.cpu(), d.cpu())
            for f in dataclasses.fields(fc):
                a, b = getattr(fc, f.name), getattr(fp, f.name)
                if not isinstance(a, torch.Tensor):
                    continue
                a = a.cpu()
                if a.dtype.is_floating_point:
                    diff = (a - b).abs()
                    diff = diff[torch.isfinite(diff)]
                    err = float(diff.max()) if diff.numel() else 0.0
                    if err > 1e-4 or not torch.equal(torch.isfinite(a), torch.isfinite(b)):
                        apart.append([i, f.name, err])
                elif not torch.equal(a, b):
                    apart.append([i, f.name, int((a != b).sum())])
            card.append(fc)
            cpu.append(fp)
        rng = np.random.default_rng(cell)
        rows = []
        for i in range(1, len(frames)):
            m = match_frames(cpu[i - 1], cpu[i], cfg.matcher.nn_ratio)
            n = max(int(gather_matched_points(cpu[i - 1], cpu[i], m)[3].sum()), 1)
            draws = torch.from_numpy(rng.integers(
                0, n, (cfg.ransac.num_hypotheses, cfg.ransac.sample_size)))
            with plain_versions_forbidden():
                rc = fused_estimate(card[i - 1], card[i], cfg, draws=draws.to(dev)).cpu()
            rp = fused_estimate(cpu[i - 1], cpu[i], cfg, draws=draws)
            rows.append({"pair": i, "valid": n, "dT": float((rc[:16] - rp[:16]).abs().max()),
                         "success": [float(rc[16]), float(rp[16])],
                         "rmse": [float(rc[17]), float(rp[17])],
                         "inliers": [int(rc[18]), int(rp[18])]})
        off = [r for r in rows if r["dT"] > 1e-3 or r["success"][0] != r["success"][1]
               or r["inliers"][0] != r["inliers"][1]]
        print(json.dumps({"cell": cell, "feature_fields_apart": apart,
                          "pairs": len(rows), "pairs_apart": off,
                          "max_dT": max(r["dT"] for r in rows),
                          "median_dT": float(np.median([r["dT"] for r in rows]))}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
