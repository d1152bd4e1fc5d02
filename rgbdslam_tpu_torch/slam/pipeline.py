"""Pipelined odometry: the per-frame tracking step over a frame sequence, B
frames per host round trip (port of rgbdslam_tpu/slam/pipeline.py).

Per frame, on the device: features of frame i, matching against the
features of frame i-1, Mahalanobis RANSAC, and the GICP polish, which is
computed on every frame and selected by the rmse >= 0.8 trigger with a
`where` (no host branch). The JAX `lax.scan` becomes a Python loop that
only enqueues device work; each batch of B frames is copied to the device
once and its (B, 18) results come back in one device-to-host copy, so no
frame waits for the host. No keyframes and no backend. Like the JAX
package's pipeline (pipeline.py:42-62), it ignores `use_dense_icp`: the
dense polish belongs to the tracker's modes.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np
import torch

from rgbdslam_tpu_torch.config import SlamConfig
from rgbdslam_tpu_torch.device import resolve_device
from rgbdslam_tpu_torch.frontend.frame import FrameFeatures, build_frame_features
from rgbdslam_tpu_torch.frontend.matcher import gather_matched_points, match_frames
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.slam.tracking import check_system_config
from rgbdslam_tpu_torch.solvers.icp import gicp_refine
from rgbdslam_tpu_torch.solvers.ransac_se3 import ransac_se3
from rgbdslam_tpu_torch.utils.profiling import spanned


def track_pair(cfg: SlamConfig, f_prev: FrameFeatures, f_cur: FrameFeatures,
               generator: torch.Generator, draws=None):
    """One frame pair's odometry on the device: matching, RANSAC (its
    samples from `generator`, or the injected `draws`) and the GICP polish
    selected by the rmse trigger. Returns T21 (frame i-1 -> frame i), the
    inlier count and success."""
    m = match_frames(f_prev, f_cur, cfg.matcher.nn_ratio)
    p1, p2, w, valid = gather_matched_points(f_prev, f_cur, m)
    res = ransac_se3(p1, p2, w, valid, generator, cfg.ransac, draws=draws)
    T21 = res.T21
    if cfg.use_icp_refinement:
        T_g, conv, _ = gicp_refine(p1, p2, res.inliers, T21, cfg.icp,
                                   C1=f_prev.surf_cov,
                                   C2=f_cur.surf_cov[m.idx2.long()])
        use = (res.rmse >= cfg.icp.rmse_trigger) & conv & res.success
        T21 = torch.where(use, T_g, T21)
    return T21, res.num_inliers, res.success


class PipelinedOdometry:
    def __init__(self, cam: Camera, cfg: SlamConfig = SlamConfig(),
                 batch: int = 8, seed: int = 0, device="cuda"):
        if batch < 1:
            raise ValueError("batch must be >= 1")
        self.cam = cam
        self.cfg = cfg
        self.batch = batch
        self.device = resolve_device(device)
        check_system_config(cfg, cam, self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------------
    def features(self, gray: torch.Tensor, depth: torch.Tensor) -> FrameFeatures:
        return build_frame_features(self.cam, gray, depth, self.cfg.extractor)

    def track_pair(self, f_prev: FrameFeatures, f_cur: FrameFeatures, draws=None):
        """T21 (frame i-1 -> frame i), inlier count and success, on the
        device; `draws` optionally injects RANSAC's sample indices."""
        return track_pair(self.cfg, f_prev, f_cur, self.generator, draws)

    # ------------------------------------------------------------------
    @spanned("tracker.pipeline")
    def run(self, frames: Iterable[Tuple[float, object, object]],
            f_ref: FrameFeatures | None = None
            ) -> Tuple[np.ndarray, np.ndarray, dict]:
        """Process an iterable of (timestamp, gray, depth) (numpy arrays or
        tensors). Returns (timestamps [N], poses Twc [N, 4, 4], stats).
        Failed frames keep the previous pose (recover() semantics).
        `f_ref` optionally replaces the first frame's features."""
        frames = iter(frames)
        try:
            ts0, g0, d0 = next(frames)
        except StopIteration:
            return np.zeros((0,)), np.zeros((0, 4, 4), np.float32), {}

        dev = self.device
        if f_ref is None:
            f_ref = self.features(torch.as_tensor(g0).to(dev), torch.as_tensor(d0).to(dev))
        timestamps: List[float] = [ts0]
        Tcw = np.eye(4, dtype=np.float32)
        poses: List[np.ndarray] = [np.linalg.inv(Tcw)]
        failures = 0
        inliers_sum = 0
        batch: List[Tuple[float, object, object]] = []

        def flush():
            nonlocal f_ref, Tcw, failures, inliers_sum
            if not batch:
                return
            grays = torch.stack([torch.as_tensor(g) for _, g, _ in batch]).to(dev)
            depths = torch.stack([torch.as_tensor(d) for _, _, d in batch]).to(dev)
            outs = []
            for i in range(len(batch)):
                f_cur = self.features(grays[i], depths[i])
                T21, ninl, ok = self.track_pair(f_ref, f_cur)
                outs.append(torch.cat([T21.reshape(16), ninl.to(torch.float32)[None],
                                       ok.to(torch.float32)[None]]))
                f_ref = f_cur
            packed = torch.stack(outs).cpu().numpy()       # one copy per batch
            for (ts, _, _), row in zip(batch, packed):
                if row[17] > 0.5:
                    Tcw = (row[:16].reshape(4, 4) @ Tcw).astype(np.float32)
                    inliers_sum += int(row[16])
                else:
                    failures += 1
                timestamps.append(ts)
                poses.append(np.linalg.inv(Tcw))
            batch.clear()

        for item in frames:
            batch.append(item)
            if len(batch) == self.batch:
                flush()
        flush()

        n_frames = len(timestamps)
        stats = {
            "frames": n_frames,
            "failures": failures,
            "mean_inliers": inliers_sum // max(n_frames - 1, 1),
        }
        return np.asarray(timestamps), np.stack(poses), stats
