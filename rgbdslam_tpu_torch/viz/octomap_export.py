"""Occupancy-map export: the octomap-equivalent grid rebuilt from keyframes
(port of rgbdslam_tpu/viz/octomap_export.py).

The reference's viewer thread rebuilds its octomap from the per-KF filtered
clouds whenever the map's big-change epoch advances
(Drawer/MapDrawer.cpp:48-71 -> OctomapDrawer::insertCloud,
Drawer/OctomapDrawer.cpp:38-79), i.e. always from the current (optimized)
keyframe poses. Here the CLI keeps each keyframe's (gray, depth) images,
and every keyframe's cloud (System/Tracking.cpp:234-237 recipe) is
ray-integrated into one dense log-odds grid (mapping/occupancy.py) under
the final poses, one keyframe after another on the device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from rgbdslam_tpu_torch.config import KeyframeConfig
from rgbdslam_tpu_torch.device import upload
from rgbdslam_tpu_torch.geometry import se3
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.mapping.cloud import keyframe_cloud, transform_cloud
from rgbdslam_tpu_torch.mapping.occupancy import OccupancyGrid, insert_cloud, make_grid


def insert_keyframe(grid: OccupancyGrid, cam: Camera, gray, depth, Twc: np.ndarray,
                    kf_cfg: KeyframeConfig, max_points: int) -> OccupancyGrid:
    """One keyframe's cloud, under its camera-to-world pose Twc, into `grid`
    on the grid's device."""
    dev = grid.log_odds.device
    c = keyframe_cloud(
        cam, upload(gray, dev).to(torch.float32), upload(depth, dev).to(torch.float32),
        stride=kf_cfg.cloud_stride, z_min=kf_cfg.cloud_z_min, z_max=kf_cfg.cloud_z_max,
        voxel=kf_cfg.voxel_size, sor_k=kf_cfg.sor_neighbors, sor_std=kf_cfg.sor_std_mul,
        max_points=max_points)
    T = upload(np.asarray(Twc, np.float32), dev)
    return insert_cloud(grid, transform_cloud(c, T), T[:3, 3])


def build_occupancy_from_keyframes(
    cam: Camera,
    kf_images: Dict[int, Tuple[np.ndarray, np.ndarray]],   # k -> (gray, depth)
    poses_cw: np.ndarray,                                   # (>= K, 4, 4) final
    kf_cfg: KeyframeConfig = KeyframeConfig(),
    resolution: float = 0.08,          # OctomapDrawer.cpp:17
    margin: float = 0.5,
    max_points: int = 4096,
    device="cuda",
) -> OccupancyGrid:
    """One occupancy grid from all keyframes under their optimized poses."""
    ks = sorted(kf_images)
    if not ks:
        raise ValueError("no keyframe images retained")
    Twc = se3.inverse_np(np.stack([poses_cw[k] for k in ks])).astype(np.float32)
    centers = Twc[:, :3, 3]
    lo = centers.min(axis=0) - (kf_cfg.cloud_z_max + margin)
    hi = centers.max(axis=0) + (kf_cfg.cloud_z_max + margin)
    grid = make_grid(lo, hi, resolution=resolution, device=device)
    for i, k in enumerate(ks):
        gray, depth = kf_images[k]
        grid = insert_keyframe(grid, cam, gray, depth, Twc[i], kf_cfg, max_points)
    return grid


class IncrementalOccupancyBuilder:
    """Live occupancy maintenance with the reference's two-level semantics:
    per-keyframe cloud insertion, deduplicated by KF id between big changes
    (OctomapDrawer::insertCloud, Drawer/OctomapDrawer.cpp:38-79 keeps
    mInsertedKFs), and a full reset + reinsert when the map's big-change
    epoch advances (MapDrawer.cpp:48-71 + Core/Map.cpp:134-144) or a new
    keyframe centre leaves the grid bounds. The grid's dims grow in 64-cell
    buckets, as in the JAX package, so the same keyframes give the same grid."""

    def __init__(self, resolution: float = 0.08, margin: float = 0.5,
                 bound_slack: float = 1.0, max_points: int = 4096, device="cuda"):
        self.resolution = resolution
        self.margin = margin
        self.bound_slack = bound_slack
        self.max_points = max_points
        self.device = torch.device(device)
        self.grid = None
        self.ids = set()
        self.epoch = -1
        self._lo = self._hi = None

    def update(self, cam: Camera, kf_images, poses_cw: np.ndarray, epoch: int,
               kf_cfg: KeyframeConfig):
        """Insert new keyframes (or rebuild on an epoch advance or a bounds
        overflow). Returns (grid, changed: bool)."""
        ks = sorted(kf_images)
        if not ks:
            return self.grid, False
        Twc = se3.inverse_np(np.stack([poses_cw[k] for k in ks])).astype(np.float32)
        centers = Twc[:, :3, 3]
        reach = kf_cfg.cloud_z_max + self.margin
        lo_need = centers.min(axis=0) - reach
        hi_need = centers.max(axis=0) + reach
        rebuild = (self.grid is None or epoch > self.epoch
                   or np.any(lo_need < self._lo) or np.any(hi_need > self._hi))
        if rebuild:
            self._lo = lo_need - self.bound_slack
            # dims quantized to 64-cell buckets (the JAX package's, there to
            # reuse compiled programs): they decide the grid written out
            span = (hi_need + self.bound_slack) - self._lo
            dims = np.ceil(span / self.resolution / 64.0) * 64.0
            self._hi = self._lo + dims * self.resolution
            self.grid = make_grid(self._lo, self._hi, resolution=self.resolution,
                                  device=self.device)
            self.ids = set()
            self.epoch = epoch
        new = [(i, k) for i, k in enumerate(ks) if k not in self.ids]
        if not new:
            return self.grid, rebuild
        for i, k in new:
            gray, depth = kf_images[k]
            self.grid = insert_keyframe(self.grid, cam, gray, depth, Twc[i], kf_cfg,
                                        self.max_points)
            self.ids.add(k)
        return self.grid, True


class KeyframeImageKeeper:
    """CLI-side retention of keyframe (gray, depth) images for the
    export-time occupancy rebuild (the reference's Frame keeps its images for
    the same purpose, Core/Frame.h:24-216). Bounded by `max_frames`
    (stride-skips beyond it to stay within memory on long runs). Tensors
    are kept by reference, never read back from the device; with
    `materialize` host data is held as numpy arrays."""

    def __init__(self, max_frames: int = 512, materialize: bool = True):
        self.max_frames = max_frames
        self.materialize = materialize
        self.images: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._skip = 1

    def offer(self, k: int, gray, depth) -> None:
        if k % self._skip != 0:
            return
        if len(self.images) >= self.max_frames:
            # thin: keep every other retained keyframe, double the stride
            self.images = {kk: v for kk, v in self.images.items()
                           if kk % (self._skip * 2) == 0}
            self._skip *= 2
            if k % self._skip != 0:
                return
        if self.materialize and not isinstance(gray, torch.Tensor):
            self.images[k] = (np.asarray(gray), np.asarray(depth))
        else:
            self.images[k] = (gray, depth)
