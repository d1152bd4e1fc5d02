"""Keyframe store: the map's keyframe side as bounded host arrays (numpy
only; the port's own copy of rgbdslam_tpu/mapping/keyframes.py).

Core/Map.{h,cpp} (keyframe half): instead of a mutex-guarded
std::map of Frame pointers (Core/Map.cpp:10-132), keyframes live in
preallocated host arrays (descriptors, 3D points, validity, poses) from which
device batches are sliced for backend work (proximity matching, loop
verification, pose-graph solves). Single-writer host orchestrator — no locks.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from rgbdslam_tpu_torch.frontend.frame import FrameFeatures


class KeyframeStore:
    def __init__(self, max_keyframes: int, num_features: int):
        self.max_keyframes = max_keyframes
        self.n_feat = num_features
        K, N = max_keyframes, num_features
        # binary descriptors: (N, 8) uint32 words
        self.desc = np.zeros((K, N, 8), dtype=np.uint32)
        self.xyz = np.zeros((K, N, 3), dtype=np.float32)
        self.obs_valid = np.zeros((K, N), dtype=bool)
        self.uv = np.zeros((K, N, 2), dtype=np.float32)
        self.intensity = np.zeros((K, N), dtype=np.float32)
        self.smooth = np.zeros((K, N), dtype=bool)   # depth-edge-free obs
        self.poses_cw = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
        self.timestamps = np.zeros((K,), dtype=np.float64)
        self.count = 0

    def add(self, timestamp: float, f: FrameFeatures, Tcw: np.ndarray) -> int:
        """Insert a keyframe; returns its index (Map::addKeyFrame,
        Core/Map.cpp analog). Budget enforcement lives in register().
        One device-to-host copy for the whole feature table."""
        from rgbdslam_tpu_torch.frontend.frame import pack_features_for_host

        packed = pack_features_for_host(f).cpu().numpy()
        return self.add_packed(timestamp, packed, f.desc.shape[1], True, Tcw)

    def add_packed(self, timestamp: float, packed: np.ndarray, nd: int,
                   binary: bool, Tcw: np.ndarray) -> int:
        """Insert from a host copy of pack_features_for_host's (N, nd+8)
        layout (the fused keyframe program delivers it inside its single
        result blob)."""
        k = self.register(timestamp, Tcw)
        self.fill_features(k, packed, nd, binary)
        return k

    def _grow(self) -> None:
        """Double every per-keyframe array. The reference's map grows
        unboundedly (Core/Map.cpp:10-132, std::map); here preallocated
        budgets double on demand so arbitrary-length sequences run."""
        K = self.max_keyframes
        self.max_keyframes = 2 * K

        def ext(a):
            return np.concatenate([a, np.zeros_like(a)], axis=0)

        self.desc = ext(self.desc)
        self.xyz = ext(self.xyz)
        self.obs_valid = ext(self.obs_valid)
        self.uv = ext(self.uv)
        self.intensity = ext(self.intensity)
        self.smooth = ext(self.smooth)
        self.poses_cw = np.concatenate(
            [self.poses_cw, np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))])
        self.timestamps = ext(self.timestamps)

    def register(self, timestamp: float, Tcw: np.ndarray) -> int:
        """Reserve the next keyframe slot with its pose/timestamp only (the
        pipelined backend registers at dispatch so radius searches for
        subsequent keyframes in the same batch see this one; feature rows
        land later via fill_features when the device blob is fetched)."""
        if self.count >= self.max_keyframes:
            self._grow()
        k = self.count
        self.poses_cw[k] = np.asarray(Tcw, dtype=np.float32)
        self.timestamps[k] = timestamp
        self.count += 1
        return k

    def fill_features_slim(self, k: int, packed: np.ndarray, cam) -> None:
        """Fill a keyframe row from the descriptor-free slim pack (N, 4):
        [uv_undist(2) | z(1) | 4*round(intensity) + obs_valid + 2*smooth]
        (frontend/frame.pack_features_slim). xyz is reconstructed with the
        same pinhole unprojection the device used (RGBDcamera::unproject,
        Core/RGBDcamera.cpp:126-161); the descriptor row stays zero until
        SlamSystem.hydrate_host fetches it from the device bank
        (checkpoint/merge only)."""
        uv = packed[:, 0:2]
        z = packed[:, 2]
        flags = packed[:, 3].astype(np.int32)
        self.uv[k] = uv
        self.xyz[k, :, 0] = (uv[:, 0] - cam.cx) / cam.fx * z
        self.xyz[k, :, 1] = (uv[:, 1] - cam.cy) / cam.fy * z
        self.xyz[k, :, 2] = z
        self.intensity[k] = (flags >> 2).astype(np.float32)
        self.obs_valid[k] = (flags & 1) > 0
        self.smooth[k] = (flags & 2) > 0

    def hold_desc_rows(self, rows: np.ndarray) -> None:
        """Reallocate the (empty) descriptor table for the family of `rows`,
        one keyframe's (N, D) host rows: (N, 8) uint32 binary words or
        (N, 128) f32 (SIFT/SURF-class)."""
        if self.desc.shape[2:] != rows.shape[1:] or self.desc.dtype != rows.dtype:
            self.desc = np.zeros((self.max_keyframes,) + rows.shape, dtype=rows.dtype)

    def fill_features(self, k: int, packed: np.ndarray, nd: int,
                      binary: bool) -> None:
        uv = packed[:, 0:2]
        xyz = packed[:, 2:5]
        desc = np.ascontiguousarray(packed[:, 5:5 + nd])
        if binary:
            desc = desc.view(np.uint32)
        intensity = packed[:, 5 + nd]
        obs_valid = packed[:, 6 + nd] > 0.5
        smooth = packed[:, 7 + nd] > 0.5
        if k == 0:
            self.hold_desc_rows(desc)
        self.desc[k] = desc
        self.xyz[k] = xyz
        self.obs_valid[k] = obs_valid
        self.uv[k] = uv
        self.intensity[k] = intensity
        self.smooth[k] = smooth

    # ------------------------------------------------------------------
    def centers(self) -> np.ndarray:
        """Camera centers Ow = -R^T t of the first `count` KFs
        (Frame::getCameraCenter analog)."""
        K = self.count
        R = self.poses_cw[:K, :3, :3]
        t = self.poses_cw[:K, :3, 3]
        return -np.einsum("kji,kj->ki", R, t)

    def nearest(self, k: int, radius: float, max_candidates: int) -> List[int]:
        """Masked brute-force radius search over KF centers — replaces the
        PCL kd-tree (Solver/PoseGraph.cpp:157-184): K is small, O(K) on
        arrays beats building a tree."""
        c = self.centers()
        d = np.linalg.norm(c - c[k], axis=-1)
        d[k] = np.inf
        idx = np.where(d <= radius)[0]
        idx = idx[np.argsort(d[idx])]
        return idx[:max_candidates].tolist()

    def set_poses(self, poses_cw: np.ndarray):
        self.poses_cw[: len(poses_cw)] = poses_cw.astype(np.float32)

    def features_of(self, k: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self.desc[k], self.xyz[k], self.obs_valid[k]
