"""Tracking: the SLAM state machine, orchestrated on the host, computed on the
device (port of rgbdslam_tpu/slam/tracking.py, the serial per-frame path;
System/Tracking.{h,cpp}).

The per-frame hot path (feature build, matching, RANSAC, GICP) is enqueued
on the device without the host waiting; the host owns the small
data-dependent control flow (state machine, reference-frame bookkeeping,
keyframe gate) and 4x4 pose composition. Per frame the host reads one
packed 20-float result, which is its one synchronisation with the device;
a second-reference retry reads one more.

Pose convention: Tcw (world -> camera), as the reference (Core/Frame.cpp).
VO estimates T21 (ref-camera -> cur-camera) and composes
Tcw_cur = T21 @ Tcw_ref (Solver/SolverSE3.cpp:124-126).

The batched (`track_batch*`) and ring (`track_pipelined*`) modes of the JAX
package are not yet ported.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from rgbdslam_tpu_torch.config import SlamConfig
from rgbdslam_tpu_torch.device import resolve_device, upload
from rgbdslam_tpu_torch.frontend.extractor import Extractor
from rgbdslam_tpu_torch.frontend.frame import FrameFeatures
from rgbdslam_tpu_torch.frontend.matcher import gather_matched_points, match_frames
from rgbdslam_tpu_torch.geometry import se3
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.solvers.icp import gicp_refine
from rgbdslam_tpu_torch.solvers.ransac_se3 import ransac_se3


class TrackerState(enum.Enum):
    NOT_INITIALIZED = 0   # System/Tracking.h:23-27
    OK = 1
    LOST = 2


@dataclass
class TrackedFrame:
    """Host-side per-frame record (trajectory bookkeeping,
    System/Tracking.cpp:249-256)."""

    timestamp: float
    Tcw: np.ndarray                 # (4, 4)
    Tcr: np.ndarray                 # pose relative to the reference KF
    ref_kf_index: int               # index into the keyframe list
    num_inliers: int = 0


@dataclass
class TrackStats:
    frames: int = 0
    failures: int = 0
    acum_inliers: int = 0
    relocalizations: int = 0
    estimates: int = 0      # match + RANSAC + GICP passes, ref2 retries included

    @property
    def mean_inliers(self) -> int:
        return self.acum_inliers // max(self.frames, 1)


def fused_estimate(ref: FrameFeatures, cur: FrameFeatures, cfg: SlamConfig,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Match + RANSAC + the GICP polish, selected by the rmse trigger with
    a `where` (System/Tracking.cpp:145-151), all enqueued on the device.
    Returns the packed (19,) f32 row [T21 (16) | success | rmse | inliers].
    A GICP that did not converge keeps the RANSAC pose."""
    m = match_frames(ref, cur, cfg.matcher.nn_ratio)
    p1, p2, w, valid = gather_matched_points(ref, cur, m)
    res = ransac_se3(p1, p2, w, valid, generator, cfg.ransac, draws=draws)
    T21 = res.T21
    if cfg.use_icp_refinement:
        T_g, conv, _ = gicp_refine(p1, p2, res.inliers, T21, cfg.icp,
                                   C1=ref.surf_cov, C2=cur.surf_cov[m.idx2.long()])
        use = (res.rmse >= cfg.icp.rmse_trigger) & conv & res.success
        T21 = torch.where(use, T_g, T21)
    return torch.cat([
        T21.reshape(16),
        torch.stack([res.success.to(torch.float32), res.rmse.to(torch.float32),
                     res.num_inliers.to(torch.float32)]),
    ])


def _not_ported(name: str):
    def f(self, *args, **kwargs):
        raise NotImplementedError(f"{name} is not yet ported (serial `track` only)")
    f.__name__ = name
    return f


class Tracker:
    """Frame-to-frame visual odometry + keyframe selection.

    The backend (pose graph / loop closure) subscribes through
    `on_keyframe`; after a global optimization it calls `apply_correction`,
    the functional equivalent of the reference's cross-thread
    Tracking::correct callback (System/Tracking.cpp:165-193).
    """

    def __init__(self, cam: Camera, cfg: SlamConfig = SlamConfig(), seed: int = 0,
                 device="cuda"):
        if cfg.use_dense_icp:
            raise NotImplementedError("use_dense_icp is not yet ported")
        self.cam = cam
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state = TrackerState.NOT_INITIALIZED
        self.stats = TrackStats()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        # reference frames (mpRefFrame.first / .second, System/Tracking.cpp:59-60)
        self.ref_frame: Optional[FrameFeatures] = None
        self.ref2_frame: Optional[FrameFeatures] = None
        self.ref_Tcw = np.eye(4, dtype=np.float32)
        self.ref2_Tcw = np.eye(4, dtype=np.float32)
        # the extractor carries the ADAPTIVE threshold state
        self._extractor = Extractor(cam, cfg.extractor, detector=cfg.detector,
                                    adaptive=cfg.adaptive)

        # keyframes: host registry (features + poses)
        self.keyframes: List[Tuple[float, FrameFeatures, np.ndarray]] = []
        self.last_kf_Tcw = np.eye(4, dtype=np.float32)
        self.trajectory: List[TrackedFrame] = []
        self.velocity = np.eye(4, dtype=np.float32)  # motion model (Tracking.cpp:54)
        self.on_keyframe = None  # callback(kf_index, timestamp, features, Tcw)
        # LOST-state relocalization hook, installed by SlamSystem:
        # callback(FrameFeatures) -> (ok, Tcw). With it, `lost_after`
        # consecutive failures enter LOST and the frame is re-localized
        # against the BoW keyframe database.
        self.relocalize_fn = None
        self.consecutive_failures = 0
        self._last_inliers = 0

    track_batch = _not_ported("track_batch")
    track_batch_dispatch = _not_ported("track_batch_dispatch")
    track_batch_complete = _not_ported("track_batch_complete")
    track_pipelined = _not_ported("track_pipelined")
    track_pipelined_flush = _not_ported("track_pipelined_flush")

    # ------------------------------------------------------------------
    def _estimate(self, ref: FrameFeatures, cur: FrameFeatures) -> torch.Tensor:
        """Match + RANSAC + GICP against an arbitrary reference (the ref2
        retry path); returns the packed device row."""
        self.stats.estimates += 1
        return fused_estimate(ref, cur, self.cfg, self.generator)

    def _step(self, ref: FrameFeatures, gray: torch.Tensor, depth: torch.Tensor,
              threshold: float):
        """One frame's device work: feature build and the fused estimate
        against `ref`. Returns (features, packed (20,)): the estimate's 19
        values and the count of detected keypoints (the ADAPTIVE feedback
        reads it from the same copy)."""
        cur = self._extractor.build(gray, depth, threshold)
        self.stats.estimates += 1
        packed = fused_estimate(ref, cur, self.cfg, self.generator)
        return cur, torch.cat([packed, torch.sum(cur.valid).to(torch.float32)[None]])

    # ------------------------------------------------------------------
    def track(self, timestamp: float, gray, depth) -> np.ndarray:
        """Process one frame; returns Tcw (Tracking::track,
        System/Tracking.cpp:39-75). gray, depth: (H, W) f32 tensors or host
        arrays."""
        gray = upload(gray, self.device).to(torch.float32)
        depth = upload(depth, self.device).to(torch.float32)
        if self.state is TrackerState.NOT_INITIALIZED:
            f = self._extractor(gray, depth)
            Tcw = np.eye(4, dtype=np.float32)
            self._initialize(timestamp, f, Tcw)
        else:
            Tcw, f = self._visual_odometry(timestamp, gray, depth)
            if self.state is TrackerState.LOST and self.relocalize_fn is not None:
                ok, Tcw_r = self.relocalize_fn(f)
                if ok:
                    Tcw = np.asarray(Tcw_r, dtype=np.float32)
                    self.state = TrackerState.OK
                    self.consecutive_failures = 0
                    self.stats.relocalizations += 1
                    # the recovered pose becomes the live reference
                    self.ref_frame, self.ref_Tcw = f, Tcw.copy()
                    self.ref2_frame, self.ref2_Tcw = f, Tcw.copy()

        # keyframe policy + bookkeeping
        if self.state is TrackerState.OK and len(self.keyframes) > 0:
            if self._need_keyframe(Tcw):
                self._create_keyframe(timestamp, f, Tcw)
                # the backend may have corrected keyframe poses inside
                # on_keyframe: adopt the corrected pose for the frame that
                # just became that keyframe
                Tcw = self.keyframes[-1][2].copy()
                self.ref_Tcw = Tcw.copy()

        ref_kf_idx = len(self.keyframes) - 1
        kf_Tcw = self.keyframes[ref_kf_idx][2]
        Tcr = Tcw @ se3.inverse_np(kf_Tcw)  # System/Tracking.cpp:252
        self.trajectory.append(
            TrackedFrame(timestamp, Tcw.copy(), Tcr, ref_kf_idx, self._last_inliers))
        return Tcw

    # ------------------------------------------------------------------
    def _initialize(self, timestamp: float, f: FrameFeatures, Tcw: np.ndarray):
        """First frame: identity pose + first keyframe
        (System/Tracking.cpp:97-119)."""
        self.ref_frame = f
        self.ref2_frame = f
        self.ref_Tcw = Tcw.copy()
        self.ref2_Tcw = Tcw.copy()
        self._last_inliers = 0
        self._create_keyframe(timestamp, f, Tcw)
        self.state = TrackerState.OK

    @staticmethod
    def _unpack(pk: np.ndarray):
        return (pk[:16].reshape(4, 4), bool(pk[16] > 0.5), float(pk[17]), int(pk[18]))

    def _visual_odometry(self, timestamp: float, gray: torch.Tensor,
                         depth: torch.Tensor):
        """Frame-to-frame VO with the second-reference retry and the GICP
        refinement (System/Tracking.cpp:121-163). All device work of the
        frame is enqueued, then one copy brings back every scalar the host
        branches on."""
        ex = self._extractor
        for _attempt in range(5):
            # VideoDynamicAdaptedFeatureDetector's <= 5 within-frame
            # re-detections (VideoDynamicAdaptedFeatureDetector.cpp:24-44).
            # With the N-slot budget over-detection is harmless, so only
            # the under-detection direction re-runs.
            thr = ex.threshold
            f, packed = self._step(self.ref_frame, gray, depth, thr)
            pk = packed.cpu().numpy()          # the frame's one device read
            n_valid = int(pk[19])
            ex.adapt(n_valid)
            if not (ex.adaptive and n_valid < ex.target_min
                    and ex.threshold < thr - 1e-9):
                break
        ref_Tcw = self.ref_Tcw
        T21_host, success, _rmse, n_inl = self._unpack(pk)

        if not success and self.ref2_frame is not None:
            # anti-drift hover heuristic (System/Tracking.cpp:136-143)
            pk = self._estimate(self.ref2_frame, f).cpu().numpy()
            ref_Tcw = self.ref2_Tcw
            T21_host, success, _rmse, n_inl = self._unpack(pk)

        n_inl = int(n_inl) if success else 0
        self._last_inliers = n_inl
        self.stats.frames += 1
        self.stats.acum_inliers += n_inl

        if success:
            # the polar projection keeps the chained pose on SE(3): the
            # closed-form inverse_np mirrors (not inverts) rotation scale
            # drift, which would feed back through apply_correction
            Tcw = se3.orthonormalize_np(np.asarray(T21_host) @ ref_Tcw)
            self.consecutive_failures = 0
            if self.state is TrackerState.LOST:
                self.state = TrackerState.OK
        else:
            # recover(): hold the reference pose (System/Tracking.cpp:195-199)
            self.stats.failures += 1
            Tcw = self.ref_Tcw.copy()
            self.consecutive_failures += 1
            if (self.cfg.use_relocalization
                    and self.relocalize_fn is not None
                    and self.consecutive_failures >= self.cfg.lost_after):
                self.state = TrackerState.LOST

        # motion model, kept for parity with the reference
        # (System/Tracking.cpp:54), which likewise only computes it
        self.velocity = Tcw @ np.linalg.inv(self.ref_Tcw)
        # slide references (System/Tracking.cpp:59-60)
        self.ref2_frame, self.ref2_Tcw = self.ref_frame, self.ref_Tcw
        self.ref_frame, self.ref_Tcw = f, Tcw.copy()
        return Tcw, f

    # ------------------------------------------------------------------
    def _need_keyframe(self, Tcw: np.ndarray) -> bool:
        """> 0.20 m or > 10 deg accumulated motion since the last KF
        (System/Tracking.cpp:213-225)."""
        delta = se3.inverse_np(Tcw) @ self.last_kf_Tcw
        tn = float(np.linalg.norm(delta[:3, 3]))
        c = np.clip(0.5 * (np.trace(delta[:3, :3]) - 1.0), -1.0, 1.0)
        rn = float(np.arccos(c))
        kf_cfg = self.cfg.keyframe
        return tn > kf_cfg.min_translation or rn > kf_cfg.min_rotation

    def _create_keyframe(self, timestamp: float, f: FrameFeatures, Tcw: np.ndarray):
        """Register a keyframe and notify the backend
        (System/Tracking.cpp:227-240)."""
        self.keyframes.append((timestamp, f, Tcw.copy()))
        self.last_kf_Tcw = Tcw.copy()
        if self.on_keyframe is not None:
            self.on_keyframe(len(self.keyframes) - 1, timestamp, f, Tcw.copy())

    # ------------------------------------------------------------------
    def apply_correction(self, kf_poses: np.ndarray, relocalize: bool = True):
        """Pull optimized KF poses back in after a loop closure.

        kf_poses: (K, 4, 4) optimized Tcw for the first K keyframes. The
        reference re-localizes the current frame against the latest
        distinct KF (Tracking::correct, System/Tracking.cpp:165-193); here
        the live reference poses are re-anchored through the last
        keyframe's correction."""
        k = len(self.keyframes)
        kf_poses = np.asarray(kf_poses)[:k]
        old_last = self.keyframes[-1][2]
        new_last = kf_poses[len(self.keyframes) - 1]
        self.keyframes = [
            (ts, f, kf_poses[i].astype(np.float32))
            for i, (ts, f, _) in enumerate(self.keyframes)
        ]
        self.last_kf_Tcw = self.keyframes[-1][2]
        if relocalize:
            # Tcw_ref' = (Tcw_ref @ Tkf_old^-1) @ Tkf_new; the projection is
            # the backstop that breaks the per-closure error feedback
            # (se3.orthonormalize_np)
            self.ref_Tcw = se3.orthonormalize_np(
                self.ref_Tcw @ se3.inverse_np(old_last) @ new_last)
            self.ref2_Tcw = se3.orthonormalize_np(
                self.ref2_Tcw @ se3.inverse_np(old_last) @ new_last)

    # ------------------------------------------------------------------
    def camera_trajectory(self) -> Tuple[np.ndarray, np.ndarray]:
        """Full camera trajectory replayed through the (possibly optimized)
        KF poses, rebased to KF0 (saveCameraTrajectory semantics,
        System/Tracking.cpp:286-317). Returns (timestamps [N], Twc [N, 4, 4])."""
        if not self.trajectory:
            return np.zeros((0,)), np.zeros((0, 4, 4), np.float32)
        Two = se3.inverse_np(self.keyframes[0][2])
        ts, poses = [], []
        for fr in self.trajectory:
            Trw = self.keyframes[fr.ref_kf_index][2] @ Two
            Twc = se3.inverse_np(fr.Tcr @ Trw)
            ts.append(fr.timestamp)
            poses.append(Twc.astype(np.float32))
        return np.asarray(ts), np.stack(poses)

    def keyframe_trajectory(self) -> Tuple[np.ndarray, np.ndarray]:
        """KF trajectory as Twc (saveKeyFrameTrajectory,
        System/Tracking.cpp:270-284)."""
        ts = np.asarray([k[0] for k in self.keyframes])
        poses = se3.inverse_np(np.stack([k[2] for k in self.keyframes])).astype(np.float32)
        return ts, poses
