"""Tracking: the SLAM state machine, orchestrated on the host, computed on the
device (port of rgbdslam_tpu/slam/tracking.py; System/Tracking.{h,cpp}).

The per-frame hot path (feature build, matching, RANSAC, GICP) is enqueued
on the device without the host waiting; the host owns the small
data-dependent control flow (state machine, reference-frame bookkeeping,
keyframe gate) and 4x4 pose composition. Three modes, as in the JAX package:

- serial (`track`): per frame the host reads one packed 20-float result,
  its one synchronisation with the device; a second-reference retry reads
  one more, and so does the dense-ICP polish of a successful estimate;
- ring (`track_pipelined*`): frame i is enqueued against frame i-1's
  features (and depth, for the dense-ICP polish, which runs inside the
  enqueued step) before the host reads frame i-1's row, which comes back in
  one read with the blob of the keyframe the previous completion dispatched;
- batched (`track_batch*`): B frames enqueued back to back (`batch_body`),
  the keyframe gate, the ADAPTIVE threshold and the dense-ICP polish on the
  device, one read of the (B, 22) rows per batch and one of the batch's
  keyframe blobs.

The JAX `lax.scan` and its jitted programs become Python loops that only
enqueue device work.

Pose convention: Tcw (world -> camera), as the reference (Core/Frame.cpp).
VO estimates T21 (ref-camera -> cur-camera) and composes
Tcw_cur = T21 @ Tcw_ref (Solver/SolverSE3.cpp:124-126).
"""

from __future__ import annotations

import enum
import functools
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
from rgbdslam_tpu_torch.solvers.dense_icp import dense_icp
from rgbdslam_tpu_torch.solvers.icp import gicp_refine
from rgbdslam_tpu_torch.solvers.ransac_se3 import check_model, ransac_se3
from rgbdslam_tpu_torch.utils.profiling import SPANS, spanned


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


def check_system_config(cfg: SlamConfig, cam: Camera, device: torch.device) -> None:
    """Refuse, when a system is built, what would fail on its first frame:
    a reprojection error model (no SLAM caller passes RANSAC a camera, as in
    the JAX package, which raises there). Nothing else is refused, on either
    device: the detection kernels of csrc/detect.cu take any cell size,
    level count and grid that the plain version takes."""
    check_model(cfg.ransac)


@functools.lru_cache()
def _eye4(device: torch.device) -> torch.Tensor:
    """The f32 4x4 identity on `device`, made there once."""
    return torch.eye(4, dtype=torch.float32, device=device)


def keyframe_gate(T21: torch.Tensor, success: torch.Tensor, D: torch.Tensor, kf_cfg):
    """The batched scan's keyframe gate on the device (JAX
    tracking.py:200-208). D = Tcw_cur Twc_kf is the motion accumulated since
    the last keyframe; a failed frame adds none. A keyframe is flagged when
    the frame succeeded and the accumulated motion exceeds
    `min_translation` or `min_rotation` (System/Tracking.cpp:213-225); D
    then restarts from the identity. Returns (kf () bool, D_out (4, 4))."""
    eye = _eye4(D.device)
    D_new = torch.where(success, T21, eye) @ D
    tn = torch.linalg.norm(D_new[:3, 3])
    rn = torch.arccos(torch.clamp(0.5 * (torch.trace(D_new[:3, :3]) - 1.0), -1.0, 1.0))
    kf = success & ((tn > kf_cfg.min_translation) | (rn > kf_cfg.min_rotation))
    return kf, torch.where(kf, eye, D_new)


def dense_polish(cam: Camera, cfg: SlamConfig, est: torch.Tensor, d_prev: torch.Tensor,
                 depth: torch.Tensor) -> torch.Tensor:
    """The dense projective ICP polish of a packed estimate row against the
    previous frame's depth, kept where the estimate succeeded (JAX
    tracking.py:143-148, 209-217), on the device. Returns the row with its
    T21 replaced."""
    T21 = est[:16].reshape(4, 4)
    T_d = dense_icp(cam, d_prev, depth, T21, levels=cfg.dense_icp_levels,
                    max_correction=(0.1, 0.1))
    T21 = torch.where(est[16] > 0.5, T_d, T21)
    return torch.cat([T21.reshape(16), est[16:]])


def batch_body(ex: Extractor, cfg: SlamConfig, f_prev: FrameFeatures, D: torch.Tensor,
               d_prev: torch.Tensor, thr: torch.Tensor, gray: torch.Tensor,
               depth: torch.Tensor, generator: Optional[torch.Generator] = None):
    """One frame of the batched scan (JAX `_batch_body`, tracking.py:186-226),
    all enqueued on the device and nothing read back: the feature build at
    the carried threshold `thr` (0-dim f32), the fused estimate against
    `f_prev`, with `cfg.use_dense_icp` its dense polish against the previous
    depth `d_prev`, the keyframe gate on the accumulated motion D, and the
    ADAPTIVE x0.7 / x1.3 update of the threshold from this frame's keypoint
    count. Returns the next carry (f_cur, D, depth, thr) and the frame's
    (22,) f32 row [T21 (16) | success | rmse | inliers | kf | n_valid | thr]."""
    with SPANS.span("tracker.build"):
        f_cur = ex.build(gray, depth, thr)
    with SPANS.span("tracker.estimate"):
        est = fused_estimate(f_prev, f_cur, cfg, generator)
    if cfg.use_dense_icp:
        with SPANS.span("tracker.polish"):
            est = dense_polish(ex.cam, cfg, est, d_prev, depth)
    kf, D_out = keyframe_gate(est[:16].reshape(4, 4), est[16] > 0.5, D, cfg.keyframe)
    n_valid = torch.sum(f_cur.valid).to(torch.float32)
    thr_new = ex.adapt_on_device(thr, n_valid)
    row = torch.cat([est, torch.stack([kf.to(torch.float32), n_valid, thr_new])])
    return f_cur, D_out, depth, thr_new, row


class Tracker:
    """Frame-to-frame visual odometry + keyframe selection.

    The backend (pose graph / loop closure) subscribes through
    `on_keyframe` (serial mode) or the pair `on_keyframe_dispatch` /
    `on_keyframe_complete` (ring and batched modes: the keyframe's device
    work is enqueued at once and its blob completed after a later read);
    after a global optimization it calls `apply_correction`, the functional
    equivalent of the reference's cross-thread Tracking::correct callback
    (System/Tracking.cpp:165-193).
    """

    def __init__(self, cam: Camera, cfg: SlamConfig = SlamConfig(), seed: int = 0,
                 device="cuda"):
        self.cam = cam
        self.cfg = cfg
        self.device = resolve_device(device)
        check_system_config(cfg, cam, self.device)
        self.state = TrackerState.NOT_INITIALIZED
        self.stats = TrackStats()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        # reference frames (mpRefFrame.first / .second, System/Tracking.cpp:59-60)
        self.ref_frame: Optional[FrameFeatures] = None
        self.ref2_frame: Optional[FrameFeatures] = None
        self.ref_Tcw = np.eye(4, dtype=np.float32)
        self.ref2_Tcw = np.eye(4, dtype=np.float32)
        # the depth of the reference frame and of the frame being tracked,
        # for the dense-ICP polish (serial: kept only when it is on)
        self.ref_depth: Optional[torch.Tensor] = None
        self._cur_depth: Optional[torch.Tensor] = None
        # the extractor carries the ADAPTIVE threshold state
        self._extractor = Extractor(cam, cfg.extractor, detector=cfg.detector,
                                    adaptive=cfg.adaptive)

        # keyframes: host registry (features + poses)
        self.keyframes: List[Tuple[float, FrameFeatures, np.ndarray]] = []
        self.last_kf_Tcw = np.eye(4, dtype=np.float32)
        self.trajectory: List[TrackedFrame] = []
        self.velocity = np.eye(4, dtype=np.float32)  # motion model (Tracking.cpp:54)
        self.on_keyframe = None  # callback(kf_index, timestamp, features, Tcw)
        # ring and batched modes: dispatch(kf_index, timestamp, features, Tcw,
        # feats_batch=None, batch_row=0) -> handle with a device "blob";
        # complete(handle, blob as a host array)
        self.on_keyframe_dispatch = None
        self.on_keyframe_complete = None
        # LOST-state relocalization hook, installed by SlamSystem:
        # callback(FrameFeatures) -> (ok, Tcw). With it, `lost_after`
        # consecutive failures enter LOST and the frame is re-localized
        # against the BoW keyframe database.
        self.relocalize_fn = None
        self.consecutive_failures = 0
        self._last_inliers = 0
        # batched mode: the scan carry (features, accumulated motion D since
        # the last keyframe, depth, FAST threshold), all on the device and chained
        # from one dispatch to the next, so batch i+1 can be enqueued before
        # batch i is completed. None: rebuild it from the host state.
        self._batch_carry = None
        # ring mode: the enqueued frame whose row is not read yet, the
        # keyframe handle whose blob rides the next read, and a generator for
        # the second-reference retry (set to the snapshot taken after the
        # frame's own draws)
        self._pipe = None
        self._pipe_kf_pending = None
        self._retry_generator = None

    # ------------------------------------------------------------------
    def _estimate(self, ref: FrameFeatures, cur: FrameFeatures) -> torch.Tensor:
        """Match + RANSAC + GICP against an arbitrary reference (the ref2
        retry path); returns the packed device row."""
        self.stats.estimates += 1
        with SPANS.span("tracker.estimate"):
            return fused_estimate(ref, cur, self.cfg, self.generator)

    @spanned("tracker.enqueue")
    def _step(self, ref: FrameFeatures, gray: torch.Tensor, depth: torch.Tensor,
              threshold: float, d_prev: Optional[torch.Tensor] = None):
        """One frame's device work: feature build and the fused estimate
        against `ref`, polished by dense ICP against `d_prev` when that is
        given (the ring). Returns (features, packed (20,)): the estimate's 19
        values and the count of detected keypoints (the ADAPTIVE feedback
        reads it from the same copy)."""
        with SPANS.span("tracker.build"):
            cur = self._extractor.build(gray, depth, threshold)
        self.stats.estimates += 1
        with SPANS.span("tracker.estimate"):
            packed = fused_estimate(ref, cur, self.cfg, self.generator)
        if d_prev is not None:
            with SPANS.span("tracker.polish"):
                packed = dense_polish(self.cam, self.cfg, packed, d_prev, depth)
        return cur, torch.cat([packed, torch.sum(cur.valid).to(torch.float32)[None]])

    # ------------------------------------------------------------------
    @spanned("tracker.track")
    def track(self, timestamp: float, gray, depth) -> np.ndarray:
        """Process one frame; returns Tcw (Tracking::track,
        System/Tracking.cpp:39-75). gray, depth: (H, W) f32 tensors or host
        arrays."""
        if self._pipe is not None:
            self.track_pipelined_flush()         # a switch of mode drains the ring
        gray = upload(gray, self.device).to(torch.float32)
        depth = upload(depth, self.device).to(torch.float32)
        if self.cfg.use_dense_icp:
            self._cur_depth = depth
        if self.state is TrackerState.NOT_INITIALIZED:
            with SPANS.span("tracker.build"):
                f = self._extractor(gray, depth)
            Tcw = np.eye(4, dtype=np.float32)
            self._initialize(timestamp, f, Tcw)
        else:
            Tcw, f = self._visual_odometry(timestamp, gray, depth)
            Tcw = self._relocalize_if_lost(f, Tcw)

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
    def _initialize(self, timestamp: float, f: FrameFeatures, Tcw: np.ndarray,
                    dispatch: bool = False):
        """First frame: identity pose + first keyframe
        (System/Tracking.cpp:97-119). With `dispatch` the keyframe goes
        through `on_keyframe_dispatch` where one is installed, and its handle
        is returned for the caller to complete."""
        self.ref_frame = f
        self.ref2_frame = f
        self.ref_Tcw = Tcw.copy()
        self.ref2_Tcw = Tcw.copy()
        self.ref_depth = self._cur_depth
        self._last_inliers = 0
        self._batch_carry = None        # a batch re-seeds from the host state
        handle = None
        if dispatch and self.on_keyframe_dispatch is not None:
            handle = self._dispatch_keyframe(timestamp, f, Tcw)
        else:
            self._create_keyframe(timestamp, f, Tcw)
        self.state = TrackerState.OK
        return handle

    @staticmethod
    def _unpack(pk: np.ndarray):
        return (pk[:16].reshape(4, 4), bool(pk[16] > 0.5), float(pk[17]), int(pk[18]))

    def _visual_odometry(self, timestamp: float, gray: torch.Tensor,
                         depth: torch.Tensor):
        """Frame-to-frame VO with the second-reference retry and the GICP
        refinement (System/Tracking.cpp:121-163). All device work of the
        frame is enqueued, then one copy brings back every scalar the host
        branches on."""
        ex, i = self._extractor, len(self.trajectory)
        for _attempt in range(5):
            # VideoDynamicAdaptedFeatureDetector's <= 5 within-frame
            # re-detections (VideoDynamicAdaptedFeatureDetector.cpp:24-44).
            # With the N-slot budget over-detection is harmless, so only
            # the under-detection direction re-runs.
            thr = ex.threshold
            f, packed = self._step(self.ref_frame, gray, depth, thr)
            with SPANS.span("tracker.read", i):
                pk = packed.cpu().numpy()      # the frame's one device read
            n_valid = int(pk[19])
            ex.adapt(n_valid)
            if not (ex.adaptive and n_valid < ex.target_min
                    and ex.threshold < thr - 1e-9):
                break
        ref_Tcw = self.ref_Tcw
        T21_host, success, _rmse, n_inl = self._unpack(pk)
        used_ref2 = False

        if not success and self.ref2_frame is not None:
            # anti-drift hover heuristic (System/Tracking.cpp:136-143)
            with SPANS.span("tracker.retry", i):
                est = self._estimate(self.ref2_frame, f)
                with SPANS.span("tracker.read", i):
                    pk = est.cpu().numpy()
            ref_Tcw = self.ref2_Tcw
            used_ref2 = True
            T21_host, success, _rmse, n_inl = self._unpack(pk)

        if (success and self.cfg.use_dense_icp and not used_ref2
                and self.ref_depth is not None):
            # the dense projective point-to-plane polish of the estimate,
            # from the device copy of its T21 and read back: the frame's one
            # extra read. Skipped after the ref2 retry: only the reference
            # frame's depth is kept, and refining T(ref2 -> cur) against it
            # would converge to T(ref -> cur) and compose it with ref2's pose.
            with SPANS.span("tracker.polish"):
                T_d = dense_icp(self.cam, self.ref_depth, self._cur_depth,
                                packed[:16].reshape(4, 4), levels=self.cfg.dense_icp_levels,
                                max_correction=(0.1, 0.1))
            with SPANS.span("tracker.read", i):
                T21_host = T_d.cpu().numpy()
        Tcw = self._finish_vo(f, T21_host, success, n_inl, ref_Tcw)
        self.ref_depth = self._cur_depth
        self._batch_carry = None        # the serial path moved the references
        return Tcw, f

    def _finish_vo(self, f: FrameFeatures, T21_host: np.ndarray, success: bool,
                   n_inl: int, ref_Tcw: np.ndarray) -> np.ndarray:
        """The host half of a frame's VO (serial and ring): statistics, the
        pose composed from `ref_Tcw` or held, LOST after `lost_after`
        failures, the motion model, the references slid to `f`. Returns
        Tcw."""
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
        return Tcw

    def _relocalize_if_lost(self, f: FrameFeatures, Tcw: np.ndarray) -> np.ndarray:
        """In LOST, re-localize frame `f` against the backend's keyframe
        database (`relocalize_fn`); a recovered pose becomes the live
        reference. Returns the frame's Tcw."""
        if self.state is not TrackerState.LOST or self.relocalize_fn is None:
            return Tcw
        with SPANS.span("tracker.relocalize", len(self.trajectory)):
            ok, Tcw_r = self.relocalize_fn(f)
        if not ok:
            return Tcw
        Tcw = np.asarray(Tcw_r, dtype=np.float32)
        self.state = TrackerState.OK
        self.consecutive_failures = 0
        self.stats.relocalizations += 1
        self.ref_frame, self.ref_Tcw = f, Tcw.copy()
        self.ref2_frame, self.ref2_Tcw = f, Tcw.copy()
        return Tcw

    # ------------------------------------------------------------------
    # Batched mode (JAX tracking.py:377-539): B frames enqueued back to back,
    # one read of their rows per batch. Divergences from the serial path, as
    # in the JAX package: no second-reference retry (a failed frame holds the
    # pose), backend corrections land at batch boundaries, and the ADAPTIVE
    # feedback runs on the device between frames (x0.7 / x1.3 in the carry)
    # instead of the serial path's within-frame re-detection. The first frame
    # of a run goes through the host extractor as in the JAX package: with
    # ADAPTIVE its re-detections read the device, so the run's first dispatch
    # then waits once per detection; every other dispatch reads nothing.
    # ------------------------------------------------------------------
    def track_batch(self, timestamps, grays, depths) -> np.ndarray:
        """Process B frames: `track_batch_dispatch`, then
        `track_batch_complete`. Returns Tcw (B, 4, 4).

        For double buffering call the two phases directly, dispatching batch
        i+1 before completing batch i: the host's bookkeeping of one batch
        then overlaps the device's work on the next (the reference overlaps
        tracking and backend with threads, main.cpp:39-48)."""
        return self.track_batch_complete(
            self.track_batch_dispatch(timestamps, grays, depths))

    @spanned("tracker.dispatch")
    def track_batch_dispatch(self, timestamps, grays, depths) -> dict:
        """Enqueue the batch: the first frame's initialisation when needed
        (its keyframe through `on_keyframe_dispatch`), then `batch_body` for
        each frame, chained on the device from the previous dispatch's carry.
        Reads nothing back. Returns the handle `track_batch_complete` takes."""
        if self._pipe is not None:
            self.track_pipelined_flush()         # a switch of mode drains the ring
        dev, ex = self.device, self._extractor
        B = len(timestamps)
        h = {"timestamps": list(timestamps), "B": B, "start": 0, "init_Tcw": None,
             "init_kf": None, "feats": [], "read": None, "d_fin": None}
        carry = self._batch_carry
        if carry is None:
            # the ADAPTIVE threshold rides the carry, seeded from the host
            thr = torch.full((), ex.threshold, dtype=torch.float32, device=dev)
            if self.state is TrackerState.NOT_INITIALIZED:
                g0 = upload(grays[0], dev).to(torch.float32)
                d0 = upload(depths[0], dev).to(torch.float32)
                with SPANS.span("tracker.build"):
                    if ex.adaptive:
                        # the JAX package's first frame: the host extractor
                        # with its within-frame re-detections (one read per
                        # detection), the carry seeded with the threshold it
                        # leaves
                        f0 = ex(g0, d0)
                        thr = torch.full((), ex.threshold, dtype=torch.float32, device=dev)
                    else:
                        f0 = ex.build(g0, d0, thr)
                Tcw0 = np.eye(4, dtype=np.float32)
                h["init_kf"] = self._initialize(timestamps[0], f0, Tcw0, dispatch=True)
                self.trajectory.append(TrackedFrame(timestamps[0], Tcw0, Tcw0.copy(), 0, 0))
                h["init_Tcw"], h["start"] = Tcw0, 1
            D0 = upload((self.ref_Tcw @ se3.inverse_np(self.last_kf_Tcw)).astype(np.float32),
                        dev)
            # the reference depth seeds the dense-ICP lane of the carry (the
            # batch's first depth where there is none: the frame it
            # initialised with)
            d_ref = (self.ref_depth if self.ref_depth is not None
                     else upload(depths[0], dev).to(torch.float32))
            carry = (self.ref_frame, D0, d_ref, thr)
        f_prev, D, d_prev, thr = carry
        rows = []
        for i in range(h["start"], B):
            f_prev, D, d_prev, thr, row = batch_body(
                ex, self.cfg, f_prev, D, d_prev, thr, upload(grays[i], dev).to(torch.float32),
                upload(depths[i], dev).to(torch.float32), self.generator)
            self.stats.estimates += 1
            # the frames' features stay a list: the backend takes keyframe
            # rows by index on the host, where a stacked copy would cost a
            # concatenation per field and a gather per keyframe
            h["feats"].append(f_prev)
            rows.append(row)
        self._batch_carry = (f_prev, D, d_prev, thr)
        h["d_fin"] = d_prev
        # the batch's one read: its rows, and the blob of keyframe 0 when
        # this batch initialised the run
        parts = ([torch.stack(rows).reshape(-1)] if rows else []) + (
            [h["init_kf"]["blob"]] if h["init_kf"] is not None else [])
        if parts:
            h["read"] = torch.cat(parts) if len(parts) > 1 else parts[0]
        return h

    @spanned("tracker.complete")
    def track_batch_complete(self, h: dict) -> np.ndarray:
        """One read of the batch's rows, then the host bookkeeping of each
        frame (pose compose, failures and relocalization, keyframes through
        `on_keyframe_dispatch`, trajectory), the references slid to the
        batch's last frame, and one stacked read of the blobs of the
        keyframes the batch dispatched. Completions run in dispatch order.
        Returns Tcw (B, 4, 4)."""
        B, start, timestamps = h["B"], h["start"], h["timestamps"]
        n = B - start
        out = np.zeros((B, 4, 4), np.float32)
        if h["init_Tcw"] is not None:
            out[0] = h["init_Tcw"]
        flat = None
        if h["read"] is not None:
            with SPANS.span("tracker.read", len(self.trajectory)):
                flat = h["read"].cpu().numpy()
        if h["init_kf"] is not None:
            self.on_keyframe_complete(h["init_kf"], flat[n * 22:])
        if n == 0:
            return out
        pk = flat[:n * 22].reshape(n, 22)
        feats = h["feats"]
        Tcw = self.ref_Tcw.copy()
        pending = []                             # keyframe handles of this batch
        for i in range(n):
            ts = timestamps[start + i]
            T21, success, _rmse, n_inl = self._unpack(pk[i])
            n_inl = n_inl if success else 0
            self.stats.frames += 1
            self.stats.acum_inliers += n_inl
            self._last_inliers = n_inl
            if success:
                # the polar projection keeps the chained pose on SE(3)
                # (se3.orthonormalize_np)
                Tcw = se3.orthonormalize_np(T21 @ Tcw)
                self.consecutive_failures = 0
                if self.state is TrackerState.LOST:
                    self.state = TrackerState.OK
            else:
                self.stats.failures += 1
                self.consecutive_failures += 1
                if (self.cfg.use_relocalization
                        and self.relocalize_fn is not None
                        and self.consecutive_failures >= self.cfg.lost_after):
                    self.state = TrackerState.LOST
                    with SPANS.span("tracker.relocalize", len(self.trajectory)):
                        ok, Tcw_r = self.relocalize_fn(feats[i])
                    if ok:
                        Tcw = np.asarray(Tcw_r, dtype=np.float32)
                        self.state = TrackerState.OK
                        self.consecutive_failures = 0
                        self.stats.relocalizations += 1
            if pk[i, 19] > 0.5 and self.state is TrackerState.OK and self.keyframes:
                if self.on_keyframe_dispatch is not None:
                    pending.append(self._dispatch_keyframe(ts, feats[i], Tcw,
                                                           feats_batch=feats, batch_row=i))
                else:
                    self._create_keyframe(ts, feats[i], Tcw)
                    Tcw = self.keyframes[-1][2].copy()   # adopt a backend correction
            ref_kf_idx = len(self.keyframes) - 1
            Tcr = Tcw @ se3.inverse_np(self.keyframes[ref_kf_idx][2])
            self.trajectory.append(TrackedFrame(ts, Tcw.copy(), Tcr, ref_kf_idx, n_inl))
            out[start + i] = Tcw
        # slide the references to the batch's last frame
        self.velocity = Tcw @ np.linalg.inv(self.ref_Tcw)
        self.ref2_frame, self.ref2_Tcw = self.ref_frame, self.ref_Tcw
        self.ref_frame, self.ref_Tcw = feats[-1], Tcw.copy()
        self.ref_depth = h["d_fin"]
        if self._extractor.adaptive:
            # the device-evolved threshold, for a carry re-seed or a switch
            # back to serial tracking
            self._extractor.threshold = float(pk[-1, 21])
        if pending:
            with SPANS.span("backend.read"):
                blobs = torch.stack([hk["blob"] for hk in pending]).cpu().numpy()
            for hk, blob in zip(pending, blobs):
                self.on_keyframe_complete(hk, blob)
        return out

    # ------------------------------------------------------------------
    # Ring mode (JAX tracking.py:554-696): serial semantics (host keyframe
    # gate on corrected poses, second-reference retry, relocalization), with
    # one read per frame. Frame i is enqueued against frame i-1's features
    # before the host reads frame i-1's row; a keyframe's backend completes
    # one frame late (its blob rides the next frame's read), and the ADAPTIVE
    # feedback lands one frame late (no within-frame re-detection).
    # ------------------------------------------------------------------
    @spanned("tracker.ring")
    def track_pipelined(self, timestamp: float, gray, depth):
        """Feed frame i into the ring; completes frame i-1 and returns its
        (ts, Tcw), or None when nothing completed yet. Call
        `track_pipelined_flush` after the last frame."""
        if self.state is TrackerState.NOT_INITIALIZED:
            return timestamp, self.track(timestamp, gray, depth)
        self._batch_carry = None
        # the reference: the frame still in the ring, else the last completed
        ref, d_prev = ((self._pipe["f"], self._pipe["d"]) if self._pipe is not None
                       else (self.ref_frame, self.ref_depth))
        depth = upload(depth, self.device).to(torch.float32)
        f, packed = self._step(ref, upload(gray, self.device).to(torch.float32), depth,
                               self._extractor.threshold,
                               d_prev if self.cfg.use_dense_icp else None)
        # the generator's state after this frame's draws: a retry for this
        # frame draws from here, as the serial path's does, although the next
        # frame will have drawn by then
        gen_state = self.generator.get_state()
        out = self._pipe_complete()
        kf_h, self._pipe_kf_pending = self._pipe_kf_pending, None
        read = packed if kf_h is None else torch.cat([packed, kf_h["blob"]])
        self._pipe = {"ts": timestamp, "f": f, "d": depth, "read": read, "kf_h": kf_h,
                      "gen_state": gen_state}
        return out

    @spanned("tracker.flush")
    def track_pipelined_flush(self):
        """Drain the ring: complete the pending frame and the keyframe it
        dispatched. Returns the frame's (ts, Tcw), or None."""
        out = self._pipe_complete()
        h, self._pipe_kf_pending = self._pipe_kf_pending, None
        if h is not None:
            with SPANS.span("backend.read"):
                blob = h["blob"].cpu().numpy()
            self.on_keyframe_complete(h, blob)
        return out

    @spanned("tracker.complete")
    def _pipe_complete(self):
        """Complete the frame in the ring: one read brings its 20 floats and
        the blob of the keyframe the previous completion dispatched; then the
        serial path's bookkeeping (`_visual_odometry` and `track`)."""
        p, self._pipe = self._pipe, None
        if p is None:
            return None
        i = len(self.trajectory)
        with SPANS.span("tracker.read", i):
            pk_all = p["read"].cpu().numpy()
        if p["kf_h"] is not None:
            # the previous keyframe's backend, before this frame's pose is
            # composed, as in the serial order
            self.on_keyframe_complete(p["kf_h"], pk_all[20:])
        ts, f = p["ts"], p["f"]
        T21_host, success, _rmse, n_inl = self._unpack(pk_all[:20])
        self._extractor.adapt(int(pk_all[19]))   # one frame late
        ref_Tcw = self.ref_Tcw
        if not success and self.ref2_frame is not None:
            # anti-drift hover heuristic (System/Tracking.cpp:136-143), with
            # the serial path's draws
            if self._retry_generator is None:
                self._retry_generator = torch.Generator(device=self.device)
            self._retry_generator.set_state(p["gen_state"])
            self.stats.estimates += 1
            with SPANS.span("tracker.retry", i):
                with SPANS.span("tracker.estimate"):
                    est = fused_estimate(self.ref2_frame, f, self.cfg, self._retry_generator)
                with SPANS.span("tracker.read", i):
                    pk2 = est.cpu().numpy()
            T21_host, success, _rmse, n_inl = self._unpack(pk2)
            ref_Tcw = self.ref2_Tcw

        Tcw = self._finish_vo(f, T21_host, success, n_inl, ref_Tcw)
        self.ref_depth = p["d"]
        Tcw = self._relocalize_if_lost(f, Tcw)
        # the host keyframe gate on corrected poses, as in the serial path
        if (self.state is TrackerState.OK and self.keyframes
                and self._need_keyframe(Tcw)):
            if self.on_keyframe_dispatch is not None:
                # its blob rides the next frame's read
                self._pipe_kf_pending = self._dispatch_keyframe(ts, f, Tcw)
            else:
                self._create_keyframe(ts, f, Tcw)
                Tcw = self.keyframes[-1][2].copy()
                self.ref_Tcw = Tcw.copy()
        ref_kf_idx = len(self.keyframes) - 1
        Tcr = Tcw @ se3.inverse_np(self.keyframes[ref_kf_idx][2])
        self.trajectory.append(TrackedFrame(ts, Tcw.copy(), Tcr, ref_kf_idx,
                                            self._last_inliers))
        return ts, Tcw

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

    def _dispatch_keyframe(self, timestamp: float, f: FrameFeatures, Tcw: np.ndarray,
                           **batch) -> dict:
        """Register a keyframe and enqueue its backend step through
        `on_keyframe_dispatch` (`batch`: feats_batch and batch_row, for a
        frame of a batch). Returns the handle to complete."""
        self.keyframes.append((timestamp, f, Tcw.copy()))
        self.last_kf_Tcw = Tcw.copy()
        return self.on_keyframe_dispatch(len(self.keyframes) - 1, timestamp,
                                         None if batch else f, Tcw.copy(), **batch)

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
        keyframe's correction. A batch registers all its keyframes before
        their backend steps complete, so a bundle adjustment completing one
        of them corrects fewer keyframes than are registered: the later
        ones keep their poses, and so do the live references, which hang on
        the last keyframe. (The JAX package indexes past the solved poses
        there and raises, tracking.py:842-845.)"""
        kf_poses = np.asarray(kf_poses)[:len(self.keyframes)]
        K = len(kf_poses)
        old_last = self.keyframes[K - 1][2]
        new_last = kf_poses[K - 1]
        self.keyframes = [
            (ts, f, kf_poses[i].astype(np.float32) if i < K else Tcw)
            for i, (ts, f, Tcw) in enumerate(self.keyframes)
        ]
        self.last_kf_Tcw = self.keyframes[-1][2]
        if relocalize and K == len(self.keyframes):
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
