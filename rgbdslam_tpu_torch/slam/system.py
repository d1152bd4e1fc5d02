"""Full SLAM system: tracking + pose-graph backend + loop closure (port of
rgbdslam_tpu/slam/system.py).

The reference's 3-thread runtime (its PoseGraph thread polls a queue,
Solver/PoseGraph.cpp:59-103) is a synchronous backend step invoked per
keyframe. The heavy work (pairwise matching, RANSAC verification, the
Levenberg-Marquardt graph solve, BoW scoring) is enqueued on the device.

Backend step per keyframe (updateGraph semantics, Solver/PoseGraph.cpp:105-126):
  1. add vertex (Twc), odometry edge to the previous KF
     (createEdgeWithReference, info = 100 I, from-state measurement);
  2. proximity edges: radius search over KF centers (0.5 m), candidates
     verified by match (>= 30) + RANSAC before a measured edge is added
     (createLocalEdges, Solver/PoseGraph.cpp:128-184);
  3. loop detection: gated (>= 15 KFs since the last loop), BoW candidates,
     match threshold 0.2 * mean tracking inliers, RANSAC verification
     (detectLoop, Solver/PoseGraph.cpp:245-287);
  4. on a loop: optimize(20), write the corrected poses back into the
     keyframe store and the tracker (Tracking::correct / Frame::correctPose).

With `use_local_ba` a keyframe without device-verified loop candidates
then bundle-adjusts the sliding window of its last `ba_window` keyframes and
their landmarks; with `use_global_ba` a closed loop, and `finish()`, adjust
every keyframe and landmark jointly with the graph's edges (no reference
analog: its backend is pose-graph-only). Each BA solve is enqueued whole and
read back once (poses and landmarks in one copy).

Host-device traffic per keyframe: one pinned upload of the `meta` array
and one copy back of the packed result blob (the layout of the JAX
package's fused keyframe program). The candidate verification is one
batched pass over all C + L candidates (kernels K2 and K3 take the
candidate on a grid axis), never a loop over candidates. The device bank is
updated in place.

The step is split in two (`_kf_dispatch` enqueues, `_kf_complete` does the
host bookkeeping from the blob), so the tracker's ring and batched modes can
read a keyframe's blob together with other results: with the frame's row in
the ring, stacked with the batch's other keyframes in batched mode.

Live export (`live_export = (every_n_keyframes, out_dir)`): every N
keyframes the tracking thread snapshots host state and a worker thread
rewrites map_viewer.html, trajectory.png, overlay.png and, when the
big-change epoch advances (a loop closure) and at the end, octomap.npz. The
worker runs its device work on a CUDA stream of its own, ordered after the
snapshot by an event: taking a snapshot reads nothing from the device
(chip_smoke.py counts the tracking thread's synchronisations with the
worker's jobs held). The worker's host work still competes with the
tracking thread for the interpreter; PERF.md gives what that costs.

`SlamConfig.distributed` with more than one visible device (several
cards, the virtual shards of `device.set_virtual_devices`, or the
processes of a torch.distributed job) puts the live solves on a mesh
(parallel/dist_ba.py): every pose-graph solve is the edge-sharded CG LM and
the global BA the landmark-sharded BA. With one device it runs the plain
path, as the JAX package does.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from rgbdslam_tpu_torch.config import SlamConfig
from rgbdslam_tpu_torch.device import resolve_device, upload
from rgbdslam_tpu_torch.frontend.frame import (FrameFeatures, pack_features_for_host,
                                               pack_features_slim, to_device_rows,
                                               to_host_rows)
from rgbdslam_tpu_torch.frontend.matcher import correspondence_weights, match_descriptors
from rgbdslam_tpu_torch.geometry import se3
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.loop.bow import bow_scores, bow_vector
from rgbdslam_tpu_torch.loop.detector import LoopDetector
from rgbdslam_tpu_torch.mapping.keyframes import KeyframeStore
from rgbdslam_tpu_torch.mapping.landmarks import LandmarkStore
from rgbdslam_tpu_torch.slam.tracking import Tracker
from rgbdslam_tpu_torch.solvers.ba import BAEdges, local_ba
from rgbdslam_tpu_torch.solvers.pose_graph import PoseGraph
from rgbdslam_tpu_torch.solvers.ransac_se3 import ransac_se3

#: the packed track-extension lane carries idx2 + 4096 * ok in one f32
MAX_PACKED_FEATURES = 4096


def verify_bank(D, X, V, idx, desc_k, xyz_k, valid_k, cfg: SlamConfig,
                generator: Optional[torch.Generator] = None, draws=None) -> torch.Tensor:
    """Verify the bank keyframes `idx` (C,) against the current frame: match
    + RANSAC for all C candidates in one batched pass (one launch of each
    kernel whatever C). Returns (C, 19) packed rows
    [T21 (16) | num_inliers | success | n_matches]; T21[c] maps candidate c's
    camera frame into the current frame's. `draws` (C, H, S) injects the
    RANSAC samples."""
    Di, Xi, Vi = D[idx], X[idx], V[idx]                   # (C, N, ...)
    m = match_descriptors(Di, Vi, desc_k, valid_k, cfg.matcher.nn_ratio)
    j = m.idx2.long()
    mvalid = m.valid
    p2 = xyz_k[j]                                         # (C, N, 3)
    w = correspondence_weights(Xi, p2, mvalid)
    res = ransac_se3(Xi, p2, w, mvalid, generator, cfg.ransac, draws=draws)
    return torch.cat(
        [res.T21.reshape(-1, 16),
         torch.stack([res.num_inliers.to(torch.float32),
                      res.success.to(torch.float32),
                      torch.sum(mvalid, dim=-1).to(torch.float32)], dim=1)],
        dim=1)


def extend_tracks(D, X, V, kprev, desc_k, xyz_k, valid_k, uv_k, T21, cam: Camera,
                  cfg: SlamConfig) -> torch.Tensor:
    """Landmark-track extension: match the previous keyframe (bank row
    `kprev`, a device scalar) into the current frame and gate each match
    geometrically. The relative keyframe pose is known, so a correct
    association maps the old 3-D point onto the new one (within 0.10 m) and
    reprojects within `track_gate_px` pixels. Returns (2, N) int32:
    [idx2, ok]."""
    kp = kprev.reshape(1)
    Dp, Xp, Vp = D.index_select(0, kp)[0], X.index_select(0, kp)[0], V.index_select(0, kp)[0]
    m = match_descriptors(Dp, Vp, desc_k, valid_k, cfg.matcher.nn_ratio)
    j = m.idx2.long()
    pred = Xp @ T21[:3, :3].T + T21[:3, 3]
    err = torch.linalg.norm(pred - xyz_k[j], dim=-1)
    z = torch.clamp_min(pred[:, 2], 1e-6)
    u_pred = cam.fx * pred[:, 0] / z + cam.cx
    v_pred = cam.fy * pred[:, 1] / z + cam.cy
    uv_cur = uv_k[j]
    err_px = torch.hypot(u_pred - uv_cur[:, 0], v_pred - uv_cur[:, 1])
    ok = m.valid & (err < 0.10) & (err_px < cfg.track_gate_px) & (pred[:, 2] > 0.05)
    return torch.stack([m.idx2.to(torch.int32), ok.to(torch.int32)])


def kf_core(bank, f: FrameFeatures, meta: torch.Tensor, words, idf, cam: Camera,
            cfg: SlamConfig, bow_on: bool,
            generator: Optional[torch.Generator] = None, draws=None) -> torch.Tensor:
    """All per-keyframe device work, ending in one f32 blob.

    bank: (D (K, N, 8) int32 or (K, N, 128) f32, X (K, N, 3), V (K, N)
    bool, B (K, Vw) f32), updated in place. meta: one (3 + C + 16,) f32 device array
    [k, kprev, n_cands, idx (C), T21.ravel (16)], every host scalar of the
    step in one upload.

    Blob layout (the JAX package's, all f32): with bow_on (a vocabulary is
    live) the slim pack (N, 4) without descriptors, the packed track
    extension (N,) as idx2 + 4096 * ok, (C + L, 19) verification rows for
    the proximity candidates and the BoW loop candidates selected here, the
    L selected loop indices and their validity. Without bow_on the full
    (N, 8 + D) pack and (C, 19) rows, no loop section.

    Loop candidates on the device (obtainCandidates semantics,
    PlaceRecognition/LoopDetector.cpp:28-84): floor = the minimum BoW score
    over the connected set {kprev} + proximity candidates; a candidate beats
    the floor, respects the id interval and is not connected; top L by
    score, the lower index first among equals. Padded proximity rows
    (index 0) and invalid loop slots are verified too and ignored by the
    host."""
    D, X, V, B = bank
    C = cfg.pose_graph.max_proximity_candidates
    L = cfg.loop.max_candidates
    k = meta[0].to(torch.int64)
    kprev = meta[1].to(torch.int64)
    n_cands = meta[2].to(torch.int64)
    idx = meta[3:3 + C].to(torch.int64)
    T21 = meta[3 + C:].reshape(4, 4)
    k1 = k.reshape(1)
    D.index_copy_(0, k1, f.desc[None])
    X.index_copy_(0, k1, f.xyz[None])
    V.index_copy_(0, k1, f.obs_valid[None])
    ps = pack_features_slim(f) if bow_on else pack_features_for_host(f)
    ext = extend_tracks(D, X, V, kprev, f.desc, f.xyz, f.obs_valid, f.uv_undist,
                        T21, cam, cfg)
    # idx2 + 4096 * ok in one f32 lane (exact: < 2^24)
    ext_packed = (ext[0] + MAX_PACKED_FEATURES * ext[1]).to(torch.float32)

    if not bow_on:
        ver = verify_bank(D, X, V, idx, f.desc, f.xyz, f.obs_valid, cfg, generator, draws)
        return torch.cat([ps.reshape(-1), ext_packed, ver.reshape(-1)])

    vec = bow_vector(f.desc, f.obs_valid, words, idf)
    B.index_copy_(0, k1, vec[None])
    scores = bow_scores(vec, B)                               # (Kbank,)
    j_iota = torch.arange(B.shape[0], device=B.device)
    slot_valid = torch.arange(C, device=B.device) < n_cands
    conn = (j_iota == kprev) | torch.any(
        (j_iota[None, :] == idx[:, None]) & slot_valid[:, None], dim=0)
    floor = torch.amin(torch.where(conn, scores, float("inf")))
    cand_ok = ((j_iota < k) & ((k - j_iota) > cfg.loop.id_interval)
               & ~conn & (scores > floor))
    s_masked = torch.where(cand_ok, scores, -1.0)
    # most entries tie at -1: the stable descending sort keeps the lower
    # index first, like jax.lax.top_k
    top_s, top_j = torch.sort(s_masked, descending=True, stable=True)
    top_s, top_j = top_s[:L], top_j[:L]
    loop_valid = top_s > -0.5
    ver = verify_bank(D, X, V, torch.cat([idx, top_j]), f.desc, f.xyz, f.obs_valid,
                      cfg, generator, draws)
    return torch.cat([ps.reshape(-1), ext_packed, ver.reshape(-1),
                      top_j.to(torch.float32), loop_valid.to(torch.float32)])


def kf_core_batched(bank, feats, batch_row: int, meta: torch.Tensor, words, idf,
                    cam: Camera, cfg: SlamConfig, bow_on: bool,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """`kf_core` on frame `batch_row` of a batch's features (JAX
    `_kf_core_batched`, system.py:214-222). The batched tracker keeps a
    batch's features as a list, so taking the row costs no launch."""
    return kf_core(bank, feats[batch_row], meta, words, idf, cam, cfg, bow_on, generator)


def distributed_mesh(cfg: SlamConfig, device: torch.device):
    """The mesh of the distributed backend, as the JAX package takes it
    (JAX system.py:256-264): with `SlamConfig.distributed` and more than
    one device of `device`'s type visible (several cards, the virtual
    shards of device.set_virtual_devices, or the processes of a
    torch.distributed job), a 1-D mesh over all of them; else None, the
    plain path (one device)."""
    from rgbdslam_tpu_torch.device import device_count

    if not cfg.distributed or device_count(device) <= 1:
        return None
    from rgbdslam_tpu_torch.parallel.dist_ba import make_mesh

    return make_mesh(device=device)


class SlamSystem:
    def __init__(self, cam: Camera, cfg: SlamConfig = SlamConfig(), seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        if cfg.extractor.num_features > MAX_PACKED_FEATURES:
            raise ValueError("num_features > 4096 breaks the packed track-extension lane")
        self.cam = cam
        self.cfg = cfg
        kf_cfg = cfg.keyframe
        # the Tracker refuses a configuration the device does not take
        self.tracker = Tracker(cam, cfg, seed=seed, device=self.device)
        self.store = KeyframeStore(kf_cfg.max_keyframes, cfg.extractor.num_features)
        self.graph = PoseGraph(
            kf_cfg.max_keyframes,
            cfg.pose_graph.max_edges,
            information=cfg.pose_graph.edge_information,
            huber_delta=cfg.pose_graph.huber_delta,
            cg_threshold=cfg.pose_graph.cg_vertex_threshold,
            cg_iters=cfg.pose_graph.cg_iters,
            lm_lambda0=cfg.pose_graph.lm_lambda0,
            device=self.device,
        )
        # the distributed backend (SlamConfig.distributed): the live solves
        # ride a 1-D mesh over every visible device, the pose-graph edges
        # sharded in PoseGraph.optimize, the global BA's landmarks in
        # _global_ba
        self._mesh = distributed_mesh(cfg, self.device)
        self.graph.mesh = self._mesh
        self.loop_detector = LoopDetector(cfg.loop, kf_cfg.max_keyframes, seed=seed,
                                          device=self.device)
        self.landmarks = LandmarkStore(cfg.max_landmarks, cfg.max_obs_per_landmark,
                                       cfg.extractor.num_features)
        self.kfs_since_loop = 0
        self.loops_closed = 0
        self.loop_solve_ms = []   # wall ms of each mid-run loop-closure
                                  # optimize(20) (Solver/PoseGraph.cpp:71)
        self.local_ba_ms = []     # wall ms of each local / global BA solve,
        self.global_ba_ms = []    # its read included
        self.last_loop_candidates = 0   # Tracking::loopCandidates analog
        self.reloc_verifications = 0    # candidate verifications run for LOST frames
        self.kf_backend_ms = []   # wall ms of each keyframe's backend step,
                                  # the loop-closure solve included
        # big-change epoch (Map::informNewBigChange, Core/Map.cpp:134-144):
        # bumped after each loop-closure optimization; the live exporter
        # rebuilds the occupancy grid when it advances
        self.map_epoch = 0
        # during-run export: (every_n_keyframes, out_dir[, min_seconds]) ->
        # map_viewer.html + trajectory.png + the latest keyframe's
        # tracked-point overlay.png + (epoch-gated) octomap.npz (the
        # offline analog of the reference's render loop,
        # Drawer/Viewer.cpp:83-136, its live overlay texture
        # Viewer.cpp:122-128 and the big-change octomap rebuild
        # MapDrawer.cpp:48-71)
        self.live_export = None
        self.live_exports_written = 0
        self.live_exports_dropped = 0   # worker-busy skips
        self.live_export_errors = []    # the worker's exceptions, as text
        self._live_q = None
        self._live_stream = None        # the worker's CUDA stream
        self._live_last_t = -1e18       # wall-clock export-floor state
        self._live_final = False        # finish()'s export bypasses the floor
        self._live_occ_epoch = -1       # epoch of the last octomap.npz write
        self._live_occ_builder = None   # the worker's incremental grid
        self._live_keeper = None        # keyframe (gray, depth) references
        self._live_overlay = None       # (gray, uv, valid, track_inlier) of
                                        # the latest keyframe
        self._recent_frames = {}        # ts -> (gray, depth), the last ~40
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 12345)
        # keyframe rows whose descriptors and BoW vectors were not shipped
        # in the slim blob: hydrated from the device bank on demand
        self._lazy_rows = set()
        self.tracker.on_keyframe = self._on_keyframe
        # ring and batched tracking: enqueue a keyframe's device work at
        # once, complete it after a read shared with other results
        self.tracker.on_keyframe_dispatch = self._kf_dispatch
        self.tracker.on_keyframe_complete = self._kf_complete
        if cfg.use_relocalization:
            self.tracker.relocalize_fn = self._relocalize

        # Device-resident keyframe bank: descriptors, 3-D points, validity
        # and BoW vectors stay on the device across the run; backend work
        # gathers candidates from it by index.
        self._bank = None     # (desc [K, N, 8], xyz [K, N, 3], valid [K, N], bow [K, V])
        self._bow_dev = None  # (words, idf) on the device once a codebook exists

    # ------------------------------------------------------------------
    def _remember_frame(self, ts, gray, depth):
        """Live export: keep references (no copy, no read) to the last ~40
        frames, so that a keyframe's own images pair with its features in
        `_kf_complete`, matched by timestamp in every tracking mode."""
        if self.live_export is None:
            return
        self._recent_frames[float(ts)] = (gray, depth)
        if len(self._recent_frames) > 40:
            for t in sorted(self._recent_frames)[:-40]:
                del self._recent_frames[t]

    def track(self, timestamp: float, gray, depth) -> np.ndarray:
        self._remember_frame(timestamp, gray, depth)
        return self.tracker.track(timestamp, gray, depth)

    def track_batch(self, timestamps, grays, depths) -> np.ndarray:
        """B frames enqueued back to back, the keyframe gate on the device,
        one read of their rows; the backend runs per flagged keyframe.
        Returns Tcw (B, 4, 4)."""
        return self.track_batch_complete(self.track_batch_dispatch(timestamps, grays, depths))

    def track_batch_dispatch(self, timestamps, grays, depths) -> dict:
        """Double buffering: dispatch batch i+1 before completing batch i,
        so the host's bookkeeping of one batch overlaps the device's work on
        the next."""
        for ts, g, d in zip(timestamps, grays, depths):
            self._remember_frame(ts, g, d)
        return self.tracker.track_batch_dispatch(timestamps, grays, depths)

    def track_batch_complete(self, h: dict) -> np.ndarray:
        return self.tracker.track_batch_complete(h)

    def track_pipelined(self, timestamp: float, gray, depth):
        """Per-frame tracking through the depth-2 ring: one read per frame,
        a keyframe's backend completing one frame late. Returns the previous
        frame's (ts, Tcw), or None."""
        self._remember_frame(timestamp, gray, depth)
        return self.tracker.track_pipelined(timestamp, gray, depth)

    def track_pipelined_flush(self):
        return self.tracker.track_pipelined_flush()

    def _ensure_bank(self, n_feat: int, desc_shape=None, desc_dtype=torch.int32):
        """The device bank, made at the first keyframe: its descriptor rows
        take the frame's shape and type ((N, 8) int32 words by default, or
        (N, 128) f32 for the float families)."""
        if desc_shape is None:
            desc_shape = (n_feat, 8)
        if self._bank is None:
            K = self.cfg.keyframe.max_keyframes
            dev = self.device
            self._bank = (
                torch.zeros((K,) + tuple(desc_shape), dtype=desc_dtype, device=dev),
                torch.zeros((K, n_feat, 3), dtype=torch.float32, device=dev),
                torch.zeros((K, n_feat), dtype=torch.bool, device=dev),
                # the BoW width follows the detector's codebook (a preloaded
                # vocabulary may differ from LoopConfig.vocab_size)
                torch.zeros((K, self.loop_detector.vocab_width), dtype=torch.float32,
                            device=dev),
            )

    def _bow_table(self, rows: int) -> torch.Tensor:
        """The host BoW table as a (rows, vocab_width) device tensor."""
        ld = self.loop_detector
        B = np.zeros((rows, ld.vocab_width), np.float32)
        n = min(rows, ld.bow_db.shape[0])
        B[:n] = ld.bow_db[:n, : ld.vocab_width]
        return upload(B, self.device)

    def load_vocabulary(self, path: str) -> None:
        """Load a pre-trained vocabulary (the reference's startup load,
        main.cpp:15,32) and sync the device codebook and BoW bank, so the
        next keyframe quantizes on the device at the loaded width."""
        ld = self.loop_detector
        ld.load_vocabulary(path)
        self._bow_dev = (ld.words, ld.idf)
        if self._bank is not None:
            self._bank = self._bank[:3] + (self._bow_table(self._bank[0].shape[0]),)

    def hydrate_host(self):
        """Fetch the deferred descriptor and BoW rows from the device bank
        into the host mirrors (slim-blob mode ships neither). One gather
        and two copies however many keyframes are pending; for the rare
        host consumers, never on the tracking path."""
        if not self._lazy_rows or self._bank is None:
            return
        ks = np.asarray(sorted(self._lazy_rows), np.int64)
        idx = upload(ks, self.device)
        desc_rows = to_host_rows(self._bank[0][idx])
        bow_rows = self._bank[3][idx].cpu().numpy()
        self.store.hold_desc_rows(desc_rows[0])
        ld = self.loop_detector
        w = min(bow_rows.shape[1], ld.bow_db.shape[1])
        for i, k in enumerate(ks):
            self.store.desc[k] = desc_rows[i]
            if k < ld.bow_db.shape[0]:
                ld.bow_db[k, :w] = bow_rows[i, :w]
        self._lazy_rows.clear()

    def rebuild_bank_from_store(self):
        """Re-sync the device bank (descriptors, points, validity, BoW
        vectors) from the host store, as needed after the host arrays were
        restored from elsewhere."""
        if self.store.count == 0:
            return
        ld = self.loop_detector
        self._bank = (
            to_device_rows(self.store.desc, self.device),
            upload(self.store.xyz, self.device),
            upload(self.store.obs_valid, self.device),
            self._bow_table(self.store.max_keyframes),
        )
        if ld.words is not None:
            self._bow_dev = (ld.words, ld.idf)

    # ------------------------------------------------------------------
    def _verify_candidates(self, cands, f: FrameFeatures):
        """Batched match + RANSAC of the bank keyframes `cands` against
        frame `f`: host arrays (T21 (C, 4, 4), ninl, ok, n_matches), one
        device pass and one copy. T21[c] = T_{f<-cand_c}. Padding rows
        (index 0) come back too and are ignored by the callers."""
        C = self.cfg.pose_graph.max_proximity_candidates
        idx = np.zeros((C,), np.int64)
        idx[: len(cands)] = cands
        D, X, V = self._bank[:3]
        rows = verify_bank(D, X, V, upload(idx, self.device), f.desc, f.xyz,
                           f.obs_valid, self.cfg, self.generator)
        return self._verify_decode(rows.cpu().numpy())

    @staticmethod
    def _verify_decode(packed: np.ndarray):
        T = packed[:, :16].reshape(-1, 4, 4)
        ninl = packed[:, 16].astype(np.int32)
        ok = packed[:, 17] > 0.5
        nm = packed[:, 18].astype(np.int32)
        return T, ninl, ok, nm

    def _on_keyframe(self, k: int, timestamp: float, f: FrameFeatures, Tcw: np.ndarray):
        """Backend step per keyframe: one upload, the device work, one copy
        of the blob back; everything after is host numpy and the (rare)
        loop-closure solve."""
        h = self._kf_dispatch(k, timestamp, f, Tcw)
        t0 = time.perf_counter()
        blob = h["blob"].cpu().numpy()
        h["ms"] += (time.perf_counter() - t0) * 1e3
        self._kf_complete(h, blob)

    def _kf_dispatch(self, k: int, timestamp: float, f: Optional[FrameFeatures],
                     Tcw: np.ndarray, feats_batch=None, batch_row: int = 0) -> dict:
        """Register the keyframe's pose (so that a later keyframe of the same
        batch sees it in its radius search and edge checks), compute the
        proximity candidates on the host, and enqueue the device work. No
        copy back. `feats_batch` / `batch_row`: the keyframe is frame
        `batch_row` of a batch's features (`kf_core_batched`), and `f` may be
        None."""
        t0 = time.perf_counter()
        if feats_batch is not None:
            f = feats_batch[batch_row]
        pg_cfg = self.cfg.pose_graph
        N = f.uv.shape[0]
        self._ensure_bank(N, f.desc.shape, f.desc.dtype)
        if k >= self._bank[0].shape[0]:
            # budget doubling of the device bank
            self._bank = tuple(torch.cat([a, torch.zeros_like(a)], dim=0)
                               for a in self._bank)
        bow_on = self._bow_dev is not None

        store_k = self.store.register(timestamp, Tcw)
        vk = self.graph.add_vertex(se3.inverse_np(Tcw))
        if store_k != k or vk != k:
            raise RuntimeError(f"keyframe {k} out of step with the store ({store_k}) "
                               f"or the graph ({vk})")
        connections = set()
        if k > 0:
            # odometry edge (createEdgeWithReference)
            self.graph.add_odometry_edge(k, k - 1)
            connections.add(k - 1)

        # proximity candidates (createLocalEdges' radius search) from the
        # host poses (Solver/PoseGraph.cpp:157-184)
        cands = []
        if k > 0:
            ck = -Tcw[:3, :3].T @ Tcw[:3, 3]
            c_all = self.store.centers()[:k]
            d = np.linalg.norm(c_all - ck, axis=-1)
            order = np.argsort(d)
            cands = [int(j) for j in order
                     if d[j] <= pg_cfg.proximity_radius and j != k - 1
                     and not self.graph.has_edge(k, j)]
            cands = cands[: pg_cfg.max_proximity_candidates]
        C = pg_cfg.max_proximity_candidates
        T21_prev = (Tcw @ se3.inverse_np(self.store.poses_cw[k - 1])
                    if k > 0 else np.eye(4, dtype=np.float32))
        # one host-to-device copy for every scalar the device work needs
        meta = np.zeros((3 + C + 16,), np.float32)
        meta[0] = k
        meta[1] = max(k - 1, 0)
        meta[2] = len(cands)
        meta[3:3 + len(cands)] = cands
        meta[3 + C:] = T21_prev.astype(np.float32).ravel()

        words, idf = self._bow_dev if bow_on else (None, None)
        meta_dev = upload(meta, self.device)
        if feats_batch is not None:
            blob = kf_core_batched(self._bank, feats_batch, batch_row, meta_dev, words, idf,
                                   self.cam, self.cfg, bow_on, self.generator)
        else:
            blob = kf_core(self._bank, f, meta_dev, words, idf, self.cam, self.cfg, bow_on,
                           self.generator)
        return {"k": k, "ts": timestamp, "f": f, "Tcw": Tcw, "cands": cands,
                "connections": connections, "bow_on": bow_on, "N": N,
                "nd": f.desc.shape[-1], "binary": not f.desc.dtype.is_floating_point,
                "blob": blob,
                "ms": (time.perf_counter() - t0) * 1e3}

    def _kf_complete(self, h: dict, blob: np.ndarray):
        """Host bookkeeping from the fetched blob: store rows, proximity
        edges, BoW registration, landmark tracks, loop detection and the
        (rare) solve. Appends the keyframe's backend time, this half and the
        dispatch half summed, to `kf_backend_ms`."""
        t0 = time.perf_counter()
        k, Tcw, cands = h["k"], h["Tcw"], h["cands"]
        connections, bow_on, N = h["connections"], h["bow_on"], h["N"]
        nd = h["nd"]
        pg_cfg = self.cfg.pose_graph
        C = pg_cfg.max_proximity_candidates
        L = self.cfg.loop.max_candidates
        width = 4 if bow_on else nd + 8       # slim pack ships no descriptors
        off = N * width
        ps = blob[:off].reshape(N, width)
        extp = blob[off:off + N]              # idx2 + 4096 * ok, one f32 lane
        off += N
        n_ver = C + L if bow_on else C        # loop rows ride the same blob
        ver = blob[off:off + n_ver * 19].reshape(n_ver, 19)
        off += n_ver * 19
        loop_j = loop_valid = None
        if bow_on:
            loop_j = blob[off:off + L].astype(np.int32)
            loop_valid = blob[off + L:off + 2 * L] > 0.5
            self.store.fill_features_slim(k, ps, self.cam)
            self._lazy_rows.add(k)            # desc + BoW row hydrate on demand
        else:
            self.store.fill_features(k, ps, nd, h["binary"])
        self.kfs_since_loop += 1

        # proximity edges (createLocalEdges)
        T_b, ninl_b, ok_b, nm_b = self._verify_decode(ver)
        for c, j in enumerate(cands):
            if (not ok_b[c] or nm_b[c] < pg_cfg.proximity_min_matches
                    or ninl_b[c] < pg_cfg.proximity_min_matches):
                continue
            # RansacSE3(F1=j, F2=k) yields T with p_k = T p_j = T_{k<-j};
            # edge (a=k, b=j) needs Z = T_{a<-b} in the Twc-vertex
            # convention: Z = X_k^-1 X_j = Tcw_k Twc_j = T_{k<-j}
            # (Solver/PoseGraph.cpp:147-153)
            self.graph.add_edge(k, j, np.asarray(T_b[c]))
            connections.add(j)
            self.loop_detector.connect(k, j)

        # BoW registration: with a codebook the device quantized the vector
        # and keeps it in the bank; before one exists the host accumulates
        # descriptors and trains after `train_after` keyframes
        if bow_on:
            self.loop_detector.add_precomputed(None, connections)
        else:
            self.loop_detector.add(self.store.desc[k], self.store.obs_valid[k],
                                   connections)
            if self.loop_detector.words is not None:
                # codebook just trained: device copies + backfill the bank
                self._bow_dev = (self.loop_detector.words, self.loop_detector.idf)
                self._bank = self._bank[:3] + (
                    self._bow_table(self._bank[0].shape[0]),)

        # landmark-track extension (Landmark::addObservation analog),
        # computed on the device; tracks accept only depth-edge-free
        # observations
        match_idx = match_valid = None
        if k > 0:
            match_idx = extp.astype(np.int32) & (MAX_PACKED_FEATURES - 1)
            match_valid = extp >= float(MAX_PACKED_FEATURES)
        self.landmarks.add_keyframe(
            k, self.store.uv[k], self.store.xyz[k],
            self.store.obs_valid[k] & self.store.smooth[k],
            None if bow_on else self.store.desc[k],
            self.store.intensity[k], Tcw,
            match_idx, match_valid, k - 1 if k > 0 else None,
            kf_centers=self.store.centers(),
        )

        if self.live_export is not None:
            self._live_capture(k, h["ts"], match_valid, N)

        # the loop gate of this keyframe; with device-verified loop
        # candidates the window BA is skipped: if the closure lands, the
        # pose-graph solve and global BA supersede it, and if every
        # candidate fails the host gates, the next keyframe's window covers
        # this one (JAX system.py:717-732)
        loop_gate_open = bow_on and self.kfs_since_loop >= self.cfg.loop.min_kfs_since_loop
        likely_loop = loop_gate_open and bool(np.any(loop_valid))
        if self.cfg.use_local_ba and not likely_loop:
            self._local_ba(k)

        # loop closure (detectLoop, Solver/PoseGraph.cpp:245-287): candidate
        # selection and verification already ran on the device; only the
        # host gates and the solve remain
        loop_found = loop_gate_open and self._close_loop_from_rows(k, loop_j, loop_valid,
                                                                   ver[C:])
        if loop_found:
            self.kfs_since_loop = 0
            if self.cfg.use_global_ba:
                # global BA polishes the pose-graph solution, over every
                # registered keyframe as the pose-graph solve: k itself but
                # in a batch, whose later keyframes (and their odometry
                # edges) are registered before k completes
                self._global_ba(self.graph.n_vertices - 1)
        self.kf_backend_ms.append(h["ms"] + (time.perf_counter() - t0) * 1e3)
        if self.live_export is not None and (k + 1) % self.live_export[0] == 0:
            self._write_live_export()

    def _close_loop_from_rows(self, k: int, loop_j, loop_valid, rows: np.ndarray) -> bool:
        """Host half of detectLoop: apply the inlier and match thresholds
        to the device-verified loop candidates, insert edges, run
        optimize(20) (Solver/PoseGraph.cpp:260-287)."""
        th = max(int(self.tracker.stats.mean_inliers * self.cfg.loop.match_fraction),
                 self.cfg.ransac.min_inliers)
        T_b, ninl_b, ok_b, nm_b = self._verify_decode(rows)
        self.last_loop_candidates = int(loop_valid.sum())
        closed = False
        for c in range(len(loop_j)):
            if not loop_valid[c]:
                continue
            j = int(loop_j[c])
            if self.graph.has_edge(k, j):
                continue
            if not ok_b[c] or nm_b[c] < th or ninl_b[c] < th:
                continue
            self.graph.add_edge(k, j, np.asarray(T_b[c]), kind=3)
            self.loop_detector.connect(k, j)
            closed = True
        if closed:
            t0 = time.perf_counter()
            self._optimize(self.cfg.pose_graph.opt_iters_loop)
            self.loop_solve_ms.append(round((time.perf_counter() - t0) * 1e3, 2))
            self.loops_closed += 1
            self.map_epoch += 1
        return closed

    # ------------------------------------------------------------------
    def _live_capture(self, k: int, ts: float, match_valid, N: int):
        """Pair keyframe k's own images (by timestamp, from the recent-frame
        references) with its features, for the tracked-point overlay and the
        occupancy keeper. No copy of an image, no read of the device."""
        fr = self._recent_frames.get(float(ts))
        if fr is None:
            return
        if self._live_keeper is None:
            from rgbdslam_tpu_torch.viz.octomap_export import KeyframeImageKeeper

            self._live_keeper = KeyframeImageKeeper(max_frames=256, materialize=False)
        self._live_keeper.offer(k, fr[0], fr[1])
        inl = match_valid if match_valid is not None else np.zeros((N,), bool)
        self._live_overlay = (fr[0], self.store.uv[k].copy(), self.store.obs_valid[k].copy(),
                              np.asarray(inl, bool).copy())

    def _write_live_export(self):
        """Snapshot the map for the export worker (the reference's Viewer::run,
        Drawer/Viewer.cpp:83-136): host copies of the landmark cloud, the
        keyframe and camera trajectories, the overlay, the keyframe image
        references and poses, and a CUDA event after which the worker may
        read the images. A wall-clock floor (2 s, or the tuple's third
        element) spaces the exports; a busy worker drops one."""
        _every, out_dir = self.live_export[:2]
        min_dt = self.live_export[2] if len(self.live_export) > 2 else 2.0
        now = time.monotonic()
        if not self._live_final and now - self._live_last_t < min_dt:
            return
        self._live_last_t = now
        K = self.store.count
        pw, inten = self.landmarks.world_points()
        _ts, cam_twc = self.tracker.camera_trajectory()
        snap = {
            "out_dir": out_dir,
            "pw": pw.copy(), "inten": inten.copy(),
            "poses_twc": se3.inverse_np(self.store.poses_cw[:K]) if K else None,
            "cam_twc": cam_twc,
            "overlay": self._live_overlay,
            "epoch": self.map_epoch,
            "final": self._live_final,
            "occ": None,
            "ready": None,
        }
        self._live_overlay = None          # one write per keyframe capture
        if self._live_keeper is not None and self._live_keeper.images:
            # the worker's builder inserts only new keyframes per export and
            # writes the file at epoch boundaries and at the end
            snap["occ"] = (dict(self._live_keeper.images),
                           self.store.poses_cw[:self.store.max_keyframes].copy())
        if self.device.type == "cuda":
            snap["ready"] = torch.cuda.Event()
            snap["ready"].record()
        self._live_enqueue(snap)

    def _live_enqueue(self, snap: dict) -> bool:
        if self._live_q is None:
            self._live_q = queue.Queue(maxsize=1)
            if self.device.type == "cuda":
                self._live_stream = torch.cuda.Stream(device=self.device)

            def worker():
                while True:
                    job = self._live_q.get()
                    try:
                        self._live_write_job(job)
                        self.live_exports_written += 1
                    except Exception as e:  # noqa: BLE001 (the export must not stop tracking)
                        self.live_export_errors.append(f"{type(e).__name__}: {e}")
                    finally:
                        self._live_q.task_done()

            threading.Thread(target=worker, daemon=True).start()
        try:
            self._live_q.put_nowait(snap)
            return True
        except queue.Full:                 # worker busy: drop this export
            self.live_exports_dropped += 1
            return False

    def live_export_flush(self):
        """Block until the export worker has drained its queue."""
        if self._live_q is not None:
            self._live_q.join()

    def _live_write_job(self, snap: dict):
        if self._live_stream is None:
            self._live_files(snap)
            return
        with torch.cuda.stream(self._live_stream):
            self._live_stream.wait_event(snap["ready"])
            self._live_files(snap)

    def _live_files(self, snap: dict):
        """The worker's writes, each to a temporary name renamed into place."""
        from rgbdslam_tpu_torch.viz.export import (draw_tracked_points,
                                                   plot_trajectory_quick, save_html_viewer)

        out_dir = snap["out_dir"]
        html = os.path.join(out_dir, "map_viewer.html")
        # live writes subsample the cloud (15k points) and rasterize the
        # trajectory directly; the full export is the CLI's at the end
        save_html_viewer(html + ".tmp", snap["pw"], snap["inten"], snap["poses_twc"],
                         max_points=15_000)
        os.replace(html + ".tmp", html)
        if len(snap["cam_twc"]):
            png = os.path.join(out_dir, "trajectory.png")
            plot_trajectory_quick(png + ".tmp.png", snap["cam_twc"])
            os.replace(png + ".tmp.png", png)
        if snap["overlay"] is not None:
            from rgbdslam_tpu_torch.io.png import write_png

            g, uv, valid, inl = snap["overlay"]
            g = g.cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
            p = os.path.join(out_dir, "overlay.png")
            write_png(p + ".tmp.png", draw_tracked_points(g, uv, inl, valid))
            os.replace(p + ".tmp.png", p)
        if snap["occ"] is not None:
            from rgbdslam_tpu_torch.mapping.occupancy import save_grid
            from rgbdslam_tpu_torch.viz.octomap_export import IncrementalOccupancyBuilder

            if self._live_occ_builder is None:
                self._live_occ_builder = IncrementalOccupancyBuilder(device=self.device)
            images, poses_cw = snap["occ"]
            b = self._live_occ_builder
            grid, _changed = b.update(self.cam, images, poses_cw, snap["epoch"],
                                      self.cfg.keyframe)
            # the npz write reads the grid back and compresses it: only at
            # epoch boundaries and at the end
            if grid is not None and (b.epoch > self._live_occ_epoch or snap["final"]):
                p = os.path.join(out_dir, "octomap.npz")
                save_grid(p + ".tmp.npz", grid, extra={"epoch": b.epoch},
                          sparse_cap=2_000_000)
                os.replace(p + ".tmp.npz", p)
                self._live_occ_epoch = b.epoch

    def _relocalize(self, f: FrameFeatures):
        """LOST-state global relocalization: BoW retrieval over the
        keyframe database + batched RANSAC verification of the top
        candidates (two device reads). Returns (ok, Tcw) for the tracker."""
        ld = self.loop_detector
        if ld.words is None or ld.count < 1:
            return False, None
        vec = bow_vector(f.desc, f.obs_valid, ld.words, ld.idf)
        if self._bow_dev is not None and self._bank is not None:
            db = self._bank[3]       # the device-resident BoW bank
        else:
            db = upload(ld.bow_db[: ld.count], self.device)
        scores = bow_scores(vec, db).cpu().numpy()[: ld.count]
        n_cand = min(self.cfg.reloc_max_candidates, ld.count)
        # the most recent keyframe is always a candidate: after a short
        # sensor dropout it is by far the likeliest match
        cands = [ld.count - 1]
        cands += [int(j) for j in np.argsort(-scores)[:n_cand] if int(j) != ld.count - 1]
        cands = cands[:n_cand]

        self.reloc_verifications += 1
        T_b, ninl_b, ok_b, _nm_b = self._verify_candidates(cands, f)
        best, best_inl = -1, self.cfg.reloc_min_inliers - 1
        for c in range(len(cands)):
            if ok_b[c] and int(ninl_b[c]) > best_inl:
                best, best_inl = c, int(ninl_b[c])
        if best < 0:
            return False, None
        # T_b = T_{query<-KF}: Tcw_query = T @ Tcw_KF
        Tcw = np.asarray(T_b[best]) @ self.store.poses_cw[cands[best]]
        return True, Tcw.astype(np.float32)

    # ------------------------------------------------------------------
    def _ba_solve(self, problem, fixed: np.ndarray, iterations: int, edges=None,
                  mesh=None):
        """One BA solve on the device and one read of its solution: host
        (Tcw (K, 4, 4), Xw (L, 3)). With a mesh the landmark-sharded BA
        (parallel/dist_ba.py): the landmark blocks sharded, the reduced
        camera system summed over the shards, the edge factors replicated."""
        fixed = upload(fixed, self.device)
        if mesh is not None:
            from rgbdslam_tpu_torch.parallel.dist_ba import (distributed_local_ba,
                                                             shard_landmarks)

            L = problem.Xw.shape[0]
            Tcw, Xw, _cost = distributed_local_ba(
                self.cam, shard_landmarks(problem, mesh), fixed, mesh, iterations,
                edges=edges, edge_huber=self.graph.huber_delta)
            Xw = Xw[:L]
        else:
            Tcw, Xw, _cost = local_ba(self.cam, problem, fixed, iterations,
                                      edges=edges, edge_huber=self.graph.huber_delta)
        K, L = Tcw.shape[0], Xw.shape[0]
        flat = torch.cat([Tcw.reshape(-1), Xw.reshape(-1)]).cpu().numpy()
        return flat[:16 * K].reshape(K, 4, 4), flat[16 * K:].reshape(L, 3)

    def _local_ba(self, k: int):
        """Window BA: the last `ba_window` keyframes and their landmarks,
        the window's first keyframe fixed as the gauge."""
        W = self.cfg.ba_window
        if k + 1 < W:
            return
        t0 = time.perf_counter()
        kf_lo = k - W + 1
        problem, lm_ids, kf_ids = self.landmarks.window_problem(
            kf_lo, k, self.store.poses_cw, device=self.device)
        if len(lm_ids) < 8:
            return
        fixed = np.zeros((W,), bool)
        fixed[0] = True
        Tcw_opt, Xw_opt = self._ba_solve(problem, fixed, self.cfg.ba_iterations)
        self.landmarks.update_from_solution(lm_ids, Xw_opt)
        self.store.poses_cw[kf_lo:k + 1] = Tcw_opt
        for i, kf in enumerate(kf_ids):
            self.graph.Twc[kf] = se3.inverse_np(Tcw_opt[i]).astype(np.float32)
        self.tracker.apply_correction(self.store.poses_cw[:k + 1], relocalize=True)
        self.local_ba_ms.append((time.perf_counter() - t0) * 1e3)

    def global_ba_problem(self, k: int):
        """The full-map BA problem over keyframes 0..k: (problem, lm_ids,
        kf_ids, fixed, edges), or None under 3 keyframes or 8 landmarks.
        The keyframes are padded to a power of two with fixed identity
        poses, the graph's edges (weights x `ba_edge_scale`) to a power of
        two with zero weights, as in the JAX package: the same arrays, so
        the same numbers. Keyframe 0 is the gauge, as the pose graph's
        vertex 0."""
        K = k + 1
        if K < 3:
            return None
        pad_k = 4
        while pad_k < K:
            pad_k *= 2
        problem, lm_ids, kf_ids = self.landmarks.window_problem(
            0, k, self.store.poses_cw, pad_k=pad_k, device=self.device)
        if len(lm_ids) < 8:
            return None
        fixed = np.zeros((pad_k,), bool)
        fixed[0] = True
        fixed[K:] = True          # the padding keyframes must not move
        g = self.graph
        E = g.n_edges
        Ep = 8
        while Ep < max(E, 1):
            Ep *= 2
        eZ = np.tile(np.eye(4, dtype=np.float32), (Ep, 1, 1))
        ew = np.zeros((Ep,), np.float32)
        eab = np.zeros((2, Ep), np.int64)
        eZ[:E] = g.e_Z[:E]
        ew[:E] = g.e_w[:E] * self.cfg.ba_edge_scale
        eab[0, :E] = g.e_a[:E]
        eab[1, :E] = g.e_b[:E]
        eab = upload(eab, self.device)
        edges = BAEdges(a=eab[0], b=eab[1], Z=upload(eZ, self.device),
                        w=upload(ew, self.device))
        return problem, lm_ids, kf_ids, fixed, edges

    def _global_ba(self, k: int):
        """Full-map BA (beyond the reference: its backend is pose-graph-only,
        Solver/PoseGraph.cpp:350-368): every keyframe pose and landmark
        jointly with the graph's edges as relative-pose factors
        (`global_ba_problem`); on a mesh the landmark-sharded BA."""
        K = k + 1
        t0 = time.perf_counter()
        built = self.global_ba_problem(k)
        if built is None:
            return
        problem, lm_ids, kf_ids, fixed, edges = built
        g = self.graph
        Tcw_opt, Xw_opt = self._ba_solve(problem, fixed, self.cfg.global_ba_iterations,
                                         edges, self._mesh)
        Tcw_opt = Tcw_opt[:K]
        self.landmarks.update_from_solution(lm_ids, Xw_opt)
        self.store.poses_cw[:K] = Tcw_opt
        for kf in kf_ids:
            g.Twc[kf] = se3.inverse_np(Tcw_opt[kf]).astype(np.float32)
        self.tracker.apply_correction(self.store.poses_cw[:K], relocalize=True)
        self.global_ba_ms.append((time.perf_counter() - t0) * 1e3)

    # ------------------------------------------------------------------
    def _optimize(self, iterations: int):
        """Global pose-graph optimization + pose write-back
        (PoseGraph::optimize + Frame::correctPose + Tracking::correct)."""
        Twc_opt = self.graph.optimize(iterations)
        K = len(Twc_opt)
        old_poses_cw = self.store.poses_cw[:K].copy()
        Tcw_opt = se3.inverse_np(np.asarray(Twc_opt)).astype(np.float32)
        # move the landmark cloud with its keyframes (Core/Frame.cpp:437-454)
        self.landmarks.reanchor(old_poses_cw, Tcw_opt)
        self.store.set_poses(Tcw_opt)
        self.tracker.apply_correction(Tcw_opt)

    def finish(self):
        """Final optimization (PoseGraph::shutdown,
        Solver/PoseGraph.cpp:407-418)."""
        if self.graph.n_vertices > 5:
            self._optimize(self.cfg.pose_graph.opt_iters_default)
            if self.cfg.use_global_ba:
                self._global_ba(self.graph.n_vertices - 1)
        if self.live_export is not None:
            # the guaranteed final export: drain the worker, snapshot the
            # final state (with any pending occupancy write), drain again
            self.live_export_flush()
            self._live_final = True
            self._write_live_export()
            self._live_final = False
            self.live_export_flush()

    def camera_trajectory(self):
        return self.tracker.camera_trajectory()

    def keyframe_trajectory(self):
        return self.tracker.keyframe_trajectory()
