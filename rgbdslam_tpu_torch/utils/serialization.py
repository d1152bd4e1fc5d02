"""Map checkpoint and resume as one npz file (port of
rgbdslam_tpu/utils/serialization.py).

The reference only declares Map::save/load (Core/Map.h:47-48). The file
layout is the JAX package's: the same keys, dtypes and JSON `meta` /
`connections` bytes, so a map saved by either package loads in the other.
It holds the keyframe store, the pose graph (vertices and edges), the
trajectory bookkeeping and the loop codebook. The tracker's reference frame
is not saved (neither package saves it): a resume restores the map and the
backend, not live tracking.
"""

from __future__ import annotations

import json

import numpy as np

from rgbdslam_tpu_torch.frontend.frame import to_device_rows, to_host_rows


def save_map(path: str, system) -> None:
    """Serialize a SlamSystem's persistent state to one .npz file."""
    # slim-blob mode keeps descriptor and BoW rows on the device bank only
    system.hydrate_host()
    store = system.store
    graph = system.graph
    det = system.loop_detector
    K = store.count
    E = graph.n_edges
    tracker = system.tracker

    meta = {
        "version": 1,
        "num_keyframes": K,
        "num_edges": E,
        "kfs_since_loop": system.kfs_since_loop,
        "loops_closed": system.loops_closed,
        "mean_inliers": tracker.stats.mean_inliers,
        "acum_inliers": tracker.stats.acum_inliers,
        "frames": tracker.stats.frames,
    }
    arrays = dict(
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        kf_desc=store.desc[:K],
        kf_xyz=store.xyz[:K],
        kf_obs_valid=store.obs_valid[:K],
        kf_uv=store.uv[:K],
        kf_intensity=store.intensity[:K],
        kf_poses_cw=store.poses_cw[:K],
        kf_timestamps=store.timestamps[:K],
        edge_a=graph.e_a[:E],
        edge_b=graph.e_b[:E],
        edge_Z=graph.e_Z[:E],
        edge_w=graph.e_w[:E],
        traj_ts=np.asarray([f.timestamp for f in tracker.trajectory]),
        traj_Tcr=np.stack([f.Tcr for f in tracker.trajectory])
        if tracker.trajectory else np.zeros((0, 4, 4), np.float32),
        traj_ref=np.asarray([f.ref_kf_index for f in tracker.trajectory], dtype=np.int32),
        connections=np.frombuffer(
            json.dumps([sorted(c) for c in det._connections]).encode(), dtype=np.uint8),
    )
    if det.words is not None:
        # binary words as uint32 (the JAX package's dtype), float words f32
        arrays["vocab_words"] = to_host_rows(det.words)
        arrays["vocab_idf"] = det.idf.cpu().numpy()
        arrays["bow_db"] = det.bow_db[:K]
    np.savez_compressed(path, **arrays)


def load_map(path: str, system) -> None:
    """Restore state saved by save_map (of either package) into a fresh
    SlamSystem of the same configuration; the codebook goes to the system's
    device and the device keyframe bank is rebuilt from the store."""
    import torch

    from rgbdslam_tpu_torch.slam.tracking import TrackedFrame

    with np.load(path, allow_pickle=False) as data:
        data = {k: data[k] for k in data.files}
    meta = json.loads(bytes(data["meta"]).decode())
    K = meta["num_keyframes"]
    E = meta["num_edges"]

    store = system.store
    kf_desc = data["kf_desc"]
    store.hold_desc_rows(kf_desc[0])
    store.desc[:K] = kf_desc
    store.xyz[:K] = data["kf_xyz"]
    store.obs_valid[:K] = data["kf_obs_valid"]
    store.uv[:K] = data["kf_uv"]
    store.intensity[:K] = data["kf_intensity"]
    store.poses_cw[:K] = data["kf_poses_cw"]
    store.timestamps[:K] = data["kf_timestamps"]
    store.count = K

    graph = system.graph
    graph.e_a[:E] = data["edge_a"]
    graph.e_b[:E] = data["edge_b"]
    graph.e_Z[:E] = data["edge_Z"]
    graph.e_w[:E] = data["edge_w"]
    graph.n_edges = E
    graph.n_vertices = K
    for k in range(K):
        graph.Twc[k] = np.linalg.inv(store.poses_cw[k])
    graph._edge_keys = {(int(a), int(b)) for a, b in zip(graph.e_a[:E], graph.e_b[:E])}

    det = system.loop_detector
    conns = json.loads(bytes(data["connections"]).decode())
    det._connections = [set(c) for c in conns]
    det.count = K
    det._pending = [(store.desc[k].copy(), store.obs_valid[k].copy()) for k in range(K)]
    if "vocab_words" in data:
        det.words = to_device_rows(data["vocab_words"], system.device)
        det.idf = torch.as_tensor(np.asarray(data["vocab_idf"], np.float32),
                                  device=system.device)
        if det.bow_db.shape[1] != det.vocab_width:
            det.bow_db = np.zeros((det.bow_db.shape[0], det.vocab_width), np.float32)
        det.bow_db[:K] = data["bow_db"]

    system.kfs_since_loop = meta["kfs_since_loop"]
    system.loops_closed = meta["loops_closed"]

    tracker = system.tracker
    tracker.stats.acum_inliers = meta["acum_inliers"]
    tracker.stats.frames = meta["frames"]
    tracker.trajectory = [
        TrackedFrame(float(ts), np.eye(4, dtype=np.float32), Tcr, int(ref))
        for ts, Tcr, ref in zip(data["traj_ts"], data["traj_Tcr"], data["traj_ref"])
    ]
    # the host keyframe registry mirrors the store (no tracker-side
    # features; the store is authoritative after a resume)
    tracker.keyframes = [(float(store.timestamps[k]), None, store.poses_cw[k].copy())
                         for k in range(K)]
    if K:
        tracker.last_kf_Tcw = store.poses_cw[K - 1].copy()

    # the backend verifies against the device bank, not the host store
    system.rebuild_bank_from_store()
