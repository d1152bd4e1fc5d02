"""Cross-session map merging through a Sim(3) pose graph (port of
rgbdslam_tpu/mapping/merge.py).

Two SLAM sessions over the same space are merged into one metric map. The
Sim(3) graph recovers a depth-factor miscalibration: each dataset hardcodes
its depth scale (TUM freiburg2 is 5208, not 5000; IO/DatasetTUM.cpp:61-89),
and a session read with the wrong factor gives a map uniformly mis-scaled by
alpha. A rigid merge cannot reconcile the overlap; the Sim(3) merge recovers
alpha as the second session's vertex scale.

Pipeline (the loop-closure path, across sessions):
1. candidate keyframe pairs by BoW score between the sessions' databases
   (both sessions share a vocabulary), a dense L1 on the host, as in the
   JAX package;
2. geometric verification on the sessions' device: descriptor matching
   (kernel K2 and the gate kernel on the card) and a batched Sim(3) RANSAC
   (scale-aware Umeyama hypotheses, euclidean inlier test); one host read
   a pair;
3. one joint Sim(3) pose graph on the device: both sessions' edges (SE(3)
   lifted at scale 1, self-consistent within a session whatever its scale)
   and the verified inter-session Sim(3) edges; session A's vertex 0 is the
   gauge, vertices and edges padded to powers of two as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from rgbdslam_tpu_torch.device import upload
from rgbdslam_tpu_torch.frontend.matcher import match_descriptors
from rgbdslam_tpu_torch.geometry import sim3
from rgbdslam_tpu_torch.solvers.kabsch import weighted_similarity_transform
from rgbdslam_tpu_torch.solvers.pose_graph import (PoseGraph, PoseGraphEdges,
                                                   optimize_sim3_graph)
from rgbdslam_tpu_torch.solvers.ransac_se3 import draw_valid


def sim3_ransac(
    p1: torch.Tensor,
    p2: torch.Tensor,
    valid: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    num_hypotheses: int = 128,
    sample_size: int = 4,
    inlier_m: float = 0.08,
    refine_iters: int = 3,
    draws: Optional[torch.Tensor] = None,
):
    """Batched Sim(3) RANSAC: find S21 with p2 ~= s R p1 + t.

    `ransac_se3`'s architecture (batched hypotheses, masked refits) with the
    scale-aware Umeyama model and a euclidean inlier test (the Mahalanobis
    whitening is ill-posed until s is known). The (H, S) sample indices come
    from `generator` on the points' device, uniform over the valid slots,
    or are injected as `draws`. Returns device tensors (S21 (4, 4),
    n_inliers (), success ()); no host read."""
    if draws is None:
        if generator is None:
            raise ValueError("sim3_ransac needs a generator or injected draws")
        draws = draw_valid(valid, num_hypotheses, sample_size, generator)
    idx = draws.to(torch.int64)
    ones = torch.ones(idx.shape, dtype=p1.dtype, device=p1.device)
    S_h = weighted_similarity_transform(p1[idx], p2[idx], ones)      # (H, 4, 4)

    def inliers_of(S):
        pred = p1 @ S[..., :3, :3].transpose(-1, -2) + S[..., None, :3, 3]
        err = torch.linalg.norm(pred - p2, dim=-1)
        return (err < inlier_m) & valid

    scores = torch.sum(inliers_of(S_h), dim=-1)                      # (H,)
    # the winner by index_select: indexing by a zero-dimensional tensor
    # reads it back to the host
    S = S_h.index_select(0, torch.argmax(scores).reshape(1))[0]      # first on ties
    for _ in range(refine_iters):
        S = weighted_similarity_transform(p1, p2, inliers_of(S).to(p1.dtype))
    n_inl = torch.sum(inliers_of(S))
    return S, n_inl, n_inl >= sample_size


@dataclasses.dataclass
class MergeResult:
    Twc: np.ndarray          # (Ka+Kb, 4, 4) merged metric SE(3) poses
    scales: np.ndarray       # (Ka+Kb,) per-vertex Sim(3) scale (A ~= 1;
    #                          B ~= 1/alpha for a session mis-scaled by alpha)
    pairs: List[Tuple[int, int]]   # verified (kf_a, kf_b) anchor pairs
    inliers: List[int]
    tried: int = 0           # candidate pairs matched and verified
    ms: Dict[str, float] = dataclasses.field(default_factory=dict)
    #                          host wall ms of "bow", "verify" and "lm", each
    #                          ending in a host read


def _words(d: np.ndarray) -> np.ndarray:
    """Host descriptor rows as the matcher takes them (uint32 words as
    int32 bit patterns; float descriptors unchanged)."""
    return np.ascontiguousarray(d).view(np.int32) if d.dtype == np.uint32 else d


def merge_maps(
    sys_a,
    sys_b,
    max_pairs: int = 3,
    min_inliers: int = 20,
    iterations: int = 12,
    information: float = 100.0,
    seed: int = 0,
) -> MergeResult:
    """Merge session B's map into session A's metric frame, on session A's
    device (the card unless A was built for the CPU).

    Both systems must have BoW databases of the same width (a shared
    vocabulary). Raises ValueError when no inter-session pair verifies. The
    RANSAC draws come from a generator seeded with `seed`."""
    for s in (sys_a, sys_b):
        if hasattr(s, "hydrate_host"):
            s.hydrate_host()     # slim-blob mode defers host desc/BoW rows
    device = sys_a.device
    ms = {}
    t0 = time.perf_counter()
    Ka, Kb = sys_a.store.count, sys_b.store.count
    dba = sys_a.loop_detector.bow_db[:Ka]
    dbb = sys_b.loop_detector.bow_db[:Kb]
    if dba.shape[1] != dbb.shape[1]:
        raise ValueError("sessions use different vocabularies")

    # 1. cross-session BoW scores (L1 similarity, loop/bow.py convention)
    scores = 1.0 - 0.5 * np.abs(dba[:, None, :] - dbb[None, :, :]).sum(-1)
    order = np.argsort(-scores, axis=None)
    pairs: List[Tuple[int, int]] = []
    used_a, used_b = set(), set()
    for flat in order:
        ia, ib = int(flat // Kb), int(flat % Kb)
        if ia in used_a or ib in used_b:
            continue
        pairs.append((ia, ib))
        used_a.add(ia)
        used_b.add(ib)
        if len(pairs) >= max_pairs:
            break
    t1 = time.perf_counter()
    ms["bow"] = 1000 * (t1 - t0)

    # 2. geometric verification with Sim(3) RANSAC, one host read a pair
    gen = torch.Generator(device=device).manual_seed(seed)
    verified: List[Tuple[int, int, np.ndarray]] = []
    inl_counts: List[int] = []
    for ka, kb in pairs:
        da, xa, va = (upload(_words(x), device) for x in sys_a.store.features_of(ka))
        db, xb, vb = (upload(_words(x), device) for x in sys_b.store.features_of(kb))
        m = match_descriptors(da, va, db, vb)
        j = m.idx2.long()
        S21, n_inl, ok = sim3_ransac(xa, xb[j], m.valid & vb[j], gen)
        got = torch.cat([n_inl.reshape(1).to(S21.dtype), ok.reshape(1).to(S21.dtype),
                         S21.reshape(16)]).cpu().numpy()
        n_inl = int(got[0])
        if bool(got[1]) and n_inl >= min_inliers:
            verified.append((ka, kb, got[2:].reshape(4, 4)))
            inl_counts.append(n_inl)
    t2 = time.perf_counter()
    ms["verify"] = 1000 * (t2 - t1)
    if not verified:
        raise ValueError("no inter-session pair verified")

    # 3. joint Sim(3) graph. Vertices: A's keyframes, then B's (index + Ka).
    #    The inter-session measurement of edge (a = ka, b = Ka + kb) maps
    #    b-camera coordinates into a-camera ones (the SE(3) graph's
    #    Z = T_{a<-b}): Z = S21^-1, since RANSAC fit p_b ~= S21 p_a.
    def inv_sim3(S):
        return sim3.inverse(torch.from_numpy(np.asarray(S, np.float32))).numpy()

    K = Ka + Kb
    Swc = np.zeros((K, 4, 4), np.float32)
    for i in range(Ka):
        Swc[i] = np.linalg.inv(sys_a.store.poses_cw[i])
    ka0, kb0, S0 = verified[0]
    # S_AB carries B-frame coordinates into A's metric world; it seeds
    # every B vertex
    S_AB = (np.linalg.inv(sys_a.store.poses_cw[ka0]) @ inv_sim3(S0)
            @ sys_b.store.poses_cw[kb0]).astype(np.float32)
    for j in range(Kb):
        Swc[Ka + j] = S_AB @ np.linalg.inv(sys_b.store.poses_cw[j])

    ea, eb, eZ, ew = [], [], [], []
    for g, off in ((sys_a.graph, 0), (sys_b.graph, Ka)):
        for e in range(g.n_edges):
            ea.append(off + int(g.e_a[e]))
            eb.append(off + int(g.e_b[e]))
            eZ.append(g.e_Z[e])          # SE(3) lifted to Sim(3) at scale 1
            ew.append(float(g.e_w[e]))
    for ka, kb, S21 in verified:
        ea.append(ka)
        eb.append(Ka + kb)
        eZ.append(inv_sim3(S21))
        ew.append(information)

    E = len(ea)
    Kp, Ep = PoseGraph._pad(K), PoseGraph._pad(E)
    Swc_p = np.tile(np.eye(4, dtype=np.float32), (Kp, 1, 1))
    Swc_p[:K] = Swc
    Z = np.concatenate([np.stack(eZ).astype(np.float32),
                        np.tile(np.eye(4, dtype=np.float32), (Ep - E, 1, 1))])
    fixed = np.zeros((Kp,), bool)
    fixed[0] = True
    fixed[K:] = True
    # everything the solve needs in one upload
    blob = upload(np.concatenate([
        Swc_p.ravel(), Z.ravel(), np.pad(np.asarray(ew, np.float32), (0, Ep - E)),
        np.pad(np.asarray(ea, np.float32), (0, Ep - E)),
        np.pad(np.asarray(eb, np.float32), (0, Ep - E)),
        fixed.astype(np.float32)]), device)
    o = 16 * Kp
    edges = PoseGraphEdges(
        a=blob[o + 17 * Ep:o + 18 * Ep].to(torch.int64),
        b=blob[o + 18 * Ep:o + 19 * Ep].to(torch.int64),
        Z=blob[o:o + 16 * Ep].reshape(Ep, 4, 4),
        weight=blob[o + 16 * Ep:o + 17 * Ep])
    S_opt, _cost = optimize_sim3_graph(blob[:o].reshape(Kp, 4, 4), edges,
                                       blob[o + 19 * Ep:] > 0.5, iterations)
    out = torch.cat([S_opt[:K].reshape(-1), sim3.scale_of(S_opt[:K])]).cpu().numpy()
    ms["lm"] = 1000 * (time.perf_counter() - t2)
    S_opt = out[:16 * K].reshape(K, 4, 4)
    scales = out[16 * K:].copy()
    Twc = S_opt.copy()
    Twc[:, :3, :3] /= scales[:, None, None]
    return MergeResult(Twc=Twc, scales=scales,
                       pairs=[(ka, kb) for ka, kb, _ in verified],
                       inliers=inl_counts, tried=len(pairs), ms=ms)
