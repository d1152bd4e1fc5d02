"""The comparison that decides `correct`, run once the window has closed and
the program's state is freed. What it reads the timed path produced: the
kept sessions' keyframe stores, track extensions, pose graphs and solves
(`observe.py`), and every session's trajectory.

Each number against the limit the cell's `limits/<cell>.json` sets (a
number the limits do not name is logged, not compared):

- `frames_missing`: frames handed in during the window whose pose never came
  back, and frames missing from a session's trajectory (exact: limit 0);
- `feature_mismatch`: slots of keyframes sampled from the seed whose stored
  keypoint, depth, validity, smoothness or descriptor differs from the plain
  reference's build of the same input frame (exact: limit 0);
- `match_mismatch`: slots of the same keyframes whose track extension
  against the keyframe before (the gated 2-NN match and its geometric gate
  under the program's relative pose) differs from the plain matcher's on
  the reference's features of both frames (exact: limit 0);
- `rpe_median_m`: the median relative pose error, against the generator's
  ground truth, of the odometry edges of the kept sessions' pose graphs,
  each the motion RANSAC, GICP and (in the noisy preset) dense ICP
  estimated between two keyframes (the worst edge is logged: a noisy
  sequence can hold one off by metres, see PERF.md);
- `dense_fixpoint_m`: in the noisy preset, the median over odometry edges
  between consecutive frames, sampled from the seed, of how far one step
  of the plain dense ICP at the program's finest level moves the program's
  estimate: a polished estimate is a fixed point, an unpolished one moves
  (the median, since a frame whose estimate failed keeps no polish);
- `solve_gap`: the largest gap between a camera centre the program's
  pose-graph solves gave and the plain solve of the same graph from the
  same poses, over the largest correction those solves made (at least
  0.01 m): a solve that returns its input reads 1;
- `ate_median_m`, `ate_max_m`: the absolute trajectory error of each of the
  window's sessions after `finish()`: their median and the worst session.
"""

from __future__ import annotations

import numpy as np
import torch

from slambench.generate import SAMPLE, derive_seed
from slambench.reference import ate as ref_ate
from slambench.reference import dense_icp as ref_dense
from slambench.reference import features as ref_features
from slambench.reference import geometry as ref_geometry
from slambench.reference import match as ref_match
from slambench.reference import pose_graph as ref_pose_graph

#: keyframes whose features and track extension the reference redoes, a run
FEATURE_SAMPLE = 8
#: frame-to-frame estimates the reference dense ICP starts from, a run
DENSE_SAMPLE = 16
#: Gauss-Newton steps of the dense fixed-point test: one, since projective
#: association by the nearest pixel keeps a converged estimate moving by
#: ~0.1 mm a step, where one step from an unpolished estimate moves it ~2 mm
DENSE_ITERS = 1
#: the correction below which `solve_gap` divides by this instead (m)
SOLVE_FLOOR_M = 0.01


def _frame(ts: float, fps: float) -> int:
    return int(round(ts * fps))


def program_outputs(sessions, seed: int, fps: float) -> dict:
    """Host copies of what the timed path produced, read before its state
    is freed: each session's camera trajectory and the count of frames
    without a pose; of the kept sessions, the stored rows and track
    extensions of keyframes drawn from the seed, the odometry edges, and
    every pose-graph solve."""
    out = {"missing": sum(len(s.t_in) - len(s.t_out) for s in sessions),
           "trajectories": [(s.pool_index, np.rint(s.trajectory[0] * fps).astype(int),
                             s.trajectory[1]) for s in sessions],
           "rows": [], "edges": [], "solves": []}
    kept = [s for s in sessions if s.system is not None]
    for s in kept:
        g, st = s.system.graph, s.system.store
        E = g.n_edges
        for a, b, Z in zip(g.e_a[:E], g.e_b[:E], g.e_Z[:E]):
            if b == a - 1:
                out["edges"].append({"pool": s.pool_index,
                                     "frames": (_frame(st.timestamps[a], fps),
                                                _frame(st.timestamps[b], fps)),
                                     "Z": Z.copy()})
        out["solves"] += s.system.bench_solves
    kfs = [(s, k) for s in kept for k in range(s.system.store.count)]
    rng = np.random.default_rng(derive_seed(seed, SAMPLE))
    picks = sorted(rng.choice(len(kfs), size=min(FEATURE_SAMPLE, len(kfs)), replace=False),
                   key=int) if kfs else []
    for j in picks:
        s, k = kfs[int(j)]
        s.system.hydrate_host()
        st = s.system.store
        row = {"pool": s.pool_index, "frame": _frame(st.timestamps[k], fps),
               "uv": st.uv[k].copy(), "z": st.xyz[k, :, 2].copy(),
               "obs_valid": st.obs_valid[k].copy(), "smooth": st.smooth[k].copy(),
               "desc": st.desc[k].view(np.int32).copy()}
        if k > 0:
            lane = s.system.bench_track[k].astype(np.int64)
            row.update(prev_frame=_frame(st.timestamps[k - 1], fps),
                       track_idx2=lane & 4095, track_ok=lane >= 4096,
                       T21=s.system.bench_t21[k])
        out["rows"].append(row)
    steps = [e for e in out["edges"] if e["frames"][0] - e["frames"][1] == 1]
    if steps:
        pick = rng.choice(len(steps), size=min(DENSE_SAMPLE, len(steps)), replace=False)
        out["dense"] = [steps[int(i)] for i in sorted(pick, key=int)]
    else:
        out["dense"] = []
    return out


def build(pool, pool_index: int, frame: int, config: dict, device, precision: str):
    """The reference's features of one input frame, and its 3-D points."""
    seq = pool[pool_index]
    g = torch.as_tensor(seq.grays[frame], device=device)
    d = torch.as_tensor(seq.depths[frame], device=device)
    s = config["sensor"]
    f = ref_features.build(g, d, s, config["slam_config"]["extractor"],
                           ref_features.PRECISIONS[precision])
    xyz = torch.stack([(f.uv[:, 0] - s["cx"]) / s["fx"] * f.z,
                       (f.uv[:, 1] - s["cy"]) / s["fy"] * f.z, f.z], dim=-1)
    return f, xyz


def _host_row(f) -> dict:
    return {"uv": f.uv.cpu().numpy(), "z": f.z.cpu().numpy(),
            "obs_valid": f.obs_valid.cpu().numpy(), "smooth": f.smooth.cpu().numpy(),
            "desc": f.desc.cpu().numpy()}


def feature_mismatch(rows, built) -> int:
    """Slots that differ in any stored field, over the sampled keyframes."""
    n = 0
    for r, b in zip(rows, built):
        diff = ((r["uv"] != b["uv"]).any(-1) | (r["z"] != b["z"])
                | (r["obs_valid"] != b["obs_valid"]) | (r["smooth"] != b["smooth"])
                | (r["desc"] != b["desc"]).any(-1))
        n += int(diff.sum())
    return n


def track(prev, cur, T21, params: dict, sensor: dict, device):
    """The reference's track extension of `cur` against `prev`, each a
    (features, points) pair, under T21: (matches, gate)."""
    (fp, xp), (fc, xc) = prev, cur
    m = ref_match.match(fp.desc, fp.obs_valid, fc.desc, fc.obs_valid, params["nn_ratio"])
    gate = ref_match.track_gate(xp, xc, fc.uv, m.idx2,
                                torch.as_tensor(T21, device=device), sensor)
    return m, gate


def relative_pose_errors(pool, edges) -> tuple:
    """(translation m, rotation rad) of each edge's measurement against the
    ground-truth motion between its two frames."""
    if not edges:
        return np.zeros(0), np.zeros(0)
    Z = np.stack([e["Z"] for e in edges])
    gt = np.stack([np.linalg.inv(pool[e["pool"]].poses_twc[e["frames"][0]])
                   @ pool[e["pool"]].poses_twc[e["frames"][1]] for e in edges])
    return ref_geometry.relative_error(Z, gt)


def dense_fixpoint(pool, samples, params: dict, sensor: dict, device) -> list:
    """How far (m) the plain dense ICP at the program's finest level moves
    each sampled frame-to-frame estimate."""
    moves = []
    for e in samples:
        seq = pool[e["pool"]]
        fa, fb = e["frames"]
        d_prev = torch.as_tensor(seq.depths[fb], device=device)
        d_cur = torch.as_tensor(seq.depths[fa], device=device)
        Z = torch.as_tensor(e["Z"], device=device)
        T = ref_dense.refine(sensor, d_prev, d_cur, Z, params["dense_levels"][-1], DENSE_ITERS)
        moves.append(float(ref_geometry.relative_error(T.cpu().numpy(), e["Z"])[0]))
    return moves


def solve_gaps(solves) -> tuple:
    """(the largest gap (m) between a camera centre of the program's solves
    and the plain solve's, the largest correction (m) the plain solves
    made)."""
    gap = corr = 0.0
    for s in solves:
        ref = ref_pose_graph.solve(s["Twc"], s["a"], s["b"], s["Z"], s["w"],
                                   s["iterations"], s["huber_delta"], s["lam0"])
        gap = max(gap, float(np.max(np.linalg.norm(s["out"][:, :3, 3] - ref[:, :3, 3],
                                                   axis=-1))))
        corr = max(corr, float(np.max(np.linalg.norm(s["Twc"][:, :3, 3] - ref[:, :3, 3],
                                                     axis=-1))))
    return gap, corr


def session_ates(pool, trajectories) -> tuple:
    """(the ATE (m) of each session's trajectory over the frames it holds,
    the frames its trajectory lacks in all)."""
    ates, lacking = [], 0
    for pool_index, frames, twc in trajectories:
        gt = pool[pool_index].poses_twc
        held = np.isin(np.arange(len(gt)), frames)
        lacking += int((~held).sum())
        order = np.argsort(frames)
        ates.append(ref_ate.ate_rmse(twc[order], gt[np.sort(frames)])
                    if len(frames) >= 3 else float("inf"))
    return ates, lacking


def numbers(pool, outputs, config: dict, params: dict, device, control: str = "") -> tuple:
    """(each number, what the log shows beside them). `params`: the
    configuration's `nn_ratio`, `track_gate_px` and `dense_levels` (empty
    without dense ICP). With `control` (a lower precision), the reference
    computed in it stands in the program's place for the features and the
    track extensions."""
    sensor = config["sensor"]
    rows = outputs["rows"]
    ref = {}

    def built(pool_index, frame, precision="float32"):
        key = (pool_index, frame, precision)
        if key not in ref:
            ref[key] = build(pool, pool_index, frame, config, device, precision)
        return ref[key]

    prog = rows
    if control:
        prog = [dict(r, **_host_row(built(r["pool"], r["frame"], control)[0])) for r in rows]
    n_feat = feature_mismatch(prog, [_host_row(built(r["pool"], r["frame"])[0]) for r in rows])
    n_match = 0
    for r in rows:
        if "T21" not in r:
            continue
        m, gate = track(built(r["pool"], r["prev_frame"]), built(r["pool"], r["frame"]),
                        r["T21"], params, sensor, device)
        if control:
            mc, gc = track(built(r["pool"], r["prev_frame"], control),
                           built(r["pool"], r["frame"], control), r["T21"], params, sensor,
                           device)
            idx2, ok = mc.idx2, mc.valid & (gc.err_m < 0.10) & (
                gc.err_px < params["track_gate_px"]) & (gc.z > 0.05)
        else:
            idx2 = torch.as_tensor(r["track_idx2"], device=device)
            ok = torch.as_tensor(r["track_ok"], device=device)
        n_match += ref_match.track_mismatch(idx2, ok, m, gate, params["track_gate_px"])
    rpe_t, rpe_r = relative_pose_errors(pool, outputs["edges"])
    gap, corr = solve_gaps(outputs["solves"])
    ates, lacking = session_ates(pool, outputs["trajectories"])
    values = {"frames_missing": outputs["missing"] + lacking,
              "feature_mismatch": n_feat, "match_mismatch": n_match,
              "rpe_median_m": float(np.median(rpe_t)) if len(rpe_t) else None,
              "solve_gap": gap / max(corr, SOLVE_FLOOR_M) if outputs["solves"] else None,
              "ate_median_m": float(np.median(ates)) if ates else None,
              "ate_max_m": float(np.max(ates)) if ates else None}
    if params["dense_levels"]:
        moves = dense_fixpoint(pool, outputs["dense"], params, sensor, device)
        values["dense_fixpoint_m"] = float(np.median(moves)) if moves else None
    still = [np.linalg.norm((np.linalg.inv(pool[e["pool"]].poses_twc[e["frames"][0]])
                             @ pool[e["pool"]].poses_twc[e["frames"][1]])[:3, 3])
             for e in outputs["edges"]]
    log = {"ates": ates, "edges": len(rpe_t),
           "rpe_max_m": float(np.max(rpe_t)) if len(rpe_t) else None,
           "rpe_unchanged_median_m": float(np.median(still)) if still else None,
           "rpe_max_deg": float(np.degrees(np.max(rpe_r))) if len(rpe_r) else None,
           "solves": len(outputs["solves"]), "solve_gap_m": gap, "solve_correction_m": corr}
    return values, log


def judge(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}). A number that could not be
    read (None) is not correct, nor is one above its limit."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name)
        checks[name] = {"value": v, "limit": limit["limit"]}
        if v is None or not v <= limit["limit"]:
            ok = False
    return ok, checks
