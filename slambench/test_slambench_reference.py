"""The plain reference against the program on the CPU: the feature build
bit for bit on clean and noisy frames of both scenes, at the cells' 640x480
and at 160x120; the lower-precision controls far from it; the ATE against
the program's own evaluator."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from slambench import scene, tiny
from slambench.reference import ate as ref_ate
from slambench.reference import features as ref

HERE = Path(__file__).resolve().parent
CONFIGS = {"full": json.loads((HERE / "configs" / "kinect_noisy_dense.json").read_text()),
           "tiny": tiny.tiny_config()}


def _program_build(cfg, gray, depth):
    from rgbdslam_tpu_torch.config import ExtractorConfig
    from rgbdslam_tpu_torch.frontend.frame import build_frame_features
    from rgbdslam_tpu_torch.geometry.camera import Camera

    s = cfg["sensor"]
    cam = Camera(s["fx"], s["fy"], s["cx"], s["cy"], width=s["width"], height=s["height"],
                 min_depth=s["min_depth"], max_depth=s["max_depth"])
    ex = cfg["slam_config"]["extractor"]
    ec = ExtractorConfig(**{f.name: ex[f.name] for f in dataclasses.fields(ExtractorConfig)
                            if f.name in ex})
    return build_frame_features(cam, gray, depth, ec)


def _frame(cfg, kind, i, noisy):
    fn, room, boxes = scene.TRAJECTORIES[kind]
    poses = fn(48)
    g, d = scene.render_frame(cfg["sensor"], poses[i], room, boxes, "cpu")
    if noisy:
        gen = torch.Generator().manual_seed(1234 + i)
        g, d = scene.add_sensor_noise(g, d, CONFIGS["full"]["sensor"]["noise"], gen)
    return g, d


@pytest.mark.parametrize("size", ["full", "tiny"])
@pytest.mark.parametrize("kind,i,noisy", [("tour", 3, False), ("tour", 21, True),
                                          ("sweep", 9, False), ("sweep", 30, True)])
def test_reference_equals_the_program(size, kind, i, noisy):
    cfg = CONFIGS[size]
    g, d = _frame(cfg, kind, i, noisy)
    f = _program_build(cfg, g, d)
    r = ref.build(g, d, cfg["sensor"], cfg["slam_config"]["extractor"])
    assert int(f.valid.sum()) > 50
    assert torch.equal(f.uv_undist, r.uv)
    assert torch.equal(f.xyz[:, 2], r.z)
    assert torch.equal(f.obs_valid, r.obs_valid)
    assert torch.equal(f.smooth, r.smooth)
    assert torch.equal(f.desc, r.desc)


@pytest.mark.parametrize("precision", ["tf32", "bfloat16"])
def test_lower_precision_differs(precision):
    cfg = CONFIGS["full"]
    g, d = _frame(cfg, "tour", 3, False)
    ex = cfg["slam_config"]["extractor"]
    r = ref.build(g, d, cfg["sensor"], ex)
    c = ref.build(g, d, cfg["sensor"], ex, ref.PRECISIONS[precision])
    differ = ((c.uv != r.uv).any(-1) | (c.z != r.z) | (c.desc != r.desc).any(-1))
    assert int(differ.sum()) > 100


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 255.3])
    y = ref.round_tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0 + 2 ** -10 and y[2] == 1.0 + 2 ** -9
    assert abs(float(y[3]) - 255.3) <= 2 ** -3


def test_ate_against_the_programs_evaluator():
    from rgbdslam_tpu_torch.eval.ate import align_umeyama

    gt = scene.tour_trajectory(64, 1.15)
    rng = np.random.default_rng(5)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(scale=0.02, size=(64, 3))
    R, t, _ = align_umeyama(est[:, :3, 3], gt[:, :3, 3])
    err = gt[:, :3, 3] - (est[:, :3, 3] @ R.T + t)
    expect = float(np.sqrt(np.mean(np.sum(err ** 2, axis=1))))
    assert ref_ate.ate_rmse(est, gt) == pytest.approx(expect, rel=1e-9)
    assert ref_ate.ate_rmse(gt, gt) == pytest.approx(0.0, abs=1e-9)


def _points(cfg, f):
    s = cfg["sensor"]
    return torch.stack([(f.uv[:, 0] - s["cx"]) / s["fx"] * f.z,
                        (f.uv[:, 1] - s["cy"]) / s["fy"] * f.z, f.z], dim=-1)


def test_track_extension_equals_the_program():
    """The plain matcher and geometric gate against the program's track
    extension on two keyframes of the tour (the program's plain matcher on
    the CPU, which the card's K2 and gate kernel equal bit for bit)."""
    from rgbdslam_tpu_torch.config import SlamConfig
    from rgbdslam_tpu_torch.slam.system import extend_tracks
    from slambench.reference import match as ref_match
    from slambench.run import camera

    cfg = CONFIGS["full"]
    fr = [_frame(cfg, "tour", i, True) for i in (20, 21)]
    built = [ref.build(g, d, cfg["sensor"], cfg["slam_config"]["extractor"]) for g, d in fr]
    pts = [_points(cfg, f) for f in built]
    gt = scene.tour_trajectory(48)
    T21 = torch.as_tensor(np.linalg.inv(gt[21]) @ gt[20], dtype=torch.float32)
    p = built[0]
    out = extend_tracks(p.desc[None], pts[0][None], p.obs_valid[None], torch.tensor(0),
                        built[1].desc, pts[1], built[1].obs_valid, built[1].uv, T21,
                        camera(cfg["sensor"]), SlamConfig())
    m = ref_match.match(p.desc, p.obs_valid, built[1].desc, built[1].obs_valid, 0.9)
    gate = ref_match.track_gate(pts[0], pts[1], built[1].uv, m.idx2, T21, cfg["sensor"])
    assert int(m.valid.sum()) > 50 and int(out[1].sum()) > 20
    assert ref_match.track_mismatch(out[0].long(), out[1] > 0, m, gate, 3.0) == 0
    shifted = (out[0].long() + 1) % out.shape[1]
    assert ref_match.track_mismatch(shifted, out[1] > 0, m, gate, 3.0) > 20


def test_matcher_ties_and_invalid_ends():
    """Ties go to the lower index on both sides; invalid ends never match."""
    from rgbdslam_tpu_torch.ops.kernels import match_gated_ref
    from slambench.reference import match as ref_match

    gen = torch.Generator().manual_seed(3)
    d1 = torch.randint(-2 ** 31, 2 ** 31 - 1, (200, 8), generator=gen, dtype=torch.int64)
    d1 = d1.to(torch.int32)
    d2 = torch.cat([d1[:100], d1[:100]])          # every query has two equal trains
    d2[150:, 0] ^= 1
    v1, v2 = torch.rand(200, generator=gen) > 0.1, torch.rand(200, generator=gen) > 0.1
    idx2, _, valid = match_gated_ref(d1, d2, v1, v2, 0.9)
    m = ref_match.match(d1, v1, d2, v2, 0.9)
    assert torch.equal(m.valid, valid)
    assert torch.equal(m.idx2[valid], idx2.long()[valid])


def test_dense_icp_step_equals_the_program():
    from rgbdslam_tpu_torch.solvers.dense_icp import _icp_level, scaled_camera
    from slambench.reference import dense_icp as ref_dense
    from slambench.reference import geometry
    from slambench.run import camera

    cfg = CONFIGS["full"]
    (_, d0), (_, d1) = (_frame(cfg, "tour", i, True) for i in (20, 21))
    gt = scene.tour_trajectory(48)
    T = (torch.as_tensor(np.linalg.inv(gt[21]) @ gt[20], dtype=torch.float32)
         @ geometry.exp(torch.tensor([0.004, -0.002, 0.001, 0.003, 0.0, -0.002])))
    prog = _icp_level(scaled_camera(camera(cfg["sensor"]), 2), d0[::2, ::2], d1[::2, ::2],
                      T, 2, 0.3)
    mine = ref_dense.refine(cfg["sensor"], d0, d1, T, 2, 2)
    t, r = geometry.relative_error(mine.numpy(), prog.numpy())
    assert t < 1e-5 and r < 1e-5
    assert geometry.relative_error(mine.numpy(), T.numpy())[0] > 1e-3


def test_pose_graph_equals_the_program():
    """The plain Levenberg-Marquardt against the program's solve of a noisy
    loop of 24 poses, both in float64 on the CPU."""
    from rgbdslam_tpu_torch.solvers.pose_graph import PoseGraphEdges, optimize_pose_graph
    from slambench.reference import geometry
    from slambench.reference import pose_graph as ref_pg

    rng = np.random.default_rng(11)
    gt = scene.tour_trajectory(24, 1.0)
    a = np.r_[np.arange(1, 24), [23, 17]]
    b = np.r_[np.arange(0, 23), [0, 3]]
    Z = np.stack([np.linalg.inv(gt[i]) @ gt[j] for i, j in zip(a, b)])
    noise = geometry.exp(torch.as_tensor(rng.normal(scale=0.01, size=(len(a), 6)))).numpy()
    Z = Z @ noise
    X0 = [gt[0]]
    for k in range(1, 24):                       # odometry dead reckoning
        X0.append(X0[-1] @ np.linalg.inv(Z[k - 1]))
    X0 = np.stack(X0)
    w = np.full(len(a), 100.0)
    prog, _ = optimize_pose_graph(
        torch.as_tensor(X0), PoseGraphEdges(torch.as_tensor(a), torch.as_tensor(b),
                                            torch.as_tensor(Z), torch.as_tensor(w)),
        torch.arange(24) == 0, 20, 1.0, 1e-4)
    mine = ref_pg.solve(X0, a, b, Z, w, 20, 1.0, 1e-4)
    gap = np.max(np.linalg.norm(prog.numpy()[:, :3, 3] - mine[:, :3, 3], axis=-1))
    corr = np.max(np.linalg.norm(X0[:, :3, 3] - mine[:, :3, 3], axis=-1))
    assert gap < 1e-6 * max(corr, 1.0) and corr > 0.05
