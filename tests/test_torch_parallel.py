"""The distributed solvers and the sequence-parallel odometry of
rgbdslam_tpu_torch.parallel against rgbdslam_tpu.parallel (the
counterparts of tests/test_parallel.py), on an 8-shard CPU mesh for the
port and JAX's 8 virtual CPU devices (tests/conftest.py).

Tolerances: the edge-sharded dense LM within 1e-4 of the port's plain solve
and of JAX's distributed solve (f32, the normal equations summed in another
order); the CG LM within 2e-3 of the dense solve (as the JAX test) and 1e-4
of JAX's CG LM (JAX's psum and the port's shard-ordered sum add in
different orders); the landmark-sharded BA within 1e-3 of the unsharded
`local_ba` (as the JAX test) and of JAX's sharded BA; dp_odometry's inlier
counts exactly equal to JAX's with JAX's draws injected, T21 within 1e-4 of
JAX's, and exactly equal to the port's unsharded runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_ba import CAM as JCAM
from test_ba import make_problem, pose_errs
from test_parallel import _chain_problem

import rgbdslam_tpu  # noqa: F401  (pins JAX f32 matmuls)
from rgbdslam_tpu.parallel import dist_ba as jdist
from rgbdslam_tpu.solvers.ba import BAEdges as JBAEdges
from rgbdslam_tpu_torch import convert
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.parallel import Mesh, make_mesh, shard_edges
from rgbdslam_tpu_torch.parallel import dist_ba as tdist
from rgbdslam_tpu_torch.solvers import ba as tba
from rgbdslam_tpu_torch.solvers.pose_graph import PoseGraphEdges, optimize_pose_graph

TCAM = Camera(fx=JCAM.fx, fy=JCAM.fy, cx=JCAM.cx, cy=JCAM.cy, width=JCAM.width,
              height=JCAM.height)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t_edges(edges):
    return PoseGraphEdges(a=torch.from_numpy(np.asarray(edges.a)).long(),
                          b=torch.from_numpy(np.asarray(edges.b)).long(),
                          Z=torch.from_numpy(np.asarray(edges.Z)),
                          weight=torch.from_numpy(np.asarray(edges.weight)))


def _fixed(n):
    f = np.zeros((n,), bool)
    f[0] = True
    return f


def test_mesh_shards_and_sums_in_shard_order():
    """make_mesh repeats the one CPU device; shard_edges pads E to a mesh
    multiple with identity, weight-0 edges in contiguous shards; psum adds
    the partials in shard order."""
    mesh = make_mesh(8, device="cpu")
    assert isinstance(mesh, Mesh) and mesh.size == 8 and mesh.shape == {"edges": 8}
    assert mesh.devices == (torch.device("cpu"),) * 8 and not mesh.spans_processes
    _, _, edges = _chain_problem(np.random.default_rng(0), n=10)   # 17 edges
    shards = shard_edges(_t_edges(edges), mesh)
    assert len(shards) == 8 and all(s.a.shape == (3,) for s in shards)
    pad = shards[-1]
    assert pad.weight[-1] == 0 and torch.equal(pad.Z[-1], torch.eye(4))
    cat = torch.cat([s.a for s in shards])[:17]
    assert torch.equal(cat, torch.from_numpy(np.asarray(edges.a)).long())
    parts = [torch.tensor([1e8]), torch.tensor([1.0])] + [torch.tensor([-1e8])] * 6
    # ((1e8 + 1) - 1e8) - 1e8 ... in f32: 1e8 + 1 rounds to 1e8
    expect = parts[0]
    for p in parts[1:]:
        expect = expect + p
    assert torch.equal(mesh.psum(parts), expect) and mesh.reductions == 1
    with pytest.raises(ValueError):
        mesh.psum(parts[:3])
    # a partial of several tensors is one reduction, each summed alike
    tot, twice = mesh.psum([(p, 2 * p) for p in parts])
    assert torch.equal(tot, expect) and torch.equal(twice, mesh.psum([2 * p for p in parts]))
    assert mesh.reductions == 3
    # one shard in one process: the partial itself, no device operation
    one, x = Mesh([torch.device("cpu")]), torch.ones(3)
    assert one.psum([x]) is x and one.gather([x]) is x and one.replicate(x)[0] is x


def test_distributed_matches_single_device():
    """tests/test_parallel.py:47: the edge-sharded LM equals the plain
    solve, and JAX's edge-sharded LM on its 8 devices."""
    gt, est, edges = _chain_problem(np.random.default_rng(0), n=10)
    fixed = _fixed(10)
    T_single, _ = optimize_pose_graph(torch.from_numpy(est), _t_edges(edges),
                                      torch.from_numpy(fixed), 10, 1.0)
    mesh = make_mesh(8, device="cpu")
    T_dist, cost = tdist.distributed_pose_graph_optimize(
        torch.from_numpy(est), shard_edges(_t_edges(edges), mesh), torch.from_numpy(fixed),
        mesh, iterations=10)
    np.testing.assert_allclose(T_dist.numpy(), T_single.numpy(), atol=1e-4)
    jmesh = jdist.make_mesh(8)
    T_j, cost_j = jdist.distributed_pose_graph_optimize(
        jnp.asarray(est), jdist.shard_edges(edges, jmesh), jnp.asarray(fixed), jmesh,
        iterations=10)
    np.testing.assert_allclose(T_dist.numpy(), np.asarray(T_j), atol=1e-4)
    # H, g and the cost in one reduction, the candidate's cost in another
    assert mesh.reductions == 2 * 10
    assert np.isfinite(float(cost)) and np.isfinite(float(cost_j))


def test_distributed_converges_to_gt():
    """tests/test_parallel.py:64."""
    from rgbdslam_tpu_torch.geometry import se3

    gt, est, edges = _chain_problem(np.random.default_rng(1), n=12)
    mesh = make_mesh(8, device="cpu")
    T_dist, _ = tdist.distributed_pose_graph_optimize(
        torch.from_numpy(est), _t_edges(edges), torch.from_numpy(_fixed(12)), mesh,
        iterations=15)
    err = se3.inverse(T_dist) @ torch.from_numpy(gt)
    assert float(se3.translation_norm(err).max()) < 1e-2
    assert float(se3.rotation_angle(err).max()) < 1e-2


def test_distributed_cg_matches_single_device():
    """tests/test_parallel.py:79: the edge-sharded matrix-free CG LM against
    the plain dense solve and JAX's CG LM; one (K, 6, 6), one (K, 6) and one
    scalar reduction a GN iteration, exactly one (K, 6) a CG iteration."""
    gt, est, edges = _chain_problem(np.random.default_rng(2), n=12)
    fixed = _fixed(12)
    T_single, _ = optimize_pose_graph(torch.from_numpy(est), _t_edges(edges),
                                      torch.from_numpy(fixed), 8, 1.0)
    mesh = make_mesh(8, device="cpu")
    T_cg, cost = tdist.distributed_pose_graph_optimize_cg(
        torch.from_numpy(est), shard_edges(_t_edges(edges), mesh), torch.from_numpy(fixed),
        mesh, iterations=8, cg_iters=64)
    np.testing.assert_allclose(T_cg.numpy(), T_single.numpy(), atol=2e-3)
    assert np.isfinite(float(cost))
    assert mesh.reductions == 8 * (3 + 64)
    jmesh = jdist.make_mesh(8)
    T_j, _ = jdist.distributed_pose_graph_optimize_cg(
        jnp.asarray(est), jdist.shard_edges(edges, jmesh), jnp.asarray(fixed), jmesh,
        iterations=8, cg_iters=64)
    np.testing.assert_allclose(T_cg.numpy(), np.asarray(T_j), atol=1e-4)
    # the port's CG LM on one shard is the plain CG LM, bit for bit
    from rgbdslam_tpu_torch.solvers.cg import optimize_pose_graph_cg

    T_plain, _ = optimize_pose_graph_cg(torch.from_numpy(est), _t_edges(edges),
                                        torch.from_numpy(fixed), 8, 64)
    T_one, _ = tdist.distributed_pose_graph_optimize_cg(
        torch.from_numpy(est), _t_edges(edges), torch.from_numpy(fixed),
        make_mesh(1, device="cpu"), 8, 64)
    assert torch.equal(T_one, T_plain)


@pytest.mark.parametrize("with_edges", [False, True])
def test_distributed_local_ba_matches_unsharded(with_edges):
    """tests/test_parallel.py:97: the landmark-sharded Schur BA equals the
    unsharded local_ba and JAX's sharded BA, and reduces the pose error;
    with the replicated edge factors (the live _global_ba's joint mode) as
    well."""
    problem, Tcw_gt, _ = make_problem(np.random.default_rng(3), K=6, L=64, M=6)
    fixed = _fixed(6)
    t_edges = j_edges = None
    if with_edges:
        a = np.array([1, 2, 3, 4, 5, 3, 0], np.int32)
        b = np.array([0, 1, 2, 3, 4, 0, 0], np.int32)
        Z = np.stack([Tcw_gt[i] @ np.linalg.inv(Tcw_gt[j]) for i, j in zip(a, b)])
        Z = Z.astype(np.float32)
        w = np.array([100.0] * 6 + [0.0], np.float32)
        t_edges = convert.ba_edges_from_numpy(a, b, Z, w, device="cpu")
        j_edges = JBAEdges(a=jnp.asarray(a), b=jnp.asarray(b), Z=jnp.asarray(Z),
                           w=jnp.asarray(w))
    pb = convert.ba_problem_from_numpy(problem, device="cpu")
    Tcw_ref, Xw_ref, _ = tba.local_ba(TCAM, pb, torch.from_numpy(fixed), 5, edges=t_edges)
    mesh = make_mesh(8, device="cpu")
    shards = tdist.shard_landmarks(pb, mesh)
    assert len(shards) == 8 and all(s.Xw.shape == (8, 3) for s in shards)
    Tcw_d, Xw_d, cost = tdist.distributed_local_ba(TCAM, shards, torch.from_numpy(fixed),
                                                   mesh, 5, edges=t_edges)
    np.testing.assert_allclose(Tcw_d.numpy(), Tcw_ref.numpy(), atol=1e-3)
    np.testing.assert_allclose(Xw_d.numpy()[:64], Xw_ref.numpy(), atol=1e-3)
    jmesh = jdist.make_mesh(8)
    Tj, Xj, cj = jdist.distributed_local_ba(JCAM, jdist.shard_landmarks(problem, jmesh),
                                            jnp.asarray(fixed), jmesh, 5, edges=j_edges)
    np.testing.assert_allclose(Tcw_d.numpy(), np.asarray(Tj), atol=1e-3)
    np.testing.assert_allclose(Xw_d.numpy()[:64], np.asarray(Xj)[:64], atol=1e-3)
    np.testing.assert_allclose(float(cost), float(cj), rtol=1e-4)
    before = pose_errs(np.asarray(problem.Tcw), Tcw_gt).max()
    after = pose_errs(Tcw_d.numpy(), Tcw_gt).max()
    assert after < before
    # a landmark count that is no mesh multiple pads with invalid landmarks
    T5, X5, _ = tdist.distributed_local_ba(TCAM, pb, torch.from_numpy(fixed),
                                           make_mesh(5, device="cpu"), 5, edges=t_edges)
    assert X5.shape == (65, 3)
    np.testing.assert_allclose(T5.numpy(), Tcw_ref.numpy(), atol=1e-3)


# ---------------------------------------------------------------------------
# dp_odometry: tests/test_parallel.py:181 at S = 4, T = 4
# ---------------------------------------------------------------------------

DP_S, DP_T = 4, 4


def test_dp_odometry_matches_jax_and_unsharded():
    """Sequence-sharded odometry over 4 shards: inlier counts equal to
    JAX's dp_odometry on its 4 devices with JAX's draws injected, T21
    within 1e-4; equal to the port's unsharded per-sequence runs; the chains
    compose into finite trajectories with inliers found."""
    from rgbdslam_tpu.config import ExtractorConfig as JExtractorConfig
    from rgbdslam_tpu.config import SlamConfig as JSlamConfig
    from rgbdslam_tpu.geometry.camera import Camera as JCamera
    from rgbdslam_tpu.io.synthetic import SyntheticDataset
    from rgbdslam_tpu.parallel import dp_odometry as jdp
    from rgbdslam_tpu_torch.frontend.frame import build_frame_features
    from rgbdslam_tpu_torch.frontend.matcher import gather_matched_points, match_frames
    from rgbdslam_tpu_torch.parallel import dp_odometry as tdp

    jcam = JCamera(100.0, 100.0, 79.5, 59.5, width=160, height=120)
    tcam = Camera(100.0, 100.0, 79.5, 59.5, width=160, height=120)
    jcfg = JSlamConfig(extractor=JExtractorConfig(
        num_features=256, num_levels=2, cell_size=8, fast_threshold=10.0,
        min_response=5.0, min_border=16))
    tcfg = convert.config_from_jax(jcfg)
    grays, depths = [], []
    for s in range(DP_S):
        ds = SyntheticDataset(n_frames=DP_T, cam=jcam, trajectory="sweep", seed=s)
        frames = [ds.grab(i) for i in range(DP_T)]
        grays.append(np.stack([np.asarray(f[1]) for f in frames]))
        depths.append(np.stack([np.asarray(f[2]) for f in frames]))
    grays, depths = np.stack(grays), np.stack(depths)
    keys = jax.random.split(jax.random.PRNGKey(0), DP_S)
    jmesh = jdp.make_seq_mesh(DP_S)
    T21_j, ninl_j = jax.device_get(
        jdp.dp_odometry(jcam, jcfg, jmesh)(jnp.asarray(grays), jnp.asarray(depths), keys))

    # JAX's draws: its key chain, over the port's valid match counts
    H, S_smp = tcfg.ransac.num_hypotheses, tcfg.ransac.sample_size
    draws = np.zeros((DP_S, DP_T - 1, H, S_smp), np.int64)
    for s in range(DP_S):
        k = keys[s]
        feats = [build_frame_features(tcam, torch.from_numpy(grays[s, t]),
                                      torch.from_numpy(depths[s, t]), tcfg.extractor)
                 for t in range(DP_T)]
        for t in range(DP_T - 1):
            k, sub = jax.random.split(k)
            m = match_frames(feats[t], feats[t + 1], tcfg.matcher.nn_ratio)
            n_valid = max(int(gather_matched_points(feats[t], feats[t + 1], m)[3].sum()), 1)
            draws[s, t] = np.asarray(jax.random.randint(sub, (H, S_smp), 0, n_valid))

    mesh = tdp.make_seq_mesh(DP_S, device="cpu")
    assert mesh.axis == "seq" and mesh.size == DP_S
    T21_t, ninl_t = tdp.dp_odometry(tcam, tcfg, mesh)(
        torch.from_numpy(grays), torch.from_numpy(depths), None, torch.from_numpy(draws))
    assert T21_t.shape == (DP_S, DP_T - 1, 4, 4) and ninl_t.shape == (DP_S, DP_T - 1)
    np.testing.assert_array_equal(ninl_t.numpy(), ninl_j)
    np.testing.assert_allclose(T21_t.numpy(), T21_j, rtol=0, atol=1e-4)

    seq_fn = tdp._sequence_odometry(tcam, tcfg)
    for s in range(DP_S):
        T21_s, ninl_s = seq_fn(torch.from_numpy(grays[s]), torch.from_numpy(depths[s]), None,
                               torch.from_numpy(draws[s]))
        assert torch.equal(T21_s, T21_t[s]) and torch.equal(ninl_s, ninl_t[s])
    traj = tdp.compose_chain(T21_t.numpy())
    assert traj.shape == (DP_S, DP_T, 4, 4) and np.isfinite(traj).all()
    assert (ninl_t.numpy() > 10).mean() > 0.8
    # generators: one a sequence, made from seeds on the shard's device
    T21_g, ninl_g = tdp.dp_odometry(tcam, tcfg, make_mesh(2, axis="seq", device="cpu"))(
        torch.from_numpy(grays), torch.from_numpy(depths), list(range(DP_S)))
    assert (ninl_g.numpy() > 10).mean() > 0.8
    with pytest.raises(ValueError, match="sequences over"):
        tdp.dp_odometry(tcam, tcfg, make_mesh(3, device="cpu"))(
            torch.from_numpy(grays), torch.from_numpy(depths), list(range(DP_S)))


def test_batched_frontend_splits_frames_over_the_shards():
    """The data-parallel frontend: each frame's features equal the plain
    build of that frame, B split over the shards."""
    from rgbdslam_tpu_torch.config import ExtractorConfig
    from rgbdslam_tpu_torch.frontend.frame import build_frame_features
    from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset as TDataset

    cam = Camera(100.0, 100.0, 79.5, 59.5, width=160, height=120)
    ecfg = ExtractorConfig(num_features=256, num_levels=2, cell_size=8, fast_threshold=10.0)
    ds = TDataset(n_frames=4, cam=cam, trajectory="sweep", device="cpu")
    grays = torch.stack([ds.grab(i)[1] for i in range(4)])
    depths = torch.stack([ds.grab(i)[2] for i in range(4)])
    mesh = make_mesh(2, device="cpu")
    feats = tdist.batched_frontend(cam, ecfg)(tdist._split(grays, mesh),
                                              tdist._split(depths, mesh))
    assert len(feats) == 4
    for i, f in enumerate(feats):
        ref = build_frame_features(cam, grays[i], depths[i], ecfg)
        assert torch.equal(f.uv, ref.uv) and torch.equal(f.desc, ref.desc)


def test_distributed_entry_points_default_to_the_card():
    """make_mesh, make_seq_mesh, multihost.initialize and both workers run on
    the card unless the caller asks for the CPU: without a card the default
    raises before any process group forms."""
    from rgbdslam_tpu_torch.parallel import dp_odometry as tdp
    from rgbdslam_tpu_torch.parallel import mp_slam, multihost

    worker = ["--coordinator", "localhost:1", "--num-processes", "1", "--process-id", "0"]
    defaults = [lambda: make_mesh(2), lambda: tdp.make_seq_mesh(2),
                lambda: multihost.initialize("localhost:1", 1, 0),
                lambda: multihost.main(worker), lambda: mp_slam.main(worker)]
    if torch.cuda.is_available():
        assert make_mesh(2).home.type == "cuda"
    else:
        for make in defaults:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()
    assert make_mesh(2, device="cpu").home == torch.device("cpu")
    import torch.distributed as dist

    assert not dist.is_initialized()
