"""The SE(3) loop solve's kernels (csrc/pose_graph.cu) on the card, against
the plain jacfwd path on the card and on the CPU. Every test here is marked
`gpu` and skips without a card:

  python -m pytest -q --noconftest -m gpu tests/test_torch_gpu_pose_graph.py

Graphs of the tours' sizes: K = 90 keyframes with E = 120 edges
(tour_b32's), K = 119 with 160 (live_ring's), a chain with chords and a
few long loop edges, the poses perturbed by ~0.05.

Tolerances, each with its reason:
- H and g within 1e-5 of max|H| (max|g|), rtol 1e-4, of the plain system
  built in float64 on the card: the kernel sums the blocks in f32 in its
  own fixed order (a block a vertex, the edges in order), with the
  closed-form Jacobians (held to float64 within 1e-6 by
  tests/test_torch_pose_graph_kernel.py). Against the plain f32 system 1e-4
  of max|H|: jacfwd's f32 derivatives of log_smooth cancel between
  theta ~ 1e-4 and 0.05, where these graphs' residuals lie;
- the cost rtol 1e-5 (the same per-edge terms summed in another order);
  H, g and the cost the same bits in two calls;
- the damped H: off the diagonal and g and the cost the same bits as with
  no damping, the diagonal within rtol 1e-6 of `_damped_step`'s damping
  of the undamped one (the same f32 operations in the same order);
- the trial step: the poses within 1e-5 of se3.exp's, the cost rtol 1e-5,
  lambda rtol 1e-6;
- whole solves: the largest camera-centre gap over the largest correction
  under 1e-2 (slambench's `solve_gap`, against the plain f32 solve on the
  card and on the CPU); the final costs rtol 1e-3 of the initial cost's
  scale (tests/test_torch_posegraph.py's: the solves end near 1e-8).
"""

import numpy as np
import pytest
import torch

from rgbdslam_tpu_torch.geometry import se3
from rgbdslam_tpu_torch.mesh import Mesh
from rgbdslam_tpu_torch.solvers import pose_graph as tpg

pytestmark = pytest.mark.gpu

SIZES = [(90, 120), (119, 160)]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def kernels(dev):
    from rgbdslam_tpu_torch.ops import kernels as k

    return k


def tour_graph(K: int, E: int, seed: int, device):
    """(X (K, 4, 4), edges, fixed) on `device`: a chain of K poses 0.1-0.3 m
    apart with E - (K - 1) chords to a vertex 2-12 back and, of those, four
    long loop edges to the first keyframes; Z from the truth, the poses
    perturbed (vertex 0 exact and fixed)."""
    rng = np.random.default_rng(seed)
    step = rng.normal(scale=0.1, size=(K, 6))
    step[:, 2] += 0.2
    truth = [torch.eye(4, dtype=torch.float64)]
    for i in range(1, K):
        truth.append(truth[-1] @ se3.exp(torch.from_numpy(step[i])))
    truth = torch.stack(truth)
    chords = E - (K - 1)
    a = np.r_[np.arange(1, K), rng.integers(12, K, chords - 4), rng.integers(K - 10, K, 4)]
    b = np.r_[np.arange(K - 1), a[K - 1:K - 1 + chords - 4] - rng.integers(2, 13, chords - 4),
              rng.integers(0, 4, 4)]
    Z = se3.inverse(truth[a]) @ truth[b]
    noise = rng.normal(scale=0.05, size=(K, 6))
    noise[0] = 0.0
    X = (se3.exp(torch.from_numpy(noise)) @ truth).float()
    edges = tpg.PoseGraphEdges(torch.from_numpy(a).long(), torch.from_numpy(b).long(),
                               Z.float().contiguous(), torch.full((E,), 100.0))
    fixed = torch.arange(K) == 0
    on = lambda t: t.to(device)   # noqa: E731
    return on(X.contiguous()), tpg.PoseGraphEdges(*map(on, edges)), on(fixed)


def plain_normal_equations(x, ed, d):
    return tpg._normal_equations(x, ed, d, x.shape[0], 6, tpg.edge_blocks)


def plain_solve(X, edges, fixed, iterations):
    """The plain dense LM on X's device (jacfwd under vmap, the scatter)."""
    return tpg._dense_lm(X, (edges,), fixed, Mesh([X.device]), iterations, 1.0, 1e-4, True, 6,
                         tpg.edge_blocks, se3.exp, tpg.graph_cost)


def solve_gap(T, T_ref, T0):
    """The largest camera-centre gap between two solves over the largest
    correction the reference made (at least 0.01 m)."""
    c, c_ref, c0 = (t[:, :3, 3].double().cpu() for t in (T, T_ref, T0))
    gap = float(torch.linalg.norm(c - c_ref, dim=-1).max())
    corr = float(torch.linalg.norm(c_ref - c0, dim=-1).max())
    return gap / max(corr, 0.01)


@pytest.mark.parametrize("K,E", SIZES)
def test_normal_equations_against_plain_on_the_card(dev, kernels, K, E):
    X, edges, fixed = tour_graph(K, E, seed=K, device=dev)
    # no damping: lam 0 and no fixed vertex leave H's diagonal + 1e-8, under
    # the f32 ulp of these diagonals
    zero, free = torch.zeros((), device=dev), torch.zeros_like(fixed)
    H, g, cost = kernels.pose_graph_normal_equations(X, *edges, 1.0, zero, free)
    H64, g64, c64 = plain_normal_equations(
        X.double(), tpg.PoseGraphEdges(edges.a, edges.b, edges.Z.double(),
                                       edges.weight.double()), 1.0)
    Hp, gp, cp = plain_normal_equations(X, edges, 1.0)
    hmax, gmax = float(H64.abs().max()), float(g64.abs().max())
    np.testing.assert_allclose(H.double().cpu(), H64.cpu(), rtol=1e-4, atol=1e-5 * hmax)
    np.testing.assert_allclose(g.double().cpu(), g64.cpu(), rtol=1e-4, atol=1e-5 * gmax)
    np.testing.assert_allclose(H.cpu(), Hp.cpu(), rtol=1e-4, atol=1e-4 * hmax)
    np.testing.assert_allclose(g.cpu(), gp.cpu(), rtol=1e-4, atol=1e-4 * gmax)
    np.testing.assert_allclose(float(cost), float(cp), rtol=1e-5)
    np.testing.assert_allclose(float(cost), float(c64), rtol=1e-5)
    # every sum in a fixed order: the same bits in a second call
    H2, g2, cost2 = kernels.pose_graph_normal_equations(X, *edges, 1.0, zero, free)
    assert torch.equal(H, H2) and torch.equal(g, g2) and torch.equal(cost, cost2)
    # the damped system: the gauge prior and Marquardt's lambda on the
    # diagonal in _damped_step's order, nothing else moved
    lam = torch.tensor(3e-3, device=dev)
    Hd, gd, cd = kernels.pose_graph_normal_equations(X, *edges, 1.0, lam, fixed)
    off = ~torch.eye(6 * K, dtype=torch.bool, device=dev)
    assert torch.equal(Hd[off], H[off]) and torch.equal(gd, g) and torch.equal(cd, cost)
    d = torch.diagonal(H)
    fixed_d = fixed[:, None].expand(K, 6).reshape(-1)
    torch.testing.assert_close(torch.diagonal(Hd),
                               (d + torch.where(fixed_d, 1e9, lam + 1e-8)) + lam * d,
                               rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("K,E", SIZES)
def test_trial_against_plain_on_the_card(dev, kernels, K, E):
    """pose_graph_trial against se3.exp, graph_cost and _lm_update on the
    step of the damped solve (accepted), on that step reversed (rejected)
    and without `adaptive` (taken): the poses within 1e-5 (se3.exp's f32
    formula, products in another order), the cost rtol 1e-5 (another order
    of sums), lambda the same up to rounding."""
    X, edges, fixed = tour_graph(K, E, seed=K + 2, device=dev)
    lam = torch.tensor(1e-4, device=dev)
    Hd, gd, cost_it = kernels.pose_graph_normal_equations(X, *edges, 1.0, lam, fixed)
    sol = torch.linalg.solve_ex(Hd, gd[:, None])[0][:, 0]
    for step, adaptive, accepted in ((sol, True, True), (-sol, True, False),
                                     (-sol, False, None)):
        X_k, lam_k, c_k = kernels.pose_graph_trial(X, step.contiguous(), fixed, *edges, 1.0,
                                                   cost_it, lam, adaptive)
        xi = torch.where(fixed[:, None], 0.0, -step.reshape(K, 6))
        X_cand = se3.exp(xi) @ X
        c_new = tpg.graph_cost(X_cand, edges, 1.0)
        if adaptive:
            X_p, lam_p, c_p = tpg._lm_update(c_new < cost_it, lam, cost_it, c_new, X, X_cand)
            assert bool(c_new < cost_it) == accepted
        else:
            X_p, lam_p, c_p = X_cand, lam, cost_it
        torch.testing.assert_close(X_k, X_p, rtol=0.0, atol=1e-5)
        torch.testing.assert_close(c_k, c_p, rtol=1e-5, atol=0.0)
        torch.testing.assert_close(lam_k, lam_p, rtol=1e-6, atol=0.0)
        assert torch.equal(X_k[0], X[0])                   # the gauge vertex


@pytest.mark.parametrize("K,E", SIZES)
def test_optimize_on_the_card_against_plain(dev, kernels, K, E):
    """optimize_pose_graph (20 iterations, the loop closure's) and the
    registry's PoseGraph.optimize on the card against the plain solve on the
    card and on the CPU; no host synchronisation inside the solve."""
    X, edges, fixed = tour_graph(K, E, seed=K + 1, device=dev)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        T_k, c_k = tpg.optimize_pose_graph(X, edges, fixed, 20)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert kernels.LAUNCHES["pose_graph_normal_equations"] == 20
    assert kernels.LAUNCHES["pose_graph_trial"] == 20
    T_p, c_p = plain_solve(X, edges, fixed, 20)
    cpu = lambda t: t.cpu()   # noqa: E731
    T_c, c_c = tpg.optimize_pose_graph(cpu(X), tpg.PoseGraphEdges(*map(cpu, edges)),
                                       cpu(fixed), 20)
    assert solve_gap(T_k, T_p, X) < 1e-2
    assert solve_gap(T_k, T_c, X) < 1e-2
    assert torch.equal(T_k[0], X[0])                       # the gauge vertex
    # the final costs are ~1e-8 (consistent measurements): compare on the
    # scale of the initial cost
    c0 = float(tpg.graph_cost(X, edges, 1.0))
    for c in (float(c_p), float(c_c)):
        assert abs(float(c_k) - c) <= 1e-3 * max(c, 1e-6 * c0)
    # the registry: one upload, the dense branch, the same solve
    graph = tpg.PoseGraph(8, 8, device=dev)
    for T in X.cpu().numpy():
        graph.add_vertex(T)
    for a, b, Z in zip(edges.a.tolist(), edges.b.tolist(), edges.Z.cpu().numpy()):
        graph.add_edge(a, b, Z)
    out = graph.optimize(20)
    assert graph.dense_iterations == 20
    assert solve_gap(torch.from_numpy(out), T_c, X) < 1e-2


def _device_ops(fn):
    """{device op name: count} over one call of fn() under torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    ops = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            ops[evt.key] = ops.get(evt.key, 0) + evt.count
    return ops


def test_device_launches_an_iteration(dev, kernels, monkeypatch):
    """The profiler's device ops of a 20-iteration solve less a 10-iteration
    one, over 10, are the two kernels once each and the device ops of
    torch.linalg.solve_ex on the same system (counted alone: cuSOLVER's
    blocked getrf and torch's triangular lu_solve, ~36 at n = 540); the
    card's path never reaches torch.func.jacfwd."""
    X, edges, fixed = tour_graph(90, 120, seed=3, device=dev)

    def refuse(*args, **kwargs):
        raise AssertionError("the card's solve reached torch.func.jacfwd")

    monkeypatch.setattr(torch.func, "jacfwd", refuse)
    tpg.optimize_pose_graph(X, edges, fixed, 2)            # warm
    lam = torch.tensor(1e-4, device=dev)
    H, g, _ = kernels.pose_graph_normal_equations(X, *edges, 1.0, lam, fixed)
    best = None
    for _ in range(4):                                      # the tracer drops records now and then
        counts = [_device_ops(lambda: tpg.optimize_pose_graph(X, edges, fixed, n))
                  for n in (10, 20)]
        solve = _device_ops(lambda: torch.linalg.solve_ex(H, g[:, None]))
        ours = [{k: v for k, v in c.items() if "pose_graph" in k} for c in counts]
        if all(sorted(o.values()) == [n, n] for o, n in zip(ours, (10, 20))):
            best = counts
            break
    assert best is not None, "no profiler window held every launch of the kernels"
    per_iteration = {k: (v - best[0].get(k, 0)) / 10 for k, v in best[1].items()}
    n_solve = sum(solve.values())
    print(f"device ops an iteration: {sum(per_iteration.values())}, of them solve_ex's "
          f"{n_solve}: {per_iteration}")
    assert sum(per_iteration.values()) <= 2 + n_solve
    assert sum(v for k, v in per_iteration.items() if "pose_graph" in k) == 2
    kernels.reset_launch_counts()
    tpg.optimize_pose_graph(X, edges, fixed, 20)
    assert kernels.LAUNCHES["pose_graph_normal_equations"] == 20
    assert kernels.LAUNCHES["pose_graph_trial"] == 20


def test_large_map_takes_cg_on_the_card(dev, kernels):
    """A map past kernels.POSE_GRAPH_MAX_VERTICES takes the CG solve on the
    card even where cg_threshold would allow the dense one."""
    from rgbdslam_tpu_torch.solvers.cg import optimize_pose_graph_cg

    K = kernels.POSE_GRAPH_MAX_VERTICES + 6
    X, edges, fixed = tour_graph(K, K + 19, seed=5, device=dev)
    graph = tpg.PoseGraph(8, 8, cg_threshold=4096, device=dev)
    for T in X.cpu().numpy():
        graph.add_vertex(T)
    for a, b, Z in zip(edges.a.tolist(), edges.b.tolist(), edges.Z.cpu().numpy()):
        graph.add_edge(a, b, Z)
    assert not graph.dense_fits(K) and graph.dense_fits(K - 6)
    kernels.reset_launch_counts()
    out = graph.optimize(2)
    assert graph.dense_iterations == 0 and kernels.LAUNCHES["pose_graph_normal_equations"] == 0
    T_cg, _ = optimize_pose_graph_cg(X, edges, fixed, 2, graph.cg_iters, graph.huber_delta,
                                     graph.lm_lambda0)
    np.testing.assert_allclose(out, T_cg.cpu().numpy(), rtol=0, atol=1e-4)
