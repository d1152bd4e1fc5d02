"""Bundle adjustment of rgbdslam_tpu_torch against rgbdslam_tpu on the same
problems: `local_ba` on tests/test_ba.py's `make_problem` shapes (K=6,
L=64, M=6), with and without relative-pose edge factors, with the adaptive
Levenberg-Marquardt schedule and with fixed damping; the edge residual
Jacobians; the window problem of a LandmarkStore filled by both packages;
the BA state carried across as numpy.

Tolerances: poses within 2e-5, landmarks within 5e-5 and the final cost
within 1e-5 relative (the normal equations are summed in another order, and
the solve runs on a 36x36 system); the window problem's arrays exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_ba import CAM as JCAM
from test_ba import make_problem
from test_torch_mapping import _drive_landmarks

import rgbdslam_tpu  # noqa: F401  (pins JAX f32 matmuls)
from rgbdslam_tpu.geometry import se3 as jse3
from rgbdslam_tpu.mapping.landmarks import LandmarkStore as JLandmarkStore
from rgbdslam_tpu.solvers import ba as jba
from rgbdslam_tpu_torch import convert
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.mapping.landmarks import LandmarkStore
from rgbdslam_tpu_torch.solvers import ba as tba
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TCAM = Camera(fx=JCAM.fx, fy=JCAM.fy, cx=JCAM.cx, cy=JCAM.cy, width=JCAM.width,
              height=JCAM.height)
K = 6


def _edges(Tcw_gt, weight=100.0):
    """Consecutive relative poses and one longer edge in the Twc convention
    Z = T_{a<-b} = Tcw_a Twc_b, padded to 8 slots with zero weight."""
    a = np.array([1, 2, 3, 4, 5, 3, 0, 0], np.int32)
    b = np.array([0, 1, 2, 3, 4, 0, 0, 0], np.int32)
    Z = np.stack([Tcw_gt[i] @ np.linalg.inv(Tcw_gt[j]) for i, j in zip(a, b)]).astype(np.float32)
    Z[6:] = np.eye(4, dtype=np.float32)
    w = np.array([weight] * 6 + [0.0, 0.0], np.float32)
    return a, b, Z, w


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("with_edges", [False, True])
def test_local_ba_matches_jax(adaptive, with_edges):
    problem, Tcw_gt, Xw_gt = make_problem(np.random.default_rng(0))
    fixed = np.zeros((K,), bool)
    fixed[0] = True
    j_edges = t_edges = None
    if with_edges:
        a, b, Z, w = _edges(Tcw_gt)
        j_edges = jba.BAEdges(a=jnp.asarray(a), b=jnp.asarray(b), Z=jnp.asarray(Z),
                              w=jnp.asarray(w))
        t_edges = convert.ba_edges_from_numpy(a, b, Z, w, device="cpu")
    Tj, Xj, cj = jba.local_ba(JCAM, problem, jnp.asarray(fixed), 5, edges=j_edges,
                              adaptive=adaptive)
    Tt, Xt, ct = tba.local_ba(TCAM, convert.ba_problem_from_numpy(problem, device="cpu"),
                              torch.from_numpy(fixed), 5, edges=t_edges, adaptive=adaptive)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=0, atol=2e-5)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=0, atol=5e-5)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-5)
    # the solve did its work: the gauge stays put, the others move toward
    # the truth
    T0 = np.asarray(problem.Tcw)
    np.testing.assert_array_equal(Tt.numpy()[0], T0[0])
    err0 = np.abs(np.asarray(problem.Xw) - Xw_gt).mean()
    assert np.abs(Xt.numpy() - Xw_gt).mean() < err0


def test_edge_residual_jacobians_match_jax():
    """Forward-mode Jacobians under vmap (a leading dimension of one inside)
    against JAX's jacfwd, on perturbed edges."""
    import jax

    rng = np.random.default_rng(4)
    _, Tcw_gt, _ = make_problem(rng)
    a, b, Z, _w = _edges(Tcw_gt)
    xi = rng.normal(scale=0.05, size=(2, 8, 6)).astype(np.float32)
    Ta = np.asarray(jse3.exp(jnp.asarray(xi[0]))) @ Tcw_gt[a]
    Tb = np.asarray(jse3.exp(jnp.asarray(xi[1]))) @ Tcw_gt[b]
    Ta, Tb = Ta.astype(np.float32), Tb.astype(np.float32)
    rj, Jaj, Jbj = jax.jit(jax.vmap(jba._edge_residual_jacobians))(
        jnp.asarray(Ta), jnp.asarray(Tb), jnp.asarray(Z))
    rt, Jat, Jbt = torch.func.vmap(tba._edge_residual_jacobians)(
        torch.from_numpy(Ta), torch.from_numpy(Tb), torch.from_numpy(Z))
    assert rt.dtype == Jat.dtype == torch.float32
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=2e-5)
    np.testing.assert_allclose(Jat.numpy(), np.asarray(Jaj), rtol=0, atol=1e-4)
    np.testing.assert_allclose(Jbt.numpy(), np.asarray(Jbj), rtol=0, atol=1e-4)


def test_reprojection_jacobians_match_jax():
    problem, _, _ = make_problem(np.random.default_rng(1))
    tp = convert.ba_problem_from_numpy(problem, device="cpu")
    uj, Jcj, Jlj, sj = jba._reproj_jacobians(JCAM, problem.Tcw[problem.obs_kf],
                                             problem.Xw[:, None, :])
    ut, Jct, Jlt, st = tba._reproj_jacobians(TCAM, tp.Tcw[tp.obs_kf], tp.Xw[:, None, :])
    for t, j, tol in ((ut, uj, 1e-3), (Jct, Jcj, 1e-2), (Jlt, Jlj, 1e-3), (st, sj, 1e-2)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=tol)


def test_padded_keyframes_and_invalid_observations_stay_put():
    """tests/test_ba.py's padding case: keyframes past K fixed at the
    identity and observation-free, landmarks with no valid observation kept
    where they were; equal to the JAX package."""
    problem, _, _ = make_problem(np.random.default_rng(2))
    pad = 8
    d = {n: np.array(getattr(problem, n)) for n in convert.BA_PROBLEM_FIELDS}
    d["Tcw"] = np.concatenate([d["Tcw"], np.tile(np.eye(4, dtype=np.float32), (pad - K, 1, 1))])
    d["obs_valid"][:5] = False
    fixed = np.zeros((pad,), bool)
    fixed[0] = True
    fixed[K:] = True
    jp = jba.BAProblem(**{n: jnp.asarray(v) for n, v in d.items()})
    Tj, Xj, _ = jba.local_ba(JCAM, jp, jnp.asarray(fixed), 4)
    Tt, Xt, _ = tba.local_ba(TCAM, convert.ba_problem_from_numpy(d, device="cpu"),
                             torch.from_numpy(fixed), 4)
    np.testing.assert_array_equal(Tt.numpy()[K:], np.tile(np.eye(4, dtype=np.float32),
                                                          (pad - K, 1, 1)))
    np.testing.assert_array_equal(Xt.numpy()[:5], d["Xw"][:5])
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=0, atol=2e-5)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=0, atol=5e-5)


@pytest.mark.parametrize("pad_k", [None, 8])
def test_window_problem_matches_jax(pad_k):
    """A LandmarkStore filled by both packages from the same keyframes gives
    the same window problem, with the keyframe padding of global BA and
    without."""
    lj, lt = JLandmarkStore(32, 3, 64), LandmarkStore(32, 3, 64)
    centers = _drive_landmarks(lj, np.random.default_rng(5), False)
    _drive_landmarks(lt, np.random.default_rng(5), False)
    poses = np.tile(np.eye(4, dtype=np.float32), (6, 1, 1))
    poses[:, :3, 3] = -centers
    lo, hi = (0, 5) if pad_k else (2, 5)
    pj, lm_j, kf_j = lj.window_problem(lo, hi, poses, pad_k=pad_k)
    pt, lm_t, kf_t = lt.window_problem(lo, hi, poses, pad_k=pad_k, device="cpu")
    np.testing.assert_array_equal(lm_t, lm_j)
    np.testing.assert_array_equal(kf_t, kf_j)
    assert len(lm_t) >= 8 and pt.Xw.shape[0] >= len(lm_t)
    nt, nj = convert.ba_problem_to_numpy(pt), convert.ba_problem_to_numpy(pj)
    for name in convert.BA_PROBLEM_FIELDS:
        np.testing.assert_array_equal(nt[name], nj[name], err_msg=name)
    assert pt.obs_kf.dtype == torch.int64 and pt.Tcw.shape[0] == (pad_k or hi - lo + 1)


def test_ba_state_round_trip():
    """JAX BAProblem -> numpy -> the port -> numpy: the arrays come back
    equal; edges carry across with int64 indices."""
    problem, Tcw_gt, _ = make_problem(np.random.default_rng(3))
    back = convert.ba_problem_to_numpy(convert.ba_problem_from_numpy(problem, device="cpu"))
    for name in convert.BA_PROBLEM_FIELDS:
        np.testing.assert_array_equal(back[name], np.asarray(getattr(problem, name)))
    a, b, Z, w = _edges(Tcw_gt)
    e = convert.ba_edges_from_numpy(a, b, Z, w, device="cpu")
    assert e.a.dtype == torch.int64 and e.w.dtype == torch.float32
    for t, n in zip(e, (a, b, Z, w)):
        np.testing.assert_array_equal(t.numpy(), n)
