"""The PnP family, rgbdslam_tpu_torch against rgbdslam_tpu on the same numpy
inputs. The JAX suite's PnP behaviour tests run on the port in
tests/test_torch_pnp_behaviour.py.

Parity tolerances: poses within 1e-4, success flags and inlier masks
equal. `pnp_ransac` gets JAX's own `jax.random.categorical` indices
injected, so both score the same samples. The port's eigendecompositions
are Jacobi sweeps where JAX calls LAPACK's, so eigenvectors are compared
with JAX's only up to their signs, which every eigensolver picks
arbitrarily: EPnP's principal axes (its control points) are signed as
JAX's where its noisy-data pose is compared; the DLT on noisy data is held
against a float64 reference (`_held`). `test_eigh_jacobi_converges` holds
the sweeps against LAPACK on EPnP's and the DLT's own matrices. Quartic
roots and P3P solutions are compared as unordered sets (a pair of roots
near a double root comes out in either order), and inlier masks leave out
rows within 1e-3 px^2 of the chi^2 gate. Each test states its bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyRot

import rgbdslam_tpu  # noqa: F401  (pins JAX f32 matmuls)
from rgbdslam_tpu.geometry.camera import Camera as JCamera
from rgbdslam_tpu.solvers import pnp as jpnp
from rgbdslam_tpu_torch.geometry import se3
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.solvers import pnp as tpnp
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CAM = Camera(525.0, 525.0, 319.5, 239.5)
JCAM = JCamera(525.0, 525.0, 319.5, 239.5)
T = torch.from_numpy


def make_pnp_scene(rng, n=100, noise_px=0.0):
    """tests/test_pnp_icp.py's scene."""
    Xw = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(2, 6, n)],
                  axis=-1).astype(np.float32)
    Tcw = np.eye(4, dtype=np.float32)
    Tcw[:3, :3] = ScipyRot.from_rotvec([0.1, -0.2, 0.05]).as_matrix()
    Tcw[:3, 3] = [0.2, -0.1, 0.3]
    Xc = Xw @ Tcw[:3, :3].T + Tcw[:3, 3]
    uv = np.stack([CAM.fx * Xc[:, 0] / Xc[:, 2] + CAM.cx,
                   CAM.fy * Xc[:, 1] / Xc[:, 2] + CAM.cy], axis=-1).astype(np.float32)
    uv += rng.normal(scale=noise_px, size=uv.shape).astype(np.float32)
    return Xw, uv, Tcw


def pose_err(Ta, Tb):
    d = torch.as_tensor(np.linalg.inv(np.asarray(Ta)) @ np.asarray(Tb), dtype=torch.float32)
    return float(se3.translation_norm(d)), float(se3.rotation_angle(d))


def _exp(xi):
    return se3.exp(T(np.asarray(xi, np.float32))).numpy()


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _outlier_scene(seed, n=200, n_out=70, noise_px=0.3):
    rng = np.random.default_rng(seed)
    Xw, uv, Tcw = make_pnp_scene(rng, n=n, noise_px=noise_px)
    uv_c = uv.copy()
    oi = rng.choice(n, n_out, replace=False)
    uv_c[oi] = rng.uniform([0, 0], [640, 480], size=(n_out, 2)).astype(np.float32)
    return Xw, uv_c, Tcw


# ------------------------------------------------------------------ parity


def test_motion_only_ba_matches_jax():
    rng = np.random.default_rng(1)
    Xw, uv, Tcw = make_pnp_scene(rng, noise_px=0.2)
    uv[:15] += 40.0
    T0 = _exp([0.02, 0.02, -0.02, 0.01, 0.01, -0.01]) @ Tcw
    valid = np.ones(len(Xw), bool)
    valid[-5:] = False
    Tj, inl_j = jpnp.motion_only_ba(JCAM, jnp.asarray(T0), jnp.asarray(Xw), jnp.asarray(uv),
                                    jnp.asarray(valid))
    Tt, inl_t = tpnp.motion_only_ba(CAM, T(T0), T(Xw), T(uv), T(valid))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-4)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    np.testing.assert_allclose(
        tpnp.reproj_residuals(CAM, Tt, T(Xw), T(uv)).numpy(),
        np.asarray(jpnp.reproj_residuals(JCAM, Tj, jnp.asarray(Xw), jnp.asarray(uv))),
        atol=2e-3)


def _root_sets_close(rt, rj, atol):
    """Each row's roots as an unordered set: conjugate pairs come out in
    either order (the sign of a zero imaginary part decides a branch)."""
    for a, b in zip(rt, rj):
        d = np.abs(a[:, None] - b[None, :])
        assert d.min(axis=1).max() <= atol and d.min(axis=0).max() <= atol, (a, b)


def test_quartic_roots_match_jax():
    rng = np.random.default_rng(2)
    coef = rng.normal(size=(4, 64)).astype(np.float32)
    rj = np.asarray(jax.vmap(jpnp._quartic_roots)(*map(jnp.asarray, coef)))  # (64, 4)
    rt = tpnp._quartic_roots(*map(T, coef)).numpy()
    _root_sets_close(rt, rj, 1e-4)


def _minimal_problems(seed, n_problems=24):
    rng = np.random.default_rng(seed)
    rays, pts, gts = [], [], []
    while len(rays) < n_problems:
        Xw = np.stack([rng.uniform(-2, 2, 3), rng.uniform(-1.5, 1.5, 3),
                       rng.uniform(2, 6, 3)], -1).astype(np.float32)
        Tcw = np.eye(4, dtype=np.float32)
        Tcw[:3, :3] = ScipyRot.from_rotvec(rng.normal(0, 0.3, 3)).as_matrix()
        Tcw[:3, 3] = rng.normal(0, 0.5, 3)
        Xc = Xw @ Tcw[:3, :3].T + Tcw[:3, 3]
        if (Xc[:, 2] < 0.2).any():
            continue
        rays.append((Xc / np.linalg.norm(Xc, axis=1, keepdims=True)).astype(np.float32))
        pts.append(Xw)
        gts.append(Tcw)
    return np.stack(rays), np.stack(pts), np.stack(gts)


def test_p3p_grunert_matches_jax():
    """The same number of valid solutions per sample; the port's solution
    nearest the ground truth no further from it than JAX's + 1e-4 (they lie
    up to 2.1e-4 apart); 90 % of all valid solutions matched within 1e-3
    (the secondary solutions sit on poorly conditioned quartic roots: on
    sample 18 both packages give a fourth pose that is no cv2.solveP3P
    solution, 0.21 apart)."""
    rays, pts, gts = _minimal_problems(3)
    Tj, okj = jax.vmap(jpnp._p3p_grunert)(jnp.asarray(rays), jnp.asarray(pts))
    Tt, okt = tpnp._p3p_grunert(T(rays), T(pts))
    Tj, okj, Tt, okt = np.asarray(Tj), np.asarray(okj), Tt.numpy(), okt.numpy()
    assert np.isfinite(Tt).all()
    np.testing.assert_array_equal(okt.sum(-1), okj.sum(-1))
    matched = 0
    for k in range(len(rays)):
        a, b = Tt[k][okt[k]], Tj[k][okj[k]]
        ea = np.abs(a - gts[k]).max(axis=(1, 2)).min()
        eb = np.abs(b - gts[k]).max(axis=(1, 2)).min()
        assert ea <= eb + 1e-4, (k, ea, eb)
        d = np.abs(a.reshape(-1, 16)[:, None] - b.reshape(-1, 16)[None, :]).max(-1)
        matched += int(np.sum(d.min(axis=1) <= 1e-3))
    assert matched >= 0.9 * okt.sum(), (matched, okt.sum())


def _normalized(uv):
    return np.stack([(uv[..., 0] - CAM.cx) / CAM.fx, (uv[..., 1] - CAM.cy) / CAM.fy],
                    axis=-1).astype(np.float32)


def _float64(fn, *args, **kw):
    """fn on the float64 copies of its tensor arguments with LAPACK's eigh in
    place of the Jacobi sweeps: a reference independent of both packages'
    f32 rounding and eigensolvers."""
    orig = tpnp.eigh_jacobi
    tpnp.eigh_jacobi = torch.linalg.eigh
    try:
        return fn(*[a.double() if torch.is_tensor(a) and a.is_floating_point() else a
                    for a in args], **kw)
    finally:
        tpnp.eigh_jacobi = orig


def _axes_signed_as(fn, ref_evecs, *args):
    """fn with the eigenvectors of every 3x3 eigendecomposition (EPnP's
    principal axes, which place its control points) signed as `ref_evecs`
    signs them; asserts that they differ from the reference by their signs
    alone. Any eigensolver's signs are arbitrary, and EPnP's result on
    noisy data depends on where its control points sit."""
    orig = tpnp.eigh_jacobi

    def signed(A):
        e, v = orig(A)
        if A.shape[-1] != 3:
            return e, v
        dot = torch.sum(v.double() * ref_evecs(A).double(), dim=-2)
        assert float((1.0 - dot.abs()).max()) < 1e-5
        return e, v * torch.where(dot < 0, -1.0, 1.0).to(v.dtype)[..., None, :]

    tpnp.eigh_jacobi = signed
    try:
        return fn(*args)
    finally:
        tpnp.eigh_jacobi = orig


def _jax_evecs(A):
    return T(np.array(jnp.linalg.eigh(jnp.asarray(A.numpy()))[1]))


def _held(port, jax_out, ref64, atol=1e-4):
    """The port within `atol` of JAX, or, where JAX's own f32 result lies
    further than that from the float64 reference, within `atol` of the
    reference and no further from JAX than JAX lies from it."""
    port, jax_out, ref64 = (np.asarray(x, np.float64) for x in (port, jax_out, ref64))
    np.testing.assert_allclose(port, ref64, atol=atol)
    lim = atol + np.abs(jax_out - ref64).max(axis=(-2, -1), keepdims=True)
    assert np.all(np.abs(port - jax_out) <= lim), np.abs(port - jax_out).max()


def _closed_form_scenes():
    """16 scenes of 24 points: clean, 0.5 px noise, zero-weight rows."""
    rng = np.random.default_rng(11)
    X, U, W = [], [], []
    for k in range(16):
        Xw, uv, _ = make_pnp_scene(rng, n=24, noise_px=0.5 * (k % 2))
        w = np.ones(24, np.float32)
        w[: 4 * (k % 3)] = 0.0
        X.append(Xw), U.append(_normalized(uv)), W.append(w)
    return np.stack(X), np.stack(U), np.stack(W)


@pytest.mark.parametrize("solver", ["epnp", "dlt"])
def test_closed_forms_match_jax(solver):
    """A batch of 16 scenes (`_closed_form_scenes`). EPnP: within 1e-4 of
    JAX on every scene, clean or noisy, with the principal axes that place
    its control points signed as JAX's LAPACK signs them (on noisy data
    EPnP's pose depends on the control points: with the port's own signs it
    lies up to 6.5e-3 from JAX's, and float64 Jacobi and float64 LAPACK,
    signed alike, give poses 2e-14 apart, test_eigh_jacobi_converges). The
    DLT, whose sign is fixed by cheirality: clean scenes within 1e-4 of JAX,
    noisy ones held by `_held` (JAX's f32 DLT lies up to 2.2e-4 from the
    float64 solution)."""
    X, U, W = _closed_form_scenes()
    args = (T(X), T(U), T(W))
    if solver == "epnp":
        Tj = np.asarray(jax.vmap(jpnp._epnp_pose)(jnp.asarray(X), jnp.asarray(U),
                                                  jnp.asarray(W)))
        Tt = _axes_signed_as(tpnp._epnp_pose, _jax_evecs, *args).numpy()
        np.testing.assert_allclose(Tt, Tj, atol=1e-4)
        return
    Tj = np.asarray(jpnp._dlt_pose(jnp.asarray(X), jnp.asarray(U), jnp.asarray(W)))
    Tt = tpnp._dlt_pose(*args).numpy()
    clean = np.arange(16) % 2 == 0
    np.testing.assert_allclose(Tt[clean], Tj[clean], atol=1e-4)
    _held(Tt, Tj, _float64(tpnp._dlt_pose, *args).numpy())


def test_eigh_jacobi_against_lapack():
    """Eigenvalues within f32 round-off of the largest, each eigenvector
    within 1e-4 up to its sign and its sign canonical (the component of
    largest magnitude positive), on symmetric PSD 3x3 and 12x12 batches."""
    g = torch.Generator().manual_seed(0)
    for n in (3, 12):
        X = torch.randn((64, 2 * n, n), generator=g)
        A = X.transpose(-1, -2) @ X
        e_ref, v_ref = torch.linalg.eigh(A.double())
        e, v = tpnp.eigh_jacobi(A)
        scale = e_ref.abs().amax(-1, keepdim=True)
        assert float(((e.double() - e_ref).abs() / scale).max()) < 1e-5
        dot = torch.abs(torch.sum(v.double() * v_ref, dim=-2))
        assert float((1.0 - dot).max()) < 1e-4
        lead = torch.gather(v, -2, torch.argmax(v.abs(), dim=-2, keepdim=True))
        assert bool((lead > 0).all())


def _room_samples(S, n_samples=256, seed=0):
    """`n_samples` S-point samples of a room seen from a camera 4.2 m from
    the world origin, 1.5 px noise: the conditioning of the tour's PnP
    problems (world coordinates of a few metres; the DLT's A^T A ~1e9)."""
    rng = np.random.default_rng(seed)
    Twc = np.eye(4)
    Twc[:3, :3] = ScipyRot.from_rotvec([0.3, -1.2, 0.1]).as_matrix()
    Twc[:3, 3] = [3.0, 1.2, -2.5]
    Xc = np.stack([rng.uniform(-2, 2, 64), rng.uniform(-1.5, 1.5, 64),
                   rng.uniform(1.5, 5, 64)], -1)
    Xw = Xc @ Twc[:3, :3].T + Twc[:3, 3]
    uv_n = Xc[:, :2] / Xc[:, 2:] + rng.normal(scale=1.5 / CAM.fx, size=(64, 2))
    idx = rng.integers(0, 64, (n_samples, S))
    return (T(Xw[idx].astype(np.float32)), T(uv_n[idx].astype(np.float32)),
            torch.ones((n_samples, S)))


def _matrices_of(fn, *args):
    """The matrices fn hands to eigh_jacobi, in call order."""
    seen, orig = [], tpnp.eigh_jacobi

    def spy(A):
        seen.append(A)
        return orig(A)

    tpnp.eigh_jacobi = spy
    try:
        fn(*args)
    finally:
        tpnp.eigh_jacobi = orig
    return seen


def test_eigh_jacobi_converges(monkeypatch):
    """On EPnP's and the DLT's own matrices (4- and 6-point samples of
    `_room_samples`, and the 24-point noisy scenes): after JACOBI_SWEEPS the
    eigen-residual max ||A v - lambda v|| / ||A||_F is at the float32 floor
    (< 5e-6; four more sweeps lower it by less than 1e-6, where six sweeps
    leave the DLT's 5e-5); and in float64 the eigenpairs match LAPACK's
    (eigenvalues to 1e-12 of ||A||, eigenvectors to 1e-9 up to sign where
    the eigenvalue is 1e-6 of ||A|| from its neighbours), and EPnP on the
    noisy scenes equals EPnP through LAPACK within 1e-9 once its principal
    axes are signed alike."""
    mats = (_matrices_of(tpnp._epnp_pose, *_room_samples(4))
            + _matrices_of(tpnp._dlt_pose, *_room_samples(6)))
    X, U, W = _closed_form_scenes()
    mats += _matrices_of(tpnp._epnp_pose, T(X), T(U), T(W))

    def residual(A):
        e, v = tpnp.eigh_jacobi(A)
        A64, e64, v64 = A.double(), e.double(), v.double()
        r = torch.linalg.vector_norm(A64 @ v64 - v64 * e64[..., None, :], dim=-2)
        return float((r.amax(-1) / torch.linalg.matrix_norm(A64)).max())

    res = [residual(A) for A in mats]
    monkeypatch.setattr(tpnp, "JACOBI_SWEEPS", tpnp.JACOBI_SWEEPS + 4)
    more = [residual(A) for A in mats]
    monkeypatch.setattr(tpnp, "JACOBI_SWEEPS", 6)
    six = [residual(A) for A in mats]
    monkeypatch.undo()
    assert max(res) < 5e-6 and max(r - m for r, m in zip(res, more)) < 1e-6, (res, more)
    assert max(six) > 1e-5, six     # the DLT's A^T A: six sweeps are not enough
    for A in mats:
        A64 = A.double()
        A64 = 0.5 * (A64 + A64.transpose(-1, -2))   # LAPACK reads one triangle
        e, v = tpnp.eigh_jacobi(A64)
        e_ref, v_ref = torch.linalg.eigh(A64)
        nrm = torch.linalg.matrix_norm(A64)[..., None]
        assert float(((e - e_ref).abs() / nrm).max()) < 1e-12
        gap = torch.full_like(e_ref, float("inf"))
        gap[..., 1:] = torch.minimum(gap[..., 1:], e_ref[..., 1:] - e_ref[..., :-1])
        gap[..., :-1] = torch.minimum(gap[..., :-1], e_ref[..., 1:] - e_ref[..., :-1])
        apart = gap / nrm > 1e-6
        d = torch.linalg.vector_norm(v - v_ref * torch.sign(torch.sum(v * v_ref, -2))[..., None, :],
                                     dim=-2)
        assert float(d[apart].max()) < 1e-9
    args64 = (T(X).double(), T(U).double(), T(W).double())
    T_jac = _axes_signed_as(tpnp._epnp_pose, lambda A: torch.linalg.eigh(A)[1], *args64)
    np.testing.assert_allclose(T_jac.numpy(), _float64(tpnp._epnp_pose, *args64).numpy(),
                               atol=1e-9)


@pytest.mark.parametrize("minimal,refit", [("p3p", "ba"), ("epnp", "ba"), ("dlt6", "ba"),
                                           ("p3p", "epnp+ba"), ("epnp", "epnp+ba"),
                                           ("dlt6", "epnp+ba")])
def test_pnp_ransac_matches_jax(minimal, refit):
    """JAX's draws injected: success equal, the pose within 1e-4 of JAX's
    (5e-4 with DLT hypotheses: each package's f32 DLT lies up to 1e-3 from
    the float64 fit of a sample, so the winner's consensus can differ by a
    near-threshold point and the polish lands up to 3.1e-4 apart), inlier
    masks equal but on rows whose chi^2 lies within 1e-3 px^2 of the 5.991
    gate (with DLT hypotheses: equal on every gross outlier, at most 6 of
    200 rows apart)."""
    Xw, uv, Tcw = _outlier_scene(13, n_out=60)
    valid = np.ones(200, bool)
    valid[::17] = False
    key = jax.random.PRNGKey(4)
    S = tpnp.PNP_SAMPLE[minimal]
    logits = jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)
    draws = T(np.asarray(jax.random.categorical(key, logits, shape=(256, S))))
    rj = jpnp.pnp_ransac(JCAM, jnp.asarray(Xw), jnp.asarray(uv), jnp.asarray(valid), key,
                         None, minimal, refit)
    rt = tpnp.pnp_ransac(CAM, T(Xw), T(uv), T(valid), minimal=minimal, refit=refit,
                         draws=draws)
    assert bool(rt.success) == bool(rj.success) and bool(rt.success)
    np.testing.assert_allclose(rt.Tcw.numpy(), np.asarray(rj.Tcw),
                               atol=5e-4 if minimal == "dlt6" else 1e-4)
    r = tpnp.reproj_residuals(CAM, rt.Tcw, T(Xw), T(uv)).numpy()
    chi2 = np.sum(r * r, axis=-1)
    inl_t, inl_j = rt.inliers.numpy(), np.asarray(rj.inliers)
    if minimal == "dlt6":
        # the polish keeps only the winner's 3 px consensus; the two f32
        # DLT winners lie ~1e-3 apart, so a few rows well inside the gate
        # belong to one consensus only (3 % at most); every gross outlier
        # stays out of both
        out = chi2 > 4.0 * tpnp.CHI2_TH
        assert not inl_t[out].any() and not inl_j[out].any()
        assert np.sum(inl_t != inl_j) <= 6
        return
    far = np.abs(chi2 - tpnp.CHI2_TH) > 1e-3
    np.testing.assert_array_equal(inl_t[far], inl_j[far])
    assert abs(int(rt.num_inliers) - int(rj.num_inliers)) <= int((~far).sum())
    assert pose_err(rt.Tcw.numpy(), Tcw)[0] < 0.02
