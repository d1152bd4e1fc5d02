"""Cross-session Sim(3) map merging, rgbdslam_tpu_torch against rgbdslam_tpu.

Parity: one pair of duck-typed sessions (numpy keyframe stores, graphs and
BoW rows, built once from the 160x120 tour's frames by the port's feature
build on the CPU) is fed to both packages' `merge_maps`. Session B sees the
frames of the overlap with its depth x1.05. `sim3_ransac` gets JAX's own
`jax.random.choice` indices injected (the port's generator cannot reproduce
jax.random's bits), so both verify the same hypotheses: pairs and inlier
counts equal, scales within 1e-4, and the port's f32 merge within 1e-5 of
its own float64 solve. Merged poses agree with JAX's within rtol 1e-4 /
atol 2e-4, not 1e-4: the joint graph is flat along session A's chain (the
float64 cost of either solution agrees to 1e-8 relative), and JAX's f32 LM
ends up to 1.6e-4 m from the float64 solution there, also when both get
the same graph. `sim3_ransac` alone with JAX's draws: the same winner, an
equal inlier count, S21 within 1e-5.
The JAX suite's merge behaviour tests run on the port in
tests/test_torch_merge_sessions.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rgbdslam_tpu  # noqa: F401  (pins JAX f32 matmuls)
from rgbdslam_tpu.mapping import merge as jmerge
from rgbdslam_tpu_torch.config import ExtractorConfig, LoopConfig, SlamConfig
from rgbdslam_tpu_torch.frontend.frame import build_frame_features
from rgbdslam_tpu_torch.geometry import se3
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset
from rgbdslam_tpu_torch.mapping import merge as tmerge
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CAM = Camera(130.0, 130.0, 79.5, 59.5, width=160, height=120)
CFG = SlamConfig(
    extractor=ExtractorConfig(num_features=384, num_levels=3, cell_size=6,
                              fast_threshold=12.0, min_response=8.0,
                              min_border=16),
    loop=LoopConfig(id_interval=12, min_kfs_since_loop=10),
)
N = 112
ALPHA = 1.05   # session B's depth miscalibration
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tour():
    return SyntheticDataset(n_frames=N, cam=CAM, trajectory="tour", device="cpu")


# ------------------------------------------------------------------ parity


class _Store:
    def __init__(self, feats, poses_cw, ts):
        self.desc = np.stack([f[0] for f in feats])
        self.xyz = np.stack([f[1] for f in feats])
        self.obs_valid = np.stack([f[2] for f in feats])
        self.poses_cw = poses_cw
        self.timestamps = ts
        self.count = len(feats)

    def features_of(self, k):
        return self.desc[k], self.xyz[k], self.obs_valid[k]


class _Graph:
    def __init__(self, poses_cw):
        Twc = np.linalg.inv(poses_cw.astype(np.float64))
        K = len(poses_cw)
        self.e_a = np.arange(1, K, dtype=np.int32)
        self.e_b = np.arange(0, K - 1, dtype=np.int32)
        self.e_Z = np.stack([np.linalg.inv(Twc[a]) @ Twc[b]
                             for a, b in zip(self.e_a, self.e_b)]).astype(np.float32)
        self.e_w = np.full(K - 1, 100.0, np.float32)
        self.n_edges = K - 1


class _Loop:
    def __init__(self, bow):
        self.bow_db = bow


class _Session:
    """What `merge_maps` reads of a SlamSystem, as host arrays."""

    def __init__(self, feats, poses_cw, ts, bow):
        self.store = _Store(feats, poses_cw, ts)
        self.graph = _Graph(poses_cw)
        self.loop_detector = _Loop(bow)
        self.device = CPU


def _bow_rows(frames, width=64):
    """Smooth BoW-like rows: keyframes of nearby frames score alike."""
    centers = np.linspace(0, N, width)
    rows = np.exp(-((np.asarray(frames, np.float64)[:, None] - centers[None]) / 6.0) ** 2)
    return (rows / rows.sum(1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def duck_sessions(tour):
    """Session A: keyframes at frames 0, 6, ..., 60; session B: 50, 56, ...,
    110 with depth x ALPHA, its world its first keyframe's camera. Poses are
    the ground truth with a seeded 1 cm / 0.5 deg jitter."""
    rng = np.random.default_rng(0)

    def session(frames, scale):
        feats, poses = [], []
        T0 = tour.poses_twc[frames[0]] if scale != 1.0 else np.eye(4)
        for i in frames:
            _, g, z = tour.grab(i)
            f = build_frame_features(CAM, g, z * scale, CFG.extractor)
            feats.append((f.desc.numpy().view(np.uint32), f.xyz.numpy(), f.obs_valid.numpy()))
            Twc = np.linalg.inv(T0) @ tour.poses_twc[i]
            Twc[:3, 3] *= scale
            jit = se3.exp(torch.from_numpy(np.r_[rng.normal(0, 0.01, 3),
                                                  rng.normal(0, 0.009, 3)].astype(np.float32)))
            poses.append((jit.numpy() @ np.linalg.inv(Twc)).astype(np.float32))
        return _Session(feats, np.stack(poses), tour.timestamps[frames],
                        _bow_rows(frames))

    return session(list(range(0, 61, 6)), 1.0), session(list(range(50, 111, 6)), ALPHA)


class _JaxDraws:
    """JAX merge_maps' sample indices, key by key, for the port's
    `draw_valid`: per pair `key, sub = split(key)`, then sim3_ransac's
    `k_draw, _ = split(sub)` and `choice(k_draw, N, (H, S), p=valid/nv)`."""

    def __init__(self, seed=0):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, valid, H, S, generator):
        self.key, sub = jax.random.split(self.key)
        k_draw, _ = jax.random.split(sub)
        v = valid.numpy()
        probs = v.astype(np.float32) / max(int(v.sum()), 1)
        idx = jax.random.choice(k_draw, len(v), shape=(H, S), p=jnp.asarray(probs))
        return torch.from_numpy(np.asarray(idx).astype(np.int64))


def test_merge_maps_matches_jax(duck_sessions, monkeypatch):
    sa, sb = duck_sessions
    res_j = jmerge.merge_maps(sa, sb, max_pairs=4, min_inliers=15)
    monkeypatch.setattr(tmerge, "draw_valid", _JaxDraws(0))
    res_t = tmerge.merge_maps(sa, sb, max_pairs=4, min_inliers=15)
    assert res_t.pairs == res_j.pairs and len(res_t.pairs) >= 2
    assert res_t.inliers == res_j.inliers
    np.testing.assert_allclose(res_t.scales, res_j.scales, atol=1e-4)
    # the graph has a flat valley along A's chain (both solutions' float64
    # costs agree to 1e-8 relative): JAX's f32 LM ends up to 1.6e-4 m from
    # the float64 solution there, the port's within 3e-6
    np.testing.assert_allclose(res_t.Twc, res_j.Twc, rtol=1e-4, atol=2e-4)
    # the same solve in float64: the port's f32 merge lies within 1e-5 of it
    solve = tmerge.optimize_sim3_graph

    def solve64(S, e, fixed, iterations):
        S64, c = solve(S.double(), e._replace(Z=e.Z.double(), weight=e.weight.double()),
                       fixed, iterations)
        return S64.float(), c.float()

    monkeypatch.setattr(tmerge, "draw_valid", _JaxDraws(0))
    monkeypatch.setattr(tmerge, "optimize_sim3_graph", solve64)
    res_64 = tmerge.merge_maps(sa, sb, max_pairs=4, min_inliers=15)
    np.testing.assert_allclose(res_t.Twc, res_64.Twc, atol=1e-5)
    np.testing.assert_allclose(res_t.scales, res_64.scales, atol=1e-5)
    Ka = sa.store.count
    assert abs(np.median(res_t.scales[Ka:]) - 1.0 / ALPHA) < 0.02
    assert res_t.tried == 4 and set(res_t.ms) == {"bow", "verify", "lm"}


def test_sim3_ransac_matches_jax(duck_sessions):
    """One verified pair's correspondences: JAX's draws injected."""
    sa, sb = duck_sessions
    da, xa, va = sa.store.features_of(10)    # frame 60
    db, xb, vb = sb.store.features_of(2)     # frame 62
    from rgbdslam_tpu.frontend.matcher import match_descriptors as jmatch

    m = jmatch(jnp.asarray(da), jnp.asarray(va), jnp.asarray(db), jnp.asarray(vb))
    idx2 = np.asarray(m.idx2)
    valid = np.asarray(m.valid) & vb[idx2]
    p2 = xb[idx2]
    key = jax.random.PRNGKey(3)
    S_j, n_j, ok_j = jmerge.sim3_ransac(jnp.asarray(xa), jnp.asarray(p2), jnp.asarray(valid),
                                        key)
    k_draw, _ = jax.random.split(key)
    draws = jax.random.choice(k_draw, len(valid), shape=(128, 4),
                              p=jnp.asarray(valid.astype(np.float32) / valid.sum()))
    S_t, n_t, ok_t = tmerge.sim3_ransac(torch.from_numpy(xa), torch.from_numpy(p2),
                                        torch.from_numpy(valid),
                                        draws=torch.from_numpy(np.asarray(draws)))
    assert int(n_t) == int(n_j) and bool(ok_t) == bool(ok_j) and int(n_t) > 50
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j), atol=1e-5)
    # generator draws on the CPU: valid slots only, the same model
    gen = torch.Generator().manual_seed(0)
    S_g, n_g, _ = tmerge.sim3_ransac(torch.from_numpy(xa), torch.from_numpy(p2),
                                     torch.from_numpy(valid), gen)
    assert abs(int(n_g) - int(n_j)) <= 0.05 * int(n_j)
    np.testing.assert_allclose(S_g.numpy(), np.asarray(S_j), atol=5e-3)


def test_merge_refusals(duck_sessions):
    sa, sb = duck_sessions
    other = _Session([sb.store.features_of(k) for k in range(sb.store.count)],
                     sb.store.poses_cw, sb.store.timestamps, sb.loop_detector.bow_db[:, :32])
    with pytest.raises(ValueError, match="vocabularies"):
        tmerge.merge_maps(sa, other)
    with pytest.raises(ValueError, match="verified"):
        tmerge.merge_maps(sa, sb, max_pairs=2, min_inliers=10 ** 6)
