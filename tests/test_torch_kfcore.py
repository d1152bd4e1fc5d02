"""The per-keyframe device work of rgbdslam_tpu_torch's SlamSystem against
rgbdslam_tpu's fused keyframe program on the same bank, frame, `meta` and
RANSAC draws; the batched candidate verification; the CLI; and what the
port must refuse.

Integers (packed features, the track-extension lane, inlier and match
counts, loop slots) must be equal; poses go through Horn fits whose 4x4
power iterations sum in another order (atol 5e-5, the bound of
tests/test_torch_ransac.py).
"""

import json
import os
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rgbdslam_tpu  # noqa: F401  (pins JAX f32 matmuls)
from rgbdslam_tpu.config import ExtractorConfig as JExtractorConfig
from rgbdslam_tpu.config import LoopConfig as JLoopConfig
from rgbdslam_tpu.config import SlamConfig as JSlamConfig
from rgbdslam_tpu.frontend.frame import build_frame_features as j_build
from rgbdslam_tpu.geometry.camera import Camera as JCamera
from rgbdslam_tpu.io.synthetic import SyntheticDataset as JSyntheticDataset
from rgbdslam_tpu.loop import bow as jbow
from rgbdslam_tpu.loop.vocabulary import shipped_vocabulary as j_shipped
from rgbdslam_tpu.slam import system as jsystem
from rgbdslam_tpu_torch import cli, convert
from rgbdslam_tpu_torch.config import SlamConfig
from rgbdslam_tpu_torch.frontend.matcher import correspondence_weights
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.ops import kernels
from rgbdslam_tpu_torch.slam import system as tsystem
from rgbdslam_tpu_torch.slam.system import SlamSystem
from rgbdslam_tpu_torch.slam.tracking import Tracker
from rgbdslam_tpu_torch.solvers.ransac_se3 import ransac_se3

CAM_ARGS = dict(fx=200.0, fy=200.0, cx=159.5, cy=119.5, width=320, height=240)
EX = dict(num_features=1024, num_levels=3, cell_size=8, fast_threshold=15.0)
# tests/test_system.py's camera and configuration (short sequence: shrunk
# loop gates); the shipped vocabulary is loaded, so vocab_size is unused
JCFG = JSlamConfig(extractor=JExtractorConfig(**EX),
                   loop=JLoopConfig(id_interval=12, min_kfs_since_loop=10, vocab_size=256))
TCFG = convert.config_from_jax(JCFG)
N_FRAMES = 100


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers at once; a torch process that takes
    every core for its intra-op threads then spends its time waiting for
    them. Two threads per process keep the workers out of each other's way."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    """The first 20 frames of the 100-frame orbit (loops=1.15) rendered by
    the JAX package, as numpy: both packages see the same pixels."""
    ds = JSyntheticDataset(n_frames=N_FRAMES, cam=JCamera(**CAM_ARGS), trajectory="orbit",
                           loops=1.15)
    out = []
    for i in range(20):
        ts, g, d = ds.grab(i)
        out.append((float(ts), np.asarray(g), np.asarray(d)))
    return ds, out


def _features_numpy(fj):
    return {k: np.asarray(getattr(fj, k)) for k in convert.FEATURE_FIELDS}


def test_kf_core_blob_matches_jax_fused_program(frames):
    """One keyframe through the JAX package's fused keyframe program and
    through kf_core, on the same bank, features, meta and (injected) RANSAC
    draws."""
    ds, fr = frames
    camj, camt = JCamera(**CAM_ARGS), Camera(**CAM_ARGS)
    C, L = JCFG.pose_graph.max_proximity_candidates, JCFG.loop.max_candidates
    cfg_j = JSlamConfig(extractor=JExtractorConfig(**EX),
                        loop=JLoopConfig(id_interval=3, min_kfs_since_loop=10))
    cfg_t = convert.config_from_jax(cfg_j)
    # bank keyframes: frames 0, 2, ..., 16; the current keyframe is frame 18
    kf_frames = list(range(0, 18, 2))
    k = len(kf_frames)
    feats = [j_build(camj, jnp.asarray(fr[i][1]), jnp.asarray(fr[i][2]), cfg_j.extractor)
             for i in kf_frames + [18]]
    d = np.load(j_shipped("svo_fast"))
    words, idf = d["words"], d["idf"]
    Kb, N = 16, EX["num_features"]
    D = np.zeros((Kb, N, 8), np.uint32)
    X = np.zeros((Kb, N, 3), np.float32)
    V = np.zeros((Kb, N), bool)
    B = np.zeros((Kb, len(idf)), np.float32)
    for r, f in enumerate(feats[:-1]):
        D[r], X[r], V[r] = np.asarray(f.desc), np.asarray(f.xyz), np.asarray(f.obs_valid)
        B[r] = np.asarray(jbow.bow_vector(f.desc, f.obs_valid, jnp.asarray(words),
                                          jnp.asarray(idf)))
    cands = [k - 2, k - 3, 0]
    Tcw = [np.linalg.inv(ds.poses_twc[i].astype(np.float64)) for i in (16, 18)]
    meta = np.zeros((3 + C + 16,), np.float32)
    meta[0], meta[1], meta[2] = k, k - 1, len(cands)
    meta[3:3 + len(cands)] = cands
    meta[3 + C:] = (Tcw[1] @ np.linalg.inv(Tcw[0])).astype(np.float32).ravel()

    key = jax.random.PRNGKey(7)
    prog = jsystem._system_programs(camj, cfg_j)["kf_fused"][True]
    Dj, Xj, Vj, Bj, _key, blob_j = prog(jnp.asarray(D), jnp.asarray(X), jnp.asarray(V),
                                        jnp.asarray(B), feats[-1], meta, jnp.asarray(words),
                                        jnp.asarray(idf), key)
    blob_j = np.asarray(blob_j)
    off = N * 4 + N
    ver_j = blob_j[off:off + (C + L) * 19].reshape(C + L, 19)

    # the JAX program splits its key per candidate and draws in
    # [0, number of matches): the same draws, injected
    sub = jax.random.split(key)[1]
    rc = cfg_j.ransac
    draws = np.stack([
        np.asarray(jax.random.randint(kk, (rc.num_hypotheses, rc.sample_size), 0,
                                      max(int(nm), 1)))
        for kk, nm in zip(jax.random.split(sub, C + L), ver_j[:, 18])])

    bank = convert.bank_from_numpy(D, X, V, B, device="cpu")
    wt, it = convert.vocabulary_from_numpy(words, idf, device="cpu")
    ft = convert.frame_features_from_numpy(_features_numpy(feats[-1]), device="cpu")
    blob_t = tsystem.kf_core(bank, ft, torch.from_numpy(meta), wt, it, camt, cfg_t, True,
                             draws=torch.from_numpy(draws)).numpy()
    assert blob_t.shape == blob_j.shape == (N * 5 + (C + L) * 19 + 2 * L,)

    # slim pack and track-extension lane: exact
    np.testing.assert_array_equal(blob_t[:off], blob_j[:off])
    ext = blob_t[N * 4:off]
    assert int((ext >= 4096).sum()) > 50                    # tracks were extended
    # loop slots: exact where valid (invalid slots tie at -1 in both)
    lv_j = blob_j[-L:] > 0.5
    np.testing.assert_array_equal(blob_t[-L:] > 0.5, lv_j)
    np.testing.assert_array_equal(blob_t[-2 * L:-L][lv_j], blob_j[-2 * L:-L][lv_j])
    assert lv_j.any()
    # verification rows: counts exact on every row both packages read
    ver_t = blob_t[off:off + (C + L) * 19].reshape(C + L, 19)
    read = np.r_[np.arange(C) < len(cands), lv_j]
    np.testing.assert_array_equal(ver_t[:, 16:][read], ver_j[:, 16:][read])
    good = read & (ver_j[:, 17] > 0.5)
    assert good[:2].all(), "the two neighbouring keyframes verify"
    np.testing.assert_allclose(ver_t[good, :16], ver_j[good, :16], rtol=0, atol=5e-5)
    # the padded rows (bank index 0) are verified too and agree as well
    np.testing.assert_array_equal(ver_t[len(cands):C, 16:], ver_j[len(cands):C, 16:])

    # the bank rows written in place equal the JAX program's new bank
    np.testing.assert_array_equal(bank[0].numpy().view(np.uint32), np.asarray(Dj))
    np.testing.assert_array_equal(bank[1].numpy(), np.asarray(Xj))
    np.testing.assert_array_equal(bank[2].numpy(), np.asarray(Vj))
    np.testing.assert_allclose(bank[3].numpy(), np.asarray(Bj), rtol=0, atol=1e-6)

    # the host half decodes both blobs alike
    sj = jsystem.SlamSystem(camj, cfg_j)
    st = SlamSystem(camt, cfg_t, device="cpu")
    for s, blob in ((sj, blob_j), (st, blob_t)):
        s.store.register(0.0, np.eye(4, dtype=np.float32))
        s.store.fill_features_slim(0, blob[:N * 4].reshape(N, 4), s.cam)
    for name in ("uv", "xyz", "obs_valid", "smooth", "intensity"):
        np.testing.assert_array_equal(getattr(st.store, name)[0], getattr(sj.store, name)[0])


def test_kf_core_full_pack_without_vocabulary(frames):
    """Without a codebook the blob carries the full (N, 16) pack and C
    verification rows, decoded by the JAX package's store alike."""
    _, fr = frames
    cam = Camera(**CAM_ARGS)
    C = TCFG.pose_graph.max_proximity_candidates
    N = EX["num_features"]
    system = SlamSystem(cam, TCFG, device="cpu")
    f0 = system.tracker._extractor(torch.from_numpy(fr[0][1]), torch.from_numpy(fr[0][2]))
    f1 = system.tracker._extractor(torch.from_numpy(fr[1][1]), torch.from_numpy(fr[1][2]))
    system._ensure_bank(N)
    meta = np.zeros((3 + C + 16,), np.float32)
    meta[3 + C:] = np.eye(4, dtype=np.float32).ravel()
    b0 = tsystem.kf_core(system._bank, f0, torch.from_numpy(meta), None, None, cam, TCFG,
                         False, system.generator)
    meta[0], meta[1], meta[2] = 1, 0, 1                 # verify keyframe 0 as a candidate
    b1 = tsystem.kf_core(system._bank, f1, torch.from_numpy(meta), None, None, cam, TCFG,
                         False, system.generator).numpy()
    assert b0.shape == b1.shape == (N * 17 + C * 19,)
    ver = b1[N * 17:].reshape(C, 19)
    assert ver[0, 17] > 0.5 and ver[0, 16] >= 100 and ver[0, 18] >= ver[0, 16]
    from rgbdslam_tpu.mapping.keyframes import KeyframeStore as JKeyframeStore

    sj = JKeyframeStore(4, N)
    sj.add_packed(0.0, b1[:N * 16].reshape(N, 16), 8, True, np.eye(4, dtype=np.float32))
    np.testing.assert_array_equal(sj.desc[0], f1.desc.numpy().view(np.uint32))
    np.testing.assert_array_equal(sj.xyz[0], f1.xyz.numpy())
    np.testing.assert_array_equal(sj.obs_valid[0], f1.obs_valid.numpy())


def test_batched_ransac_equals_per_entry_and_jax_vmap():
    """ransac_se3 over a batch of problems (the candidates of one keyframe)
    equals the unbatched call on each entry, and the JAX package's vmap over
    split keys once its draws are injected."""
    from rgbdslam_tpu.solvers.ransac_se3 import ransac_se3 as j_ransac

    rng = np.random.default_rng(11)
    Bn, N = 4, 200
    p1 = rng.uniform(-1, 1, (Bn, N, 3)).astype(np.float32)
    p1[..., 2] = rng.uniform(0.8, 4.0, (Bn, N))
    from rgbdslam_tpu.geometry import se3 as jse3

    T = np.asarray(jse3.exp(jnp.asarray(rng.normal(scale=0.05, size=(Bn, 6)).astype(np.float32))))
    p2 = (np.einsum("bij,bnj->bni", T[:, :3, :3], p1) + T[:, None, :3, 3]
          + rng.normal(scale=0.004, size=(Bn, N, 3))).astype(np.float32)
    out = rng.uniform(size=(Bn, N)) < 0.3
    p2[out] += rng.normal(scale=0.4, size=(int(out.sum()), 3)).astype(np.float32)
    valid = rng.uniform(size=(Bn, N)) > 0.25
    valid[3] = False                                     # a candidate without matches
    w = np.where(valid, 1.0 / (p1[..., 2] * p2[..., 2]), 0.0).astype(np.float32)
    rcj, rct = JCFG.ransac, TCFG.ransac
    keys = jax.random.split(jax.random.PRNGKey(3), Bn)
    rj = jax.vmap(lambda a, b, c, d, kk: j_ransac(a, b, c, d, kk, rcj))(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w), jnp.asarray(valid), keys)
    draws = np.stack([np.asarray(jax.random.randint(
        kk, (rcj.num_hypotheses, rcj.sample_size), 0, max(int(v.sum()), 1)))
        for kk, v in zip(keys, valid)])
    tt = [torch.from_numpy(a) for a in (p1, p2, w, valid)]
    torch.testing.assert_close(correspondence_weights(tt[0], tt[1], tt[3]), tt[2])
    rb = ransac_se3(*tt, None, rct, draws=torch.from_numpy(draws))
    assert rb.T21.shape == (Bn, 4, 4) and rb.inliers.shape == (Bn, N)
    np.testing.assert_array_equal(rb.success.numpy(), np.asarray(rj.success))
    np.testing.assert_array_equal(rb.success.numpy(), [True, True, True, False])
    np.testing.assert_array_equal(rb.num_inliers.numpy(), np.asarray(rj.num_inliers))
    np.testing.assert_array_equal(rb.inliers.numpy(), np.asarray(rj.inliers))
    np.testing.assert_allclose(rb.T21.numpy(), np.asarray(rj.T21), rtol=0, atol=5e-5)
    for i in range(Bn):
        r1 = ransac_se3(*(t[i] for t in tt), None, rct, draws=torch.from_numpy(draws[i]))
        assert torch.equal(r1.inliers, rb.inliers[i])
        torch.testing.assert_close(r1.T21, rb.T21[i], rtol=0, atol=1e-6)
    # the generator draws one (B, H, S) block on the points' device
    g = torch.Generator().manual_seed(0)
    rg = ransac_se3(*tt, g, rct)
    np.testing.assert_array_equal(rg.success.numpy(), [True, True, True, False])


# ---------------------------------------------------------------------------
# the CLI and what the port refuses
# ---------------------------------------------------------------------------


def test_cli_full_slam_runs_on_cpu(tmp_path, capsys):
    argv = ["--dataset", "synthetic:orbit", "--frames", "36", "--loop-interval", "12",
            "--device", "cpu", "--width", "320", "--height", "240", "--cell-size", "8",
            "--fast-threshold", "15", "--out-dir", str(tmp_path)]
    assert cli.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["frames"] == 36 and out["device"] == "cpu" and out["keyframes"] >= 10
    assert out["ate_rmse"] < 0.05 and "loops_closed" in out and out["graph_edges"] >= 9
    for name, rows in (("CameraTrajectory.txt", 36), ("KeyFrameTrajectory.txt",
                                                      out["keyframes"])):
        with open(os.path.join(tmp_path, name)) as f:
            assert len(f.read().splitlines()) == rows
    assert cli.main(argv[:3] + ["8", "--odometry-only"] + argv[4:]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["frames"] == 8 and "loops_closed" not in out and out["keyframes"] >= 2


@pytest.mark.parametrize("field", ["distributed"])
def test_unported_configuration_raises(field, monkeypatch):
    """The distributed backend across several CUDA devices (ROADMAP item
    26, ported): two visible cards give SlamSystem's mesh over both, and
    the field off gives none (one device runs the plain path,
    tests/test_torch_distributed_flag.py)."""
    import dataclasses

    from rgbdslam_tpu_torch.slam.system import distributed_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cuda = torch.device("cuda")
    mesh = distributed_mesh(dataclasses.replace(SlamConfig(), **{field: True}), cuda)
    assert mesh.size == 2 and mesh.axis == "edges"
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert distributed_mesh(SlamConfig(), cuda) is None


def test_unported_modes_raise():
    import dataclasses

    # the batched and ring modes (tests/test_torch_batch_ring.py), the
    # live export (tests/test_torch_disk_slam.py), dense ICP and bundle
    # adjustment (tests/test_torch_accuracy_slam.py) and the extractor
    # families (tests/test_torch_families_*.py) run since they were ported;
    # the distributed backend runs its plain path on one device (F9) and
    # puts the solves on a mesh over several (test_unported_configuration_raises)
    system = SlamSystem(Camera(**CAM_ARGS), dataclasses.replace(TCFG, distributed=True),
                        device="cpu")
    assert system.graph.mesh is None
    from rgbdslam_tpu_torch.device import virtual_devices

    with virtual_devices(2):
        system = SlamSystem(Camera(**CAM_ARGS), dataclasses.replace(TCFG, distributed=True),
                            device="cpu")
    assert system.graph.mesh is system._mesh and system._mesh.size == 2
    from rgbdslam_tpu.frontend.extractor import Extractor as JExtractor

    for detector in ("orb", "sift"):
        tr = Tracker(Camera(**CAM_ARGS), dataclasses.replace(TCFG, detector=detector),
                     device="cpu")
        jx = JExtractor(JCamera(**CAM_ARGS), JCFG.extractor, detector=detector)
        rt, rj = tr._extractor._resolved(), jx._resolved()
        assert rt[:3] == rj[:3], detector
        assert (rt[3].scale_factor, rt[3].num_levels, rt[3].min_response) == (
            rj[3].scale_factor, rj[3].num_levels, rj[3].min_response), detector
    with pytest.raises(ValueError, match="4096"):
        SlamSystem(Camera(**CAM_ARGS), dataclasses.replace(
            TCFG, extractor=dataclasses.replace(TCFG.extractor, num_features=8192)),
            device="cpu")


def test_entry_points_default_to_the_card(monkeypatch):
    """Every public entry point runs on the card unless told otherwise, and
    raises without one."""
    import inspect

    from rgbdslam_tpu_torch.slam.pipeline import PipelinedOdometry
    from rgbdslam_tpu_torch.solvers.pose_graph import PoseGraph

    for cls in (SlamSystem, Tracker, PipelinedOdometry, PoseGraph):
        assert inspect.signature(cls.__init__).parameters["device"].default == "cuda", cls
    assert cli.build_argparser().parse_args(["--dataset", "synthetic"]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: SlamSystem(Camera(**CAM_ARGS)), lambda: Tracker(Camera(**CAM_ARGS)),
                 lambda: PoseGraph(8, 8)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--dataset", "synthetic:orbit", "--frames", "3"])


def test_port_imports_neither_jax_nor_the_jax_package():
    root = pathlib.Path(__file__).resolve().parent.parent
    sources = sorted((root / "rgbdslam_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    assert len(sources) > 30
    pat = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|flax|rgbdslam_tpu)(?:\.|\s|$)", re.M)
    bad = [(str(p.relative_to(root)), m.group(0).strip())
           for p in sources for m in pat.finditer(p.read_text())]
    assert not bad, bad
