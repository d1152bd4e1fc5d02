"""`SlamConfig.distributed` / `--distributed` on one device (F9): the port
runs its plain path, as the JAX package does on one device (JAX
system.py:256-262, cli.py:92-95 "no-op on 1 device"), and with several
devices builds the distributed backend's mesh (the runs on a mesh are
tests/test_torch_distributed_system.py and test_torch_distributed_modes.py;
the mesh of several cards is also
tests/test_torch_kfcore.py::test_unported_configuration_raises and
tests/test_torch_pipeline.py::test_cli_rejects_unported_modes).

The poses of a distributed=True run equal those of distributed=False on the
same frames exactly: one device makes them the same computation.
"""

import json

import numpy as np
import pytest
import torch

from rgbdslam_tpu_torch import cli
from rgbdslam_tpu_torch.config import ExtractorConfig, LoopConfig, SlamConfig
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset
from rgbdslam_tpu_torch.slam import system as system_mod
from rgbdslam_tpu_torch.slam.system import SlamSystem

CAM = Camera(200.0, 200.0, 159.5, 119.5, width=320, height=240)


def _cfg(distributed: bool) -> SlamConfig:
    """tests/test_distributed_system.py's configuration."""
    return SlamConfig(
        extractor=ExtractorConfig(num_features=1024, num_levels=3, cell_size=8,
                                  fast_threshold=15.0),
        loop=LoopConfig(id_interval=12, min_kfs_since_loop=10, vocab_size=256),
        distributed=distributed)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(cfg, n=8):
    ds = SyntheticDataset(n_frames=n, cam=CAM, trajectory="orbit", loops=1.15, device="cpu")
    system = SlamSystem(CAM, cfg, seed=0, device="cpu")
    for i in range(n):
        system.track(*ds.grab(i))
    system.finish()
    return system


def test_distributed_flag_degrades_gracefully_on_one_device(monkeypatch):
    """tests/test_distributed_system.py::
    test_distributed_flag_degrades_gracefully_on_one_device on the port: one
    visible CUDA device (the count patched, as the JAX test patches
    jax.device_count) gives no mesh, two give a mesh over both cards; the
    run on the one CPU device gives poses equal to the distributed=False
    run."""
    cuda = torch.device("cuda")
    monkeypatch.setattr(system_mod.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(system_mod.torch.cuda, "device_count", lambda *a, **k: 1)
    assert system_mod.distributed_mesh(_cfg(distributed=True), cuda) is None
    monkeypatch.setattr(system_mod.torch.cuda, "device_count", lambda *a, **k: 2)
    mesh = system_mod.distributed_mesh(_cfg(distributed=True), cuda)
    assert mesh.size == 2 and mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert system_mod.distributed_mesh(_cfg(distributed=False), cuda) is None
    monkeypatch.undo()
    system = _run(_cfg(distributed=True))
    assert system.graph.mesh is None and system.graph.dist_solves == 0
    assert system.store.count >= 1
    plain = _run(_cfg(distributed=False))
    _, poses_d = system.camera_trajectory()
    _, poses_s = plain.camera_trajectory()
    np.testing.assert_array_equal(poses_d, poses_s)
    assert system.store.count == plain.store.count


def test_cli_accepts_distributed_on_one_device(tmp_path, capsys):
    argv = ["--dataset", "synthetic:orbit", "--frames", "8", "--width", "160",
            "--height", "120", "--cell-size", "8", "--fast-threshold", "15",
            "--device", "cpu", "--out-dir", str(tmp_path)]
    outs = []
    for extra in ([], ["--distributed"]):
        assert cli.main(argv + extra) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        outs.append({k: v for k, v in out.items() if k not in ("wall_s", "fps")})
    assert outs[1] == outs[0] and outs[1]["frames"] == 8


def test_pose_graph_mesh_stays_plain():
    """No mesh, or a mesh of one shard, keeps the plain solve; a mesh of two
    shards puts the solve on the edge-sharded CG LM (dist_solves), which
    lands within CG tolerance of the plain one."""
    from rgbdslam_tpu_torch.geometry import se3
    from rgbdslam_tpu_torch.parallel import make_mesh
    from rgbdslam_tpu_torch.solvers.pose_graph import PoseGraph

    rng = np.random.default_rng(0)
    xi = rng.normal(scale=0.2, size=(8, 6)).astype(np.float32)
    xi[0] = 0
    truth = se3.exp(torch.from_numpy(xi)).numpy()
    noisy = se3.exp(torch.from_numpy(xi + rng.normal(scale=0.02, size=(8, 6)).astype(
        np.float32))).numpy()
    outs = []
    for mesh in (None, make_mesh(1, device="cpu"), make_mesh(2, device="cpu")):
        pg = PoseGraph(8, 16, device="cpu")
        pg.mesh = mesh
        assert pg.mesh is mesh
        for k in range(8):
            pg.add_vertex(noisy[k] if k else truth[0])
        for a, b in [(k, k - 1) for k in range(1, 8)] + [(k, k - 2) for k in range(2, 8)]:
            pg.add_edge(a, b, np.linalg.inv(truth[a]) @ truth[b])
        outs.append(pg.optimize(10))
        assert pg.dist_solves == (1 if mesh is not None and mesh.size > 1 else 0)
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_allclose(outs[2], outs[0], atol=2e-3)
    np.testing.assert_allclose(outs[2], truth, atol=2e-3)
