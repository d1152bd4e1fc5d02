"""`SlamConfig.distributed` / `--distributed` on one device (F9): the port
runs its plain path, as the JAX package does on one device (JAX
system.py:256-262, cli.py:92-95 "no-op on 1 device"), and across several
CUDA devices raises, naming ROADMAP item 26 (the refusal itself is
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
    jax.device_count) passes the distributed check that two refuse, and the
    run, on the CPU, gives poses equal to the distributed=False run."""
    cuda = torch.device("cuda")
    monkeypatch.setattr(system_mod.torch.cuda, "device_count", lambda *a, **k: 1)
    system_mod.check_distributed(_cfg(distributed=True), cuda)
    monkeypatch.setattr(system_mod.torch.cuda, "device_count", lambda *a, **k: 2)
    with pytest.raises(NotImplementedError, match="ROADMAP item 26"):
        system_mod.check_distributed(_cfg(distributed=True), cuda)
    monkeypatch.undo()
    system = _run(_cfg(distributed=True))
    assert system.graph.mesh is None
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
    from rgbdslam_tpu_torch.solvers.pose_graph import PoseGraph

    pg = PoseGraph(8, 8, device="cpu")
    pg.mesh = None
    assert pg.mesh is None
    with pytest.raises(NotImplementedError, match="ROADMAP item 26"):
        pg.mesh = object()
