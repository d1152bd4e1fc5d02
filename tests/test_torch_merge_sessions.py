"""The JAX suite's cross-session merge behaviour tests (tests/test_merge.py)
on the port alone: three port sessions on the CPU at that file's 160x120
camera and configuration (A over frames 0-60, B over 52-112 with its depth
x1.05, the control B' over 52-112, the shipped vocabulary), built once,
held to that file's bounds with no JAX re-run: scales 1 +- 0.02 and
1/1.05 +- 0.02, B's spread < 0.02, the joint ATE < 0.25 m, the control
1 +- 0.02 with spread < 0.02. The parity of `merge_maps` with the JAX
package is tests/test_torch_merge.py.
"""

import numpy as np
import pytest

from rgbdslam_tpu_torch.eval.ate import ate_rmse
from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset
from rgbdslam_tpu_torch.loop.vocabulary import shipped_vocabulary
from rgbdslam_tpu_torch.mapping import merge as tmerge
from rgbdslam_tpu_torch.slam.system import SlamSystem
from test_torch_merge import ALPHA, CAM, CFG, N
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def tour():
    return SyntheticDataset(n_frames=N, cam=CAM, trajectory="tour", device="cpu")


def _run_session(ds, lo, hi, depth_scale=1.0):
    system = SlamSystem(CAM, CFG, seed=0, device="cpu")
    system.load_vocabulary(shipped_vocabulary("svo_fast"))
    for i in range(lo, hi):
        ts, gray, depth = ds.grab(i)
        system.track(ts, gray, depth * depth_scale if depth_scale != 1.0 else depth)
    system.finish()
    assert system.tracker.stats.failures <= (hi - lo) * 0.15
    return system


@pytest.fixture(scope="module")
def sessions(tour):
    return (_run_session(tour, 0, 60), _run_session(tour, 52, N, depth_scale=ALPHA),
            _run_session(tour, 52, N))


def test_merge_recovers_depth_scale(tour, sessions):
    sys_a, sys_b, _ = sessions
    res = tmerge.merge_maps(sys_a, sys_b, max_pairs=4, min_inliers=15)
    Ka = sys_a.store.count
    sa, sb = res.scales[:Ka], res.scales[Ka:]
    assert np.abs(np.median(sa) - 1.0) < 0.02, np.median(sa)
    assert np.abs(np.median(sb) - 1.0 / ALPHA) < 0.02, (np.median(sb), 1.0 / ALPHA)
    assert np.std(sb) < 0.02
    ts_all = np.concatenate([sys_a.store.timestamps[:Ka],
                             sys_b.store.timestamps[: sys_b.store.count]])
    order = np.argsort(ts_all)
    rmse, _ = ate_rmse(ts_all[order], res.Twc[order], tour.timestamps, tour.poses_twc)
    assert rmse < 0.25, f"merged joint ATE {rmse:.3f}"


def test_merge_equal_scale_control(sessions):
    sys_a, _, sys_c = sessions
    res = tmerge.merge_maps(sys_a, sys_c, max_pairs=4, min_inliers=15)
    assert np.abs(np.median(res.scales) - 1.0) < 0.02
    assert np.std(res.scales) < 0.02
