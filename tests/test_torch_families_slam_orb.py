"""Serial full SLAM of the ORB family of rgbdslam_tpu_torch against
rgbdslam_tpu (the x1.2, 8-level scale space, steered BRIEF, the shipped ORB
vocabulary) over the tour's first 12 frames at 320x240 with 512 features,
and the last frame's features of both runs: the tests of
tests/test_torch_families_slam.py for another family. The JAX run's
detector goes through its plain reference (tests/test_torch_families_build.py
holds the port's K1 against the Pallas kernel itself).
"""

import jax
import pytest

from rgbdslam_tpu.ops import fast as jfast

import test_torch_families_slam as base
from test_torch_families_slam import (frames,  # noqa: F401
                                      test_family_last_frame_features_match_jax,
                                      test_family_slam_matches_jax)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True, scope="module")
def _jax_detector_through_its_plain_reference():
    """The JAX builds run the Pallas detector through its plain reference,
    masked_score_map(use_pallas=False): the XLA composition that the JAX
    package's tests (tests/test_pallas_detect.py) hold the kernel to, at
    about a third of interpret mode's compile time. The jitted programs
    traced meanwhile are dropped afterwards."""
    orig = jfast.masked_score_map

    def plain(img, fast_threshold, use_fast_gate=True, use_pallas=True):
        return orig(img, fast_threshold, use_fast_gate, use_pallas=False)

    jfast.masked_score_map = plain
    yield
    jfast.masked_score_map = orig
    jax.clear_caches()


@pytest.fixture(scope="module", params=["orb"])
def runs(request, frames):  # noqa: F811
    return base._family_run(request.param, frames)
