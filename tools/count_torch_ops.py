"""Count the tensor ops the port's feature build runs for one frame.

  python tools/count_torch_ops.py [--width 640 --height 480] [--detector orb]

Runs the feature build of rgbdslam_tpu_torch (`Extractor.build` of the
detector's variant, svo_fast by default) once on the CPU on a rendered sweep
frame under a dispatch counter and prints, per part of the build (pyramid,
detection, blur, description, depth_patch_covariances, the rest of the
feature table), how many ops reached the dispatcher; views (ops whose result
aliases an input) are left out, since they launch nothing on a card. On a
CUDA tensor each counted op is at least one kernel launch, except in the
`fast_st` detection (the half-sample `detect_keypoints`, the x1.2
`detect_keypoints_scaled`), which is two launches there. The counts say
where the launches of a frame come from; they are not times.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from rgbdslam_tpu_torch.config import ExtractorConfig  # noqa: E402
from rgbdslam_tpu_torch.frontend import frame as frame_mod  # noqa: E402
from rgbdslam_tpu_torch.frontend.extractor import Extractor  # noqa: E402
from rgbdslam_tpu_torch.geometry.camera import Camera  # noqa: E402
from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset  # noqa: E402


class OpCounter(TorchDispatchMode):
    """Counts dispatched ops under the label that is current."""

    def __init__(self):
        super().__init__()
        self.label = "other"
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        returns = func._schema.returns
        is_view = any(r.alias_info is not None and not r.alias_info.is_write for r in returns)
        if not is_view:
            self.counts[self.label] += 1
        return func(*args, **(kwargs or {}))

    @contextlib.contextmanager
    def part(self, label):
        before, self.label = self.label, label
        try:
            yield
        finally:
            self.label = before


def labelled(counter, module, name, label):
    """Replace module.name by a wrapper that counts its ops under `label`;
    returns the original for restoring."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        with counter.part(label):
            return fn(*args, **kwargs)

    setattr(module, name, wrapper)
    return fn


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--detector", default="svo_fast", choices=Extractor.DETECTORS)
    a = ap.parse_args()
    f = 400.0 * a.width / 640
    cam = Camera(f, f, (a.width - 1) / 2, (a.height - 1) / 2, width=a.width, height=a.height)
    _, gray, depth = SyntheticDataset(n_frames=24, cam=cam, trajectory="sweep",
                                      device="cpu").grab(3)
    counter = OpCounter()
    parts = [(frame_mod.image_ops, "build_pyramid", "pyramid"),
             (frame_mod.image_ops, "build_scaled_pyramid", "x1.2 pyramid"),
             (frame_mod.fast_ops, "detect_keypoints", "detect_keypoints (plain version)"),
             (frame_mod.fast_ops, "detect_keypoints_scaled",
              "detect_keypoints_scaled (plain version)"),
             (frame_mod.image_ops, "gaussian_blur", "gaussian_blur"),
             (frame_mod, "_describe", "description"),
             (frame_mod, "depth_patch_covariances", "depth_patch_covariances")]
    ex = Extractor(cam, ExtractorConfig(), detector=a.detector)
    saved = [(m, n, labelled(counter, m, n, label)) for m, n, label in parts]
    try:
        with counter, counter.part("rest of the feature table"):
            ex.build(gray, depth, ExtractorConfig().fast_threshold)
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
    counts = dict(counter.counts)
    counts["total"] = sum(counts.values())
    print(json.dumps({"frame": [a.height, a.width], "detector": a.detector, "ops": counts}))


if __name__ == "__main__":
    main()
