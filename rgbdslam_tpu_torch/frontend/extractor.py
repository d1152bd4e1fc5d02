"""Extractor factory: detector variants + ADAPTIVE threshold feedback (port
of rgbdslam_tpu/frontend/extractor.py; Features/Extractor.{h,cpp}).

Only the live FAST + Shi-Tomasi + upright BRIEF path is ported: the
variants 'svo_fast', 'fast' and 'brief' (aliases of one another). The other
reference factory types raise "not yet ported".

ADAPTIVE mode: the FAST threshold is adjusted from the previous detection's
keypoint count with the reference's x0.7 / x1.3 rule
(Features/DetectorAdjuster.cpp:45-57).
"""

from __future__ import annotations

import torch

from rgbdslam_tpu_torch.config import ExtractorConfig
from rgbdslam_tpu_torch.frontend.frame import FrameFeatures, build_frame_features
from rgbdslam_tpu_torch.geometry.camera import Camera


class Extractor:
    # name -> (response, use_fast_gate, descriptor)
    VARIANTS = {
        "svo_fast": ("fast_st", True, "brief"),
        "fast": ("fast_st", True, "brief"),
        "brief": ("fast_st", True, "brief"),
    }
    NOT_PORTED = ("orb", "orb2", "gftt", "star", "brisk", "freak", "latch",
                  "sift", "surf")
    DETECTORS = tuple(VARIANTS)

    def __init__(
        self,
        cam: Camera,
        cfg: ExtractorConfig = ExtractorConfig(),
        detector: str = "svo_fast",
        adaptive: bool = False,
        target_min: int | None = None,   # default: cfg.adapt_target_min
        target_max: int | None = None,   # (Features/Extractor.cpp:95 band)
        th_min: float | None = None,
        th_max: float | None = None,
    ):
        if detector in self.NOT_PORTED:
            raise NotImplementedError(
                f"detector {detector!r} is not yet ported (one of {self.DETECTORS})")
        if detector not in self.DETECTORS:
            raise ValueError(f"unknown detector {detector!r}; one of {self.DETECTORS}")
        self.cam = cam
        self.cfg = cfg
        self.detector = detector
        self.adaptive = adaptive
        self.target_min = cfg.adapt_target_min if target_min is None else target_min
        self.target_max = cfg.adapt_target_max if target_max is None else target_max
        self.th_min = cfg.adapt_th_min if th_min is None else th_min
        self.th_max = cfg.adapt_th_max if th_max is None else th_max
        self.threshold = float(cfg.fast_threshold)
        self.reads = 0       # device-to-host reads made by the retry loop

    def build(self, gray: torch.Tensor, depth: torch.Tensor, threshold) -> FrameFeatures:
        """Feature build at a given FAST threshold (a float, or a 0-dim f32
        tensor on the tensors' device), on the tensors' device."""
        return build_frame_features(self.cam, gray, depth, self.cfg,
                                    descriptor=self.VARIANTS[self.detector][2],
                                    fast_threshold=threshold)

    def adapt(self, num_valid: int) -> None:
        """DetectorAdjuster::tooFew/tooMany (x0.7 / x1.3, clamped) threshold
        feedback from a detection's keypoint count."""
        if not self.adaptive:
            return
        if num_valid < self.target_min:
            self.threshold = max(self.threshold * 0.7, self.th_min)
        elif num_valid > self.target_max:
            self.threshold = min(self.threshold * 1.3, self.th_max)

    def adapt_on_device(self, threshold: torch.Tensor, num_valid: torch.Tensor
                        ) -> torch.Tensor:
        """`adapt` as tensor code, for the batched tracker's scan: the next
        threshold (0-dim f32) from a detection's keypoint count (0-dim f32),
        both on the device and never read back. The rule runs in f32, as the
        JAX scan runs it. Only the FAST gate takes a threshold."""
        if not (self.adaptive and self.VARIANTS[self.detector][1]):
            return threshold
        lower = torch.clamp_min(threshold * 0.7, self.th_min)
        higher = torch.clamp_max(threshold * 1.3, self.th_max)
        return torch.where(num_valid < self.target_min, lower,
                           torch.where(num_valid > self.target_max, higher, threshold))

    def __call__(self, gray: torch.Tensor, depth: torch.Tensor) -> FrameFeatures:
        f = self.build(gray, depth, self.threshold)
        if not self.adaptive:
            return f
        # within-frame retry loop (<=5 detections,
        # VideoDynamicAdaptedFeatureDetector.cpp:24-44): re-detect at the
        # lowered threshold until the count enters the band. Only the
        # too-few direction re-runs; the N-slot budget caps over-detection.
        for _ in range(5):
            before = self.threshold
            n_valid = int(f.valid.sum())     # one device-to-host read per round
            self.reads += 1
            self.adapt(n_valid)
            if n_valid >= self.target_min or self.threshold >= before - 1e-9:
                break
            f = self.build(gray, depth, self.threshold)
        return f
