"""Extractor factory: detector and descriptor variants + ADAPTIVE threshold
feedback (port of rgbdslam_tpu/frontend/extractor.py;
Features/Extractor.{h,cpp}).

The twelve reference factory types (Features/Extractor.h:13-26) map onto a
(response, FAST gate, descriptor) triple: 'svo_fast' / 'fast' / 'brief' the
live FAST + Shi-Tomasi + upright BRIEF path; 'orb' / 'orb2' the same
detection on the x1.2, 8-level scale space with steered BRIEF; 'gftt'
Shi-Tomasi without the FAST gate; 'star' a centre-surround response;
'brisk' / 'freak' / 'latch' FAST detection with their sampling patterns;
'sift' / 'surf' the DoG / box-Hessian responses with a 128-D float
descriptor, matched by L2.

ADAPTIVE mode: the FAST threshold is adjusted from the previous detection's
keypoint count with the reference's x0.7 / x1.3 rule
(Features/DetectorAdjuster.cpp:45-57); only variants with the FAST gate
take a threshold.
"""

from __future__ import annotations

import dataclasses

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
        "orb": ("fast_st", True, "orb"),
        "orb2": ("fast_st", True, "orb"),
        "gftt": ("fast_st", False, "brief"),
        "star": ("star", False, "brief"),
        "brisk": ("fast_st", True, "brisk"),
        "freak": ("fast_st", True, "freak"),
        "latch": ("fast_st", True, "latch"),
        "sift": ("dog", False, "sift"),
        "surf": ("hessian", False, "sift"),
    }
    DETECTORS = tuple(VARIANTS)
    # response magnitudes differ by orders of magnitude: the min_response
    # gate is scaled per response so one config value works for all
    RESPONSE_GATE_SCALE = {"fast_st": 1.0, "star": 0.05, "dog": 0.02, "hessian": 0.01}

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

    def _resolved(self):
        """(response, use_fast_gate, descriptor, cfg) with the variant's
        static adjustments: the response's gate scale, and for 'orb' /
        'orb2' the x1.2, 8-level scale space unless the config pins a
        non-default pyramid (Features/Extractor.cpp:21)."""
        response, use_fast_gate, descriptor = self.VARIANTS[self.detector]
        cfg = self.cfg
        gate = self.RESPONSE_GATE_SCALE[response]
        if gate != 1.0:
            cfg = dataclasses.replace(cfg, min_response=cfg.min_response * gate)
        if self.detector in ("orb", "orb2") and cfg.scale_factor == 2.0:
            cfg = dataclasses.replace(cfg, scale_factor=1.2, num_levels=8)
        return response, use_fast_gate, descriptor, cfg

    @property
    def uses_threshold(self) -> bool:
        """Whether the variant has the FAST gate (and so a threshold)."""
        return self.VARIANTS[self.detector][1]

    def build(self, gray: torch.Tensor, depth: torch.Tensor, threshold) -> FrameFeatures:
        """Feature build at a given FAST threshold (a float, or a 0-dim f32
        tensor on the tensors' device), on the tensors' device."""
        response, use_fast_gate, descriptor, cfg = self._resolved()
        return build_frame_features(self.cam, gray, depth, cfg, descriptor=descriptor,
                                    fast_threshold=threshold, use_fast_gate=use_fast_gate,
                                    response=response)

    def adapt(self, num_valid: int) -> None:
        """DetectorAdjuster::tooFew/tooMany (x0.7 / x1.3, clamped) threshold
        feedback from a detection's keypoint count; a variant without the
        FAST gate has no threshold to adapt."""
        if not (self.adaptive and self.uses_threshold):
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
        if not (self.adaptive and self.uses_threshold):
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
