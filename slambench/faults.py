"""Faults planted in the program underneath a run, each where its answer is
produced: the benchmark's tests and `calibrate.py` see `correct` come out
false under each. A plant takes `setattr(obj, name, value)`, such as
pytest's `monkeypatch.setattr`, and replaces one function of the program.
"""

from __future__ import annotations

import dataclasses

import torch


def identity_estimate(setattr_):
    """Every frame-to-frame estimate returns the identity: the state never
    moves."""
    from rgbdslam_tpu_torch.slam import tracking

    real = tracking.fused_estimate

    def unchanged(*a, **k):
        row = real(*a, **k).clone()
        row[:16] = torch.eye(4, dtype=row.dtype, device=row.device).reshape(16)
        return row

    setattr_(tracking, "fused_estimate", unchanged)


def half_batch(setattr_):
    """Each batch's completion returns the poses of its first half only."""
    from rgbdslam_tpu_torch.slam.system import SlamSystem

    real = SlamSystem.track_batch_complete
    setattr_(SlamSystem, "track_batch_complete",
             lambda self, h: real(self, h)[: max(1, h["B"] // 2)])


def descriptor_bit(setattr_):
    """One descriptor bit of every frame's first slot flipped as it is
    built."""
    from rgbdslam_tpu_torch.frontend import extractor

    real = extractor.build_frame_features

    def altered(*a, **k):
        f = real(*a, **k)
        desc = f.desc.clone()
        desc[0, 0] ^= 1
        f.desc = desc
        return f

    setattr_(extractor, "build_frame_features", altered)


def match_altered(setattr_):
    """The keyframe backend's matcher answers every query with the next
    train slot's index."""
    from rgbdslam_tpu_torch.slam import system

    real = system.match_descriptors

    def altered(*a, **k):
        m = real(*a, **k)
        return dataclasses.replace(m, idx2=(m.idx2 + 1) % m.idx2.shape[-1])

    setattr_(system, "match_descriptors", altered)


def solve_unchanged(setattr_):
    """Every pose-graph solve returns the poses it was given."""
    from rgbdslam_tpu_torch.solvers.pose_graph import PoseGraph

    setattr_(PoseGraph, "optimize", lambda self, iterations=10: self.Twc[:self.n_vertices])


def dense_skipped(setattr_):
    """The dense-ICP polish returns the estimate it was given."""
    from rgbdslam_tpu_torch.slam import tracking

    setattr_(tracking, "dense_polish", lambda cam, cfg, est, d_prev, depth: est)


#: name -> (plant, the number it must fail)
FAULTS = {"identity_estimate": (identity_estimate, "ate_median_m"),
          "half_batch": (half_batch, "frames_missing"),
          "descriptor_bit": (descriptor_bit, "feature_mismatch"),
          "match_altered": (match_altered, "match_mismatch"),
          "solve_unchanged": (solve_unchanged, "solve_gap"),
          "dense_skipped": (dense_skipped, "dense_fixpoint_m")}
