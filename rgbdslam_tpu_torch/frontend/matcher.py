"""Descriptor matching with the reference Matcher's gates (port of
rgbdslam_tpu/frontend/matcher.py; Features/Matcher.cpp:106-139).

2-NN Hamming matching of frame-1 (query) against frame-2 (train)
descriptors, Lowe ratio test, mutual-nearest train dedup, and validity
gates. On CUDA the 2-NN and the column best come from kernel K2, which
never builds the N x M distance matrix, and the gates from a second kernel.
"""

from __future__ import annotations

import dataclasses

import torch

from rgbdslam_tpu_torch.frontend.frame import FrameFeatures
from rgbdslam_tpu_torch.ops import kernels


@dataclasses.dataclass
class MatchResult:
    """Matches from frame1 (ref/query) into frame2 (cur/train), N1 slots."""

    idx2: torch.Tensor    # (N1,) i32 matched index in frame2
    dist: torch.Tensor    # (N1,) i32 Hamming distance
    valid: torch.Tensor   # (N1,) bool match survives all gates

    @property
    def num_matches(self) -> torch.Tensor:
        return torch.sum(self.valid)


def match_descriptors(desc1: torch.Tensor, valid1: torch.Tensor,
                      desc2: torch.Tensor, valid2: torch.Tensor,
                      ratio: float = 0.9) -> MatchResult:
    """2-NN ratio + mutual-nearest matching on packed descriptors: (i -> j)
    is kept iff j is i's nearest train, i is j's nearest query, the Lowe
    ratio passes and both ends are valid (a pair with an invalid end has
    distance BIG, so `best < BIG` gates valid2[j] as well as valid1[i]).
    Kernel K2 and the gate kernel for CUDA tensors (two launches), their
    plain version for CPU tensors. The query side may carry a leading batch
    dimension ((B, N1, 8), (B, N1)) against one train set: the same two
    launches for all."""
    if desc1.dtype.is_floating_point:
        raise NotImplementedError("float (L2) descriptors are not yet ported")
    if kernels.on_cuda(desc1, desc2):
        idx2, dist, valid = kernels.match_gated(
            desc1.contiguous(), desc2.contiguous(), valid1.contiguous(),
            valid2.contiguous(), ratio)
    else:
        idx2, dist, valid = kernels.match_gated_ref(desc1, desc2, valid1, valid2, ratio)
    return MatchResult(idx2=idx2, dist=dist, valid=valid)


def match_frames(f1: FrameFeatures, f2: FrameFeatures, ratio: float = 0.9) -> MatchResult:
    """Matcher::match over FrameFeatures: both endpoints must be valid
    observations (detected + valid depth, Features/Matcher.cpp:130): the
    train side's validity at idx2 is implied by the matcher's `best < BIG`."""
    return match_descriptors(f1.desc, f1.obs_valid, f2.desc, f2.obs_valid, ratio)


def correspondence_weights(p1: torch.Tensor, p2: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    """Fit weights 1/(z1*z2) for matched 3-D pairs, zero where invalid
    (Solver/SolverSE3.cpp:174)."""
    z1 = torch.clamp_min(p1[..., 2], 1e-6)
    z2 = torch.clamp_min(p2[..., 2], 1e-6)
    return torch.where(valid, 1.0 / (z1 * z2), 0.0)


def gather_matched_points(f1: FrameFeatures, f2: FrameFeatures, m: MatchResult):
    """(p1 [N,3], p2 [N,3], w [N], valid [N]) — the RANSAC inputs."""
    p1 = f1.xyz
    p2 = f2.xyz[m.idx2.long()]
    return p1, p2, correspondence_weights(p1, p2, m.valid), m.valid
