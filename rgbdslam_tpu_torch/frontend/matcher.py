"""Descriptor matching with the reference Matcher's gates (port of
rgbdslam_tpu/frontend/matcher.py; Features/Matcher.cpp:106-139).

2-NN matching of frame-1 (query) against frame-2 (train) descriptors, Lowe
ratio test, mutual-nearest train dedup, and validity gates. Binary
descriptors use Hamming distance: on CUDA the 2-NN and the column best come
from kernel K2, which never builds the N x M distance matrix, and the gates
from a second kernel. Float (SIFT/SURF-class) descriptors use L2 distance
as tensor code, as the reference picks NORM_L2 from the descriptor type
(Features/Matcher.cpp:16).
"""

from __future__ import annotations

import dataclasses

import torch

from rgbdslam_tpu_torch.frontend.frame import FrameFeatures
from rgbdslam_tpu_torch.ops import hamming
from rgbdslam_tpu_torch.ops import image as image_ops
from rgbdslam_tpu_torch.ops import kernels


@dataclasses.dataclass
class MatchResult:
    """Matches from frame1 (ref/query) into frame2 (cur/train), N1 slots."""

    idx2: torch.Tensor    # (N1,) i32 matched index in frame2
    dist: torch.Tensor    # (N1,) i32 Hamming distance (f32 L2 distance)
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
    launches for all. Float descriptors take `match_descriptors_l2`."""
    if desc1.dtype.is_floating_point:
        return match_descriptors_l2(desc1, valid1, desc2, valid2, ratio)
    if kernels.on_cuda(desc1, desc2):
        idx2, dist, valid = kernels.match_gated(
            desc1.contiguous(), desc2.contiguous(), valid1.contiguous(),
            valid2.contiguous(), ratio)
    else:
        idx2, dist, valid = kernels.match_gated_ref(desc1, desc2, valid1, valid2, ratio)
    return MatchResult(idx2=idx2, dist=dist, valid=valid)


def match_descriptors_l2(desc1: torch.Tensor, valid1: torch.Tensor,
                         desc2: torch.Tensor, valid2: torch.Tensor,
                         ratio: float = 0.9) -> MatchResult:
    """L2 2-NN + ratio + mutual-nearest on float descriptors (JAX
    matcher.py:84-112): squared distances |a|^2 + |b|^2 - 2 a.b (the product
    by one matmul, the norms by pairwise-tree sums, square roots correctly
    rounded), floored at 0, 1e12
    where either end is invalid; the ratio test on distances (d < r * d2nd).
    The query side may carry a leading batch dimension. dist is the L2
    distance (f32)."""
    big = 1e12
    n1 = image_ops.tree_sum(desc1 * desc1)                   # (..., N1)
    n2 = image_ops.tree_sum(desc2 * desc2)                   # (N2,)
    cross = desc1 @ desc2.transpose(-1, -2)                  # (..., N1, N2)
    d2 = torch.clamp_min(n1[..., :, None] + n2[..., None, :] - 2.0 * cross, 0.0)
    d2 = torch.where(valid1[..., :, None] & valid2[..., None, :], d2, big)
    best_idx = torch.argmin(d2, dim=-1)
    best = torch.gather(d2, -1, best_idx[..., None])[..., 0]
    cols = torch.arange(d2.shape[-1], device=d2.device)
    second = torch.amin(torch.where(cols == best_idx[..., None], big, d2), dim=-1)
    ratio_ok = image_ops.sqrt_rn(best) < ratio * image_ops.sqrt_rn(second)
    col_best = torch.argmin(d2, dim=-2)                      # (..., N2)
    rows = torch.arange(d2.shape[-2], device=d2.device)
    mutual = torch.gather(col_best, -1, best_idx) == rows
    valid = ratio_ok & mutual & valid1 & (best < big)
    return MatchResult(idx2=best_idx.to(torch.int32), dist=image_ops.sqrt_rn(best), valid=valid)


def match_frames(f1: FrameFeatures, f2: FrameFeatures, ratio: float = 0.9) -> MatchResult:
    """Matcher::match over FrameFeatures: both endpoints must be valid
    observations (detected + valid depth, Features/Matcher.cpp:130): the
    train side's validity at idx2 is implied by the matcher's `best < BIG`."""
    return match_descriptors(f1.desc, f1.obs_valid, f2.desc, f2.obs_valid, ratio)


def projection_match(f1: FrameFeatures, f2: FrameFeatures, T21: torch.Tensor, cam,
                     radius: float = 15.0, th_high: int = 100) -> MatchResult:
    """Projection-guided matching (Matcher::projectionMatch,
    Features/Matcher.cpp:35-104): frame-1 points projected into frame 2 by
    T21 (4, 4) (frame-1 camera coordinates to frame-2 camera coordinates),
    each matched to the frame-2 keypoint of least Hamming distance within
    `radius` pixels, kept at distance <= `th_high` and when mutual (the
    reference's first-come train dedup, order-free). The reference walks a
    spatial hash grid per keypoint; here the window query is a dense masked
    (N1, N2) distance matrix from `ops.hamming` (its matmul form), as in the
    JAX package, first index on ties. No host read."""
    q = f1.xyz @ T21[:3, :3].T + T21[:3, 3]                       # (N1, 3) in camera 2
    z = torch.clamp_min(q[:, 2], 1e-6)
    u = cam.fx * q[:, 0] / z + cam.cx
    v = cam.fy * q[:, 1] / z + cam.cy
    proj_ok = (f1.obs_valid & (q[:, 2] > 0) & (u >= 0) & (u <= cam.width - 1)
               & (v >= 0) & (v <= cam.height - 1))
    duv = torch.stack([u, v], dim=-1)[:, None, :] - f2.uv_undist[None, :, :]
    in_window = torch.sum(duv * duv, dim=-1) <= radius * radius    # (N1, N2)
    d = hamming.hamming_distance_matrix(f1.desc, f2.desc, proj_ok, f2.obs_valid,
                                        impl="matmul")
    d = torch.where(in_window, d, hamming.BIG_DIST)
    best_idx = torch.argmin(d, dim=1)
    best_dist = torch.gather(d, 1, best_idx[:, None])[:, 0]
    col_best = torch.argmin(d, dim=0)
    rows = torch.arange(d.shape[0], device=d.device)
    valid = proj_ok & (col_best[best_idx] == rows) & (best_dist <= th_high)
    return MatchResult(idx2=best_idx.to(torch.int32), dist=best_dist, valid=valid)


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
