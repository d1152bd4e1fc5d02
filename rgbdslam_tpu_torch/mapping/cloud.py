"""Per-keyframe point clouds as fixed-shape tensor programs (port of
rgbdslam_tpu/mapping/cloud.py).

The Frame cloud stack (Core/Frame.cpp:475-608 + the keyframe recipe in
System/Tracking.cpp:234-237): createCloud(stride) -> pass-through z filter
-> voxel-grid downsample -> statistical outlier removal -> world transform.
PCL's dynamically sized clouds become fixed-budget point arrays with
validity masks; the voxel filter is a stable sort by voxel key + segment
mean; SOR's k-NN mean distances come from a masked dense distance matrix.
Everything runs on the tensors' device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rgbdslam_tpu_torch.geometry import se3
from rgbdslam_tpu_torch.geometry.camera import Camera

INT32_MAX = 2**31 - 1


class Cloud(NamedTuple):
    xyz: torch.Tensor        # (M, 3)
    intensity: torch.Tensor  # (M,) grey value (the reference keeps RGB,
                             #   Core/Frame.cpp:497-500)
    valid: torch.Tensor      # (M,) bool

    @property
    def count(self):
        return torch.sum(self.valid)


def create_cloud(cam: Camera, gray: torch.Tensor, depth: torch.Tensor, stride: int = 6,
                 z_min: float = 0.5, z_max: float = 4.0) -> Cloud:
    """Strided depth-image backprojection + pass-through z filter
    (Frame::createCloud(res) + passThroughFilter, Core/Frame.cpp:475-549)."""
    d = depth[::stride, ::stride]
    g = gray[::stride, ::stride]
    h, w = d.shape
    vv, uu = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=d.device) * stride,
        torch.arange(w, dtype=torch.float32, device=d.device) * stride,
        indexing="ij")
    # XLA folds the JAX package's division by the (compile-time) focal
    # length into a product with its f32 reciprocal: the same rounding here
    rfx = float(np.float32(1.0) / np.float32(cam.fx))
    rfy = float(np.float32(1.0) / np.float32(cam.fy))
    x = (uu - cam.cx) * rfx * d
    y = (vv - cam.cy) * rfy * d
    pts = torch.stack([x, y, d], dim=-1)
    valid = (d > z_min) & (d < z_max) & torch.isfinite(d)
    return Cloud(xyz=pts.reshape(-1, 3), intensity=g.reshape(-1), valid=valid.reshape(-1))


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d rounded as one IEEE division on every device. A CUDA tensor
    divided by a Python float is multiplied by the float's f32 reciprocal
    instead, which rounds differently near integers, where floor() then
    picks the neighbouring voxel; the JAX package divides (its voxel size
    and resolution are traced scalars)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def voxel_key(pts: torch.Tensor, voxel: float) -> torch.Tensor:
    """The JAX package's int32 key (q0 << 20) ^ (q1 << 10) ^ q2 of the voxel
    indices q + 2^15. The shifts overflow int32 there, which wraps in two's
    complement; here they run in int64 and the result wraps to int32
    explicitly (XOR keeps the low 32 bits of each operand). The voxel size
    divides as a device scalar (`true_div`)."""
    q = torch.floor(true_div(pts, voxel)).to(torch.int64) + 2**15
    key = (q[..., 0] << 20) ^ (q[..., 1] << 10) ^ q[..., 2]
    key = key & 0xFFFFFFFF
    return torch.where(key > INT32_MAX, key - 2**32, key).to(torch.int32)


def voxel_downsample(cloud: Cloud, max_points: int, voxel: float = 0.04) -> Cloud:
    """Voxel-grid centroid downsample (Frame::downsampleCloud,
    Core/Frame.cpp:517-525): a stable sort by voxel key, then segment means,
    into a fixed output budget. Keys, order and counts are exact; each
    voxel's centroid and intensity sums add its points in sorted order."""
    pts = cloud.xyz
    key = torch.where(cloud.valid, voxel_key(pts, voxel),
                      torch.tensor(INT32_MAX, dtype=torch.int32, device=pts.device))
    key_s, order = torch.sort(key, stable=True)
    pts_s = pts[order]
    int_s = cloud.intensity[order]
    valid_s = cloud.valid[order]

    first = torch.ones((1,), dtype=torch.bool, device=pts.device)
    starts = torch.cat([first, key_s[1:] != key_s[:-1]]) & valid_s
    seg = torch.cumsum(starts.to(torch.int64), 0) - 1      # segment id per point
    seg = torch.where(valid_s, seg, max_points - 1)
    seg = torch.clamp_max(seg, max_points - 1)

    # segment sums by index_put_(accumulate=True): on a card it sorts the
    # indices and adds each segment's values in their order, so the sums
    # are the same from run to run (float atomics would not be)
    w = valid_s.to(pts.dtype)
    z = pts.new_zeros((max_points,))
    sums = pts.new_zeros((max_points, 3)).index_put_((seg,), pts_s * w[:, None],
                                                     accumulate=True)
    ints = z.clone().index_put_((seg,), int_s * w, accumulate=True)
    counts = z.clone().index_put_((seg,), w, accumulate=True)
    centroid = sums / torch.clamp_min(counts[:, None], 1.0)
    inten = ints / torch.clamp_min(counts, 1.0)
    n_voxels = torch.sum(starts)
    out_valid = (torch.arange(max_points, device=pts.device) < n_voxels) & (counts > 0)
    return Cloud(xyz=centroid, intensity=inten, valid=out_valid)


def statistical_outlier_removal(cloud: Cloud, k: int = 50, std_mul: float = 1.0) -> Cloud:
    """PCL StatisticalOutlierRemoval semantics (Frame::statisticalFilterCloud,
    Core/Frame.cpp:527-536): mean distance to the k nearest neighbours; drop
    points whose mean exceeds the global mean + std_mul * std. Invalid
    pairs and the diagonal carry the JAX package's 1e12 sentinel."""
    pts = cloud.xyz
    diff = pts[:, None, :] - pts[None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    del diff
    big = 1e12
    mask = cloud.valid[:, None] & cloud.valid[None, :]
    d2 = torch.where(mask, d2, big)
    d2.fill_diagonal_(big)
    near, _ = torch.topk(d2, k, dim=-1, largest=False)
    knn_d = torch.sqrt(torch.clamp_min(near, 0.0))
    knn_valid = near < big * 0.5
    mean_d = (torch.sum(knn_d * knn_valid, dim=-1)
              / torch.clamp_min(torch.sum(knn_valid, dim=-1), 1))
    wm = cloud.valid.to(pts.dtype)
    n = torch.clamp_min(torch.sum(wm), 1.0)
    mu = torch.sum(mean_d * wm) / n
    var = torch.sum((mean_d - mu) ** 2 * wm) / n
    thresh = mu + std_mul * torch.sqrt(var)
    keep = cloud.valid & (mean_d <= thresh)
    return Cloud(xyz=cloud.xyz, intensity=cloud.intensity, valid=keep)


def transform_cloud(cloud: Cloud, Twc: torch.Tensor) -> Cloud:
    """Camera frame -> world frame (Frame::cloudToWorld, Core/Frame.cpp:551-608)."""
    return Cloud(xyz=se3.transform_points(Twc, cloud.xyz), intensity=cloud.intensity,
                 valid=cloud.valid)


def keyframe_cloud(cam: Camera, gray: torch.Tensor, depth: torch.Tensor, stride: int = 6,
                   z_min: float = 0.5, z_max: float = 4.0, voxel: float = 0.04,
                   sor_k: int = 50, sor_std: float = 1.0, max_points: int = 4096) -> Cloud:
    """The full keyframe cloud recipe (System/Tracking.cpp:234-237)."""
    c = create_cloud(cam, gray, depth, stride, z_min, z_max)
    c = voxel_downsample(c, max_points, voxel)
    return statistical_outlier_removal(c, sor_k, sor_std)
