"""Per-frame feature build into a fixed-shape set of tensors (port of
rgbdslam_tpu/frontend/frame.py; Core/Frame.cpp:34-122).

pyramid -> FAST/Shi-Tomasi grid detection (K1 on CUDA) -> blur -> upright
BRIEF-256 -> depth lookup/denoise -> undistortion -> unprojection -> depth
patch covariances, under a fixed N-keypoint budget with validity masks.
Only the default path is ported: the half-sample pyramid
(scale_factor=2.0), the `fast_st` response and the `brief` descriptor.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from rgbdslam_tpu_torch.config import ExtractorConfig
from rgbdslam_tpu_torch.geometry import camera as cam_mod
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.ops import fast as fast_ops
from rgbdslam_tpu_torch.ops import image as image_ops
from rgbdslam_tpu_torch.ops import orb as orb_ops
from rgbdslam_tpu_torch.solvers.icp import depth_patch_covariances


@dataclasses.dataclass
class FrameFeatures:
    """Fixed-budget per-frame features (the device-side Frame,
    Core/Frame.h:24-216)."""

    uv: torch.Tensor          # (N, 2) f32 detected (distorted) pixel coords
    uv_undist: torch.Tensor   # (N, 2) f32 undistorted pixel coords
    xyz: torch.Tensor         # (N, 3) f32 camera-frame 3D (z=0 when no depth)
    desc: torch.Tensor        # (N, 8) int32 words of the 256-bit descriptor
    score: torch.Tensor       # (N,) f32 detector response
    level: torch.Tensor       # (N,) i32 pyramid level
    valid: torch.Tensor       # (N,) bool detected slot
    has_depth: torch.Tensor   # (N,) bool valid metric depth at the keypoint
    intensity: torch.Tensor   # (N,) f32 gray value at the keypoint
    smooth: torch.Tensor      # (N,) bool depth locally smooth (no occlusion edge)
    surf_cov: torch.Tensor    # (N, 3, 3) depth-patch surface covariance

    @property
    def num_slots(self) -> int:
        return self.uv.shape[0]

    @property
    def obs_valid(self) -> torch.Tensor:
        """Usable observation: detected and has depth (Frame::isValidObs)."""
        return self.valid & self.has_depth


def build_frame_features(cam: Camera, gray: torch.Tensor, depth: torch.Tensor,
                         cfg: ExtractorConfig = ExtractorConfig(),
                         descriptor: str = "brief",
                         fast_threshold=None) -> FrameFeatures:
    """gray [H, W] f32 (0..255), depth [H, W] f32 meters -> FrameFeatures,
    on the tensors' device. `fast_threshold` overrides cfg.fast_threshold
    (the ADAPTIVE extractor's feedback): a float, or a 0-dim f32 tensor on
    the frames' device, which is never read back to the host."""
    if cfg.scale_factor != 2.0:
        raise NotImplementedError("the x1.2 ORB scale space is not yet ported "
                                  "(scale_factor must be 2.0)")
    if descriptor != "brief":
        raise NotImplementedError(f"descriptor {descriptor!r} is not yet ported")
    if cfg.subpixel:
        raise NotImplementedError("subpixel refinement is not yet ported")
    pyramid = image_ops.build_pyramid(gray, cfg.num_levels)
    kp = fast_ops.detect_keypoints(
        pyramid,
        num_features=cfg.num_features,
        cell_size=cfg.cell_size,
        fast_threshold=cfg.fast_threshold if fast_threshold is None else fast_threshold,
        min_response=cfg.min_response,
        min_border=cfg.min_border,
    )
    blurred = image_ops.gaussian_blur(gray, sigma=2.0, radius=3)
    desc = orb_ops.brief_descriptors_dense(blurred, kp.uv, cfg.brief_patch_size)
    return _assemble_features(cam, gray, depth, kp, desc)


def _assemble_features(cam: Camera, gray, depth, kp, desc) -> FrameFeatures:
    """Feature-table tail: depth lookup/denoise, smoothness gate,
    undistortion, unprojection, intensity, surface covariances."""
    # depth at the detected (distorted) coords (Core/Frame.cpp:91-117);
    # unprojection uses the undistorted coords (Core/Frame.cpp:251-281)
    z_n = image_ops.nearest_sample(depth, kp.uv)
    has_depth = cam_mod.valid_depth(cam, z_n) & kp.valid
    # depth-edge test: 3x3 min/max range around the keypoint (+-inf padding)
    d4 = depth[None, None]
    zmax = F.max_pool2d(d4, 3, stride=1, padding=1)[0, 0]
    zmin = -F.max_pool2d(-d4, 3, stride=1, padding=1)[0, 0]
    zrange = image_ops.nearest_sample(zmax, kp.uv) - image_ops.nearest_sample(zmin, kp.uv)
    smooth = has_depth & (zrange <= 0.03 + 0.02 * z_n)
    # 3x3 valid-pixel mean depth on smooth surfaces; edges keep the center
    valid_px = (depth > 0).to(depth.dtype)
    zsum = image_ops.box_filter_sum(depth, 1)
    zcnt = image_ops.box_filter_sum(valid_px, 1)
    zmean = zsum / torch.clamp_min(zcnt, 1.0)
    z = torch.where(smooth, image_ops.nearest_sample(zmean, kp.uv), z_n)
    uv_undist = cam_mod.undistort_pixels(cam, kp.uv)
    z_safe = torch.where(has_depth, z, 0.0)
    xyz = cam_mod.unproject(cam, uv_undist, z_safe)
    intensity = image_ops.nearest_sample(gray, kp.uv)
    surf_cov = depth_patch_covariances(cam, depth, kp.uv)
    return FrameFeatures(
        uv=kp.uv, uv_undist=uv_undist, xyz=xyz, desc=desc, score=kp.score,
        level=kp.level, valid=kp.valid, has_depth=has_depth,
        intensity=intensity, smooth=smooth, surf_cov=surf_cov,
    )


def pack_features_for_host(f: FrameFeatures) -> torch.Tensor:
    """Everything the host-side keyframe store needs as one (N, 16) f32
    tensor, so the device-to-host copy is a single transfer. Layout:
    [uv_undist(2) | xyz(3) | desc(8, bit patterns) | intensity(1) |
    obs_valid(1) | smooth(1)]. The descriptor words cross as f32 bit
    patterns (a copy is bit-exact; the host views them back as uint32)."""
    return torch.cat(
        [
            f.uv_undist,
            f.xyz,
            f.desc.view(torch.float32),
            f.intensity[:, None],
            f.obs_valid[:, None].to(torch.float32),
            f.smooth[:, None].to(torch.float32),
        ],
        dim=1,
    )


def pack_features_slim(f: FrameFeatures) -> torch.Tensor:
    """Descriptor-free host packing, (N, 4): [uv_undist(2) | z(1) |
    4*round(intensity) + obs_valid + 2*smooth (1)]. The host rebuilds xyz
    from (uv_undist, z) with the pinhole unprojection the device used;
    descriptors stay in the device bank. The flag lane is at most 1023 and
    exact in f32."""
    flags = (4.0 * torch.round(torch.clamp(f.intensity, 0.0, 255.0))
             + f.obs_valid.to(torch.float32)
             + 2.0 * f.smooth.to(torch.float32))
    return torch.cat([f.uv_undist, f.xyz[:, 2:3], flags[:, None]], dim=1)
