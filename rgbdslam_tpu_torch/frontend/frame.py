"""Per-frame feature build into a fixed-shape set of tensors (port of
rgbdslam_tpu/frontend/frame.py; Core/Frame.cpp:34-122).

pyramid -> grid detection (K1 on CUDA) -> blur -> description -> depth
lookup/denoise -> undistortion -> unprojection -> depth patch covariances,
under a fixed N-keypoint budget with validity masks. Every variant of the
extractor factory: the half-sample pyramid (scale_factor=2.0) or the ORB
x1.2 scale space with per-level quotas, the `fast_st` response with or
without the FAST gate (GFTT) or the star / DoG / Hessian responses, and the
brief, orb, brisk, freak, latch (binary, (N, 8) int32) or sift (float,
(N, 128) f32) descriptors, with optional subpixel refinement.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from rgbdslam_tpu_torch.config import ExtractorConfig
from rgbdslam_tpu_torch.geometry import camera as cam_mod
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.ops import fast as fast_ops
from rgbdslam_tpu_torch.ops import image as image_ops
from rgbdslam_tpu_torch.ops import descriptors as desc_ops
from rgbdslam_tpu_torch.ops import orb as orb_ops
from rgbdslam_tpu_torch.solvers.icp import depth_patch_covariances


@dataclasses.dataclass
class FrameFeatures:
    """Fixed-budget per-frame features (the device-side Frame,
    Core/Frame.h:24-216)."""

    uv: torch.Tensor          # (N, 2) f32 detected (distorted) pixel coords
    uv_undist: torch.Tensor   # (N, 2) f32 undistorted pixel coords
    xyz: torch.Tensor         # (N, 3) f32 camera-frame 3D (z=0 when no depth)
    desc: torch.Tensor        # (N, 8) int32 words of a 256-bit descriptor,
                              # or (N, 128) f32 for the sift family
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
                         fast_threshold=None,
                         use_fast_gate: bool = True,
                         response: str = "fast_st") -> FrameFeatures:
    """gray [H, W] f32 (0..255), depth [H, W] f32 meters -> FrameFeatures,
    on the tensors' device. `fast_threshold` overrides cfg.fast_threshold
    (the ADAPTIVE extractor's feedback): a float, or a 0-dim f32 tensor on
    the frames' device, which is never read back to the host. With the FAST
    gate the final response gate scales with it (`fast.response_gate`).
    `use_fast_gate=False` gives the GFTT detector; `response`: 'fast_st' |
    'star' | 'dog' | 'hessian'; `descriptor`: 'brief' | 'orb' | 'brisk' |
    'freak' | 'latch' | 'sift'. cfg.scale_factor != 2.0 selects the
    fractional scale space."""
    thr = cfg.fast_threshold if fast_threshold is None else fast_threshold
    gate_thr = cfg.fast_threshold if (response == "fast_st" and use_fast_gate) else None
    if cfg.scale_factor != 2.0:
        kp, desc = _multiscale_detect_describe(gray, cfg, thr, gate_thr, use_fast_gate,
                                               descriptor, response)
    else:
        pyramid = image_ops.build_pyramid(gray, cfg.num_levels)
        kp = fast_ops.detect_keypoints(
            pyramid,
            num_features=cfg.num_features,
            cell_size=cfg.cell_size,
            fast_threshold=thr,
            min_response=cfg.min_response,
            min_border=cfg.min_border,
            use_fast_gate=use_fast_gate,
            subpixel=cfg.subpixel,
            response=response,
            gate_threshold=gate_thr,
        )
        blurred = image_ops.gaussian_blur(gray, sigma=2.0, radius=3)
        desc = _describe(blurred, gray, kp.uv, cfg, descriptor)
    return _assemble_features(cam, gray, depth, kp, desc)


def _describe(img_blurred, img_raw, uv, cfg: ExtractorConfig, descriptor: str):
    """Descriptor dispatch at the given image and coordinates (the level-0
    and the per-level paths share it)."""
    if descriptor == "brief":
        return orb_ops.brief_descriptors_dense(img_blurred, uv, cfg.brief_patch_size)
    if descriptor == "orb":
        return orb_ops.orb_descriptors_dense(img_blurred, img_raw, uv, cfg.brief_patch_size)[0]
    if descriptor in ("brisk", "freak"):
        return desc_ops.pattern_descriptors_dense(img_blurred, uv, descriptor,
                                                  cfg.brief_patch_size)
    if descriptor == "latch":
        # 3x3 block means: XLA's product with the f32 reciprocal of 9
        box3 = image_ops.box_filter_sum_xla(img_raw, 1) * float(fast_ops.f32_reciprocal(9.0))
        return desc_ops.latch_descriptors_dense(box3, uv, cfg.brief_patch_size)
    if descriptor == "sift":
        return desc_ops.sift_descriptors_dense(img_blurred, uv)
    raise ValueError(f"unknown descriptor {descriptor!r}")


@functools.lru_cache(maxsize=64)
def _slot_scales(quotas: tuple, scale_factor: float, device: torch.device) -> torch.Tensor:
    """Each slot's f32(scale_factor ** level) for the x1.2 slots in level
    order, written on `device` by fill kernels (no host wait) once per
    layout."""
    return torch.cat([torch.full((q,), float(np.float32(scale_factor ** lvl)),
                                 dtype=torch.float32, device=device)
                      for lvl, q in enumerate(quotas) if q > 0])


def _detect_per_level(pyramid, quotas, cell_size: int, thr, min_response, border: int,
                      use_fast_gate: bool = True, gate_thr=None, subpixel: bool = False,
                      response: str = "fast_st") -> fast_ops.Keypoints:
    """`fast.detect_keypoints_level` on each level with a positive quota,
    the slots in level order with their level: the x1.2 detection of the
    responses other than `fast_st`, in the arguments of
    `fast.detect_keypoints_scaled`."""
    gate = fast_ops.response_gate(min_response, thr, gate_thr)
    parts = [fast_ops.detect_keypoints_level(img_l, q, cell_size, thr, gate, border,
                                             use_fast_gate, response, subpixel)._replace(
                 level=torch.full((q,), lvl, dtype=torch.int32, device=img_l.device))
             for lvl, (img_l, q) in enumerate(zip(pyramid, quotas)) if q > 0]
    return fast_ops.Keypoints(*(torch.cat(f) for f in zip(*parts)))


def _multiscale_detect_describe(gray, cfg: ExtractorConfig, thr, gate_thr, use_fast_gate: bool,
                                descriptor: str, response: str, per_level: bool = False):
    """x`cfg.scale_factor` pyramid with per-level quotas (ORBextractor,
    Features/ORBextractor.cpp:347-419, 773-797): detect on every level (for
    `fast_st` the whole scale space at once, two launches of csrc/detect.cu
    on CUDA; `per_level` detects level by level instead, as the other
    responses do), describe each level's slots at its own resolution, then
    scale the coordinates to level 0 by each slot's f32(scale_factor **
    level). The N slots are the levels' quotas end to end."""
    pyramid = image_ops.build_scaled_pyramid(gray, cfg.num_levels, cfg.scale_factor)
    shapes = [tuple(p.shape) for p in pyramid]
    quotas = fast_ops.level_quotas(cfg.num_features, cfg.num_levels, cfg.scale_factor,
                                   cfg.cell_size, shapes)
    border = max(cfg.min_border, cfg.brief_patch_size // 2 + 1)
    args = (pyramid, quotas, cfg.cell_size, thr, cfg.min_response, border, use_fast_gate,
            gate_thr, cfg.subpixel)
    if response == "fast_st" and not per_level:
        kp = fast_ops.detect_keypoints_scaled(*args)
    else:
        kp = _detect_per_level(*args, response)
    descs, first = [], 0
    for img_l, q in zip(pyramid, quotas):
        if q <= 0:
            continue
        blurred_l = image_ops.gaussian_blur(img_l, sigma=2.0, radius=3)
        descs.append(_describe(blurred_l, img_l, kp.uv[first:first + q], cfg, descriptor))
        first += q
    uv = kp.uv * _slot_scales(tuple(quotas), cfg.scale_factor, gray.device)[:, None]
    return kp._replace(uv=uv), torch.cat(descs)


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
    """Everything the host-side keyframe store needs as one (N, 8 + D) f32
    tensor, so the device-to-host copy is a single transfer. Layout:
    [uv_undist(2) | xyz(3) | desc(D) | intensity(1) | obs_valid(1) |
    smooth(1)]: D = 8 binary words crossing as f32 bit patterns (a copy is
    bit-exact; the host views them back as uint32), or D = 128 floats."""
    desc = f.desc if f.desc.dtype.is_floating_point else f.desc.view(torch.float32)
    return torch.cat(
        [
            f.uv_undist,
            f.xyz,
            desc,
            f.intensity[:, None],
            f.obs_valid[:, None].to(torch.float32),
            f.smooth[:, None].to(torch.float32),
        ],
        dim=1,
    )


def to_device_rows(desc: np.ndarray, device) -> torch.Tensor:
    """Host descriptor rows (store, files, codebooks) as the device holds
    them: uint32 words as int32 bit patterns, float rows as f32."""
    from rgbdslam_tpu_torch.device import upload

    desc = np.ascontiguousarray(desc)
    if desc.dtype == np.uint32:
        desc = desc.view(np.int32)
    elif desc.dtype.kind == "f":
        desc = desc.astype(np.float32, copy=False)
    else:
        raise ValueError(f"descriptor rows of dtype {desc.dtype}: expected uint32 or float")
    return upload(desc, torch.device(device))


def to_host_rows(desc: torch.Tensor) -> np.ndarray:
    """Device descriptor rows on the host as the store and the files hold
    them (the JAX package's dtypes): int32 bit patterns as uint32 words,
    float rows as f32."""
    a = desc.cpu().numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


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
