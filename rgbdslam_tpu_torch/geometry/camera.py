"""Pinhole RGB-D camera model on torch tensors (port of
rgbdslam_tpu/geometry/camera.py).

The camera is a frozen dataclass of floats; operations are plain functions
over (..., 2) pixel and (..., 3) point tensors. Intrinsics tables mirror
IO/DatasetTUM.cpp:61-89, IO/DatasetICL.cpp:37-39, IO/DatasetCORBS.cpp:37-39.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Camera:
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    depth_factor: float = 5000.0   # raw depth / factor = meters (Core/Frame.cpp:48)
    width: int = 640
    height: int = 480
    min_depth: float = 0.1         # validity gate (Solver/Ransac.cpp:72-83)
    max_depth: float = 6.0

    @property
    def has_distortion(self) -> bool:
        return any(abs(v) > 0 for v in (self.k1, self.k2, self.k3, self.p1, self.p2))


TUM_FR1 = Camera(517.306408, 516.469215, 318.643040, 255.313989,
                 k1=0.262383, k2=-0.953104, k3=1.163314, p1=-0.005358, p2=0.002628,
                 depth_factor=5000.0)
TUM_FR2 = Camera(520.908620, 521.007327, 325.141442, 249.701764,
                 k1=0.231222, k2=-0.784899, k3=0.917205, p1=-0.003257, p2=-0.000105,
                 depth_factor=5208.0)
TUM_FR3 = Camera(535.4, 539.2, 320.1, 247.6, depth_factor=5000.0)
ICL_NUIM = Camera(481.20, -480.0, 319.5, 239.5, depth_factor=5000.0)
CORBS = Camera(468.60, 468.61, 318.27, 243.99, depth_factor=5000.0)
SYNTHETIC = Camera(525.0, 525.0, 319.5, 239.5, depth_factor=5000.0)


def undistort_normalized(cam: Camera, xd: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Invert the radial-tangential model by fixed-point iteration
    (cv::undistortPoints semantics, Core/Frame.cpp:251-281)."""
    if not cam.has_distortion:
        return xd
    x = xd
    for _ in range(iters):
        xk, yk = x[..., 0], x[..., 1]
        r2 = xk * xk + yk * yk
        radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        dx = 2.0 * cam.p1 * xk * yk + cam.p2 * (r2 + 2.0 * xk * xk)
        dy = cam.p1 * (r2 + 2.0 * yk * yk) + 2.0 * cam.p2 * xk * yk
        x = torch.stack([(xd[..., 0] - dx) / radial, (xd[..., 1] - dy) / radial], dim=-1)
    return x


def undistort_pixels(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Distorted pixel coords (..., 2) -> undistorted pixel coords (..., 2)."""
    xn = torch.stack(
        [(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy], dim=-1
    )
    xu = undistort_normalized(cam, xn)
    return torch.stack(
        [xu[..., 0] * cam.fx + cam.cx, xu[..., 1] * cam.fy + cam.cy], dim=-1
    )


def unproject(cam: Camera, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Undistorted pixel coords (..., 2) + metric depth (...,) -> camera 3D (..., 3)
    (RGBDcamera::unproject, Core/RGBDcamera.cpp:126-161)."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def valid_depth(cam: Camera, depth: torch.Tensor) -> torch.Tensor:
    """Depth validity mask (finite, within (min_depth, max_depth))."""
    return torch.isfinite(depth) & (depth > cam.min_depth) & (depth < cam.max_depth)


def camera_from_dict(d: dict) -> Camera:
    """Camera from a plain dict/JSON (the reference's unused YAML camera
    loader, System/Utility.cpp:37-64, as a format-agnostic equivalent)."""
    return Camera(
        fx=float(d["fx"]), fy=float(d["fy"]),
        cx=float(d["cx"]), cy=float(d["cy"]),
        k1=float(d.get("k1", 0.0)), k2=float(d.get("k2", 0.0)),
        k3=float(d.get("k3", 0.0)), p1=float(d.get("p1", 0.0)),
        p2=float(d.get("p2", 0.0)),
        depth_factor=float(d.get("depth_factor", 5000.0)),
        width=int(d.get("width", 640)), height=int(d.get("height", 480)),
    )


def load_camera(path: str) -> Camera:
    """Load a camera from a JSON file."""
    import json

    with open(path) as f:
        return camera_from_dict(json.load(f))
