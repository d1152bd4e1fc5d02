"""The benchmark's scenes: ground-truth trajectories, frames ray cast on the
device, and Kinect-class sensor noise.

A frozen copy of the renderer the program ships (its synthetic dataset), so
that a change to the program cannot change the inputs it is measured on.
Plain torch; nothing of the program is imported.
"""

from __future__ import annotations

import numpy as np
import torch

ROOM_HALF = (3.0, 2.0, 3.0)
MULTIROOM_HALF = (6.0, 2.0, 3.0)
MULTIROOM_BOXES = np.array(
    [
        [[-0.1, -2.0, -3.0], [0.1, 2.0, -0.7]],
        [[-0.1, -2.0, 0.7], [0.1, 2.0, 3.0]],
        [[-5.6, -2.0, 1.9], [-4.7, -0.4, 2.7]],
        [[-5.4, -2.0, -2.7], [-4.6, -0.9, -2.0]],
        [[-2.3, -2.0, -2.8], [-1.7, 0.6, -2.2]],
        [[4.6, -2.0, 1.8], [5.4, -0.3, 2.6]],
        [[4.8, -2.0, -2.7], [5.6, -1.0, -1.9]],
        [[1.7, -2.0, 2.2], [2.3, 0.5, 2.8]],
    ],
    dtype=np.float32,
)
_M32 = 0xFFFFFFFF


def look_at_pose(eye: np.ndarray, target: np.ndarray, up=(0.0, -1.0, 0.0)) -> np.ndarray:
    """Twc with camera z pointing at `target` (x right, y down, z forward)."""
    z = target - eye
    z = z / np.linalg.norm(z)
    up = np.asarray(up, dtype=np.float64)
    x = np.cross(-up, z)
    if np.linalg.norm(x) < 1e-6:
        x = np.cross(np.array([0.0, 0.0, 1.0]), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    T = np.eye(4, dtype=np.float32)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x, y, z, eye
    return T


def tour_trajectory(n_frames: int, loops: float = 1.0) -> np.ndarray:
    """A figure-eight through both rooms of the multi-room world, crossing
    the doorway twice a revolution; `loops` > 1 revisits the start, so the
    keyframe backend can close a loop. Twc (N, 4, 4)."""
    poses = []
    for i in range(n_frames):
        a = 2.0 * np.pi * loops * i / n_frames
        eye = np.array([4.2 * np.sin(a), 0.25 * np.sin(2 * a), 1.6 * np.sin(2 * a)])
        tangent = np.array([4.2 * np.cos(a), 0.5 * np.cos(2 * a), 3.2 * np.cos(2 * a)])
        tangent /= np.linalg.norm(tangent)
        poses.append(look_at_pose(eye, eye + tangent))
    return np.stack(poses)


def sweep_trajectory(n_frames: int, span: float = 1.6, one_way: bool = False) -> np.ndarray:
    """A lateral sweep facing one wall of the single room: there and back,
    or with `one_way` a single pass from one end to the other, easing in and
    out. Twc (N, 4, 4)."""
    poses = []
    for i in range(n_frames):
        if one_way:
            s = np.sin(0.5 * np.pi * (2.0 * i / (n_frames - 1) - 1.0))
        else:
            s = np.sin(2 * np.pi * i / n_frames)
        eye = np.array([span * s, 0.2 * np.sin(4 * np.pi * i / n_frames), -1.0])
        target = np.array([0.6 * span * s, 0.0, float(ROOM_HALF[2])])
        poses.append(look_at_pose(eye, target))
    return np.stack(poses)


#: trajectory kind -> (poses(n_frames, **params), room half-extents, solid boxes)
TRAJECTORIES = {
    "tour": (tour_trajectory, MULTIROOM_HALF, MULTIROOM_BOXES),
    "sweep": (sweep_trajectory, ROOM_HALF, None),
}


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _hash3(ix, iy, iz, seed: int) -> torch.Tensor:
    h = (_mul32(ix & _M32, 0x8DA6B343) + _mul32(iy & _M32, 0xD8163841)
         + _mul32(iz & _M32, 0xCB1AB31F) + ((seed * 0x9E3779B9) & _M32)) & _M32
    h = h ^ (h >> 13)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 16)
    return h.to(torch.float32) * (1.0 / 4294967296.0)


def _blocky_noise(p: torch.Tensor, freq: float, seed: int) -> torch.Tensor:
    q = torch.floor(p * freq).to(torch.int64)
    return _hash3(q[..., 0], q[..., 1], q[..., 2], seed)


def texture(p: torch.Tensor) -> torch.Tensor:
    return (0.45 * _blocky_noise(p, 2.0, 1) + 0.30 * _blocky_noise(p, 5.0, 2)
            + 0.18 * _blocky_noise(p, 11.0, 3) + 0.07 * _blocky_noise(p, 23.0, 4))


def render_frame(sensor: dict, Twc: np.ndarray, room_half, boxes, device):
    """Ray cast one frame of a box room with solid boxes: (gray (H, W) f32 in
    [0, 255], depth (H, W) f32 metres along the camera's z) on `device`.
    `sensor`: width, height, fx, fy, cx, cy of a pinhole camera."""
    h, w = sensor["height"], sensor["width"]
    Twc = torch.as_tensor(np.asarray(Twc, dtype=np.float32), device=device)
    vv, uu = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device),
                            indexing="ij")
    x = (uu - sensor["cx"]) * (1.0 / sensor["fx"])
    y = (vv - sensor["cy"]) * (1.0 / sensor["fy"])
    R, o = Twc[:3, :3], Twc[:3, 3]
    d_world = torch.stack([x * R[i, 0] + y * R[i, 1] + R[i, 2] for i in range(3)], dim=-1)
    half = torch.as_tensor(room_half, dtype=torch.float32, device=device)
    t_best = torch.full((h, w), float("inf"), dtype=torch.float32, device=device)
    for axis in range(3):
        for sign in (-1.0, 1.0):
            denom = d_world[..., axis]
            t = (sign * half[axis] - o[axis]) / torch.where(torch.abs(denom) < 1e-9, 1e-9,
                                                            denom)
            hit = o + t[..., None] * d_world
            ok = t > 1e-3
            for other in range(3):
                if other != axis:
                    ok = ok & (torch.abs(hit[..., other]) <= half[other] + 1e-4)
            t_best = torch.where(ok & (t < t_best), t, t_best)
    if boxes is not None:
        bx = torch.as_tensor(boxes, dtype=torch.float32, device=device)
        inv_d = 1.0 / torch.where(torch.abs(d_world) < 1e-9, 1e-9, d_world)
        t0 = (bx[:, 0] - o) * inv_d[..., None, :]
        t1 = (bx[:, 1] - o) * inv_d[..., None, :]
        t_near = torch.amax(torch.minimum(t0, t1), dim=-1)
        t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
        hit_box = (t_near < t_far) & (t_near > 1e-3)
        t_best = torch.minimum(t_best, torch.amin(torch.where(hit_box, t_near, float("inf")),
                                                  dim=-1))
    depth = torch.where(torch.isfinite(t_best), t_best, 0.0)
    hit_pts = (o.double() + t_best.double()[..., None] * d_world.double()).float()
    gray = torch.clamp(30.0 + 210.0 * texture(hit_pts) * (1.0 / (1.0 + 0.05 * depth)),
                       0.0, 255.0)
    gray = torch.where(depth > 0, gray, 0.0)
    return gray, depth


def add_sensor_noise(gray, depth, noise: dict, generator: torch.Generator):
    """Kinect-class corruption drawn from `generator` on the images' device:
    grey shot noise (`sigma_gray`), depth noise sigma_z = `depth_coeff` z^2
    (Khoshelham and Elberink's Kinect model) and dropout of a `dropout`
    share of the pixels to 0."""
    kw = {"generator": generator, "dtype": torch.float32, "device": gray.device}
    n_gray = torch.randn(gray.shape, **kw)
    n_depth = torch.randn(depth.shape, **kw)
    u_drop = torch.rand(depth.shape, **kw)
    g = torch.clamp(gray + noise["sigma_gray"] * n_gray, 0.0, 255.0)
    d = depth + noise["depth_coeff"] * depth * depth * n_depth
    d = torch.where((u_drop < noise["dropout"]) | (depth <= 0), 0.0, torch.clamp_min(d, 0.0))
    return g, d
