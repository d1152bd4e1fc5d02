"""Procedural synthetic RGB-D sequences with ground truth, rendered on the
device (port of rgbdslam_tpu/io/synthetic.py).

Frames of a textured box room are ray cast in float32; the texture is
multi-frequency blocky value noise from an integer lattice hash. The hash's uint32 multiply-wrap
arithmetic runs in int64, split into 16-bit halves so no product leaves the
int64 range, and masked to 32 bits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from rgbdslam_tpu_torch.device import resolve_device
from rgbdslam_tpu_torch.geometry.camera import SYNTHETIC, Camera, undistort_normalized

ROOM_HALF = (3.0, 2.0, 3.0)           # box half-extents (x, y, z)

# The multi-room world: a 12 x 4 x 6 m shell split by a doorway wall, with
# solid crates and pillars in each room (occlusion boundaries, depth
# discontinuities, and loop closures that pass through a different place).
MULTIROOM_HALF = (6.0, 2.0, 3.0)
MULTIROOM_BOXES = np.array(
    [
        # dividing wall at x ~ 0, full height, doorway gap |z| < 0.7
        [[-0.1, -2.0, -3.0], [0.1, 2.0, -0.7]],
        [[-0.1, -2.0, 0.7], [0.1, 2.0, 3.0]],
        # room A (x < 0): corner crates + a pillar
        [[-5.6, -2.0, 1.9], [-4.7, -0.4, 2.7]],
        [[-5.4, -2.0, -2.7], [-4.6, -0.9, -2.0]],
        [[-2.3, -2.0, -2.8], [-1.7, 0.6, -2.2]],
        # room B (x > 0): crates + a pillar
        [[4.6, -2.0, 1.8], [5.4, -0.3, 2.6]],
        [[4.8, -2.0, -2.7], [5.6, -1.0, -1.9]],
        [[1.7, -2.0, 2.2], [2.3, 0.5, 2.8]],
    ],
    dtype=np.float32,
)
_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a in [0, 2^32) (int64), without int64 overflow."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _hash3(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor, seed: int) -> torch.Tensor:
    """Integer lattice hash -> [0, 1) float32 (the JAX uint32 hash, bit for bit)."""
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
    """World-space texture in [0, 1]: multi-scale blocky noise."""
    return (0.45 * _blocky_noise(p, 2.0, 1) + 0.30 * _blocky_noise(p, 5.0, 2)
            + 0.18 * _blocky_noise(p, 11.0, 3) + 0.07 * _blocky_noise(p, 23.0, 4))


def render_frame(cam: Camera, Twc, device="cuda", room_half=None, boxes=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ray-cast one frame of the box room: (gray [H, W] f32 in [0, 255],
    depth [H, W] f32 meters along camera z) on `device` (the card unless
    the caller asks for the CPU; a CUDA request without a card raises). Twc:
    camera-to-world (4, 4). room_half: shell half-extents (default
    ROOM_HALF); boxes: optional (Nb, 2, 3) solid boxes [min, max] inside the
    shell (the multi-room world)."""
    dev = resolve_device(device)
    Twc = torch.as_tensor(np.asarray(Twc, dtype=np.float32), device=dev)
    h, w = cam.height, cam.width
    vv, uu = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    # XLA divides by a constant as a multiply by its reciprocal; so does this
    xn = torch.stack([(uu - cam.cx) * (1.0 / cam.fx), (vv - cam.cy) * (1.0 / cam.fy)],
                     dim=-1)
    if cam.has_distortion:
        xn = undistort_normalized(cam, xn)
    R = Twc[:3, :3]
    o = Twc[:3, 3]
    # d_cam @ R.T with d_cam = (x, y, 1), as separate f32 multiplies and adds:
    # the same bits as XLA's dot on the CPU, and on every device (a BLAS
    # matmul sums in its own order, and cuBLAS with FMAs)
    x, y = xn[..., 0], xn[..., 1]
    d_world = torch.stack([x * R[i, 0] + y * R[i, 1] + R[i, 2] for i in range(3)], dim=-1)
    half = torch.as_tensor(ROOM_HALF if room_half is None else room_half,
                           dtype=torch.float32, device=dev)

    t_best = torch.full((h, w), float("inf"), dtype=torch.float32, device=dev)
    for axis in range(3):
        for sign in (-1.0, 1.0):
            bound = sign * half[axis]
            denom = d_world[..., axis]
            t = (bound - o[axis]) / torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
            hit = o + t[..., None] * d_world
            ok = t > 1e-3
            for other in range(3):
                if other != axis:
                    ok = ok & (torch.abs(hit[..., other]) <= half[other] + 1e-4)
            t_best = torch.where(ok & (t < t_best), t, t_best)

    if boxes is not None:
        # solid boxes, slab method: the entry distance where the ray has
        # crossed all three slabs (the camera is outside every solid)
        bx = torch.as_tensor(np.asarray(boxes, dtype=np.float32), device=dev)
        inv_d = 1.0 / torch.where(torch.abs(d_world) < 1e-9, 1e-9, d_world)
        t0 = (bx[:, 0] - o) * inv_d[..., None, :]            # (H, W, Nb, 3)
        t1 = (bx[:, 1] - o) * inv_d[..., None, :]
        t_near = torch.amax(torch.minimum(t0, t1), dim=-1)   # (H, W, Nb)
        t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
        hit_box = (t_near < t_far) & (t_near > 1e-3)
        t_box = torch.amin(torch.where(hit_box, t_near, float("inf")), dim=-1)
        t_best = torch.minimum(t_best, t_box)

    depth = torch.where(torch.isfinite(t_best), t_best, 0.0)
    # Walls lie on texel boundaries (e.g. z = 3 m at 2 texels/m), so the
    # texel of a wall hit depends on the last bit of o + t*d. Computed in
    # float64 and rounded once, as a fused multiply-add would (XLA's CPU
    # code does), it gives the same texels on every device.
    hit_pts = (o.double() + t_best.double()[..., None] * d_world.double()).float()
    shade = texture(hit_pts)
    gray = torch.clamp(30.0 + 210.0 * shade * (1.0 / (1.0 + 0.05 * depth)), 0.0, 255.0)
    gray = torch.where(depth > 0, gray, 0.0)
    return gray, depth


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


def orbit_trajectory(n_frames: int, radius: float = 1.2, height_amp: float = 0.25,
                     loops: float = 1.0) -> np.ndarray:
    """A smooth closed orbit inside the room, looking outward. Twc [N, 4, 4]."""
    poses = []
    for i in range(n_frames):
        a = 2.0 * np.pi * loops * i / n_frames
        eye = np.array([radius * np.cos(a), height_amp * np.sin(2 * a), radius * np.sin(a)])
        look_dir = np.array([-np.sin(a), 0.15 * np.cos(2 * a), np.cos(a)])
        poses.append(look_at_pose(eye, eye + look_dir))
    return np.stack(poses)


def tour_trajectory(n_frames: int, loops: float = 1.0) -> np.ndarray:
    """A figure-eight tour through both rooms of the multi-room world,
    crossing the doorway (x = 0) at z = 0 twice per revolution: the loop
    closure case where the revisited place was left for a different one in
    between. Twc [N, 4, 4]."""
    poses = []
    for i in range(n_frames):
        a = 2.0 * np.pi * loops * i / n_frames
        eye = np.array([4.2 * np.sin(a), 0.25 * np.sin(2 * a), 1.6 * np.sin(2 * a)])
        tangent = np.array([4.2 * np.cos(a), 0.5 * np.cos(2 * a), 3.2 * np.cos(2 * a)])
        tangent /= np.linalg.norm(tangent)
        poses.append(look_at_pose(eye, eye + tangent))
    return np.stack(poses)


def sweep_trajectory(n_frames: int, span: float = 1.6) -> np.ndarray:
    """A back-and-forth lateral sweep facing one wall — the odometry case."""
    poses = []
    for i in range(n_frames):
        s = np.sin(2 * np.pi * i / n_frames)
        eye = np.array([span * s, 0.2 * np.sin(4 * np.pi * i / n_frames), -1.0])
        target = np.array([0.6 * span * s, 0.0, float(ROOM_HALF[2])])
        poses.append(look_at_pose(eye, target))
    return np.stack(poses)


def kinect_noise_fields(seed: int, i: int, height: int, width: int):
    """The three standard fields of frame `i`'s sensor noise drawn on the
    host with numpy (`default_rng((seed, i))`): grey normal, depth normal,
    dropout uniform, each (height, width) f32. Any package can replay them
    through `apply_sensor_noise`."""
    rng = np.random.default_rng((seed, i))
    return (rng.standard_normal((height, width), dtype=np.float32),
            rng.standard_normal((height, width), dtype=np.float32),
            rng.random((height, width), dtype=np.float32))


def apply_sensor_noise(cam: Camera, gray: torch.Tensor, depth: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       n_gray=None, n_depth=None, u_drop=None):
    """Kinect-class sensor corruption (JAX synthetic.py:240-263):

    - image shot noise (sigma 2 grey levels),
    - depth noise sigma_z = 0.0015 z^2, Khoshelham & Elberink's measured
      Kinect model (the reference's RANSAC gate over-estimates it as
      0.01 z^2, Solver/SolverSE3.cpp:289-297),
    - depth dropout (3 % of pixels -> 0, like IR shadowing).

    The standard normal fields `n_gray`, `n_depth` and the uniform field
    `u_drop` (H, W) are drawn from `generator` on the images' device, or
    injected (tensors or host arrays), so the same noisy pixels can be
    replayed elsewhere. `cam` is unused (the JAX signature)."""
    fields = (n_gray, n_depth, u_drop)
    if all(f is None for f in fields):
        if generator is None:
            raise ValueError("apply_sensor_noise needs a generator or the three fields")
        kw = {"generator": generator, "dtype": torch.float32, "device": gray.device}
        fields = (torch.randn(gray.shape, **kw), torch.randn(depth.shape, **kw),
                  torch.rand(depth.shape, **kw))
    elif any(f is None for f in fields):
        raise ValueError("inject all three noise fields or none")
    n_gray, n_depth, u_drop = (torch.as_tensor(f, dtype=torch.float32).to(gray.device)
                               for f in fields)
    g = torch.clamp(gray + 2.0 * n_gray, 0.0, 255.0)
    sigma_z = 0.0015 * depth * depth
    d = depth + sigma_z * n_depth
    dropout = u_drop < 0.03
    d = torch.where(dropout | (depth <= 0), 0.0, torch.clamp_min(d, 0.0))
    return g, d


class SyntheticDataset:
    """Dataset over the renderer: grab(i) -> (timestamp, gray [H,W] f32,
    depth [H,W] f32 meters) as tensors on `device` (the card unless the
    caller asks for the CPU); ground truth in
    `.poses_twc`. With `noise`, frames carry the Kinect-class noise of
    `apply_sensor_noise`, drawn from a generator seeded by (seed, i): the
    same frame is the same noisy frame on every call."""

    name = "SYNTH"

    def __init__(self, n_frames: int = 120, cam: Camera = SYNTHETIC,
                 trajectory: str = "orbit", fps: float = 30.0,
                 loops: float = 1.0, noise: bool = False, seed: int = 0, device="cuda"):
        self.cam = cam
        self.fps = fps
        self.noise = noise
        self._seed = seed
        self.device = resolve_device(device)
        self._room_half = None
        self._boxes = None
        if trajectory == "orbit":
            self.poses_twc = orbit_trajectory(n_frames, loops=loops)
        elif trajectory == "sweep":
            self.poses_twc = sweep_trajectory(n_frames)
        elif trajectory == "tour":
            self.poses_twc = tour_trajectory(n_frames, loops=loops)
            self._room_half = MULTIROOM_HALF
            self._boxes = MULTIROOM_BOXES
        else:
            raise ValueError(f"unknown trajectory {trajectory!r}")
        self.timestamps = np.arange(n_frames, dtype=np.float64) / fps

    def __len__(self) -> int:
        return len(self.poses_twc)

    def grab(self, i: int):
        gray, depth = render_frame(self.cam, self.poses_twc[i], device=self.device,
                                   room_half=self._room_half, boxes=self._boxes)
        if self.noise:
            # a 32-bit seed mixed from (seed, i): the CPU generator keeps 32 bits
            mixed = int(np.random.SeedSequence((self._seed, i)).generate_state(1)[0])
            gen = torch.Generator(device=self.device).manual_seed(mixed)
            gray, depth = apply_sensor_noise(self.cam, gray, depth, gen)
        return self.timestamps[i], gray, depth
