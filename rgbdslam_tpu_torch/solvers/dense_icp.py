"""Dense projective ICP odometry: coarse-to-fine point-to-plane on depth maps
(port of rgbdslam_tpu/solvers/dense_icp.py).

The reference refines with PCL GICP over sparse matched keypoints
(Solver/Gicp.cpp); this is the dense-depth equivalent (SURVEY.md section 7,
layer 6). RGB-D gives projective data association for free, no k-d tree:

  for each reference pixel: p_ref -> q = T p_ref -> project into the current
  frame -> read the current point and normal at that pixel -> point-to-plane
  residual n . (q - p_cur).

Normals come from depth-map central differences (the cross product of the
backprojected tangents). The Gauss-Newton normal equations reduce over all
pixels with one matrix product; the levels run coarse first over strided
subsamplings of the depth maps (nearest-neighbour subsampling keeps depth
edges crisp). Everything is enqueued on the device: the 6x6 solve reports
no error to the host and the trust gate is a `where`, so a call never waits
for the device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from rgbdslam_tpu_torch.geometry import se3
from rgbdslam_tpu_torch.geometry.camera import Camera, depth_to_points


def scaled_camera(cam: Camera, scale: int) -> Camera:
    """Camera for a 1/scale resolution level."""
    return dataclasses.replace(
        cam, fx=cam.fx / scale, fy=cam.fy / scale, cx=cam.cx / scale, cy=cam.cy / scale,
        width=cam.width // scale, height=cam.height // scale)


def depth_normals(cam: Camera, depth: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backprojected points (H, W, 3) and normals (H, W, 3) from central
    differences. Normals face the camera (dot(n, p) <= 0); they are zero
    where the depth is missing or a neighbour jumps by 0.3 m or more."""
    pts = depth_to_points(cam, depth)
    dx = torch.zeros_like(pts)
    dy = torch.zeros_like(pts)
    dx[:, 1:-1] = pts[:, 2:] - pts[:, :-2]
    dy[1:-1, :] = pts[2:, :] - pts[:-2, :]
    n = torch.linalg.cross(dx, dy, dim=-1)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp_min(norm, 1e-12)
    flip = torch.sum(n * pts, dim=-1, keepdim=True) > 0
    n = torch.where(flip, -n, n)
    valid = ((depth > 0) & (norm[..., 0] > 1e-9)
             # depth-edge rejection: neighbour jumps kill the normal estimate
             & (torch.linalg.norm(dx, dim=-1) < 0.3)
             & (torch.linalg.norm(dy, dim=-1) < 0.3))
    return pts, torch.where(valid[..., None], n, 0.0)


@functools.lru_cache()
def _level_constants(cam_l: Camera, device: torch.device):
    """Per level and device, made once: the focal lengths and principal
    point as (2,) rows, the in-bounds limits, the 1e-5 damping."""
    f = torch.tensor([cam_l.fx, cam_l.fy], dtype=torch.float32, device=device)
    c = torch.tensor([cam_l.cx, cam_l.cy], dtype=torch.float32, device=device)
    lim = torch.tensor([cam_l.width - 1, cam_l.height - 1], dtype=torch.float32,
                       device=device)
    return f, c, lim, 1e-5 * torch.eye(6, dtype=torch.float32, device=device)


def _icp_level(cam_l: Camera, d_ref: torch.Tensor, d_cur: torch.Tensor,
               T_init: torch.Tensor, iters: int, max_dist: float) -> torch.Tensor:
    p_ref = depth_to_points(cam_l, d_ref)                  # (H, W, 3)
    p_cur, n_cur = depth_normals(cam_l, d_cur)
    h, w = d_ref.shape
    src = p_ref.reshape(-1, 3)
    src_valid = (d_ref > 0).reshape(-1)
    # what a reference point reads at its pixel, gathered in one lookup:
    # the current point, its normal, and whether the pixel has depth and a
    # normal
    cur_ok = (p_cur[..., 2] > 0) & (torch.sum(n_cur * n_cur, dim=-1) > 0.5)
    table = torch.cat([p_cur, n_cur, cur_ok[..., None].to(p_cur.dtype)],
                      dim=-1).reshape(-1, 7)
    f, c, lim, damp = _level_constants(cam_l, d_ref.device)
    T = T_init
    for _ in range(iters):
        q = src @ T[:3, :3].T + T[:3, 3]                   # (N, 3)
        z = torch.clamp_min(q[:, 2], 1e-6)
        uv = f * q[:, :2] / z[:, None] + c
        inb = (src_valid & (q[:, 2] > 0.05) & torch.all(uv >= 0, dim=-1)
               & torch.all(uv <= lim, dim=-1))
        # the pixel jnp.round (half to even) picks: in bounds it lies in the
        # image, so no clamp is needed; out of bounds (a NaN pose included)
        # pixel 0 is read and gated out
        r_uv = torch.round(uv)
        pix = torch.where(inb, r_uv[:, 1] * w + r_uv[:, 0], 0.0).to(torch.int64)
        cur = table.index_select(0, pix)
        pc, nc = cur[:, :3], cur[:, 3:6]
        d = q - pc
        r = torch.sum(d * nc, dim=-1)
        wm = (inb & (cur[:, 6] > 0.5) & (torch.linalg.norm(d, dim=-1) < max_dist)).to(T.dtype)
        J = torch.cat([nc, torch.linalg.cross(q, nc, dim=-1)], dim=-1)   # (N, 6)
        A = (J * wm[:, None]).T @ torch.cat([J, r[:, None]], dim=-1)    # [H | g] (6, 7)
        # no error check: a singular system gives a non-finite pose, which
        # the gate in dense_icp turns back into T_init
        xi = -torch.linalg.solve_ex(A[:, :6] + damp, A[:, 6:], check_errors=False)[0][:, 0]
        T = se3.exp(xi) @ T
    return T


def dense_icp(cam: Camera, depth_ref: torch.Tensor, depth_cur: torch.Tensor,
              T_init: torch.Tensor, levels: Tuple[int, ...] = (4, 2),
              iters_per_level: int = 10, max_dist: float = 0.3,
              max_correction: Tuple[float, float] = (0.5, 0.6)) -> torch.Tensor:
    """Estimate T21 (ref-camera -> cur-camera coordinates) by coarse-to-fine
    projective point-to-plane ICP on the depth maps' device. `levels` are
    subsampling factors, coarse first. A result that moved more than
    `max_correction` (translation m, rotation rad) from `T_init`, or is not
    finite, is divergence, not refinement: `T_init` comes back instead
    (decided on the device). Callers with a good warm start (the tracker's
    polish) pass a tight bound.

    On a card the ~2,000 small launches of a call are captured once per
    shape and configuration as a CUDA graph and replayed: the same kernels
    on the same inputs, launched by the device instead of the host."""
    args = (cam, tuple(levels), iters_per_level, max_dist, tuple(max_correction))
    if depth_ref.is_cuda:
        return _graphed(args, tuple(depth_ref.shape), depth_ref.device)(depth_ref, depth_cur,
                                                                         T_init)
    return _dense_icp(*args, depth_ref, depth_cur, T_init)


class _GraphedIcp:
    """`_dense_icp` for one configuration and shape as a CUDA graph over
    static input and output buffers: a call copies its inputs in, replays
    the graph and copies the result out."""

    def __init__(self, args, shape, device):
        self.inputs = [torch.zeros(shape, device=device), torch.zeros(shape, device=device),
                       torch.eye(4, device=device)]
        # warm-up on a side stream first (the library handles and cached
        # constants are made there, outside the capture)
        side = torch.cuda.Stream(device=device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            _dense_icp(*args, *self.inputs)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.output = _dense_icp(*args, *self.inputs)

    def __call__(self, depth_ref, depth_cur, T_init):
        for buf, x in zip(self.inputs, (depth_ref, depth_cur, T_init)):
            buf.copy_(x)
        self.graph.replay()
        return self.output.clone()


@functools.lru_cache(maxsize=None)
def _graphed(args, shape, device) -> _GraphedIcp:
    """The graph of one configuration, image shape and card, captured at its
    first call (the capture waits for the card once)."""
    return _GraphedIcp(args, shape, device)


def _dense_icp(cam: Camera, levels: Tuple[int, ...], iters_per_level: int, max_dist: float,
               max_correction: Tuple[float, float], depth_ref: torch.Tensor,
               depth_cur: torch.Tensor, T_init: torch.Tensor) -> torch.Tensor:
    T = T_init
    for s in levels:
        T = _icp_level(scaled_camera(cam, s), depth_ref[::s, ::s], depth_cur[::s, ::s], T,
                       iters_per_level, max_dist)
    delta = se3.inverse(T_init) @ T
    ok = (torch.isfinite(T).all() & (se3.translation_norm(delta) < max_correction[0])
          & (se3.rotation_angle(delta) < max_correction[1]))
    return torch.where(ok, T, T_init)
