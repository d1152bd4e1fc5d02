"""Plain reference of dense projective point-to-plane ICP between two depth
maps (the noisy-sensor preset's polish of each frame-to-frame estimate):
every reference pixel moved by T, projected into the current frame, and
held to the plane of the current point it lands on, over strided
subsamplings of the maps. Gauss-Newton on left increments in float32, the
stated precision, with a 1e-5 damping.

The benchmark runs it from the program's own result at the program's
finest level: a result the program polished is a fixed point of this
iteration, and one it did not polish moves."""

from __future__ import annotations

import torch

from slambench.reference import geometry


def points(cam: dict, depth: torch.Tensor) -> torch.Tensor:
    """(H, W) metres -> (H, W, 3) backprojected; no depth gives z = 0."""
    h, w = depth.shape
    vv, uu = torch.meshgrid(torch.arange(h, dtype=depth.dtype, device=depth.device),
                            torch.arange(w, dtype=depth.dtype, device=depth.device),
                            indexing="ij")
    x = (uu - cam["cx"]) * (1.0 / cam["fx"]) * depth
    y = (vv - cam["cy"]) * (1.0 / cam["fy"]) * depth
    return torch.stack([x, y, depth], dim=-1)


def normals(cam: dict, depth: torch.Tensor):
    """Points and camera-facing normals from central differences; a normal
    is zero without depth or across a jump of 0.3 m or more."""
    p = points(cam, depth)
    dx, dy = torch.zeros_like(p), torch.zeros_like(p)
    dx[:, 1:-1] = p[:, 2:] - p[:, :-2]
    dy[1:-1, :] = p[2:, :] - p[:-2, :]
    n = torch.linalg.cross(dx, dy, dim=-1)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp_min(norm, 1e-12)
    n = torch.where(torch.sum(n * p, dim=-1, keepdim=True) > 0, -n, n)
    ok = ((depth > 0) & (norm[..., 0] > 1e-9) & (torch.linalg.norm(dx, dim=-1) < 0.3)
          & (torch.linalg.norm(dy, dim=-1) < 0.3))
    return p, torch.where(ok[..., None], n, 0.0)


def scaled(cam: dict, s: int) -> dict:
    return {"fx": cam["fx"] / s, "fy": cam["fy"] / s, "cx": cam["cx"] / s,
            "cy": cam["cy"] / s, "width": cam["width"] // s, "height": cam["height"] // s}


def refine(cam: dict, depth_ref: torch.Tensor, depth_cur: torch.Tensor, T: torch.Tensor,
           stride: int, iters: int, max_dist: float = 0.3) -> torch.Tensor:
    """`iters` Gauss-Newton steps of T (ref camera -> current camera) on the
    maps subsampled by `stride`."""
    c = scaled(cam, stride)
    d_ref, d_cur = depth_ref[::stride, ::stride], depth_cur[::stride, ::stride]
    h, w = d_ref.shape
    src = points(c, d_ref).reshape(-1, 3)
    src_ok = (d_ref > 0).reshape(-1)
    p_cur, n_cur = normals(c, d_cur)
    cur_ok = ((p_cur[..., 2] > 0) & (torch.sum(n_cur * n_cur, dim=-1) > 0.5)).reshape(-1)
    p_cur, n_cur = p_cur.reshape(-1, 3), n_cur.reshape(-1, 3)
    damp = 1e-5 * torch.eye(6, dtype=T.dtype, device=T.device)
    for _ in range(iters):
        q = src @ T[:3, :3].T + T[:3, 3]
        z = torch.clamp_min(q[:, 2], 1e-6)
        u = c["fx"] * q[:, 0] / z + c["cx"]
        v = c["fy"] * q[:, 1] / z + c["cy"]
        inb = (src_ok & (q[:, 2] > 0.05) & (u >= 0) & (v >= 0) & (u <= c["width"] - 1)
               & (v <= c["height"] - 1))
        pix = torch.where(inb, torch.round(v) * w + torch.round(u), 0.0).to(torch.int64)
        pc, nc = p_cur[pix], n_cur[pix]
        d = q - pc
        r = torch.sum(d * nc, dim=-1)
        wm = (inb & cur_ok[pix] & (torch.linalg.norm(d, dim=-1) < max_dist)).to(T.dtype)
        J = torch.cat([nc, torch.linalg.cross(q, nc, dim=-1)], dim=-1)
        H = (J * wm[:, None]).T @ J
        g = (J * wm[:, None]).T @ r
        xi = -torch.linalg.solve(H + damp, g)
        T = geometry.exp(xi) @ T
    return T
