"""Occupancy voxel mapping, the octomap replacement, as a dense log-odds grid
(port of rgbdslam_tpu/mapping/occupancy.py).

Drawer/OctomapDrawer.{h,cpp} keeps an octomap::ColorOcTree with per-KF ray
insertion and hit/miss updates (OctomapDrawer.cpp:15-79: res 0.08 m,
clamping 0.001/0.999, hit 0.9, miss 0.4). For bounded scenes a dense 3-D
log-odds grid does the same with one scatter per keyframe:

- rays are marched in fixed steps from the camera centre to each cloud
  point (free-space samples), endpoint voxels take the hit update;
- per scan each traversed voxel takes one miss and each endpoint voxel one
  hit, occupied winning over free (scatter-max of visited / occupied flags,
  octomap's insertPointCloud set semantics);
- colours (intensity here) are averaged per voxel like ColorOcTree
  (OctomapDrawer.cpp:60-68).

The npz layout of save_grid / load_grid is the JAX package's.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from rgbdslam_tpu_torch.mapping.cloud import Cloud, true_div


def _logit(p: float) -> float:
    return math.log(p / (1.0 - p))


class OccupancyGrid(NamedTuple):
    log_odds: torch.Tensor    # (Gx, Gy, Gz) f32
    color_sum: torch.Tensor   # (Gx, Gy, Gz) f32 intensity accumulator
    color_cnt: torch.Tensor   # (Gx, Gy, Gz) f32
    origin: torch.Tensor      # (3,) world coords of voxel (0,0,0)'s corner
    resolution: float

    @property
    def occupancy(self) -> torch.Tensor:
        return torch.sigmoid(self.log_odds)


def make_grid(bounds_min, bounds_max, resolution: float = 0.08,
              device="cuda") -> OccupancyGrid:
    """An empty grid over the bounds; cells per axis ceil((hi - lo) / res),
    in f32 as the JAX package computes them on the host."""
    lo = np.asarray(bounds_min, np.float32)
    hi = np.asarray(bounds_max, np.float32)
    dims = tuple(int(math.ceil((h - l) / resolution)) for l, h in zip(lo, hi))
    dev = torch.device(device)
    return OccupancyGrid(
        log_odds=torch.zeros(dims, dtype=torch.float32, device=dev),
        color_sum=torch.zeros(dims, dtype=torch.float32, device=dev),
        color_cnt=torch.zeros(dims, dtype=torch.float32, device=dev),
        origin=torch.as_tensor(lo, device=dev),
        resolution=resolution,
    )


def insert_cloud(grid: OccupancyGrid, world_cloud: Cloud, sensor_origin: torch.Tensor,
                 n_steps: int = 64, hit_p: float = 0.9, miss_p: float = 0.4,
                 clamp_min_p: float = 0.001, clamp_max_p: float = 0.999) -> OccupancyGrid:
    """Ray-integrate one world-frame keyframe cloud (OctomapDrawer::insertCloud,
    Drawer/OctomapDrawer.cpp:38-79; hit 0.9 :23, miss 0.4 :24, clamping
    0.001 / 0.999 :21-22). A ray sample within float rounding of a voxel
    face may land in the neighbouring voxel where the JAX package's
    contracted multiply-add lands it in this one."""
    res = grid.resolution
    dims = grid.log_odds.shape
    dev = grid.log_odds.device
    pts = world_cloud.xyz                          # (P, 3)
    valid = world_cloud.valid

    # free-space samples strictly inside the ray (the endpoint voxel excluded)
    ts = (torch.arange(n_steps, dtype=torch.float32, device=dev) + 0.5) / n_steps
    ray = pts[None, :, :] * ts[:, None, None] + sensor_origin[None, None, :] * (
        1.0 - ts[:, None, None])                   # (S, P, 3)
    dims_t = torch.tensor(dims, dtype=torch.int64, device=dev)

    def to_idx(p):
        q = torch.floor(true_div(p - grid.origin, res)).to(torch.int64)
        inb = torch.all((q >= 0) & (q < dims_t), dim=-1)
        qc = torch.minimum(torch.clamp_min(q, 0), dims_t - 1)
        flat = (qc[..., 0] * dims[1] + qc[..., 1]) * dims[2] + qc[..., 2]
        return flat, inb

    end_flat, end_inb = to_idx(pts)
    ray_flat, ray_inb = to_idx(ray)
    # a free-space sample in the endpoint voxel must not erase the hit
    ray_is_end = ray_flat == end_flat[None, :]

    lo = grid.log_odds.reshape(-1)
    miss_w = (ray_inb & valid[None, :] & ~ray_is_end).to(torch.float32)
    visited = torch.zeros_like(lo).scatter_reduce_(0, ray_flat.reshape(-1),
                                                   miss_w.reshape(-1), "amax")
    hit_w = (end_inb & valid).to(torch.float32)
    occupied = torch.zeros_like(lo).scatter_reduce_(0, end_flat, hit_w, "amax")

    lo = lo + _logit(miss_p) * visited * (1.0 - occupied) + _logit(hit_p) * occupied
    lo = torch.clamp(lo, _logit(clamp_min_p), _logit(clamp_max_p))

    # accumulate=True adds duplicates in index order on a card too
    # (mapping/cloud.voxel_downsample), so a grid is the same from run to run
    cs = grid.color_sum.reshape(-1).index_put((end_flat,), hit_w * world_cloud.intensity,
                                              accumulate=True)
    cc = grid.color_cnt.reshape(-1).index_put((end_flat,), hit_w, accumulate=True)
    return OccupancyGrid(log_odds=lo.reshape(dims), color_sum=cs.reshape(dims),
                         color_cnt=cc.reshape(dims), origin=grid.origin,
                         resolution=grid.resolution)


def save_grid(path: str, grid: OccupancyGrid, extra: dict | None = None,
              sparse_cap: int | None = None) -> None:
    """Persist the occupancy map (OctomapDrawer::save analog,
    Drawer/OctomapDrawer.cpp:27-36, which the reference never calls).
    `extra` adds metadata fields (e.g. the live exporter's big-change
    epoch). sparse_cap: write only the touched voxels (dense when more than
    the cap are touched), the live exporter's mode. load_grid reads both
    layouts."""
    lo = grid.log_odds.reshape(-1)
    origin = grid.origin.cpu().numpy()
    if sparse_cap is not None:
        idx = torch.nonzero(lo != 0.0).reshape(-1)
        if idx.numel() <= sparse_cap:
            np.savez_compressed(
                path,
                sparse_dims=np.asarray(tuple(grid.log_odds.shape)),
                sparse_idx=idx.cpu().numpy().astype(np.int64),
                log_odds=lo[idx].cpu().numpy(),
                color_sum=grid.color_sum.reshape(-1)[idx].cpu().numpy(),
                color_cnt=grid.color_cnt.reshape(-1)[idx].cpu().numpy(),
                origin=origin,
                resolution=np.asarray(grid.resolution, np.float32),
                **(extra or {}),
            )
            return
    np.savez_compressed(
        path,
        log_odds=grid.log_odds.cpu().numpy(),
        color_sum=grid.color_sum.cpu().numpy(),
        color_cnt=grid.color_cnt.cpu().numpy(),
        origin=origin,
        resolution=np.asarray(grid.resolution, np.float32),
        **(extra or {}),
    )


def load_grid(path: str, device="cuda") -> OccupancyGrid:
    dev = torch.device(device)
    with np.load(path) as d:
        d = {k: d[k] for k in d.files}
    if "sparse_dims" in d:
        dims = tuple(int(x) for x in d["sparse_dims"])
        idx = d["sparse_idx"]

        def densify(vals):
            full = np.zeros(int(np.prod(dims)), np.float32)
            full[idx] = vals
            return torch.as_tensor(full.reshape(dims), device=dev)

        fields = [densify(d[k]) for k in ("log_odds", "color_sum", "color_cnt")]
    else:
        fields = [torch.as_tensor(d[k], device=dev)
                  for k in ("log_odds", "color_sum", "color_cnt")]
    return OccupancyGrid(*fields, origin=torch.as_tensor(d["origin"], device=dev),
                         resolution=float(d["resolution"]))


@functools.lru_cache()
def occupied_from(threshold: float) -> float:
    """The least float32 log-odds x with sigmoid(x) >= threshold, the sigmoid
    and the comparison in float32 as the JAX package evaluates them on the
    CPU: `log_odds >= occupied_from(t)` makes the same decision on any
    device (at the hit-once value logit(0.9), against 0.9, it is a matter of
    the sigmoid's last bit). Searched over the 4096 floats around
    float32(logit(threshold)), evaluated as one vector (the CPU's
    vectorised sigmoid)."""
    x = torch.tensor(_logit(threshold), dtype=torch.float32)
    cand = [x]
    for direction in (-math.inf, math.inf):
        c = x
        for _ in range(2048):
            c = torch.nextafter(c, torch.tensor(direction))
            cand.append(c)
    cand = torch.stack(cand).sort().values
    hit = torch.sigmoid(cand) >= threshold
    first = int(torch.argmax(hit.to(torch.int8)))
    if not hit[first] or hit[:first].any() or not hit[first:].all():
        raise ValueError(f"no float32 occupancy cut for threshold {threshold}")
    return float(cand[first])


def occupied_voxels(grid: OccupancyGrid, threshold: float = 0.9):
    """World-space centres + mean intensity of voxels with occupancy >=
    threshold (the render set, Drawer/OctomapDrawer.cpp:133-216). The cut
    runs on the grid's device in log-odds (`occupied_from`); the centres and
    means are computed on the host (dynamic count)."""
    mask = grid.log_odds >= occupied_from(threshold)
    idx = torch.nonzero(mask).cpu().numpy()
    # in f32, as the JAX package computes it once a jitted insertion has made
    # the grid's resolution a device scalar
    centers = ((idx + 0.5).astype(np.float32) * np.float32(grid.resolution)
               + grid.origin.cpu().numpy())
    cnt = grid.color_cnt[mask].cpu().numpy()
    col = grid.color_sum[mask].cpu().numpy() / np.maximum(cnt, 1.0)
    return centers.astype(np.float32), col.astype(np.float32)
