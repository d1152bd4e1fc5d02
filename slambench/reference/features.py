"""Plain reference of the live feature build: the half-sample pyramid,
FAST-10 + Shi-Tomasi + 3x3 NMS per level, the best corner of each grid cell
across levels, the top-N cells, a 7-tap Gaussian blur, upright BRIEF-256,
and the depth lookup, smoothness gate and unprojection of each keypoint
(SVO's extractor and BRIEF as toniortiz/rgbd-slam runs them).

A frozen copy of the program's plain tensor versions of this path, in one
file, with nothing imported from the program. Every sum is written in a
fixed order, so the same input gives the same bits on the CPU and on a card;
integer results (keypoint cells, validity, descriptor bits) and the depth of
each keypoint are held exactly.

`quantize` rounds every image the build computes (input, pyramid levels,
gradients, box sums, scores, blur, depth means): the identity for the
stated float32, or a rounding to a lower precision for the control.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

Quantize = Callable[[torch.Tensor], torch.Tensor]

FAST_RING = np.array(
    [(0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
     (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3)],
    dtype=np.int32)


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


PRECISIONS = {"float32": identity, "tf32": round_tf32, "bfloat16": round_bf16}


class Features(NamedTuple):
    """One frame's slots as the keyframe store keeps them."""

    uv: torch.Tensor         # (N, 2) f32 undistorted pixel coordinates
    z: torch.Tensor          # (N,) f32 depth of the slot, 0 without depth
    obs_valid: torch.Tensor  # (N,) bool detected and with depth
    smooth: torch.Tensor     # (N,) bool no depth edge around the slot
    desc: torch.Tensor       # (N, 8) int32 words of BRIEF-256


def half_sample(img, q: Quantize):
    h2, w2 = img.shape[0] // 2, img.shape[1] // 2
    x = img[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2)
    return q((x[:, 0, :, 0] + x[:, 0, :, 1] + x[:, 1, :, 0] + x[:, 1, :, 1]) / 4.0)


def box_filter_sum(img, radius: int):
    """Zero-padded (2r+1)^2 window sum: a row pass, then a column pass, each
    adding the +s then the -s neighbour for s = 1..r."""
    h, w = img.shape
    r = radius
    p = F.pad(img, (r, r))
    acc = img
    for s in range(1, r + 1):
        acc = acc + p[:, r + s: r + s + w] + p[:, r - s: r - s + w]
    p = F.pad(acc, (0, 0, r, r))
    out = acc
    for s in range(1, r + 1):
        out = out + p[r + s: r + s + h, :] + p[r - s: r - s + h, :]
    return out


def shi_tomasi_map(img, q: Quantize, radius: int = 4):
    """Min-eigenvalue score of the central-difference structure tensor over a
    zero-padded box, normalised by 2 x its area; a correctly rounded root."""
    dx = torch.zeros_like(img)
    dy = torch.zeros_like(img)
    dx[:, 1:-1] = img[:, 2:] - img[:, :-2]
    dy[1:-1, :] = img[2:, :] - img[:-2, :]
    inv = 1.0 / (2.0 * float((2 * radius + 1) ** 2))
    dxx = q(box_filter_sum(q(dx * dx), radius) * inv)
    dyy = q(box_filter_sum(q(dy * dy), radius) * inv)
    dxy = q(box_filter_sum(q(dx * dy), radius) * inv)
    diff = dxx - dyy
    root = torch.sqrt(torch.clamp_min(diff * diff + 4.0 * dxy * dxy, 0.0).double()).float()
    return q(0.5 * (dxx + dyy - root))


def fast_corner_mask(img, threshold: float, arc: int = 10):
    """FAST-10: >= `arc` contiguous ring pixels all brighter than centre + t
    or all darker than centre - t, on the 3-pixel interior."""
    h, w = img.shape
    ring = torch.stack([torch.roll(img, shifts=(-int(dy), -int(dx)), dims=(0, 1))
                        for dx, dy in FAST_RING])
    bits = (1 << torch.arange(16, device=img.device, dtype=torch.int64))[:, None, None]
    window = (1 << arc) - 1

    def has_arc(flags):
        m = torch.sum(flags.to(torch.int64) * bits, dim=0)
        ext = m | (m << 16)
        out = torch.zeros((h, w), dtype=torch.bool, device=img.device)
        for s in range(16):
            out = out | (((ext >> s) & window) == window)
        return out

    mask = has_arc(ring > (img + threshold)[None]) | has_arc(ring < (img - threshold)[None])
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    return mask & (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)


def nms3x3(score):
    return score >= F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]


def masked_score(img, threshold: float, q: Quantize):
    """The FAST-gated Shi-Tomasi score where it is a 3x3 maximum among the
    corners, -inf elsewhere."""
    score = shi_tomasi_map(img, q)
    corners = fast_corner_mask(img, threshold)
    keep = corners & nms3x3(torch.where(corners, score, float("-inf")))
    return torch.where(keep, score, float("-inf"))


def response_gate(min_response: float, threshold: float) -> float:
    """min_response x (thr / thr)^2 in the f32 arithmetic the program folds
    it to: (thr * thr) * (f32(min_response) * r * r), r = f32(1 / thr)."""
    r = np.float32(1.0) / np.float32(threshold)
    k = np.float32(min_response) * (r * r)
    t = np.float32(threshold)
    return float((t * t) * k)


def detect(pyramid: List[torch.Tensor], ecfg: dict, q: Quantize):
    """(uv (N, 2), valid (N,)) of the best corner per cell across levels,
    the top `num_features` cells by score (stable), padded."""
    cell, border = ecfg["cell_size"], ecfg["min_border"]
    thr = float(ecfg["fast_threshold"])
    n_levels = 0
    while n_levels < len(pyramid) and (cell >> n_levels) >= 1:
        n_levels += 1
    h0, w0 = pyramid[0].shape
    rows, cols = h0 // cell, w0 // cell
    n_cells = rows * cols
    dev = pyramid[0].device
    best = torch.full((n_cells,), float("-inf"), dtype=torch.float32, device=dev)
    best_u = torch.zeros((n_cells,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((n_cells,), dtype=torch.float32, device=dev)
    cell_row = torch.arange(n_cells, dtype=torch.int64, device=dev) // cols
    cell_col = torch.arange(n_cells, dtype=torch.int64, device=dev) % cols
    for lvl in range(n_levels):
        shift, cell_l = 1 << lvl, cell >> lvl
        score = masked_score(pyramid[lvl], thr, q)
        h, w = score.shape
        yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] * shift
        xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] * shift
        inb = (xx >= border) & (xx < w0 - border) & (yy >= border) & (yy < h0 - border)
        score = torch.where(inb, score, float("-inf"))
        tiles = score[:rows * cell_l, :cols * cell_l].reshape(rows, cell_l, cols, cell_l)
        tiles = tiles.permute(0, 2, 1, 3).reshape(n_cells, cell_l * cell_l)
        cmax, carg = torch.amax(tiles, dim=-1), torch.argmax(tiles, dim=-1)
        u = ((cell_col * cell_l + carg % cell_l) * shift).to(torch.float32)
        v = ((cell_row * cell_l + carg // cell_l) * shift).to(torch.float32)
        better = cmax > best
        best = torch.where(better, cmax, best)
        best_u = torch.where(better, u, best_u)
        best_v = torch.where(better, v, best_v)
    gate = response_gate(ecfg["min_response"], thr)
    sel = torch.where(best > gate, best, float("-inf"))
    k = min(ecfg["num_features"], n_cells)
    order = torch.sort(sel, descending=True, stable=True)
    top, idx = order.values[:k], order.indices[:k]
    uv = torch.stack([best_u[idx], best_v[idx]], dim=-1)
    valid = torch.isfinite(top) & (top > gate)
    pad = ecfg["num_features"] - k
    if pad > 0:
        uv = torch.cat([uv, torch.zeros((pad, 2), dtype=torch.float32, device=dev)])
        valid = torch.cat([valid, torch.zeros((pad,), dtype=torch.bool, device=dev)])
    return uv, valid


def gaussian_blur(img, q: Quantize, sigma: float = 2.0, radius: int = 3):
    """Separable 7-tap Gaussian over a reflect-padded image."""
    xs = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    k /= k.sum()
    h, w = img.shape
    pad = F.pad(img[None, None], (radius, radius, radius, radius), mode="reflect")[0, 0]
    acc = torch.zeros_like(img)
    for i, kv in enumerate(k):
        acc = acc + float(kv) * pad[radius: radius + h, i: i + w]
    pad2 = F.pad(q(acc)[None, None], (0, 0, radius, radius), mode="reflect")[0, 0]
    out = torch.zeros_like(img)
    for i, kv in enumerate(k):
        out = out + float(kv) * pad2[i: i + h, :]
    return q(out)


def brief(img_blurred, uv, patch_size: int = 31, seed: int = 7):
    """Upright BRIEF-256 at the rounded keypoints: the pattern is numpy's
    default_rng(seed) normal draw (sigma = patch / 5, clipped to the patch,
    rounded half to even); bit i of word w is pair 32 w + i's a < b, reads
    clamped to the image."""
    h, w = img_blurred.shape
    half = patch_size // 2
    pts = np.random.default_rng(seed).normal(scale=patch_size / 5.0, size=(256, 2, 2))
    pat = torch.as_tensor(np.round(np.clip(pts, -half, half).astype(np.float32))
                          .astype(np.int64), device=img_blurred.device)
    u = torch.clamp(torch.round(uv[:, 0]).long(), 0, w - 1)
    v = torch.clamp(torch.round(uv[:, 1]).long(), 0, h - 1)

    def sample(offs):
        x = torch.clamp(u[:, None] + offs[None, :, 0], 0, w - 1)
        y = torch.clamp(v[:, None] + offs[None, :, 1], 0, h - 1)
        return img_blurred[y, x]

    bits = (sample(pat[:, 0]) < sample(pat[:, 1])).reshape(-1, 8, 32).to(torch.int64)
    words = torch.sum(bits << torch.arange(32, dtype=torch.int64, device=bits.device), dim=-1)
    return torch.where(words >= (1 << 31), words - (1 << 32), words).to(torch.int32)


def nearest(img, uv):
    h, w = img.shape
    u = torch.clamp(torch.round(uv[..., 0]).long(), 0, w - 1)
    v = torch.clamp(torch.round(uv[..., 1]).long(), 0, h - 1)
    return img[v, u]


def build(gray: torch.Tensor, depth: torch.Tensor, sensor: dict, ecfg: dict,
          q: Quantize = identity) -> Features:
    """The feature build of one (gray, depth) frame of a pinhole sensor
    without distortion."""
    gray, depth = q(gray), q(depth)
    pyramid = [gray]
    for _ in range(1, ecfg["num_levels"]):
        pyramid.append(half_sample(pyramid[-1], q))
    uv, valid = detect(pyramid, ecfg, q)
    desc = brief(gaussian_blur(gray, q), uv, ecfg["brief_patch_size"])
    fx, fy, cx, cy = sensor["fx"], sensor["fy"], sensor["cx"], sensor["cy"]
    z_n = nearest(depth, uv)
    has_depth = (torch.isfinite(z_n) & (z_n > sensor["min_depth"])
                 & (z_n < sensor["max_depth"]) & valid)
    d4 = depth[None, None]
    zmax = F.max_pool2d(d4, 3, stride=1, padding=1)[0, 0]
    zmin = -F.max_pool2d(-d4, 3, stride=1, padding=1)[0, 0]
    smooth = has_depth & (nearest(zmax, uv) - nearest(zmin, uv) <= 0.03 + 0.02 * z_n)
    zmean = q(q(box_filter_sum(depth, 1))
              / torch.clamp_min(box_filter_sum((depth > 0).to(depth.dtype), 1), 1.0))
    z = torch.where(smooth, nearest(zmean, uv), z_n)
    # the undistortion of a sensor without distortion, as the program
    # computes it: normalised, then back to pixels
    uv_u = torch.stack([((uv[:, 0] - cx) / fx) * fx + cx, ((uv[:, 1] - cy) / fy) * fy + cy],
                       dim=-1)
    return Features(uv=uv_u, z=torch.where(has_depth, z, 0.0), obs_valid=has_depth,
                    smooth=smooth, desc=desc)
