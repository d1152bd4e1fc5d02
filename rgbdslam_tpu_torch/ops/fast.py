"""Dense FAST corner test + Shi-Tomasi score + grid NMS into a fixed
keypoint budget (port of rgbdslam_tpu/ops/fast.py, `fast_st` response).

Per pyramid level a dense FAST-10 mask, a dense Shi-Tomasi min-eigenvalue
map and 3x3 NMS give a masked score map; the best corner per grid cell
across levels and the top-N cells fill the N keypoint slots (reference:
Features/SVOextractor.cpp:79-133). On CUDA the whole detection is two
launches of csrc/detect.cu (see ops/kernels.py); the tensor code here is its
plain version.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from rgbdslam_tpu_torch.ops import image as image_ops

# Bresenham circle of radius 3 — the 16 FAST ring offsets (dx, dy), clockwise
# from 12 o'clock (csrc/detect.cu holds the same table).
FAST_RING = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1),
        (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1),
        (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)


def fast_corner_mask(img: torch.Tensor, threshold, arc: int = 10) -> torch.Tensor:
    """Dense FAST segment test: True where >= `arc` contiguous ring pixels
    are all brighter than center+t or all darker than center-t, on the
    3-pixel interior (the ring reads wrap around outside it). `threshold`:
    a float or a 0-dim f32 tensor on the image's device (the same bits)."""
    h, w = img.shape
    ring = torch.stack([torch.roll(img, shifts=(-int(dy), -int(dx)), dims=(0, 1))
                        for dx, dy in FAST_RING])             # (16, H, W)
    brighter = ring > (img + threshold)[None]
    darker = ring < (img - threshold)[None]
    bits = (1 << torch.arange(16, device=img.device, dtype=torch.int64))[:, None, None]
    window = (1 << arc) - 1

    def has_arc(flags: torch.Tensor) -> torch.Tensor:
        m = torch.sum(flags.to(torch.int64) * bits, dim=0)    # 16 flag bits
        ext = m | (m << 16)                                    # wrap-around
        out = torch.zeros((h, w), dtype=torch.bool, device=img.device)
        for s in range(16):
            out = out | (((ext >> s) & window) == window)
        return out

    mask = has_arc(brighter) | has_arc(darker)
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    interior = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    return mask & interior


def shi_tomasi_map(img: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Dense Shi-Tomasi min-eigenvalue score (SVO ShiTomasiScore semantics,
    Features/SVOextractor.cpp:39-77: central-difference gradients, zero-padded
    box sum, normalisation by 2*box_area written as a multiply, as the
    Pallas and CUDA kernels write it)."""
    dx, dy = image_ops.sobel_gradients(img)
    inv = 1.0 / (2.0 * float((2 * radius + 1) ** 2))
    dxx = image_ops.box_filter_sum(dx * dx, radius) * inv
    dyy = image_ops.box_filter_sum(dy * dy, radius) * inv
    dxy = image_ops.box_filter_sum(dx * dy, radius) * inv
    tr = dxx + dyy
    diff = dxx - dyy
    det_term = torch.sqrt(torch.clamp_min(diff * diff + 4.0 * dxy * dxy, 0.0))
    return 0.5 * (tr - det_term)


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """True where score >= every value of its 3x3 neighbourhood (-inf outside)."""
    nb = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return score >= nb


class Keypoints(NamedTuple):
    """Fixed-budget keypoint set (level-0 pixel coords)."""

    uv: torch.Tensor       # (N, 2) float32 — (u=x, v=y) at level 0
    level: torch.Tensor    # (N,) int32 pyramid level
    score: torch.Tensor    # (N,) float32 Shi-Tomasi response
    valid: torch.Tensor    # (N,) bool


def masked_score_map(img: torch.Tensor, fast_threshold: float):
    """Per-level (masked, raw) detector maps: the dense kernel K1 for a CUDA
    tensor, its plain version for a CPU tensor. The raw map is what subpixel
    refinement reads; `detect_keypoints` needs neither map."""
    from rgbdslam_tpu_torch.ops import kernels

    if kernels.on_cuda(img):
        return kernels.detect_score_map(img, fast_threshold)
    return kernels.detect_score_map_ref(img, fast_threshold)


def used_levels(num_levels: int, cell_size: int) -> int:
    """How many pyramid levels the detection reads: it stops at the first
    level whose cell (cell_size >> level) has no pixel."""
    n = 0
    while n < num_levels and (cell_size >> n) >= 1:
        n += 1
    return n


def detect_cells_ref(pyramid: List[torch.Tensor], cell_size: int, fast_threshold,
                     min_border: int):
    """First half of the plain detection: per level the masked score map
    (K1's plain version), the border gate in level-0 coordinates and the best
    corner of each `cell_size >> level` cell. Returns (cell_max (L, n_cells)
    f32, cell_arg (L, n_cells) int32: the first maximum's row-major index in
    its cell, 0 for a cell with no corner)."""
    from rgbdslam_tpu_torch.ops import kernels

    h0, w0 = pyramid[0].shape
    dev = pyramid[0].device
    grid_rows = h0 // cell_size
    grid_cols = w0 // cell_size
    n_cells = grid_rows * grid_cols
    maxima, args = [], []
    for lvl, img in enumerate(pyramid[:used_levels(len(pyramid), cell_size)]):
        scale = 1 << lvl
        cell_l = cell_size // scale
        h, w = img.shape
        score, _raw = kernels.detect_score_map_ref(img, fast_threshold)
        # border gate in level-0 coordinates
        yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] * scale
        xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] * scale
        inb = ((xx >= min_border) & (xx < w0 - min_border)
               & (yy >= min_border) & (yy < h0 - min_border))
        masked = torch.where(inb, score, float("-inf"))

        hc, wc = grid_rows * cell_l, grid_cols * cell_l
        tiles = masked[:hc, :wc].reshape(grid_rows, cell_l, grid_cols, cell_l)
        tiles = tiles.permute(0, 2, 1, 3).reshape(n_cells, cell_l * cell_l)
        maxima.append(torch.amax(tiles, dim=-1))
        # first maximum; an all -inf tile gives index 0, as jnp.argmax does
        args.append(torch.argmax(tiles, dim=-1).to(torch.int32))
    return torch.stack(maxima), torch.stack(args)


def detect_select_ref(cell_max: torch.Tensor, cell_arg: torch.Tensor, grid_cols: int,
                      num_features: int, cell_size: int, min_response: float) -> Keypoints:
    """Second half of the plain detection: merge the levels' cell winners
    (strict >, so the lower level keeps ties and a cell with no corner keeps
    u = v = 0, level 0; a NaN maximum never wins), gate by `min_response`,
    take the top `num_features` cells (stable: lower cell index first on equal
    scores) and pad to the fixed budget."""
    n_levels, n_cells = cell_max.shape
    dev = cell_max.device
    best_score = torch.full((n_cells,), float("-inf"), dtype=torch.float32, device=dev)
    best_u = torch.zeros((n_cells,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((n_cells,), dtype=torch.float32, device=dev)
    best_level = torch.zeros((n_cells,), dtype=torch.int32, device=dev)
    cell_row = torch.arange(n_cells, dtype=torch.int64, device=dev) // grid_cols
    cell_col = torch.arange(n_cells, dtype=torch.int64, device=dev) % grid_cols

    for lvl in range(n_levels):
        scale = 1 << lvl
        cell_l = cell_size // scale
        py = cell_arg[lvl].long() // cell_l
        px = cell_arg[lvl].long() % cell_l
        u = ((cell_col * cell_l + px) * scale).to(torch.float32)
        v = ((cell_row * cell_l + py) * scale).to(torch.float32)

        better = cell_max[lvl] > best_score
        best_score = torch.where(better, cell_max[lvl], best_score)
        best_u = torch.where(better, u, best_u)
        best_v = torch.where(better, v, best_v)
        best_level = torch.where(better, torch.full_like(best_level, lvl), best_level)

    valid_cell = best_score > min_response            # Features/SVOextractor.cpp:128
    sel_scores = torch.where(valid_cell, best_score, float("-inf"))

    k = min(num_features, n_cells)
    order = torch.sort(sel_scores, descending=True, stable=True)
    top_scores, top_idx = order.values[:k], order.indices[:k]
    uv = torch.stack([best_u[top_idx], best_v[top_idx]], dim=-1)
    level = best_level[top_idx]
    valid = torch.isfinite(top_scores) & (top_scores > min_response)

    if k < num_features:  # pad to the fixed budget
        pad = num_features - k
        uv = torch.cat([uv, torch.zeros((pad, 2), dtype=torch.float32, device=dev)])
        level = torch.cat([level, torch.zeros((pad,), dtype=torch.int32, device=dev)])
        top_scores = torch.cat([top_scores, torch.full((pad,), float("-inf"), device=dev)])
        valid = torch.cat([valid, torch.zeros((pad,), dtype=torch.bool, device=dev)])

    return Keypoints(uv=uv, level=level,
                     score=torch.where(valid, top_scores, 0.0), valid=valid)


def detect_keypoints_ref(pyramid: List[torch.Tensor], num_features: int, cell_size: int,
                         fast_threshold, min_response: float,
                         min_border: int) -> Keypoints:
    """Plain version of `detect_keypoints`: tensor code on whatever device
    the pyramid lies on, in the two halves that the two kernels of
    csrc/detect.cu take (`detect_cells_ref`, `detect_select_ref`)."""
    cell_max, cell_arg = detect_cells_ref(pyramid, cell_size, fast_threshold, min_border)
    return detect_select_ref(cell_max, cell_arg, pyramid[0].shape[1] // cell_size,
                             num_features, cell_size, min_response)


def detect_keypoints(
    pyramid: List[torch.Tensor],
    num_features: int,
    cell_size: int,
    fast_threshold,
    min_response: float,
    min_border: int,
) -> Keypoints:
    """Multi-level FAST detection with best-per-cell grid NMS into N slots
    (SVOextractor::detect, Features/SVOextractor.cpp:79-133): one winner per
    `cell_size` cell across all levels, final response gate `min_response`,
    top `num_features` cells by score (ties: lower cell index first, as
    jax.lax.top_k). Two launches of csrc/detect.cu for a CUDA pyramid
    (`kernels.detect_keypoints_fused`), the plain version for a CPU one.
    `fast_threshold` is a float or a 0-dim f32 tensor on the pyramid's
    device; neither is read back to the host."""
    from rgbdslam_tpu_torch.ops import kernels

    if kernels.on_cuda(*pyramid):
        return kernels.detect_keypoints_fused(pyramid, num_features, cell_size,
                                              fast_threshold, min_response, min_border)[0]
    return detect_keypoints_ref(pyramid, num_features, cell_size, fast_threshold,
                                min_response, min_border)
