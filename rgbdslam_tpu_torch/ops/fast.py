"""Dense FAST corner test + Shi-Tomasi score + grid NMS into a fixed
keypoint budget, and the other detector responses of the extractor factory
(port of rgbdslam_tpu/ops/fast.py).

Per pyramid level a dense FAST-10 mask (or, in the GFTT mode, every pixel),
a dense Shi-Tomasi min-eigenvalue map and 3x3 NMS give a masked score map;
the best corner per grid cell across levels and the top-N cells fill the N
keypoint slots (reference: Features/SVOextractor.cpp:79-133). On CUDA the
whole detection of the half-sample pyramid (subpixel offsets included) is
two launches of csrc/detect.cu, and so is the whole detection of the ORB
x1.2 scale space, every level with its quota (see ops/kernels.py); the
tensor code here is their plain version, in the halves the kernels take.
The STAR, DoG and Hessian responses were XLA code in the JAX package and
are tensor code here on every device.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

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
    Pallas and CUDA kernels write it; a correctly rounded square root, as
    theirs)."""
    dx, dy = image_ops.sobel_gradients(img)
    inv = 1.0 / (2.0 * float((2 * radius + 1) ** 2))
    dxx = image_ops.box_filter_sum(dx * dx, radius) * inv
    dyy = image_ops.box_filter_sum(dy * dy, radius) * inv
    dxy = image_ops.box_filter_sum(dx * dy, radius) * inv
    tr = dxx + dyy
    diff = dxx - dyy
    det_term = image_ops.sqrt_rn(torch.clamp_min(diff * diff + 4.0 * dxy * dxy, 0.0))
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


def f32_reciprocal(value: float) -> np.float32:
    """1 / value rounded to f32, as XLA folds a division by a static float."""
    return np.float32(1.0) / np.float32(value)


def gate_scale(min_response: float, gate_threshold: float) -> np.float32:
    """K of the scaled response gate thr^2 * K: XLA compiles the JAX
    package's min_response * (thr / cfg threshold)^2 (frontend/frame.py:103-106)
    into (thr * thr) * K with K = f32(min_response) * (r * r), r the f32
    reciprocal of the static threshold (measured on the JAX package's jitted
    arithmetic)."""
    r = f32_reciprocal(gate_threshold)
    return np.float32(min_response) * (r * r)


def response_gate(min_response: float, fast_threshold, gate_threshold: Optional[float]):
    """The final response gate: with the FAST gate it scales with the
    (possibly adapted) threshold, thr^2 * `gate_scale` (`gate_threshold` =
    cfg.fast_threshold); `gate_threshold=None` keeps min_response. A float
    threshold gives a float (f32 arithmetic), a 0-dim tensor a 0-dim tensor
    on its device (never read back)."""
    if gate_threshold is None:
        return min_response
    k = gate_scale(min_response, gate_threshold)
    if isinstance(fast_threshold, torch.Tensor):
        return (fast_threshold * fast_threshold) * float(k)
    t = np.float32(fast_threshold)
    return float((t * t) * k)


def masked_score_map(img: torch.Tensor, fast_threshold, use_fast_gate: bool = True):
    """Per-level (masked, raw) detector maps: the dense kernel K1 for a CUDA
    tensor, its plain version for a CPU tensor. The raw map is the dense
    Shi-Tomasi surface that subpixel refinement reads."""
    from rgbdslam_tpu_torch.ops import kernels

    if kernels.on_cuda(img):
        return kernels.detect_score_map(img, fast_threshold, use_fast_gate)
    return kernels.detect_score_map_ref(img, fast_threshold, use_fast_gate)


def level_score_map(img: torch.Tensor, fast_threshold, use_fast_gate: bool, response: str):
    """(masked, raw) maps of one level for a response: K1 (or its plain
    version) for 'fast_st', the tensor-code response maps otherwise."""
    if response == "fast_st":
        return masked_score_map(img, fast_threshold, use_fast_gate)
    return response_masked_score(img, response)


def used_levels(num_levels: int, cell_size: int) -> int:
    """How many pyramid levels the detection reads: it stops at the first
    level whose cell (cell_size >> level) has no pixel."""
    n = 0
    while n < num_levels and (cell_size >> n) >= 1:
        n += 1
    return n


def _cell_winners(masked: torch.Tensor, cell_l: int, grid_rows: int, grid_cols: int):
    """Best score of each cell_l x cell_l cell of the cell-aligned region and
    its first index in the cell's row-major order (0 for an all -inf cell,
    as jnp.argmax gives)."""
    n_cells = grid_rows * grid_cols
    hc, wc = grid_rows * cell_l, grid_cols * cell_l
    tiles = masked[:hc, :wc].reshape(grid_rows, cell_l, grid_cols, cell_l)
    tiles = tiles.permute(0, 2, 1, 3).reshape(n_cells, cell_l * cell_l)
    return torch.amax(tiles, dim=-1), torch.argmax(tiles, dim=-1).to(torch.int32)


def _cell_offsets(raw: torch.Tensor, cell_arg: torch.Tensor, cell_l: int,
                  grid_cols: int) -> torch.Tensor:
    """(n_cells, 2) parabola offsets (ox, oy) on `raw` at each cell's winning
    pixel (the cell's first pixel for a cell with no corner)."""
    cells = torch.arange(cell_arg.shape[0], dtype=torch.int64, device=raw.device)
    arg = cell_arg.long()
    ul = (cells % grid_cols) * cell_l + arg % cell_l
    vl = (cells // grid_cols) * cell_l + arg // cell_l
    return torch.stack(_subpixel_offsets(raw, ul, vl), dim=-1)


def _border_gate(score: torch.Tensor, shift: int, frame_hw, min_border: int) -> torch.Tensor:
    """`score` with -inf where pixel (x, y) of the map, scaled by `shift`,
    lies less than min_border inside the frame_hw (h, w) frame."""
    h, w = score.shape
    dev = score.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] * shift
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] * shift
    fh, fw = frame_hw
    inb = ((xx >= min_border) & (xx < fw - min_border)
           & (yy >= min_border) & (yy < fh - min_border))
    return torch.where(inb, score, float("-inf"))


def _detect_cells(levels: List[torch.Tensor], cell_size: int, min_border: int,
                  masked_maps: List[torch.Tensor], raw_maps: Optional[List[torch.Tensor]] = None):
    """Per level its masked map, the border gate in level-0 coordinates and
    the best of each `cell_size >> level` cell: (cell_max (L, n_cells) f32,
    cell_arg (L, n_cells) int32, cell_off). With `raw_maps` cell_off holds
    the parabola offsets at each (level, cell) winner and, last, those of
    pixel (0, 0) of level 0 ((L * n_cells + 1, 2) f32); else None."""
    h0, w0 = levels[0].shape
    grid_rows = h0 // cell_size
    grid_cols = w0 // cell_size
    maxima, args, offs = [], [], []
    for lvl, score in enumerate(masked_maps):
        cell_l = cell_size >> lvl
        cmax, carg = _cell_winners(_border_gate(score, 1 << lvl, (h0, w0), min_border),
                                   cell_l, grid_rows, grid_cols)
        maxima.append(cmax)
        args.append(carg)
        if raw_maps is not None:
            offs.append(_cell_offsets(raw_maps[lvl], carg, cell_l, grid_cols))
    cell_off = None
    if raw_maps is not None:
        zero = torch.zeros((1,), dtype=torch.int64, device=levels[0].device)
        offs.append(torch.stack(_subpixel_offsets(raw_maps[0], zero, zero), dim=-1))
        cell_off = torch.cat(offs)
    return torch.stack(maxima), torch.stack(args), cell_off


def detect_cells_ref(pyramid: List[torch.Tensor], cell_size: int, fast_threshold,
                     min_border: int, use_fast_gate: bool = True, subpixel: bool = False):
    """First half of the plain detection: per level the masked score map
    (K1's plain version), the border gate in level-0 coordinates and the best
    corner of each `cell_size >> level` cell. Returns (cell_max (L, n_cells)
    f32, cell_arg (L, n_cells) int32: the first maximum's row-major index in
    its cell, 0 for a cell with no corner), and with `subpixel` the offsets
    of `_detect_cells` third."""
    from rgbdslam_tpu_torch.ops import kernels

    levels = pyramid[:used_levels(len(pyramid), cell_size)]
    maps = [kernels.detect_score_map_ref(img, fast_threshold, use_fast_gate) for img in levels]
    out = _detect_cells(levels, cell_size, min_border, [m for m, _ in maps],
                        [r for _, r in maps] if subpixel else None)
    return out if subpixel else out[:2]


def select_cells(cell_max: torch.Tensor, cell_arg: torch.Tensor, grid_cols: int,
                 num_features: int, cell_size: int, min_response,
                 cell_off: Optional[torch.Tensor] = None) -> Keypoints:
    """Merge the levels' cell winners (strict >, so the lower level keeps
    ties and a cell with no corner keeps u = v = 0, level 0; a NaN maximum
    never wins), gate by `min_response` (a float, or the 0-dim tensor of
    `response_gate`), take the top `num_features` cells (stable: lower cell
    index first on equal scores) and pad to the fixed budget. With
    `cell_off` (`_detect_cells`' offsets) each winner moves by its level's
    offsets scaled to level 0 (JAX fast.py:238-254: every slot, valid or
    not; the padding does not move). The star / DoG / Hessian detection
    selects with it as tensor code; under the name `detect_select_ref` it is
    kernel B's plain version."""
    n_levels, n_cells = cell_max.shape
    dev = cell_max.device
    best_score = torch.full((n_cells,), float("-inf"), dtype=torch.float32, device=dev)
    best_u = torch.zeros((n_cells,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((n_cells,), dtype=torch.float32, device=dev)
    best_level = torch.zeros((n_cells,), dtype=torch.int32, device=dev)
    if cell_off is not None:
        best_du = cell_off[-1, 0].expand(n_cells)
        best_dv = cell_off[-1, 1].expand(n_cells)
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
        if cell_off is not None:
            off = cell_off[lvl * n_cells:(lvl + 1) * n_cells]
            best_du = torch.where(better, off[:, 0] * scale, best_du)
            best_dv = torch.where(better, off[:, 1] * scale, best_dv)

    valid_cell = best_score > min_response            # Features/SVOextractor.cpp:128
    sel_scores = torch.where(valid_cell, best_score, float("-inf"))

    k = min(num_features, n_cells)
    order = torch.sort(sel_scores, descending=True, stable=True)
    top_scores, top_idx = order.values[:k], order.indices[:k]
    uv = torch.stack([best_u[top_idx], best_v[top_idx]], dim=-1)
    if cell_off is not None:
        uv = uv + torch.stack([best_du[top_idx], best_dv[top_idx]], dim=-1)
    level = best_level[top_idx]
    valid = torch.isfinite(top_scores) & (top_scores > min_response)
    return _pad_keypoints(uv, level, top_scores, valid, num_features)


def _pad_keypoints(uv, level, top_scores, valid, num_features: int) -> Keypoints:
    """Pad k slots to the fixed budget (zeros, level 0, invalid) and zero the
    scores of invalid slots."""
    k = uv.shape[0]
    dev = uv.device
    if k < num_features:
        pad = num_features - k
        uv = torch.cat([uv, torch.zeros((pad, 2), dtype=torch.float32, device=dev)])
        level = torch.cat([level, torch.zeros((pad,), dtype=torch.int32, device=dev)])
        top_scores = torch.cat([top_scores, torch.full((pad,), float("-inf"), device=dev)])
        valid = torch.cat([valid, torch.zeros((pad,), dtype=torch.bool, device=dev)])
    return Keypoints(uv=uv, level=level,
                     score=torch.where(valid, top_scores, 0.0), valid=valid)


#: the second half of the plain detection, what kernel B computes
detect_select_ref = select_cells


def detect_keypoints_ref(pyramid: List[torch.Tensor], num_features: int, cell_size: int,
                         fast_threshold, min_response: float, min_border: int,
                         use_fast_gate: bool = True,
                         gate_threshold: Optional[float] = None,
                         subpixel: bool = False) -> Keypoints:
    """Plain version of `detect_keypoints` for the `fast_st` response: tensor
    code on whatever device the pyramid lies on, in the two halves that the
    two kernels of csrc/detect.cu take (`detect_cells_ref`,
    `detect_select_ref`). gate_threshold: see `response_gate`."""
    cells = detect_cells_ref(pyramid, cell_size, fast_threshold, min_border, use_fast_gate,
                             subpixel)
    return detect_select_ref(*cells[:2], pyramid[0].shape[1] // cell_size, num_features,
                             cell_size, response_gate(min_response, fast_threshold,
                                                      gate_threshold),
                             cells[2] if subpixel else None)


def _parabola_offset(s_minus: torch.Tensor, s_center: torch.Tensor,
                     s_plus: torch.Tensor) -> torch.Tensor:
    """1-D quadratic-peak offset in [-0.5, 0.5] from three samples."""
    denom = s_minus + s_plus - 2.0 * s_center
    off = torch.where(torch.abs(denom) > 1e-12, 0.5 * (s_minus - s_plus) / denom, 0.0)
    return torch.clamp(off, -0.5, 0.5)


def _subpixel_offsets(raw: torch.Tensor, ul: torch.Tensor, vl: torch.Tensor):
    """(ox, oy): the separable 3-point quadratic fit on `raw` around the
    integer pixels (ul, vl) (int64, inside the map), the neighbours clamped
    into it."""
    h, w = raw.shape
    um, up = torch.clamp_min(ul - 1, 0), torch.clamp_max(ul + 1, w - 1)
    vm, vp = torch.clamp_min(vl - 1, 0), torch.clamp_max(vl + 1, h - 1)
    c = raw[vl, ul]
    return (_parabola_offset(raw[vl, um], c, raw[vl, up]),
            _parabola_offset(raw[vm, ul], c, raw[vp, ul]))


def detect_keypoints(
    pyramid: List[torch.Tensor],
    num_features: int,
    cell_size: int,
    fast_threshold,
    min_response: float,
    min_border: int,
    use_fast_gate: bool = True,
    subpixel: bool = False,
    response: str = "fast_st",
    gate_threshold: Optional[float] = None,
) -> Keypoints:
    """Multi-level detection with best-per-cell grid NMS into N slots
    (SVOextractor::detect, Features/SVOextractor.cpp:79-133): one winner per
    `cell_size` cell across all levels, the final response gate, top
    `num_features` cells by score (ties: lower cell index first, as
    jax.lax.top_k). For `fast_st` two launches of csrc/detect.cu for a CUDA
    pyramid (`kernels.detect_keypoints_fused`, also in the GFTT mode and
    with subpixel offsets), the plain version for a CPU one; the other
    responses are tensor code. `fast_threshold` is a float or a 0-dim f32
    tensor on the pyramid's device; neither is read back to the host.
    `gate_threshold`: the configured FAST threshold when the gate scales
    with it (`response_gate`). `subpixel`: every slot moves by the 3-point
    quadratic fit at its winner on its level's raw map."""
    from rgbdslam_tpu_torch.ops import kernels

    if response == "fast_st":
        if kernels.on_cuda(*pyramid):
            return kernels.detect_keypoints_fused(pyramid, num_features, cell_size,
                                                  fast_threshold, min_response, min_border,
                                                  use_fast_gate, gate_threshold, subpixel)[0]
        return detect_keypoints_ref(pyramid, num_features, cell_size, fast_threshold,
                                    min_response, min_border, use_fast_gate, gate_threshold,
                                    subpixel)
    levels = pyramid[:used_levels(len(pyramid), cell_size)]
    maps = [response_masked_score(img, response) for img in levels]
    cell_max, cell_arg, cell_off = _detect_cells(levels, cell_size, min_border,
                                                 [m for m, _ in maps],
                                                 [r for _, r in maps] if subpixel else None)
    return select_cells(cell_max, cell_arg, pyramid[0].shape[1] // cell_size, num_features,
                        cell_size, min_response, cell_off)


def level_quotas(num_features: int, levels: int, scale_factor: float,
                 cell_size: int, shapes) -> List[int]:
    """Per-level feature allocation, geometric in 1/scale_factor
    (ORBextractor's constructor allocation, Features/ORBextractor.cpp:347-419:
    nfeatures * (1-q)/(1-q^L) * q^l with q = 1/f), capped by each level's
    grid-cell count, the remainder pushed to level 0."""
    q = 1.0 / scale_factor
    norm = num_features * (1.0 - q) / (1.0 - q**levels)
    quotas = [int(round(norm * q**lvl)) for lvl in range(levels)]
    caps = [(h // cell_size) * (w // cell_size) for h, w in shapes]
    for lvl in range(levels - 1, 0, -1):
        quotas[lvl] = min(quotas[lvl], caps[lvl])
    # exact budget: level 0 absorbs caps and rounding drift (slots beyond its
    # own cell count pad invalid)
    quotas[0] = num_features - sum(quotas[1:])
    return quotas


def _level_cells(masked: torch.Tensor, raw: Optional[torch.Tensor], cell_size: int,
                 min_border: int):
    """One level of the x1.2 scale space: the border gate in the level's own
    pixels and the best of each cell_size cell of its own grid: (cell_max
    (n,) f32, cell_arg (n,) int32, cell_off (n, 2) f32 at the winners, or
    None without `raw`)."""
    h, w = masked.shape
    grid_rows, grid_cols = h // cell_size, w // cell_size
    cell_max, cell_arg = _cell_winners(_border_gate(masked, 1, (h, w), min_border), cell_size,
                                       grid_rows, grid_cols)
    off = None if raw is None else _cell_offsets(raw, cell_arg, cell_size, grid_cols)
    return cell_max, cell_arg, off


def _rank_level(cell_max, cell_arg, cell_off, grid_cols: int, cell_size: int, quota: int,
                min_response):
    """The top `quota` cells of one level by their ungated maxima (stable:
    lower cell index first on equal scores, -inf cells by index), in level
    pixels (plus `cell_off` where given); the gate only marks slots valid,
    so an invalid slot keeps its cell's coordinates. Padded to `quota`
    (level 0 everywhere, as the JAX function returns)."""
    dev = cell_max.device
    n_cells = cell_max.shape[0]
    cells = torch.arange(n_cells, dtype=torch.int64, device=dev)
    u = ((cells % grid_cols) * cell_size + cell_arg.long() % cell_size).to(torch.float32)
    v = ((cells // grid_cols) * cell_size + cell_arg.long() // cell_size).to(torch.float32)
    k = min(quota, n_cells)
    order = torch.sort(cell_max, descending=True, stable=True)
    top_scores, top_idx = order.values[:k], order.indices[:k]
    uv = torch.stack([u[top_idx], v[top_idx]], dim=-1)
    if cell_off is not None:
        uv = uv + cell_off[top_idx]
    valid = torch.isfinite(top_scores) & (top_scores > min_response)
    level = torch.zeros((k,), dtype=torch.int32, device=dev)
    return _pad_keypoints(uv, level, top_scores, valid, quota)


def detect_keypoints_level(
    img: torch.Tensor,
    quota: int,
    cell_size: int,
    fast_threshold,
    min_response,
    min_border: int,
    use_fast_gate: bool = True,
    response: str = "fast_st",
    subpixel: bool = False,
) -> Keypoints:
    """Detection on one level of the x`scale_factor` pyramid into `quota`
    slots, in level pixel coordinates (JAX fast.py:285-357; the grid's
    best-per-cell plays DistributeOctTree's role,
    Features/ORBextractor.cpp:421-611): the per-level counterpart of the JAX
    function. K1's dense kernel for `fast_st` on a CUDA level (the x1.2
    builds call `detect_keypoints_scaled` instead), its plain version on a
    CPU one. Unlike `detect_keypoints`, the top `quota` cells are ranked by
    their ungated maxima and the gate (`min_response`: a float or a 0-dim
    tensor) only marks slots valid, so an invalid slot keeps its cell's
    coordinates."""
    score, raw = level_score_map(img, fast_threshold, use_fast_gate, response)
    cell_max, cell_arg, cell_off = _level_cells(score, raw if subpixel else None, cell_size,
                                                min_border)
    return _rank_level(cell_max, cell_arg, cell_off, img.shape[1] // cell_size, cell_size,
                       quota, min_response)


def detect_scaled_cells_ref(pyramid: List[torch.Tensor], quotas: List[int], cell_size: int,
                            fast_threshold, min_border: int, use_fast_gate: bool = True,
                            subpixel: bool = False):
    """Kernel A's x1.2 mode, plain: per level with a positive quota its
    masked map (K1's plain version), the border gate in the level's own
    pixels and the best of each cell_size cell of its own grid, the levels
    end to end: (cell_max (C,) f32, cell_arg (C,) int32, cell_off (C, 2) f32
    with `subpixel`, else None)."""
    from rgbdslam_tpu_torch.ops import kernels

    parts = []
    for img, quota in zip(pyramid, quotas):
        if quota > 0:
            masked, raw = kernels.detect_score_map_ref(img, fast_threshold, use_fast_gate)
            parts.append(_level_cells(masked, raw if subpixel else None, cell_size, min_border))
    cell_max = torch.cat([p[0] for p in parts])
    cell_arg = torch.cat([p[1] for p in parts])
    return cell_max, cell_arg, torch.cat([p[2] for p in parts]) if subpixel else None


def detect_scaled_select_ref(cell_max: torch.Tensor, cell_arg: torch.Tensor,
                             cell_off: Optional[torch.Tensor], shapes, quotas: List[int],
                             cell_size: int, min_response) -> Keypoints:
    """Kernel C, plain: each level's cells (the levels of `shapes` with a
    positive quota, end to end in `cell_max`) ranked into its quota of slots
    by `_rank_level`, the slots in level order with their level. uv in level
    pixels; `min_response` a float or the 0-dim tensor of `response_gate`."""
    parts, first = [], 0
    for lvl, ((h, w), quota) in enumerate(zip(shapes, quotas)):
        if quota <= 0:
            continue
        n = (h // cell_size) * (w // cell_size)
        sl = slice(first, first + n)
        kp = _rank_level(cell_max[sl], cell_arg[sl], None if cell_off is None else cell_off[sl],
                         w // cell_size, cell_size, quota, min_response)
        parts.append(kp._replace(level=torch.full_like(kp.level, lvl)))
        first += n
    return Keypoints(*(torch.cat(f) for f in zip(*parts)))


def detect_keypoints_scaled_ref(pyramid: List[torch.Tensor], quotas: List[int],
                                cell_size: int, fast_threshold, min_response: float,
                                min_border: int, use_fast_gate: bool = True,
                                gate_threshold: Optional[float] = None,
                                subpixel: bool = False) -> Keypoints:
    """Plain version of `detect_keypoints_scaled`, in the two halves that
    kernels A and C take (`detect_scaled_cells_ref`,
    `detect_scaled_select_ref`)."""
    cell_max, cell_arg, cell_off = detect_scaled_cells_ref(
        pyramid, quotas, cell_size, fast_threshold, min_border, use_fast_gate, subpixel)
    return detect_scaled_select_ref(cell_max, cell_arg, cell_off,
                                    [tuple(p.shape) for p in pyramid], quotas, cell_size,
                                    response_gate(min_response, fast_threshold, gate_threshold))


def detect_keypoints_scaled(pyramid: List[torch.Tensor], quotas: List[int], cell_size: int,
                            fast_threshold, min_response: float, min_border: int,
                            use_fast_gate: bool = True,
                            gate_threshold: Optional[float] = None,
                            subpixel: bool = False) -> Keypoints:
    """The `fast_st` detection of the x1.2 scale space (JAX frame.py:166-207
    calling fast.py:285-357 once a level): per level with a positive quota
    the top `quotas[l]` cells of its own grid by their ungated maxima, the
    border in the level's pixels, the response gate (`response_gate`) only
    marking slots valid. The slots come out in level order with their
    level, uv in level pixels (with `subpixel` moved by the parabola offsets
    at the winners). Two launches of csrc/detect.cu for a CUDA pyramid
    (`kernels.detect_keypoints_scaled`), the plain version for a CPU one."""
    from rgbdslam_tpu_torch.ops import kernels

    if kernels.on_cuda(*pyramid):
        return kernels.detect_keypoints_scaled(pyramid, quotas, cell_size, fast_threshold,
                                               min_response, min_border, use_fast_gate,
                                               gate_threshold, subpixel)[0]
    return detect_keypoints_scaled_ref(pyramid, quotas, cell_size, fast_threshold,
                                       min_response, min_border, use_fast_gate, gate_threshold,
                                       subpixel)


# ---------------------------------------------------------------------------
# The other detector responses of the factory (Features/Extractor.h:13-26:
# STAR, SIFT, SURF), JAX fast.py:364-425. Each gives a dense per-level
# response whose 3x3 maxima feed the same grid NMS and top-N budget.
# ---------------------------------------------------------------------------


def star_response_map(img: torch.Tensor, inner: int = 2, outer: int = 4) -> torch.Tensor:
    """CenSurE/STAR-style centre-surround response |mean(inner box) -
    mean(surrounding ring)| with axis-aligned boxes, in the arithmetic XLA's
    CPU code gives it: the divisions by the static areas are products with
    their f32 reciprocals, and s_in * (1 / a_in) - ring is one fused
    multiply-add (written here in float64, where the product of two f32
    values is exact)."""
    a_in = float((2 * inner + 1) ** 2)
    a_out = float((2 * outer + 1) ** 2)
    s_in = image_ops.box_filter_sum_xla(img, inner)
    s_out = image_ops.box_filter_sum_xla(img, outer)
    ring = (s_out - s_in) * float(f32_reciprocal(a_out - a_in))
    fused = s_in.double() * float(f32_reciprocal(a_in)) - ring.double()
    return torch.abs(fused.to(torch.float32))


def dog_response_map(img: torch.Tensor, sigma: float = 1.2, k: float = 1.6) -> torch.Tensor:
    """SIFT-style difference-of-Gaussians magnitude (intra-octave)."""
    r1 = max(1, int(3 * sigma))
    r2 = max(1, int(3 * sigma * k))
    g1 = image_ops.gaussian_blur(img, sigma=sigma, radius=r1)
    g2 = image_ops.gaussian_blur(img, sigma=sigma * k, radius=r2)
    return torch.abs(g1 - g2)


def hessian_response_map(img: torch.Tensor, radius: int = 2) -> torch.Tensor:
    """SURF-style box-filter Hessian determinant, Dxx*Dyy - (0.9*Dxy)^2 on a
    box-smoothed image, floored at 0."""
    s = image_ops.box_filter_sum_xla(img, radius) * float(
        f32_reciprocal(float((2 * radius + 1) ** 2)))
    dxx = _shift_np(s, 0, 2) - 2.0 * s + _shift_np(s, 0, -2)
    dyy = _shift_np(s, 2, 0) - 2.0 * s + _shift_np(s, -2, 0)
    dxy = 0.25 * (_shift_np(s, 1, 1) - _shift_np(s, 1, -1)
                  - _shift_np(s, -1, 1) + _shift_np(s, -1, -1))
    t = 0.9 * dxy
    return torch.clamp_min(dxx * dyy - t * t, 0.0)


def _shift_np(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """b[y, x] = a[y+dy, x+dx], zero-filled."""
    h, w = a.shape
    out = torch.zeros_like(a)
    ys, yd = (slice(dy, h), slice(0, h - dy)) if dy >= 0 else (slice(0, h + dy), slice(-dy, h))
    xs, xd = (slice(dx, w), slice(0, w - dx)) if dx >= 0 else (slice(0, w + dx), slice(-dx, w))
    out[yd, xd] = a[ys, xs]
    return out


RESPONSE_MAPS = {
    "star": star_response_map,
    "dog": dog_response_map,
    "hessian": hessian_response_map,
}


def response_masked_score(img: torch.Tensor, response: str):
    """(masked, raw) for an alternative response: the dense response and its
    3x3 maxima (-inf elsewhere)."""
    score = RESPONSE_MAPS[response](img)
    return torch.where(nms3x3(score), score, float("-inf")), score
