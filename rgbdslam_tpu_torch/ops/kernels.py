"""Hand-written CUDA kernels of the tracking step, of the keyframe
backend's candidate verification and of the loop solve, their launch
wrappers and their plain PyTorch versions (counterpart of
rgbdslam_tpu/ops/pallas_kernels.py).

| Kernel (csrc/)           | Replaces (pallas_kernels.py)          | Plain version              |
|--------------------------|---------------------------------------|----------------------------|
| detect.cu   (K1, dense; GFTT mode too) | detect_score_map, 320-397 | detect_score_map_ref |
| detect.cu   (K1, whole half-sample detection) | the same, with the rest of detect_keypoints | ops.fast.detect_keypoints_ref |
| detect.cu   (K1, whole x1.2 detection) | the same, with detect_keypoints_level on every level | ops.fast.detect_keypoints_scaled_ref |
| hamming.cu  (K2)         | hamming_match_2nn, 87-150             | hamming_match_2nn_ref      |
| hamming.cu  (K2's gates) | the gates XLA fused behind it         | match_gates_ref            |
| mahal.cu    (K3)         | mahal_hypothesis_scores, 480-526      | mahal_hypothesis_scores_ref|
| mahal.cu    (K3, whole RANSAC) | the same, with the rest of ransac_se3 | solvers.ransac_se3.ransac_se3_ref |
| gicp.cu     (K4, whole gicp_refine) | gicp_refine_kernel, 791-825, with gicp_refine's gate | gicp_refine_ref + solvers.icp._finish_gicp |
| gicp.cu     (K5)         | gicp_gn_normal_equations, 829-862     | gicp_gn_normal_equations_ref|
| pose_graph.cu (SE(3) LM) | none (XLA's jacfwd program)           | pose_graph's plain _dense_lm |

The TPU kernels sat inside programs XLA fused around them; eager PyTorch
launches every op, so on this card `detect_keypoints_fused` (the whole
half-sample detection, subpixel offsets included, two launches),
`detect_keypoints_scaled` (the whole x1.2 scale-space detection, every
level, two launches), `match_gated` (2-NN and gates, two launches),
`ransac_se3_fused` (the whole RANSAC, two launches) and `gicp_refine_fused`
(loop, gate and fallback, one launch) are what the main paths call.
`hamming_match_2nn` stays as the first of `match_gated`'s two launches. The
direct counterparts of K1 (`detect_score_map`, the dense maps of one level;
also behind `fast.detect_keypoints_level`), of K3
(`mahal_hypothesis_scores`) and K5 are reached through their public entries
(those, `icp.gicp_normal_equations`) and lie on no main path.
`pose_graph_normal_equations` and `pose_graph_trial` are the dense SE(3)
loop solve's iteration (`solvers.pose_graph.optimize_pose_graph` on the
card): one launch each around the library's dense solve.

K2 and K3 take an optional leading batch dimension (the same launches
whatever the batch): the keyframe backend verifies all its candidate
keyframes against the current frame at once.

A wrapper (`detect_score_map`, ...) takes CUDA tensors only: it checks
device, dtype, shape and contiguity, allocates its outputs, launches on the
current stream without synchronising, raises if the launch failed, and adds
one to its entry in `LAUNCHES`. The public functions of the pipeline
(`fast.detect_keypoints`, `matcher.match_descriptors`, `ransac_se3`,
`icp.gicp_refine`) pick the wrapper for CUDA tensors and the plain version
for CPU tensors (`on_cuda`); nothing falls back from one to the other, and
no plain version launches a kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch

from rgbdslam_tpu_torch.ops import fast, hamming

BIG = hamming.BIG_DIST

# launches per wrapper since the last reset_launch_counts()
LAUNCHES = {
    "detect_score_map": 0,
    "detect_keypoints_fused": 0,
    "detect_keypoints_scaled": 0,
    "hamming_match_2nn": 0,
    "match_gates": 0,
    "mahal_hypothesis_scores": 0,
    "ransac_se3_fused": 0,
    "gicp_refine_fused": 0,
    "gicp_gn_normal_equations": 0,
    "pose_graph_normal_equations": 0,
    "pose_graph_trial": 0,
}


# of those, the launches that carried a batch dimension (K2 and K3)
BATCHED_LAUNCHES = {"hamming_match_2nn": 0, "match_gates": 0,
                    "mahal_hypothesis_scores": 0, "ransac_se3_fused": 0}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, BATCHED_LAUNCHES):
        for k in counts:
            counts[k] = 0


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True if every tensor lies on a CUDA device, False if every one lies
    on the CPU; raises for a mix or another device type."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on devices {sorted(kinds)}: expected all on "
                     "one CUDA device or all on the CPU")


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if len(shape) != t.dim() or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _launch(fn_name: str, device: torch.device, *args) -> None:
    from rgbdslam_tpu_torch.ops import _build

    lib = _build.library()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(lib, fn_name)(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed with cudaError {err}")


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


# ---------------------------------------------------------------------------
# K1: fused FAST + Shi-Tomasi + 3x3 NMS
# ---------------------------------------------------------------------------


def _threshold_on(fast_threshold, dev: torch.device) -> torch.Tensor:
    """The FAST threshold as a 0-dim f32 tensor on `dev`: a tensor given
    there is taken as it is, a float becomes a cached device scalar."""
    if isinstance(fast_threshold, torch.Tensor):
        _check(fast_threshold, "fast_threshold", torch.float32, ())
        if fast_threshold.device != dev:
            raise ValueError(f"fast_threshold on {fast_threshold.device}, image on {dev}")
        return fast_threshold
    return _device_scalar(float(fast_threshold), dev)


def detect_score_map(img: torch.Tensor, fast_threshold, use_fast_gate: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(masked, raw) score maps of one pyramid level, by csrc/detect.cu.

    img: (H, W) f32 CUDA. masked is the Shi-Tomasi score (9x9 box) where the
    pixel is a FAST-10 corner (with `use_fast_gate`; every pixel in the GFTT
    mode) winning its 3x3 neighbourhood, -inf elsewhere; raw is the dense
    Shi-Tomasi map. fast_threshold: a float, or a 0-dim f32 tensor on the
    image's device; the kernel reads it from device memory either way."""
    _check(img, "img", torch.float32, (None, None))
    h, w = img.shape
    thr = _threshold_on(fast_threshold, img.device)
    out = torch.empty_like(img)
    raw = torch.empty_like(img)
    _launch("rgbd_detect_score_map", img.device, _ptr(img), h, w, _ptr(thr),
            int(bool(use_fast_gate)), _ptr(out), _ptr(raw))
    LAUNCHES["detect_score_map"] += 1
    return out, raw


def detect_score_map_ref(img: torch.Tensor, fast_threshold, use_fast_gate: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: the fast_corner_mask / shi_tomasi_map / nms3x3
    composition (rgbdslam_tpu/ops/fast.py:114-140); without the FAST gate
    (GFTT) every pixel is a candidate."""
    score = fast.shi_tomasi_map(img)
    if not use_fast_gate:
        return torch.where(fast.nms3x3(score), score, float("-inf")), score
    corners = fast.fast_corner_mask(img, fast_threshold)
    corner_score = torch.where(corners, score, float("-inf"))
    keep = corners & fast.nms3x3(corner_score)
    return torch.where(keep, score, float("-inf")), score


#: the widest cell kernel A's tiles hold whole (csrc/detect.cu TW); a wider
#: cell is reduced by one block over its 32 x 16 sub-tiles
DETECT_TILE_CELL = 32


def whole_cell_tile(cell: int) -> Tuple[int, int]:
    """(width, height) of kernel A's tile for cells of `cell` pixels: whole
    cells, cell * max(1, 32 // cell) by cell * max(1, 16 // cell), and for a
    cell wider than 32 pixels the 32 x 16 sub-tile its block walks
    (csrc/detect.cu whole_cell_tile)."""
    if cell > DETECT_TILE_CELL:
        return DETECT_TILE_CELL, 16
    return cell * max(1, 32 // cell), cell * max(1, 16 // cell)


@functools.lru_cache(maxsize=256)
def _device_scalar(value: float, device: torch.device) -> torch.Tensor:
    """`value` as a 0-dim f32 tensor on `device`, written there by a fill
    kernel (no host wait) once per value: the FAST thresholds a run uses are
    few, and a constant never rewritten is safe on any stream."""
    return torch.full((), value, dtype=torch.float32, device=device)


def _detect_level_checks(entry: str, levels: List[torch.Tensor], cells) -> None:
    """A detection's pyramid against its cells: each level's grid inside its
    image (checked before the device), then f32 CUDA images."""
    for lvl, (img, (cell_l, rows, cols)) in enumerate(zip(levels, cells)):
        if img.shape[0] < rows * cell_l or img.shape[1] < cols * cell_l:
            raise ValueError(f"{entry}, level {lvl}: {tuple(img.shape)} pixels do not hold "
                             f"{rows}x{cols} cells of {cell_l}x{cell_l}")
    for lvl, img in enumerate(levels):
        _check(img, f"pyramid[{lvl}]", torch.float32, (None, None))


def _whole(entry: str, cell_size, min_border) -> None:
    if int(cell_size) != cell_size or int(min_border) != min_border or cell_size < 1:
        raise ValueError(f"{entry} takes a whole cell_size >= 1 and a whole min_border")


def detect_keypoints_fused(pyramid: List[torch.Tensor], num_features: int, cell_size: int,
                           fast_threshold, min_response: float, min_border: int,
                           use_fast_gate: bool = True, gate_threshold: Optional[float] = None,
                           subpixel: bool = False):
    """The whole keypoint detection of the half-sample pyramid in two
    launches of csrc/detect.cu (see its header): kernel A finds the best
    corner of every grid cell on every pyramid level, kernel B merges the
    levels, gates by `min_response`, ranks the cells and writes the
    `num_features` keypoint slots.

    pyramid: the levels `build_pyramid` returns, (H >> l, W >> l) f32 CUDA
    each; levels whose cell (cell_size >> l) has no pixel are not read, as in
    the plain version. fast_threshold: a float, or a 0-dim f32 tensor on the
    pyramid's device (the batched tracker's device-evolved threshold); kernel
    A reads it from device memory either way. use_fast_gate=False: the GFTT
    mode (every pixel a candidate). gate_threshold: the configured FAST
    threshold when the response gate scales with the threshold (kernel B
    then gates by thr^2 * `fast.gate_scale` from the device threshold, as
    `fast.response_gate`); None gates by min_response. subpixel: kernel A
    also writes the parabola offsets at every cell's winner, and kernel B
    moves each slot by its winning level's, scaled to level 0.

    Returns (`fast.Keypoints`, (cell_max (L, n_cells) f32, cell_arg (L,
    n_cells) int32[, cell_off (L * n_cells + 1, 2) f32 with subpixel])), what
    `fast.detect_select_ref` and `fast.detect_cells_ref` return."""
    entry = "detect_keypoints_fused"
    _whole(entry, cell_size, min_border)
    if num_features < 1 or not pyramid:
        raise ValueError(f"{entry} needs at least one level and one slot")
    levels = pyramid[:fast.used_levels(len(pyramid), cell_size)]
    L = len(levels)
    h0, w0 = pyramid[0].shape
    grid_rows, grid_cols = h0 // cell_size, w0 // cell_size
    n_cells = grid_rows * grid_cols
    if n_cells < 1:
        raise ValueError(f"{entry}: a {h0}x{w0} image holds no cell of {cell_size} pixels")
    _detect_level_checks(entry, levels, [(cell_size >> lvl, grid_rows, grid_cols)
                                         for lvl in range(L)])
    dev = levels[0].device
    thr = _threshold_on(fast_threshold, dev)
    scale_gate = gate_threshold is not None
    k_gate = float(fast.gate_scale(min_response, gate_threshold)) if scale_gate else 0.0
    cell_max = torch.empty((L, n_cells), dtype=torch.float32, device=dev)
    cell_arg = torch.empty((L, n_cells), dtype=torch.int32, device=dev)
    cell_off = (torch.empty((L * n_cells + 1, 2), dtype=torch.float32, device=dev)
                if subpixel else None)
    uv = torch.empty((num_features, 2), dtype=torch.float32, device=dev)
    level = torch.empty((num_features,), dtype=torch.int32, device=dev)
    score = torch.empty((num_features,), dtype=torch.float32, device=dev)
    valid = torch.empty((num_features,), dtype=torch.bool, device=dev)
    imgs = (ctypes.c_void_p * L)(*[img.data_ptr() for img in levels])
    hs = (ctypes.c_int * L)(*[img.shape[0] for img in levels])
    ws = (ctypes.c_int * L)(*[img.shape[1] for img in levels])
    _launch("rgbd_detect_keypoints", dev, imgs, hs, ws, L, int(cell_size), grid_rows,
            grid_cols, _ptr(thr), int(bool(use_fast_gate)), int(min_border),
            float(min_response), int(scale_gate), k_gate, int(num_features), int(subpixel),
            _ptr(cell_max), _ptr(cell_arg), _ptr(cell_off), _ptr(uv), _ptr(level),
            _ptr(score), _ptr(valid))
    LAUNCHES["detect_keypoints_fused"] += 1
    cells = (cell_max, cell_arg) + ((cell_off,) if subpixel else ())
    return fast.Keypoints(uv=uv, level=level, score=score, valid=valid), cells


def detect_keypoints_scaled(pyramid: List[torch.Tensor], quotas: List[int], cell_size: int,
                            fast_threshold, min_response: float, min_border: int,
                            use_fast_gate: bool = True, gate_threshold: Optional[float] = None,
                            subpixel: bool = False):
    """The whole detection of the x1.2 scale space in two launches of
    csrc/detect.cu (see its header): kernel A in its x1.2 mode finds the
    best corner of every cell_size cell of each level's own grid (the border
    in the level's pixels; with `subpixel` the parabola offsets at the
    winners), kernel C ranks each level's cells by their ungated maxima into
    its `quotas[l]` slots and marks a slot valid where its maximum is finite
    and above the gate.

    pyramid: the levels `build_scaled_pyramid` returns, f32 CUDA; quotas:
    `fast.level_quotas`, one per level (a level with quota <= 0 is not read
    and has no slots). fast_threshold, use_fast_gate, gate_threshold: as
    `detect_keypoints_fused`.

    Returns (`fast.Keypoints` with the slots of the levels in level order,
    uv in level pixels, (cell_max (C,) f32, cell_arg (C,) int32, cell_off
    (C, 2) f32 or None)), what `fast.detect_scaled_select_ref` and
    `fast.detect_scaled_cells_ref` return."""
    entry = "detect_keypoints_scaled"
    _whole(entry, cell_size, min_border)
    if len(quotas) != len(pyramid):
        raise ValueError(f"{entry}: {len(quotas)} quotas for {len(pyramid)} levels")
    n_slots = sum(max(int(q), 0) for q in quotas)
    if n_slots < 1:
        raise ValueError(f"{entry} needs at least one slot")
    grids = [(h // cell_size, w // cell_size) if q > 0 else (0, 0)
             for (h, w), q in zip((p.shape for p in pyramid), quotas)]
    _detect_level_checks(entry, pyramid, [(int(cell_size), r, c) for r, c in grids])
    L = len(pyramid)
    dev = pyramid[0].device
    thr = _threshold_on(fast_threshold, dev)
    scale_gate = gate_threshold is not None
    k_gate = float(fast.gate_scale(min_response, gate_threshold)) if scale_gate else 0.0
    n_cells = sum(r * c for r, c in grids)
    cell_max = torch.empty((n_cells,), dtype=torch.float32, device=dev)
    cell_arg = torch.empty((n_cells,), dtype=torch.int32, device=dev)
    cell_off = (torch.empty((n_cells, 2), dtype=torch.float32, device=dev)
                if subpixel else None)
    uv = torch.empty((n_slots, 2), dtype=torch.float32, device=dev)
    level = torch.empty((n_slots,), dtype=torch.int32, device=dev)
    score = torch.empty((n_slots,), dtype=torch.float32, device=dev)
    valid = torch.empty((n_slots,), dtype=torch.bool, device=dev)
    imgs = (ctypes.c_void_p * L)(*[img.data_ptr() for img in pyramid])
    hs = (ctypes.c_int * L)(*[img.shape[0] for img in pyramid])
    ws = (ctypes.c_int * L)(*[img.shape[1] for img in pyramid])
    qs = (ctypes.c_int * L)(*[int(q) for q in quotas])
    _launch("rgbd_detect_scaled", dev, imgs, hs, ws, qs, L, int(cell_size), _ptr(thr),
            int(bool(use_fast_gate)), int(min_border), float(min_response), int(scale_gate),
            k_gate, int(subpixel), _ptr(cell_max), _ptr(cell_arg), _ptr(cell_off), _ptr(uv),
            _ptr(level), _ptr(score), _ptr(valid))
    LAUNCHES["detect_keypoints_scaled"] += 1
    return (fast.Keypoints(uv=uv, level=level, score=score, valid=valid),
            (cell_max, cell_arg, cell_off))


# ---------------------------------------------------------------------------
# K2: 256-bit Hamming 2-NN with column best
# ---------------------------------------------------------------------------


def hamming_match_2nn(desc1: torch.Tensor, desc2: torch.Tensor,
                      valid1: torch.Tensor, valid2: torch.Tensor):
    """(best_idx [N], best_dist [N], second_dist [N], col_best_row [M]) by
    csrc/hamming.cu. desc: (N, 8) / (M, 8) int32 words of 32 bits; valid:
    bool. Pairs with an invalid end have distance BIG; ties go to the lowest
    index; a row with no valid pair gets index 0 and distances BIG.

    Either side may carry a leading batch dimension ((B, N, 8) with
    (B, N) validity); the other is then shared by every entry or batched
    alike, and every output gains the batch dimension. One launch."""
    b1, b2 = desc1.dim() == 3, desc2.dim() == 3
    batch = desc1.shape[0] if b1 else (desc2.shape[0] if b2 else 1)
    lead = (batch,) if (b1 or b2) else ()
    n, m = desc1.shape[-2], desc2.shape[-2]
    _check(desc1, "desc1", torch.int32, ((batch,) if b1 else ()) + (n, 8))
    _check(desc2, "desc2", torch.int32, ((batch,) if b2 else ()) + (m, 8))
    _check(valid1, "valid1", torch.bool, ((batch,) if b1 else ()) + (n,))
    _check(valid2, "valid2", torch.bool, ((batch,) if b2 else ()) + (m,))
    if n < 1 or m < 1 or batch < 1:
        raise ValueError("hamming_match_2nn needs at least one query and one train row")
    dev = desc1.device
    best_idx = torch.empty(lead + (n,), dtype=torch.int32, device=dev)
    best_dist = torch.empty(lead + (n,), dtype=torch.int32, device=dev)
    second = torch.empty(lead + (n,), dtype=torch.int32, device=dev)
    col_best = torch.empty(lead + (m,), dtype=torch.int32, device=dev)
    _launch("rgbd_hamming_match_2nn", dev, _ptr(desc1), _ptr(desc2),
            _ptr(valid1), _ptr(valid2), n, m, batch, int(b1), int(b2),
            _ptr(best_idx), _ptr(best_dist), _ptr(second), _ptr(col_best))
    LAUNCHES["hamming_match_2nn"] += 1
    BATCHED_LAUNCHES["hamming_match_2nn"] += int(b1 or b2)
    return best_idx, best_dist, second, col_best


def hamming_match_2nn_ref(desc1, desc2, valid1, valid2):
    """Plain version of K2: the N x M distance matrix + knn2 + column
    argmin (rgbdslam_tpu/ops/hamming.py:45-90). The matrix comes from the
    matmul form, which gives the integers of XOR + popcount at a fraction
    of their cost on a CPU. A batch is a loop over its entries."""
    b1, b2 = desc1.dim() == 3, desc2.dim() == 3
    if b1 or b2:
        batch = desc1.shape[0] if b1 else desc2.shape[0]
        outs = [hamming_match_2nn_ref(desc1[i] if b1 else desc1,
                                      desc2[i] if b2 else desc2,
                                      valid1[i] if b1 else valid1,
                                      valid2[i] if b2 else valid2)
                for i in range(batch)]
        return tuple(torch.stack(o) for o in zip(*outs))
    d = hamming.hamming_distance_matrix(desc1, desc2, valid1, valid2, impl="matmul")
    best_idx, best_dist, second = hamming.knn2(d)
    col_best = torch.argmin(d, dim=0).to(torch.int32)
    return best_idx, best_dist, second, col_best


def match_gates(best_idx: torch.Tensor, best_dist: torch.Tensor, second: torch.Tensor,
                col_best: torch.Tensor, valid1: torch.Tensor, ratio: float
                ) -> torch.Tensor:
    """The matcher's gates on `hamming_match_2nn`'s outputs, one launch of
    csrc/hamming.cu: match i -> best_idx[i] is valid iff float(best) < ratio
    * float(second) in f32, i is the best query of train row best_idx[i],
    valid1[i] and best < BIG (which holds only where the train row is valid
    too). best_idx, best_dist, second (N,) and col_best (M,) int32, all with or all without one batch
    dimension; valid1 (N,) or (B, N). Returns valid, shaped like best_idx."""
    lead = tuple(best_idx.shape[:-1])
    if len(lead) > 1:
        raise ValueError("match_gates takes at most one batch dimension")
    n, m = best_idx.shape[-1], col_best.shape[-1]
    batch = lead[0] if lead else 1
    for t, name in ((best_idx, "best_idx"), (best_dist, "best_dist"), (second, "second")):
        _check(t, name, torch.int32, lead + (n,))
    _check(col_best, "col_best", torch.int32, lead + (m,))
    b1 = valid1.dim() == 2
    _check(valid1, "valid1", torch.bool, (lead if b1 else ()) + (n,))
    valid = torch.empty(lead + (n,), dtype=torch.bool, device=best_idx.device)
    _launch("rgbd_match_gates", best_idx.device, _ptr(best_idx), _ptr(best_dist),
            _ptr(second), _ptr(col_best), _ptr(valid1), n, m, batch, int(b1),
            float(ratio), _ptr(valid))
    LAUNCHES["match_gates"] += 1
    BATCHED_LAUNCHES["match_gates"] += int(bool(lead))
    return valid


def match_gates_ref(best_idx, best_dist, second, col_best, valid1, ratio: float
                    ) -> torch.Tensor:
    """Plain version of `match_gates`: the gates of
    rgbdslam_tpu/frontend/matcher.py:96-110 as tensor code."""
    ratio_ok = best_dist.to(torch.float32) < ratio * second.to(torch.float32)
    rows = torch.arange(best_idx.shape[-1], dtype=torch.int32, device=best_idx.device)
    j = best_idx.long()
    mutual = torch.gather(col_best, -1, j) == rows
    return ratio_ok & mutual & valid1 & (best_dist < BIG)


def match_gated(desc1: torch.Tensor, desc2: torch.Tensor, valid1: torch.Tensor,
                valid2: torch.Tensor, ratio: float):
    """(idx2, dist, valid) of the gated matcher in two launches:
    `hamming_match_2nn`, then `match_gates`."""
    best_idx, best_dist, second, col_best = hamming_match_2nn(desc1, desc2, valid1, valid2)
    return best_idx, best_dist, match_gates(best_idx, best_dist, second, col_best,
                                            valid1, ratio)


def match_gated_ref(desc1, desc2, valid1, valid2, ratio: float):
    """Plain version of `match_gated`."""
    best_idx, best_dist, second, col_best = hamming_match_2nn_ref(
        desc1, desc2, valid1, valid2)
    return best_idx, best_dist, match_gates_ref(best_idx, best_dist, second, col_best,
                                                valid1, ratio)


# ---------------------------------------------------------------------------
# K3: Mahalanobis hypothesis scorer
# ---------------------------------------------------------------------------


#: the scorer alone (csrc/mahal.cu, mahal_scores_kernel): threads a block
#: and blocks a cluster at most
SCORER_THREADS, SCORER_MAX_CHUNKS = 128, 8


def scorer_chunks(n: int) -> int:
    """Blocks of a cluster that share one group's n points: one pass of
    SCORER_THREADS points each, at most SCORER_MAX_CHUNKS (then several
    passes), at least one. Block r takes the points [r span, (r + 1) span),
    span = ceil(n / chunks)."""
    return min(SCORER_MAX_CHUNKS, max(1, -(-n // SCORER_THREADS)))


def scorer_group(h: int, n: int, batch: int, sms: int) -> int:
    """Hypotheses a block of the scorer: 8, so that a point is read H / 8
    times, once the grid then has two blocks for each of the card's `sms`
    SMs; else 4 (twice the blocks, to hide latency where the grid is small:
    H = 256, N = 1024 unbatched). Which block scores a hypothesis does not
    change the order of its sums: the results do not depend on it."""
    return 8 if -(-h // 8) * scorer_chunks(n) * batch >= 2 * sms else 4


def mahal_hypothesis_scores(T_h: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                            s1: torch.Tensor, s2: torch.Tensor,
                            valid: torch.Tensor, th: float):
    """Inlier count (H,) int32 and sum of m^2 over inliers (H,) f32 per
    hypothesis, by csrc/mahal.cu. T_h (H, 4, 4); p1, p2, s1, s2 (N, 3) f32
    (s = diagonal sensor covariances); valid (N,) bool; th = max m^2.

    With a leading batch dimension on every argument (T_h (B, H, 4, 4),
    points (B, N, 3), valid (B, N)) the outputs are (B, H). One launch: a
    cluster of `scorer_chunks(N)` blocks a group of `scorer_group(...)`
    hypotheses and batch entry, the chunks' sums combined in rank order, so
    an entry's results do not depend on the batch around it."""
    batched = T_h.dim() == 4
    lead = (T_h.shape[0],) if batched else ()
    H, N = T_h.shape[-3], p1.shape[-2]
    _check(T_h, "T_h", torch.float32, lead + (H, 4, 4))
    for t, name in ((p1, "p1"), (p2, "p2"), (s1, "s1"), (s2, "s2")):
        _check(t, name, torch.float32, lead + (N, 3))
    _check(valid, "valid", torch.bool, lead + (N,))
    dev = T_h.device
    cnt = torch.empty(lead + (H,), dtype=torch.int32, device=dev)
    err = torch.empty(lead + (H,), dtype=torch.float32, device=dev)
    if cnt.numel() == 0:
        return cnt, err
    B = lead[0] if batched else 1
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _launch("rgbd_mahal_hypothesis_scores", dev, _ptr(T_h), _ptr(p1), _ptr(p2),
            _ptr(s1), _ptr(s2), _ptr(valid), B, H, N, scorer_chunks(N),
            scorer_group(H, N, B, sms), float(th), _ptr(cnt), _ptr(err))
    LAUNCHES["mahal_hypothesis_scores"] += 1
    BATCHED_LAUNCHES["mahal_hypothesis_scores"] += int(batched)
    return cnt, err


def mahal_hypothesis_scores_ref(T_h, p1, p2, s1, s2, valid, th: float):
    """Plain version of K3: the plane-form m^2 of
    rgbdslam_tpu/solvers/ransac_se3.py:84-129 + the count/sum of 183-189,
    batched alike."""
    from rgbdslam_tpu_torch.solvers.ransac_se3 import mahalanobis_sq_planes

    m2 = mahalanobis_sq_planes(T_h, p1, p2, s1, s2)      # (..., H, N)
    inl = (m2 <= th) & valid[..., None, :]
    cnt = torch.sum(inl, dim=-1).to(torch.int32)
    err = torch.sum(torch.where(inl, m2, 0.0), dim=-1)
    return cnt, err


#: dynamic shared memory a block may use on sm_90, less kernel B's static part
_SELECT_SHARED_BYTES = 232448 - 2048
#: RansacConfig.error_model, in the order of csrc/mahal.cu's ErrorModel
ERROR_MODELS = ("mahalanobis", "euclidean", "adaptive_euclidean", "reprojection", "both")


def select_scratch_stride(n: int) -> int:
    """Bytes of one problem's planes (31 a slot: seven f32 planes, three of
    flags), rounded up to 16; 0 where they fit kernel B's shared memory."""
    return 0 if n * 31 <= _SELECT_SHARED_BYTES else (n * 31 + 15) & ~15


def ransac_se3_fused(p1: torch.Tensor, p2: torch.Tensor, w: torch.Tensor,
                     valid: torch.Tensor, u: Optional[torch.Tensor],
                     draws: Optional[torch.Tensor], num_hypotheses: int, sample_size: int,
                     error_model: str, params, refine_iters: int, min_inliers: int,
                     polish_iters: int = 0):
    """The whole RANSAC in two launches of csrc/mahal.cu (see its header):
    kernel A samples, fits and scores the H hypotheses, kernel B selects the
    winner, runs the masked refits and, with `polish_iters` > 0, the
    Mahalanobis polish (mahalanobis_refine).

    p1, p2 (N, 3) f32, w (N,) f32, valid (N,) bool, all with or all without
    one leading batch dimension. Exactly one of `u` ((H, S) f32 uniforms in
    [0, 1), scaled to the number of valid slots in the kernel) and `draws`
    ((H, S) int32 ranks among the valid slots) is given, batched alike; S =
    `sample_size`. error_model: one of ERROR_MODELS. params: 11 floats, the
    noise model's per-point covariance (cov_x z, cov_y z, (depth_std_factor
    z z)^2) as cov_x, cov_y, depth_std_factor; th, the largest m^2 of an
    inlier; the distance threshold (m), the adaptive coefficient and the
    pixel threshold; the camera's fx, fy, cx, cy (read by reprojection and
    both). Past what kernel B's shared memory holds (`select_scratch_stride`)
    its planes go to a scratch buffer allocated here.

    Returns (T21 (4, 4), inliers (N,) bool, num_inliers () int32, rmse ()
    f32, success () bool) and kernel A's (T_h (H, 4, 4), count (H,) int32,
    sum of errors (H,) f32), each with the batch dimension if given."""
    batched = p1.dim() == 3
    lead = (p1.shape[0],) if batched else ()
    N, H, S = p1.shape[-2], int(num_hypotheses), int(sample_size)
    for t, name in ((p1, "p1"), (p2, "p2")):
        _check(t, name, torch.float32, lead + (N, 3))
    _check(w, "w", torch.float32, lead + (N,))
    _check(valid, "valid", torch.bool, lead + (N,))
    if (u is None) == (draws is None):
        raise ValueError("ransac_se3_fused takes exactly one of u and draws")
    if u is not None:
        _check(u, "u", torch.float32, lead + (H, S))
    else:
        _check(draws, "draws", torch.int32, lead + (H, S))
    if N < 1 or H < 1 or S < 1 or (batched and lead[0] < 1):
        raise ValueError("ransac_se3_fused needs at least one correspondence slot, "
                         "one hypothesis, one sample and one problem")
    if error_model not in ERROR_MODELS:
        raise ValueError(f"unknown error_model {error_model!r}")
    params = (ctypes.c_float * 11)(*[float(v) for v in params])
    dev = p1.device
    B = lead[0] if batched else 1
    stride = select_scratch_stride(N)
    scratch = torch.empty((B * stride,), dtype=torch.uint8, device=dev) if stride else None
    T_h = torch.empty(lead + (H, 4, 4), dtype=torch.float32, device=dev)
    cnt_h = torch.empty(lead + (H,), dtype=torch.int32, device=dev)
    err_h = torch.empty(lead + (H,), dtype=torch.float32, device=dev)
    T = torch.empty(lead + (4, 4), dtype=torch.float32, device=dev)
    inliers = torch.empty(lead + (N,), dtype=torch.bool, device=dev)
    cnt = torch.empty(lead, dtype=torch.int32, device=dev)
    rmse = torch.empty(lead, dtype=torch.float32, device=dev)
    success = torch.empty(lead, dtype=torch.bool, device=dev)
    _launch("rgbd_ransac_se3", dev, _ptr(p1), _ptr(p2), _ptr(w), _ptr(valid),
            None if u is None else _ptr(u), None if draws is None else _ptr(draws),
            B, H, N, S, ERROR_MODELS.index(error_model), params, int(refine_iters),
            int(polish_iters), int(min_inliers), _ptr(scratch), stride,
            _ptr(T_h), _ptr(cnt_h), _ptr(err_h), _ptr(T), _ptr(inliers), _ptr(cnt),
            _ptr(rmse), _ptr(success))
    LAUNCHES["ransac_se3_fused"] += 1
    BATCHED_LAUNCHES["ransac_se3_fused"] += int(batched)
    return (T, inliers, cnt, rmse, success), (T_h, cnt_h, err_h)


# ---------------------------------------------------------------------------
# K4: the whole plane-to-plane GICP refinement
# ---------------------------------------------------------------------------


def _check_gicp_inputs(T, p1, p2, C1, C2, valid) -> int:
    N = p1.shape[0]
    _check(T, "T", torch.float32, (4, 4))
    for t, name in ((p1, "p1"), (p2, "p2")):
        _check(t, name, torch.float32, (N, 3))
    for t, name in ((C1, "C1"), (C2, "C2")):
        _check(t, name, torch.float32, (N, 3, 3))
    _check(valid, "valid", torch.bool, (N,))
    return N


#: correspondences `gicp_refine_fused` holds in shared memory (76 bytes
#: each); past them its planes go to a global scratch buffer
GICP_SHARED_POINTS = 3000


def gicp_refine_fused(T_init: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                      C1: torch.Tensor, C2: torch.Tensor, valid: torch.Tensor,
                      iters: int, max_dist: float, min_matches: int,
                      reassociate: bool = False):
    """The whole `gicp_refine` in one launch of csrc/gicp.cu: `iters` rounds
    of (normal equations -> damped 6x6 solve -> left SE(3) exp-compose) on
    inputs held as planes in shared memory (past GICP_SHARED_POINTS in a
    global scratch buffer allocated here), then the convergence gate (at
    least `min_matches` valid pairs, as many within `max_dist` at the final
    pose, a finite pose) and the fallback to T_init. With `reassociate`
    every round and the gate pair each point with its nearest valid target
    (IcpConfig.reassociate). The solve pivots like the plain version's LU;
    the Pallas kernel's Cholesky gave NaN on the indefinite H that real
    frames produce (see the note in gicp.cu).

    Returns ((T_out (4, 4), converged () bool, n_valid () int32), (T_fin
    (4, 4), cost (), count ())): what `_finish_gicp` returns, and the final
    pose with the gated plane-to-plane cost and correspondence count of the
    last round's build, as `gicp_refine_ref` returns them. All are views of
    one output buffer."""
    N = _check_gicp_inputs(T_init, p1, p2, C1, C2, valid)
    if N < 1:
        raise ValueError("gicp_refine_fused needs at least one correspondence")
    out = torch.empty((36,), dtype=torch.float32, device=T_init.device)
    planes = (torch.empty((19 * (N | 1),), dtype=torch.float32, device=T_init.device)
              if N > GICP_SHARED_POINTS else None)
    _launch("rgbd_gicp_refine_full", T_init.device, _ptr(T_init), _ptr(p1), _ptr(p2),
            _ptr(C1), _ptr(C2), _ptr(valid), N, int(iters), float(max_dist),
            float(max_dist) * float(max_dist), int(min_matches), int(bool(reassociate)),
            _ptr(planes), _ptr(out))
    LAUNCHES["gicp_refine_fused"] += 1
    n_valid = out[34:35].view(torch.int32)[0]
    converged = out[35:36].view(torch.bool)[0]      # the low byte of a 0 / 1 word
    return ((out[:16].view(4, 4), converged, n_valid),
            (out[16:32].view(4, 4), out[32], out[33]))


def gicp_refine_ref(T_init, p1, p2, C1, C2, valid, iters: int, max_dist: float,
                    reassociate: bool = False):
    """Plain version of K4's loop: the Gauss-Newton rounds of
    rgbdslam_tpu/solvers/icp.py:198-221, with `reassociate` re-pairing each
    point with its nearest valid target (and its C2) at the start of every
    round. Returns (T, cost, count) of the last round, like the kernels;
    `solvers.icp._finish_gicp` is the plain version of the gate behind it."""
    from rgbdslam_tpu_torch.solvers.icp import _gn_step, nearest_targets
    from rgbdslam_tpu_torch.solvers.ransac_se3 import _inv3x3

    T = T_init
    cost = torch.full((), float("inf"), dtype=T.dtype, device=T.device)
    count = torch.zeros((), dtype=T.dtype, device=T.device)
    for _ in range(iters):
        R = T[:3, :3]
        p2_i, C2_i = p2, C2
        if reassociate:
            j = nearest_targets(p1 @ R.T + T[:3, 3], p2, valid)
            p2_i, C2_i = p2[j], C2[j]
        C1r = torch.einsum("ij,njk,lk->nil", R, C1, R)
        W = _inv3x3(C1r + C2_i)
        T, cost, count = _gn_step(T, p1, p2_i, W, valid, max_dist)
    return T, cost, count


# ---------------------------------------------------------------------------
# K5: one plane-to-plane GICP normal-equation build
# ---------------------------------------------------------------------------


def gicp_gn_result(out: torch.Tensor):
    """(H (6, 6), b (6,), cost (), count ()) as views of K5's 44-float
    result: H row-major (both triangles), b, cost, count."""
    return out[:36].view(6, 6), out[36:42], out[42], out[43]


def gicp_gn_normal_equations(T: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                             C1: torch.Tensor, C2: torch.Tensor,
                             valid: torch.Tensor, max_dist: float):
    """One Gauss-Newton build at pose T by csrc/gicp.cu (`rgbd_gicp_gn`):
    (H (6, 6), b (6,), cost (), count ()) of min sum r^T W r with
    r = R p1 + t - p2, W = (R C1 R^T + C2)^-1, J = [I | -hat(R p1 + t)],
    over valid pairs with |r| < max_dist. No damping, no solve: it is one
    round of `gicp_refine_fused` up to the block reduction. One launch
    writes the whole result into one buffer; the outputs are views of it."""
    _check_gicp_inputs(T, p1, p2, C1, C2, valid)
    out = torch.empty((44,), dtype=torch.float32, device=T.device)
    _launch("rgbd_gicp_gn", T.device, _ptr(T), _ptr(p1), _ptr(p2), _ptr(C1),
            _ptr(C2), _ptr(valid), p1.shape[0],
            float(max_dist) * float(max_dist), _ptr(out))
    LAUNCHES["gicp_gn_normal_equations"] += 1
    return gicp_gn_result(out)


def gicp_gn_normal_equations_ref(T, p1, p2, C1, C2, valid, max_dist: float):
    """Plain version of K5: the build half of `solvers.icp._gn_step`
    (rgbdslam_tpu/solvers/icp.py:140-165), gated on |r|^2 < max_dist^2 like
    the kernels."""
    from rgbdslam_tpu_torch.geometry import se3
    from rgbdslam_tpu_torch.solvers.ransac_se3 import _inv3x3

    R, t = T[:3, :3], T[:3, 3]
    W = _inv3x3(torch.einsum("ij,njk,lk->nil", R, C1, R) + C2)
    q = p1 @ R.T + t
    r = q - p2
    wm = (valid & (torch.sum(r * r, dim=-1) < max_dist * max_dist)).to(T.dtype)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(q.shape[0], 3, 3)
    J = torch.cat([eye, -se3.hat(q)], dim=-1)                 # (N, 3, 6)
    WJ = W @ J
    H = torch.einsum("nij,nik,n->jk", J, WJ, wm)
    b = torch.einsum("nij,ni,n->j", WJ, r, wm)
    cost = torch.sum(torch.einsum("ni,nij,nj->n", r, W, r) * wm)
    return H, b, cost, torch.sum(wm)


# ---------------------------------------------------------------------------
# The SE(3) pose-graph LM iteration (csrc/pose_graph.cu)
# ---------------------------------------------------------------------------


#: vertices `pose_graph_normal_equations` takes at most: a block holds its
#: vertex's six rows of H in shared memory (24 x 6K bytes)
POSE_GRAPH_MAX_VERTICES = 1024


def _check_pose_graph(X, a, b, Z, weight) -> Tuple[int, int]:
    K, E = X.shape[0], a.shape[0]
    _check(X, "X", torch.float32, (K, 4, 4))
    for t, name in ((a, "a"), (b, "b")):
        _check(t, name, torch.int64, (E,))
    _check(Z, "Z", torch.float32, (E, 4, 4))
    _check(weight, "weight", torch.float32, (E,))
    if len({t.device for t in (X, a, b, Z, weight)}) != 1:
        raise ValueError("pose graph: the poses and the edges on different devices")
    if not 1 <= K <= POSE_GRAPH_MAX_VERTICES:
        raise ValueError(f"pose graph: {K} vertices, the kernels take 1 to "
                         f"{POSE_GRAPH_MAX_VERTICES}")
    return K, E


def _huber(delta: float) -> Tuple[float, float, float]:
    """delta, 2 delta and delta^2, each rounded to f32 from the double as
    `_huber_cost`'s Python scalars are."""
    d = float(delta)
    return d, 2.0 * d, d * d


def pose_graph_normal_equations(X: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                                Z: torch.Tensor, weight: torch.Tensor, huber_delta: float,
                                lam: torch.Tensor, fixed: torch.Tensor):
    """The SE(3) edges' damped Gauss-Newton system at the poses X (K, 4, 4)
    in one launch of csrc/pose_graph.cu: H (6K, 6K), g (6K,) and the robust
    cost (), as `solvers.pose_graph._normal_equations` over `edge_blocks`
    gives them, with the closed-form Jacobians Jb = J_r^-1(r) Ad(Tb^-1),
    Ja = -Jb, and H damped as `_damped_step` damps it: the 1e9 prior on the
    `fixed` ((K,) bool) vertices, Marquardt's `lam` (() f32) on the
    diagonal. Edges: a, b (E,) int64, Z (E, 4, 4) = T_{a<-b}, weight (E,)
    (0: the slot adds nothing). A block a vertex sums its rows of H and g in
    edge order, without atomics: the same bits every call. H, g and the
    cost are views of one buffer, written whole by the one launch."""
    K, E = _check_pose_graph(X, a, b, Z, weight)
    _check(lam, "lam", torch.float32, ())
    _check(fixed, "fixed", torch.bool, (K,))
    n = 6 * K
    ws = torch.empty((n * n + n + 1,), dtype=torch.float32, device=X.device)
    H, g, cost = ws[:n * n].view(n, n), ws[n * n:n * n + n], ws[n * n + n]
    _launch("rgbd_pose_graph_normal_equations", X.device, _ptr(X), _ptr(a), _ptr(b), _ptr(Z),
            _ptr(weight), E, K, *_huber(huber_delta), _ptr(H), _ptr(g), _ptr(cost),
            _ptr(lam), _ptr(fixed))
    LAUNCHES["pose_graph_normal_equations"] += 1
    return H, g, cost


def pose_graph_trial(X: torch.Tensor, sol: torch.Tensor, fixed: torch.Tensor,
                     a: torch.Tensor, b: torch.Tensor, Z: torch.Tensor, weight: torch.Tensor,
                     huber_delta: float, cost_it: torch.Tensor, lam: torch.Tensor,
                     adaptive: bool = True):
    """The rest of an LM iteration in one launch of csrc/pose_graph.cu: the
    candidate poses exp(xi) X with xi = -sol (sol (6K,) the damped solve's
    solution; xi = 0 on the fixed vertices), their robust cost over the
    edges, and `_lm_update`'s masked accept against the iteration's cost
    `cost_it` (()): x1/3 on lam (()) on an accepted step, x2 on a rejected
    one, clamped to [1e-9, 1e8]. Without `adaptive` the candidate is taken
    with cost_it. Returns (X_next (K, 4, 4), lam_next (), cost_next ())."""
    K, E = _check_pose_graph(X, a, b, Z, weight)
    _check(sol, "sol", torch.float32, (6 * K,))
    _check(fixed, "fixed", torch.bool, (K,))
    _check(cost_it, "cost_it", torch.float32, ())
    _check(lam, "lam", torch.float32, ())
    X_out, Xc = torch.empty_like(X), torch.empty_like(X)
    state = torch.empty((2,), dtype=torch.float32, device=X.device)
    _launch("rgbd_pose_graph_trial", X.device, _ptr(X), _ptr(sol), _ptr(fixed), _ptr(a),
            _ptr(b), _ptr(Z), _ptr(weight), E, K, *_huber(huber_delta), _ptr(cost_it),
            _ptr(lam), int(bool(adaptive)), _ptr(Xc), _ptr(X_out), _ptr(state))
    LAUNCHES["pose_graph_trial"] += 1
    return X_out, state[0], state[1]
