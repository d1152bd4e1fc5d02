"""Hand-written CUDA kernels of the tracking step, their launch wrappers and
their plain PyTorch versions (counterpart of rgbdslam_tpu/ops/pallas_kernels.py).

| Kernel (csrc/)           | Replaces (pallas_kernels.py)          | Plain version              |
|--------------------------|---------------------------------------|----------------------------|
| detect.cu   (K1)         | detect_score_map, 319-397             | detect_score_map_ref       |
| hamming.cu  (K2)         | hamming_match_2nn, 86-150             | hamming_match_2nn_ref      |
| mahal.cu    (K3)         | mahal_hypothesis_scores, 479-526      | mahal_hypothesis_scores_ref|
| gicp.cu     (K4)         | gicp_refine_kernel, 790-825           | gicp_refine_ref            |

A wrapper (`detect_score_map`, ...) takes CUDA tensors only: it checks
device, dtype, shape and contiguity, allocates its outputs, launches on the
current stream without synchronising, raises if the launch failed, and adds
one to its entry in `LAUNCHES`. The public functions of the pipeline
(`fast.masked_score_map`, `matcher.match_descriptors`, the scorer in
`ransac_se3`, `icp.gicp_refine`) pick the wrapper for CUDA tensors and the
plain version for CPU tensors (`on_cuda`); nothing falls back from one to
the other.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from rgbdslam_tpu_torch.ops import fast, hamming

BIG = hamming.BIG_DIST

# launches per wrapper since the last reset_launch_counts()
LAUNCHES = {
    "detect_score_map": 0,
    "hamming_match_2nn": 0,
    "mahal_hypothesis_scores": 0,
    "gicp_refine_kernel": 0,
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


# ---------------------------------------------------------------------------
# K1: fused FAST + Shi-Tomasi + 3x3 NMS
# ---------------------------------------------------------------------------


def detect_score_map(img: torch.Tensor, fast_threshold: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(masked, raw) score maps of one pyramid level, by csrc/detect.cu.

    img: (H, W) f32 CUDA. masked is the Shi-Tomasi score (9x9 box) where the
    pixel is a FAST-10 corner winning its 3x3 neighbourhood, -inf
    elsewhere; raw is the dense Shi-Tomasi map."""
    _check(img, "img", torch.float32, (None, None))
    h, w = img.shape
    out = torch.empty_like(img)
    raw = torch.empty_like(img)
    _launch("rgbd_detect_score_map", img.device, _ptr(img), h, w,
            float(fast_threshold), _ptr(out), _ptr(raw))
    LAUNCHES["detect_score_map"] += 1
    return out, raw


def detect_score_map_ref(img: torch.Tensor, fast_threshold: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: the fast_corner_mask / shi_tomasi_map / nms3x3
    composition (rgbdslam_tpu/ops/fast.py:130-140)."""
    corners = fast.fast_corner_mask(img, fast_threshold)
    score = fast.shi_tomasi_map(img)
    corner_score = torch.where(corners, score, float("-inf"))
    keep = corners & fast.nms3x3(corner_score)
    return torch.where(keep, score, float("-inf")), score


# ---------------------------------------------------------------------------
# K2: 256-bit Hamming 2-NN with column best
# ---------------------------------------------------------------------------


def hamming_match_2nn(desc1: torch.Tensor, desc2: torch.Tensor,
                      valid1: torch.Tensor, valid2: torch.Tensor):
    """(best_idx [N], best_dist [N], second_dist [N], col_best_row [M]) by
    csrc/hamming.cu. desc: (N, 8) / (M, 8) int32 words of 32 bits; valid:
    bool. Pairs with an invalid end have distance BIG; ties go to the lowest
    index; a row with no valid pair gets index 0 and distances BIG."""
    n, m = desc1.shape[0], desc2.shape[0]
    _check(desc1, "desc1", torch.int32, (n, 8))
    _check(desc2, "desc2", torch.int32, (m, 8))
    _check(valid1, "valid1", torch.bool, (n,))
    _check(valid2, "valid2", torch.bool, (m,))
    if n < 1 or m < 1:
        raise ValueError("hamming_match_2nn needs at least one query and one train row")
    dev = desc1.device
    best_idx = torch.empty((n,), dtype=torch.int32, device=dev)
    best_dist = torch.empty((n,), dtype=torch.int32, device=dev)
    second = torch.empty((n,), dtype=torch.int32, device=dev)
    col_best = torch.empty((m,), dtype=torch.int32, device=dev)
    # (dist << 32 | row) keys; BIG << 32 gives row 0 to columns with no
    # valid pair, like argmin over a column of BIGs
    col_key = torch.full((m,), BIG << 32, dtype=torch.int64, device=dev)
    _launch("rgbd_hamming_match_2nn", dev, _ptr(desc1), _ptr(desc2),
            _ptr(valid1), _ptr(valid2), n, m, _ptr(best_idx), _ptr(best_dist),
            _ptr(second), _ptr(col_key), _ptr(col_best))
    LAUNCHES["hamming_match_2nn"] += 1
    return best_idx, best_dist, second, col_best


def hamming_match_2nn_ref(desc1, desc2, valid1, valid2):
    """Plain version of K2: the popcount distance matrix + knn2 + column
    argmin (rgbdslam_tpu/ops/hamming.py:68-75, 77-90)."""
    d = hamming.hamming_distance_matrix(desc1, desc2, valid1, valid2)
    best_idx, best_dist, second = hamming.knn2(d)
    col_best = torch.argmin(d, dim=0).to(torch.int32)
    return best_idx, best_dist, second, col_best


# ---------------------------------------------------------------------------
# K3: Mahalanobis hypothesis scorer
# ---------------------------------------------------------------------------


def mahal_hypothesis_scores(T_h: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                            s1: torch.Tensor, s2: torch.Tensor,
                            valid: torch.Tensor, th: float):
    """Inlier count (H,) int32 and sum of m^2 over inliers (H,) f32 per
    hypothesis, by csrc/mahal.cu. T_h (H, 4, 4); p1, p2, s1, s2 (N, 3) f32
    (s = diagonal sensor covariances); valid (N,) bool; th = max m^2."""
    H, N = T_h.shape[0], p1.shape[0]
    _check(T_h, "T_h", torch.float32, (H, 4, 4))
    for t, name in ((p1, "p1"), (p2, "p2"), (s1, "s1"), (s2, "s2")):
        _check(t, name, torch.float32, (N, 3))
    _check(valid, "valid", torch.bool, (N,))
    dev = T_h.device
    cnt = torch.empty((H,), dtype=torch.int32, device=dev)
    err = torch.empty((H,), dtype=torch.float32, device=dev)
    if H == 0:
        return cnt, err
    _launch("rgbd_mahal_hypothesis_scores", dev, _ptr(T_h), _ptr(p1), _ptr(p2),
            _ptr(s1), _ptr(s2), _ptr(valid), H, N, float(th), _ptr(cnt), _ptr(err))
    LAUNCHES["mahal_hypothesis_scores"] += 1
    return cnt, err


def mahal_hypothesis_scores_ref(T_h, p1, p2, s1, s2, valid, th: float):
    """Plain version of K3: the plane-form m^2 of
    rgbdslam_tpu/solvers/ransac_se3.py:84-129 + the count/sum of 183-189."""
    from rgbdslam_tpu_torch.solvers.ransac_se3 import mahalanobis_sq_planes

    m2 = mahalanobis_sq_planes(T_h, p1, p2, s1, s2)      # (H, N)
    inl = (m2 <= th) & valid
    cnt = torch.sum(inl, dim=-1).to(torch.int32)
    err = torch.sum(torch.where(inl, m2, 0.0), dim=-1)
    return cnt, err


# ---------------------------------------------------------------------------
# K4: the whole plane-to-plane GICP Gauss-Newton loop
# ---------------------------------------------------------------------------


def gicp_refine_kernel(T_init: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                       C1: torch.Tensor, C2: torch.Tensor, valid: torch.Tensor,
                       iters: int, max_dist: float):
    """`iters` rounds of (normal equations -> damped 6x6 solve -> left
    SE(3) exp-compose) in one launch of csrc/gicp.cu. The solve pivots like
    the plain version's LU; the Pallas kernel's Cholesky gave NaN on the
    indefinite H that real frames produce (see the note in gicp.cu).

    Returns (T (4, 4), cost (), count ()) where cost/count are the gated
    plane-to-plane cost and correspondence count of the last round's build.
    """
    N = p1.shape[0]
    _check(T_init, "T_init", torch.float32, (4, 4))
    for t, name in ((p1, "p1"), (p2, "p2")):
        _check(t, name, torch.float32, (N, 3))
    for t, name in ((C1, "C1"), (C2, "C2")):
        _check(t, name, torch.float32, (N, 3, 3))
    _check(valid, "valid", torch.bool, (N,))
    out = torch.empty((18,), dtype=torch.float32, device=T_init.device)
    _launch("rgbd_gicp_refine", T_init.device, _ptr(T_init), _ptr(p1), _ptr(p2),
            _ptr(C1), _ptr(C2), _ptr(valid), N, int(iters),
            float(max_dist) * float(max_dist), _ptr(out))
    LAUNCHES["gicp_refine_kernel"] += 1
    return out[:16].view(4, 4), out[16], out[17]


def gicp_refine_ref(T_init, p1, p2, C1, C2, valid, iters: int, max_dist: float):
    """Plain version of K4: the Gauss-Newton loop of
    rgbdslam_tpu/solvers/icp.py:198-221 (reassociate=False). Returns
    (T, cost, count) of the last round, like the kernel."""
    from rgbdslam_tpu_torch.solvers.icp import _gn_step
    from rgbdslam_tpu_torch.solvers.ransac_se3 import _inv3x3

    T = T_init
    cost = torch.full((), float("inf"), dtype=T.dtype, device=T.device)
    count = torch.zeros((), dtype=T.dtype, device=T.device)
    for _ in range(iters):
        R = T[:3, :3]
        C1r = torch.einsum("ij,njk,lk->nil", R, C1, R)
        W = _inv3x3(C1r + C2)
        T, cost, count = _gn_step(T, p1, p2, W, valid, max_dist)
    return T, cost, count
