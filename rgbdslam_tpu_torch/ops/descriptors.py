"""Descriptor families of the extractor factory: BRISK, FREAK and LATCH-style
binary patterns and a SIFT-class 128-D float descriptor (port of
rgbdslam_tpu/ops/descriptors.py; Features/Extractor.h:13-26).

The sampling patterns are the JAX package's numpy constructions. Each
sample is read from the keypoint's flattened patch (`orb.extract_patches`):
integer offsets (LATCH) as a direct gather, bilinear ones (BRISK, FREAK) as
their taps added in a fixed order (`orb.sample_taps`), where the JAX package
multiplies by selector matrices. SIFT's cell histograms and norms are
pairwise-tree sums (`image.tree_sum`) and its square roots correctly
rounded (`image.sqrt_rn`), so the card computes the CPU's bits but where
atan2 rounds apart.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rgbdslam_tpu_torch.ops import image as image_ops
from rgbdslam_tpu_torch.ops.orb import (DESC_BITS, _pack_bits, bilinear_selectors,
                                        extract_patches, sample_taps, selector_taps)


@functools.lru_cache()
def brisk_pattern(patch_size: int = 31) -> np.ndarray:
    """(256, 2, 2) short-distance pairs over concentric rings (4 rings x
    [10, 14, 15, 20] points and the centre, after Leutenegger et al.): the
    256 closest pairs."""
    half = patch_size // 2
    pts = [(0.0, 0.0)]
    for radius_f, n in ((0.25, 10), (0.45, 14), (0.65, 15), (0.85, 20)):
        r = radius_f * half
        for i in range(n):
            a = 2.0 * np.pi * i / n + (0.5 if n % 2 else 0.0)
            pts.append((r * np.cos(a), r * np.sin(a)))
    pts = np.asarray(pts, dtype=np.float32)
    iu, ju = np.triu_indices(len(pts), k=1)
    d = np.linalg.norm(pts[iu] - pts[ju], axis=-1)
    order = np.argsort(d, kind="stable")[:DESC_BITS]
    return np.stack([pts[iu[order]], pts[ju[order]]], axis=1)


@functools.lru_cache()
def freak_pattern(patch_size: int = 31, seed: int = 11) -> np.ndarray:
    """(256, 2, 2) retinal pattern: 7 rings of 6 points and the fovea, radius
    shrinking by 0.7 a ring; coarse-to-fine pairs drawn from a seeded
    shuffle of the longest 512."""
    half = patch_size // 2
    rng = np.random.default_rng(seed)
    rings = []
    n_rings = 8
    for k in range(n_rings):
        r = half * (0.9 * (0.7 ** k))
        n = 6 if k < n_rings - 1 else 1
        ring = []
        for i in range(n):
            a = 2.0 * np.pi * i / n + k * 0.4
            ring.append((r * np.cos(a), r * np.sin(a)))
        rings.append(np.asarray(ring, dtype=np.float32))
    pts = np.concatenate(rings)
    iu, ju = np.triu_indices(len(pts), k=1)
    d = np.linalg.norm(pts[iu] - pts[ju], axis=-1)
    order = np.argsort(-d, kind="stable")
    keep = rng.permutation(order[: 2 * DESC_BITS])[:DESC_BITS]
    keep.sort()
    return np.stack([pts[iu[keep]], pts[ju[keep]]], axis=1)


@functools.lru_cache()
def _pattern_taps(name: str, device: torch.device, patch_size: int = 31):
    """Taps of a named float pattern's a and b samples on `device`:
    (idx_a, w_a, idx_b, w_b), each (256, T)."""
    pat = {"brisk": brisk_pattern, "freak": freak_pattern}[name](patch_size)
    out = []
    for ab in range(2):
        idx, w = selector_taps(bilinear_selectors(pat[:, ab], patch_size))
        out += [torch.as_tensor(idx, device=device), torch.as_tensor(w, device=device)]
    return tuple(out)


def pattern_descriptors_dense(img_blurred: torch.Tensor, uv: torch.Tensor, pattern: str,
                              patch_size: int = 31) -> torch.Tensor:
    """Upright binary descriptor of a named pattern ('brisk' | 'freak'):
    bilinear samples of the blurred patch, bit = a < b. (N, 8) int32."""
    flat = extract_patches(img_blurred, uv, patch_size)
    idx_a, w_a, idx_b, w_b = _pattern_taps(pattern, img_blurred.device, patch_size)
    return _pack_bits(sample_taps(flat, idx_a, w_a) < sample_taps(flat, idx_b, w_b))


@functools.lru_cache()
def _latch_triplets(patch_size: int = 31, seed: int = 17) -> np.ndarray:
    """(256, 3, 2) anchor / a / b block centres of the triplet test, drawn
    like BRIEF pairs plus an anchor."""
    rng = np.random.default_rng(seed)
    half = patch_size // 2 - 1
    sigma = patch_size / 5.0
    pts = rng.normal(scale=sigma, size=(DESC_BITS, 3, 2))
    return np.clip(pts, -half, half).astype(np.float32)


@functools.lru_cache()
def _latch_index(device: torch.device, patch_size: int = 31) -> torch.Tensor:
    """(3, 256) patch-pixel indices of the rounded triplet points on `device`
    (the JAX package's one-hot selectors)."""
    tri = np.round(_latch_triplets(patch_size)).astype(np.int64)
    half = patch_size // 2
    idx = (tri[:, :, 1] + half) * patch_size + (tri[:, :, 0] + half)     # (256, 3)
    return torch.as_tensor(np.ascontiguousarray(idx.T), device=device)


def latch_descriptors_dense(img_box3: torch.Tensor, uv: torch.Tensor,
                            patch_size: int = 31) -> torch.Tensor:
    """LATCH-style triplet descriptor on 3x3 block means (img_box3: the 3x3
    box-mean image): bit k = (mean(a_k) - mean(anchor_k))^2 <
    (mean(b_k) - mean(anchor_k))^2. (N, 8) int32."""
    flat = extract_patches(img_box3, uv, patch_size)
    idx = _latch_index(img_box3.device, patch_size)
    sa, sb, sc = flat[:, idx[0]], flat[:, idx[1]], flat[:, idx[2]]
    da, db = sa - sc, sb - sc
    return _pack_bits(da * da < db * db)


SIFT_CELLS = 4        # 4x4 spatial cells
SIFT_BINS = 8         # orientation bins
SIFT_DIM = SIFT_CELLS * SIFT_CELLS * SIFT_BINS   # 128


@functools.lru_cache()
def _sift_window(patch_size: int = 16) -> np.ndarray:
    """(P, P) Gaussian spatial window of the descriptor (JAX
    _sift_cell_weights' nonzero entries)."""
    half = patch_size / 2.0
    g = np.zeros((patch_size, patch_size), np.float32)
    for yy in range(patch_size):
        for xx in range(patch_size):
            g[yy, xx] = np.exp(-((xx - half + 0.5) ** 2 + (yy - half + 0.5) ** 2)
                               / (2.0 * (0.5 * patch_size) ** 2))
    return g


@functools.lru_cache()
def _sift_window_on(device: torch.device, patch_size: int = 16) -> torch.Tensor:
    return torch.as_tensor(_sift_window(patch_size), device=device)


def sift_descriptors_dense(img_blurred: torch.Tensor, uv: torch.Tensor,
                           patch_size: int = 16) -> torch.Tensor:
    """(N, 128) f32 SIFT-class descriptor: central-difference gradients of
    the patch, hard orientation bins (8), magnitudes weighted by a Gaussian
    window and summed over a 4x4 cell grid, L2-normalised, clipped at 0.2,
    renormalised (Lowe). Upright, like the live path's BRIEF."""
    p = patch_size
    n = uv.shape[0]
    patches = extract_patches(img_blurred, uv, p + 2).reshape(n, p + 2, p + 2)
    dx = patches[:, 1:-1, 2:] - patches[:, 1:-1, :-2]
    dy = patches[:, 2:, 1:-1] - patches[:, :-2, 1:-1]
    mag = image_ops.sqrt_rn(dx * dx + dy * dy)
    ang = torch.atan2(dy, dx)
    # XLA's product with the f32 reciprocal of the static 2 pi
    inv_2pi = float(np.float32(1.0) / np.float32(2.0 * np.pi))
    binf = (ang + float(np.float32(np.pi))) * inv_2pi * float(SIFT_BINS)
    bins = torch.clamp(binf.to(torch.int32), 0, SIFT_BINS - 1)
    cell = p // SIFT_CELLS
    contrib = mag * _sift_window_on(img_blurred.device, p)

    def by_cell(a):                       # (N, p, p) -> (N, 16 cells, cell^2)
        a = a.reshape(n, SIFT_CELLS, cell, SIFT_CELLS, cell).permute(0, 1, 3, 2, 4)
        return a.reshape(n, SIFT_CELLS * SIFT_CELLS, cell * cell)

    contrib_c, bins_c = by_cell(contrib), by_cell(bins)
    hists = [image_ops.tree_sum(torch.where(bins_c == b, contrib_c, 0.0))
             for b in range(SIFT_BINS)]
    desc = torch.stack(hists, dim=-1).reshape(n, SIFT_DIM)
    norm = image_ops.sqrt_rn(image_ops.tree_sum(desc * desc))[:, None]
    desc = torch.clamp_max(desc / torch.clamp_min(norm, 1e-6), 0.2)
    norm = image_ops.sqrt_rn(image_ops.tree_sum(desc * desc))[:, None]
    return desc / torch.clamp_min(norm, 1e-6)
