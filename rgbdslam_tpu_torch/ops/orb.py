"""BRIEF-256 descriptors, upright (the live path, Features/Extractor.cpp:59)
and steered with the intensity-centroid angle (ORB,
Features/ORBextractor.cpp:16-87); port of rgbdslam_tpu/ops/orb.py.

The sampling pattern is the JAX package's numpy draw (default_rng(7)): the
shipped loop-closure vocabularies were trained on those bits. Where the JAX
package reads the pattern samples through one-hot or bilinear selector
matmuls (to keep off the TPU's gather unit), the port gathers each sample's
taps and adds them in a fixed order. Integer offsets give the same pixels,
so the same bits; a bilinear sample (steered ORB) sums its four taps in
another order than XLA's matmul, so a bit flips where a and b lie within
rounding of each other. Moments are pairwise-tree sums (`image.tree_sum`):
the card computes the CPU's bits.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from rgbdslam_tpu_torch.ops import image as image_ops

DESC_BITS = 256
DESC_WORDS = DESC_BITS // 32


@functools.lru_cache()
def brief_pattern(patch_size: int = 31, seed: int = 7) -> np.ndarray:
    """Deterministic BRIEF-GII pattern: (256, 2, 2) float32 offsets (a, b)."""
    rng = np.random.default_rng(seed)
    half = patch_size // 2
    sigma = patch_size / 5.0
    pts = rng.normal(scale=sigma, size=(DESC_BITS, 2, 2))
    return np.clip(pts, -half, half).astype(np.float32)


@functools.lru_cache()
def _int_pattern(patch_size: int = 31, seed: int = 7) -> np.ndarray:
    """The pattern rounded to integer pixel offsets (half to even)."""
    return np.round(brief_pattern(patch_size, seed)).astype(np.int64)


@functools.lru_cache()
def _int_pattern_on(device: torch.device, patch_size: int = 31) -> torch.Tensor:
    """_int_pattern on `device`, copied there once: a copy from host memory
    makes the host wait for the device, which the per-frame path must not."""
    return torch.as_tensor(_int_pattern(patch_size), device=device)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) bool -> (N, 8) int32 words, bit i of word w = bits[:, 32*w + i].

    Packed in int64 and mapped onto the int32 range explicitly (no cast
    that relies on overflow)."""
    n = bits.shape[0]
    b = bits.reshape(n, DESC_WORDS, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = torch.sum(b << shifts, dim=-1)                  # [0, 2^32)
    words = torch.where(words >= (1 << 31), words - (1 << 32), words)
    return words.to(torch.int32)


def brief_descriptors_dense(img_blurred: torch.Tensor, uv: torch.Tensor,
                            patch_size: int = 31) -> torch.Tensor:
    """Upright BRIEF-256 at integer keypoint coords on a pre-blurred image.

    For each keypoint (rounded, clamped into the image) and pattern pair,
    read the two pixels at the integer offsets, clamped to the image (the
    JAX path's edge padding), and set the bit where a < b. Returns (N, 8)
    int32 words."""
    h, w = img_blurred.shape
    pat = _int_pattern_on(img_blurred.device, patch_size)
    u = torch.clamp(torch.round(uv[:, 0]).long(), 0, w - 1)
    v = torch.clamp(torch.round(uv[:, 1]).long(), 0, h - 1)

    def sample(offs):                                        # offs (256, 2)
        x = torch.clamp(u[:, None] + offs[None, :, 0], 0, w - 1)
        y = torch.clamp(v[:, None] + offs[None, :, 1], 0, h - 1)
        return img_blurred[y, x]                             # (N, 256)

    return _pack_bits(sample(pat[:, 0]) < sample(pat[:, 1]))


def extract_patches(img: torch.Tensor, uv: torch.Tensor, patch_size: int = 31) -> torch.Tensor:
    """(N, patch^2) flattened patches around the rounded keypoint coords
    (offsets -patch//2 .. patch - 1 - patch//2), read with edge padding
    (clamped reads), row-major."""
    half = patch_size // 2
    h, w = img.shape
    u = torch.clamp(torch.round(uv[:, 0]).long(), 0, w - 1)
    v = torch.clamp(torch.round(uv[:, 1]).long(), 0, h - 1)
    offs = torch.arange(patch_size, device=img.device) - half
    ys = torch.clamp(v[:, None] + offs[None, :], 0, h - 1)          # (N, P)
    xs = torch.clamp(u[:, None] + offs[None, :], 0, w - 1)
    return img[ys[:, :, None], xs[:, None, :]].reshape(uv.shape[0], -1)


def selector_taps(sel: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The nonzero entries of a (P^2, C) selector matrix as per-column taps:
    (idx (C, T) int64, w (C, T) f32), ascending pixel index, padded with
    weight 0 at pixel 0."""
    counts = (sel != 0).sum(axis=0)
    n_taps = max(int(counts.max()), 1)
    idx = np.zeros((sel.shape[1], n_taps), np.int64)
    w = np.zeros((sel.shape[1], n_taps), np.float32)
    for c in range(sel.shape[1]):
        nz = np.nonzero(sel[:, c])[0]
        idx[c, :len(nz)] = nz
        w[c, :len(nz)] = sel[nz, c]
    return idx, w


def sample_taps(flat: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted tap sums of flattened patches: flat (N, P^2), idx / w
    (N, C, T) or (C, T) -> (N, C), taps added in order t = 0, 1, ..."""
    n = flat.shape[0]
    if idx.dim() == 2:
        idx = idx.expand(n, *idx.shape)
        w = w.expand(n, *w.shape)
    c, t = idx.shape[1], idx.shape[2]
    vals = torch.gather(flat, 1, idx.reshape(n, c * t)).reshape(n, c, t)
    out = vals[..., 0] * w[..., 0]
    for k in range(1, t):
        out = out + vals[..., k] * w[..., k]
    return out


def ic_angles(img: torch.Tensor, uv: torch.Tensor, radius: int = 15) -> torch.Tensor:
    """Intensity-centroid orientation per keypoint (ORB IC_Angle,
    Features/ORBextractor.cpp:16-41): the angle of the (m10, m01) moments of
    bilinear samples over a circular patch. uv: (N, 2) -> (N,) radians."""
    ys, xs = np.meshgrid(np.arange(-radius, radius + 1), np.arange(-radius, radius + 1),
                         indexing="ij")
    circle = (xs * xs + ys * ys) <= radius * radius
    offs = torch.as_tensor(np.stack([xs[circle], ys[circle]], axis=-1).astype(np.float32),
                           device=img.device)                  # (M, 2)
    vals = image_ops.bilinear_sample(img, uv[:, None, :] + offs[None])
    m10 = image_ops.tree_sum(vals * offs[:, 0])
    m01 = image_ops.tree_sum(vals * offs[:, 1])
    return torch.atan2(m01, m10)


@functools.lru_cache()
def _moment_weights(patch_size: int = 31, radius: int = 15):
    """Per-patch-pixel x / y weights over the IC circle: m10 = patch . wx,
    m01 = patch . wy."""
    half = patch_size // 2
    ys, xs = np.meshgrid(np.arange(-half, half + 1), np.arange(-half, half + 1),
                         indexing="ij")
    circle = (xs * xs + ys * ys) <= radius * radius
    wx = (xs * circle).astype(np.float32).reshape(-1)
    wy = (ys * circle).astype(np.float32).reshape(-1)
    return wx, wy


def bilinear_selectors(points: np.ndarray, patch_size: int) -> np.ndarray:
    """(P^2, C) selector whose column c distributes the float offset
    points[c] = (x, y) bilinearly over its four patch pixels (clamped into
    the patch), as the JAX package's selector matrices do."""
    half = patch_size // 2
    sel = np.zeros((patch_size * patch_size, points.shape[0]), dtype=np.float32)
    for c, (x, y) in enumerate(points):
        x = min(max(float(x), -half), half - 1e-3)
        y = min(max(float(y), -half), half - 1e-3)
        x0, y0 = int(np.floor(x)), int(np.floor(y))
        dx, dy = x - x0, y - y0
        for (xx, yy, wt) in ((x0, y0, (1 - dx) * (1 - dy)), (x0 + 1, y0, dx * (1 - dy)),
                             (x0, y0 + 1, (1 - dx) * dy), (x0 + 1, y0 + 1, dx * dy)):
            xx = min(max(xx, -half), half)
            yy = min(max(yy, -half), half)
            sel[(yy + half) * patch_size + (xx + half), c] += wt
    return sel


@functools.lru_cache()
def _rotated_taps_np(patch_size: int = 31, n_bins: int = 16, seed: int = 7):
    """Taps of the BRIEF pattern rotated to each of n_bins angles
    (JAX orb.py:_rotated_selectors): (idx (2, n_bins, 256, T), w (2, n_bins,
    256, T)) for the a and b samples."""
    pat = brief_pattern(patch_size, seed)
    idx_ab, w_ab = [], []
    for ab in range(2):
        idx_b, w_b = [], []
        for b in range(n_bins):
            ang = 2.0 * np.pi * b / n_bins
            c, s = np.cos(ang), np.sin(ang)
            x, y = pat[:, ab, 0], pat[:, ab, 1]
            pts = np.stack([c * x - s * y, s * x + c * y], axis=-1)
            idx, w = selector_taps(bilinear_selectors(pts, patch_size))
            idx_b.append(idx)
            w_b.append(w)
        t = max(i.shape[1] for i in idx_b)
        idx_ab.append(np.stack([np.pad(i, ((0, 0), (0, t - i.shape[1]))) for i in idx_b]))
        w_ab.append(np.stack([np.pad(i, ((0, 0), (0, t - i.shape[1]))) for i in w_b]))
    t = max(i.shape[-1] for i in idx_ab)
    idx = np.stack([np.pad(i, ((0, 0), (0, 0), (0, t - i.shape[-1]))) for i in idx_ab])
    w = np.stack([np.pad(i, ((0, 0), (0, 0), (0, t - i.shape[-1]))) for i in w_ab])
    return idx, w


@functools.lru_cache()
def _orb_tables_on(device: torch.device, patch_size: int = 31, n_bins: int = 16):
    """The moment weights and rotated taps on `device`, copied there once."""
    wx, wy = _moment_weights(patch_size)
    idx, w = _rotated_taps_np(patch_size, n_bins)
    return tuple(torch.as_tensor(a, device=device) for a in (wx, wy, idx, w))


def orb_descriptors_dense(img_blurred: torch.Tensor, img_raw: torch.Tensor, uv: torch.Tensor,
                          patch_size: int = 31, n_bins: int = 16
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Steered BRIEF (the 'orb' descriptor, JAX orb.py:200-244): the IC
    angle from the raw patch's moments, quantised to one of n_bins rotations
    (round half to even, mod n_bins), and the pattern rotated to that bin
    sampled bilinearly on the blurred patch. Returns (desc (N, 8) int32,
    angles (N,) radians)."""
    wx, wy, idx, w = _orb_tables_on(img_blurred.device, patch_size, n_bins)
    p_raw = extract_patches(img_raw, uv, patch_size)
    m10 = image_ops.tree_sum(p_raw * wx)
    m01 = image_ops.tree_sum(p_raw * wy)
    angles = torch.atan2(m01, m10)
    # XLA turns the division by the static 2 pi into a product with its f32
    # reciprocal
    inv_2pi = float(np.float32(1.0) / np.float32(2.0 * np.pi))
    bins = torch.remainder(torch.round(angles * inv_2pi * float(n_bins)).to(torch.int32),
                           n_bins).long()
    p_blur = extract_patches(img_blurred, uv, patch_size)
    sa = sample_taps(p_blur, idx[0][bins], w[0][bins])
    sb = sample_taps(p_blur, idx[1][bins], w[1][bins])
    return _pack_bits(sa < sb), angles


def brief_descriptors(img_blurred: torch.Tensor, uv: torch.Tensor,
                      angles: torch.Tensor | None = None,
                      patch_size: int = 31) -> torch.Tensor:
    """BRIEF-256 by per-sample bilinear reads at the float pattern offsets,
    steered by `angles` (N,) if given (JAX orb.py:247-288). (N, 8) int32."""
    pat = torch.as_tensor(brief_pattern(patch_size), device=img_blurred.device)
    a, b = pat[:, 0, :], pat[:, 1, :]
    if angles is not None:
        c, s = torch.cos(angles)[:, None], torch.sin(angles)[:, None]

        def rotate(offs):
            x, y = offs[None, :, 0], offs[None, :, 1]
            return torch.stack([c * x - s * y, s * x + c * y], dim=-1)

        pa, pb = uv[:, None, :] + rotate(a), uv[:, None, :] + rotate(b)
    else:
        pa, pb = uv[:, None, :] + a[None], uv[:, None, :] + b[None]
    ia = image_ops.bilinear_sample(img_blurred, pa)
    ib = image_ops.bilinear_sample(img_blurred, pb)
    return _pack_bits(ia < ib)
