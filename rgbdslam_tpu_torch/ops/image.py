"""Image ops: half-sample and x1.2 pyramids, blur, gradients, box sums,
nearest and bilinear reads (port of rgbdslam_tpu/ops/image.py).

Sums run as shift-and-accumulate passes (or tap sums) in a fixed order, so a
result does not depend on how a library kernel orders its reduction: the
card computes the CPU's bits.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def half_sample(img: torch.Tensor) -> torch.Tensor:
    """2x2 average downsample (SVO halfSample, Features/SVOextractor.cpp:16-37)."""
    h, w = img.shape
    h2, w2 = h // 2, w // 2
    x = img[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2)
    # the same summation order as XLA's reduce over axes (1, 3)
    s = x[:, 0, :, 0] + x[:, 0, :, 1] + x[:, 1, :, 0] + x[:, 1, :, 1]
    return s / 4.0


def build_pyramid(img: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """Half-sampling pyramid (Features/SVOextractor.cpp:135-144)."""
    pyr = [img]
    for _ in range(1, levels):
        pyr.append(half_sample(pyr[-1]))
    return pyr


def scaled_pyramid_shapes(h: int, w: int, levels: int,
                          scale_factor: float) -> List[tuple]:
    """Per-level (h, w) of a x`scale_factor` pyramid (ORB-SLAM2's
    ComputePyramid rounding: size_l = round(size_0 / f^l),
    Features/ORBextractor.cpp:773-797), at least 16 pixels a side."""
    return [(max(int(round(h / scale_factor**lvl)), 16),
             max(int(round(w / scale_factor**lvl)), 16))
            for lvl in range(levels)]


@functools.lru_cache(maxsize=None)
def _resize_taps_np(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """The nonzero taps of jax.image.resize's "linear" weights along one
    axis, built in f32 as jax._src.image.scale.compute_weight_mat builds them
    (triangle kernel widened by the inverse scale when downsampling: the
    antialiasing torch's interpolate leaves out; weights normalised per
    output; the division by the kernel scale XLA's product with the f32
    reciprocal). A few weights still differ from XLA's in the last bit.
    Returns (idx (T, n_out) int64, w (T, n_out) f32), each
    output's taps in ascending input order, padded with weight 0."""
    f32 = np.float32
    scale = n_out / n_in
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    # (o + 0.5) * inv_scale - 0.5, contracted to one fused multiply-add as
    # XLA's CPU code does (the f64 product of two f32 values is exact)
    sample_f = ((np.arange(n_out, dtype=f32) + f32(0.5)).astype(np.float64)
                * np.float64(f32(inv_scale)) - 0.5).astype(f32)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) * (
        f32(1.0) / f32(kernel_scale))
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, f32(1.0)), f32(0.0)).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    weights = np.where(inside[None, :], weights, f32(0.0)).astype(f32)
    n_taps = int((weights != 0).sum(axis=0).max())
    idx = np.zeros((n_taps, n_out), np.int64)
    w = np.zeros((n_taps, n_out), f32)
    for o in range(n_out):
        nz = np.nonzero(weights[:, o])[0]
        idx[:len(nz), o] = nz
        w[:len(nz), o] = weights[nz, o]
    return idx, w


@functools.lru_cache(maxsize=None)
def _resize_taps(n_in: int, n_out: int, device: torch.device):
    """`_resize_taps_np` on `device`, copied there once per shape and device."""
    idx, w = _resize_taps_np(n_in, n_out)
    return (torch.as_tensor(idx, device=device), torch.as_tensor(w, device=device))


def _resize_axis(img: torch.Tensor, n_out: int, dim: int) -> torch.Tensor:
    """One axis of the linear resize: each output line is its taps' weighted
    sum, added in ascending input order."""
    if img.shape[dim] == n_out:
        return img
    idx, w = _resize_taps(img.shape[dim], n_out, img.device)
    out = None
    for t in range(idx.shape[0]):
        if dim == 0:
            term = img.index_select(0, idx[t]) * w[t][:, None]
        else:
            term = img.index_select(1, idx[t]) * w[t][None, :]
        out = term if out is None else out + term
    return out


def resize_linear(img: torch.Tensor, shape) -> torch.Tensor:
    """jax.image.resize(img, shape, "linear") for a 2-D image (antialiased
    when downsampling), as fixed-order tap sums: rows, then columns."""
    return _resize_axis(_resize_axis(img, shape[0], 0), shape[1], 1)


def build_scaled_pyramid(img: torch.Tensor, levels: int,
                         scale_factor: float) -> List[torch.Tensor]:
    """Fractional-scale pyramid by chained linear resize (the ORBextractor's
    x1.2 / 8-level scale space, Features/ORBextractor.cpp:773-797: each level
    from the previous one, so blur accumulates down the octaves)."""
    shapes = scaled_pyramid_shapes(img.shape[0], img.shape[1], levels, scale_factor)
    pyr = [img]
    for lvl in range(1, levels):
        pyr.append(resize_linear(pyr[-1], shapes[lvl]))
    return pyr


def gaussian_blur(img: torch.Tensor, sigma: float = 2.0, radius: int = 3) -> torch.Tensor:
    """Separable Gaussian blur over a reflect-padded image (ORBextractor
    blurs 7x7 sigma 2 before describing, Features/ORBextractor.cpp:746)."""
    xs = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    k /= k.sum()
    h, w = img.shape
    pad = F.pad(img[None, None], (radius, radius, radius, radius), mode="reflect")[0, 0]
    acc = torch.zeros_like(img)
    for i, kv in enumerate(k):
        acc = acc + float(kv) * pad[radius: radius + h, i: i + w]
    pad2 = F.pad(acc[None, None], (0, 0, radius, radius), mode="reflect")[0, 0]
    out = torch.zeros_like(img)
    for i, kv in enumerate(k):
        out = out + float(kv) * pad2[i: i + h, :]
    return out


def sobel_gradients(img: torch.Tensor):
    """Central differences (dx = I[x+1] - I[x-1], Features/SVOextractor.cpp:63-66),
    zero on the outer row/column."""
    dx = torch.zeros_like(img)
    dy = torch.zeros_like(img)
    dx[:, 1:-1] = img[:, 2:] - img[:, :-2]
    dy[1:-1, :] = img[2:, :] - img[:-2, :]
    return dx, dy


def box_filter_sum(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Sum over a zero-padded (2r+1)^2 window ("SAME").

    Separable: row pass then column pass, each adding the +s then the -s
    neighbour for s = 1..r — the order the detector kernel (csrc/detect.cu)
    uses too."""
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


def box_filter_sum_xla(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Sum over a zero-padded (2r+1)^2 window in the order XLA's CPU
    reduce_window adds it: from 0, window rows top to bottom, each left to
    right (the JAX package's box_filter_sum, whose sums the STAR, Hessian and
    LATCH paths compare)."""
    h, w = img.shape
    r = radius
    p = F.pad(img, (r, r, r, r))
    out = torch.zeros_like(img)
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            out = out + p[dy: dy + h, dx: dx + w]
    return out


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation at float pixel coords uv (..., 2) = (u=x, v=y),
    clamped into the image; the four products summed in the JAX package's
    order."""
    h, w = img.shape
    u = torch.clamp(uv[..., 0], 0.0, w - 1.0)
    v = torch.clamp(uv[..., 1], 0.0, h - 1.0)
    u0 = torch.clamp_max(torch.floor(u).long(), w - 2)
    v0 = torch.clamp_max(torch.floor(v).long(), h - 2)
    du = u - u0
    dv = v - v0
    u1, v1 = u0 + 1, v0 + 1
    return (img[v0, u0] * (1 - du) * (1 - dv) + img[v0, u1] * du * (1 - dv)
            + img[v1, u0] * (1 - du) * dv + img[v1, u1] * du * dv)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root on every device: through float64,
    whose correctly rounded square root rounds to the f32 one (53 >= 2 x 24
    + 2 bits). PyTorch's vectorised CPU sqrt misses the f32 rounding for
    some inputs, where the card's sqrtf, the CUDA kernels' and XLA's round
    correctly."""
    return torch.sqrt(x.double()).to(x.dtype)


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dimension as a pairwise tree (zero-padded to a power
    of two, halves added elementwise): a fixed order, so the card adds what
    the CPU adds."""
    n = x.shape[-1]
    size = 1
    while size < n:
        size *= 2
    if size != n:
        x = F.pad(x, (0, size - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def nearest_sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour read at float pixel coords (clamped; round half to even)."""
    h, w = img.shape
    u = torch.clamp(torch.round(uv[..., 0]).long(), 0, w - 1)
    v = torch.clamp(torch.round(uv[..., 1]).long(), 0, h - 1)
    return img[v, u]
