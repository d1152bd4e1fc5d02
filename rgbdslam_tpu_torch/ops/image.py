"""Image ops: half-sample pyramid, blur, gradients, box sums, nearest reads
(port of rgbdslam_tpu/ops/image.py).

Sums run as separable shift-and-accumulate passes in a fixed order, so a
result does not depend on how a library kernel orders its reduction.
"""

from __future__ import annotations

from typing import List

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


def nearest_sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour read at float pixel coords (clamped; round half to even)."""
    h, w = img.shape
    u = torch.clamp(torch.round(uv[..., 0]).long(), 0, w - 1)
    v = torch.clamp(torch.round(uv[..., 1]).long(), 0, h - 1)
    return img[v, u]
