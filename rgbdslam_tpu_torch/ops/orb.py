"""Upright BRIEF-256 descriptors (port of rgbdslam_tpu/ops/orb.py, the
`brief` path the live tracker uses; Features/Extractor.cpp:59).

The sampling pattern is the JAX package's numpy draw (default_rng(7)): the
shipped loop-closure vocabulary was trained on those bits. Where the JAX
package reads the pattern samples through one-hot matmuls (to keep off the
TPU's gather unit), the port reads them with a direct per-pair gather — the
same pixels, so the same bits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

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
