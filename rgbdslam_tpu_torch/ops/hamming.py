"""Hamming distances + 2-NN over packed 256-bit descriptors (port of
rgbdslam_tpu/ops/hamming.py, popcount form).

Descriptors are (N, 8) torch.int32 tensors holding uint32 bit patterns
(PyTorch's uint32 shifts and popcounts are incomplete). Popcounts run in
int64 on the zero-extended words. On CUDA the matcher uses kernel K2
(ops/kernels.py) and never builds the N x M matrix; these are its plain
version's parts.
"""

from __future__ import annotations

from typing import Tuple

import torch

BIG_DIST = 1 << 20


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 words (bit patterns), as int64."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """(N, W) int32 words -> (N, 32 W) f32 of 0/1, least significant bit
    first within each word."""
    shifts = torch.arange(32, dtype=torch.int64, device=desc.device)
    bits = ((desc.to(torch.int64) & 0xFFFFFFFF)[:, :, None] >> shifts) & 1
    return bits.reshape(desc.shape[0], -1).to(torch.float32)


def hamming_distance_matrix(desc1: torch.Tensor, desc2: torch.Tensor,
                            valid1: torch.Tensor | None = None,
                            valid2: torch.Tensor | None = None,
                            impl: str = "popcount") -> torch.Tensor:
    """(N, 8) x (M, 8) words -> (N, M) int32 Hamming distances; pairs with
    an invalid end are BIG_DIST.

    impl: 'popcount' (XOR + popcount over the packed words) or 'matmul'
    (d = pop(a) + pop(b) - 2 bits(a) . bits(b), one (N, 256) x (256, M) f32
    product of 0/1 values: exact, and the cheaper form when M is a
    vocabulary of thousands of words). Both give the same integers."""
    if impl == "matmul":
        common = unpack_bits(desc1) @ unpack_bits(desc2).T
        d = (popcount_rows(desc1)[:, None] + popcount_rows(desc2)[None, :]
             - 2 * common.to(torch.int32))
    elif impl == "popcount":
        x = desc1[:, None, :] ^ desc2[None, :, :]
        d = torch.sum(_popcount32(x), dim=-1).to(torch.int32)
    else:
        raise ValueError(f"unknown impl {impl!r}")
    if valid1 is not None:
        d = torch.where(valid1[:, None], d, BIG_DIST)
    if valid2 is not None:
        d = torch.where(valid2[None, :], d, BIG_DIST)
    return d


def knn2(dist: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row 2 nearest neighbours: (best_idx, best_dist, second_dist);
    the first minimum wins ties, and second is the minimum over the other
    columns."""
    best_idx = torch.argmin(dist, dim=1)
    best_dist = torch.amin(dist, dim=1)
    col = torch.arange(dist.shape[1], device=dist.device)[None, :]
    masked = torch.where(col == best_idx[:, None], BIG_DIST, dist)
    second_dist = torch.amin(masked, dim=1)
    return best_idx.to(torch.int32), best_dist, second_dist


def popcount_rows(desc: torch.Tensor) -> torch.Tensor:
    """Number of set bits per descriptor row."""
    return torch.sum(_popcount32(desc), dim=-1).to(torch.int32)
