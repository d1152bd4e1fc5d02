"""The chip's peaks and the least time each measured kernel could take.

Peaks of one NVIDIA H100 SXM at its full 700 W (NVIDIA's data sheet): HBM
3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s. A kernel's least
time is the larger of its bytes over the memory rate (each input read once,
each output written once) and its operations over the peak rate, counted at
the least known form of the function on the cell's shapes, not as the
kernel's own algorithm does them (copied from the program's smoke script,
where each count is argued).
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

# Per pixel of the detection: central differences 2; the three products 3;
# the 9x9 box sums of three channels as running sums 12; the eigenvalue 13;
# FAST-10 (centre +- threshold 2, 32 ring comparisons, 32 bits set, the arc
# test by doubling shifts 2 x 11 and their or 1); the corner mask 1 and the
# 3x3 NMS as separable maxima 5; the border gate and the cell maximum 2.
DETECT_OPS_PER_PX = 2 + 3 + 12 + 13 + (2 + 32 + 32 + 2 * 11 + 1) + (1 + 5) + 2


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least seconds the card could take."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_OPS_PER_S)


def rank_ops(n: int) -> int:
    """A stable descending ranking of n cells at its least: n ceil(log2 n)
    comparisons of 2 operations (the score, then the index on a tie)."""
    return 2 * n * max(n - 1, 0).bit_length()


def detect_bound_s(height: int, width: int, num_levels: int, cell_size: int,
                   num_features: int) -> float:
    """One half-sample detection (kernels A and B): the pyramid in, the
    keypoint slots out (17 bytes a slot); DETECT_OPS_PER_PX a pixel of every
    level read, the merge (4 a level and cell) and the ranking of the cells."""
    levels, n_px, h, w = 0, 0, height, width
    while levels < num_levels and (cell_size >> levels) >= 1:
        n_px += h * w
        h, w = h // 2, w // 2
        levels += 1
    n_cells = (height // cell_size) * (width // cell_size)
    return bound_s(n_px * 4 + num_features * 17,
                   n_px * DETECT_OPS_PER_PX + 4 * n_cells * levels + rank_ops(n_cells))


def match_bound_s(batch: int, n: int, m: int) -> float:
    """One gated 2-NN Hamming match (K2 and its gates) of `batch` query sets
    of n 256-bit descriptors against m: 8 words x (xor, popcount, add) a
    pair, the gates' 5 operations a query; the descriptors and validity in,
    the index and distance a query out."""
    return bound_s(batch * n * 33 + m * 33 + batch * n * 9,
                   batch * n * m * 8 * 3 + batch * n * 5)
