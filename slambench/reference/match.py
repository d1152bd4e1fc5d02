"""Plain reference of the gated 2-NN Hamming matcher and of the keyframe
track extension that drives it (toniortiz/rgbd-slam Features/Matcher.cpp's
gates; the landmark-track extension of a keyframe against the one before).

Query i keeps its nearest train j iff the Lowe ratio passes in float32
(best < ratio * second), i is j's nearest query, and both ends are valid.
Ties go to the lower index. Distances are integers, so the result is exact
on any device."""

from __future__ import annotations

from typing import NamedTuple

import torch

BIG = 1 << 20


def _popcount(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def distances(desc1, desc2, valid1, valid2) -> torch.Tensor:
    """(N, 8) x (M, 8) int32 words -> (N, M) Hamming distances, BIG where
    either end is invalid (rows of 64 queries at a time)."""
    rows = []
    for i in range(0, desc1.shape[0], 64):
        x = desc1[i:i + 64, None, :] ^ desc2[None, :, :]
        rows.append(torch.sum(_popcount(x), dim=-1))
    d = torch.cat(rows)
    return torch.where(valid1[:, None] & valid2[None, :], d, BIG)


class Matches(NamedTuple):
    idx2: torch.Tensor    # (N,) nearest train index
    valid: torch.Tensor   # (N,) the match passes every gate


def match(desc1, valid1, desc2, valid2, ratio: float) -> Matches:
    d = distances(desc1, desc2, valid1, valid2)
    best_idx = torch.argmin(d, dim=1)
    best = torch.gather(d, 1, best_idx[:, None])[:, 0]
    cols = torch.arange(d.shape[1], device=d.device)
    second = torch.amin(torch.where(cols[None, :] == best_idx[:, None], BIG, d), dim=1)
    col_best = torch.argmin(d, dim=0)
    rows = torch.arange(d.shape[0], device=d.device)
    ratio32 = torch.tensor(ratio, dtype=torch.float32)
    ratio_ok = best.to(torch.float32) < ratio32 * second.to(torch.float32)
    valid = ratio_ok & (col_best[best_idx] == rows) & valid1 & (best < BIG)
    return Matches(best_idx, valid)


class Gate(NamedTuple):
    """The geometric gate of each match under the relative pose: the 3-D
    gap (m), the reprojection gap (px) and the predicted depth (m)."""

    err_m: torch.Tensor
    err_px: torch.Tensor
    z: torch.Tensor


def track_gate(xyz1, xyz2, uv2, idx2, T21, cam: dict) -> Gate:
    """Each frame-1 point moved by T21 (4, 4) into frame 2, against the
    frame-2 point and keypoint it matched."""
    pred = xyz1 @ T21[:3, :3].T + T21[:3, 3]
    j = idx2.long()
    err = torch.linalg.norm(pred - xyz2[j], dim=-1)
    z = torch.clamp_min(pred[:, 2], 1e-6)
    u = cam["fx"] * pred[:, 0] / z + cam["cx"]
    v = cam["fy"] * pred[:, 1] / z + cam["cy"]
    return Gate(err, torch.hypot(u - uv2[j, 0], v - uv2[j, 1]), pred[:, 2])


def track_mismatch(prog_idx2, prog_ok, ref: Matches, gate: Gate, gate_px: float,
                   margin: float = 1e-3) -> int:
    """Slots where the program's track extension (its nearest index and
    whether it kept the match) differs from the reference: a valid match
    with another index, a kept match the matcher's gates refuse, or a
    geometric decision that differs where the reference's value lies more
    than `margin` (relative) from the threshold."""
    same = prog_idx2 == ref.idx2
    sure_in = ((gate.err_m < 0.10 * (1 - margin)) & (gate.err_px < gate_px * (1 - margin))
               & (gate.z > 0.05 * (1 + margin)))
    sure_out = ((gate.err_m >= 0.10 * (1 + margin)) | (gate.err_px >= gate_px * (1 + margin))
                | (gate.z <= 0.05 * (1 - margin)))
    bad = ((ref.valid & ~same) | (prog_ok & ~ref.valid)
           | (ref.valid & same & sure_in & ~prog_ok) | (prog_ok & sure_out))
    return int(bad.sum())
