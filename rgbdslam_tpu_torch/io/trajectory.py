"""TUM-format trajectory files (port of rgbdslam_tpu/io/trajectory.py).

Format: `timestamp tx ty tz qx qy qz qw` per line, (t, q) the camera-to-world
transform Twc (Core/Frame.cpp:20-30, System/Tracking.cpp:286-317).
"""

from __future__ import annotations

import io
from typing import List, Sequence, Tuple

import numpy as np
import torch

from rgbdslam_tpu_torch.geometry import se3


def twc_to_line(timestamp: float, Twc: np.ndarray) -> str:
    R = torch.as_tensor(np.asarray(Twc[:3, :3], dtype=np.float32))
    q = se3.quat_from_rotation(R).numpy()
    t = Twc[:3, 3]
    return (f"{timestamp:.6f} "
            f"{t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
            f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}")


def save_tum(path: str, timestamps: Sequence[float], poses_twc: Sequence[np.ndarray]) -> None:
    """Write a TUM-format trajectory (Twc per timestamp)."""
    with open(path, "w") as f:
        f.write(dumps_tum(timestamps, poses_twc))


def load_tum(path_or_file) -> Tuple[np.ndarray, np.ndarray]:
    """Read a TUM-format trajectory (also ground-truth files with '#'
    comments). Returns (timestamps [N], poses_twc [N, 4, 4])."""
    if isinstance(path_or_file, (str, bytes)):
        with open(path_or_file) as f:
            return load_tum(f)
    ts: List[float] = []
    mats: List[np.ndarray] = []
    for line in path_or_file:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        vals = [float(v) for v in line.split()]
        if len(vals) < 8:
            continue
        q = torch.tensor(vals[4:8], dtype=torch.float32)          # (x, y, z, w)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = se3.rotation_from_quat(q).numpy()
        T[:3, 3] = np.array(vals[1:4], dtype=np.float32)
        ts.append(vals[0])
        mats.append(T)
    return (np.asarray(ts, dtype=np.float64),
            np.stack(mats) if mats else np.zeros((0, 4, 4), np.float32))


def dumps_tum(timestamps: Sequence[float], poses_twc: Sequence[np.ndarray]) -> str:
    buf = io.StringIO()
    for ts, T in zip(timestamps, poses_twc):
        buf.write(twc_to_line(float(ts), np.asarray(T)) + "\n")
    return buf.getvalue()
