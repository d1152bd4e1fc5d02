"""TUM / ICL-NUIM / CoRBS dataset readers and the dataset factory (port of
rgbdslam_tpu/io/datasets.py).

Parses `associations.txt` (timestamp rgb_ts rgb_path ts depth_path — the
format the reference consumes, IO/DatasetTUM.cpp:39-55) and infers the
camera from the directory name (IO/DatasetTUM.cpp:61-89's freiburg1/2/3
switch). PNGs decode with cv2 where it is installed, else PIL, else the
port's own decoder (io/png.py), which gives cv2's bits on 8-bit grey,
colour and 16-bit depth files. `grab` returns host numpy arrays, as the JAX
package's does; the tracker uploads them.
"""

from __future__ import annotations

import functools
import os
from typing import List, Optional, Tuple

import numpy as np

from rgbdslam_tpu_torch.geometry.camera import (CORBS, ICL_NUIM, TUM_FR1, TUM_FR2,
                                                TUM_FR3, Camera)

DECODERS = ("cv2", "PIL", "png")


@functools.lru_cache()
def default_decoder() -> str:
    """The first of cv2, PIL and the port's own decoder that imports."""
    try:
        import cv2  # noqa: F401

        return "cv2"
    except ImportError:
        pass
    try:
        from PIL import Image  # noqa: F401

        return "PIL"
    except ImportError:
        return "png"


def load_gray(path: str, decoder: str) -> np.ndarray:
    """(H, W) f32 grey 0..255."""
    if decoder == "cv2":
        import cv2

        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(path)
        return img.astype(np.float32)
    if decoder == "PIL":
        from PIL import Image

        return np.asarray(Image.open(path).convert("L"), dtype=np.float32)
    from rgbdslam_tpu_torch.io.png import read_gray

    return read_gray(path).astype(np.float32)


def load_depth_raw(path: str, decoder: str) -> np.ndarray:
    """(H, W) f32 raw depth samples."""
    if decoder == "cv2":
        import cv2

        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(path)
        return img.astype(np.float32)
    if decoder == "PIL":
        from PIL import Image

        return np.asarray(Image.open(path), dtype=np.float32)
    from rgbdslam_tpu_torch.io.png import read_png

    return read_png(path).astype(np.float32)


def detect_tum_camera(base_dir: str) -> Camera:
    """freiburg1/2/3 intrinsics switch (IO/DatasetTUM.cpp:61-89)."""
    idx = base_dir.find("freiburg")
    if idx < 0:
        return TUM_FR3
    c = base_dir[idx + 8: idx + 9]
    return {"1": TUM_FR1, "2": TUM_FR2, "3": TUM_FR3}.get(c, TUM_FR3)


def parse_associations(path: str) -> Tuple[List[float], List[str], List[str]]:
    """`timestamp rgb ts depth` association file (IO/DatasetTUM.cpp:39-55)."""
    ts, rgb, depth = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 4:
                continue
            ts.append(float(parts[0]))
            rgb.append(parts[1])
            depth.append(parts[3])
    return ts, rgb, depth


class RGBDDataset:
    """Disk-backed RGB-D dataset with the grab(i) interface of
    SyntheticDataset. kind: 'TUM' | 'ICL' | 'CORBS' (IO/Dataset.h enum +
    factory, IO/Dataset.cpp:29-41). PNGs decode with `default_decoder()`."""

    def __init__(self, base_dir: str, kind: str = "TUM", camera: Optional[Camera] = None):
        self.base_dir = base_dir
        self.kind = kind
        self.decoder = default_decoder()
        assoc = os.path.join(base_dir, "associations.txt")
        self.timestamps, self.rgb_files, self.depth_files = parse_associations(assoc)
        if camera is not None:
            self.cam = camera
        elif kind == "TUM":
            self.cam = detect_tum_camera(base_dir)
        elif kind == "ICL":
            self.cam = ICL_NUIM
        elif kind == "CORBS":
            self.cam = CORBS
        else:
            raise ValueError(f"unknown dataset kind {kind!r}")

    def __len__(self) -> int:
        return len(self.timestamps)

    def grab(self, i: int):
        """Returns (timestamp, gray [H,W] f32 0..255, depth [H,W] f32 meters),
        host arrays. Depth scaling by 1/depth_factor mirrors
        Core/Frame.cpp:48 (f32 / python float, as numpy rounds it)."""
        gray = load_gray(os.path.join(self.base_dir, self.rgb_files[i]), self.decoder)
        raw = load_depth_raw(os.path.join(self.base_dir, self.depth_files[i]), self.decoder)
        depth = raw / self.cam.depth_factor
        return self.timestamps[i], gray, depth

    def ground_truth_path(self) -> Optional[str]:
        p = os.path.join(self.base_dir, "groundtruth.txt")
        return p if os.path.exists(p) else None


def open_dataset(path_or_kind: str, **kwargs):
    """'synthetic' / 'synthetic:sweep' / 'synthetic:orbit' / 'synthetic:tour'
    -> SyntheticDataset(trajectory=..., **kwargs); a directory ->
    RGBDDataset(path, kind=kwargs.get('kind', 'TUM'), ...)."""
    if path_or_kind.startswith("synthetic"):
        from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset

        traj = path_or_kind.split(":", 1)[1] if ":" in path_or_kind else "orbit"
        return SyntheticDataset(trajectory=traj, **kwargs)
    kind = kwargs.pop("kind", "TUM")
    return RGBDDataset(path_or_kind, kind=kind, **kwargs)
