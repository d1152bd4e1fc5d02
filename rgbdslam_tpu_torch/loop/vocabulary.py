"""Vocabulary persistence (port of rgbdslam_tpu/loop/vocabulary.py): the
shipped codebook artifact and npz load/save. Words are stored as uint32 and
held as int32 bit patterns, like every descriptor in this package.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

#: shipped vocabulary artifacts by detector (the reference's
#: voc_TUM_FAST_BRIEF.yml.gz analog, main.cpp:15), trained offline over
#: synthetic worlds
_SHIPPED = {
    "svo_fast": "voc_synth_fast_brief.npz",
    "fast": "voc_synth_fast_brief.npz",
    "brief": "voc_synth_fast_brief.npz",
}


def shipped_vocabulary(detector: str) -> Optional[str]:
    """Path of the shipped vocabulary matching a detector's descriptor
    family, or None if no artifact fits."""
    name = _SHIPPED.get(detector)
    if name is None:
        return None
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "assets", name)
    return path if os.path.exists(path) else None


def save_vocabulary(path: str, words, idf) -> None:
    w = np.ascontiguousarray(torch.as_tensor(words).cpu().numpy())
    if w.dtype == np.int32:
        w = w.view(np.uint32)
    np.savez_compressed(path, words=w, idf=torch.as_tensor(idf).cpu().numpy())


def load_vocabulary(path: str, device="cpu"):
    """(words (V, 8) int32 bit patterns, idf (V,) f32) on `device`."""
    with np.load(path) as d:
        words, idf = np.asarray(d["words"]), np.asarray(d["idf"], dtype=np.float32)
    if words.dtype != np.uint32:
        raise NotImplementedError("float vocabularies are not yet ported")
    words = np.ascontiguousarray(words).view(np.int32)
    return (torch.as_tensor(words, device=device), torch.as_tensor(idf, device=device))
