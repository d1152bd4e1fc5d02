"""State carried between the JAX package and the port (numpy only).

The system has no learned weights. What a run carries is its config, the
BRIEF pattern (the same numpy draw in both packages) and the per-frame
features the next frame is matched against. Descriptor words cross as
uint32 bits viewed as int32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from rgbdslam_tpu_torch import config as torch_config

FEATURE_FIELDS = ("uv", "uv_undist", "xyz", "desc", "score", "level", "valid",
                  "has_depth", "intensity", "smooth", "surf_cov")


def _convert(obj, cls):
    kwargs = {}
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(f.default) and not isinstance(f.default, type):
            v = _convert(v, type(f.default))
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def config_from_jax(cfg) -> torch_config.SlamConfig:
    """The port's SlamConfig from the JAX package's SlamConfig, or from any
    object with the same (nested) fields."""
    return _convert(cfg, torch_config.SlamConfig)


def frame_features_from_numpy(d: Dict[str, np.ndarray], device="cpu"):
    """FrameFeatures on `device` from a mapping of field name -> numpy array
    (uint32 descriptor words are reinterpreted as int32)."""
    import torch

    from rgbdslam_tpu_torch.frontend.frame import FrameFeatures

    fields = {}
    for name in FEATURE_FIELDS:
        a = np.asarray(d[name])
        if name == "desc":
            a = np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)
        fields[name] = torch.as_tensor(np.array(a), device=device)
    return FrameFeatures(**fields)


def frame_features_to_numpy(f) -> Dict[str, np.ndarray]:
    """Field name -> numpy array (descriptor words as uint32)."""
    out = {}
    for name in FEATURE_FIELDS:
        a = getattr(f, name).detach().cpu().numpy()
        if name == "desc":
            a = a.view(np.uint32)
        out[name] = a
    return out
