"""State carried between the JAX package and the port (numpy only).

The system has no learned weights. What a run carries is its config, the
BRIEF pattern (the same numpy draw in both packages), the per-frame
features the next frame is matched against, the vocabulary, the keyframe
bank, pose-graph edges and bundle-adjustment problems (the per-keyframe
result blob is one f32 array:
`torch.from_numpy` / `.numpy()` carry it). Descriptor words cross as uint32
bits viewed as int32. The `*_from_numpy` functions put what they build on
the card unless the caller asks for the CPU (`device="cpu"`); a CUDA request
without a card raises.
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


def _on(device):
    """`device` as a torch.device: a CUDA request without a card raises
    (device.resolve_device; imported here, as torch is, on first use)."""
    from rgbdslam_tpu_torch.device import resolve_device

    return resolve_device(device)


def frame_features_from_numpy(d: Dict[str, np.ndarray], device="cuda"):
    """FrameFeatures on `device` from a mapping of field name -> numpy array
    (uint32 descriptor words are reinterpreted as int32; float descriptors
    stay f32)."""
    device = _on(device)
    import torch

    from rgbdslam_tpu_torch.frontend.frame import FrameFeatures

    fields = {}
    for name in FEATURE_FIELDS:
        a = np.asarray(d[name])
        if name == "desc" and a.dtype.kind != "f":
            a = np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)
        fields[name] = torch.as_tensor(np.array(a), device=device)
    return FrameFeatures(**fields)


def frame_features_to_numpy(f) -> Dict[str, np.ndarray]:
    """Field name -> numpy array (binary descriptor words as uint32)."""
    out = {}
    for name in FEATURE_FIELDS:
        a = getattr(f, name).detach().cpu().numpy()
        if name == "desc" and a.dtype == np.int32:
            a = a.view(np.uint32)
        out[name] = a
    return out


def desc_words_from_numpy(a: np.ndarray, device="cuda"):
    """uint32 descriptor or vocabulary words (..., 8) as an int32 tensor of
    the same bit patterns; float descriptors or words as f32."""
    device = _on(device)
    import torch

    a = np.asarray(a)
    if a.dtype.kind == "f":
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32), device=device)
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32),
                           device=device)


def vocabulary_from_numpy(words: np.ndarray, idf: np.ndarray, device="cuda"):
    """(words (V, 8) int32 bit patterns or (V, D) f32, idf (V,) f32) on
    `device` from the JAX package's uint32 or f32 words and f32 idf."""
    device = _on(device)
    import torch

    return (desc_words_from_numpy(words, device),
            torch.as_tensor(np.asarray(idf, dtype=np.float32), device=device))


def bank_from_numpy(desc: np.ndarray, xyz: np.ndarray, valid: np.ndarray,
                    bow: np.ndarray, device="cuda"):
    """The device keyframe bank (D, X, V, B) of slam/system.py from host
    arrays: desc (K, N, 8) uint32 or (K, N, 128) f32, xyz (K, N, 3) f32,
    valid (K, N) bool, bow
    (K, Vw) f32. The tensors are fresh copies (the bank is updated in place)."""
    device = _on(device)
    import torch

    return (desc_words_from_numpy(desc, device).clone(),
            torch.tensor(np.asarray(xyz, dtype=np.float32), device=device),
            torch.tensor(np.asarray(valid, dtype=bool), device=device),
            torch.tensor(np.asarray(bow, dtype=np.float32), device=device))


def pose_graph_edges_from_numpy(a, b, Z, weight, device="cuda"):
    """solvers.pose_graph.PoseGraphEdges from the JAX package's edge arrays
    (int32 indices become int64)."""
    device = _on(device)
    import torch

    from rgbdslam_tpu_torch.solvers.pose_graph import PoseGraphEdges

    return PoseGraphEdges(
        a=torch.as_tensor(np.asarray(a, dtype=np.int64), device=device),
        b=torch.as_tensor(np.asarray(b, dtype=np.int64), device=device),
        Z=torch.as_tensor(np.asarray(Z, dtype=np.float32), device=device),
        weight=torch.as_tensor(np.asarray(weight, dtype=np.float32), device=device))


BA_PROBLEM_FIELDS = ("Tcw", "Xw", "lm_valid", "obs_kf", "obs_uv", "obs_valid", "obs_z")
_BA_DTYPES = {"Tcw": np.float32, "Xw": np.float32, "lm_valid": bool, "obs_kf": np.int64,
              "obs_uv": np.float32, "obs_valid": bool, "obs_z": np.float32}


def ba_problem_from_numpy(p, device="cuda"):
    """solvers.ba.BAProblem on `device` from the JAX package's BAProblem
    (or any mapping or object with its fields) as host arrays; int32
    observation indices become int64."""
    device = _on(device)
    import torch

    from rgbdslam_tpu_torch.solvers.ba import BAProblem

    get = p.__getitem__ if isinstance(p, dict) else lambda n: getattr(p, n)
    return BAProblem(**{n: torch.tensor(np.asarray(get(n), dtype=_BA_DTYPES[n]), device=device)
                        for n in BA_PROBLEM_FIELDS})


def ba_problem_to_numpy(p) -> Dict[str, np.ndarray]:
    """Field name -> host array of a BAProblem of either package."""
    out = {}
    for n in BA_PROBLEM_FIELDS:
        a = getattr(p, n)
        out[n] = a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
    return out


def ba_edges_from_numpy(a, b, Z, w, device="cuda"):
    """solvers.ba.BAEdges from the JAX package's edge arrays (int32 vertex
    indices become int64)."""
    device = _on(device)
    import torch

    from rgbdslam_tpu_torch.solvers.ba import BAEdges

    return BAEdges(a=torch.tensor(np.asarray(a, dtype=np.int64), device=device),
                   b=torch.tensor(np.asarray(b, dtype=np.int64), device=device),
                   Z=torch.tensor(np.asarray(Z, dtype=np.float32), device=device),
                   w=torch.tensor(np.asarray(w, dtype=np.float32), device=device))
