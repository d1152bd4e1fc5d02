"""Data-parallel multi-sequence odometry over a mesh of shards (port of
rgbdslam_tpu/parallel/dp_odometry.py).

The offline-mapping serving shape: S independent RGB-D sequences (or S
segments of one long sequence), each run through the pipelined odometry's
frame-pair step (slam/pipeline.py: features, matching, RANSAC, the GICP
polish), split over the mesh's `seq` shards in contiguous blocks. No
collectives: a sequence's frame chain is sequential, sequences are not. On
a card each frame pair launches the ported kernels: the detection (kernels
A and B), K2 and its gate, RANSAC (kernels A and B) and K4.

RANSAC draws from a generator per sequence (the RNG is injected, as
everywhere in the port), or from injected per-frame `draws`, with which the
tests hold the port against the JAX package's keys.

The reference has no analog (single process, single sequence; SURVEY.md
section 2.7 P7 "absent").
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from rgbdslam_tpu_torch.config import SlamConfig
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.parallel.dist_ba import Mesh, make_mesh


def make_seq_mesh(n_devices: Optional[int] = None, axis: str = "seq", device="cuda") -> Mesh:
    """1-D mesh of `n_devices` sequence shards (make_mesh on the `seq` axis)."""
    return make_mesh(n_devices, axis=axis, device=device)


def _sequence_odometry(cam: Camera, cfg: SlamConfig):
    """fn(grays [T, H, W], depths [T, H, W], generator, draws=None) ->
    (T21 chain [T-1, 4, 4], inliers [T-1]) for one sequence, on its
    frames' device: the pipelined odometry's body without the host loop.
    `draws` (T-1, H, S) injects RANSAC's sample indices frame by frame."""
    from rgbdslam_tpu_torch.frontend.frame import build_frame_features
    from rgbdslam_tpu_torch.slam.pipeline import track_pair

    def run(grays, depths, generator, draws=None):
        f_prev = build_frame_features(cam, grays[0], depths[0], cfg.extractor)
        T21s, ninl = [], []
        for t in range(1, grays.shape[0]):
            f_cur = build_frame_features(cam, grays[t], depths[t], cfg.extractor)
            T21, n, _ok = track_pair(cfg, f_prev, f_cur, generator,
                                     None if draws is None else draws[t - 1])
            T21s.append(T21)
            ninl.append(n)
            f_prev = f_cur
        return torch.stack(T21s), torch.stack(ninl)

    return run


def dp_odometry(cam: Camera, cfg: SlamConfig, mesh: Mesh, axis: str = "seq"):
    """Returns fn(grays [S, T, H, W], depths [S, T, H, W], generators,
    draws=None) -> (T21 [S, T-1, 4, 4], inliers [S, T-1]) with the S
    sequences split over the mesh's shards.

    S must be a multiple of the mesh size; each shard runs its sequences
    one after another on its device. `generators`: S torch.Generators, each
    on its sequence's shard's device, or S integer seeds (a generator is
    made there); None with `draws` (S, T-1, H, S_sample). The results are
    gathered in sequence order on the mesh's home device (across processes
    too: each process runs its own shards' sequences). No collective enters
    the per-frame work."""
    from rgbdslam_tpu_torch.slam.tracking import check_system_config

    seq_fn = _sequence_odometry(cam, cfg)
    for d in set(mesh.devices):
        check_system_config(cfg, cam, d)

    def run(grays, depths, generators: Optional[Sequence] = None, draws=None):
        S = grays.shape[0]
        if S % mesh.size:
            raise ValueError(f"{S} sequences over {mesh.size} shards")
        if generators is None and draws is None:
            raise ValueError("dp_odometry needs generators or injected draws")
        per = S // mesh.size
        T21_parts, ninl_parts = [], []
        for shard, dev in zip(mesh.local_shards(), mesh.devices):
            T21_s, ninl_s = [], []
            for s in range(shard * per, (shard + 1) * per):
                gen = None
                if generators is not None:
                    gen = generators[s]
                    if not isinstance(gen, torch.Generator):
                        gen = torch.Generator(device=dev).manual_seed(int(gen))
                dr = None if draws is None else torch.as_tensor(draws[s]).to(dev)
                T21, n = seq_fn(torch.as_tensor(grays[s]).to(dev),
                                torch.as_tensor(depths[s]).to(dev), gen, dr)
                T21_s.append(T21)
                ninl_s.append(n)
            T21_parts.append(torch.stack(T21_s))
            ninl_parts.append(torch.stack(ninl_s))
        return mesh.gather(T21_parts), mesh.gather(ninl_parts)

    return run


def compose_chain(T21s: np.ndarray) -> np.ndarray:
    """Frame-to-frame chains -> absolute Tcw trajectories.

    T21s: (..., T-1, 4, 4); returns (..., T, 4, 4) with Tcw[0] = I and
    Tcw[t] = T21[t-1] @ Tcw[t-1] (Solver/SolverSE3.cpp:124-126 convention).
    """
    T21s = np.asarray(T21s)
    lead = T21s.shape[:-3]
    T = T21s.shape[-3] + 1
    out = np.tile(np.eye(4, dtype=T21s.dtype), lead + (T, 1, 1))
    for t in range(1, T):
        out[..., t, :, :] = T21s[..., t - 1, :, :] @ out[..., t - 1, :, :]
    return out
