"""The one generator of the benchmark's traffic: from a configuration's
sensor and scale and a traffic mix's trajectory, the pool of recorded
sequences a run cycles through, made from the run's seed.

A sequence is rendered once on the device. The pool holds the mix's
`pool_sessions` copies of it (one where the mix names none): with the
configuration's noise model each copy is corrupted on the device by noise
drawn from the seed; without one the copies are the same frames, and the
rendered scene does not depend on the seed. Frames are handed to the program the way the dataset loader
hands them: (H, W) float32 arrays in host memory, grey levels and metres.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from slambench import scene


def derive_seed(seed: int, *path: int) -> int:
    """A 32-bit seed for one purpose of a run, from the run's seed (any
    whole number) and the purpose's path."""
    return int(np.random.SeedSequence([seed % (1 << 64), *path]).generate_state(1)[0])


#: purposes of the derived seeds
NOISE, SESSION, SAMPLE, WARM = 0, 1, 2, 3


@dataclass
class Sequence:
    """One recorded sequence: host frames and their ground truth."""

    timestamps: np.ndarray   # (n,) float64 seconds
    grays: list              # n (H, W) float32 arrays
    depths: list
    poses_twc: np.ndarray    # (n, 4, 4) ground truth


def make_pool(config: dict, traffic: dict, seed: int, device) -> list:
    """The sequences of a run: `pool_sessions` copies of one rendering."""
    sensor = config["sensor"]
    poses_of, room, boxes = scene.TRAJECTORIES[traffic["trajectory"]]
    poses = poses_of(config["sequence_frames"], **traffic.get("trajectory_params", {}))
    frames = [scene.render_frame(sensor, T, room, boxes, device) for T in poses]
    ts = np.arange(len(poses), dtype=np.float64) / sensor["fps"]
    noise = sensor.get("noise")
    copies = traffic.get("pool_sessions", 1)
    pool = []
    for c in range(copies):
        if noise:
            gen = torch.Generator(device=device).manual_seed(derive_seed(seed, NOISE, c))
            noisy = [scene.add_sensor_noise(g, d, noise, gen) for g, d in frames]
        else:
            noisy = frames
        grays = torch.stack([g for g, _ in noisy]).cpu().numpy()
        depths = torch.stack([d for _, d in noisy]).cpu().numpy()
        pool.append(Sequence(ts, list(grays), list(depths), poses))
    return pool
