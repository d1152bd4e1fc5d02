"""Device selection and host-to-device copies.

Entry points run on the card unless the caller asks for the CPU; a CUDA
request without a card raises. Host arrays go up through pinned memory with
a non-blocking copy: a copy from pageable memory makes the host wait for
the device, which the per-frame path must not.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA request without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev


def upload(a, device: torch.device) -> torch.Tensor:
    """The tensor or host array `a` as a tensor on `device`. A tensor already
    there is returned as it is; host data bound for a card is staged in
    pinned memory and copied without blocking the host."""
    if isinstance(a, torch.Tensor):
        if a.device == device:
            return a
        t = a
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
