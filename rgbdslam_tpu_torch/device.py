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


# The shard count of the distributed backend on one device, the counterpart
# of the JAX package's virtual host devices
# (--xla_force_host_platform_device_count): 0 shows the physical devices, n
# shows n devices that cycle over them (the CPU n times, or one card n
# times). Tests set it with `virtual_devices`; it is neither a SlamConfig
# field nor a CLI flag.
_VIRTUAL_DEVICES = 0
# The one card of this process in a multi-process job (None: every card).
_PROCESS_CARD = None


def set_virtual_devices(n: int) -> None:
    """Show `n` devices (0: the physical ones) to `visible_devices`."""
    global _VIRTUAL_DEVICES
    if n < 0:
        raise ValueError("the virtual device count must be >= 0")
    _VIRTUAL_DEVICES = int(n)


def set_process_card(index) -> None:
    """Show only card `index` (None: every card) to `visible_devices`: a
    process of a multi-process job on a card of its own, or sharing one."""
    global _PROCESS_CARD
    _PROCESS_CARD = None if index is None else int(index)


class virtual_devices:
    """Context manager: `set_virtual_devices(n)` inside, the earlier count
    restored on exit."""

    def __init__(self, n: int):
        self.n = n

    def __enter__(self):
        self.saved = _VIRTUAL_DEVICES
        set_virtual_devices(self.n)
        return self

    def __exit__(self, *exc):
        set_virtual_devices(self.saved)
        return False


def visible_devices(device="cuda") -> list:
    """This process's devices of `device`'s type, in order: the CPU, or
    every card (cuda:0 .. cuda:n-1; the process's own card where one is
    set), cycled to the virtual count where one is set. A CUDA request
    without a card raises."""
    dev = resolve_device(device)
    if dev.type == "cuda" and _PROCESS_CARD is not None:
        phys = [torch.device("cuda", _PROCESS_CARD)]
    elif dev.type == "cuda":
        phys = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        phys = [torch.device(dev.type)]
    n = _VIRTUAL_DEVICES or len(phys)
    return [phys[i % len(phys)] for i in range(n)]


def device_count(device="cuda") -> int:
    """Devices of `device`'s type over every process of the job: this
    process's visible devices times the world size of an initialised
    torch.distributed job (the JAX package's global jax.device_count())."""
    n = len(visible_devices(device))
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        n *= torch.distributed.get_world_size()
    return n
