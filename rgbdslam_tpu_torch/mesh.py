"""A 1-D mesh of shards and its fixed-order reduction (the counterpart of
the JAX package's `Mesh` with `shard_map` + `psum`).

A `Mesh` is an ordered tuple of torch devices (the shards; a device may
repeat, so one card or the CPU can hold several) with an axis name and,
when the shards span OS processes, a torch.distributed process group. The
solvers (solvers/pose_graph.py, solvers/cg.py, solvers/ba.py) run every
shard's part on that shard's device, one after another in shard order, and
`Mesh.psum` sums the shards' partial results in shard order: in one process
each partial is copied to the first shard's device and added there in
order; across processes the partials are all-gathered and added in rank
order, so every process holds bit-identical sums, and a mesh of n shards
gives the same bits in one process as across several. No float atomics and
no reduction whose order depends on the backend. A mesh of one shard in one
process adds no device operation: the plain solves are the sharded solves
on `Mesh([device])`.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _on(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`x` on `device`: itself where it lies there already (not even a
    no-op dispatch, so a one-shard mesh costs the plain solve nothing)."""
    return x if x.device == device else x.to(device)


class Mesh:
    """A 1-D mesh of shards: this process's devices (in shard order), the
    axis name, and optionally the process group across which the global
    mesh spans (rank r holds global shards r * n_local .. (r + 1) * n_local
    - 1)."""

    def __init__(self, devices: Sequence, axis: str = "edges", group=None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis
        self.group = group
        if group is not None:
            import torch.distributed as dist

            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
            self._stage_on_host = dist.get_backend(group) == "gloo"
        else:
            self.rank, self.world = 0, 1
            self._stage_on_host = False
        self.reductions = 0     # psum calls (collectives when it spans processes)

    @property
    def size(self) -> int:
        """Shards over every process."""
        return self.world * len(self.devices)

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}

    @property
    def home(self) -> torch.device:
        """The device that holds the replicated state: the first shard's."""
        return self.devices[0]

    @property
    def spans_processes(self) -> bool:
        return self.group is not None and self.world > 1

    def local_shards(self) -> range:
        """The global indices of this process's shards."""
        n = len(self.devices)
        return range(self.rank * n, (self.rank + 1) * n)

    def _gathered(self, partials: Sequence[tuple]) -> list:
        """Every shard's partial (a tuple of tensors) in global shard order,
        on the home device. Across processes the tuples travel as one
        flat vector a shard, in one all_gather."""
        parts = [tuple(_on(t, self.home) for t in p) for p in partials]
        if self.group is None:
            return parts
        import torch.distributed as dist

        shapes = [t.shape for t in parts[0]]
        sizes = [t.numel() for t in parts[0]]
        local = torch.stack([torch.cat([t.reshape(-1) for t in p]) for p in parts])
        if self._stage_on_host:
            local = local.cpu()
        out = [torch.empty_like(local) for _ in range(self.world)]
        dist.all_gather(out, local, group=self.group)
        return [tuple(c.reshape(s) for c, s in zip(flat.to(self.home).split(sizes), shapes))
                for t in out for flat in t.unbind(0)]

    def psum(self, partials: Sequence):
        """The sum over every shard of the mesh of this process's
        `partials` (one a local shard, each a tensor or a tuple of tensors of
        the same shapes on every shard), added in shard order on the home
        device; one reduction however many tensors a partial holds."""
        if len(partials) != len(self.devices):
            raise ValueError(f"{len(partials)} partials for {len(self.devices)} shards")
        self.reductions += 1
        as_tuple = isinstance(partials[0], tuple)
        parts = self._gathered([p if as_tuple else (p,) for p in partials])
        out = parts[0]
        for p in parts[1:]:
            out = tuple(o + q for o, q in zip(out, p))
        return out if as_tuple else out[0]

    def gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Every shard's part (one a local shard, same shape) concatenated
        along dim 0 in shard order, on the home device."""
        got = [p for (p,) in self._gathered([(p,) for p in parts])]
        return got[0] if len(got) == 1 else torch.cat(got)

    def replicate(self, x: torch.Tensor) -> list:
        """`x` on each local shard's device (one copy per distinct device)."""
        on = {}
        for d in self.devices:
            if d not in on:
                on[d] = _on(x, d)
        return [on[d] for d in self.devices]

    def __repr__(self) -> str:
        devs = ", ".join(str(d) for d in self.devices)
        return (f"Mesh({self.axis}: {self.size} shards; rank {self.rank} of "
                f"{self.world} holds [{devs}])")
