"""The ``('blocks',)`` mesh (counterpart of the reference's
``parallel/mesh.py``).

Every independent frame block is its own compression problem, so the
one axis of parallelism is blocks: a batch of blocks is cut into as many
contiguous shards as the mesh has devices, each shard runs on its
device, and the results are gathered in order (``BlocksMesh.batch`` and
``BlocksMesh.shards`` hold that rule).  The mesh is a tuple of
``torch.device``; a device may appear more than once (two shards on one
card, or ``["cpu"] * 8`` in tests, as the reference's tests lay their
mesh over 8 virtual CPU devices).
"""

from __future__ import annotations

import dataclasses

import torch

from .device import resolve_device

__all__ = ["BlocksMesh", "blocks_mesh", "local_device_count"]


@dataclasses.dataclass(frozen=True)
class BlocksMesh:
    """A one-axis mesh: the devices, in shard order."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    def batch(self, rows: int) -> int:
        """``rows`` rounded down to a multiple of the mesh's size, and at
        least one row a device (reference: sharded.py:317-320)."""
        return max(rows // self.size, 1) * self.size

    def shards(self, rows: int) -> list[tuple[torch.device, int, int]]:
        """The contiguous shards of a batch of ``rows`` rows, as
        (device, lo, hi) in order.  The batch is laid out as the
        reference pads it, ``ceil(rows / size)`` rows a device
        (sharded.py:321-325); the pad rows are not staged, so a device
        whose part is only padding gets no shard."""
        per = -(-rows // self.size)
        return [(d, k * per, min((k + 1) * per, rows))
                for k, d in enumerate(self.devices) if k * per < rows]


def local_device_count() -> int:
    """The number of CUDA devices of this process."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def blocks_mesh(n_devices: int | None = None, devices=None) -> BlocksMesh:
    """A ``('blocks',)`` mesh over the first ``n_devices`` of ``devices``
    (default: every CUDA device).  Raises when more devices are asked for
    than there are, and when a CUDA device is named and none is present:
    nothing drops to the CPU on its own."""
    if devices is None:
        if not local_device_count():
            raise RuntimeError("blocks_mesh: CUDA is not available; pass "
                               "devices= to lay the mesh over others")
        devices = [f"cuda:{k}" for k in range(local_device_count())]
    devs = [resolve_device(d) for d in devices]
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return BlocksMesh(tuple(devs[:n]))
