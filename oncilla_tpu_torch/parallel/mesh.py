"""Mesh helpers: the ordered list of devices that hold the fabric's rows.

The control plane addresses devices as (rank, device_index); the fabric
addresses them by position in the mesh, ``global = rank * devices_per_rank +
index`` (``oncilla_tpu.parallel.mesh``, the analogue of EXTOLL's flat
(node, vpid) space). Where the JAX package builds a ``jax.sharding.Mesh``
and shards one global array over it, the port keeps one row tensor per mesh
entry, so a mesh is just the list of those rows' devices, and the JAX
module's ``arena_sharding``/``replicated`` have no counterpart.
"""

from __future__ import annotations

import torch

from oncilla_tpu_torch.core.errors import OcmDeviceError
from oncilla_tpu_torch.utils.platform import resolve_device

NODE_AXIS = "node"


def node_mesh(devices=None) -> list[torch.device]:
    """The mesh: one entry per fabric row, in order. The default is every
    CUDA device; without CUDA that raises :class:`OcmDeviceError`. A device
    may repeat, which is how one card (or the CPU, when named) hosts several
    rows."""
    if devices is None:
        if not torch.cuda.is_available():
            raise OcmDeviceError(
                "CUDA is not available; pass devices (e.g. ['cpu'] * 8) to "
                "build the mesh on the CPU"
            )
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return [resolve_device(d) for d in devices]


def global_index(rank: int, device_index: int, devices_per_rank: int) -> int:
    return rank * devices_per_rank + device_index
