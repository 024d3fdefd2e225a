"""Cluster membership from a nodefile: the port's copy of the parts of
``oncilla_tpu/runtime/membership.py`` a client needs.

The reference's membership is a positional text nodefile
``#rank hostname ethernet_ip ocm_port rdmacm_port``, with self-rank found
by matching gethostname() (reference src/nodefile.c:30-37,92-103). Where
the hostnames do not match this machine, an initialised
``torch.distributed`` group whose world size equals the node count gives
the rank, as ``jax.process_index`` does for the JAX package.
"""

from __future__ import annotations

import socket
from dataclasses import dataclass

from oncilla_tpu_torch.core.errors import OcmError
from oncilla_tpu_torch.utils.debug import printd


@dataclass(frozen=True)
class NodeEntry:
    """One row of the cluster table (``struct node_entry``, reference
    inc/nodefile.h:19-27). ``host`` is the name used for self-rank
    detection; ``addr`` (the ethernet_ip column) is the address peers
    connect to, and defaults to ``host``."""

    rank: int
    host: str
    port: int
    addr: str | None = None

    @property
    def connect_host(self) -> str:
        return self.addr or self.host


def parse_nodefile(path: str) -> list[NodeEntry]:
    """Parse nodefile lines; '#' starts a comment. Three layouts:

    - ``rank host port`` (short form)
    - ``rank host ip port``
    - ``rank host ip ocm_port rdmacm_port``, the reference's format; the
      trailing per-fabric port is ignored (the data plane is
      connectionless).
    """
    entries: list[NodeEntry] = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            try:
                if len(parts) == 3:
                    entry = NodeEntry(rank=int(parts[0]), host=parts[1],
                                      port=int(parts[2]))
                elif len(parts) in (4, 5):
                    entry = NodeEntry(rank=int(parts[0]), host=parts[1],
                                      port=int(parts[3]), addr=parts[2])
                else:
                    raise ValueError("wrong field count")
            except ValueError:
                raise OcmError(
                    f"{path}:{lineno}: expected 'rank host port', "
                    "'rank host ip port' or "
                    "'rank host ip ocm_port rdmacm_port'"
                ) from None
            entries.append(entry)
    entries.sort(key=lambda e: e.rank)
    if [e.rank for e in entries] != list(range(len(entries))):
        raise OcmError(f"{path}: ranks must be contiguous from 0")
    return entries


def detect_rank(entries: list[NodeEntry]) -> int:
    """Self-rank by hostname match (nodefile.c:92-103), falling back to
    ``torch.distributed``'s rank when a process group is initialised and
    its world size equals the node count (multi-host jobs whose nodefile
    names hosts this machine's gethostname does not match)."""
    hostname = socket.gethostname()
    for e in entries:
        if e.host in (hostname, hostname.split(".")[0], "localhost",
                      "127.0.0.1"):
            return e.rank
    try:
        import torch.distributed as dist

        if (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() == len(entries)):
            return int(dist.get_rank())
    except (ImportError, RuntimeError) as e:
        printd("detect_rank: torch.distributed probe failed: %s", e)
    raise OcmError(f"hostname {hostname!r} not present in nodefile")
