"""Pluggable one-sided fabric layer (the reference's swappable L1), the
port's copy of ``oncilla_tpu/fabric/__init__.py``, line for line.

The data plane is selected PER PEER PAIR at CONNECT: a client whose
config offers fabrics (OCM_FABRIC=shm/auto) sets FLAG_CAP_FABRIC on its
data-plane CONNECT probe; a daemon that registered a fabric echoes the
bit with a JSON descriptor tail; the client then proves reachability
(for shm: by attaching the named segment) and the pair runs the best
fabric both sides proved — everyone else falls back to the framed-TCP
engine (fabric/tcp.py), the zeroth backend negotiation never has to
name. See docs/FABRIC.md for the negotiation matrix.

Registry shape: one ServerFabric class per backend the daemon can
serve, one PeerFabric per backend the client can attach. The planned
ICI chip-to-chip backend (ops/ici.py) is a future entry here, not a
runtime rewrite.
"""

from __future__ import annotations

import json

from oncilla_tpu_torch.core.errors import OcmError
from oncilla_tpu_torch.fabric.base import FabricKey, PeerFabric, ServerFabric
from oncilla_tpu_torch.fabric.shm import ShmPeerFabric, ShmServerFabric
from oncilla_tpu_torch.utils.debug import printd

__all__ = [
    "FabricKey",
    "PeerFabric",
    "ServerFabric",
    "ShmPeerFabric",
    "ShmServerFabric",
    "attach_peer",
    "server_fabrics",
]

# Client-side attachers, tried in preference order against a daemon's
# descriptor tail. (tcp is not listed: it is the fallback, not an
# attachable region.)
PEER_BACKENDS: dict[str, type] = {"shm": ShmPeerFabric}


def server_fabrics(config) -> dict[str, ServerFabric]:
    """The ServerFabrics a daemon with this config serves. Creation
    failures degrade to tcp-only with a diagnostic — a daemon must
    come up on a host with a full /dev/shm, it just can't serve shm."""
    out: dict[str, ServerFabric] = {}
    if getattr(config, "fabric_offer", False):
        try:
            out["shm"] = ShmServerFabric(config.host_arena_bytes)
        except (OSError, ValueError) as e:
            printd("fabric: shm unavailable (%s); serving tcp only", e)
    return out


def attach_peer(descriptor_tail: bytes, control) -> PeerFabric | None:
    """Client side of negotiation: parse a daemon's descriptor tail and
    return the first backend this process can actually reach, or None
    (-> tcp). Unattachable descriptors — a cross-host segment name, a
    daemon that died since advertising, a malformed tail from a future
    daemon — are a clean decline, never an error: tcp always works."""
    try:
        desc = json.loads(bytes(descriptor_tail))
    except (ValueError, UnicodeDecodeError):
        return None
    if not isinstance(desc, dict):
        return None
    for name, cls in PEER_BACKENDS.items():
        entry = desc.get(name)
        if not isinstance(entry, dict):
            continue
        try:
            return cls(entry, control)
        except (OSError, OcmError, ValueError) as e:
            printd("fabric: %s descriptor not attachable (%s)", name, e)
    return None
