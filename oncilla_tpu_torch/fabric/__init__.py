"""Pluggable one-sided fabric layer (the reference's swappable L1), the
port's copy of ``oncilla_tpu/fabric/__init__.py``, its server half: the
daemon serves the shared-memory fabric (``server_fabrics``). The port's
client speaks the framed-TCP engine only (:mod:`.tcp`) and does not offer
FLAG_CAP_FABRIC; its attach (``attach_peer``) waits for ROADMAP A 2.3.

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

from oncilla_tpu_torch.fabric.base import ServerFabric
from oncilla_tpu_torch.fabric.shm import ShmServerFabric
from oncilla_tpu_torch.utils.debug import printd

__all__ = ["ServerFabric", "ShmServerFabric", "server_fabrics"]


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
