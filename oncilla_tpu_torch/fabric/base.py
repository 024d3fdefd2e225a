"""The one-sided fabric contract both halves of a data plane implement.

The port's copy of ``oncilla_tpu/fabric/base.py``, its server half
(``ServerFabric``); the peer half (``FabricKey``, ``PeerFabric``) waits
for the port's client fabrics (ROADMAP A 2.3).

The reference's L1 is a swappable fabric layer: IB verbs RDMA and EXTOLL
RMA2 each expose register/put/get behind one allocation protocol
(PAPER.md §0 layer map; reference src/{rdma,extoll}.c). This module
is that seam for the Python runtime: a **server fabric** registers the
daemon's arena and advertises a descriptor at CONNECT; a **peer fabric**
is the client half for ONE peer pair, moving bytes with one-sided
``put(key, off, src)`` / ``get(key, off, dst)`` against a registered
region key.

Addressing model (the RDMA rkey idiom): the daemon registers its whole
host arena as one region per fabric; per-allocation keys are
``(alloc_id, extent offset, extent nbytes)`` windows inside it, resolved
through the control plane (fabric/shm.py: SHM_MAP). Control traffic —
allocation, leases, replica chains, epoch fencing, the put/get
validate/ack legs — always rides the framed-TCP protocol; only the data
bytes ride the fabric.

The framed-TCP engine itself (fabric/tcp.py) is the zeroth backend: the
one every pair can always fall back to, negotiated by silence. A future
ICI backend (ops/ici.py chip-to-chip transfers) slots in as another
entry in :data:`oncilla_tpu_torch.fabric.PEER_BACKENDS` — a config entry, not
a rewrite.
"""

from __future__ import annotations


class ServerFabric:
    """Daemon-side half: owns the registered arena backing.

    Lifecycle: constructed at daemon boot (before the arena, whose
    storage it may provide via :meth:`buffer`), advertised through
    :meth:`descriptor` on every CONNECT that offers FLAG_CAP_FABRIC,
    torn down — idempotently — on daemon stop AND kill (a crashed
    daemon must not leak registrations; for shm that means the segment
    is unlinked from /dev/shm)."""

    name: str = "?"

    def buffer(self):
        """The registered region as a writable uint8 ndarray, or None
        when this fabric does not provide arena storage."""
        return None

    def descriptor(self) -> dict:
        """The advertisement a client needs to reach this region — the
        'key material' of register(arena) -> key. Must be JSON-safe."""
        raise NotImplementedError

    def teardown(self) -> None:
        raise NotImplementedError
