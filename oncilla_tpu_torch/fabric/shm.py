"""Same-host shared-memory fabric: put/get is a bounds-checked memcpy.

The port's copy of ``oncilla_tpu/fabric/shm.py``, its server half: the
daemon's segment (``ShmServerFabric``). The client's attach
(``ShmPeerFabric``) waits for the port's client fabrics (ROADMAP A 2.3).

The daemon backs its host arena with a named
``multiprocessing.shared_memory`` segment and advertises the segment
name at CONNECT (behind FLAG_CAP_FABRIC). A client that can ATTACH the
segment — attachability is the same-host proof; hostnames are never
compared, so containers sharing a hostname but not /dev/shm can never
false-positive — moves data by memcpy into the peer's mapped region,
with only control messages riding TCP:

    SHM_MAP             resolve alloc_id -> (extent offset, nbytes)
    memcpy              the one-sided data movement (this module)
    SHM_PUT / SHM_GET   validate + ack: registry lookup, extent identity,
                        bounds, replica role, epoch fencing — and, for
                        puts to a replicated chain, the TCP fan-out —
                        all run daemon-side before the ack

Consistency contract (docs/FABRIC.md): a put is durable only once its
SHM_PUT ack lands; a get is trustworthy only because SHM_GET validated
the extent FIRST (a fenced/stale owner answers STALE_EPOCH and the
client re-walks its failover ladder instead of trusting stale bytes).
Like RDMA writes racing memory-region deregistration, an op through a
freed/expired handle may touch a recycled extent before validation
rejects it — leases must outlive transfers, exactly the existing
DATA_PUT TOCTOU class (runtime/daemon.py _route_put_payload).
"""

from __future__ import annotations

import os

import numpy as np

from oncilla_tpu_torch.fabric.base import ServerFabric

SEG_PREFIX = "ocm-fab-"
# Creating a segment larger than tmpfs' free space succeeds (ftruncate
# is lazy) and then SIGBUSes the process at first touch — refuse up
# front, with slack for concurrent creators.
_FREE_SLACK = 8 << 20


def _shm_module():
    from multiprocessing import shared_memory

    return shared_memory


def _release_mapping(shm) -> None:
    """Release a SharedMemory wrapper whose mapping may still be pinned
    by numpy views (the arena backing, in-flight transfer windows). A
    plain close() raises BufferError then — and the wrapper's __del__
    retries at GC, spraying "Exception ignored" noise at interpreter
    shutdown. Detach the handles instead: the mapping stays owned by
    the surviving views and unmaps when the last one dies (the mmap
    object closes itself once nothing exports its buffer)."""
    try:
        shm.close()
    except BufferError:
        shm._buf = None
        shm._mmap = None


class ShmServerFabric(ServerFabric):
    """Daemon side: create the named segment that BACKS the host arena."""

    name = "shm"

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError(f"capacity must be > 0 (got {capacity})")
        try:
            st = os.statvfs("/dev/shm")
            free = st.f_bavail * st.f_frsize
        except OSError:
            free = None
        if free is not None and free < capacity + _FREE_SLACK:
            raise OSError(
                f"/dev/shm has {free} B free; {capacity} B segment would "
                "SIGBUS at first touch"
            )
        # The name doubles as the cross-host guard: random per segment,
        # so an attach on another host fails (no such file) rather than
        # aliasing an unrelated daemon's arena.
        seg = f"{SEG_PREFIX}{os.getpid():x}-{os.urandom(8).hex()}"
        self._shm = _shm_module().SharedMemory(
            name=seg, create=True, size=capacity
        )
        self.capacity = capacity
        # Fresh POSIX shm is zero-filled, matching HostArena's
        # zeros-at-boot / scrub-on-free contract.
        self._buf = np.frombuffer(self._shm.buf, dtype=np.uint8)
        self._torn = False

    def buffer(self) -> np.ndarray:
        return self._buf

    def descriptor(self) -> dict:
        return {"seg": self._shm.name, "size": self.capacity}

    def teardown(self) -> None:
        """Unlink the segment (idempotent). Called from daemon stop()
        AND kill(): the name must never outlive the daemon in /dev/shm.
        The mapping itself survives until every attacher unmaps — live
        numpy views (in-flight transfers, post-mortem test inspection)
        stay valid; only the NAME is gone."""
        if self._torn:
            return
        self._torn = True
        try:
            self._shm.unlink()
        except (OSError, FileNotFoundError):
            pass
        # The arena's backing views keep the mapping pinned; detach the
        # wrapper so neither close() nor its __del__ fights them.
        _release_mapping(self._shm)

    def exists(self) -> bool:
        """Is the segment name still linked in /dev/shm? (tests)"""
        return os.path.exists(f"/dev/shm/{self._shm.name}")
