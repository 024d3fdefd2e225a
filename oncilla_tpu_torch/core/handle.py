"""The opaque allocation handle (``struct lib_alloc``,
reference src/lib.c:36-78): the kind tag plus the address
``(rank, device_index, offset, nbytes)``."""

from __future__ import annotations

from dataclasses import dataclass, field

from oncilla_tpu_torch.core.arena import Extent
from oncilla_tpu_torch.core.kinds import Fabric, OcmKind


@dataclass
class OcmAlloc:
    """Opaque handle to an oncilla allocation.

    Fields:
      alloc_id:     process-unique id (odd, as local ids are in the JAX
                    package, so they never collide with daemon ids).
      kind:         which arm the memory lives on.
      fabric:       which data plane reaches it.
      nbytes:       user-requested size.
      rank:         owning node's rank.
      device_index: owning GPU's index on that node (device arms only).
      extent:       (offset, nbytes) inside the owning arena.
      origin_rank:  rank of the node that requested the allocation.
      owner_addr, local_nbytes, daemon_owned, replica_ranks: as in the
                    JAX package (``oncilla_tpu/core/handle.py:48-66``).
    """

    alloc_id: int
    kind: OcmKind
    fabric: Fabric
    nbytes: int
    rank: int
    device_index: int
    extent: Extent
    origin_rank: int
    freed: bool = field(default=False, compare=False)
    # (host, port) of the owner daemon, from the ALLOC_RESULT reply: where
    # the client sends the handle's DATA_PUT/DATA_GET.
    owner_addr: tuple[str, int] | None = field(default=None, compare=False)
    # App-side staging-window size of a remote handle when smaller than
    # the remote region (``alloc(local_nbytes=)``); None = ``nbytes``.
    local_nbytes: int | None = field(default=None, compare=False)
    # True when a daemon placed and registered the allocation, a
    # single-node DEMOTED one (kind LOCAL_*) included: the daemon owns the
    # bytes, so every data op and the free go through the client, never
    # through the context's own arenas.
    daemon_owned: bool = field(default=False, compare=False)
    # Replica ranks of a k-way replicated allocation: the client's failover
    # candidates. A transfer that cannot reach the primary retries these in
    # order (the first survivor is, by the deterministic promotion rule,
    # the new primary). () = single copy.
    replica_ranks: tuple[int, ...] = field(default=(), compare=False)

    @property
    def is_remote(self) -> bool:
        return self.kind.is_remote

    @property
    def remote_sz(self) -> int:
        """Size of the remote region (``ocm_remote_sz``), 0 for local arms."""
        return self.nbytes if self.is_remote else 0

    def address(self) -> tuple[int, int, int, int]:
        """The one-sided address (rank, device, offset, nbytes)."""
        return (self.rank, self.device_index, self.extent.offset, self.nbytes)
