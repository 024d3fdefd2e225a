"""Placement policy: which node/device hosts a new allocation.

The reference's ``alloc_find`` (reference src/alloc.c:77-140) is the
rank-0 placement policy: force local host memory when single-node
(alloc.c:82-83), else fixed neighbor round-robin ``(orig_rank+1) % nnodes``
(alloc.c:107,120 — marked /* XXX */), with capacity validation commented out
(alloc.c:87-92). Here placement is pluggable; the neighbor policy reproduces
reference behavior, and the capacity-aware policy is the upgrade SURVEY.md §7
("Hard parts") calls for: per-chip HBM accounting.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from oncilla_tpu_torch.analysis.lockwatch import make_lock
from oncilla_tpu_torch.core.errors import OcmPlacementError
from oncilla_tpu_torch.core.kinds import OcmKind


@dataclass
class NodeResources:
    """What rank 0 knows about one node, reported at ADD_NODE time
    (alloc_add_node analogue, alloc.c:60-74) and updated on alloc/free."""

    rank: int
    ndevices: int
    device_arena_bytes: int
    host_arena_bytes: int
    device_used: list[int] = field(default_factory=list)
    host_used: int = 0

    def __post_init__(self):
        if not self.device_used:
            self.device_used = [0] * self.ndevices


@dataclass(frozen=True)
class Placement:
    rank: int
    device_index: int
    kind: OcmKind
    # k-way replication (resilience/): the k-1 replica ranks chosen
    # alongside the primary, each on a distinct node. () = single copy.
    replica_ranks: tuple[int, ...] = ()


class PlacementPolicy:
    """Tracks cluster resources and sites allocations. Thread-safe."""

    def __init__(self):
        self._nodes: dict[int, NodeResources] = {}
        self._rr = 0
        self._dead: set[int] = set()
        self._lock = make_lock("placement._lock")

    # -- membership ------------------------------------------------------

    def add_node(self, res: NodeResources) -> None:
        with self._lock:
            self._nodes[res.rank] = res
            self._dead.discard(res.rank)  # a (re)joining node is alive

    def mark_dead(self, rank: int) -> None:
        """Stop siting allocations on a rank the detector declared DEAD
        (its resources stay recorded for when it rejoins via ADD_NODE)."""
        with self._lock:
            if rank in self._nodes:
                self._dead.add(rank)

    def mark_alive(self, rank: int) -> None:
        with self._lock:
            self._dead.discard(rank)

    def remove_node(self, rank: int) -> None:
        """A member LEFT cleanly (elastic/): drop its resources from the
        table entirely — unlike mark_dead, a departed rank must not
        count toward capacity queries or ever rejoin implicitly."""
        with self._lock:
            self._nodes.pop(rank, None)
            self._dead.discard(rank)

    def host_free(self) -> dict[int, int]:
        """Free host-arena bytes per alive rank — what the rebalancer's
        capacity-weighted planner sites migrations against."""
        with self._lock:
            return {
                r: n.host_arena_bytes - n.host_used
                for r, n in self._nodes.items() if r not in self._dead
            }

    def host_capacities(self) -> dict[int, int]:
        """Host-arena capacity per alive rank (the rebalance weights)."""
        with self._lock:
            return {
                r: n.host_arena_bytes
                for r, n in self._nodes.items() if r not in self._dead
            }

    @property
    def nnodes(self) -> int:
        with self._lock:
            return len(self._nodes)

    # -- master-state replication (control/leader.py) --------------------

    def export_rows(self) -> list[dict]:
        """The accounting table as plain rows — what the leader
        replicates to standby masters (JSON + CRC, snapshot discipline)
        so a promoted standby resumes placement from live numbers
        instead of zeros."""
        with self._lock:
            return [
                {
                    "rank": n.rank,
                    "ndevices": n.ndevices,
                    "device_arena_bytes": n.device_arena_bytes,
                    "host_arena_bytes": n.host_arena_bytes,
                    "device_used": list(n.device_used),
                    "host_used": n.host_used,
                }
                for _, n in sorted(self._nodes.items())
            ]

    def restore(self, rows: list[dict], dead=()) -> None:
        """Adopt a replicated (or rebuilt) accounting table WHOLE —
        the promotion path. Replaces the node table; the dead set is
        reset to ``dead`` so a deposed leader's verdicts carry over."""
        nodes: dict[int, NodeResources] = {}
        for r in rows:
            n = NodeResources(
                rank=int(r["rank"]),
                ndevices=int(r["ndevices"]),
                device_arena_bytes=int(r["device_arena_bytes"]),
                host_arena_bytes=int(r["host_arena_bytes"]),
                device_used=[int(x) for x in r.get("device_used", [])],
                host_used=int(r.get("host_used", 0)),
            )
            nodes[n.rank] = n
        with self._lock:
            self._nodes = nodes
            self._dead = {int(d) for d in dead if int(d) in nodes}

    # -- cluster-wide queries (qos/: validation + back-pressure) ---------

    def max_capacity(self, kind: OcmKind) -> int:
        """Largest single-arena capacity any non-dead node offers for
        ``kind`` — a request above it can NEVER be sited, so REQ_ALLOC
        rejects it up front instead of bouncing through placement/OOM."""
        with self._lock:
            caps = [
                n.host_arena_bytes
                if kind in (OcmKind.REMOTE_HOST, OcmKind.LOCAL_HOST)
                else n.device_arena_bytes
                for r, n in self._nodes.items() if r not in self._dead
            ]
        return max(caps, default=0)

    def min_host_occupancy(self) -> float | None:
        """The LEAST-loaded alive node's host-arena occupancy in [0, 1]
        (None with no alive nodes). This is the back-pressure signal:
        when even the emptiest rank is past the high watermark, REQ_ALLOC
        answers BUSY rather than packing arenas to the brim."""
        with self._lock:
            occ = [
                n.host_used / n.host_arena_bytes
                for r, n in self._nodes.items()
                if r not in self._dead and n.host_arena_bytes > 0
            ]
        return min(occ) if occ else None

    # -- accounting ------------------------------------------------------

    def note_alloc(self, p: Placement, nbytes: int) -> None:
        with self._lock:
            node = self._nodes[p.rank]
            if p.kind in (OcmKind.REMOTE_HOST, OcmKind.LOCAL_HOST):
                node.host_used += nbytes
            else:
                node.device_used[p.device_index] += nbytes

    def note_free(self, p: Placement, nbytes: int) -> None:
        with self._lock:
            node = self._nodes[p.rank]
            if p.kind in (OcmKind.REMOTE_HOST, OcmKind.LOCAL_HOST):
                node.host_used = max(0, node.host_used - nbytes)
            else:
                node.device_used[p.device_index] = max(
                    0, node.device_used[p.device_index] - nbytes
                )

    # -- policy ----------------------------------------------------------

    def place(
        self,
        orig_rank: int,
        kind: OcmKind,
        nbytes: int,
        replicas: int = 1,
        exclude: tuple[int, ...] = (),
    ) -> Placement:
        """Site an allocation. ``replicas`` > 1 asks for a primary plus
        ``replicas - 1`` replica ranks on DISTINCT nodes (host kinds; the
        result's ``replica_ranks`` may be shorter when the cluster has
        too few eligible nodes — degraded, never an error). ``exclude``
        bars specific ranks (re-replication must avoid the surviving
        chain). DEAD-marked ranks are never candidates."""
        raise NotImplementedError


class NeighborRoundRobin(PlacementPolicy):
    """Reference-parity policy: remote allocations go to
    ``(orig_rank + 1) % nnodes`` (alloc.c:107,120), single node demotes to
    local (alloc.c:82-83). Device chosen round-robin within the node.
    Replicas continue the same walk: the next distinct eligible ranks
    after the primary."""

    def place(
        self,
        orig_rank: int,
        kind: OcmKind,
        nbytes: int,
        replicas: int = 1,
        exclude: tuple[int, ...] = (),
    ) -> Placement:
        import bisect

        with self._lock:
            n = len(self._nodes)
            if n == 0:
                raise OcmPlacementError("no nodes registered")
            if n == 1 and kind.is_remote:
                # Single-node demotion, alloc.c:82-83.
                kind = (
                    OcmKind.LOCAL_DEVICE
                    if kind == OcmKind.REMOTE_DEVICE
                    else OcmKind.LOCAL_HOST
                )
                return Placement(rank=orig_rank, device_index=0, kind=kind)
            barred = self._dead | set(exclude)
            # Walk the LIVE rank set cyclically from the neighbor slot.
            # Ranks need not be contiguous once members JOIN/LEAVE
            # post-boot (elastic/): a departed rank keeps its number but
            # leaves the table, so the reference's (orig+1) % nnodes
            # arithmetic generalizes to "next registered rank after
            # orig_rank, wrapping" — identical on a contiguous table.
            ranks = sorted(self._nodes)
            start = (orig_rank + 1) % (max(ranks) + 1)
            i0 = bisect.bisect_left(ranks, start) % n
            order = ranks[i0:] + ranks[:i0]
            cands = [r for r in order if r not in barred]
            if not cands:
                raise OcmPlacementError("no eligible node (all dead/excluded)")
            rank = cands[0]
            reps: list[int] = []
            if replicas > 1:
                reps = cands[1:replicas]
            if kind == OcmKind.REMOTE_HOST:
                return Placement(rank=rank, device_index=0, kind=kind,
                                 replica_ranks=tuple(reps))
            node = self._nodes[rank]
            self._rr += 1
            return Placement(
                rank=rank,
                device_index=self._rr % max(1, node.ndevices),
                kind=kind,
                replica_ranks=tuple(reps),
            )


class CapacityAware(PlacementPolicy):
    """Pick the (node, device) with the most free bytes that can actually fit
    the request — the accounting the reference commented out
    (alloc.c:87-92) made real. Never places on the origin rank when another
    node fits (disaggregation intent). Replicas take the next-fullest-free
    DISTINCT nodes after the primary."""

    def _weight(self, rank: int, free: int) -> int:
        """Candidate score (higher wins). The base policy ranks by free
        bytes alone; qos.loadaware.LoadAware overrides this to discount
        hot ranks using the live obs per-rank stats. Called under
        self._lock."""
        return free

    def place(
        self,
        orig_rank: int,
        kind: OcmKind,
        nbytes: int,
        replicas: int = 1,
        exclude: tuple[int, ...] = (),
    ) -> Placement:
        with self._lock:
            if not self._nodes:
                raise OcmPlacementError("no nodes registered")
            n = len(self._nodes)
            if n == 1 and kind.is_remote:
                kind = (
                    OcmKind.LOCAL_DEVICE
                    if kind == OcmKind.REMOTE_DEVICE
                    else OcmKind.LOCAL_HOST
                )
                return Placement(rank=orig_rank, device_index=0, kind=kind)

            barred = self._dead | set(exclude)
            candidates: list[tuple[int, Placement]] = []
            for rank, node in self._nodes.items():
                if rank in barred:
                    continue
                prefer_remote = 0 if rank != orig_rank else -(1 << 62)
                if kind == OcmKind.REMOTE_HOST:
                    free = node.host_arena_bytes - node.host_used
                    if free >= nbytes:
                        candidates.append(
                            (self._weight(rank, free) + prefer_remote,
                             Placement(rank, 0, kind))
                        )
                else:
                    for di in range(node.ndevices):
                        free = node.device_arena_bytes - node.device_used[di]
                        if free >= nbytes:
                            candidates.append(
                                (self._weight(rank, free) + prefer_remote,
                                 Placement(rank, di, kind))
                            )
            if not candidates:
                raise OcmPlacementError(
                    f"no node can fit {nbytes} B of {kind.value}"
                )
            candidates.sort(key=lambda c: c[0], reverse=True)
            primary = candidates[0][1]
            reps: list[int] = []
            if replicas > 1:
                for _, p in candidates[1:]:
                    if len(reps) >= replicas - 1:
                        break
                    if p.rank != primary.rank and p.rank not in reps:
                        reps.append(p.rank)
            if not reps:
                return primary
            return Placement(
                rank=primary.rank,
                device_index=primary.device_index,
                kind=primary.kind,
                replica_ranks=tuple(reps),
            )


def _make_loadaware():
    # Lazy factory, not a class reference: qos.loadaware subclasses
    # CapacityAware from THIS module, so a top-level import here would be
    # circular. The factory resolves at first use, long after both
    # modules finished initializing.
    from oncilla_tpu_torch.qos.loadaware import LoadAware

    return LoadAware()


POLICIES = {
    "neighbor": NeighborRoundRobin,
    "capacity": CapacityAware,
    "loadaware": _make_loadaware,
}
