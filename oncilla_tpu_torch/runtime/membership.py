"""Cluster membership from a nodefile: the port's copy of the parts of
``oncilla_tpu/runtime/membership.py`` its client and its daemon need,
the live member table (``ClusterView``, ``as_view``) among them.

The reference's membership is a positional text nodefile
``#rank hostname ethernet_ip ocm_port rdmacm_port``, with self-rank found
by matching gethostname() (reference src/nodefile.c:30-37,92-103). Where
the hostnames do not match this machine, an initialised
``torch.distributed`` group whose world size equals the node count gives
the rank, as ``jax.process_index`` does for the JAX package.
"""

from __future__ import annotations

import json
import socket
from dataclasses import dataclass

from oncilla_tpu_torch.analysis.lockwatch import make_lock
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


class ClusterView:
    """Mutable, epoch-stamped member table (elastic/).

    The reference parses its nodefile once into a fixed global table;
    post-boot membership changes required a nodefile rewrite and a full
    restart. ClusterView is the same table made LIVE: sequence-protocol
    compatible with the ``list[NodeEntry]`` every runtime component
    already indexes (``entries[rank]``, ``len(entries)``, iteration),
    plus epoch-stamped upserts driven by the JOIN/LEAVE protocol.
    ``parse_nodefile`` is now just the boot-time seed.

    Ranks are identity (registry chains, placement accounting, fencing
    verdicts all key on them), so a departed member keeps its slot —
    it is marked *left*, never compacted out. Thread-safe; iteration
    snapshots under the lock.

    The row storage is held BY REFERENCE, not copied: every in-process
    component handed the same ``list`` (the LocalCluster idiom — N
    daemons + clients sharing one table so rank 0's ephemeral-port
    update and JOIN appends are visible everywhere) keeps sharing it
    whether it wraps the list in its own view or indexes it raw. Views
    over the same list share rows but track epoch/left independently —
    each daemon adopts MEMBER_UPDATE for itself, exactly as separate
    processes would.
    """

    def __init__(self, entries: list[NodeEntry], epoch: int = 0):
        self._entries = entries if isinstance(entries, list) else list(entries)
        self._left: set[int] = set()
        self.epoch = epoch
        self._lock = make_lock("membership.ClusterView._lock")

    # -- sequence protocol (list[NodeEntry] drop-in) ---------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __getitem__(self, rank: int) -> NodeEntry:
        with self._lock:
            return self._entries[rank]

    def __setitem__(self, rank: int, entry: NodeEntry) -> None:
        with self._lock:
            self._entries[rank] = entry

    def __iter__(self):
        with self._lock:
            return iter(list(self._entries))

    # -- membership mutation (JOIN/LEAVE protocol) -----------------------

    def upsert(self, entry: NodeEntry, epoch: int | None = None) -> None:
        """Add or replace the member at ``entry.rank``; appending past
        the end pads with the entry itself (ranks stay contiguous — the
        protocol assigns the next rank, so padding never really fires)."""
        with self._lock:
            while len(self._entries) <= entry.rank:
                self._entries.append(entry)
            self._entries[entry.rank] = entry
            self._left.discard(entry.rank)
            if epoch is not None and epoch > self.epoch:
                self.epoch = epoch

    def mark_left(self, rank: int, epoch: int | None = None) -> None:
        with self._lock:
            if 0 <= rank < len(self._entries):
                self._left.add(rank)
            if epoch is not None and epoch > self.epoch:
                self.epoch = epoch

    def has_left(self, rank: int) -> bool:
        with self._lock:
            return rank in self._left

    def left_ranks(self) -> set[int]:
        with self._lock:
            return set(self._left)

    def alive_count(self) -> int:
        """Members not marked left (the ocm_cluster_members gauge)."""
        with self._lock:
            return len(self._entries) - len(self._left)

    def find(self, host: str, port: int) -> int | None:
        """Rank of the member announcing (host, port), left ones
        included — how REQ_JOIN dedups a retried/restarted joiner onto
        its original rank instead of leaking a fresh slot per attempt."""
        with self._lock:
            for e in self._entries:
                if e.connect_host == host and e.port == port:
                    return e.rank
        return None

    # -- wire form (JOIN_OK / MEMBER_UPDATE data tails) ------------------

    def to_wire(self) -> bytes:
        with self._lock:
            doc = {
                "epoch": self.epoch,
                "members": [
                    {"rank": e.rank, "host": e.host, "port": e.port,
                     "addr": e.addr}
                    for e in self._entries
                ],
                "left": sorted(self._left),
            }
        return json.dumps(doc, separators=(",", ":")).encode()

    def adopt(self, epoch: int, wire: bytes) -> bool:
        """Apply a MEMBER_UPDATE/JOIN_OK table. Epoch-fenced: a table
        older than what this view already holds is dropped (stale
        broadcast racing a newer one). Idempotent — rank-keyed upserts,
        so replays and shared-view double-adoption are harmless.
        Returns whether the table was applied."""
        try:
            doc = json.loads(bytes(wire))
            members = [
                NodeEntry(int(m["rank"]), m["host"], int(m["port"]),
                          m.get("addr"))
                for m in doc.get("members", [])
            ]
            left = {int(r) for r in doc.get("left", [])}
        except (ValueError, KeyError, TypeError) as e:
            raise OcmError(f"malformed member table: {e}") from None
        with self._lock:
            if epoch < self.epoch:
                return False
            for m in members:
                while len(self._entries) <= m.rank:
                    self._entries.append(m)
                if not m.port and self._entries[m.rank].port:
                    # A row without a port is a member the table's maker
                    # had not heard announce yet: it never replaces an
                    # address this view holds (a promoted standby's stale
                    # master state would cut the member off every
                    # broadcast).
                    continue
                self._entries[m.rank] = m
            self._left = left
            self.epoch = max(self.epoch, epoch)
        return True

    def snapshot(self) -> list[NodeEntry]:
        with self._lock:
            return list(self._entries)


def as_view(entries) -> "ClusterView":
    """Wrap a boot-time seed (nodefile parse, jax_membership) in a live
    view; an existing view passes through so in-process clusters can
    share ONE table (the LocalCluster idiom)."""
    return entries if isinstance(entries, ClusterView) else ClusterView(entries)



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


def torch_membership(base_port: int, hosts: list[str] | None = None
                     ) -> tuple[list[NodeEntry], int]:
    """Membership from ``torch.distributed``: one daemon a process, rank
    the process group's rank (the JAX package's ``jax_membership``, with
    ``jax.process_index`` its counterpart). The process group does not
    carry peer hostnames, so a job spread over hosts passes ``hosts`` or
    sets ``OCM_HOSTS`` to a comma-separated list ordered by rank (the
    nodefile's equivalent); a world of one, or no process group, is
    ``localhost``. Rank r's daemon listens on ``base_port + r``."""
    import os

    import torch.distributed as dist

    live = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if live else 1
    if hosts is None:
        env = os.environ.get("OCM_HOSTS")
        hosts = [h.strip() for h in env.split(",")] if env else None
    if hosts is None:
        if n > 1:
            raise OcmError(
                "multi-host membership needs hostnames: pass hosts= or set "
                "OCM_HOSTS=host0,host1,... ordered by the process group's rank"
            )
        hosts = ["localhost"]
    if len(hosts) != n:
        raise OcmError(f"got {len(hosts)} hosts for {n} processes")
    entries = [NodeEntry(rank=i, host=hosts[i], port=base_port + i)
               for i in range(n)]
    return entries, dist.get_rank() if live else 0
