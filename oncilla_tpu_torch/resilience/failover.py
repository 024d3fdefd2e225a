"""Rank-0 failover coordination: fence, promote, re-replicate.

When the master's failure detector reaches a DEAD verdict for a rank,
the coordinator runs the FaRM-shaped recovery sequence:

1. **Fence** — bump the cluster epoch and broadcast EPOCH_UPDATE (with
   the dead daemon's incarnation) to every rank, including a best-effort
   send to the dead one: a merely-partitioned owner that receives its
   own verdict fences itself and answers STALE_EPOCH to all further
   writes, so a stale primary can never serve split-brain writes after
   its replicas were promoted.
2. **Promote** — every survivor reconciles the dead set against its
   replica chains (registry.reconcile_dead): the first alive member of
   each chain becomes primary, deterministically and locally. PROMOTE
   replies report the allocations that now hold fewer copies than built.
3. **Re-replicate** — a background thread walks that repair list, sites
   a fresh replica rank via the placement policy (excluding the
   surviving chain and the dead set) and drives RE_REPLICATE on each new
   primary, which provisions the extent (DO_REPLICA) and streams the
   bytes (DATA_PUT) — restoring k without client involvement.

Every step is journaled (obs/journal) and counted (daemon.res_counters →
Prometheus), and the whole sequence is idempotent per dead rank.
"""

from __future__ import annotations

import json
import threading

from oncilla_tpu_torch.analysis.lockwatch import make_lock
from oncilla_tpu_torch.core.errors import OcmError, OcmPlacementError
from oncilla_tpu_torch.core.kinds import OcmKind
from oncilla_tpu_torch.obs import journal as obs_journal
from oncilla_tpu_torch.runtime.protocol import Message, MsgType
from oncilla_tpu_torch.utils.debug import printd


class FailoverCoordinator:
    """Owned by the rank-0 daemon; ``node_dead`` is its only entry point
    (called from the reaper/serve threads when the detector escalates)."""

    def __init__(self, daemon):
        self.d = daemon
        self._lock = make_lock("resilience.failover._lock")
        self._handled: set[int] = set()

    def node_dead(self, dead_rank: int) -> None:
        d = self.d
        with self._lock:
            if dead_rank in self._handled:
                return
            self._handled.add(dead_rank)
        epoch = d.bump_epoch()
        d.res_counters["deaths"] += 1
        inc = d.detector.incarnation(dead_rank) if d.detector else 0
        obs_journal.record(
            "node_dead", track=d.tracer.track,
            dead_rank=dead_rank, epoch=epoch,
        )
        printd("failover: rank %d declared DEAD at epoch %d",
               dead_rank, epoch)
        d.policy.mark_dead(dead_rank)
        if d.detector is not None:
            d.detector.mark_dead(dead_rank)
        de = d.entries[dead_rank]
        d.peers.evict(de.connect_host, de.port)

        # 1. Fence: every rank (the dead one included, best-effort) learns
        # the epoch bump before any promotion happens.
        upd = Message(
            MsgType.EPOCH_UPDATE,
            {"epoch": epoch, "dead_rank": dead_rank, "inc": inc},
        )
        for r, e in enumerate(d.entries):
            if r == d.rank:
                continue
            try:
                d.peers.request(e.connect_host, e.port, upd)
            except (OSError, OcmError):
                # The dead rank (and any unreachable peer) misses the
                # broadcast; epoch gossip on the PING path is the backstop.
                printd("failover: EPOCH_UPDATE to rank %d failed", r)

        # 2. Promote: master reconciles locally, then asks each survivor.
        dead = d.detector.dead_ranks() if d.detector else {dead_rank}
        dead.add(dead_rank)
        repair: list[dict] = []
        # Quarantined inbound migration copies from the dead rank are
        # dropped BEFORE reconciliation (elastic/): a half-streamed copy
        # must never be promoted into a chain.
        d._abort_migrations(dead, epoch)
        promoted, items = d.registry.reconcile_dead(dead, d.rank, epoch)
        d.res_counters["promotions"] += len(promoted)
        for e in promoted:
            obs_journal.record(
                "failover_promote", track=d.tracer.track,
                alloc_id=e.alloc_id, chain=list(e.chain), epoch=epoch,
            )
        repair.extend(items)
        req = Message(
            MsgType.PROMOTE,
            {"dead_ranks": ",".join(str(r) for r in sorted(dead)),
             "epoch": epoch},
        )
        for r, e in enumerate(d.entries):
            if r == d.rank or r in dead:
                continue
            try:
                reply = d.peers.request(e.connect_host, e.port, req)
            except (OSError, OcmError):
                printd("failover: PROMOTE to rank %d failed", r)
                continue
            if reply.data:
                try:
                    repair.extend(json.loads(bytes(reply.data)))
                except ValueError:
                    printd("failover: bad PROMOTE_OK tail from rank %d", r)

        # 3. Re-replicate in the background: data copies must not block
        # the verdict path (the reaper/serve thread that got us here).
        if repair:
            t = threading.Thread(
                target=self._re_replicate, args=(repair, dead, epoch),
                daemon=True, name=f"ocm-rerepl-e{epoch}",
            )
            t.start()

    def _re_replicate(self, repair: list[dict], dead: set[int],
                      epoch: int) -> None:
        d = self.d
        for it in repair:
            missing = it["want"] - len(it["chain"])
            for _ in range(max(0, missing)):
                kind = OcmKind(it["kind"])
                try:
                    placed = d.policy.place(
                        it["origin_rank"], kind, it["nbytes"],
                        exclude=tuple(set(it["chain"]) | dead),
                    )
                except OcmPlacementError as e:
                    obs_journal.record(
                        "rereplicate_skip", track=d.tracer.track,
                        alloc_id=it["alloc_id"], reason=str(e),
                    )
                    break
                target = placed.rank
                primary = it["chain"][0]
                msg = Message(
                    MsgType.RE_REPLICATE,
                    {"alloc_id": it["alloc_id"], "target_rank": target,
                     "epoch": epoch},
                )
                try:
                    if primary == d.rank:
                        d._on_re_replicate(msg)
                    else:
                        pe = d.entries[primary]
                        d.peers.request(pe.connect_host, pe.port, msg)
                except (OSError, OcmError) as e:
                    obs_journal.record(
                        "rereplicate_fail", track=d.tracer.track,
                        alloc_id=it["alloc_id"], target=target, error=str(e),
                    )
                    printd("failover: re-replicate alloc %d -> rank %d "
                           "failed: %s", it["alloc_id"], target, e)
                    continue
                it["chain"].append(target)
                d.policy.note_alloc(placed, it["nbytes"])
                d.res_counters["rereplications"] += 1
                obs_journal.record(
                    "rereplicate", track=d.tracer.track,
                    alloc_id=it["alloc_id"], target=target, epoch=epoch,
                )
