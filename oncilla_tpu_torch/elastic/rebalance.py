"""Rank-0 rebalancer: capacity-weighted target placement + live moves.

Owned by the rank-0 daemon (the FailoverCoordinator pattern): gathers
per-member host-kind inventories (REQ_EXTENTS), computes the
capacity-weighted target share for every alive member, and drives
MIGRATE legs at the source primaries until loads sit within tolerance —
or, in drain mode (REQ_LEAVE), until the leaver holds nothing at all.
Placement accounting moves atomically for both ends of each successful
migration HERE (note_free source / note_alloc target), never in the
migration state machine itself, so an aborted move leaves the books
exactly where they were.

Everything is deterministic for the chaos harness: members walk in rank
order, extents in (size desc, alloc_id) order for planning and plain
alloc_id order for drains — two runs over the same cluster state plan
the identical move list.
"""

from __future__ import annotations

import json
import time

from oncilla_tpu_torch.analysis.lockwatch import make_lock
from oncilla_tpu_torch.core.errors import OcmError, OcmPlacementError
from oncilla_tpu_torch.core.kinds import OcmKind
from oncilla_tpu_torch.obs import journal as obs_journal
from oncilla_tpu_torch.runtime.placement import Placement
from oncilla_tpu_torch.runtime.protocol import (
    WIRE_KIND_INV,
    Message,
    MsgType,
)
from oncilla_tpu_torch.utils.debug import printd

# A member is "balanced enough" when its primary-byte load sits within
# this fraction of the cluster total from its capacity-weighted target;
# moving extents below that just churns data for no headroom.
TOLERANCE = 0.10


class Rebalancer:
    """Rank-0 daemon component; thread-safe (one rebalance at a time)."""

    def __init__(self, daemon):
        self.d = daemon
        self._lock = make_lock("elastic.rebalance._lock")

    # -- inventory -------------------------------------------------------

    def _inventory(self, rank: int) -> list[dict]:
        d = self.d
        if rank == d.rank:
            return d._extent_rows()
        e = d.entries[rank]
        r = d.peers.request(
            e.connect_host, e.port, Message(MsgType.REQ_EXTENTS, {})
        )
        return json.loads(bytes(r.data)) if r.data else []

    def _alive_ranks(self) -> list[int]:
        d = self.d
        return sorted(
            r for r in d.policy.host_capacities()
            if not d.entries.has_left(r)
            and not d._believed_dead(r)
            and d.entries[r].port
        )

    # -- one move --------------------------------------------------------

    def migrate(self, row: dict, src: int, dst: int) -> bool:
        """Drive one MIGRATE at the source primary; on success move the
        placement accounting and record the relocation for REQ_LOCATE."""
        d = self.d
        msg = Message(
            MsgType.MIGRATE,
            {"alloc_id": row["id"], "target_rank": dst, "epoch": d.epoch},
        )
        try:
            if src == d.rank:
                r = d._on_migrate(msg)
                if r.type == MsgType.ERROR:
                    raise OcmError(r.fields["detail"])
            else:
                e = d.entries[src]
                d.peers.request(e.connect_host, e.port, msg)
        except (OSError, OcmError) as exc:
            obs_journal.record(
                "rebalance_migrate_fail", track=d.tracer.track,
                alloc_id=row["id"], src=src, dst=dst,
                error=f"{type(exc).__name__}: {exc}",
            )
            printd("rebalance: migrate %d (%d -> %d) failed: %s",
                   row["id"], src, dst, exc)
            return False
        kind = OcmKind(WIRE_KIND_INV[row["kind"]])
        d.policy.note_free(
            Placement(rank=src, device_index=0, kind=kind), row["nbytes"]
        )
        d.policy.note_alloc(
            Placement(rank=dst, device_index=0, kind=kind), row["nbytes"]
        )
        d._note_moved(
            row["id"], dst, row["origin_pid"], row["origin_rank"]
        )
        return True

    # -- capacity-weighted rebalance -------------------------------------

    def plan(
        self,
        inventories: dict[int, list[dict]],
        capacities: dict[int, int],
        tolerance: float = TOLERANCE,
    ) -> list[tuple[dict, int, int]]:
        """Greedy capacity-weighted move list: while some member carries
        more primary bytes than its capacity share (past tolerance) and
        another carries less, move the largest movable extent that fits
        the deficit. Pure and deterministic — unit-testable without a
        cluster."""
        ranks = sorted(set(inventories) & set(capacities))
        if len(ranks) < 2:
            return []
        load = {
            r: sum(x["nbytes"] for x in inventories[r] if x["primary"])
            for r in ranks
        }
        total = sum(load.values())
        capsum = sum(capacities[r] for r in ranks)
        if total == 0 or capsum == 0:
            return []
        target = {r: total * capacities[r] / capsum for r in ranks}
        slack = tolerance * total
        movable = {
            r: sorted(
                (
                    x for x in inventories[r]
                    if x["primary"] and not x.get("migrating")
                ),
                key=lambda x: (-x["nbytes"], x["id"]),
            )
            for r in ranks
        }
        moves: list[tuple[dict, int, int]] = []
        for _ in range(4096):  # planner backstop, never a real bound
            over = max(ranks, key=lambda r: (load[r] - target[r], r))
            under = min(ranks, key=lambda r: (load[r] - target[r], r))
            if load[over] - target[over] <= slack or over == under:
                break
            deficit = target[under] - load[under]
            pick = None
            for x in movable[over]:
                if x["nbytes"] <= deficit + slack and under not in x["chain"]:
                    pick = x
                    break
            if pick is None:
                break  # nothing fits without overshooting the receiver
            movable[over].remove(pick)
            moves.append((pick, over, under))
            load[over] -= pick["nbytes"]
            load[under] += pick["nbytes"]
        return moves

    def rebalance(self) -> dict:
        """One full round: inventories over the live view, plan, move.
        Per-move failures are journaled and skipped — the next round
        (or the chaos-aborted migration's own cleanup) picks them up."""
        d = self.d
        # _lock is held across every dial below on purpose: its ONLY job
        # is "one rebalance/drain at a time" — the critical section IS
        # the whole round, because interleaved rounds would double-move
        # the same extents and corrupt the placement books. It is a leaf
        # lock private to the rank-0 coordinator; none of the handlers
        # the legs reach (REQ_EXTENTS, MIGRATE, RE_REPLICATE,
        # DO_REPLICA, DO_FREE) acquire it, so the rpc:daemon order edge
        # is one-way. OCM_WAITWATCH=1 verifies the dynamic graph.
        with self._lock:
            capacities = {
                r: c for r, c in d.policy.host_capacities().items()
                if r in set(self._alive_ranks())
            }
            inventories: dict[int, list[dict]] = {}
            for r in sorted(capacities):
                try:
                    inventories[r] = self._inventory(r)  # ocm-lint: allow[lock-across-rpc]
                except (OSError, OcmError) as exc:
                    printd("rebalance: inventory of rank %d failed: %s",
                           r, exc)
                    capacities.pop(r, None)
            moves = self.plan(inventories, capacities)
            done = 0
            for row, src, dst in moves:
                if self.migrate(row, src, dst):  # ocm-lint: allow[lock-across-rpc]
                    done += 1
            obs_journal.record(
                "rebalance_round", track=d.tracer.track,
                planned=len(moves), moved=done,
                ranks=sorted(capacities),
            )
            printd("rebalance: %d/%d planned moves completed",
                   done, len(moves))
            return {"planned": len(moves), "moved": done}

    def rebalance_safe(self, settle_s: float = 0.0) -> None:
        """Background-thread entry (post-JOIN auto-rebalance): wait a
        beat for the joiner to start serving, then rebalance; never let
        an exception out of the thread."""
        try:
            if settle_s:
                time.sleep(settle_s)
            self.rebalance()
        except Exception as exc:  # noqa: BLE001 — a failed auto-round is
            # journaled, never fatal; the operator can re-drive it
            printd("rebalance: background round failed: %s", exc)

    # -- LEAVE drain -----------------------------------------------------

    def drain(self, rank: int) -> tuple[int, int]:
        """Move EVERYTHING off ``rank`` (the REQ_LEAVE path): primaries
        migrate to capacity-chosen targets; replica copies are re-homed
        (grow the chain elsewhere via RE_REPLICATE, shrink it past the
        leaver, free the leaver's copy). Returns (moved, remaining) —
        a non-zero remainder means the leave must be refused."""
        # Same serialization story as rebalance(): a drain interleaved
        # with a rebalance round would move extents out from under the
        # other's plan; the leaf _lock spans the dials by design (see
        # the justification there).
        with self._lock:
            rows = self._inventory(rank)  # ocm-lint: allow[lock-across-rpc]
            moved = 0
            for row in sorted(rows, key=lambda x: x["id"]):
                ok = (
                    self._drain_primary(row, rank)  # ocm-lint: allow[lock-across-rpc]
                    if row["primary"]
                    else self._rehome_replica(row, rank)  # ocm-lint: allow[lock-across-rpc]
                )
                if ok:
                    moved += 1
            remaining = len(self._inventory(rank))  # ocm-lint: allow[lock-across-rpc]
            return moved, remaining

    def _drain_primary(self, row: dict, leaver: int) -> bool:
        d = self.d
        kind = OcmKind(WIRE_KIND_INV[row["kind"]])
        try:
            placed = d.policy.place(
                row["origin_rank"], kind, row["nbytes"],
                exclude=tuple(set(row["chain"]) | {leaver}),
            )
        except OcmPlacementError as exc:
            obs_journal.record(
                "drain_skip", track=d.tracer.track,
                alloc_id=row["id"], rank=leaver, reason=str(exc),
            )
            return False
        return self.migrate(row, leaver, placed.rank)

    def _rehome_replica(self, row: dict, leaver: int) -> bool:
        """A replica copy on the leaver: restore k on a fresh rank via
        the primary's RE_REPLICATE, push the leaver-less chain to every
        surviving holder, then free the leaver's copy. A cluster too
        small for a fresh rank shrinks the chain instead (degraded,
        journaled) — the same policy as replica provisioning."""
        d = self.d
        chain = [int(c) for c in row["chain"]]
        if not chain or leaver not in chain:
            return False
        primary = chain[0]
        kind = OcmKind(WIRE_KIND_INV[row["kind"]])
        grown = list(chain)
        try:
            placed = d.policy.place(
                row["origin_rank"], kind, row["nbytes"],
                exclude=tuple(set(chain)),
            )
            target = placed.rank
        except OcmPlacementError:
            placed = target = None
        if target is not None:
            rr = Message(
                MsgType.RE_REPLICATE,
                {"alloc_id": row["id"], "target_rank": target,
                 "epoch": d.epoch},
            )
            try:
                if primary == d.rank:
                    d._on_re_replicate(rr)
                else:
                    pe = d.entries[primary]
                    d.peers.request(pe.connect_host, pe.port, rr)
                grown.append(target)
                d.policy.note_alloc(
                    Placement(rank=target, device_index=0, kind=kind),
                    row["nbytes"],
                )
            except (OSError, OcmError) as exc:
                obs_journal.record(
                    "drain_rehome_degraded", track=d.tracer.track,
                    alloc_id=row["id"], rank=leaver, error=str(exc),
                )
        new_chain = [c for c in grown if c != leaver]
        upsert = {
            "alloc_id": row["id"],
            "kind": row["kind"],
            "nbytes": row["nbytes"],
            "orig_rank": row["origin_rank"],
            "pid": row["origin_pid"],
            "chain": ",".join(str(c) for c in new_chain),
            "epoch": d.epoch,
        }
        for c in new_chain:
            m = Message(MsgType.DO_REPLICA, dict(upsert))
            try:
                if c == d.rank:
                    d._on_do_replica(m)
                else:
                    ce = d.entries[c]
                    d.peers.request(ce.connect_host, ce.port, m)
            except (OSError, OcmError):
                printd("drain: chain shrink push to rank %d failed", c)
        le = d.entries[leaver]
        try:
            d.peers.request(
                le.connect_host, le.port,
                Message(MsgType.DO_FREE, {"alloc_id": row["id"]}),
            )
        except (OSError, OcmError) as exc:
            obs_journal.record(
                "drain_free_fail", track=d.tracer.track,
                alloc_id=row["id"], rank=leaver, error=str(exc),
            )
            return False
        return True
