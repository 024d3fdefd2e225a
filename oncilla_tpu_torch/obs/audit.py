"""The port's copy of ``oncilla_tpu/obs/audit.py``, line for line, with the
JAX package's ``python -m oncilla_tpu.obs audit`` subcommand as :func:`main`:
the cross-rank post-mortem auditor, the journals as a correctness oracle.
It reads the segments of either package's flight recorder and of the native
daemon's alike (one format).

The chaos smokes assert end-STATE byte-exactness; this module audits the
end-to-end event TIMELINE the flight recorder (:mod:`~.flightrec`)
persisted. Segments from every rank — dead ones included — are merged
cluster-wide (rank-tagged via each event's ``track``, wall-clock ordered
with a per-process (jid, seq) tiebreak, tolerant of clock skew because
every ORDER-sensitive check walks a single process's seq order, never
the cross-process wall clock) and a registry of invariant checks runs
over the result:

====================  ==================================================
rule                  violated when
====================  ==================================================
``segment-corrupt``   a segment frame fails its CRC (or decodes to
                      non-JSON / bad magic) — evidence tampering or disk
                      rot, reported never skipped
``journal-gap``       a process's spilled (jid, seq) stream has holes —
                      events were recorded but never reached the disk
``epoch-monotonic``   a daemon emits a cluster epoch lower than one it
                      already emitted (epochs only ever advance)
``migrate-pairing``   a ``migrate_start`` never reaches a terminal, or
                      reaches BOTH ``migrate_flip`` and
                      ``migrate_abort``, or a terminal has no start
``replica-ack``       a client DATA_PUT ack on a k>1 chain precedes its
                      replica fan-out (durability contract: a byte the
                      client saw acked is on every live replica)
``lease-chain``       an app renewed leases but the timeline never
                      terminates them (no disconnect / free / reclaim /
                      eviction for that app)
``eviction-priority`` a pressure eviction OR frozen-tier demotion fired
                      on an ACTIVE lease above the low priority class,
                      or a demoted-to-FROZEN alloc was reported
                      destroyed while still frozen
``fenced-silence``    a fenced daemon emitted a post-fence client ack or
                      replica fan-out (split-brain writes)
``leader-unique``     more than one rank claimed leadership under the
                      same cluster epoch (``leader_elect`` /
                      ``leader_handoff`` events) — the split brain the
                      epoch-fenced lease must make impossible
``placement-agreement`` a ``hash_place`` event's chain disagrees with
                      the rendezvous plan recomputed over its recorded
                      member set, or one alloc id was hash-placed twice
                      with different chains
====================  ==================================================

Findings follow the ``analysis``-family style: typed rule, rank, event
refs, nonzero process exit (``python -m oncilla_tpu_torch.obs.audit <dir>``).

Stdlib-only by the obs-package contract.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field

from oncilla_tpu_torch.obs import flightrec

# Events whose ``epoch`` field reports the emitting daemon's CURRENT
# epoch at record time. migrate_flip/migrate_abort deliberately carry
# the migration's BEGIN epoch (the fencing identity of that migration)
# and are excluded — they may lag a bump that landed mid-stream.
EPOCH_EVENTS = frozenset({
    "fenced", "member_join", "member_leave", "node_dead",
    "failover_promote", "rereplicate", "migrate_start",
    "leader_elect", "leader_fence", "leader_handoff",
})

# The low priority class (qos/policy.py PRIO_LOW); the reaper may evict
# ACTIVE leases of this class only. Mirrored here (not imported) to keep
# the module stdlib-only.
_PRIO_LOW = 0

_TRACK_RANK = re.compile(r"^daemon-r(\d+)$")


@dataclass(frozen=True)
class AuditFinding:
    """One invariant violation, in the analysis-family Finding style."""

    rule: str
    message: str
    rank: int = -1  # emitting daemon rank, -1 when not rank-specific
    events: tuple[str, ...] = ()  # "jid:seq" refs into the timeline

    def render(self) -> str:
        where = f" rank={self.rank}" if self.rank >= 0 else ""
        refs = f" (events: {', '.join(self.events)})" if self.events else ""
        return f"[{self.rule}]{where} {self.message}{refs}"


def _ref(e: dict) -> str:
    return f"{e.get('jid', '?')}:{e.get('seq', '?')}"


def _rank_of(e: dict) -> int:
    m = _TRACK_RANK.match(str(e.get("track", "")))
    return int(m.group(1)) if m else -1


def _order_key(e: dict):
    # Wall clock first (the only cross-process clock), then (jid, seq):
    # same-millisecond events from one process can never interleave out
    # of their true order, and skewed clocks only ever reorder ACROSS
    # processes — which no order-sensitive check relies on.
    return (e.get("ts", 0.0), str(e.get("jid", "")), e.get("seq", 0))


class Timeline:
    """A merged, ordered cluster timeline plus per-process streams."""

    def __init__(self, events: list[dict], problems: list[dict] | None = None,
                 source: str = ""):
        self.events = sorted(events, key=_order_key)
        self.problems = list(problems or ())
        self.source = source
        self.streams: dict[str, list[dict]] = defaultdict(list)
        for e in self.events:
            jid = e.get("jid")
            if jid is not None:
                self.streams[str(jid)].append(e)
        for evs in self.streams.values():
            evs.sort(key=lambda e: e.get("seq", 0))

    def stats(self) -> dict:
        ranks = sorted({r for e in self.events
                        if (r := _rank_of(e)) >= 0})
        return {
            "events": len(self.events),
            "processes": len(self.streams),
            "ranks": ranks,
            "kinds": len({e.get("ev") for e in self.events}),
            "truncated_segments": sum(
                1 for p in self.problems if p["kind"] == "truncated"
            ),
        }


# -- the invariant registry ---------------------------------------------

CHECKS: list[tuple[str, object]] = []


def invariant(rule: str):
    def deco(fn):
        CHECKS.append((rule, fn))
        return fn
    return deco


@invariant("segment-corrupt")
def _check_integrity(tl: Timeline) -> list[AuditFinding]:
    out = []
    for p in tl.problems:
        if p["kind"] in ("crc", "decode", "header"):
            out.append(AuditFinding(
                rule="segment-corrupt",
                message=f"{os.path.basename(p['path'])} @{p['offset']}: "
                        f"{p['detail']}",
            ))
    return out


@invariant("journal-gap")
def _check_continuity(tl: Timeline) -> list[AuditFinding]:
    out = []
    for jid, evs in tl.streams.items():
        seqs = sorted({e.get("seq", 0) for e in evs})
        if len(seqs) < 2:
            continue
        missing = (seqs[-1] - seqs[0] + 1) - len(seqs)
        if missing:
            out.append(AuditFinding(
                rule="journal-gap",
                message=f"process {jid}: {missing} event(s) missing from "
                        f"the spilled stream (seq {seqs[0]}..{seqs[-1]} "
                        f"holds {len(seqs)})",
            ))
    return out


@invariant("epoch-monotonic")
def _check_epochs(tl: Timeline) -> list[AuditFinding]:
    out = []
    # Per (process, daemon track): one daemon's own epoch never regresses.
    for jid, evs in tl.streams.items():
        high: dict[str, tuple[int, dict]] = {}
        for e in evs:
            if e.get("ev") not in EPOCH_EVENTS or "epoch" not in e:
                continue
            track = str(e.get("track", ""))
            if not _TRACK_RANK.match(track):
                continue
            epoch = int(e["epoch"])
            prev = high.get(track)
            if prev is not None and epoch < prev[0]:
                out.append(AuditFinding(
                    rule="epoch-monotonic",
                    rank=_rank_of(e),
                    message=f"epoch regressed {prev[0]} -> {epoch} "
                            f"({prev[1].get('ev')} then {e.get('ev')})",
                    events=(_ref(prev[1]), _ref(e)),
                ))
            if prev is None or epoch > prev[0]:
                high[track] = (epoch, e)
    return out


@invariant("migrate-pairing")
def _check_migrations(tl: Timeline) -> list[AuditFinding]:
    groups: dict[tuple, dict[str, list[dict]]] = defaultdict(
        lambda: {"start": [], "flip": [], "abort": []}
    )
    for e in tl.events:
        ev = e.get("ev")
        if ev in ("migrate_start", "migrate_flip", "migrate_abort"):
            key = (e.get("alloc_id"), e.get("src"), e.get("target"))
            groups[key][ev.split("_", 1)[1]].append(e)
    out = []
    for (alloc_id, src, target), g in sorted(
        groups.items(), key=lambda kv: str(kv[0])
    ):
        label = f"alloc {alloc_id} migration rank {src} -> {target}"
        refs = tuple(_ref(e) for v in g.values() for e in v)
        if not g["start"]:
            out.append(AuditFinding(
                rule="migrate-pairing", rank=src if src is not None else -1,
                message=f"{label}: terminal without a migrate_start",
                events=refs,
            ))
        elif g["flip"] and g["abort"]:
            out.append(AuditFinding(
                rule="migrate-pairing", rank=src if src is not None else -1,
                message=f"{label}: BOTH flipped and aborted (copies "
                        "may have forked)",
                events=refs,
            ))
        elif len(g["flip"]) > 1:
            out.append(AuditFinding(
                rule="migrate-pairing", rank=src if src is not None else -1,
                message=f"{label}: {len(g['flip'])} flips for "
                        f"{len(g['start'])} start(s)",
                events=refs,
            ))
        elif not g["flip"] and not g["abort"]:
            out.append(AuditFinding(
                rule="migrate-pairing", rank=src if src is not None else -1,
                message=f"{label}: migrate_start never reached "
                        "migrate_flip or migrate_abort",
                events=refs,
            ))
    return out


@invariant("replica-ack")
def _check_replica_acks(tl: Timeline) -> list[AuditFinding]:
    out = []
    for jid, evs in tl.streams.items():
        # Pending fan-outs per (daemon track, alloc, offset, nbytes):
        # within one process the seq order IS program order per thread,
        # and the serving thread records its fan-out strictly before its
        # ack.
        pending: dict[tuple, int] = defaultdict(int)
        for e in evs:
            ev = e.get("ev")
            if ev == "replica_fanout":
                key = (e.get("track"), e.get("alloc_id"),
                       e.get("offset"), e.get("nbytes"))
                pending[key] += 1
            elif ev == "put_ack" and e.get("chain", 0) > 1:
                key = (e.get("track"), e.get("alloc_id"),
                       e.get("offset"), e.get("nbytes"))
                if pending[key] <= 0:
                    out.append(AuditFinding(
                        rule="replica-ack", rank=_rank_of(e),
                        message=f"DATA_PUT ack for alloc "
                                f"{e.get('alloc_id')} "
                                f"[{e.get('offset')}+{e.get('nbytes')}] on "
                                f"a {e.get('chain')}-member chain precedes "
                                "its replica fan-out",
                        events=(_ref(e),),
                    ))
                else:
                    pending[key] -= 1
    return out


@invariant("lease-chain")
def _check_lease_chains(tl: Timeline) -> list[AuditFinding]:
    renewing: dict[object, dict] = {}
    terminated: set = set()
    for e in tl.events:
        ev = e.get("ev")
        if ev == "lease_renew":
            renewing.setdefault(e.get("app_pid"), e)
        elif ev in ("app_disconnect", "app_close"):
            # Daemon-side reclamation, or the app's own clean close —
            # DISCONNECT is fire-and-forget, so a stopping daemon may
            # legitimately never record the former (the lease reaper is
            # the runtime's backstop); the client-side event is the
            # deliberate-termination evidence either way.
            terminated.add(e.get("pid"))
        elif ev in ("lease_reclaim", "qos_evict", "free_local"):
            terminated.add(e.get("origin_pid"))
    out = []
    for pid, first in sorted(renewing.items(), key=lambda kv: str(kv[0])):
        if pid not in terminated:
            out.append(AuditFinding(
                rule="lease-chain",
                message=f"app {pid} renewed leases but the timeline has "
                        "no disconnect / free / reclaim / eviction for "
                        "it (leaked lease chain)",
                events=(_ref(first),),
            ))
    return out


@invariant("eviction-priority")
def _check_evictions(tl: Timeline) -> list[AuditFinding]:
    """Pressure victims obey the class invariant — and the FROZEN tier
    (persist/) never lies about destruction. ``qos_evict`` means the
    bytes are gone; ``tier_demote`` means they spilled to disk. Both
    legs run inside the same victim loop, so BOTH must respect the
    active-above-low prohibition; and an alloc the timeline shows as
    demoted-to-frozen must never be reported destroyed while it is
    still frozen (that qos_evict would be silent durable-data loss —
    a frozen entry holds no arena bytes and is not a legal victim).
    The frozen set is tracked per PROCESS stream (seq order is program
    order for one daemon); a ``tier_promote`` or ``free_local`` for
    the alloc lifts the prohibition."""
    out = []
    for e in tl.events:
        if (e.get("ev") in ("qos_evict", "tier_demote") and e.get("active")
                and int(e.get("priority", _PRIO_LOW)) > _PRIO_LOW):
            verb = ("eviction" if e.get("ev") == "qos_evict"
                    else "demotion to frozen")
            out.append(AuditFinding(
                rule="eviction-priority", rank=_rank_of(e),
                message=f"pressure {verb} fired on ACTIVE priority-"
                        f"{e.get('priority')} alloc {e.get('alloc_id')}",
                events=(_ref(e),),
            ))
    for jid, evs in tl.streams.items():
        frozen_at: dict[tuple, dict] = {}  # (track, alloc_id) -> demote ev
        for e in evs:
            ev = e.get("ev")
            if ev not in ("tier_demote", "tier_promote", "qos_evict",
                          "free_local"):
                continue
            key = (e.get("track"), e.get("alloc_id"))
            if ev == "tier_demote":
                frozen_at.setdefault(key, e)
            elif ev in ("tier_promote", "free_local"):
                frozen_at.pop(key, None)
            elif e.get("destroyed") and key in frozen_at:
                out.append(AuditFinding(
                    rule="eviction-priority", rank=_rank_of(e),
                    message=f"alloc {e.get('alloc_id')} reported "
                            "DESTROYED by qos_evict while demoted to the "
                            "frozen tier (durable payload silently lost)",
                    events=(_ref(frozen_at[key]), _ref(e)),
                ))
    return out


@invariant("fenced-silence")
def _check_fenced(tl: Timeline) -> list[AuditFinding]:
    out = []
    for jid, evs in tl.streams.items():
        fenced_at: dict[str, dict] = {}
        for e in evs:
            track = str(e.get("track", ""))
            ev = e.get("ev")
            if ev == "fenced" and _TRACK_RANK.match(track):
                fenced_at.setdefault(track, e)
            elif ev in ("put_ack", "replica_fanout") and track in fenced_at:
                out.append(AuditFinding(
                    rule="fenced-silence", rank=_rank_of(e),
                    message=f"{ev} for alloc {e.get('alloc_id')} emitted "
                            "AFTER this daemon was fenced (split-brain "
                            "write)",
                    events=(_ref(fenced_at[track]), _ref(e)),
                ))
    return out


@invariant("cancel-ack-order")
def _check_cancel_acks(tl: Timeline) -> list[AuditFinding]:
    """No ack after a binding cancel-ack (resilience/timebudget.py):
    once a daemon answered CANCEL with revoked=1 for a (conn, tag), the
    op's reply was promised suppressed — a later ``mux_reply`` for the
    same (track, conn, tag) means the client was told "revoked" and
    then acked anyway, the double-outcome the revocation lock exists to
    prevent. Walks single-process seq order only (the daemon records
    both events), so clock skew cannot forge a violation; client-side
    tag reuse within one connection would need 2^32 ops between the
    cancel and the reuse."""
    out = []
    for jid, evs in tl.streams.items():
        revoked_at: dict[tuple, dict] = {}
        for e in evs:
            ev = e.get("ev")
            if ev not in ("cancel_ack", "mux_reply"):
                continue
            key = (e.get("track"), e.get("conn"), e.get("tag"))
            if ev == "cancel_ack" and e.get("revoked"):
                revoked_at.setdefault(key, e)
            elif ev == "mux_reply" and key in revoked_at:
                out.append(AuditFinding(
                    rule="cancel-ack-order", rank=_rank_of(e),
                    message=f"tagged reply for conn {e.get('conn')} tag "
                            f"{e.get('tag')} sent AFTER its revoked "
                            "cancel-ack (double outcome)",
                    events=(_ref(revoked_at[key]), _ref(e)),
                ))
    return out


@invariant("leader-unique")
def _check_leader_unique(tl: Timeline) -> list[AuditFinding]:
    """At most one unfenced leader per epoch (control/): every
    leadership claim — an election win or a handoff adoption — bumps
    the epoch first, so two claims under ONE epoch mean two daemons
    each believed they held the lease simultaneously. Both ends of a
    handoff journal the same (target, epoch) pair; that is one claimant,
    not two."""
    claims: dict[int, dict[int, dict]] = defaultdict(dict)  # epoch->rank->ev
    for e in tl.events:
        ev = e.get("ev")
        if ev == "leader_elect":
            rank, epoch = e.get("rank"), e.get("epoch")
        elif ev == "leader_handoff":
            rank, epoch = e.get("target"), e.get("epoch")
        else:
            continue
        if rank is None or epoch is None:
            continue
        claims[int(epoch)].setdefault(int(rank), e)
    out = []
    for epoch, by_rank in sorted(claims.items()):
        if len(by_rank) > 1:
            out.append(AuditFinding(
                rule="leader-unique",
                message=f"epoch {epoch}: leadership claimed by ranks "
                        f"{sorted(by_rank)} — more than one unfenced "
                        "leader per epoch (split brain)",
                events=tuple(_ref(e) for _, e in sorted(by_rank.items())),
            ))
    return out


@invariant("placement-agreement")
def _check_placement_agreement(tl: Timeline) -> list[AuditFinding]:
    """Every rank that hash-placed an allocation agrees with the
    rendezvous plan: the ``hash_place`` event records the member set the
    placer used, and the plan is a pure function of (alloc_id, members,
    k) — so the auditor simply recomputes it. A second placement of the
    same id with a DIFFERENT chain is flagged too (two origins can never
    mint the same id, so a duplicate means a replayed or forged
    placement)."""
    # Local import: hashring is stdlib-only by contract, but audit must
    # stay importable even if the control package is absent/broken.
    try:
        from oncilla_tpu_torch.control import hashring
    except Exception:  # noqa: BLE001 — no hash placements to verify then
        hashring = None
    out = []
    seen: dict[object, tuple] = {}
    for e in tl.events:
        if e.get("ev") != "hash_place":
            continue
        aid = e.get("alloc_id")
        chain = tuple(int(r) for r in e.get("chain") or ())
        live = [int(r) for r in e.get("live") or ()]
        k = int(e.get("k", len(chain) or 1))
        if hashring is not None and live:
            want = hashring.plan(int(aid), live, k)
            if want != chain:
                out.append(AuditFinding(
                    rule="placement-agreement", rank=_rank_of(e),
                    message=f"alloc {aid}: placed chain {list(chain)} "
                            f"disagrees with the rendezvous plan "
                            f"{list(want)} over members {live} (k={k})",
                    events=(_ref(e),),
                ))
        prev = seen.get(aid)
        if prev is not None and prev[0] != chain:
            out.append(AuditFinding(
                rule="placement-agreement", rank=_rank_of(e),
                message=f"alloc {aid}: hash-placed twice with different "
                        f"chains {list(prev[0])} vs {list(chain)}",
                events=(prev[1], _ref(e)),
            ))
        else:
            seen.setdefault(aid, (chain, _ref(e)))
    return out


# -- entry points --------------------------------------------------------


def audit_events(events: list[dict], problems: list[dict] | None = None,
                 source: str = "") -> tuple[list[AuditFinding], dict]:
    tl = Timeline(events, problems, source=source)
    findings: list[AuditFinding] = []
    for _rule, fn in CHECKS:
        findings.extend(fn(tl))
    return findings, tl.stats()


def audit_dir(path: str) -> tuple[list[AuditFinding], dict]:
    """Audit ONE timeline directory (segments directly inside it)."""
    events, problems = flightrec.read_dir(path)
    return audit_events(events, problems, source=path)


def audit_tree(path: str) -> list[tuple[str, list[AuditFinding], dict]]:
    """Audit every timeline under ``path`` independently. Sibling
    recordings (a smoke's run 1 vs its replay) must never be conflated:
    their alloc-id and epoch spaces restart per cluster, so each leaf
    directory of segments is its own oracle."""
    return [(d, *audit_dir(d)) for d in flightrec.timeline_dirs(path)]


@dataclass
class RecordedRun:
    """Handle yielded by :func:`recorded`; filled in on clean exit."""

    path: str
    findings: list[AuditFinding] = field(default_factory=list)
    stats: dict = field(default_factory=dict)

    def summary(self) -> str:
        st = self.stats or {}
        return (f"audited {st.get('events', 0)} events from "
                f"{st.get('processes', 0)} process(es), ranks "
                f"{st.get('ranks', [])}: "
                + (f"{len(self.findings)} finding(s)" if self.findings
                   else "clean"))


@contextmanager
def recorded(label: str, *, strict: bool = True):
    """Run a block under the flight recorder, then audit its timeline::

        with audit.recorded("resilience-run1") as rec:
            run_scenario(seed)
        print(rec.summary())          # findings raise by default

    Spills into ``$OCM_FLIGHTREC/<label>`` (or a temp dir), audits on
    clean exit, and — when ``strict`` — raises ``AssertionError``
    listing every finding. The black box is always left on disk; on any
    failure its path is in the exception message.
    """
    base = os.environ.get(flightrec.ENV_DIR)
    path = os.path.join(base, label) if base else None
    rec = RecordedRun(path="")
    with flightrec.recording(path) as d:
        rec.path = d
        yield rec
    rec.findings, rec.stats = audit_dir(rec.path)
    if strict and rec.findings:
        lines = "\n".join(f.render() for f in rec.findings)
        raise AssertionError(
            f"invariant audit of {rec.path} found "
            f"{len(rec.findings)} violation(s):\n{lines}"
        )


# -- the CLI -------------------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    """``python -m oncilla_tpu_torch.obs.audit <dir>`` — merge the flight
    recorder's segments and run every invariant check. Sibling
    recording subdirectories are audited as independent timelines.
    Exits 1 on findings, 2 when ``dir`` holds no segments."""
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(
        prog="python -m oncilla_tpu_torch.obs.audit",
        description="cross-rank invariant audit of flight-recorder "
                    "segments",
    )
    ap.add_argument("dir", help="flight-recorder directory "
                                "(what OCM_FLIGHTREC pointed at)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable findings on stdout")
    args = ap.parse_args(argv)
    if not os.path.isdir(args.dir):
        print(f"audit: {args.dir} is not a directory", file=sys.stderr)
        return 2
    results = audit_tree(args.dir)
    if not results:
        print(f"audit: no flight-recorder segments under {args.dir}",
              file=sys.stderr)
        return 2
    total = 0
    if args.as_json:
        json.dump(
            [
                {"timeline": d, "stats": stats,
                 "findings": [f.__dict__ for f in findings]}
                for d, findings, stats in results
            ],
            sys.stdout, indent=2, default=str,
        )
        print()
    for d, findings, stats in results:
        total += len(findings)
        if args.as_json:
            continue
        for f in findings:
            print(f"{d}: {f.render()}")
        print(f"audit: {d}: {stats['events']} events, "
              f"{stats['processes']} process(es), ranks {stats['ranks']}, "
              f"{stats['truncated_segments']} torn tail(s) -> "
              + (f"{len(findings)} finding(s)" if findings else "clean"))
    if not args.as_json:
        nruns = len(results)
        if total:
            print(f"audit: {total} finding(s) across {nruns} timeline(s)")
        else:
            print(f"audit: clean ({nruns} timeline(s), "
                  f"{len(CHECKS)} invariant(s))")
    return 1 if total else 0


if __name__ == "__main__":
    sys.exit(main())
