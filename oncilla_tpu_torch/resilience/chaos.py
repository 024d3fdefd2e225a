"""The port's copy of ``oncilla_tpu/resilience/chaos.py``, line for line:
deterministic fault injection for the control/data planes, at the port's
connection-pool seam (``runtime/pool.set_chaos_hook``) and into the port's
journal.

Faults are injected at the connection-pool seam (``pool.set_chaos_hook``
fires once per lease, covering every client stripe, daemon relay, and
fan-out leg in the process) and are keyed by LOGICAL op index — the Nth
lease observed process-wide — not by wall-clock time. That is what makes
replay exact: two runs of the same workload with the same seed fire the
same faults at the same op indices, regardless of scheduler jitter, and
the controller's ``log`` (the fired (op, action, rank) triples) compares
equal across runs.

Fault vocabulary:

- ``kill``    — hard-kill a daemon (no snapshot, no drain): the crashed
                owner the failover machinery exists for.
- ``drop``    — the triggering lease raises OSError (a torn connection).
- ``delay``   — the triggering lease sleeps a schedule-fixed duration.
- ``partition``/``heal`` — from this op on, every lease toward the
                target rank raises (one-way partition at the seam).
- ``corrupt_snapshot`` — flip one byte of the target rank's snapshot
                file (exercises the CRC refusal path on restart).
- ``isolate``/``heal_isolate`` — FULL host partition of one daemon
                (control/ split-brain scenarios): fired through the
                harness-bound ``isolate_fn(rank, on)``, which flips
                ``Daemon.set_partitioned`` — inbound connections drop
                mid-frame, outbound pool leases refuse, probes fail —
                so a live-but-unreachable leader keeps believing it
                leads until the heal lets the fence reach it. Unlike
                ``partition`` (one-way, at the pool seam only), this
                models the whole host vanishing from the network.
- ``restart`` — hard-kill a daemon AND relaunch it at the same address
                as a fresh incarnation (persist/ warm-boot scenarios):
                no snapshot is written, so only the frozen tier's
                manifest survives. Fired through the harness-bound
                ``restart_fn(rank)``; the victim's journal ring is
                spilled first, exactly like ``kill``.
- ``join``/``leave``/``migrate`` — elastic-membership fault points
                (elastic/): fire the harness-bound ``join_fn`` /
                ``leave_fn(rank)`` / ``migrate_fn`` at a deterministic
                op index, so a JOIN can land mid-workload, a LEAVE can
                race live puts, and a migration can start exactly N
                leases before the kill that aborts it. The callables
                run inline on the leasing thread (that is what keys
                them deterministically) and must not require the lease
                that triggered them.

Faults that need cluster knowledge (kill, partition's rank→port mapping,
snapshot paths) resolve through the membership ``entries`` list and an
optional ``kill_fn``/``snapshot_paths`` binding, so the same schedule
drives an in-process ``local_cluster`` or a subprocess harness.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass

from oncilla_tpu_torch.analysis.lockwatch import make_lock
from oncilla_tpu_torch.obs import journal as obs_journal
from oncilla_tpu_torch.runtime import pool as _pool

ACTIONS = ("kill", "drop", "delay", "partition", "heal", "corrupt_snapshot",
           "join", "leave", "migrate", "isolate", "heal_isolate", "restart")


@dataclass(frozen=True)
class Fault:
    """One scheduled fault: fire when the process-wide lease counter
    reaches ``op``. ``rank`` targets kill/partition/heal/corrupt_snapshot
    (-1 for destination-agnostic drop/delay)."""

    op: int
    action: str
    rank: int = -1
    delay_s: float = 0.0

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(f"unknown chaos action {self.action!r}")


@dataclass(frozen=True)
class ChaosSchedule:
    seed: int
    faults: tuple[Fault, ...] = ()

    @classmethod
    def generate(
        cls,
        seed: int,
        nranks: int,
        nfaults: int = 4,
        span: int = 64,
        actions: tuple[str, ...] = ("drop", "delay"),
        protect: tuple[int, ...] = (0,),
    ) -> "ChaosSchedule":
        """A reproducible random schedule: ``nfaults`` faults at distinct
        op indices in [2, span], actions drawn from ``actions``, target
        ranks drawn outside ``protect`` (rank 0 — the arbiter — by
        default). Same seed, same schedule, always."""
        rng = random.Random(seed)
        eligible = [r for r in range(nranks) if r not in protect] or [0]
        ops = rng.sample(range(2, max(span, nfaults + 2)), nfaults)
        faults = []
        for op in sorted(ops):
            action = rng.choice(actions)
            faults.append(Fault(
                op=op,
                action=action,
                rank=rng.choice(eligible) if action != "drop" else -1,
                delay_s=round(rng.uniform(0.001, 0.01), 6)
                if action == "delay" else 0.0,
            ))
        return cls(seed=seed, faults=tuple(faults))

    @classmethod
    def kill_at(cls, seed: int, rank: int, op: int,
                extra: tuple[Fault, ...] = ()) -> "ChaosSchedule":
        """The smoke scenario's schedule: kill ``rank`` at op ``op``,
        plus any extra faults."""
        faults = tuple(sorted((Fault(op=op, action="kill", rank=rank),
                               *extra), key=lambda f: f.op))
        return cls(seed=seed, faults=faults)


class ChaosController:
    """Executes a :class:`ChaosSchedule` at the pool seam. Install with
    the ``inject()`` context manager; read ``log`` afterwards for the
    replay-identity assertion."""

    def __init__(self, schedule: ChaosSchedule, entries,
                 kill_fn=None, snapshot_paths: dict[int, str] | None = None,
                 join_fn=None, leave_fn=None, migrate_fn=None,
                 isolate_fn=None, restart_fn=None):
        self.schedule = schedule
        self.entries = entries  # live membership list (ports resolve late)
        self.kill_fn = kill_fn
        self.isolate_fn = isolate_fn
        self.restart_fn = restart_fn
        self.snapshot_paths = snapshot_paths or {}
        # Elastic-membership fault points (elastic/): bound by the
        # harness; a schedule naming them without a binding is a no-op
        # fault (still logged, so replay identity holds either way).
        self.join_fn = join_fn
        self.leave_fn = leave_fn
        self.migrate_fn = migrate_fn
        self.log: list[tuple[int, str, int]] = []
        # Kill-time journal snapshots (rank -> event list): the victim's
        # evidence captured BEFORE the kill tears it down, also spilled
        # to the flight recorder when one is armed. Post-mortem tests
        # and the auditor read these even for ranks that died.
        self.victim_rings: dict[int, list[dict]] = {}
        self._by_op: dict[int, list[Fault]] = {}
        for f in schedule.faults:
            self._by_op.setdefault(f.op, []).append(f)
        self._count = 0
        self._blocked: set[int] = set()
        self._lock = make_lock("resilience.chaos._lock")

    # -- the pool hook ---------------------------------------------------

    def _rank_of(self, host: str, port: int) -> int:
        for e in self.entries:
            if e.port == port and e.connect_host == host:
                return e.rank
        return -1

    def __call__(self, host: str, port: int) -> None:
        dest = self._rank_of(host, port)
        with self._lock:
            self._count += 1
            n = self._count
            fired = self._by_op.pop(n, [])
            for f in fired:
                self.log.append((n, f.action, f.rank))
                if f.action == "partition":
                    self._blocked.add(f.rank)
                elif f.action == "heal":
                    self._blocked.discard(f.rank)
            blocked = dest in self._blocked
        drop = False
        for f in fired:
            obs_journal.record(
                "chaos_fault", op=n, action=f.action, rank=f.rank
            )
            if f.action == "kill":
                # Snapshot the victim's ring AT kill time (and spill it
                # when the flight recorder is armed): the kill is the
                # one fault that used to destroy its own evidence.
                self.victim_rings[f.rank] = obs_journal.events()
                obs_journal.spill_ring(label=f"chaos-kill-r{f.rank}")
                if self.kill_fn is not None:
                    self.kill_fn(f.rank)
            elif f.action == "restart":
                # Kill-then-relaunch at the same address: the outgoing
                # incarnation's evidence spills like a kill's, then the
                # harness brings a fresh incarnation up (frozen-tier
                # warm boot; no snapshot was written).
                self.victim_rings[f.rank] = obs_journal.events()
                obs_journal.spill_ring(label=f"chaos-restart-r{f.rank}")
                if self.restart_fn is not None:
                    self.restart_fn(f.rank)
            elif f.action == "delay":
                time.sleep(f.delay_s)
            elif f.action == "drop":
                drop = True
            elif f.action == "corrupt_snapshot":
                path = self.snapshot_paths.get(f.rank)
                if path:
                    corrupt_file(path, seed=self.schedule.seed)
            elif f.action == "join":
                if self.join_fn is not None:
                    self.join_fn()
            elif f.action == "leave":
                if self.leave_fn is not None:
                    self.leave_fn(f.rank)
            elif f.action == "migrate":
                if self.migrate_fn is not None:
                    self.migrate_fn()
            elif f.action == "isolate":
                if self.isolate_fn is not None:
                    self.isolate_fn(f.rank, True)
            elif f.action == "heal_isolate":
                if self.isolate_fn is not None:
                    self.isolate_fn(f.rank, False)
        if drop:
            raise OSError(f"chaos: dropped lease to {host}:{port} (op {n})")
        if blocked:
            raise OSError(
                f"chaos: partitioned from rank {dest} ({host}:{port})"
            )

    def force(self, action: str, rank: int = -1,
              delay_s: float = 0.0) -> None:
        """Fire one fault NOW, at a program point instead of a lease
        index — for scenarios whose fault placement must not depend on
        how many leases a retry ladder burns (the deadline smoke's
        partition/heal windows, forced kills between phases). Logged
        with the sentinel op index -1, so the replay-identity check
        stays exact: program-point faults land at the same position in
        the log on every run regardless of lease-count jitter."""
        if action not in ACTIONS:
            raise ValueError(f"unknown chaos action {action!r}")
        with self._lock:
            self.log.append((-1, action, rank))
            if action == "partition":
                self._blocked.add(rank)
            elif action == "heal":
                self._blocked.discard(rank)
        obs_journal.record("chaos_fault", op=-1, action=action, rank=rank)
        if action == "kill":
            self.victim_rings[rank] = obs_journal.events()
            obs_journal.spill_ring(label=f"chaos-kill-r{rank}")
            if self.kill_fn is not None:
                self.kill_fn(rank)
        elif action == "restart":
            self.victim_rings[rank] = obs_journal.events()
            obs_journal.spill_ring(label=f"chaos-restart-r{rank}")
            if self.restart_fn is not None:
                self.restart_fn(rank)
        elif action == "delay":
            time.sleep(delay_s)
        elif action == "isolate":
            if self.isolate_fn is not None:
                self.isolate_fn(rank, True)
        elif action == "heal_isolate":
            if self.isolate_fn is not None:
                self.isolate_fn(rank, False)

    # -- lifecycle -------------------------------------------------------

    def inject(self):
        """Context manager installing this controller as the process-wide
        pool hook (exclusive: nested injection is a harness bug)."""
        return _Injection(self)

    @property
    def ops_seen(self) -> int:
        with self._lock:
            return self._count

    def pending(self) -> list[Fault]:
        """Faults whose op index was never reached (a workload too short
        for its schedule should fail loudly, not silently skip faults)."""
        with self._lock:
            return [f for fs in self._by_op.values() for f in fs]


class _Injection:
    def __init__(self, controller: ChaosController):
        self.c = controller

    def __enter__(self) -> ChaosController:
        _pool.set_chaos_hook(self.c)
        return self.c

    def __exit__(self, *exc) -> None:
        _pool.set_chaos_hook(None)


def corrupt_file(path: str, offset: int | None = None, seed: int = 0) -> int:
    """Flip one byte of ``path`` in place (deterministically from
    ``seed`` when ``offset`` is None); returns the offset flipped."""
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    if not raw:
        raise ValueError(f"cannot corrupt empty file {path}")
    if offset is None:
        offset = random.Random(seed).randrange(len(raw))
    raw[offset] ^= 0xFF
    with open(path, "wb") as f:
        f.write(raw)
    return offset
