"""Master-state replication + the election rule.

The leader's coordination state — what a standby needs to RESUME
coordination (failover, re-replication, rebalance, joins) without the
dead leader — is small: the placement accounting table, the member
view, and the dead set. It replicates as a JSON document with a
trailing CRC32, the exact integrity discipline of snapshot format v2
(:mod:`oncilla_tpu_torch.runtime.snapshot`): a standby that cannot verify the
CRC refuses the copy WHOLE and re-syncs from the survivors rather than
leading from torn state.

The election rule is deliberately trivial and coordination-free: after
a DEAD verdict for the leader, the new leader is the LOWEST-rank live
member. Every rank computes it locally from its own view + detector;
the epoch bump + (rank, incarnation) fence — the failover layer's owner-fencing
machinery applied to the master role — is what makes two transient
claimants safe: at most one survives under any epoch, and the
flight-recorder ``leader-unique`` invariant audits exactly that.
"""

from __future__ import annotations

import json
import struct
import zlib

from oncilla_tpu_torch.core.errors import OcmProtocolError

_CRC = struct.Struct("<I")

# Bumped when the document shape changes incompatibly; a standby from a
# newer build refuses an older leader's state (and re-syncs) instead of
# misparsing it.
STATE_VERSION = 1


def pack_state(doc: dict) -> bytes:
    """Encode a master-state document with the CRC32 trailer."""
    doc = dict(doc)
    doc["v"] = STATE_VERSION
    raw = json.dumps(doc, separators=(",", ":")).encode()
    return raw + _CRC.pack(zlib.crc32(raw))


def unpack_state(raw) -> dict:
    """Decode + verify a replicated master-state copy. Raises
    :class:`OcmProtocolError` on ANY integrity failure — truncation, CRC
    mismatch, non-JSON, version skew — so promotion code has exactly one
    refuse-whole path."""
    raw = bytes(raw)
    if len(raw) < _CRC.size + 2:
        raise OcmProtocolError("truncated master state")
    (want,) = _CRC.unpack_from(raw, len(raw) - _CRC.size)
    body = raw[: len(raw) - _CRC.size]
    got = zlib.crc32(body)
    if got != want:
        raise OcmProtocolError(
            f"master-state CRC mismatch (stored {want:#010x}, computed "
            f"{got:#010x}): torn or corrupt — refusing whole"
        )
    try:
        doc = json.loads(body)
    except ValueError as e:
        raise OcmProtocolError(f"malformed master state: {e}") from None
    if not isinstance(doc, dict) or doc.get("v") != STATE_VERSION:
        raise OcmProtocolError(
            f"unsupported master-state version {doc.get('v') if isinstance(doc, dict) else '?'}"
        )
    return doc


def build_state(daemon, seq: int, leader: int | None = None) -> dict:
    """The leader's replicable coordination state, as of now."""
    det = daemon.detector
    return {
        "seq": seq,
        "epoch": daemon.epoch,
        "leader": daemon.rank if leader is None else leader,
        "inc": daemon.incarnation,
        "view": json.loads(daemon.entries.to_wire().decode()),
        "placement": daemon.policy.export_rows(),
        "dead": sorted(det.dead_ranks()) if det is not None else [],
    }


def apply_state(daemon, doc: dict) -> None:
    """Adopt a verified master-state document on a promoting standby:
    member view (epoch-fenced — a stale table is dropped by adopt),
    placement accounting, and the dead set. Idempotent."""
    view = doc.get("view") or {}
    if view:
        daemon.entries.adopt(
            int(view.get("epoch", 0)),
            json.dumps(view, separators=(",", ":")).encode(),
        )
    daemon.policy.restore(doc.get("placement") or [],
                          doc.get("dead") or ())
    daemon._adopt_epoch(int(doc.get("epoch", 0)))
    if daemon.detector is not None:
        for r in doc.get("dead") or ():
            daemon.detector.mark_dead(int(r))


def elect(view, dead, self_rank: int) -> int | None:
    """The election rule: lowest-rank live member (not departed, not in
    the dead set, actually addressable). Every rank runs the same pure
    computation over its own view — returns the winner's rank, or None
    when nobody qualifies."""
    cands = [
        e.rank for e in view
        if e.port
        and e.rank not in dead
        and not view.has_left(e.rank)
    ]
    return min(cands) if cands else None
