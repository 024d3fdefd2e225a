"""Rendezvous (highest-random-weight) placement.

The plan shape that lets ANY rank site an allocation without a leader
round trip: given the allocation's id and the live member set, every
rank — and, post-mortem, the flight-recorder auditor — computes the
identical primary+replica chain. Rendezvous hashing beats a ring here
because membership churn moves only the extents whose owner changed
(1/n of keys per departure), and the chain for one key is just the
top-k scores — no virtual-node bookkeeping.

STDLIB-ONLY by contract: :mod:`oncilla_tpu_torch.obs.audit` imports this to
recompute plans when verifying the ``placement-agreement`` invariant,
and the obs package must stay importable mid-package-init.
"""

from __future__ import annotations

import hashlib
import struct

_PAIR = struct.Struct("<QQ")
_MASK = (1 << 64) - 1


def score(key: int, rank: int) -> int:
    """The HRW weight of ``rank`` for ``key``: a keyed 64-bit digest.
    blake2b is stdlib, stable across platforms/processes (unlike
    hash()), and 8 digest bytes are plenty for rank ordering."""
    h = hashlib.blake2b(
        _PAIR.pack(key & _MASK, rank & _MASK), digest_size=8
    )
    return int.from_bytes(h.digest(), "little")


def plan(key: int, ranks, k: int = 1) -> tuple[int, ...]:
    """The ordered owner chain for ``key``: the ``k`` highest-scoring
    members of ``ranks`` (primary first). Deterministic — same key, same
    member set, same chain, on every rank — and stable under churn: a
    member leaving only re-homes the keys it was in the top-k for.
    Ties (astronomically unlikely) break toward the lower rank so the
    order stays total. Returns fewer than ``k`` when the member set is
    smaller (degraded, never an error — the replication contract).
    """
    members = sorted(set(int(r) for r in ranks))
    if not members:
        return ()
    k = max(1, int(k))
    ordered = sorted(members, key=lambda r: (-score(key, r), r))
    return tuple(ordered[:k])
