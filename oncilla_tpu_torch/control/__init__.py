"""Decentralized control plane: leadership transfer + hash placement.

Two cooperating pieces remove the rank-0 single point of failure the
resilience layer could not absorb (ROADMAP item 2):

- :mod:`~oncilla_tpu_torch.control.leader` — the master role as an
  epoch-fenced lease: the leader replicates its coordination state
  (placement accounting, member view, dead set) to standby masters
  under the snapshot+CRC discipline, and on a DEAD verdict for the
  leader the lowest live rank bumps the epoch, fences the old leader by
  (rank, incarnation), and resumes coordination from the replica.
- :mod:`~oncilla_tpu_torch.control.hashring` — rendezvous (HRW) placement so
  any rank computes an allocation's primary+replica set locally from
  the live member view, serving REQ_ALLOC with zero leader round trips.

The wire surface (MASTER_STATE / LEADER_UPDATE / LEADER_HANDOFF, the
NOT_MASTER leader-redirect tail) follows the established
declined-by-silence capability discipline: nothing rides unless
``OCM_STANDBY_MASTERS`` arms it, so the default wire stays byte-for-byte
the pre-leadership protocol.
"""

from oncilla_tpu_torch.control import hashring, leader  # noqa: F401
