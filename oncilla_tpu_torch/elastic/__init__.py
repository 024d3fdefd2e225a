"""Elastic membership, the port's copy of ``oncilla_tpu/elastic``:
epoch-fenced JOIN/LEAVE + live extent migration.

The reference fixes cluster membership at boot — a positional nodefile
parsed once, rank 0 placing over a static table — and data moves only
when an owner *dies* (the failover path). This subsystem makes the
cluster grow, shrink, and rebalance WITHOUT a failure:

- **JOIN** — a fresh daemon dials rank 0 with REQ_JOIN (address,
  capacities, incarnation); rank 0 assigns the next rank, bumps the
  cluster epoch, and broadcasts MEMBER_UPDATE so every daemon's
  ClusterView (runtime/membership.py) and detector table adopt the new
  member. A joiner whose JOIN_OK was lost retries idempotently — the
  address dedups onto the original rank, never a half-member slot.
- **LEAVE** — REQ_LEAVE drains the leaver (everything it holds migrates
  or re-homes), THEN the epoch bumps and the member departs; a drain
  that cannot complete refuses the leave. Dying instead of leaving is
  the *unclean* path and degrades to the DEAD-verdict failover ladder.
- **Live migration** — the rank-0 :class:`Rebalancer` computes
  capacity-weighted target placement and drives a provision ->
  FLAG_FANOUT chunk stream (with bounded pre-copy dirty passes) ->
  epoch-fenced ownership flip -> drop-source state machine at each
  source primary. Racing puts are fenced by NOT_PRIMARY/MOVED and
  retried through the client's failover ladder, so gets stay byte-exact
  throughout; handles repoint lazily via the MOVED redirect or a
  REQ_LOCATE to rank 0.

``python -m oncilla_tpu_torch.elastic --smoke`` proves the protocol under the
deterministic chaos harness (kill-owner-mid-migration, partitioned
join, and a full join -> rebalance -> leave cycle with drained
ledgers). See docs/ELASTIC.md for the state machines and the fencing
matrix.
"""

from oncilla_tpu_torch.elastic.rebalance import Rebalancer

__all__ = ["Rebalancer", "join_cluster", "leave_cluster"]


def __getattr__(name: str):
    # join/leave build Daemon objects; importing them eagerly here would
    # cycle (runtime.daemon imports elastic.rebalance through THIS
    # package __init__).
    if name in ("join_cluster", "leave_cluster"):
        from oncilla_tpu_torch.elastic import join as _join

        return getattr(_join, name)
    raise AttributeError(name)
