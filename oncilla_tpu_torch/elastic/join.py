"""The port's copy of ``oncilla_tpu/elastic/join.py``, line for line, with the
imports renamed to the port's modules.

Joiner/leaver side of the elastic membership protocol.

:func:`join_cluster` is what a fresh daemon process runs instead of the
boot-time nodefile path: bind a listener FIRST (peers dialing the freshly
announced rank queue in the backlog instead of bouncing off a closed
port), dial rank 0 with REQ_JOIN, and build the daemon from the JOIN_OK
grant — assigned rank, cluster epoch, and the full member table. The
request retries with capped backoff: a dropped REQ_JOIN or a lost
JOIN_OK re-sends idempotently, and rank 0 dedups the (host, port)
announcement onto the original rank, so a retried join can never leak a
half-member slot.

:func:`leave_cluster` is the graceful departure: REQ_LEAVE asks rank 0
to drain everything the leaver holds (migrate primaries out, re-home
replica copies), and only a COMPLETE drain lets the member depart —
rank 0 bumps the epoch, broadcasts the shrunk view, and the leaver stops
serving. A refused drain leaves the member in place; dying instead is
the *unclean* path and degrades to the DEAD-verdict failover ladder.
"""

from __future__ import annotations

import os
import socket
import time

from oncilla_tpu_torch.core.errors import OcmConnectError, OcmError, OcmRemoteError
from oncilla_tpu_torch.runtime.membership import ClusterView, NodeEntry
from oncilla_tpu_torch.runtime.pool import PeerPool
from oncilla_tpu_torch.runtime.protocol import ErrCode, Message, MsgType
from oncilla_tpu_torch.utils.config import OcmConfig
from oncilla_tpu_torch.utils.debug import printd


def join_cluster(
    rank0_host: str,
    rank0_port: int,
    config: OcmConfig | None = None,
    *,
    host: str = "127.0.0.1",
    port: int = 0,
    advertise_host: str | None = None,
    policy: str = "capacity",
    ndevices: int = 1,
    snapshot_path: str | None = None,
    retries: int = 20,
):
    """Join a running cluster and return the STARTED joiner daemon.

    The listener binds (and listens) before REQ_JOIN goes out, so the
    instant rank 0 broadcasts the new member, peer dials land in the
    backlog and are served the moment :meth:`Daemon.start` runs the
    accept loop. ``advertise_host`` is the address peers should dial
    (defaults to the bind host — pass it when binding a wildcard).
    """
    from oncilla_tpu_torch.runtime.daemon import Daemon  # cycle: daemon imports elastic

    config = config or OcmConfig()
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        listener.bind((host, port))
        listener.listen(64)
        port = listener.getsockname()[1]
        inc = int.from_bytes(os.urandom(8), "little") or 1
        req = Message(
            MsgType.REQ_JOIN,
            {
                "host": advertise_host or host,
                "port": port,
                "ndevices": ndevices,
                "device_arena_bytes": config.device_arena_bytes,
                "host_arena_bytes": config.host_arena_bytes,
                "inc": inc,
            },
        )
        # A short-lived pool (not a bare socket) so the chaos harness's
        # lease seam covers the JOIN leg too — a partitioned or dropped
        # REQ_JOIN retries idempotently, which IS the protocol claim the
        # smoke proves.
        pool = PeerPool()
        seed = (rank0_host, rank0_port)
        try:
            reply = None
            for i in range(retries):
                try:
                    reply = pool.request(seed[0], seed[1], req)
                    break
                except OcmRemoteError as e:
                    # Leadership moved off the seed (control/): the
                    # NOT_MASTER redirect names the live leader's
                    # address explicitly — a joiner has no member table
                    # yet, so the rank alone would be useless.
                    addr = getattr(e, "leader_addr", None)
                    if e.code == int(ErrCode.NOT_MASTER) and addr:
                        printd("join: seed %s:%d is not the leader; "
                               "redirected to %s:%d",
                               seed[0], seed[1], addr[0], addr[1])
                        seed = tuple(addr)
                        continue
                    raise
                except (OSError, OcmConnectError) as e:
                    printd("join: REQ_JOIN attempt %d failed: %s", i, e)
                    time.sleep(min(0.05 * 2 ** i, 2.0))
            if reply is None:
                raise OcmConnectError(
                    f"leader unreachable at {seed[0]}:{seed[1]} "
                    f"after {retries} REQ_JOIN attempts"
                )
        finally:
            pool.close()
        rank = reply.fields["rank"]
        epoch = reply.fields["epoch"]
        view = ClusterView([])
        if not reply.data:
            raise OcmError("JOIN_OK carried no member table")
        view.adopt(epoch, bytes(reply.data))
        if not (0 <= rank < len(view)):
            raise OcmError(
                f"JOIN_OK rank {rank} not in the granted member table"
            )
        d = Daemon(
            rank, view, config=config, policy=policy, ndevices=ndevices,
            host=host, snapshot_path=snapshot_path,
            incarnation=inc, listener=listener,
        )
        listener = None  # owned by the daemon now
        # The daemon that granted JOIN_OK IS the leader (only leaders
        # admit): seed leader_rank from the address that answered, so a
        # joiner admitted after a leadership transfer aims its ADD_NODE
        # and proxies at the live leader instead of bouncing off rank 0.
        lead = view.find(seed[0], seed[1])
        if lead is not None:
            d.leader_rank = lead
        d._adopt_epoch(epoch)
        d.start()
        # The granted view may name members a boot-time constructor never
        # saw (and departed ones it must not probe).
        d._reconcile_detector()
        printd("join: rank %d serving at %s:%d (epoch %d, %d members)",
               rank, host, port, epoch, view.alive_count())
        return d
    finally:
        if listener is not None:
            listener.close()


def leave_cluster(daemon, retries: int = 3) -> dict:
    """Gracefully depart: drain-then-drop via the leader, then stop
    serving.

    A daemon that currently LEADS first hands the role off to the
    lowest live standby (``Daemon.handoff_leadership`` — final master
    state pushed synchronously under the CRC discipline), then departs
    as an ordinary member through the successor. This closes the
    "rank 0 cannot leave" hole of the first elastic design; without standby masters
    configured there is nobody to hand to and the leader still refuses.

    Returns ``{"epoch": ..., "moved": ...}`` from LEAVE_OK. Raises (and
    leaves the daemon RUNNING) if the leader refuses — e.g. the drain
    could not complete, or this daemon's incarnation no longer matches
    the member table (a restarted daemon at the same address must
    re-join before it may leave).
    """
    if daemon.rank == daemon.leader_rank:
        if daemon.config.standby_masters <= 0:
            raise OcmError(
                f"rank {daemon.rank} leads the cluster and cannot leave: "
                "no standby masters configured (OCM_STANDBY_MASTERS)"
            )
        daemon.handoff_leadership()
    req = Message(
        MsgType.REQ_LEAVE,
        {"rank": daemon.rank, "inc": daemon.incarnation},
    )
    last: Exception | None = None
    for i in range(retries):
        le = daemon._leader_entry()
        try:
            reply = daemon.peers.request(le.connect_host, le.port, req)
            break
        except OcmRemoteError as e:
            if e.code == int(ErrCode.NOT_MASTER) and getattr(
                e, "leader_rank", None
            ) is not None:
                daemon._adopt_leader_hint(e)
                last = e
                continue
            # A typed refusal (drain incomplete, stale incarnation) is
            # the caller's problem, not noise.
            raise
        except (OSError, OcmConnectError) as e:
            last = e
            time.sleep(min(0.05 * 2 ** i, 1.0))
    else:
        raise OcmRemoteError(
            0, f"leader unreachable for REQ_LEAVE: {last}"
        )
    out = {"epoch": reply.fields["epoch"], "moved": reply.fields["moved"]}
    printd("leave: rank %d departed at epoch %d (%d extents moved)",
           daemon.rank, out["epoch"], out["moved"])
    daemon.stop()
    return out
