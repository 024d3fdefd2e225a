"""Replication on the port's daemon (``oncilla_tpu_torch/runtime/
daemon.py``) where it parts from the JAX package's daemon: gaps that made
the reference's own resilience smokes fail now and then on a loaded host
(ROADMAP Queue C), each forced open here.

- Re-replication against a concurrent put (``_on_re_replicate``). The
  primary adopts the extended chain, then streams its bytes to the new
  replica chunk by chunk. A client put landing on a range after the stream
  read that chunk, whose fan-out reached the new replica before the chunk
  did, was overwritten there by the chunk's older bytes: the replica held
  bytes older than the client's last acknowledged write, and a later
  failover would have served them (the JAX package's ``docs/RESILIENCE.md``
  names the window). Here the stream's chunk waits, already read, while
  the put lands and fans out, framed or through the shm fabric.
- Provisioning a replica (``_provision_chain``). One dropped connection to
  a replica cut the chain to the primary alone, and nothing restored the
  copy until a member died: the resilience leader smoke lost an
  acknowledged write when the leader it killed held such a chain. Here the
  first DO_REPLICA to the replica fails.
- A put whose chain grows while its fan-out runs (``_fan_out_legs``). The
  legs went to the chain as it stood when they began, while the ack names
  the chain as it stands at the ack: a member a concurrent upsert added
  missed the acknowledged bytes (the auditor's ``replica-ack`` finding,
  where the chain had one member when the legs began; the leader smoke
  failed on it on the card). Here the chain gains a member during the
  first leg; the new member must hold the bytes.
"""

import threading
import time

import numpy as np
import pytest

from oncilla_tpu_torch.core.kinds import OcmKind
from oncilla_tpu_torch.obs import audit, journal
from oncilla_tpu_torch.runtime.cluster import inprocess_cluster
from oncilla_tpu_torch.runtime.protocol import (
    FLAG_FANOUT, WIRE_KIND, Message, MsgType)
from oncilla_tpu_torch.utils.config import OcmConfig

CHUNK = 64 << 10
NBYTES = 4 * CHUNK
AT = 2 * CHUNK  # the chunk the put races


@pytest.mark.parametrize("fabric", ["tcp", "shm"])
def test_put_racing_a_stream_chunk_reaches_the_new_replica(fabric):
    cfg = OcmConfig(host_arena_bytes=8 << 20, device_arena_bytes=1 << 20,
                    heartbeat_s=5.0, chunk_bytes=CHUNK, fabric=fabric,
                    fabric_shm_min_bytes=4 << 10)
    old = np.random.default_rng(0).integers(0, 256, NBYTES, dtype=np.uint8)
    new = np.random.default_rng(1).integers(0, 256, CHUNK, dtype=np.uint8)
    with inprocess_cluster(3, config=cfg) as cl:
        client = cl.client(0, heartbeat=False)
        h = client.alloc(NBYTES, OcmKind.REMOTE_HOST)
        client.put(h, old)
        primary = cl.daemons[h.rank]
        target = next(r for r in range(3) if r != h.rank)
        streamer = threading.get_ident()
        real = primary.peers.request
        put_thread = []

        def request(host, port, msg, *a, **kw):
            if (threading.get_ident() == streamer
                    and msg.type == MsgType.DATA_PUT and msg.flags & FLAG_FANOUT
                    and msg.fields["offset"] == AT and not put_thread):
                # The chunk is read (its bytes are the old ones); the put
                # lands and fans out before it is sent.
                t = threading.Thread(target=client.put, args=(h, new, AT))
                put_thread.append(t)
                t.start()
                time.sleep(0.5)
            return real(host, port, msg, *a, **kw)

        primary.peers.request = request
        try:
            primary._on_re_replicate(Message(MsgType.RE_REPLICATE, {
                "alloc_id": h.alloc_id, "target_rank": target,
                "epoch": primary.epoch}))
        finally:
            primary.peers.request = real
        put_thread[0].join(10.0)
        assert not put_thread[0].is_alive()
        want = old.copy()
        want[AT:AT + CHUNK] = new
        assert np.array_equal(np.asarray(client.get(h, NBYTES)), want)
        e = cl.daemons[target].registry.lookup(h.alloc_id)
        replica = np.frombuffer(bytes(
            cl.daemons[target].host_arena.view(e.extent))[:NBYTES], np.uint8)
        assert np.array_equal(replica, want), (
            f"{int((replica != want).sum())} replica bytes stale")
        assert primary.fabric_counters["shm_puts"] == (2 if fabric == "shm" else 0)
        client.free(h)


def test_one_dropped_provisioning_leg_keeps_the_chain_whole():
    cfg = OcmConfig(host_arena_bytes=8 << 20, device_arena_bytes=1 << 20,
                    heartbeat_s=5.0, replicas=2)
    data = np.random.default_rng(2).integers(0, 256, NBYTES, dtype=np.uint8)
    with inprocess_cluster(3, config=cfg) as cl:
        leader = cl.daemons[0]
        real = leader.peers.request
        dropped = []

        def request(host, port, msg, *a, **kw):
            if msg.type == MsgType.DO_REPLICA and not dropped:
                dropped.append(port)
                raise OSError("connection dropped")
            return real(host, port, msg, *a, **kw)

        leader.peers.request = request
        try:
            client = cl.client(0, heartbeat=False)
            h = client.alloc(NBYTES, OcmKind.REMOTE_HOST)
        finally:
            leader.peers.request = real
        assert dropped, "no provisioning leg crossed the wire"
        assert len(h.replica_ranks) == 1 and h.replica_ranks[0] != h.rank
        chain = (h.rank, h.replica_ranks[0])
        for r in chain:
            assert cl.daemons[r].registry.lookup(h.alloc_id).chain == chain
        client.put(h, data)
        e = cl.daemons[chain[1]].registry.lookup(h.alloc_id)
        replica = np.frombuffer(bytes(
            cl.daemons[chain[1]].host_arena.view(e.extent))[:NBYTES], np.uint8)
        assert np.array_equal(replica, data)
        client.free(h)


def test_put_reaches_a_member_its_chain_gained_during_the_legs():
    cfg = OcmConfig(host_arena_bytes=8 << 20, device_arena_bytes=1 << 20,
                    heartbeat_s=5.0, replicas=2)
    data = np.random.default_rng(3).integers(0, 256, NBYTES, dtype=np.uint8)
    was = journal.enabled()
    journal.set_enabled(True)
    journal.clear()
    try:
        with inprocess_cluster(3, config=cfg) as cl:
            client = cl.client(0, heartbeat=False)
            h = client.alloc(NBYTES, OcmKind.REMOTE_HOST)
            primary = cl.daemons[h.rank]
            (first,) = h.replica_ranks
            (grown,) = set(range(3)) - {h.rank, first}
            e = primary.registry.lookup(h.alloc_id)
            chain = (h.rank, first, grown)
            real = primary.peers.request

            def request(host, port, msg, *a, **kw):
                if (msg.type == MsgType.DATA_PUT and msg.flags & FLAG_FANOUT
                        and e.chain != chain):
                    # A re-replication's or a chain fixup's DO_REPLICA
                    # upsert lands while the first leg is on the wire.
                    cl.daemons[grown]._on_do_replica(Message(
                        MsgType.DO_REPLICA, {
                            "alloc_id": h.alloc_id,
                            "kind": WIRE_KIND[e.kind.value],
                            "nbytes": e.nbytes, "orig_rank": e.origin_rank,
                            "pid": e.origin_pid,
                            "chain": ",".join(map(str, chain)),
                            "epoch": e.epoch}))
                    primary.registry.set_chain(h.alloc_id, chain, e.epoch)
                return real(host, port, msg, *a, **kw)

            primary.peers.request = request
            try:
                client.put(h, data)
            finally:
                primary.peers.request = real
            assert e.chain == chain
            for r in (first, grown):
                re_ = cl.daemons[r].registry.lookup(h.alloc_id)
                replica = np.frombuffer(bytes(
                    cl.daemons[r].host_arena.view(re_.extent))[:NBYTES],
                    np.uint8)
                assert np.array_equal(replica, data), (
                    f"rank {r}: {int((replica != data).sum())} bytes missing")
            acks = [ev for ev in journal.events() if ev.get("ev") == "put_ack"]
            assert acks and all(ev["chain"] == len(chain) for ev in acks)
            findings, _ = audit.audit_events(journal.events())
            assert not [f for f in findings if f.rule == "replica-ack"], findings
            client.free(h)
    finally:
        journal.set_enabled(was)
        journal.clear()
