"""The LEADER_UPDATE broadcast of the port's daemon (``oncilla_tpu_torch/
runtime/daemon.py``) reaching every live member, where it parts from the
JAX package's daemon (ROADMAP Queue C). Both gaps left a member naming the
dead leader for good: the flake of ``test_leader.py::
test_not_master_redirect_names_leader`` on a loaded host (rank 2 kept
``leader_rank`` 0 through the test's 10 s wait).

- A late row. The reference arms the broadcast once, toward the rows that
  have a port when the winner is elected
  (``oncilla_tpu/runtime/daemon.py:1024-1039``): a member whose row gains
  its port after the election (its ADD_NODE reaches the winner late) is
  never sent it. Here, while the broadcast is armed, such a row joins it.
- A stale view. A standby promoted from a master state pushed before a
  member announced adopts that member's row without a port over the
  address its view holds (in an in-process cluster, over the row every
  daemon shares), and the member drops out of every broadcast. Here a row
  without a port never replaces an address (``ClusterView.adopt``).
"""

import time

from oncilla_tpu_torch.control import leader as control_leader
from oncilla_tpu_torch.runtime.cluster import inprocess_cluster
from oncilla_tpu_torch.runtime.membership import ClusterView, NodeEntry
from oncilla_tpu_torch.runtime.protocol import Message, MsgType
from oncilla_tpu_torch.utils.config import OcmConfig


def ldr_cfg(**kw):
    """test_leader.py's control plane: standby masters, a fast detector."""
    d = dict(
        host_arena_bytes=16 << 20, device_arena_bytes=4 << 20,
        chunk_bytes=128 << 10, heartbeat_s=0.05, lease_s=5.0,
        detect_interval_s=0.05, suspect_after=1, dead_after=2,
        probe_timeout_s=0.25, dcn_stripes=1, standby_masters=2,
        failover_wait_s=10.0, replicas=1,
    )
    d.update(kw)
    return OcmConfig(**d)


def wait_for(pred, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _hand_state(standby, doc) -> None:
    """Make ``doc`` the master state ``standby`` holds, fresh."""
    with standby._state_lock:
        standby._master_state_raw = control_leader.pack_state(doc)
        standby._master_state_ts = time.monotonic()


def test_a_row_that_gains_its_port_after_the_election_gets_the_update():
    # One standby: the winner replicates its state to rank 2 alone, so the
    # broadcast is rank 3's only way to learn of the election.
    with inprocess_cluster(4, config=ldr_cfg(standby_masters=1)) as cl:
        d0, d1, d3 = cl.daemons[0], cl.daemons[1], cl.daemons[3]
        wait_for(lambda: d1._master_state_raw is not None, 10.0,
                 "master-state replication")
        # The winner has not heard rank 3 announce: its row has no port,
        # in its view and in the master state it is promoted from.
        d0._push_master_state = lambda: None
        time.sleep(0.2)
        row = cl.entries[3]
        cl.entries[3] = NodeEntry(3, row.host, 0, row.addr)
        _hand_state(d1, control_leader.build_state(d0, seq=1 << 30))
        cl.kill(0)
        wait_for(lambda: d1.is_leader, 10.0, "election")
        time.sleep(0.3)  # a few reaper ticks: nothing to send rank 3 yet
        assert d3.leader_rank == 0
        # Rank 3's ADD_NODE lands at the winner after the election.
        e1 = cl.entries[1]
        d3.peers.request(e1.connect_host, e1.port, Message(MsgType.ADD_NODE, {
            "rank": 3, "host": row.connect_host, "port": d3.port,
            "ndevices": d3.ndevices,
            "device_arena_bytes": d3.config.device_arena_bytes,
            "host_arena_bytes": d3.config.host_arena_bytes,
        }))
        wait_for(lambda: d3.leader_rank == 1, 10.0,
                 "the late row's LEADER_UPDATE")
        assert d3.epoch >= d1.leader_epoch


def test_a_stale_master_state_keeps_the_members_address():
    with inprocess_cluster(3, config=ldr_cfg()) as cl:
        d0, d1, d2 = cl.daemons
        wait_for(lambda: d1._master_state_raw is not None, 10.0,
                 "master-state replication")
        d0._push_master_state = lambda: None  # no fresher copy lands
        time.sleep(0.2)
        # The copy rank 1 holds was pushed before rank 2 announced.
        doc = control_leader.build_state(d0, seq=1 << 30)
        doc["view"]["members"][2]["port"] = 0
        _hand_state(d1, doc)
        cl.kill(0)
        wait_for(lambda: d1.is_leader, 10.0, "election")
        assert cl.entries[2].port == d2.port
        wait_for(lambda: d2.leader_rank == 1, 10.0, "rank 2's LEADER_UPDATE")


def test_adopt_keeps_an_address_over_a_row_without_a_port():
    view = ClusterView([NodeEntry(0, "h", 5000), NodeEntry(1, "h", 5001)])
    stale = ClusterView([NodeEntry(0, "h", 5000), NodeEntry(1, "h", 0),
                         NodeEntry(2, "h", 0)], epoch=1)
    assert view.adopt(1, stale.to_wire())
    assert [e.port for e in view] == [5000, 5001, 0]
    moved = ClusterView([NodeEntry(0, "h", 5000), NodeEntry(1, "h", 6001),
                         NodeEntry(2, "h", 6002)], epoch=2)
    assert view.adopt(2, moved.to_wire())
    assert [e.port for e in view] == [5000, 6001, 6002]
