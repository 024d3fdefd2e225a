"""The JAX package's own daemon tests of replicas, failure detection and failover, leader election, hash placement and QoS, re-run with
the port's ``Daemon`` (``oncilla_tpu_torch/runtime/daemon.py``) in place of
the JAX one.

Sources: ``tests/test_resilience.py``, ``tests/test_leader.py``, ``tests/test_qos.py``. Each test
named below is imported from its source and collected here as a case; an
autouse fixture monkeypatches ``oncilla_tpu.runtime.cluster.Daemon``,
``oncilla_tpu.runtime.daemon.Daemon`` and the names the source bound
(``Daemon``, ``D``) with the shim of ``test_torch_daemon.py``, which hands
the port's daemon the port's own config and rows. Nothing in
``oncilla_tpu/`` or the JAX tests changes. The JAX client and the JAX
apps talk to the port's daemons over the wire.

Run: every test of these sources that starts a daemon (26), none left
out, plus the flag-table tests, whose ``D`` here is the port's daemon module.
Not run: the tests that start no daemon; they test the JAX modules alone,
and ``test_torch_daemon.py`` holds the port's copies of those modules to
them.

Pointed at the port:

- ``test_leader.py``'s ``obs_journal`` is the port's journal, which the
  port's daemons record ``hash_place`` in.
- ``test_resilience.py``'s ``alloctrace`` is the port's ledger, which the
  port's daemons keep.
- ``test_qos.py``'s ``LoadAware`` is the port's class, which the port's
  daemons place with.
- Faults are injected by the port's chaos harness
  (``test_torch_daemon.use_port_chaos``); ``test_resilience.py``'s
  chaos-replay test, which counts the client's own legs, runs the port's
  client (``test_torch_mux.use_port_client``).
- Errors raised by ``start``, ``_lookup_serving`` and ``_on_migrate``
  when a test calls them directly come back as the JAX classes of the same
  name, message and attributes (``test_torch_daemon.jax_error``).
"""

import pytest

import test_resilience as src_resilience
import test_leader as src_leader
import test_qos as src_qos
from oncilla_tpu_torch.analysis import alloctrace as talloctrace
from oncilla_tpu_torch.obs import journal as tjournal
from oncilla_tpu_torch.qos.loadaware import LoadAware as TLoadAware
from test_torch_daemon import export_ref, patch_ref
from test_torch_mux import use_port_client

RUN_RESILIENCE = [
    "test_dead_verdict_evicts_pooled_connections",
    "test_corrupt_snapshot_restore_refused_cleanly",
    "test_client_connect_retries_daemon_coming_up",
    "test_replicated_alloc_mirrors_and_frees",
    "test_replica_rejects_client_write_while_primary_alive",
    "test_owner_failover_promotes_rereplicates_and_fences",
    "test_fencing_by_incarnation",
    "test_app_killed_mid_striped_put_leaves_no_orphans",
    "test_chaos_replay_identical_interleaving",
    "test_new_flags_declared_and_daemon_handled",
]

RUN_LEADER = [
    "test_election_promotes_standby_and_evicts_pool",
    "test_torn_standby_state_refused_and_resynced",
    "test_stale_pooled_conn_to_fenced_leader_not_retried",
    "test_client_bootstrap_with_rank0_down",
    "test_handoff_and_rank0_leaves_cleanly",
    "test_leader_without_standbys_refuses_leave",
    "test_hash_alloc_zero_leader_roundtrips",
    "test_hash_alloc_survives_dead_primary_replan",
    "test_hash_disabled_is_default_and_inert",
    "test_not_master_redirect_names_leader",
]

RUN_QOS = [
    "test_req_alloc_size_validation_typed_errors",
    "test_quota_enforced_end_to_end_and_freed_quota_returns",
    "test_priority_rides_to_owner_registry",
    "test_busy_backpressure_with_hint_and_high_priority_bypass",
    "test_reaper_evicts_active_low_priority_never_active_normal",
    "test_loadaware_policy_registered_and_fed",
    "test_prom_renders_qos_families",
    "test_qos_flags_declared_and_daemon_handled",
]

export_ref(globals(), src_resilience, RUN_RESILIENCE)
export_ref(globals(), src_leader, RUN_LEADER)
export_ref(globals(), src_qos, RUN_QOS)


_PATCHES = {
    src_resilience.__name__: (src_resilience, dict(alloctrace=talloctrace)),
    src_leader.__name__: (src_leader, dict(obs_journal=tjournal)),
    src_qos.__name__: (src_qos, dict(LoadAware=TLoadAware)),
}


# Counts the client's own legs at the pool seam, where only the port's
# chaos harness is installed: the port's client dials through that seam.
_PORT_CLIENT = {"test_chaos_replay_identical_interleaving"}


@pytest.fixture(autouse=True)
def _port_daemon(request, monkeypatch):
    src, names = _PATCHES[request.function.__module__]
    if request.function.__name__ in _PORT_CLIENT:
        use_port_client(monkeypatch, src, **names)
    else:
        patch_ref(monkeypatch, src, **names)
