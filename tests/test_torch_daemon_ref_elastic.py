"""The JAX package's own daemon tests of elastic join, leave and live migration, and mux tagged serving, re-run with
the port's ``Daemon`` (``oncilla_tpu_torch/runtime/daemon.py``) in place of
the JAX one.

Sources: ``tests/test_elastic.py``, ``tests/test_mux.py``. Each test
named below is imported from its source and collected here as a case; an
autouse fixture monkeypatches ``oncilla_tpu.runtime.cluster.Daemon``,
``oncilla_tpu.runtime.daemon.Daemon`` and the names the source bound
(``Daemon``, ``D``) with the shim of ``test_torch_daemon.py``, which hands
the port's daemon the port's own config and rows. Nothing in
``oncilla_tpu/`` or the JAX tests changes. The JAX client and the JAX
apps talk to the port's daemons over the wire.

Run: every test of these sources that starts a daemon (19), none left
out, plus the flag-table tests, whose ``D`` here is the port's daemon module.
Not run: the tests that start no daemon; they test the JAX modules alone,
and ``test_torch_daemon.py`` holds the port's copies of those modules to
them.

Pointed at the port:

- ``test_mux.py``'s chaos test reads the JAX client's ledger, as in its
  source; the port's daemons' ledger is not read there.
- Errors raised by ``start``, ``_lookup_serving`` and ``_on_migrate``
  when a test calls them directly come back as the JAX classes of the same
  name, message and attributes (``test_torch_daemon.jax_error``).
"""

import pytest

import test_elastic as src_elastic
import test_mux as src_mux
from test_torch_daemon import export_ref, patch_ref

RUN_ELASTIC = [
    "test_req_join_assigns_next_rank_and_dedups_retries",
    "test_join_cluster_serves_and_leave_drains",
    "test_live_migration_moved_redirect_put_get_free",
    "test_migrate_rejects_bad_targets_and_non_primary",
    "test_migration_with_replicas_moves_primary_keeps_chain",
    "test_heartbeat_tombstone_forward_cannot_loop",
    "test_migration_carries_priority_and_quota_stays_charged",
    "test_rebalance_spreads_onto_joiner_and_ledger_drains",
    "test_join_auto_rebalance_config_knob",
    "test_elastic_msgtypes_registered_and_dispatched",
]

RUN_MUX = [
    "test_mux_sync_client_roundtrip_and_footprint",
    "test_mux_many_tenants_share_one_channel_set",
    "test_mux_declined_by_silence_python_peer",
    "test_async_ocm_basic_roundtrip",
    "test_async_device_kind_rejected",
    "test_mux_out_of_order_control_completion",
    "test_mux_concurrent_tenants_chaos_kill_owner",
    "test_hash_placement_backpressure_busy",
    "test_hash_backpressure_spills_to_unpressured_rank",
    "test_mux_channel_survives_abandoned_waiter",
    "test_mux_flags_declared_and_daemon_handled",
]

export_ref(globals(), src_elastic, RUN_ELASTIC)
export_ref(globals(), src_mux, RUN_MUX)


_PATCHES = {
    src_elastic.__name__: (src_elastic, dict()),
    src_mux.__name__: (src_mux, dict()),
}


@pytest.fixture(autouse=True)
def _port_daemon(request, monkeypatch):
    src, names = _PATCHES[request.function.__module__]
    patch_ref(monkeypatch, src, **names)
