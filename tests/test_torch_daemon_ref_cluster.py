"""The JAX package's own daemon tests of the data plane, snapshots, demotion, the FROZEN tier, the plane relay and the shm fabric, re-run with
the port's ``Daemon`` (``oncilla_tpu_torch/runtime/daemon.py``) in place of
the JAX one.

Sources: ``tests/test_cluster.py``, ``tests/test_snapshot.py``, ``tests/test_demotion.py``, ``tests/test_persist.py``, ``tests/test_plane_relay.py``, ``tests/test_fabric.py``. Each test
named below is imported from its source and collected here as a case; an
autouse fixture monkeypatches ``oncilla_tpu.runtime.cluster.Daemon``,
``oncilla_tpu.runtime.daemon.Daemon`` and the names the source bound
(``Daemon``, ``D``) with the shim of ``test_torch_daemon.py``, which hands
the port's daemon the port's own config and rows. Nothing in
``oncilla_tpu/`` or the JAX tests changes. The JAX client and the JAX
apps talk to the port's daemons over the wire.

Run: every test of these sources that starts a daemon (63), none left
out, plus the flag-table tests, whose ``D`` here is the port's daemon module.
Not run: the tests that start no daemon; they test the JAX modules alone,
and ``test_torch_daemon.py`` holds the port's copies of those modules to
them.

Pointed at the port:

- ``test_persist.py``'s ``journal`` fixture yields the port's journal,
  which the port's daemons record their tier events in.
- Errors raised by ``start``, ``_lookup_serving`` and ``_on_migrate``
  when a test calls them directly come back as the JAX classes of the same
  name, message and attributes (``test_torch_daemon.jax_error``).
"""

import pytest

import test_cluster as src_cluster
import test_snapshot as src_snapshot
import test_demotion as src_demotion
import test_persist as src_persist
import test_plane_relay as src_plane_relay
import test_fabric as src_fabric
from oncilla_tpu_torch.obs import journal as tjournal
from test_torch_daemon import export_ref, patch_ref

RUN_CLUSTER = [
    "test_remote_host_alloc_put_get_free",
    "test_put_get_offsets_and_chunking",
    "test_remote_bounds_enforced_by_owner",
    "test_remote_device_bookkeeping",
    "test_single_node_demotion",
    "test_capacity_placement_spreads_and_oom",
    "test_neighbor_policy_reference_parity",
    "test_alloc_from_non_master_rank",
    "test_status_endpoint",
    "test_status_surfaces_lease_health",
    "test_lease_expiry_reaps_orphans",
    "test_heartbeat_keeps_alive",
    "test_disconnect_reclaims_immediately",
    "test_heartbeat_fanout_bounded",
    "test_free_unknown_id_rejected",
    "test_many_concurrent_allocs",
    "test_pipelined_error_does_not_desync_connection",
    "test_bounds_error_code_on_wire",
    "test_malformed_request_gets_typed_error_not_dead_thread",
    "test_localbuf_staging_for_remote_kinds",
    "test_localbuf_push_pull_rejected_for_local",
    "test_push_bounds_enforced",
    "test_ocm_init_attaches_via_nodefile",
    "test_handle_sharing_between_apps",
    "test_localbuf_size_asymmetry",
    "test_localbuf_nbytes_window",
    "test_copy_onesided_read_with_window",
    "test_fuzz_full_stack_ops_against_model",
    "test_freed_extents_read_as_zeros",
    "test_reaped_device_extent_scrubbed_for_next_tenant",
    "test_fuzz_relay_and_demotion_against_model",
]

RUN_SNAPSHOT = [
    "test_daemon_restart_restores_allocations",
    "test_restore_wrong_rank_rejected",
    "test_python_snapshot_restored_by_native_daemon",
    "test_restore_device_index_out_of_range",
]

RUN_DEMOTION = [
    "test_demoted_host_roundtrip_and_free",
    "test_demoted_handle_does_not_alias_app_arena",
    "test_demoted_staging_push_pull",
    "test_demoted_device_roundtrip_via_plane",
    "test_demoted_device_without_plane_raises_typed",
]

RUN_PERSIST = [
    "test_demote_promote_roundtrip_and_journal_split",
    "test_eviction_destroys_when_frozen_unconfigured",
    "test_warm_boot_readopts_and_serves_byte_exact",
    "test_warm_boot_refuses_corrupt_extent_and_counts_loss",
    "test_chaos_restart_action",
]

RUN_PLANE_RELAY = [
    "test_planeless_client_reaches_device_bytes",
    "test_planeless_alloc_is_scrubbed",
    "test_relay_bounds_and_errors_are_typed",
    "test_no_plane_registered_raises_typed",
    "test_libocm_c_abi_device_roundtrip",
    "test_relay_concurrency_stress",
    "test_plane_deregister_on_close",
    "test_stale_endpoint_self_heals",
    "test_two_os_processes_share_device_plane",
    "test_restarted_daemon_relearns_plane_endpoint",
]

RUN_FABRIC = [
    "test_shm_roundtrip_counters_and_prom",
    "test_small_transfers_stay_on_tcp",
    "test_v2_daemon_declines_by_silence",
    "test_cross_host_pair_never_selects_shm",
    "test_kill_and_stop_unlink_segments_no_dev_shm_leak",
    "test_stale_segment_and_stale_mapping_rejected",
    "test_fabric_renegotiated_after_owner_failover",
    "test_free_forgets_cached_key_and_close_releases_mappings",
    "test_fabric_flag_declared_and_daemon_handled",
]

export_ref(globals(), src_cluster, RUN_CLUSTER)
export_ref(globals(), src_snapshot, RUN_SNAPSHOT)
export_ref(globals(), src_demotion, RUN_DEMOTION)
export_ref(globals(), src_persist, RUN_PERSIST)
export_ref(globals(), src_plane_relay, RUN_PLANE_RELAY)
export_ref(globals(), src_fabric, RUN_FABRIC)


_PATCHES = {
    src_cluster.__name__: (src_cluster, dict()),
    src_snapshot.__name__: (src_snapshot, dict()),
    src_demotion.__name__: (src_demotion, dict()),
    src_persist.__name__: (src_persist, dict()),
    src_plane_relay.__name__: (src_plane_relay, dict()),
    src_fabric.__name__: (src_fabric, dict()),
}


@pytest.fixture(autouse=True)
def _port_daemon(request, monkeypatch):
    src, names = _PATCHES[request.function.__module__]
    patch_ref(monkeypatch, src, **names)


@pytest.fixture
def journal():
    prev = tjournal.enabled()
    tjournal.set_enabled(True)
    yield tjournal
    tjournal.set_enabled(prev)
