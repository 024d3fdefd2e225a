"""The JAX package's own tests of the async mux runtime and of the
time-bounded data plane, re-run with the port's client, ``Ocm`` and
``AsyncOcm`` (``oncilla_tpu_torch/runtime/client.py``, ``mux.py``,
``core/context.py``) and the port's daemons in place of the JAX ones.

Sources: ``tests/test_mux.py`` and ``tests/test_timebudget.py``. Each test
named below is imported from its source and collected here as a case; an
autouse fixture (``test_torch_mux.use_port_client``) puts the port's
``Daemon`` in place as ``test_torch_daemon.use_port_daemon`` does, and the
shims of ``test_torch_mux.py`` in place of the JAX ``ControlPlaneClient``,
``Ocm``, ``ocm_init`` and ``AsyncOcm`` (in the JAX cluster, the JAX mux
module and under the names the source bound). Nothing in ``oncilla_tpu/``
or the JAX tests changes.

Pointed at the port, under the names the sources bound: the protocol
module (``P``), the mux module (``mux_rt``: its ``ChannelMap``,
``MuxChannel`` and ``ORPHAN_CAP``), ``OcmConfig``, ``timebudget``,
``backoff_sleep``, the journal (``obs_journal``, which the port's client
and daemons record in), the allocation ledger (``alloctrace``) and the
error classes; the shims' errors derive from both packages' classes of
the same name.

Run: all 13 tests of ``test_mux.py``; 16 of the 17 of
``test_timebudget.py``.
Not run: ``test_timebudget.py::test_audit_catches_ack_after_cancel_ack``,
which drives the JAX package's journal auditor (``obs/audit.py``) alone;
the port has no auditor (ROADMAP A 4, the utilities).
"""

import pytest

import test_mux as src_mux
import test_timebudget as src_timebudget
from test_torch_daemon import export_ref
from test_torch_mux import use_port_client

RUN_MUX = [
    "test_tag_attach_split_roundtrip",
    "test_mux_flags_declared_and_daemon_handled",
    "test_mux_unset_wire_is_byte_identical",
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
]

RUN_TIMEBUDGET = [
    "test_budget_remaining_decrements",
    "test_budget_wire_roundtrip",
    "test_backoff_sleep_jitter_and_clamp_bounds",
    "test_circuit_breaker_state_machine",
    "test_deadline_protocol_surface",
    "test_deadline_unset_wire_is_byte_identical",
    "test_cross_hop_budget_decrement_and_expired_refusal",
    "test_cancel_revokes_server_side_out_of_order",
    "test_cancel_from_lockstep_peer_is_honest_noop",
    "test_mux_orphans_bounded_against_mute_peer",
    "test_hedged_get_escapes_slow_primary",
    "test_hedge_loser_never_mutates_shared_handle",
    "test_replica_serves_client_reads_while_primary_alive",
    "test_breaker_opens_in_transfer_ladder_and_recovers",
    "test_transfer_ladder_clamps_to_budget",
    "test_ocm_context_passes_deadline_through",
]

export_ref(globals(), src_mux, RUN_MUX)
export_ref(globals(), src_timebudget, RUN_TIMEBUDGET)

_SOURCES = {m.__name__: m for m in (src_mux, src_timebudget)}


@pytest.fixture(autouse=True)
def _port_client(request, monkeypatch):
    use_port_client(monkeypatch, _SOURCES[request.function.__module__])
