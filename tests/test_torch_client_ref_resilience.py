"""The JAX package's own client tests of replication, failover and the
CONNECT ladder, re-run with the port's client (``oncilla_tpu_torch/
runtime/client.py``) and the port's daemons in place of the JAX ones.

Source: ``tests/test_resilience.py``. Each test named below is imported
from it and collected here as a case; an autouse fixture
(``test_torch_mux.use_port_client``) puts the port's ``Daemon`` and client
in place as ``test_torch_client_ref_mux.py`` says, with the allocation
ledger (``alloctrace``), the protocol module (``P``), ``OcmConfig`` and the
error classes the port's. Nothing in ``oncilla_tpu/`` or the JAX tests
changes.

Run: the 8 tests of the source that drive a client.
Not run: the tests that drive no client. The detector, placement, pool
(``test_dead_verdict_evicts_pooled_connections`` included),
snapshot and chaos-schedule units test the JAX modules alone, and
``test_torch_daemon.py`` holds the port's copies of those modules to them;
``test_fencing_by_incarnation``, ``test_unreplicated_wire_is_byte_identical``
and ``test_new_flags_declared_and_daemon_handled`` speak raw frames to the
daemons, which ``test_torch_daemon_ref_control.py`` already runs on the
port's daemons.
"""

import pytest

import test_resilience as src_resilience
from oncilla_tpu_torch.analysis import alloctrace as talloctrace
from oncilla_tpu_torch.runtime import snapshot as tsnap
from test_torch_daemon import export_ref
from test_torch_mux import use_port_client

RUN_RESILIENCE = [
    "test_corrupt_snapshot_restore_refused_cleanly",
    "test_client_connect_retries_daemon_coming_up",
    "test_client_connect_retries_exhausted",
    "test_replicated_alloc_mirrors_and_frees",
    "test_replica_rejects_client_write_while_primary_alive",
    "test_owner_failover_promotes_rereplicates_and_fences",
    "test_app_killed_mid_striped_put_leaves_no_orphans",
    "test_chaos_replay_identical_interleaving",
]

export_ref(globals(), src_resilience, RUN_RESILIENCE)


@pytest.fixture(autouse=True)
def _port_client(monkeypatch):
    use_port_client(monkeypatch, src_resilience, alloctrace=talloctrace,
                    snap=tsnap)
