"""The JAX package's own tests of the striped TCP data plane and of the
shared-memory fabric, re-run with the port's client and ``Ocm``
(``oncilla_tpu_torch/runtime/client.py``, ``fabric/``,
``core/context.py``) and the port's daemons in place of the JAX ones.

Sources: ``tests/test_dcn_stripe.py`` and ``tests/test_fabric.py``. Each
test named below is imported from its source and collected here as a
case; an autouse fixture (``test_torch_mux.use_port_client``) puts the
port's ``Daemon``, client and ``Ocm`` in place as
``test_torch_client_ref_mux.py`` says. Nothing in ``oncilla_tpu/`` or the
JAX tests changes.

Pointed at the port, under the names the sources bound: the protocol
module (``P``), the fabric package (``F``), its shm and tcp modules
(``fshm``, ``tcp_mod``: a fault a test injects by monkeypatching their
``send_msg``, ``recv_msg`` or ``_attach_untracked`` lands in the port's
data plane), ``FabricKey``, the tuner (``_PeerTuner``), ``OcmConfig`` and
the error classes.

Run: every test of both sources, 19 of ``test_dcn_stripe.py`` (22 cases)
and 13 of ``test_fabric.py``, none left out.
"""

import pytest

import test_dcn_stripe as src_dcn
import test_fabric as src_fabric
from oncilla_tpu_torch import fabric as tfabric
from oncilla_tpu_torch.fabric import shm as tshm
from oncilla_tpu_torch.fabric import tcp as ttcp
from oncilla_tpu_torch.fabric.base import FabricKey as TFabricKey
from test_torch_daemon import export_ref
from test_torch_mux import use_port_client

RUN_DCN = [
    "test_chunk_bytes_capped_at_wire_frame",
    "test_max_chunk_frame_actually_fits",
    "test_stripe_config_validated",
    "test_plan_stripes_respects_min_bytes",
    "test_tuner_grows_and_shrinks",
    "test_tuner_pinned_when_adaptive_off",
    "test_striped_roundtrip_byte_exact",
    "test_single_stream_path_selectable",
    "test_lockstep_fallback_when_coalesce_disabled",
    "test_get_into_reuses_caller_buffer",
    "test_context_get_out_param",
    "test_mid_stripe_socket_kill_retries",
    "test_failed_stripe_does_not_corrupt_siblings",
    "test_stale_owner_addr_falls_back_to_membership",
    "test_interleaved_request_inside_burst_rejected",
    "test_coalesced_burst_error_reported_once",
    "test_status_reports_data_plane_throughput",
    "test_status_fields_keep_v2_shape",
    "test_concurrent_striped_transfers",
]

RUN_FABRIC = [
    "test_fabric_config_validated",
    "test_fabric_key_bounds_checked_before_any_byte_moves",
    "test_attach_peer_declines_garbage_and_unreachable",
    "test_fabric_unset_wire_is_byte_identical",
    "test_fabric_flag_declared_and_daemon_handled",
    "test_shm_roundtrip_counters_and_prom",
    "test_small_transfers_stay_on_tcp",
    "test_v2_daemon_declines_by_silence",
    "test_cross_host_pair_never_selects_shm",
    "test_kill_and_stop_unlink_segments_no_dev_shm_leak",
    "test_stale_segment_and_stale_mapping_rejected",
    "test_fabric_renegotiated_after_owner_failover",
    "test_free_forgets_cached_key_and_close_releases_mappings",
]

export_ref(globals(), src_dcn, RUN_DCN)
export_ref(globals(), src_fabric, RUN_FABRIC)

_PATCHES = {
    src_dcn.__name__: (src_dcn, dict(tcp_mod=ttcp,
                                     _PeerTuner=ttcp.PeerTuner)),
    src_fabric.__name__: (src_fabric, dict(F=tfabric, fshm=tshm,
                                           FabricKey=TFabricKey)),
}


@pytest.fixture(autouse=True)
def _port_client(request, monkeypatch):
    src, names = _PATCHES[request.function.__module__]
    use_port_client(monkeypatch, src, **names)
