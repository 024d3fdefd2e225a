"""The port's trace export, journal, Prometheus text and cluster CLI
(``oncilla_tpu_torch/obs/{export,journal,prom,trace}.py`` and ``python -m
oncilla_tpu_torch.obs``), held to the JAX package's own tests of them.

Sources, each test named below imported and collected here as a case:

- ``tests/test_obs.py``: all of its tests (33). An autouse fixture points
  the names the source bound at the port: ``export``, ``journal``,
  ``prom`` and ``obs_trace`` are the port's modules, ``P`` its protocol,
  ``obs_main`` its CLI entry, ``Daemon``, ``OcmConfig``, ``OpStats``,
  ``Tracer`` and ``OcmKind`` its classes, and ``local_cluster``
  ``test_torch_slo.port_cluster`` (the port's in-process daemons, clients
  and contexts). The daemon module the v2-peer case imports inside the
  test is the port's (``test_torch_daemon.PORT_DAEMON_MODULE``).
- ``tests/test_native_obs.py``: its export case (one trace_id from the
  port's client into the native daemon, stitched by the port's exporter)
  and its CLI case (the port's CLI against native daemons that decline
  the obs families), on the port's copy of the native daemon
  (``test_torch_chaos.PortNative``) and the port's client
  (``test_torch_mux.use_port_client``).

Nothing in ``oncilla_tpu/`` or the JAX tests changes.

Added here: ``merge`` and ``chrome_trace`` of the same event streams equal
the JAX package's as sorted JSON (tolerance 0).
"""

import json

import numpy as np
import pytest

import oncilla_tpu.obs.__main__ as jobs_main_mod
import oncilla_tpu.runtime as jruntime_pkg
import test_native_obs as src_native
import test_obs as src
from oncilla_tpu.obs import export as jexport
from oncilla_tpu_torch.core.kinds import OcmKind as TKind
from oncilla_tpu_torch.obs import export as texport
from oncilla_tpu_torch.obs import journal as tjournal
from oncilla_tpu_torch.obs import prom as tprom
from oncilla_tpu_torch.obs import trace as ttrace
from oncilla_tpu_torch.obs.__main__ import main as tobs_main
from oncilla_tpu_torch.runtime import cluster as tcluster
from oncilla_tpu_torch.runtime import daemon as tdaemon_mod
from oncilla_tpu_torch.runtime import protocol as TP
from oncilla_tpu_torch.utils.config import OcmConfig as TConfig
from oncilla_tpu_torch.utils.debug import OpStats as TOpStats
from oncilla_tpu_torch.utils.debug import Tracer as TTracer
from test_torch_chaos import PortNative
from test_torch_daemon import PORT_DAEMON_MODULE, export_ref
from test_torch_mux import use_port_client
from test_torch_slo import port_cluster

RUN_OBS = [
    "test_ctx_encode_decode_roundtrip",
    "test_child_keeps_trace_id_and_parents",
    "test_use_ctx_nests_and_restores",
    "test_attach_split_roundtrip_small_and_vectored",
    "test_split_tolerates_short_tail",
    "test_gbps_unit_unified_between_snapshot_and_transfer_ring",
    "test_journal_ring_caps_and_orders",
    "test_journal_disabled_records_nothing_without_force",
    "test_journal_cap_env_knob_tolerates_garbage",
    "test_journal_ring_overflow_newest_n_under_concurrent_writers",
    "test_journal_jsonl_dump_load_roundtrip",
    "test_merge_dedupes_on_jid_seq",
    "test_chrome_trace_tracks_and_flows",
    "test_single_track_trace_has_no_flows",
    "test_hedge_and_cancel_lifecycles_stitched_as_flows",
    "test_lifecycle_summary_counted_in_write_chrome_trace",
    "test_end_to_end_trace_export",
    "test_trace_relay_stitches_alloc_hop",
    "test_v2_peer_declines_trace_by_silence",
    "test_trace_disabled_by_config_never_offers",
    "test_prom_render_validates",
    "test_prom_histogram_renders_with_exemplars",
    "test_merge_tiebreak_same_rank_same_millisecond",
    "test_prom_cli_endpoint_validates",
    "test_prom_cli_bad_rank",
    "test_cli_table_renders_every_rank",
    "test_cli_trace_merges_cluster_journals",
    "test_cli_watch_single_iteration",
    "test_cli_smoke_passes",
    "test_journal_records_lease_renew_and_reclaim",
    "test_slowop_flags_on_close",
    "test_slowop_watchdog_flags_open_span",
    "test_open_spans_tracked_only_under_threshold",
]

RUN_NATIVE = [
    "test_native_trace_capability_granted_and_one_trace_id",
    "test_obs_cli_degrades_gracefully_on_bad_msg",
]

export_ref(globals(), src, RUN_OBS)
export_ref(globals(), src_native, RUN_NATIVE)


@pytest.fixture(scope="module")
def binary():
    """The port's copy of the native daemon (a missing compiler raises)."""
    return tcluster.build_daemon()


@pytest.fixture(autouse=True)
def _port_obs(request, monkeypatch):
    module = request.function.__module__
    if module == src.__name__:
        for name, value in (
                ("export", texport), ("journal", tjournal), ("prom", tprom),
                ("obs_trace", ttrace), ("obs_main", tobs_main), ("P", TP),
                ("local_cluster", port_cluster),
                ("Daemon", tdaemon_mod.Daemon), ("OcmConfig", TConfig),
                ("OpStats", TOpStats), ("Tracer", TTracer),
                ("OcmKind", TKind)):
            monkeypatch.setattr(src, name, value)
        monkeypatch.setattr(jruntime_pkg, "daemon", PORT_DAEMON_MODULE)
    elif module == src_native.__name__:
        use_port_client(monkeypatch, src_native, native=PortNative,
                        journal=tjournal, export=texport)
        monkeypatch.setattr(jobs_main_mod, "main", tobs_main)


# -- the same inputs through both packages -----------------------------------


def seeded_events(seed: int) -> list[dict]:
    """Spans over four tracks (trace ids shared across tracks, some with
    no trace), journal instants, and hedge and cancel lifecycles, with
    colliding (jid, seq) duplicates."""
    rng = np.random.default_rng(seed)
    tracks = ["client", "daemon-r0", "daemon-r1", "pid77"]
    evs = []
    for i in range(60):
        tr = tracks[int(rng.integers(0, 4))]
        ts = 1000.0 + float(rng.uniform(0, 2))
        if rng.random() < 0.7:
            evs.append({"ev": "span", "ts": ts, "t_wall": ts,
                        "dur_us": float(rng.uniform(1, 500)), "track": tr,
                        "tid": int(rng.integers(1, 4)), "thread": "t",
                        "op": ("put", "get", "dcn_put_srv", "alloc")[i % 4],
                        "trace_id": int(rng.integers(0, 6)),
                        "span_id": i + 1,
                        "parent_span_id": int(rng.integers(0, i + 1)),
                        "jid": tr, "seq": i, "rank": i % 2})
        else:
            ev = ("lease_renew", "hedge_fired", "hedge_won", "hedge_lost",
                  "cancel_sent", "cancel_ack")[int(rng.integers(0, 6))]
            evs.append({"ev": ev, "ts": ts, "track": tr, "tid": 1,
                        "alloc_id": int(rng.integers(0, 3)),
                        "tag": int(rng.integers(0, 3)), "jid": tr, "seq": i})
    return evs


@pytest.mark.parametrize("seed", [0, 3, 8])
def test_merge_and_chrome_trace_equal_jax(seed):
    evs = seeded_events(seed)
    half = evs[::2]
    want = jexport.merge(evs, half)
    got = texport.merge(evs, half)
    assert got == want
    dump = lambda t: json.dumps(t, sort_keys=True)  # noqa: E731
    assert dump(texport.chrome_trace(got)) == dump(jexport.chrome_trace(want))
    trace = texport.chrome_trace(got)
    assert texport.cross_track_flows(trace) == jexport.cross_track_flows(trace)
    assert texport.lifecycle_flows(trace) == jexport.lifecycle_flows(trace)


def test_write_chrome_trace_file_equals_jax(tmp_path):
    evs = seeded_events(1)
    a, b = tmp_path / "j.json", tmp_path / "t.json"
    assert texport.write_chrome_trace(evs, str(b)) == \
        jexport.write_chrome_trace(evs, str(a))
    assert json.loads(b.read_text()) == json.loads(a.read_text())
