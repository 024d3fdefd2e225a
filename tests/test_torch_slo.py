"""The port's metrics history and SLO engine (``oncilla_tpu_torch/obs/
scrape.py``, ``obs/slo.py``) and the client's SLO watcher
(``Ocm.start_slo``), held to the JAX package's own tests of them.

Source: ``tests/test_slo.py``. Each of its tests (23 cases) is imported
from it and collected here as a case; an autouse fixture points the names
the source bound at the port: ``journal``, ``prom``, ``scrape`` and
``slo`` are the port's modules, ``OcmConfig`` and ``OcmKind`` the port's
types, and ``local_cluster`` is :func:`port_cluster`, the port's
``inprocess_cluster`` with its contexts on the CPU (the JAX package's
in-process cluster). The serving case's ``ServingStats`` (imported inside
the test) is the port's. Nothing in ``oncilla_tpu/`` or the JAX tests
changes.

Added here: the same inputs through both packages give equal outputs
(tolerance 0): ``parse_samples`` of a fixed exposition, and
``SloEngine.evaluate`` and ``render_prom`` over the same seeded histories.
"""

from contextlib import contextmanager

import numpy as np
import pytest

import oncilla_tpu.serving.metrics as jmetrics
import test_slo as src
from oncilla_tpu.obs import journal as jjournal
from oncilla_tpu.obs import scrape as jscrape
from oncilla_tpu.obs import slo as jslo
from oncilla_tpu_torch.core.kinds import OcmKind as TKind
from oncilla_tpu_torch.obs import journal as tjournal
from oncilla_tpu_torch.obs import prom as tprom
from oncilla_tpu_torch.obs import scrape as tscrape
from oncilla_tpu_torch.obs import slo as tslo
from oncilla_tpu_torch.runtime.cluster import InProcessCluster
from oncilla_tpu_torch.serving.metrics import ServingStats as TServingStats
from oncilla_tpu_torch.utils.config import OcmConfig as TConfig
from test_torch_daemon import export_ref, port_config

RUN = [
    "test_parse_samples_roundtrip_with_labels_and_exemplars",
    "test_parse_samples_rejects_malformed_exposition",
    "test_scrape_interval_env_tolerant",
    "test_delta_and_rate_windowed",
    "test_delta_is_counter_reset_aware",
    "test_delta_aggregates_across_label_sets_with_subset_match",
    "test_ring_cap_keeps_newest",
    "test_hist_quantile_from_windowed_bucket_deltas",
    "test_scraper_poll_once_counts_fetch_errors",
    "test_default_objectives_scale_with_budget",
    "test_load_spec_env_shapes",
    "test_unknown_objective_kind_rejected",
    "test_engine_healthy_green_with_idle_objectives_ok",
    "test_engine_burn_requires_both_windows",
    "test_engine_burn_and_recovery_journal_events",
    "test_availability_objective_counts_typed_errors",
    "test_throughput_objective_idle_vs_starved",
    "test_render_prom_validates_and_carries_verdicts",
    "test_runner_injects_extra_samples",
    "test_client_slo_watcher_surfaces_in_status",
    "test_slo_disabled_by_env",
    "test_seeded_slow_handler_trips_burn",
    "test_serving_ttft_histogram_renders_and_validates",
]

export_ref(globals(), src, RUN)


class CpuCluster(InProcessCluster):
    """The port's in-process cluster whose contexts hold their device arm
    on the CPU, as a JAX test's contexts do."""

    def context(self, rank: int, ici_plane=None, device="cpu", **kw):
        return super().context(rank, ici_plane=ici_plane, device=device, **kw)


@contextmanager
def port_cluster(n: int, config=None, **kw):
    """``oncilla_tpu.runtime.cluster.local_cluster`` for a JAX test: the
    port's daemons, clients and contexts in this process."""
    c = CpuCluster(n, config=port_config(config), **kw)
    try:
        yield c
    finally:
        c.stop()


@pytest.fixture(autouse=True)
def _port_slo(request, monkeypatch):
    if request.function.__module__ != src.__name__:
        return
    for name, value in (("journal", tjournal), ("prom", tprom),
                        ("scrape", tscrape), ("slo", tslo),
                        ("local_cluster", port_cluster),
                        ("OcmConfig", TConfig), ("OcmKind", TKind)):
        monkeypatch.setattr(src, name, value)
    monkeypatch.setattr(jmetrics, "ServingStats", TServingStats)


# -- the same inputs through both packages -----------------------------------

EXPOSITION = """\
# HELP ocm_op_total ops
# TYPE ocm_op_total counter
ocm_op_total{rank="0",op="dcn_put"} 7
ocm_op_total{rank="1",op="dcn_get",note="a \\"quoted\\" \\\\ back\\nslash"} 3.5
# HELP ocm_op_latency_seconds lat
# TYPE ocm_op_latency_seconds histogram
ocm_op_latency_seconds_bucket{rank="0",op="dcn_put",le="0.005"} 5 # {trace_id="00ff"} 0.004 1.0
ocm_op_latency_seconds_bucket{rank="0",op="dcn_put",le="+Inf"} 9
ocm_op_latency_seconds_sum{rank="0",op="dcn_put"} 0.25
ocm_op_latency_seconds_count{rank="0",op="dcn_put"} 9
# HELP ocm_arena_bytes gauge
# TYPE ocm_arena_bytes gauge
ocm_arena_bytes 1.5e6
"""


def test_parse_samples_equals_jax():
    assert tscrape.parse_samples(EXPOSITION) == jscrape.parse_samples(EXPOSITION)


def _feed(mod, rng) -> object:
    """A seeded history: cumulative latency buckets per priority class,
    op and error counters, serving TTFT buckets and decode tokens, one
    scrape every 2 s for 60 s, with a counter reset half way."""
    h = mod.MetricsHistory()
    cum = {}
    for step in range(31):
        ts = 2.0 * step
        if step == 15:
            cum = {}  # a daemon restart: every counter starts over
        out = []

        def add(fam, name, labels, inc):
            key = (name, tuple(sorted(labels.items())))
            cum[key] = cum.get(key, 0) + inc
            out.append((fam, name, dict(labels), float(cum[key])))

        for prio in ("0", "1", "2"):
            fast, slow = rng.integers(0, 50), rng.integers(0, 6)
            fam = "ocm_op_latency_seconds"
            base = {"rank": "0", "priority": prio}
            add(fam, fam + "_bucket", {**base, "le": "0.001"}, fast)
            add(fam, fam + "_bucket", {**base, "le": "0.25"},
                fast + slow // 2)
            add(fam, fam + "_bucket", {**base, "le": "+Inf"}, fast + slow)
        add("ocm_op_total", "ocm_op_total", {"rank": "0", "op": "dcn_put"},
            rng.integers(50, 200))
        add("ocm_backpressure_busy_total", "ocm_backpressure_busy_total",
            {"rank": "0"}, rng.integers(0, 3))
        fam = "ocm_serving_ttft_seconds"
        for le, n in (("0.5", rng.integers(0, 4)), ("+Inf", 4)):
            add(fam, fam + "_bucket", {"rank": "0", "le": le}, n)
        add("ocm_serving_tokens_total", "ocm_serving_tokens_total",
            {"rank": "0", "phase": "decode"}, rng.integers(0, 40))
        h.observe_samples(out, ts=ts)
    return h


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_evaluate_equals_jax(seed):
    was = (jjournal.enabled(), tjournal.enabled())
    jjournal.set_enabled(True)
    tjournal.set_enabled(True)
    try:
        engines = []
        for mod, slo_mod in ((jscrape, jslo), (tscrape, tslo)):
            hist = _feed(mod, np.random.default_rng(seed))
            engines.append(slo_mod.SloEngine(
                hist, slo_mod.default_objectives(budget_s=0.5),
                fast_s=10.0, slow_s=40.0))
        for now in (10.0, 30.0, 60.0):
            want, got = (e.evaluate(now=now) for e in engines)
            assert got == want
        assert engines[1].render_prom(1) == engines[0].render_prom(1)
        for q in (0.5, 0.99):
            assert engines[1].history.hist_quantile(
                "ocm_op_latency_seconds", q, 40.0, now=60.0) == \
                engines[0].history.hist_quantile(
                    "ocm_op_latency_seconds", q, 40.0, now=60.0)
    finally:
        jjournal.set_enabled(was[0])
        tjournal.set_enabled(was[1])
