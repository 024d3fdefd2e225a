"""The port's critical-path attribution (``oncilla_tpu_torch/obs/
critpath.py``) and ``python -m oncilla_tpu_torch.obs critpath``, held to the
JAX package's own tests of them.

Source: ``tests/test_critpath.py``. Each of its tests (13 cases) is
imported from it and collected here as a case; an autouse fixture points
the names the source bound at the port: ``critpath``, ``flightrec`` and
``journal`` are the port's modules, ``obs_main`` the port's CLI entry,
``OcmConfig`` and ``OcmKind`` the port's types and ``local_cluster``
``test_torch_slo.port_cluster`` (the port's in-process daemons, clients and
contexts). Nothing in ``oncilla_tpu/`` or the JAX tests changes.

Added here: ``assemble``, ``phase_table`` and ``render_report`` of the same
seeded span streams equal the JAX package's (tolerance 0), and ``critpath
--require-cross-rank`` as a process exits 0 on a recorded cross-rank
stream and 1 on a one-track one.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import test_critpath as src
from oncilla_tpu.obs import critpath as jcritpath
from oncilla_tpu_torch.core.kinds import OcmKind as TKind
from oncilla_tpu_torch.obs import critpath as tcritpath
from oncilla_tpu_torch.obs import flightrec as tflightrec
from oncilla_tpu_torch.obs import journal as tjournal
from oncilla_tpu_torch.obs.__main__ import main as tobs_main
from oncilla_tpu_torch.utils.config import OcmConfig as TConfig
from test_torch_daemon import export_ref
from test_torch_slo import port_cluster

ROOT = Path(__file__).resolve().parents[1]

RUN = [
    "test_single_span_attributes_to_own_op",
    "test_child_carves_self_time_and_both_ops_attributed",
    "test_phases_carve_named_slices_out_of_self_time",
    "test_overclaiming_phases_scaled_never_inflate",
    "test_clock_skew_child_clamped_into_parent",
    "test_orphan_parent_becomes_root_and_priorities_collected",
    "test_trees_sorted_by_wall_time_and_zero_duration_skipped",
    "test_phase_table_groups_by_op_and_priority",
    "test_render_report_handles_empty_stream",
    "test_load_events_merges_segments_and_jsonl",
    "test_cli_gates_pass_and_fail",
    "test_cli_json_output",
    "test_real_traffic_builds_cross_rank_trees_95pct_attributed",
]

export_ref(globals(), src, RUN)


@pytest.fixture(autouse=True)
def _port_critpath(request, monkeypatch):
    if request.function.__module__ != src.__name__:
        return
    for name, value in (("critpath", tcritpath), ("flightrec", tflightrec),
                        ("journal", tjournal), ("obs_main", tobs_main),
                        ("local_cluster", port_cluster),
                        ("OcmConfig", TConfig), ("OcmKind", TKind)):
        monkeypatch.setattr(src, name, value)


def seeded_stream(seed: int) -> list[dict]:
    """Span trees over three tracks with phases, orphans, priorities,
    clock skew and zero-length spans, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    evs, seq = [], 0
    for trace in range(1, 25):
        t0 = 100.0 + trace
        dur = float(rng.uniform(0.001, 0.05))
        prio = int(rng.integers(0, 3))
        parent = 0 if rng.random() > 0.1 else 999  # some orphans
        seq += 1
        evs.append({"ev": "span", "op": ("dcn_put", "dcn_get")[trace % 2],
                    "ts": t0, "t_wall": t0, "dur_us": dur * 1e6,
                    "trace_id": trace, "span_id": 1,
                    "parent_span_id": parent, "track": "client",
                    "priority": prio, "jid": "c", "seq": seq})
        for k in range(int(rng.integers(0, 3))):
            seq += 1
            cdur = float(rng.uniform(0.0, dur))  # may be 0, may overrun
            evs.append({"ev": "span", "op": f"srv{k}",
                        "ts": t0 + float(rng.uniform(0, dur)),
                        "t_wall": t0 + float(rng.uniform(0, dur)),
                        "dur_us": cdur * 1e6, "trace_id": trace,
                        "span_id": 2 + k, "parent_span_id": 1,
                        "track": f"daemon-r{k}", "jid": f"d{k}", "seq": seq})
        for name in ("client_queue", "daemon_queue")[: int(rng.integers(0, 3))]:
            seq += 1
            evs.append({"ev": "phase", "phase": name, "ts": 0.0,
                        "dur_us": float(rng.uniform(0, dur)) * 1e6,
                        "trace_id": trace, "span_id": 1, "priority": prio,
                        "jid": "c", "seq": seq})
    return evs


@pytest.mark.parametrize("seed", [0, 5, 11])
def test_assemble_and_phase_table_equal_jax(seed):
    evs = seeded_stream(seed)
    want = jcritpath.assemble([dict(e) for e in evs])
    got = tcritpath.assemble([dict(e) for e in evs])
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert tcritpath.phase_table(got) == jcritpath.phase_table(want)
    assert tcritpath.render_report(got) == jcritpath.render_report(want)


def test_cli_require_cross_rank_as_a_process(tmp_path):
    """``python -m oncilla_tpu_torch.obs critpath F --require-cross-rank``
    exits 0 on a stream whose trees cross tracks and 1 on one that does
    not."""
    evs = seeded_stream(0)
    cross = tmp_path / "cross.jsonl"
    cross.write_text(tjournal.dump_jsonl(evs))
    solo = tmp_path / "solo.jsonl"
    solo.write_text(tjournal.dump_jsonl(
        [e for e in evs if e.get("track", "client") == "client"]))

    def run(path):
        return subprocess.run(
            [sys.executable, "-m", "oncilla_tpu_torch.obs", "critpath",
             str(path), "--require-cross-rank"],
            cwd=ROOT, capture_output=True, text=True, timeout=120)

    ok = run(cross)
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert "cross-rank" in ok.stdout
    assert run(solo).returncode == 1
