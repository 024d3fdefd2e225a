"""The port's post-mortem auditor (``oncilla_tpu_torch/obs/audit.py``) held
to the JAX package's own tests of its auditor.

Source: ``tests/test_audit.py``. Each of its tests (27 cases) is imported
from it and collected here as a case; an autouse fixture points the names
the source bound at the port: ``audit``, ``flightrec`` and ``journal`` are
the port's modules, and ``obs_main`` (the JAX ``python -m oncilla_tpu.obs``
entry) runs the port's ``audit.main`` for its ``audit`` subcommand. Nothing
in ``oncilla_tpu/`` or the JAX tests changes.

Added here: the port's invariant registry is the JAX package's, rule for
rule, and ``python -m oncilla_tpu_torch.obs.audit`` as a process exits as
the in-process entry does.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

import test_audit as src
from oncilla_tpu.obs import audit as jaudit
from oncilla_tpu_torch.obs import audit as taudit
from oncilla_tpu_torch.obs import flightrec as tflightrec
from oncilla_tpu_torch.obs import journal as tjournal
from test_torch_daemon import export_ref

ROOT = Path(__file__).resolve().parents[1]

RUN = [
    "test_epoch_regression_is_caught",
    "test_epoch_advance_and_cross_rank_skew_are_clean",
    "test_migrate_abort_begin_epoch_is_exempt",
    "test_migration_flip_pairs_cleanly",
    "test_unterminated_migration_is_caught",
    "test_flip_and_abort_both_firing_is_caught",
    "test_orphan_terminal_is_caught",
    "test_double_abort_from_both_ends_is_clean",
    "test_ack_before_fanout_is_caught",
    "test_fanout_then_ack_is_clean",
    "test_unreplicated_ack_needs_no_fanout",
    "test_seq_order_wins_over_colliding_wall_clock",
    "test_unterminated_lease_chain_is_caught",
    "test_each_terminal_closes_the_lease_chain",
    "test_active_high_priority_eviction_is_caught",
    "test_low_or_expired_evictions_are_clean",
    "test_post_fence_ack_is_caught",
    "test_other_ranks_keep_acking_after_a_fence",
    "test_gap_in_spilled_stream_is_caught",
    "test_finding_render_carries_rule_rank_and_refs",
    "test_cli_catches_seeded_epoch_violation",
    "test_cli_clean_timeline_exits_zero",
    "test_cli_no_segments_is_usage_error",
    "test_cli_json_output",
    "test_audit_tree_keeps_timelines_separate",
    "test_recorded_raises_on_violation",
    "test_recorded_clean_run_reports_stats",
]

export_ref(globals(), src, RUN)


def port_obs_main(argv: list[str]) -> int:
    """The JAX CLI's ``audit`` subcommand, served by the port's entry."""
    if not argv or argv[0] != "audit":
        raise AssertionError(f"only the audit subcommand is ported: {argv}")
    return taudit.main(argv[1:])


@pytest.fixture(autouse=True)
def _port_auditor(request, monkeypatch):
    if request.function.__module__ != src.__name__:
        return
    for name, value in (("audit", taudit), ("flightrec", tflightrec),
                        ("journal", tjournal), ("obs_main", port_obs_main)):
        monkeypatch.setattr(src, name, value)


def test_invariant_registry_is_the_jax_packages():
    assert [r for r, _ in taudit.CHECKS] == [r for r, _ in jaudit.CHECKS]
    assert taudit.EPOCH_EVENTS == jaudit.EPOCH_EVENTS


def test_cli_as_a_process(tmp_path):
    """``python -m oncilla_tpu_torch.obs.audit <dir>``: 2 without segments,
    1 on a seeded violation, 0 on a clean timeline."""
    def run(d):
        return subprocess.run(
            [sys.executable, "-m", "oncilla_tpu_torch.obs.audit", str(d)],
            cwd=ROOT, capture_output=True, text=True, timeout=120)

    assert run(tmp_path).returncode == 2
    prev = tflightrec.segment_dir()
    try:
        tflightrec.set_dir(str(tmp_path / "bad"))
        tflightrec.dump_events([
            {"ev": "migrate_flip", "ts": 1.0, "jid": "j1", "seq": 1,
             "track": "daemon-r1", "alloc_id": 7, "src": 1, "target": 2,
             "epoch": 1}], label="seeded")
        tflightrec.set_dir(str(tmp_path / "clean"))
        tflightrec.dump_events([
            {"ev": "span", "ts": 1.0, "jid": "j2", "seq": 1, "op": "put",
             "track": "client"}], label="seeded")
    finally:
        tflightrec.set_dir(prev)
    bad = run(tmp_path / "bad")
    assert bad.returncode == 1 and "[migrate-pairing]" in bad.stdout
    clean = run(tmp_path / "clean")
    assert clean.returncode == 0 and "clean" in clean.stdout
    assert os.path.isdir(tmp_path / "clean")
