"""The port's flight recorder (``oncilla_tpu_torch/obs/flightrec.py``) and
the journal that streams into it, held against the JAX package's.

Source: ``tests/test_flightrec.py``. Each of its 16 tests is imported from
it and collected here as a case; an autouse fixture points the names the
source bound (``audit``, ``flightrec``, ``journal``) at the port's modules,
puts the port's ``Daemon`` in place (``test_torch_daemon.patch_ref``: the
JAX cluster's daemons are the port's, so their kill spills the port's ring)
and the port's ``ChaosController``/``ChaosSchedule`` where the source
imports them from (``oncilla_tpu.resilience.chaos``, by
``test_torch_daemon.use_port_chaos``). Nothing in
``oncilla_tpu/`` or the JAX tests changes.

Added here:

- the repro of the port's silent ``OCM_FLIGHTREC``: with the variable set
  before import, ``record("daemon_kill", rank=1)`` then
  ``spill_ring("kill-r1")`` leave the same two segments in either package
  (names and events equal but for the journal's identity and clocks);
- each package's reader and auditor read the other's segments, with equal
  events and stats and zero findings on a clean timeline, and both find a
  seeded violation the other wrote;
- a killed port daemon (``InProcessCluster.kill``) leaves a ``kill-r<rank>``
  segment holding its ``daemon_kill``;
- ``journal.dump`` / ``load_jsonl`` against the JAX journal's.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import test_flightrec as src
from oncilla_tpu.obs import audit as jaudit
from oncilla_tpu.obs import flightrec as jflightrec
from oncilla_tpu.obs import journal as jjournal
from oncilla_tpu_torch.core.kinds import OcmKind
from oncilla_tpu_torch.obs import audit as taudit
from oncilla_tpu_torch.obs import flightrec as tflightrec
from oncilla_tpu_torch.obs import journal as tjournal
from oncilla_tpu_torch.runtime.cluster import inprocess_cluster
from oncilla_tpu_torch.utils.config import OcmConfig
from test_torch_daemon import export_ref, patch_ref

ROOT = Path(__file__).resolve().parents[1]

RUN = [
    "test_stream_spills_every_event",
    "test_segment_rotation_stays_bounded",
    "test_max_segs_rotation_caps_directory",
    "test_max_segs_never_touches_other_writers_segments",
    "test_two_writer_dir_rotation_deletes_only_owners_oldest",
    "test_seg_bytes_env_knob_tolerates_garbage",
    "test_max_segs_env_knob_tolerates_garbage",
    "test_ring_overflow_spill_keeps_full_stream",
    "test_ring_dump_dedups_against_stream",
    "test_crc_corruption_is_reported_not_skipped",
    "test_torn_tail_is_tolerated_crash_evidence",
    "test_bad_magic_is_reported",
    "test_daemon_kill_flushes_ring_to_spill",
    "test_chaos_controller_snapshots_victim_ring",
    "test_env_var_dir_is_created_lazily",
    "test_spill_unconfigured_is_free",
]

export_ref(globals(), src, RUN)


@pytest.fixture(autouse=True)
def _port_recorder(request, monkeypatch):
    if request.function.__module__ != src.__name__:
        return
    patch_ref(monkeypatch, src, audit=taudit, flightrec=tflightrec,
              journal=tjournal)


# -- the repro: OCM_FLIGHTREC set, a kill recorded and the ring spilled ----

_REPRO = """
import sys
from {pkg}.obs import journal
journal.record("daemon_kill", rank=1)
print(journal.spill_ring("kill-r1"))
print(journal.jid())
"""

# What differs between two journals by construction: identity and clocks.
_VOLATILE = ("jid", "ts", "mono", "pid", "tid")


def _repro(pkg: str, d: Path) -> tuple[str, str]:
    env = {**os.environ, "OCM_FLIGHTREC": str(d), "JAX_PLATFORMS": "cpu"}
    env.pop("OCM_EVENTS", None)
    out = subprocess.run([sys.executable, "-c", _REPRO.format(pkg=pkg)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120, check=True).stdout.split()
    return out[-2], out[-1]


def _stable(events: list[dict]) -> list[dict]:
    return [{k: v for k, v in e.items() if k not in _VOLATILE} for e in events]


def test_queue_c_repro_same_segments_as_jax(tmp_path):
    """``OCM_FLIGHTREC=<dir>``, ``record("daemon_kill", rank=1)``,
    ``spill_ring("kill-r1")``: the port's journal leaves the JAX journal's
    two segments (the stream and the labelled ring dump), where it used to
    leave none and return None."""
    got = {}
    for pkg in ("oncilla_tpu", "oncilla_tpu_torch"):
        d = tmp_path / pkg
        path, jid = _repro(pkg, d)
        names = sorted(os.listdir(d))
        assert path == str(d / f"fr-{jid}-kill-r1-00002.seg")
        got[pkg] = {
            "names": [n.replace(jid, "J") for n in names],
            "segments": [_stable(jflightrec.read_segment(str(d / n))[0])
                         for n in names],
        }
        for reader in (jflightrec, tflightrec):
            evs, problems = reader.read_dir(str(d))
            assert problems == []
            assert [e["ev"] for e in evs] == ["daemon_kill"]  # deduped
    assert got["oncilla_tpu"]["names"] == ["fr-J-00001.seg",
                                           "fr-J-kill-r1-00002.seg"]
    assert got["oncilla_tpu_torch"] == got["oncilla_tpu"]
    assert got["oncilla_tpu"]["segments"][0] == [
        {"ev": "daemon_kill", "thread": "MainThread", "rank": 1, "seq": 1}]


# -- each package reads and audits the other's segments --------------------


def _clean_timeline(journal, rank: int):
    mig = dict(track=f"daemon-r{rank}", alloc_id=rank + 1, src=rank,
               target=rank + 1, epoch=1)
    journal.record("span", op="put", track="client")
    journal.record("migrate_start", **mig)
    journal.record("migrate_flip", **mig)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_auditors_read_each_others_segments(tmp_path, writer):
    """One package records a clean timeline (and another's journal a second
    process's worth in the same directory): both readers merge the same
    events and both auditors find nothing; a seeded epoch regression that
    the writer dumps is found by both, with the same finding."""
    w_flightrec, w_journal = ((jflightrec, jjournal) if writer == "jax"
                              else (tflightrec, tjournal))
    o_flightrec, o_journal = ((tflightrec, tjournal) if writer == "jax"
                              else (jflightrec, jjournal))
    d = str(tmp_path / "clean")
    with w_flightrec.recording(d), o_flightrec.recording(d):
        _clean_timeline(w_journal, 0)
        _clean_timeline(o_journal, 1)
    assert w_journal.jid() != o_journal.jid()
    jevs, jprob = jflightrec.read_dir(d)
    tevs, tprob = tflightrec.read_dir(d)
    assert jprob == tprob == []
    key = lambda e: (e["jid"], e["seq"])  # noqa: E731
    assert sorted(jevs, key=key) == sorted(tevs, key=key)
    assert len(tevs) == 6
    jf, jst = jaudit.audit_dir(d)
    tf, tst = taudit.audit_dir(d)
    assert jf == [] and tf == []
    assert jst == tst and jst["processes"] == 2

    bad = str(tmp_path / "bad")
    prev = w_flightrec.segment_dir()
    w_flightrec.set_dir(bad)
    try:
        w_flightrec.dump_events([
            {"ev": "member_join", "ts": 1.0, "jid": "j1", "seq": 1,
             "track": "daemon-r0", "rank": 1, "epoch": 4},
            {"ev": "fenced", "ts": 2.0, "jid": "j1", "seq": 2,
             "track": "daemon-r0", "rank": 0, "epoch": 1},
        ], label="seeded")
    finally:
        w_flightrec.set_dir(prev)
    jf, _ = jaudit.audit_dir(bad)
    tf, _ = taudit.audit_dir(bad)
    assert [f.rule for f in tf] == [f.rule for f in jf] == ["epoch-monotonic"]
    assert [f.render() for f in tf] == [f.render() for f in jf]


def test_killed_port_daemon_leaves_its_kill_segment(tmp_path):
    """``Daemon.kill`` spills the port's ring: the killed rank's
    ``kill-r<rank>`` segment holds its ``daemon_kill`` and its serve spans,
    and the timeline audits clean."""
    d = str(tmp_path / "fr")
    cfg = OcmConfig(host_arena_bytes=8 << 20, device_arena_bytes=1 << 20,
                    chunk_bytes=128 << 10, heartbeat_s=5.0)
    with tflightrec.recording(d):
        with inprocess_cluster(2, config=cfg) as cl:
            client = cl.client(0, heartbeat=False)
            h = client.alloc(1 << 20, OcmKind.REMOTE_HOST)
            client.put(h, np.arange(1 << 20, dtype=np.uint8), 0)
            victim = h.rank
            cl.kill(victim)
    names = [n for n in os.listdir(d) if re.match(
        rf"fr-{re.escape(tjournal.jid())}-kill-r{victim}-\d{{5}}\.seg$", n)]
    assert len(names) == 1, os.listdir(d)
    evs, problems = tflightrec.read_segment(os.path.join(d, names[0]))
    assert problems == []
    assert [e["rank"] for e in evs if e["ev"] == "daemon_kill"] == [victim]
    assert any(e.get("track") == f"daemon-r{victim}" and e["ev"] == "span"
               for e in evs)
    findings, stats = taudit.audit_dir(d)
    assert findings == [], [f.render() for f in findings]
    assert victim in stats["ranks"]


def test_journal_dump_and_load_jsonl_match_jax(tmp_path):
    """``dump`` writes the ring as JSONL that either package's
    ``load_jsonl`` reads back; a malformed line raises in both."""
    was = tjournal.enabled()
    tjournal.set_enabled(True)
    tjournal.clear()
    try:
        for i in range(5):
            tjournal.record("span", op=f"d{i}", nbytes=i)
        path = str(tmp_path / "ring.jsonl")
        assert tjournal.dump(path) == 5
    finally:
        tjournal.set_enabled(was)
        tjournal.clear()
    got = tjournal.load_jsonl(path)
    assert got == jjournal.load_jsonl(path)
    assert [e["op"] for e in got] == [f"d{i}" for i in range(5)]
    assert tjournal.dump_jsonl(got) == jjournal.dump_jsonl(got)
    with open(path, "a", encoding="utf-8") as fh:
        fh.write("{not json\n")
    for journal in (tjournal, jjournal):
        with pytest.raises(json.JSONDecodeError):
            journal.load_jsonl(path)
