"""The port's wire-conformance analyzer
(``oncilla_tpu_torch.analysis.conformance``), the JAX package's
tests/test_conformance.py on the port: both extractors against the
port's ``runtime/`` and its copy of the native daemon, the six deliberate
C++ mutations each producing exactly its expected finding, the fencing
classification, the audit↔journal cross-reference in both directions,
and the generated capability matrix byte-matching
``oncilla_tpu_torch/docs/ARCHITECTURE.md``."""

from pathlib import Path

import pytest

from oncilla_tpu_torch.analysis import conformance as C

NATIVE = Path(C._ROOT) / "oncilla_tpu_torch" / "runtime" / "native"


@pytest.fixture(scope="module")
def py():
    return C.extract_python()


@pytest.fixture(scope="module")
def nat():
    return C.extract_native()


def _mutated_native(tmp_path, fname, old, new):
    """Copy the three native sources into tmp_path with ONE mutation
    applied — built from the live files so the tests can never drift
    from the tree they guard."""
    for f in ("protocol.hh", "protocol.cc", "daemon.cc"):
        src = (NATIVE / f).read_text()
        if f == fname:
            assert old in src, f"mutation anchor missing from {f}: {old!r}"
            src = src.replace(old, new, 1)
        (tmp_path / f).write_text(src)
    return str(tmp_path)


# -- extractors against the real tree ------------------------------------


def test_native_extractor_parses_real_surface(nat):
    assert not nat.problems, nat.problems
    assert nat.msg_values["CONNECT"] == 1 and nat.msg_values["ERR"] == 99
    assert set(nat.schemas) == set(nat.msg_values)
    assert {"DATA_PUT", "DATA_GET", "CONNECT", "STATUS_PROM"} <= set(
        nat.dispatch
    )
    # The srv_op_name stage-name switch also contains `case MsgType::`
    # labels — the extractor must bound itself to dispatch() (the stage
    # switch names reply types like ALLOC_RESULT that dispatch never
    # cases on).
    assert "ALLOC_RESULT" not in nat.dispatch
    assert nat.caps_implemented == (
        nat.flag_values["kFlagCapCoalesce"] | nat.flag_values["kFlagCapTrace"]
    )
    assert nat.trace_gated  # OCM_NATIVE_OBS=0 drops the trace grant


def test_python_extractor_grant_sites(py):
    # Unconditional grants plus the two gated ones, straight from the
    # _on_connect AST.
    assert py.granted["FLAG_CAP_COALESCE"] == ""
    assert py.granted["FLAG_CAP_TRACE"] == ""
    assert "mux_serve" in py.granted["FLAG_CAP_MUX"]
    assert py.granted["FLAG_CAP_FABRIC"] != ""


def test_conformance_clean_on_tree():
    fs = [f for f in C.check_conformance() if f.rule not in C.INFO_RULES]
    assert fs == [], [f.render() for f in fs]


# -- the six C++ mutations (each: exactly the expected finding) ----------


def _parity(tmp_path, py, fname, old, new):
    nat = C.extract_native(_mutated_native(tmp_path, fname, old, new))
    return C.check_native_parity(py, nat)


def test_mutation_removed_enum_member(tmp_path, py):
    # ALLOC_PLACED vanishes from the enum; its schema entry is now an
    # orphan referencing a nonexistent member.
    fs = _parity(tmp_path, py, "protocol.hh", "  ALLOC_PLACED = 13,\n", "")
    assert [f.rule for f in fs] == ["native-enum-drift"], fs
    assert "ALLOC_PLACED" in fs[0].message
    assert "enum does not define" in fs[0].message


def test_mutation_enum_value_drift(tmp_path, py):
    fs = _parity(tmp_path, py, "protocol.hh",
                 "DATA_GET = 32,", "DATA_GET = 37,")
    assert [f.rule for f in fs] == ["native-enum-drift"], fs
    assert "different wire byte" in fs[0].message


def test_mutation_grant_of_unimplemented_cap(tmp_path, py):
    # caps_mask_ gains kFlagTraceCtx — a defined flag bit that is NOT a
    # capability this build implements.
    old = "caps_mask_ = kFlagCapCoalesce | (obs_enabled_ ? kFlagCapTrace : 0);"
    new = ("caps_mask_ = kFlagCapCoalesce | kFlagTraceCtx | "
           "(obs_enabled_ ? kFlagCapTrace : 0);")
    fs = _parity(tmp_path, py, "daemon.cc", old, new)
    assert [f.rule for f in fs] == ["native-caps-overgrant"], fs
    assert "0x0008" in fs[0].message


def test_mutation_flag_value_drift(tmp_path, py):
    fs = _parity(tmp_path, py, "protocol.hh",
                 "kFlagCapTrace = 0x0004;", "kFlagCapTrace = 0x0040;")
    assert [f.rule for f in fs] == ["flag-parity"], fs
    assert "FLAG_CAP_TRACE" in fs[0].message


def test_mutation_dispatch_case_deleted(tmp_path, py):
    fs = _parity(
        tmp_path, py, "daemon.cc",
        "      case MsgType::DATA_GET: return on_data_get(c, m);\n", "",
    )
    assert [f.rule for f in fs] == ["native-dispatch-gap"], fs
    assert "DATA_GET" in fs[0].message and "BAD_MSG" in fs[0].message


def test_mutation_schema_field_drift(tmp_path, py):
    old = ('{MsgType::DATA_GET, {{"alloc_id", \'Q\'}, {"offset", \'Q\'}, '
           '{"nbytes", \'Q\'}}},')
    new = ('{MsgType::DATA_GET, {{"alloc_id", \'I\'}, {"offset", \'Q\'}, '
           '{"nbytes", \'Q\'}}},')
    fs = _parity(tmp_path, py, "protocol.cc", old, new)
    assert [f.rule for f in fs] == ["native-schema-drift"], fs
    assert "DATA_GET" in fs[0].message


# -- fencing classification ----------------------------------------------


def test_plane_types_fenced_regression(py):
    """The finding this family shipped with: a fenced daemon must not
    relay device-plane ops (same split-brain as DATA_*)."""
    from oncilla_tpu_torch.runtime import daemon as D
    from oncilla_tpu_torch.runtime.protocol import MsgType

    for t in (MsgType.PLANE_SERVE, MsgType.PLANE_PUT,
              MsgType.PLANE_GET, MsgType.PLANE_SCRUB):
        assert t in D._FENCED_REJECT, f"{t.name} not fenced"
    assert C.check_fenced(py) == []


def test_fenced_gap_detected(monkeypatch):
    from oncilla_tpu_torch.runtime import daemon as D
    from oncilla_tpu_torch.runtime.protocol import MsgType

    monkeypatch.setattr(
        D, "_FENCED_REJECT", D._FENCED_REJECT - {MsgType.DATA_PUT}
    )
    fs = C.check_fenced(C.extract_python())
    assert [f.rule for f in fs] == ["fenced-reject-gap"], fs
    assert "DATA_PUT" in fs[0].message


def test_unclassified_request_type_detected(py):
    # A request type the fencing table has never heard of must fail the
    # gate until someone classifies it.
    py2 = C.PySurface(**vars(py))
    py2.msg_values = dict(py.msg_values, NEW_THING=98)
    fs = C.check_fenced(py2)
    assert [f.rule for f in fs] == ["fenced-reject-gap"], fs
    assert "not classified" in fs[0].message


# -- audit <-> journal cross-reference (both directions) -----------------


def test_cross_reference_both_directions():
    fs = C.cross_reference_events(
        consumed={"real_ev", "ghost_ev"},
        emitted={"real_ev": ("a.py", 1), "dead_ev": ("b.py", 2)},
    )
    by_rule = {f.rule: f for f in fs}
    assert set(by_rule) == {"audit-event-unemitted", "journal-event-unchecked"}
    assert by_rule["audit-event-unemitted"].symbol == "ghost_ev"
    assert by_rule["journal-event-unchecked"].symbol == "dead_ev"
    assert by_rule["journal-event-unchecked"].path == "b.py"


def test_audit_events_all_emitted_on_tree():
    fs = C.check_audit_events()
    fatal = [f for f in fs if f.rule == "audit-event-unemitted"]
    assert fatal == [], [f.render() for f in fatal]
    # The reverse direction exists and is info-level: dead telemetry is
    # visible, never fatal.
    assert any(f.rule == "journal-event-unchecked" for f in fs)
    assert C.INFO_RULES == {"journal-event-unchecked"}


def test_consumed_event_extraction_patterns():
    src = (
        "EPOCH = frozenset({'fenced', 'member_join'})\n"
        "def chk(events):\n"
        "    for e in events:\n"
        "        ev = e.get('ev')\n"
        "        if ev == 'put_ack':\n"
        "            pass\n"
        "        elif ev in ('lease_renew', 'qos_evict'):\n"
        "            pass\n"
        "        if e.get('ev') not in EPOCH:\n"
        "            pass\n"
        "        if 'epoch' not in e:\n"  # not an event-name compare
        "            pass\n"
    )
    assert C._consumed_events(src) == {
        "fenced", "member_join", "put_ack", "lease_renew", "qos_evict",
    }


# -- the generated capability matrix -------------------------------------


def test_matrix_byte_matches_architecture_md(py, nat):
    """The acceptance criterion verbatim: derived block == checked-in
    block."""
    assert C.check_matrix(py, nat) == []


def test_matrix_drift_detected(tmp_path, py, nat):
    docs = tmp_path / "oncilla_tpu_torch" / "docs"
    docs.mkdir(parents=True)
    stale = C.render_matrix(C.matrix_data(py, nat)).replace(
        "| `CONNECT` (1) | served | served |",
        "| `CONNECT` (1) | served | typed `BAD_MSG` |",
    )
    (docs / "ARCHITECTURE.md").write_text(f"# arch\n\n{stale}\n")
    fs = C.check_matrix(py, nat, str(tmp_path))
    assert [f.rule for f in fs] == ["matrix-drift"], fs


def test_matrix_missing_block_detected(tmp_path, py, nat):
    docs = tmp_path / "oncilla_tpu_torch" / "docs"
    docs.mkdir(parents=True)
    (docs / "ARCHITECTURE.md").write_text("# arch\n")
    fs = C.check_matrix(py, nat, str(tmp_path))
    assert [f.rule for f in fs] == ["matrix-drift"], fs
    assert "--write-matrix" in fs[0].message


def test_matrix_content(py, nat):
    data = C.matrix_data(py, nat)
    caps = data["capabilities"]
    assert caps["FLAG_CAP_COALESCE"]["native"] == "granted"
    assert "OCM_NATIVE_OBS=0" in caps["FLAG_CAP_TRACE"]["native"]
    assert caps["FLAG_CAP_MUX"]["native"] == "declined"
    reqs = data["requests"]
    assert reqs["DATA_PUT"] == {
        "value": 30, "python": "served", "native": "served",
    }
    assert reqs["CANCEL"]["native"] == "typed `BAD_MSG`"
    # Every Python request type has a row.
    assert set(reqs) == {
        n for n in py.msg_values if C._is_request(n)
    }
