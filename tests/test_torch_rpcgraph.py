"""The port's distributed wait-graph analyzer
(``oncilla_tpu_torch.analysis.rpcgraph``) and its runtime twin
(``analysis/waitwatch.py``), the JAX package's tests/test_rpcgraph.py on
the port: seeded fixtures through the port's CLI, report determinism, the
FLAG_HB_FWD/hop-bound recognition, the heartbeat-amplification mutation,
pool stratification of the REQ_FREE -> DO_FREE -> NOTE_FREE nesting, the
unified wait-for graph; and the port's own lock fixtures, one for each
lock the gate found in the port's runtime."""

import json
import os
from pathlib import Path

import pytest

from oncilla_tpu_torch.analysis import rpcgraph
from oncilla_tpu_torch.analysis.__main__ import main as analysis_main
from oncilla_tpu_torch.analysis.rpcgraph import check_rpcgraph, scan_rpcgraph

FIXTURES = Path(__file__).parent / "fixtures" / "analysis"
PORT_FIXTURES = Path(__file__).parent / "fixtures" / "torch_analysis"
ROOT = Path(__file__).resolve().parents[1]


# -- seeded fixtures through the CLI ------------------------------------


@pytest.mark.parametrize("name,rule", [
    ("seeded_rpc_relay_cycle.py", "relay-cycle"),
    ("seeded_rpc_pool_strata.py", "pool-stratification"),
    ("seeded_rpc_lock_across.py", "lock-across-rpc"),
    ("seeded_rpc_unbounded.py", "unbounded-blocking"),
])
def test_seeded_fixture_exactly_one_finding(name, rule, capsys):
    rc = analysis_main([str(FIXTURES / name), "--families", "rpcgraph",
                        "--json", "--no-baseline"])
    assert rc == 1
    report = json.loads(capsys.readouterr().out)
    assert len(report["findings"]) == 1
    f = report["findings"][0]
    assert f["rule"] == rule
    assert f["family"] == "rpcgraph"
    assert f["path"].endswith(name)


@pytest.mark.parametrize("name,symbol", [
    ("seeded_stage_lock_put.py", "Client.put"),
    ("seeded_stage_lock_get.py", "Client.get_into"),
    ("seeded_restream_lock.py", "Daemon.seeded_suppressed_on_with_line"),
])
def test_port_lock_fixture_exactly_one_finding(name, symbol, capsys):
    """Each lock the gate found in the port's runtime, reduced to its
    shape: the staging lock held across the put's and the get's wire leg
    (the pooled repair beside it stays silent), and the re-replication
    stream lock whose suppression sat on the ``with`` line, not on the
    dialling call the finding names."""
    rc = analysis_main([str(PORT_FIXTURES / name), "--json",
                        "--no-baseline"])
    assert rc == 1
    report = json.loads(capsys.readouterr().out)
    assert [(f["rule"], f["symbol"]) for f in report["findings"]] == [
        ("lock-across-rpc", symbol)]
    line = (PORT_FIXTURES / name).read_text().splitlines()[
        report["findings"][0]["line"] - 1]
    assert "# FINDING" in line


def test_staging_pool_gives_each_transfer_its_own_buffer():
    """The repair of the staging lock: a card-tensor transfer takes a
    pinned buffer from the client's pool under ``_stage_lock`` and runs
    its wire leg with no lock held, so two transfers of one client
    overlap on buffers of their own; the smallest free buffer that fits
    is reused, and a smaller one is released before a bigger one is
    made."""
    import threading

    from oncilla_tpu_torch.runtime.client import ControlPlaneClient

    c = ControlPlaneClient.__new__(ControlPlaneClient)
    c._stage_free, c._stage_lock = [], threading.Lock()

    def sizes():
        return [b.untyped_storage().nbytes() for b in c._stage_free]

    with c._staged(100) as a:
        assert not c._stage_lock.locked()
        with c._staged(50) as b:
            assert a.numel() == 100 and b.numel() == 50
            assert a.data_ptr() != b.data_ptr()
    assert sizes() == [50, 100]
    with c._staged(80) as d:
        assert d.numel() == 80 and d.untyped_storage().nbytes() == 100
        assert sizes() == [50]
    with c._staged(200):
        assert sizes() == [100]
    assert sizes() == [100, 200]


def _bare_client():
    import threading

    from oncilla_tpu_torch.runtime.client import ControlPlaneClient

    c = ControlPlaneClient.__new__(ControlPlaneClient)
    c._stage_free, c._stage_lock = [], threading.Lock()
    return c


def test_staging_pool_keeps_at_most_stage_keep_buffers():
    """Three transfers at once take three buffers; given back, the pool
    releases its smallest free buffer past ``STAGE_KEEP``, so a burst
    leaves no more pinned memory behind than the largest two."""
    from oncilla_tpu_torch.runtime.client import STAGE_KEEP

    c = _bare_client()
    with c._staged(100), c._staged(200), c._staged(50):
        assert c._stage_free == []
    assert STAGE_KEEP == 2
    assert [b.numel() for b in c._stage_free] == [100, 200]
    with c._staged(300):  # a miss releases the smallest first
        assert [b.numel() for b in c._stage_free] == [200]
    assert [b.numel() for b in c._stage_free] == [200, 300]


def test_staging_pool_threads_never_share_a_buffer():
    """Eight threads at once, each filling its staging buffer with its own
    byte and reading it back after the others ran: no transfer's bytes
    are overwritten by another's, and the pool ends at ``STAGE_KEEP``."""
    import threading

    from oncilla_tpu_torch.runtime.client import STAGE_KEEP

    c = _bare_client()
    barrier = threading.Barrier(8)
    bad = []

    def one(i):
        for _ in range(20):
            with c._staged(4096 + i) as buf:
                buf.fill_(i)
                barrier.wait()  # every thread holds a buffer here
                if not bool((buf == i).all()):
                    bad.append(i)
                barrier.wait()

    ts = [threading.Thread(target=one, args=(i,)) for i in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert bad == []
    assert len(c._stage_free) == STAGE_KEEP


@pytest.mark.parametrize("name", [
    "seeded_rpc_terminal_flag.py",
    "seeded_rpc_hop_bounded.py",
])
def test_bounded_relays_scan_clean(name):
    assert scan_rpcgraph([str(FIXTURES / name)]) == []


# -- determinism --------------------------------------------------------


def test_json_report_byte_identical(capsys):
    """Same tree => byte-identical --json artifact (findings globally
    sorted, no set-iteration or dict-hash order leaking through)."""
    args = [str(ROOT / "oncilla_tpu_torch" / "runtime"), "--families",
            "rpcgraph", "--json", "--no-baseline"]
    assert analysis_main(args) == 0
    first = capsys.readouterr().out
    assert analysis_main(args) == 0
    assert capsys.readouterr().out == first


# -- hop/flag bound recognition on the live tree ------------------------


def test_heartbeat_terminal_flag_recognized():
    """The FLAG_HB_FWD early return in _on_heartbeat is the terminal
    guard of the amplification fix; the extractor must see it, which is
    what keeps HEARTBEAT ('terminal-flag' in _RELAY_CLASS) out of the
    relay-cycle findings."""
    g = rpcgraph._runtime_graph(str(ROOT))
    hname = g.handlers["HEARTBEAT"]
    _, hfi = g.funcs[hname]
    assert "FLAG_HB_FWD" in hfi.guards
    assert rpcgraph._handler_bounded(g, "HEARTBEAT")


def test_live_tree_scans_clean():
    """Zero unjustified findings on the live tree: the four rules over
    the runtime graph, the class table, the native pool, and the
    generated topology appendix."""
    paths = [str(ROOT / p) for p in rpcgraph._RUNTIME_FILES]
    assert scan_rpcgraph(paths, rel_to=str(ROOT)) == []
    assert check_rpcgraph(str(ROOT)) == []


# -- the heartbeat-amplification mutation --------------------------------------------------


def _delete_guard_block(src: str, marker: str) -> str:
    """Remove the ``if`` statement whose test line contains ``marker``
    (the line plus its indented body), returning the mutated source."""
    lines = src.splitlines(keepends=True)
    for i, ln in enumerate(lines):
        if marker in ln:
            indent = len(ln) - len(ln.lstrip())
            j = i + 1
            while j < len(lines):
                s = lines[j]
                if s.strip() and (len(s) - len(s.lstrip())) <= indent:
                    break
                j += 1
            return "".join(lines[:i] + lines[j:])
    raise AssertionError(f"marker {marker!r} not found")


def test_heartbeat_guard_mutation_caught(tmp_path):
    """Deleting the FLAG_HB_FWD terminal check from a copied daemon.py
    reproduces the heartbeat-amplification shape — the analyzer
    must produce the relay-cycle finding naming HEARTBEAT and both
    daemon roles in the cycle."""
    src = (ROOT / "oncilla_tpu_torch" / "runtime" / "daemon.py").read_text(
        encoding="utf-8")
    mutated = _delete_guard_block(src, "if msg.flags & FLAG_HB_FWD:")
    bad = tmp_path / "daemon.py"
    bad.write_text(mutated, encoding="utf-8")
    findings = scan_rpcgraph([str(bad)], rel_to=str(tmp_path))
    relay = [f for f in findings if f.rule == "relay-cycle"
             and "HEARTBEAT" in f.message]
    assert relay, f"mutation not caught; got {[f.render() for f in findings]}"
    msg = relay[0].message
    assert "origin daemon role" in msg
    assert "relay peer daemon role" in msg
    # And the unmutated file stays clean, so the signal IS the guard.
    good = tmp_path / "daemon_ok.py"
    good.write_text(src, encoding="utf-8")
    assert [f for f in scan_rpcgraph([str(good)], rel_to=str(tmp_path))
            if f.rule == "relay-cycle"] == []


# -- the worker-pool nesting ---------------------------------------------


def test_req_free_chain_is_pool_stratified():
    """REQ_FREE -> DO_FREE -> NOTE_FREE is the deepest nested control
    chain; pin that it exists in the extracted type graph AND that the
    whole runtime graph carries no bounded-pool wait cycle — the
    invariant that used to live only in pool.py's docstring."""
    g = rpcgraph._runtime_graph(str(ROOT))
    edges = rpcgraph._type_edges(g)
    assert any(t == "DO_FREE" for t, _, _, _ in edges.get("REQ_FREE", []))
    assert any(t == "NOTE_FREE" for t, _, _, _ in edges.get("DO_FREE", []))
    assert rpcgraph._pool_findings(g) == []


# -- CLI satellites -----------------------------------------------------


def test_stale_baseline_warning_names_family(tmp_path, capsys):
    baseline = tmp_path / "b.json"
    baseline.write_text(json.dumps(
        {"version": 1, "findings": {"relay-cycle:gone.py:fn": 1}}
    ))
    rc = analysis_main([str(FIXTURES / "seeded_rpc_terminal_flag.py"),
                        "--families", "rpcgraph",
                        "--baseline", str(baseline)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "stale rpcgraph baseline entry" in out
    assert "relay-cycle:gone.py:fn" in out


def test_write_baseline_refuses_transients(tmp_path, monkeypatch, capsys):
    """--write-baseline re-scans and drops findings that did not
    reproduce — a fresh baseline must not capture transient findings."""
    import oncilla_tpu_torch.analysis.__main__ as cli
    from oncilla_tpu_torch.analysis.lint import Finding

    real = cli.scan_paths
    calls = {"n": 0}

    def flaky(paths, rel_to=None):
        out = real(paths, rel_to=rel_to)
        calls["n"] += 1
        if calls["n"] == 1:  # present on the first scan only
            out = out + [Finding(
                rule="swallowed-exception", path="ghost.py", line=1,
                symbol="ghost", message="transient",
            )]
        return out

    monkeypatch.setattr(cli, "scan_paths", flaky)
    baseline = tmp_path / "b.json"
    rc = cli.main([str(FIXTURES / "seeded_swallow.py"),
                   "--write-baseline", "--baseline", str(baseline)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "refusing transient finding" in out
    assert "ghost.py" in out
    data = json.loads(baseline.read_text())
    assert data["findings"]  # the reproducible ones were kept
    assert not any("ghost.py" in k for k in data["findings"])


def test_relay_class_gap_fails_both_gates(monkeypatch):
    """Drive-by: a handled MsgType missing from rpcgraph._RELAY_CLASS
    fails the conformance gate too, pointing at the one table."""
    from oncilla_tpu_torch.analysis import conformance

    monkeypatch.delitem(rpcgraph._RELAY_CLASS, "HEARTBEAT")
    gap = conformance.check_relay_classes(conformance.extract_python())
    assert [f.symbol for f in gap] == ["HEARTBEAT"]
    assert gap[0].rule == "relay-class-gap"
    assert "rpcgraph._RELAY_CLASS" in gap[0].message
    g = rpcgraph._runtime_graph(str(ROOT))
    unclassified = [
        f for f in rpcgraph._class_findings(g, str(ROOT))
        if f.rule == "relay-unclassified"
    ]
    assert len(unclassified) == 1
    assert "HEARTBEAT" in unclassified[0].message


# -- the runtime twin ---------------------------------------------------


def test_waitwatch_unified_graph(monkeypatch):
    monkeypatch.setenv("OCM_WAITWATCH", "1")
    from oncilla_tpu_torch.analysis import lockwatch, waitwatch

    waitwatch.reset()
    lk = lockwatch.make_lock("t.fixture_lock")
    assert isinstance(lk, lockwatch.WatchedLock)  # WAITWATCH implies it
    # Client-shaped thread: lock held across an RPC round-trip.
    with lk:
        waitwatch.note_wait(waitwatch.RPC_DAEMON)
    assert waitwatch.cycles() == []  # one-way edge: fine
    # Daemon-shaped thread: serving slot held while taking the lock —
    # the reverse edge closes the cross-process cycle.
    with waitwatch.slot(waitwatch.RPC_DAEMON):
        with lk:
            pass
    cyc = waitwatch.cycles()
    assert any(waitwatch.RPC_DAEMON in c and "t.fixture_lock" in c
               for c in cyc)
    with pytest.raises(AssertionError, match="wait-for cycles"):
        waitwatch.assert_acyclic()
    waitwatch.reset()
    assert waitwatch.cycles() == []


def test_waitwatch_disabled_is_noop(monkeypatch):
    monkeypatch.delenv("OCM_WAITWATCH", raising=False)
    monkeypatch.delenv("OCM_LOCKWATCH", raising=False)
    from oncilla_tpu_torch.analysis import waitwatch

    waitwatch.reset()
    waitwatch.note_wait(waitwatch.RPC_DAEMON)
    with waitwatch.slot(waitwatch.MUX_SLOT):
        waitwatch.note_holding(waitwatch.POOL_SLOT)
        waitwatch.note_done(waitwatch.POOL_SLOT)
    assert waitwatch.snapshot() == {
        "edges": {}, "acquires": {}, "long_holds": [],
    }
