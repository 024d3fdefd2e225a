"""The port's handle-lifecycle analysis family
(``oncilla_tpu_torch.analysis.lifecycle``), the JAX package's
tests/test_lifecycle.py on the port: every seeded fixture violation (the
JAX fixture, read in place) fires its rule, every documented exemption
stays silent, the port's CLI gates both families with per-family counts,
the baseline round-trips (and reports stale entries), and the port's
``OCM_ALLOCTRACE=1`` ledger records allocation sites that ``Ocm.tini()``
surfaces for leaked handles."""

import json
from pathlib import Path

import pytest

import oncilla_tpu_torch as ocm
from oncilla_tpu_torch.analysis import alloctrace
from oncilla_tpu_torch.analysis.__main__ import main as analysis_main
from oncilla_tpu_torch.analysis.lifecycle import analyze_source, scan_lifecycle

FIXTURES = Path(__file__).parent / "fixtures" / "analysis"
LIFECYCLE_FIXTURE = str(FIXTURES / "seeded_lifecycle.py")


def _rules(findings):
    return sorted(f.rule for f in findings)


# -- the dataflow pass on the seeded fixture ----------------------------


def test_lifecycle_fixture_fires_exactly():
    fs = scan_lifecycle([LIFECYCLE_FIXTURE])
    assert _rules(fs) == [
        "double-free",
        "handle-leak-on-path",
        "handle-leak-on-path",
        "handle-leak-on-path",
        "use-after-free",
    ], fs
    by_rule = {}
    for f in fs:
        by_rule.setdefault(f.rule, set()).add(f.symbol)
    assert by_rule["handle-leak-on-path"] == {
        "seeded_leak_on_branch", "seeded_leak_on_raise",
        "seeded_discarded_alloc",
    }
    assert by_rule["use-after-free"] == {"seeded_use_after_free"}
    assert by_rule["double-free"] == {"seeded_double_free"}
    # Every ok_* exemption function stayed silent.
    assert all(f.symbol.startswith("seeded_") for f in fs), fs


def test_leak_needs_inconsistent_release():
    """A function that never frees its handle transfers ownership (to a
    caller, a fixture, the lease reaper) — not a finding. Only the mixed
    freed-on-one-path/live-on-another shape fires."""
    never_freed = (
        "def f(ctx):\n"
        "    h = ctx.alloc(64)\n"
        "    ctx.put(h, b'x')\n"
    )
    assert analyze_source(never_freed, "x.py") == []
    mixed = (
        "def f(ctx, cond):\n"
        "    h = ctx.alloc(64)\n"
        "    if cond:\n"
        "        ctx.free(h)\n"
    )
    assert _rules(analyze_source(mixed, "x.py")) == ["handle-leak-on-path"]


def test_exception_edge_out_of_tryless_body():
    src = (
        "def f(ctx, n):\n"
        "    h = ctx.alloc(n)\n"
        "    if n > 10:\n"
        "        raise ValueError(n)\n"
        "    ctx.free(h)\n"
    )
    fs = analyze_source(src, "x.py")
    assert _rules(fs) == ["handle-leak-on-path"]
    assert "exception path" in fs[0].message
    # The same raise covered by try/finally free is clean.
    covered = (
        "def f(ctx, n):\n"
        "    h = ctx.alloc(n)\n"
        "    try:\n"
        "        if n > 10:\n"
        "            raise ValueError(n)\n"
        "    finally:\n"
        "        ctx.free(h)\n"
    )
    assert analyze_source(covered, "x.py") == []


def test_use_after_free_requires_no_reassignment():
    src = (
        "def f(ctx):\n"
        "    h = ctx.alloc(64)\n"
        "    ctx.free(h)\n"
        "    h = ctx.alloc(64)\n"
        "    ctx.get(h)\n"
        "    ctx.free(h)\n"
    )
    assert analyze_source(src, "x.py") == []


def test_ocm_free_module_function_recognized():
    src = (
        "def f(ctx):\n"
        "    h = ocm_alloc(ctx, 64)\n"
        "    ocm_free(ctx, h)\n"
        "    ocm_copy_out(ctx, h)\n"
    )
    assert _rules(analyze_source(src, "x.py")) == ["use-after-free"]


def test_pool_lease_release_discipline():
    leaked = (
        "def f(pool, host, port, cond):\n"
        "    e = pool.lease(host, port)\n"
        "    if cond:\n"
        "        pool.release(host, port, e)\n"
    )
    assert _rules(analyze_source(leaked, "x.py")) == ["handle-leak-on-path"]
    balanced = (
        "def f(pool, host, port, cond):\n"
        "    e = pool.lease(host, port)\n"
        "    if cond:\n"
        "        pool.release(host, port, e)\n"
        "    else:\n"
        "        pool.discard(host, port, e)\n"
    )
    assert analyze_source(balanced, "x.py") == []


def test_suppression_comment_is_per_rule():
    src = (
        "def f(ctx):\n"
        "    h = ctx.alloc(64)\n"
        "    ctx.free(h)\n"
        "    ctx.free(h)  # ocm-lint: allow[use-after-free]\n"
    )
    # Wrong rule name in the comment: the double-free still fires.
    assert _rules(analyze_source(src, "x.py")) == ["double-free"]
    src_ok = src.replace("allow[use-after-free]", "allow[double-free]")
    assert analyze_source(src_ok, "x.py") == []


# -- CLI gate: both families, per-family counts -------------------------


def test_cli_nonzero_on_lifecycle_fixture(capsys):
    rc = analysis_main([LIFECYCLE_FIXTURE])
    assert rc == 1
    out = capsys.readouterr().out
    assert "use-after-free" in out
    assert "lifecycle 5" in out  # per-family summary names the tripped gate
    assert "concurrency 0" in out


def test_baseline_roundtrip_writes_then_rescans_clean(tmp_path, capsys):
    baseline = tmp_path / "baseline.json"
    rc = analysis_main([LIFECYCLE_FIXTURE, "--write-baseline",
                        "--baseline", str(baseline)])
    assert rc == 0
    data = json.loads(baseline.read_text())
    assert sum(data["findings"].values()) == 5
    # Re-scan against the freshly written baseline: exits 0.
    rc = analysis_main([LIFECYCLE_FIXTURE, "--baseline", str(baseline)])
    assert rc == 0
    assert "5 baselined" in capsys.readouterr().out


def test_stale_baseline_entry_reported(tmp_path, capsys):
    baseline = tmp_path / "baseline.json"
    rc = analysis_main([LIFECYCLE_FIXTURE, "--write-baseline",
                        "--baseline", str(baseline)])
    assert rc == 0
    data = json.loads(baseline.read_text())
    stale_key = "use-after-free:gone.py:symbol_that_was_fixed"
    data["findings"][stale_key] = 1
    baseline.write_text(json.dumps(data))
    rc = analysis_main([LIFECYCLE_FIXTURE, "--baseline", str(baseline)])
    out = capsys.readouterr().out
    assert rc == 0  # stale allowances warn, they don't fail the gate
    assert "stale lifecycle baseline entry" in out
    assert stale_key in out


# -- the runtime ledger (OCM_ALLOCTRACE=1) ------------------------------


@pytest.fixture
def tracing(monkeypatch):
    monkeypatch.setenv("OCM_ALLOCTRACE", "1")
    alloctrace.reset()
    yield
    alloctrace.reset()


def test_ledger_disabled_is_a_noop(monkeypatch):
    monkeypatch.delenv("OCM_ALLOCTRACE", raising=False)
    alloctrace.reset()
    alloctrace.note_alloc("t:x", 1, 64)
    assert alloctrace.live() == []


def test_ledger_records_site_thread_and_drains(tracing):
    alloctrace.note_alloc("t:a", 1, 64, "REMOTE_HOST")
    alloctrace.note_alloc("t:b", 2, 128)
    recs = alloctrace.live("t:a")
    assert len(recs) == 1
    assert recs[0].nbytes == 64
    assert recs[0].kind == "REMOTE_HOST"
    assert "test_torch_lifecycle.py" in recs[0].site
    assert recs[0].thread
    rep = alloctrace.leak_report()
    assert rep["count"] == 2 and rep["bytes"] == 192
    alloctrace.note_free("t:a", 1)
    alloctrace.note_free("t:a", 999)  # unknown id: silently ignored
    alloctrace.drop_scope("t:b")
    assert alloctrace.live() == []


def test_tini_reports_leaked_handle_allocation_site(tracing):
    ctx = ocm.ocm_init(ocm.OcmConfig(
        host_arena_bytes=1 << 20, device_arena_bytes=1 << 20,
    ), device="cpu")
    h = ctx.alloc(4096)  # deliberately never freed
    assert h.alloc_id > 0
    ctx.tini()
    rep = alloctrace.last_tini_report()
    assert rep is not None and rep["count"] == 1
    (entry,) = rep["live"]
    assert entry["nbytes"] == 4096
    assert "test_torch_lifecycle.py" in entry["site"]  # the leaky line, not ours
    # tini reclaimed it: the ledger (context and arena scopes) is clean.
    assert alloctrace.live("ctx:") == []
    assert ctx.host_arena.allocator.bytes_live == 0


def test_balanced_workload_leaves_ledger_clean(tracing):
    with ocm.ocm_init(ocm.OcmConfig(
        host_arena_bytes=1 << 20, device_arena_bytes=1 << 20,
    ), device="cpu") as ctx:
        h = ctx.alloc(8192)
        ctx.put(h, b"\x07" * 8192)
        assert bytes(ctx.get(h, 4)) == b"\x07" * 4
        ctx.free(h)
        assert alloctrace.live() == []
    rep = alloctrace.last_tini_report()
    assert rep is not None and rep["count"] == 0


# -- satellites: Ocm context manager + arena error type -----------------


def test_ocm_is_a_context_manager():
    with ocm.ocm_init(ocm.OcmConfig(
        host_arena_bytes=1 << 20, device_arena_bytes=1 << 20,
    ), device="cpu") as ctx:
        h = ctx.alloc(1024)
        assert not h.freed
    # __exit__ ran tini(): the forgotten handle was reclaimed.
    assert h.freed
    assert ctx.host_arena.allocator.bytes_live == 0


def test_arena_free_unknown_extent_raises_invalid_handle():
    """Freeing an extent the arena never handed out must raise
    OcmInvalidHandle — the same typed error as context.free — not a
    generic exception."""
    from oncilla_tpu_torch.core.arena import ArenaAllocator, Extent

    a = ArenaAllocator(1 << 16, alignment=512)
    with pytest.raises(ocm.OcmInvalidHandle):
        a.free(Extent(offset=512, nbytes=64))  # never allocated
    e = a.alloc(64)
    a.free(e)
    with pytest.raises(ocm.OcmInvalidHandle):
        a.free(e)  # already freed
    assert a.bytes_free == 1 << 16
