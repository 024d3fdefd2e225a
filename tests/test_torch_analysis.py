"""The port's static-analysis gate analyzed (``oncilla_tpu_torch.analysis``,
the JAX package's passes pointed at the port): every seeded violation
fires its rule, documented non-findings stay silent, the protocol checks
catch seeded drift in the port's protocol and daemon, and the default scan
(the port's package and its tests) is clean with an empty baseline. The
parity test holds each port pass to the JAX pass on every JAX fixture,
read in place."""

import contextlib
import io
import json
import os
from pathlib import Path

import pytest

from oncilla_tpu.analysis import lint as jax_lint
from oncilla_tpu.analysis.asyncsafety import scan_async as jax_scan_async
from oncilla_tpu.analysis.lifecycle import scan_lifecycle as jax_scan_lifecycle
from oncilla_tpu.analysis.rpcgraph import scan_rpcgraph as jax_scan_rpcgraph
from oncilla_tpu_torch.analysis import check_protocol, scan_paths
from oncilla_tpu_torch.analysis import __main__ as cli
from oncilla_tpu_torch.analysis.__main__ import main as analysis_main
from oncilla_tpu_torch.analysis.asyncsafety import scan_async
from oncilla_tpu_torch.analysis.lifecycle import scan_lifecycle
from oncilla_tpu_torch.analysis.lint import captured_functions, lint_source
from oncilla_tpu_torch.analysis.rpcgraph import scan_rpcgraph

FIXTURES = Path(__file__).parent / "fixtures" / "analysis"
PORT_FIXTURES = Path(__file__).parent / "fixtures" / "torch_analysis"
ROOT = Path(__file__).resolve().parents[1]


def _rules(findings):
    return [f.rule for f in findings]


@pytest.fixture(scope="module")
def tree_report():
    """One default scan of the whole port, shared by the tests that need
    it (about 20 s): ``--json`` carries the findings, the info channel,
    the summary, the matrix and the topology."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = analysis_main(["--json"])
    return rc, json.loads(out.getvalue())


# -- AST rules on the seeded fixtures ----------------------------------


def test_lock_blocking_fixture_fires():
    fs = scan_paths([str(FIXTURES / "seeded_lock_blocking.py")])
    assert _rules(fs) == ["blocking-call-under-lock"] * 4, fs
    lines = {f.line for f in fs}
    # One finding per seeded site; none from the ok_* functions.
    assert len(lines) == 4
    syms = {f.symbol for f in fs}
    assert syms == {
        "sleep_under_lock", "wire_roundtrip_under_lock", "dial_under_lock",
    }


def test_swallow_fixture_fires():
    fs = scan_paths([str(FIXTURES / "seeded_swallow.py")])
    assert _rules(fs) == ["swallowed-exception"] * 2, fs
    assert {f.symbol for f in fs} == {"swallow_exception", "swallow_bare"}


def test_graph_capture_fixture_fires():
    fs = scan_paths([str(PORT_FIXTURES / "seeded_graph_impure.py")])
    assert _rules(fs) == ["graph-host-call"] * 6, fs
    assert {f.symbol for f in fs} == {
        "captured_block", "handed_step", "graphed_body",
    }


def test_jit_fixture_is_not_the_ports_target():
    """The JAX package's ``jit-host-call`` fixture holds no CUDA-graph
    capture, so the port's rule in its place reports nothing there."""
    fs = scan_paths([str(FIXTURES / "seeded_jit_impure.py")])
    assert fs == [], fs


def test_printd_eager_format_fixture_fires():
    fs = scan_paths([str(FIXTURES / "seeded_printd_eager.py")])
    assert _rules(fs) == ["printd-eager-format"] * 3, fs
    assert {f.symbol for f in fs} == {
        "eager_fstring", "eager_percent", "eager_format",
    }


def test_printd_eager_format_clean_on_tree():
    import oncilla_tpu_torch

    pkg = os.path.dirname(oncilla_tpu_torch.__file__)
    fs = [f for f in scan_paths([pkg]) if f.rule == "printd-eager-format"]
    assert fs == [], [f.render() for f in fs]


def test_graph_host_call_clean_on_tree():
    """The port's captured steps (the functions of
    :func:`test_graph_capture_follows_the_port_steps`) read nothing on
    the host."""
    import oncilla_tpu_torch

    pkg = os.path.dirname(oncilla_tpu_torch.__file__)
    fs = [f for f in scan_paths([pkg]) if f.rule == "graph-host-call"]
    assert fs == [], [f.render() for f in fs]


def test_graph_capture_follows_the_port_steps():
    """What the resolution finds inside the port's captures: the steps the
    engine, the paged decoders and the kv_decode bench hand to
    ``StepGraphs.run`` (through a method's parameter, ``hooked_step`` and
    an import), what they call, and the MoE family's hooks; never the
    decoders' host-side ``step`` methods nor the eager decode."""
    import oncilla_tpu_torch

    got = captured_functions([os.path.dirname(oncilla_tpu_torch.__file__)])
    m = "oncilla_tpu_torch.models."
    assert {
        m + "graphs:StepGraphs.run.<lambda>",
        m + "kv_paging:paged_token_step", m + "kv_paging:paged_decode_batch_step",
        m + "llama:block", m + "llama:grouped_attention", m + "llama:rope",
        m + "llama:final_logits", m + "llama:layer_params",
        m + "moe:moe_layer_params", m + "moe:mlp_of", m + "moe:moe_ffn",
    } <= got, sorted(got)
    assert not {
        m + "kv_paging:PagedDecoder.step", m + "kv_paging:BucketedPagedDecoder.step",
        m + "kv_paging:paged_decode_step", m + "llama:decode_step",
        m + "moe:decode_step",
    } & got, sorted(got)


def test_graph_capture_resolves_across_modules():
    """The fixture package: steps handed to the capture from other modules
    through a ``partial`` with a hook, a method's parameter, relative and
    absolute imports, and a callee of a captured step; the ``step``
    methods and the eager functions stay silent."""
    pkg = PORT_FIXTURES / "capture_pkg"
    fs = scan_paths([str(pkg)])
    assert _rules(fs) == ["graph-host-call"] * 4, [f.render() for f in fs]
    assert {f.symbol for f in fs} == {
        "timed_step", "scaled_mlp", "helper", "batch_step"}
    for f in fs:
        assert "# FINDING" in Path(f.path).read_text().splitlines()[f.line - 1]


def _seed_host_read(tmp_path, module: str, qualname: str) -> Path:
    """The port's models, the attention op the paged step calls and the
    serving engine copied under ``tmp_path`` with ``torch.zeros(1).item()``
    before the last statement of ``module``'s ``qualname``; returns the
    copy's package directory."""
    import ast
    import shutil

    import oncilla_tpu_torch

    src = Path(oncilla_tpu_torch.__file__).parent
    pkg = tmp_path / "oncilla_tpu_torch"
    shutil.copytree(src / "models", pkg / "models",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (pkg / "serving").mkdir()
    shutil.copy(src / "serving" / "engine.py", pkg / "serving" / "engine.py")
    (pkg / "ops").mkdir()
    shutil.copy(src / "ops" / "attn.py", pkg / "ops" / "attn.py")
    for d in (pkg, pkg / "serving", pkg / "ops"):
        (d / "__init__.py").write_text("")
    path = pkg / "models" / f"{module}.py"
    text = path.read_text()
    node = ast.parse(text)
    for part in qualname.split("."):
        node = next(n for n in node.body if getattr(n, "name", None) == part)
    last = node.body[-1]
    lines = text.splitlines(keepends=True)
    lines.insert(last.lineno - 1, " " * last.col_offset + "torch.zeros(1).item()\n")
    path.write_text("".join(lines))
    return pkg


@pytest.mark.parametrize("module, qualname, caught", [
    ("kv_paging", "paged_token_step", True),
    ("kv_paging", "paged_decode_batch_step", True),
    ("llama", "grouped_attention", True),
    ("moe", "moe_ffn", True),
    ("kv_paging", "PagedDecoder.step", False),
    ("kv_paging", "BucketedPagedDecoder.step", False),
    ("llama", "decode_step", False),
])
def test_graph_host_call_catches_a_host_read_in_the_port(
        tmp_path, module, qualname, caught):
    """A host read seeded into a copy of the port: caught in what the
    captures run, silent in what runs only eagerly."""
    pkg = _seed_host_read(tmp_path, module, qualname)
    fs = [f for f in scan_paths([str(pkg)]) if f.rule == "graph-host-call"]
    want = [(f"{module}.py", qualname)] if caught else []
    assert [(Path(f.path).name, f.symbol) for f in fs] == want


def test_suppression_comment_is_per_rule():
    src = (
        "import threading, time\n"
        "_mu = threading.Lock()\n"
        "def f():\n"
        "    with _mu:\n"
        "        time.sleep(1)  # ocm-lint: allow[swallowed-exception]\n"
    )
    # Wrong rule name in the comment: the finding still fires.
    assert _rules(lint_source(src, "x.py")) == ["blocking-call-under-lock"]


def test_graph_suppression_and_nested_capture_names():
    src = (
        "import torch\n"
        "def f(g, x):\n"
        "    with torch.cuda.graph(g):\n"
        "        a = x.item()  # ocm-lint: allow[graph-host-call]\n"
        "        return x.tolist()\n"
        "def g(x):\n"
        "    return x.numpy()\n"
        "step = CapturedStep(g, [x])\n"
    )
    fs = lint_source(src, "x.py")
    assert [(f.rule, f.line, f.symbol) for f in fs] == [
        ("graph-host-call", 5, "f"), ("graph-host-call", 7, "g"),
    ]


def test_syntax_error_is_a_finding_not_a_crash():
    fs = lint_source("def broken(:\n", "bad.py")
    assert _rules(fs) == ["syntax-error"]


# -- parity with the JAX package's passes ------------------------------


_PASSES = {
    "lint": (jax_lint.scan_paths, scan_paths),
    "lifecycle": (jax_scan_lifecycle, scan_lifecycle),
    "asyncsafety": (jax_scan_async, scan_async),
    "rpcgraph": (jax_scan_rpcgraph, scan_rpcgraph),
}
_JAX_FIXTURES = sorted(p.name for p in FIXTURES.glob("seeded_*.py"))


def test_fifteen_jax_fixtures():
    assert len(_JAX_FIXTURES) == 15, _JAX_FIXTURES


@pytest.mark.parametrize("name", _JAX_FIXTURES)
@pytest.mark.parametrize("family", sorted(_PASSES))
def test_passes_match_the_jax_passes(family, name):
    """Each port pass gives the JAX pass's (rule, line, symbol) set on
    every JAX fixture, read in place; on the jit fixture the JAX
    ``jit-host-call`` findings have no counterpart (the port's rule is
    ``graph-host-call``, which must report nothing there)."""
    jax_pass, port_pass = _PASSES[family]
    path = [str(FIXTURES / name)]

    def key(fs):
        return sorted((f.rule, f.line, f.symbol) for f in fs)

    want = [k for k in key(jax_pass(path)) if k[0] != "jit-host-call"]
    got = key(port_pass(path))
    assert got == want
    assert not any(k[0] == "graph-host-call" for k in got)
    if name == "seeded_jit_impure.py" and family == "lint":
        assert len(key(jax_pass(path))) == 4  # what the JAX rule sees


# -- protocol exhaustiveness / roundtrip -------------------------------


def test_protocol_checks_clean_on_tree():
    assert check_protocol() == []


def test_unhandled_request_type_detected(monkeypatch):
    from oncilla_tpu_torch.runtime import daemon
    from oncilla_tpu_torch.runtime.protocol import MsgType

    monkeypatch.delitem(daemon._HANDLERS, MsgType.DATA_PUT)
    fs = check_protocol()
    assert any(
        f.rule == "protocol-exhaustiveness" and "DATA_PUT" in f.message
        and "no daemon handler" in f.message
        and f.path == "oncilla_tpu_torch/runtime/daemon.py"
        for f in fs
    ), fs


def test_missing_schema_detected(monkeypatch):
    from oncilla_tpu_torch.runtime import protocol
    from oncilla_tpu_torch.runtime.protocol import MsgType

    monkeypatch.delitem(protocol._SCHEMAS, MsgType.STATUS_OK)
    fs = check_protocol()
    assert any("STATUS_OK has no payload schema" in f.message for f in fs), fs


# -- the CLI gate -------------------------------------------------------


def test_cli_nonzero_on_seeded_fixture(capsys):
    rc = analysis_main([str(FIXTURES / "seeded_swallow.py")])
    assert rc == 1
    out = capsys.readouterr().out
    assert "swallowed-exception" in out


def test_default_scan_is_the_port_and_its_tests():
    paths = cli.default_paths()
    assert paths[0] == str(ROOT / "oncilla_tpu_torch")
    tests = [Path(p).name for p in paths[1:]]
    assert Path(__file__).name in tests and "_torch_dist.py" in tests
    assert all(n.startswith(("test_torch_", "_torch_")) for n in tests)
    assert "test_analysis.py" not in tests


def test_baseline_is_empty():
    data = json.loads(Path(cli.DEFAULT_BASELINE).read_text())
    assert data == {"version": 1, "findings": {}}


def test_cli_clean_on_tree(tree_report):
    """The acceptance gate itself: default scan of the port and its
    tests, protocol checks included. The baseline is empty, so the same
    scan with ``--no-baseline`` is this one."""
    rc, report = tree_report
    assert rc == 0, report["findings"]
    assert report["findings"] == [] and report["baselined"] == 0


def test_cli_json_report_shape(tree_report, capsys):
    """--json emits the per-family CI artifact: typed findings, the
    info channel, the summary, and (on default scans) the capability
    matrix — with exit-code semantics unchanged."""
    rc = analysis_main([str(FIXTURES / "seeded_swallow.py"), "--json"])
    assert rc == 1
    report = json.loads(capsys.readouterr().out)
    assert {f["rule"] for f in report["findings"]} == {"swallowed-exception"}
    assert all(f["family"] == "concurrency" for f in report["findings"])
    assert {"family", "rule", "path", "line", "symbol", "message"} <= set(
        report["findings"][0]
    )
    assert "matrix" not in report  # explicit-path scans stay hermetic

    rc, report = tree_report
    assert rc == 0  # info-level findings never affect the exit code
    assert report["findings"] == []
    assert set(report["summary"]) == {
        "concurrency", "lifecycle", "asyncsafety", "conformance",
        "rpcgraph",
    }
    assert all(f["rule"] == "journal-event-unchecked" for f in report["info"])
    assert all(f["path"].startswith("oncilla_tpu_torch/")
               for f in report["info"])
    m = report["matrix"]
    assert m["capabilities"]["FLAG_CAP_COALESCE"]["native"] == "granted"
    assert m["requests"]["CANCEL"]["native"] == "typed `BAD_MSG`"
    assert report["topology"]["types"]


def test_cli_families_filter(capsys):
    # A concurrency-only fixture produces nothing under the async family.
    rc = analysis_main([str(FIXTURES / "seeded_swallow.py"),
                        "--families", "asyncsafety"])
    assert rc == 0
    # ...and fires under its own.
    rc = analysis_main([str(FIXTURES / "seeded_async_task.py"),
                        "--families", "asyncsafety"])
    assert rc == 1
    assert "async-untracked-task" in capsys.readouterr().out


def test_cli_baseline_suppresses_known_findings(tmp_path, capsys):
    fixture = str(FIXTURES / "seeded_swallow.py")
    baseline = tmp_path / "baseline.json"
    rc = analysis_main([fixture, "--write-baseline",
                        "--baseline", str(baseline)])
    assert rc == 0
    data = json.loads(baseline.read_text())
    assert sum(data["findings"].values()) == 2
    # Same findings again: fully baselined -> clean exit.
    rc = analysis_main([fixture, "--baseline", str(baseline)])
    assert rc == 0
    assert "2 baselined" in capsys.readouterr().out
    # A baseline for a DIFFERENT file doesn't cover new findings.
    rc = analysis_main([str(PORT_FIXTURES / "seeded_graph_impure.py"),
                        "--baseline", str(baseline)])
    assert rc == 1


def test_package_imports_no_jax():
    """No module of the port's analysis imports jax or the JAX package:
    the protocol and conformance checks import the port's own runtime."""
    import ast

    pkg = ROOT / "oncilla_tpu_torch" / "analysis"
    for fp in sorted(pkg.glob("*.py")):
        for node in ast.walk(ast.parse(fp.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("jax", "oncilla_tpu"), (fp, n)
