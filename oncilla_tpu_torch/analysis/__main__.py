"""``python -m oncilla_tpu_torch.analysis`` — the static-analysis gate
over the port's own sources.

Scans the port's package and the port's tests (``tests/test_torch_*.py``
and ``tests/_torch_*.py``; never the JAX package's files) with the
analysis families — the concurrency lint (:mod:`~.lint`), the
handle-lifecycle dataflow pass (:mod:`~.lifecycle`), the asyncio-safety
lint (:mod:`~.asyncsafety`), the distributed wait-graph pass
(:mod:`~.rpcgraph`), and on default scans the protocol
exhaustiveness/roundtrip checks plus the cross-language wire-conformance
family (:mod:`~.conformance`) over the port's ``runtime/`` and its copy
of the native daemon — subtracts the checked-in baseline, and exits
nonzero on anything new. Info-level findings (dead-telemetry reports
like ``journal-event-unchecked``) are printed for visibility but never
affect the exit code. The summary line carries per-family counts so CI
logs show which gate tripped; baseline entries whose symbol no longer
produces a finding are reported as stale (fix: re-run
``--write-baseline``).

Usage::

    python -m oncilla_tpu_torch.analysis                  # gate the port
    python -m oncilla_tpu_torch.analysis path/to/file.py  # scan paths
    python -m oncilla_tpu_torch.analysis --families conformance,asyncsafety
    python -m oncilla_tpu_torch.analysis --json           # CI report
    python -m oncilla_tpu_torch.analysis --write-matrix   # regen matrix
    python -m oncilla_tpu_torch.analysis --write-topology # regen topology
    python -m oncilla_tpu_torch.analysis --write-baseline # adopt findings

The generated blocks (capability matrix, RPC topology) live in
``oncilla_tpu_torch/docs/ARCHITECTURE.md``. The baseline
(``oncilla_tpu_torch/analysis/baseline.json``) makes the gate adoptable
incrementally: pre-existing findings are allowances keyed by
``rule:path:enclosing-symbol`` (no line numbers, so unrelated edits
don't churn it); new findings always fail. Prefer fixing, then per-line
``# ocm-lint: allow[rule]`` with a justification, and only then the
baseline.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from collections import Counter

from oncilla_tpu_torch.analysis import conformance, rpcgraph
from oncilla_tpu_torch.analysis.asyncsafety import ASYNC_RULES, scan_async
from oncilla_tpu_torch.analysis.conformance import (
    CONFORMANCE_RULES,
    INFO_RULES,
    check_conformance,
)
from oncilla_tpu_torch.analysis.lifecycle import LIFECYCLE_RULES, scan_lifecycle
from oncilla_tpu_torch.analysis.lint import Finding, scan_paths
from oncilla_tpu_torch.analysis.project import check_protocol
from oncilla_tpu_torch.analysis.rpcgraph import (
    RPCGRAPH_RULES,
    check_rpcgraph,
    scan_rpcgraph,
)

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG_DIR)
DEFAULT_BASELINE = os.path.join(PKG_DIR, "analysis", "baseline.json")
ARCH_MD = conformance._ARCH_MD
# The port's tests beside the JAX package's in ``tests/``.
TEST_GLOBS = ("test_torch_*.py", "_torch_*.py")

FAMILIES = (
    "concurrency", "lifecycle", "asyncsafety", "conformance", "rpcgraph",
)


def family(rule: str) -> str:
    """Which analysis family a rule belongs to (for the summary line)."""
    if rule in LIFECYCLE_RULES:
        return "lifecycle"
    if rule in ASYNC_RULES:
        return "asyncsafety"
    if rule in CONFORMANCE_RULES:
        return "conformance"
    if rule in RPCGRAPH_RULES:
        return "rpcgraph"
    return "concurrency"


def family_counts(findings: list[Finding]) -> Counter:
    counts = Counter({f: 0 for f in FAMILIES})
    counts.update(family(f.rule) for f in findings)
    return counts


def load_baseline(path: str) -> Counter:
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    return Counter({str(k): int(v) for k, v in data.get("findings", {}).items()})


def apply_baseline(
    findings: list[Finding], allowed: Counter
) -> tuple[list[Finding], int, list[str]]:
    """Consume baseline allowances; returns (new findings, #suppressed,
    stale allowance keys that matched nothing — symbols fixed or gone)."""
    budget = Counter(allowed)
    new: list[Finding] = []
    suppressed = 0
    for f in findings:
        if budget[f.key()] > 0:
            budget[f.key()] -= 1
            suppressed += 1
        else:
            new.append(f)
    stale = sorted(k for k, v in budget.items() if v > 0)
    return new, suppressed, stale


def default_paths() -> list[str]:
    """The package and the port's test files (``tests/fixtures`` holds
    seeded violations, scanned only when named)."""
    tests_dir = os.path.join(ROOT, "tests")
    tests = sorted({fp for g in TEST_GLOBS
                    for fp in glob.glob(os.path.join(tests_dir, g))})
    return [PKG_DIR, *tests]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m oncilla_tpu_torch.analysis",
        description="oncilla-tpu project lint + protocol/conformance checks",
    )
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to scan (default: the package + its "
                         "tests)")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline JSON (default: {DEFAULT_BASELINE})")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current findings as the new baseline")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore any baseline file")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable per-family findings on stdout")
    ap.add_argument("--families", default=None, metavar="A,B",
                    help="comma-separated subset of families to run "
                         f"(default: all of {','.join(FAMILIES)})")
    ap.add_argument("--write-matrix", action="store_true",
                    help="regenerate the capability/parity matrix block "
                         f"in {ARCH_MD} and exit")
    ap.add_argument("--write-topology", action="store_true",
                    help=f"regenerate the RPC-topology appendix in {ARCH_MD} "
                         "and exit")
    args = ap.parse_args(argv)

    if args.write_matrix:
        changed = conformance.write_matrix(ROOT)
        print("capability matrix: "
              + (f"regenerated in {ARCH_MD}" if changed
                 else "already up to date"))
        return 0

    if args.write_topology:
        changed = rpcgraph.write_topology(ROOT)
        print("rpc topology: "
              + (f"regenerated in {ARCH_MD}" if changed
                 else "already up to date"))
        return 0

    if args.families:
        fams = set(args.families.split(","))
        unknown = fams - set(FAMILIES)
        if unknown:
            ap.error(f"unknown families: {', '.join(sorted(unknown))} "
                     f"(valid: {', '.join(FAMILIES)})")
    else:
        fams = set(FAMILIES)

    default_scan = not args.paths
    paths = default_paths() if default_scan else args.paths

    def collect() -> list[Finding]:
        out: list[Finding] = []
        if "concurrency" in fams:
            out.extend(scan_paths(paths, rel_to=ROOT))
        if "lifecycle" in fams:
            out.extend(scan_lifecycle(paths, rel_to=ROOT))
        if "asyncsafety" in fams:
            out.extend(scan_async(paths, rel_to=ROOT))
        if "rpcgraph" in fams:
            out.extend(scan_rpcgraph(paths, rel_to=ROOT))
        if default_scan:
            # These need the real modules + the whole tree;
            # explicit-path scans (fixtures, pre-commit on a file)
            # stay hermetic.
            if "concurrency" in fams:
                out.extend(check_protocol())
            if "conformance" in fams:
                out.extend(check_conformance(ROOT))
            if "rpcgraph" in fams:
                out.extend(check_rpcgraph(ROOT))
        # One global deterministic order regardless of family mix: the
        # --json report is a CI artifact and must be byte-identical for
        # identical trees.
        out.sort(key=lambda f: (f.path, f.line, f.rule, f.symbol,
                                f.message))
        return out

    findings = collect()

    # Info-level findings are reported, never fatal, never baselined.
    info = [f for f in findings if f.rule in INFO_RULES]
    findings = [f for f in findings if f.rule not in INFO_RULES]

    baseline_path = args.baseline or DEFAULT_BASELINE
    if args.write_baseline:
        counts = Counter(f.key() for f in findings)
        # A finding that does not reproduce on an immediate re-scan is
        # transient (a racing editor save, a half-written generated
        # file) — baking it in would hide the next REAL occurrence, so
        # refuse it and say so.
        second = Counter(
            f.key() for f in collect() if f.rule not in INFO_RULES
        )
        dropped = counts - (counts & second)
        counts &= second
        with open(baseline_path, "w", encoding="utf-8") as fh:
            json.dump(
                {"version": 1, "findings": dict(sorted(counts.items()))},
                fh, indent=2,
            )
            fh.write("\n")
        for key in sorted(dropped):
            print(f"analysis: refusing transient finding (did not "
                  f"reproduce on re-scan): {key}")
        print(f"wrote {sum(counts.values())} allowance(s) to {baseline_path}")
        return 0

    suppressed = 0
    stale: list[str] = []
    if not args.no_baseline and os.path.exists(baseline_path):
        findings, suppressed, stale = apply_baseline(
            findings, load_baseline(baseline_path)
        )

    if args.as_json:
        def row(f: Finding) -> dict:
            return {"family": family(f.rule), **f.__dict__}

        report = {
            "findings": [row(f) for f in findings],
            "info": [row(f) for f in info],
            "stale_baseline": stale,
            "baselined": suppressed,
            "summary": dict(sorted(family_counts(findings).items())),
        }
        if default_scan and "conformance" in fams:
            report["matrix"] = conformance.matrix_data(
                conformance.extract_python(ROOT), conformance.extract_native()
            )
        if default_scan and "rpcgraph" in fams:
            report["topology"] = rpcgraph.topology_data(ROOT)
        json.dump(report, sys.stdout, indent=2)
        print()
    else:
        for f in findings:
            print(f.render())
        for f in info:
            print(f"info: {f.render()}")
        for key in stale:
            # The rule prefix of the key identifies the family, so the
            # log says which gate's baseline needs the refresh.
            fam = family(key.split(":", 1)[0])
            print(f"analysis: stale {fam} baseline entry (symbol no "
                  f"longer present): {key}")
        fams_c = family_counts(findings)
        per_family = ", ".join(
            f"{k} {v}" for k, v in sorted(fams_c.items()) if k in fams
        )
        tail = f" ({suppressed} baselined)" if suppressed else ""
        if info:
            tail += f" ({len(info)} info)"
        if findings:
            print(f"analysis: {len(findings)} finding(s) "
                  f"({per_family}){tail}")
        else:
            print(f"analysis: clean ({per_family}){tail}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
